"""The port's legacy state layout (``repro_torch.core.engine_legacy``, the
frozen pre-packed step builders) against the JAX reference's, on the
CPU: the 9 goldens the legacy layout admits, under
``state_layout="legacy"`` through ``run_simulation``, give the
reference's legacy fingerprint, ``raw`` counters and ``metrics is
None``, and the golden fixture itself (the fixtures encode the
pre-packed engine).

The final states of ``tests/test_engine_leap.py``'s cells and per-step
differentials are in ``tests/test_torch_legacy_step.py``; the port's
own packed-against-legacy identities, K-fused dispatch and
``run_cells`` on the legacy layout in ``tests/test_torch_legacy_sweep.py``.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from golden.regenerate import CELLS, GOLDEN_DIR, SIM, fingerprint  # noqa: E402

from repro.core import engine as ref_engine  # noqa: E402
from repro.core import workloads as ref_workloads  # noqa: E402
from repro_torch.core import engine, workloads  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the goldens whose configs the legacy layout admits (no scheduled
# family, fragments, planner lanes, open arrival or overload layer)
LEGACY_GOLDENS = (
    "twopl_waitdie", "twopl_waitfor", "twopl_dreadlocks", "deadlock_free",
    "orthrus", "partitioned_store", "dgcc", "quecc",
    "deadlock_free_tpcc_ollp",
)


def _raw(res):
    return {k: v for k, v in res.raw.items() if k != "wall_s_group"}


def test_legacy_goldens_are_the_admissible_ones():
    """Exactly the 9 goldens above make valid legacy configs."""
    admitted = set()
    for name, (_wl_kw, eng_kw) in CELLS.items():
        try:
            engine.EngineConfig(**eng_kw, state_layout="legacy")
        except AssertionError:
            continue
        admitted.add(name)
    assert admitted == set(LEGACY_GOLDENS)


@pytest.mark.parametrize("name", LEGACY_GOLDENS)
def test_legacy_golden_matches_reference(name):
    wl_kw, eng_kw = CELLS[name]
    ref = ref_engine.run_simulation(
        ref_engine.EngineConfig(**eng_kw, state_layout="legacy", **SIM),
        ref_workloads.make_workload(ref_workloads.WorkloadConfig(**wl_kw)))
    got = engine.run_simulation(
        engine.EngineConfig(**eng_kw, state_layout="legacy", **SIM),
        workloads.make_workload(workloads.WorkloadConfig(**wl_kw)),
        device="cpu")
    assert ref.metrics is None and got.metrics is None
    assert fingerprint(got) == fingerprint(ref)
    assert _raw(got) == _raw(ref)
    assert got.raw["steps_executed"] == ref.raw["steps_executed"]
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        assert fingerprint(got) == json.load(f)["trace"]
