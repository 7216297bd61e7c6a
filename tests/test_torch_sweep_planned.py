"""The port's multi-cell sweep on the CPU for deadlock_free and orthrus (the planned lock-table protocols): the three hot
sets as one group under SERIAL_MODE and the reference's three other
modes, each cell against ``repro.core.sweep.run_cells`` in the same
mode and the port's per-cell ``run_simulation``. The check is
``tests/test_torch_sweep_cells.py``'s; this file holds it apart for its
time."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_sweep_cells import MODES, check_protocol_mode  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are small (and the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode_name", sorted(MODES))
@pytest.mark.parametrize("protocol", ["deadlock_free", "orthrus"])
def test_run_cells_matches_reference(protocol, mode_name):
    got = check_protocol_mode(protocol, mode_name)
    # the cells meet the commit target at different boundaries
    assert len({r.raw["rounds_total"] for r in got}) > 1
