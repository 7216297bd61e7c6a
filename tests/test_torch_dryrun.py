"""The dry run and the roofline (``repro_torch.launch.{dryrun,roofline}``)
against the JAX package's.

* ``SHAPES`` and ``applicable_shapes`` equal the reference's for every
  arch.
* Each cell's ``params``, ``active_params`` and ``model_flops`` equal the
  reference's for every arch x applicable shape (the reference's
  ``analyze_compiled`` on an empty compiled artifact: no compile).
* A train, a prefill and a decode cell of qwen3-32b SMOKE (2 layers) on a
  2 x 2 mesh (``tools/torch_collective_compare.py``): the port's
  per-device FLOPs (a ``fake`` process group of 4 ranks, the cell traced
  on ``meta``, every tensor of it on ``meta``) within 5% of the
  reference's ``run_cell`` (its compiled HLO's dot FLOPs on 4 host
  devices); each in a subprocess, the two run side by side. Measured
  gaps: 0.0% in all three. The train cell runs both under the "dots"
  remat policy (8 microbatches, the loss in chunks of 512, as the dry
  run's default): under "nothing", which recomputes every matmul in the
  backward, the reference counts 10.4% more than the port (measured),
  and under "dots", which recomputes none, the two agree exactly; so the
  gap is in what the reference's compiled step recomputes, more than the
  one forward of each layer that the port recomputes. The test pins
  that gap under "nothing" too (between 5% and 15%).
* The same three cells' collective wire bytes per device (the port's
  ring formulas over DTensor's collectives, the reference's over its
  HLO's) between 0.5x and 1.15x (train_4k) or 1.10x (prefill_32k,
  decode_32k) of the reference's. The reference's bytes are counted at
  the dtypes its collectives had before XLA's CPU backend promoted each
  bf16 one to f32 (a TPU or GPU compile keeps them in bf16; the port
  reduces and gathers in the dtype of what it carries). Measured:
  1.0598e9 against 1.0558e9 in train_4k (1.004x), 2.685e8 against
  3.021e8 in prefill_32k (0.889x), 9.48e4 against 1.002e5 in decode_32k
  (0.946x); against the promoted f32 counts (2.099e9, 6.041e8, 1.988e5)
  the ratios are half of these. Before the port reduced each partial sum
  once, in its own dtype, and took the loss on the vocab shards, it
  moved 3.734e9, 8.054e8 and 2.42e5 (3.54x, 2.67x, 2.42x of the
  own-dtype yardstick).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.base import (  # noqa: E402
    applicable_shapes as jax_applicable,
)
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.roofline import analyze_compiled  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    SHAPES,
    applicable_shapes,
    get_config,
    list_archs,
)
from repro_torch.launch.dryrun import cell_meta  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    DeviceCounter,
    analyze_counts,
)
from tools.torch_collective_compare import compare  # noqa: E402

ARCH = "qwen3-32b"
CELLS = ("train_4k", "prefill_32k", "decode_32k")
FLOPS_RTOL = 0.05
# the port's collective bytes per device over the reference's (at the
# dtypes its collectives had before XLA's CPU backend promoted bf16 ones
# to f32), by cell
COLL_RATIO = {"train_4k": (0.5, 1.15), "prefill_32k": (0.5, 1.10),
              "decode_32k": (0.5, 1.10)}


def test_shapes_and_applicable_shapes_equal_the_reference():
    assert {k: tuple(v.__dict__.values()) for k, v in SHAPES.items()} == {
        k: tuple(v.__dict__.values()) for k, v in JAX_SHAPES.items()}
    for arch in list_archs():
        assert applicable_shapes(get_config(arch)) == jax_applicable(
            jax_config(arch))


class _Empty:
    """A compiled artifact with nothing in it: the reference's
    ``analyze_compiled`` then reports the cell's metadata and its
    analytic model FLOPs alone."""

    def memory_analysis(self):
        return None

    def cost_analysis(self):
        return {}

    def as_text(self):
        return ""


class _Mesh:
    devices = np.zeros(256)


@pytest.mark.parametrize("arch", list_archs())
def test_params_and_model_flops_equal_the_reference(arch):
    cfg = get_config(arch)
    for shape in applicable_shapes(cfg):
        meta = cell_meta(arch, shape, cfg)
        want = analyze_compiled(_Empty(), dict(meta), jax_config(arch), None,
                                _Mesh())
        got = analyze_counts(DeviceCounter(), meta, chips=256, param_bytes=0,
                             arg_bytes=0, out_bytes=0)
        for key in ("params", "active_params", "model_flops"):
            assert got[key] == want[key], (arch, shape, key)


def test_smoke_cells_flops_within_5_percent_of_jax(tmp_path):
    port, ref = compare([ARCH], CELLS, nothing=True, workdir=str(tmp_path))
    for shape in CELLS:
        got, want = port[f"{ARCH}/{shape}"], ref[f"{ARCH}/{shape}"]
        assert want["flops"] > 0
        assert abs(got["flops"] - want["flops"]) <= FLOPS_RTOL * want[
            "flops"], (shape, got["flops"], want["flops"])
    for shape, (lo, hi) in COLL_RATIO.items():
        got, want = port[f"{ARCH}/{shape}"], ref[f"{ARCH}/{shape}"]
        assert want["coll_own"] > 0 and (
            lo * want["coll_own"] <= got["coll"] <= hi * want["coll_own"]), (
            shape, got, want)
    # the reference's extra recompute under "nothing" (ROADMAP Queue 3),
    # pinned: it counts more than the port, by about a tenth (10.4%)
    got = port[f"{ARCH}/train_4k/nothing"]["flops"]
    want = ref[f"{ARCH}/train_4k/nothing"]["flops"]
    assert 0.05 * want < want - got < 0.15 * want, (got, want)
