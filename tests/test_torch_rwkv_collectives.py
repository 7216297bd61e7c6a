"""rwkv6-1.6b's sharded plan against the JAX package's compiled step.

rwkv6-1.6b SMOKE's train_4k, prefill_32k and decode_32k cells on a 2 x 2
(``data``, ``model``) mesh, the port's dry run against the reference's
(``tools/torch_collective_compare.py``, the cells side by side, each in
two subprocesses; the reference's bytes at the dtypes its collectives
had before XLA's CPU backend promoted bf16 ones to f32; train_4k's
combined elements split by their operands): FLOPs per device within 5%
and collective bytes per device between 0.5x and 1.25x (train) or 1.10x
(prefill, decode) of the reference's.

Two sites differed. The decay LoRA: the reference's compiled step runs
``x @ wa`` on each rank's rows with every lora column on every ``model``
rank and splits ``lo @ wb`` over the heads; DTensor's own einsum split
``x @ wa``'s columns over ``model`` and gathered ``lo`` back. The time
mix's ``ln_x`` norm over the heads, which ``model`` shards: DTensor's
mean placed the row's partial sum along the batch and sent the
backward's gradients at the norm's full width in f32 (two all-gathers,
then a reduce-scatter); ``sharding.ctx.mean_last`` reduces one number a
row, forward and backward. Measured after both: FLOPs +2.9%, 0 and 0
(-4.0%, -8.2%, -7.0% before); bytes 1.107x, 0.890x and 0.959x (1.716x,
1.110x, 0.996x before).
"""

import concurrent.futures

import pytest

torch = pytest.importorskip("torch")

from tools.torch_collective_compare import compare  # noqa: E402

ARCH = "rwkv6-1.6b"
CELLS = ("train_4k", "prefill_32k", "decode_32k")
FLOPS_RTOL = 0.05
# port / reference collective bytes, by cell
RATIO = {"train_4k": (0.5, 1.25), "prefill_32k": (0.5, 1.10),
         "decode_32k": (0.5, 1.10)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each cell's comparison (two subprocesses each), all side by side."""
    with concurrent.futures.ThreadPoolExecutor(len(CELLS)) as pool:
        jobs = {cell: pool.submit(compare, [ARCH], [cell],
                                  workdir=str(tmp_path_factory.mktemp(cell)))
                for cell in CELLS}
        return {cell: f.result() for cell, f in jobs.items()}


@pytest.mark.parametrize("cell", CELLS)
def test_rwkv_flops_match_the_reference(runs, cell):
    port, ref = runs[cell]
    got, want = port[f"{ARCH}/{cell}"], ref[f"{ARCH}/{cell}"]
    assert abs(got["flops"] - want["flops"]) <= FLOPS_RTOL * want["flops"], (
        cell, got["flops"], want["flops"])


@pytest.mark.parametrize("cell", CELLS)
def test_rwkv_sends_what_jax_sends(runs, cell):
    port, ref = runs[cell]
    got, want = port[f"{ARCH}/{cell}"], ref[f"{ARCH}/{cell}"]
    lo, hi = RATIO[cell]
    assert want["coll_own"] > 0
    assert lo * want["coll_own"] <= got["coll"] <= hi * want["coll_own"], (
        cell, got, want)
