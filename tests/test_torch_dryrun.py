"""The dry run and the roofline (``repro_torch.launch.{dryrun,roofline}``)
against the JAX package's.

* ``SHAPES`` and ``applicable_shapes`` equal the reference's for every
  arch.
* Each cell's ``params``, ``active_params`` and ``model_flops`` equal the
  reference's for every arch x applicable shape (the reference's
  ``analyze_compiled`` on an empty compiled artifact: no compile).
* A train, a prefill and a decode cell of qwen3-32b SMOKE (2 layers) on a
  2 x 2 mesh: the port's per-device FLOPs (a ``fake`` process group of 4
  ranks, the cell traced on ``meta``, every tensor of it on ``meta``)
  within 5% of the reference's ``run_cell`` (its compiled HLO's dot FLOPs
  on 4 host devices); each in a subprocess, the two run side by side.
  Measured gaps: 0.0% in all three. The train cell runs both under the
  "dots" remat policy (8 microbatches, the loss in chunks of 512, as the
  dry run's default): under "nothing", which recomputes every matmul in
  the backward, the reference counts 10.4% more than the port
  (measured), and under "dots", which recomputes none, the two agree
  exactly; so the gap is in what the reference's compiled step
  recomputes, more than the one forward of each layer that the port
  recomputes. The test pins that gap under "nothing" too (between 5%
  and 15%).
* The same three cells' collective wire bytes per device (the port's
  ring formulas over DTensor's collectives, the reference's over its
  HLO's), held within a band around the measured gap. The port moves
  more: 3.734e9 bytes against 2.099e9 in train_4k (1.78x; all-reduce
  3.154e9 against 2.027e9, all-gather 5.79e8 against 6.94e7: the port
  gathers each weight whole at every use, in each of the 8
  microbatches, where the compiled reference gathers less), 8.054e8
  against 6.041e8 in prefill_32k (1.33x), and 2.42e5 against 1.99e5 in
  decode_32k (1.22x). The band is 1x to 2x in train_4k and 1x to 1.5x
  in the other two: a change that moves the port past it moves the
  roofline's dominant term, and the docstring's numbers with it.
"""

import json
import os
import subprocess
import sys
import textwrap

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

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ARCH = "qwen3-32b"
CELLS = ("train_4k", "prefill_32k", "decode_32k")
FLOPS_RTOL = 0.05
# the port's collective bytes per device over the reference's, by cell
COLL_RATIO = {"train_4k": (1.0, 2.0), "prefill_32k": (1.0, 1.5),
              "decode_32k": (1.0, 1.5)}


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


JAX_RUN = """
import json, sys
sys.path.insert(0, {src!r})
import repro.launch.dryrun as D  # sets the host device count first
import jax, numpy as np
from jax.sharding import Mesh
from repro.optim import OptConfig
from repro.train import TrainConfig

mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
tcfg = TrainConfig(microbatches=8, remat_policy="dots", opt=OptConfig())
out = {{}}
for s in {cells!r}:
    a = D.run_cell({arch!r}, s, mesh, "m22", smoke=True, tcfg=tcfg)
    out[s] = a["flops_per_device"]
    out[s + "/coll"] = a["collective_bytes_per_device"]
out["nothing"] = D.run_cell({arch!r}, "train_4k", mesh, "m22", smoke=True,
                            tcfg=TrainConfig(microbatches=8, opt=OptConfig())
                            )["flops_per_device"]
print("JAX " + json.dumps(out))
"""

PORT_RUN = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.launch import dryrun as D
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig

mesh = D.fake_mesh((2, 2), ("data", "model"))
tcfg = TrainConfig(microbatches=8, remat_policy="dots", opt=OptConfig())
out = {{}}
for s in {cells!r}:
    a = D.run_cell({arch!r}, s, mesh, "m22", smoke=True, tcfg=tcfg)
    out[s] = a["flops_per_device"]
    out[s + "/coll"] = a["collective_bytes_per_device"]
out["nothing"] = D.run_cell({arch!r}, "train_4k", mesh, "m22", smoke=True,
                            tcfg=TrainConfig(microbatches=8, opt=OptConfig())
                            )["flops_per_device"]
print("PORT " + json.dumps(out))
"""


def test_smoke_cells_flops_within_5_percent_of_jax(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {}
    for tag, text in (("JAX", JAX_RUN), ("PORT", PORT_RUN)):
        script = tmp_path / f"run_{tag.lower()}.py"
        script.write_text(textwrap.dedent(text.format(src=SRC, arch=ARCH,
                                                      cells=CELLS)))
        procs[tag] = subprocess.Popen([sys.executable, str(script)],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      env=env)
    res = {}
    for tag, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, out + err[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
        res[tag] = json.loads(line[-1][len(tag) + 1:])
    for shape in CELLS:
        got, want = res["PORT"][shape], res["JAX"][shape]
        assert want > 0
        assert abs(got - want) <= FLOPS_RTOL * want, (shape, got, want)
    for shape, (lo, hi) in COLL_RATIO.items():
        got, want = res["PORT"][shape + "/coll"], res["JAX"][shape + "/coll"]
        assert want > 0 and lo * want <= got <= hi * want, (shape, got, want)
    # the reference's extra recompute under "nothing" (ROADMAP Queue 3),
    # pinned: it counts more than the port, by about a tenth (10.4%)
    got, want = res["PORT"]["nothing"], res["JAX"]["nothing"]
    assert 0.05 * want < want - got < 0.15 * want, (got, want)
