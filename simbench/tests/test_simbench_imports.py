"""The benchmark measures the port alone: nothing it loads is JAX or the
JAX package (top-level names compared whole: ``repro_torch`` begins with
``repro``), and the reference loads nothing of the port. The harness
refuses to run without a card and in a checkout without the port."""

import json
import shutil
import subprocess
import sys

from simbench import guard, spec

LOAD_ALL = """
import json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src"]
from simbench import check, control, guard, harness, spec, trace, yardstick
from simbench.tests.conftest import CELLS
for name in CELLS:
    cell = spec.load_cell(name)
    harness.entry_module(cell)
    harness.make_inputs(cell, 1)
import repro_torch.core.engine, repro_torch.core.sweep
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src"]
from simbench import harness
from simbench.tests.conftest import tiny
cell = tiny("dgcc-80c.ycsb-hot64")
harness.entry_module(cell).reference(cell.config, cell.traffic,
                                     harness.make_inputs(cell, 1), "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(code):
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=str(spec.ROOT))],
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_names_are_compared_whole():
    assert guard.forbidden_loaded({"repro_torch.core.engine": 1}) == []
    assert guard.forbidden_loaded({"repro.core": 1, "jaxlib.xla": 1}) == [
        "jaxlib", "repro"]


def test_the_harness_and_the_port_load_no_jax():
    tops = loaded(LOAD_ALL)
    assert guard.PORT in tops
    assert not tops & guard.FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    tops = loaded(REFERENCE_ONLY)
    assert "torch" in tops
    assert not tops & (guard.FORBIDDEN | {guard.PORT})


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(spec.ROOT / "simbench" / "run.py"),
         "--workload", "dgcc-80c.ycsb-hot64", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "simbench", tmp_path / "simbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "simbench/run.py", "--workload",
         "dgcc-80c.ycsb-hot64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
