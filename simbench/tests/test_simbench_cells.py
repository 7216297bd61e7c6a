"""Every cell, configuration, mix, entry, generator and metric that
BENCHMARK.json names resolves to its file, and the files agree."""

import json

import pytest

from simbench import spec
from simbench.tests.conftest import CELLS

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def test_the_cells_in_their_ranked_order():
    assert tuple(w["name"] for w in BENCH["workloads"]) == CELLS
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.load_cell(name)
    assert cell.traffic["entry"] == "run_simulation"
    assert (spec.HERE / "entries" / "run_simulation.py").is_file()
    assert (spec.HERE / "generators"
            / f"{cell.config['generator']}.py").is_file()
    assert [m.name for m in cell.end_to_end] == ["sim_rounds_per_s",
                                                 "setup_s"]
    names = {m.name for m in cell.per_layer}
    assert {"plan_ms", "steps_per_round", "host_ms_per_step",
            "step_kernels", "step_device_ms",
            "device_idle_share"} <= names
    kernel = ("b1_roofline" if name.startswith("orthrus")
              else "b2_roofline")
    assert kernel in names
    assert all(callable(m.reader.read) for m in cell.per_layer)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_matches_its_entry(entry):
    cfg = json.loads((spec.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]


def test_unknown_cell_is_refused():
    with pytest.raises(spec.SpecError):
        spec.load_cell("no-such-cell")
