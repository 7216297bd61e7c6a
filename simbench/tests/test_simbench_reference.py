"""The plain reference against the port's ``run_simulation`` on the CPU,
on tiny cuts of each cell at its own contention and at 1,024 hot
records, and on the frozen step's other lock-table protocols; its
planner against its definitions."""

import numpy as np
import pytest

from simbench import check, harness
from simbench.reference import plan as rplan
from simbench.tests.conftest import CELLS, tiny


def port_fingerprints(cell, arrays):
    entry = harness.entry_module(cell)
    program = entry.Program(cell.config, cell.traffic, arrays, "cpu")
    return [check.fingerprint(r) for r in program.call()]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [7, 2**31 + 11])
@pytest.mark.parametrize("num_hot", [None, 1024])  # the mix's; fig13's low end
def test_reference_equals_the_port(name, seed, num_hot):
    cell = tiny(name, num_hot)
    arrays = harness.make_inputs(cell, seed)
    got = port_fingerprints(cell, arrays)
    want = harness.entry_module(cell).reference(cell.config, cell.traffic,
                                                arrays, "cpu")
    assert got == want
    assert check.within(check.compare([got], want))
    assert want[0]["commits"] > 0 and want[0]["steps_executed"] > 0
    assert sum(v for k, v in want[0].items()
               if k.startswith("lat_hist.")) == want[0]["commits"]


@pytest.mark.parametrize("protocol", ["deadlock_free", "twopl_waitdie",
                                      "twopl_dreadlocks"])
def test_reference_equals_the_port_on_other_lock_protocols(protocol):
    cell = tiny("orthrus-80c.ycsb-hot64", protocol=protocol, n_cc=0)
    arrays = harness.make_inputs(cell, 5)
    want = harness.entry_module(cell).reference(cell.config, cell.traffic,
                                                arrays, "cpu")
    assert port_fingerprints(cell, arrays) == want


def test_conflict_preds_follow_the_definition():
    # txn 1 writes 10 after txn 0 read it (WAR) and after txn 0 wrote 11
    # (WAW); txn 2 reads 10 after txn 1's write (RAW); txn 3 is in the
    # next batch and depends on nothing; a txn never depends on itself
    keys = np.array([[10, 11], [10, 11], [10, 10], [10, 11]])
    modes = np.array([[0, 1], [1, 1], [0, 0], [1, 1]])
    nkeys = np.array([2, 2, 2, 2])
    preds = rplan.conflict_preds(keys, modes, nkeys, batch_epoch=3)
    assert preds == [set(), {0}, {1}, set()]
