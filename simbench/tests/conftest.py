"""Shared helpers of the benchmark's CPU tests: cells cut to a size the
CPU runs in about a second, and one intra-op thread."""

import copy
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from simbench import spec  # noqa: E402

CELLS = ("orthrus-80c.ycsb-hot64", "dgcc-80c.ycsb-hot64")


def tiny(name: str, num_hot: int | None = None, **engine) -> spec.Cell:
    """Cell ``name`` cut to 256 txns over 20,000 records, 2 CC/planner +
    6 exec lanes of 2 slots, batches of 64 and 1,200 rounds; with
    ``num_hot``, on that many hot records instead of its mix's."""
    cell = spec.load_cell(name)
    traffic = copy.deepcopy(cell.traffic)
    if num_hot is not None:
        traffic["workload"]["num_hot"] = num_hot
    cfg = copy.deepcopy(cell.config)
    cfg["workload"].update(num_txns=256, num_records=20_000)
    cfg["engine"].update(dict(n_cc=2, n_exec=6, window=2, max_rounds=1200,
                              warmup_rounds=400, chunk_rounds=400), **engine)
    cfg["batch_epoch"] = 64
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def fresh_runners():
    """An empty runner cache of the port before and after the test, so
    a patched step is the one that runs."""
    from repro_torch.core import sweep

    sweep._evict_to(0)
    yield
    sweep._evict_to(0)
