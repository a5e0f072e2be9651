"""The lower-precision control on the card: the reference in the program's
place, computed in float32 with TF32 products, must fail a cell's limits
where the port passes them. At a size a test run holds (short drives, a
short window); the cells' own readings come from ``benchmark/control.py``
(PERF.md §2). Skips without a card."""

import pytest
import torch

from benchmark import control, harness

SHORT = {"traffic": {"drive_frames": 120, "lap_frames": 200}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["os1_offline", "os1_fleet8"])
def test_control_fails_where_the_port_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    c = harness.load_cell(cell, harness.with_candidates(), scale=SHORT)
    for seed in (7100000001, 7100000002, 7100000003):
        r = control.readings(c, seed, 8.0)
        assert r["judged"] > 0
        port = all(r["port"][k] <= lim for k, lim in c.limits.items())
        ctrl = all(r["control"][k] <= lim for k, lim in c.limits.items())
        assert port and not ctrl, r
