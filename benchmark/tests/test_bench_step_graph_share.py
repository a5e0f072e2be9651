"""``step_graph_share.offline`` on the CPU: the share of the window's step
stretches outside GICP that the program replayed from a graph, from its
counters; no number from a program without them (as before the step's
graphs) or from a run of another traffic; declared for the offline cell."""

import pytest

from benchmark import harness

NAME = "step_graph_share.offline"


def _totals(counts):
    from direct_lidar_odometry_tpu_torch.utils import sync

    return lambda: sync.Totals({}, {}, {"frames": 8, **counts})


@pytest.mark.parametrize("counts,want", [
    ({"step_graph.replays": 60, "step_graph.captures": 6, "step_graph.eager": 0}, 1.0),
    ({"step_graph.replays": 30, "step_graph.captures": 10, "step_graph.eager": 10}, 0.75),
    ({"step_graph.eager": 30}, 0.0),
    ({"step_graph.replays": 40}, 1.0),
    ({"gicp_graph.replays": 30, "gicp_graph.eager_iters": 0}, None),
    ({}, None),
])
def test_share_of_replayed_stretches(monkeypatch, counts, want):
    from direct_lidar_odometry_tpu_torch.utils import sync

    monkeypatch.setattr(sync, "totals", _totals(counts))
    assert harness.reader(NAME).read(harness.RunLog("offline"), None) == want
    assert harness.reader(NAME).read(harness.RunLog("live"), None) is None


def test_a_program_without_aggregates_reports_no_share(monkeypatch):
    from direct_lidar_odometry_tpu_torch.utils import sync

    monkeypatch.delattr(sync, "totals")
    assert harness.reader(NAME).read(harness.RunLog("offline"), None) is None


def test_share_is_declared_for_the_offline_cell():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "share", "higher", "program_counter", "per-frame step", "frames_per_s", ["os1_offline"])
