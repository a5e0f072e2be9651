"""``gicp_graph_share.offline`` on the CPU: the share of the window's GICP
iterations that the program replayed from a graph, from its counters; no
number from a program without them (as before the graph path) or from a
run of another traffic; declared for the offline cell."""

import pytest

from benchmark import harness

NAME = "gicp_graph_share.offline"


def _totals(counts):
    from direct_lidar_odometry_tpu_torch.utils import sync

    return lambda: sync.Totals({}, {}, {"frames": 8, **counts})


@pytest.mark.parametrize("counts,want", [
    ({"align_iters.step.s2s": 30, "align_iters.step.s2m": 20, "gicp_graph.eager_iters": 0,
      "gicp_graph.replays": 60}, 1.0),
    ({"align_iters.step.s2s": 30, "align_iters.step.s2m": 10, "gicp_graph.eager_iters": 10,
      "gicp_graph.replays": 33}, 0.75),
    ({"align_iters.step.s2s": 30, "gicp_graph.eager_iters": 30, "gicp_graph.replays": 0}, 0.0),
    ({"align_iters.step.s2s": 30}, None),
    ({"gicp_graph.eager_iters": 0}, None),
])
def test_share_of_replayed_iterations(monkeypatch, counts, want):
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
        "share", "higher", "program_counter", "registration", "frames_per_s", ["os1_offline"])
