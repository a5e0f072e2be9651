"""``lm_trial_kernel_share.offline`` on the CPU: the share of the window's
LM trials that the program ran as its trial kernel, from its counters; no
number from a program without the counter (as before the kernel) or from a
run of another traffic; declared for the offline cell."""

import pytest

from benchmark import harness

NAME = "lm_trial_kernel_share.offline"


def _totals(counts):
    from direct_lidar_odometry_tpu_torch.utils import sync

    return lambda: sync.Totals({}, {}, {"frames": 8, **counts})


@pytest.mark.parametrize("counts,want", [
    ({"lm_steps.step.s2s": 31, "lm_steps.step.s2m": 29, "gicp_trial.kernel": 60}, 1.0),
    ({"lm_steps.step.s2s": 30, "lm_steps.refine.register": 10, "gicp_trial.kernel": 30}, 0.75),
    ({"lm_steps.step.s2s": 30, "gicp_trial.kernel": 0}, 0.0),
    ({"lm_steps.step.s2s": 30, "gicp_graph.replays": 30}, None),
    ({"gicp_trial.kernel": 4}, None),
])
def test_share_of_trials_run_by_the_kernel(monkeypatch, counts, want):
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
