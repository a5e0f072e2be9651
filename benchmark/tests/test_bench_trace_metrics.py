"""The offline cell's readers of the program's own spans and counters on
the CPU: a traced dry run reports each as a finite, non-negative number,
the step's parts add up to the harness's ``step`` spans in the window
within 5 % and to no more, and
a program without the aggregates gives no number and no error."""

import math

from benchmark import harness
from benchmark.tests.test_bench_harness import dry_run

METRICS = ["host_waits_per_frame.offline", "host_wait_ms_per_frame.offline",
           "dispatch_ms_per_frame.offline", "runner_ms_per_frame.offline",
           "registration_ms_per_frame.offline", "align_iters_per_frame.offline",
           "prep_cpu_ms_per_frame.offline"]


def test_traced_dry_run_reports_the_program_metrics():
    res = dry_run("os1_offline", trace=True)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in METRICS:
        assert name in got, name
        assert math.isfinite(got[name]) and got[name] >= 0, (name, got[name])
    # (gicp_iters_per_frame.offline also sums the warm-up pass's iterations,
    # which weigh on a short CPU window: the two are not compared here)
    assert got["align_iters_per_frame.offline"] > 0
    assert got["host_waits_per_frame.offline"] >= got["host_reads_per_frame.offline"] > 0
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        assert declared[name]["workloads"] == ["os1_offline"]
        assert declared[name]["moves"] == "frames_per_s"


def test_step_parts_add_up_to_no_more_than_the_step(monkeypatch):
    from benchmark.drivers import offline

    logs = []
    run = offline.run

    def keep(ctx):
        log = run(ctx)
        logs.append(log)
        return log

    monkeypatch.setattr(offline, "run", keep)
    res = dry_run("os1_offline", trace=True)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    (log,) = logs
    from benchmark import program_trace

    _, frames = program_trace.offline_window(log)
    parts_ms = frames * (got["dispatch_ms_per_frame.offline"] + got["runner_ms_per_frame.offline"]
                         + got["host_wait_ms_per_frame.offline"])
    # the harness's step spans in the window (the warm-up's are before it);
    # no profiler runs on the CPU, so the program's spans outside profiling
    # cover the harness's sub-window too ("step@profiled")
    (warm,) = log.rec.spans["warm"]
    step_ms = sum(b - a for key in ("step", "step@profiled")
                  for a, b, _ in log.rec.spans.get(key, []) if a > warm[1]) * 1e3
    assert 0.95 * step_ms <= parts_ms <= step_ms


def test_a_program_without_aggregates_reports_nothing(monkeypatch):
    from direct_lidar_odometry_tpu_torch.utils import sync

    log = harness.RunLog("offline")
    monkeypatch.delattr(sync, "totals")
    for name in METRICS:
        assert harness.reader(name).read(log, None) is None
    assert harness.reader(METRICS[0]).read(harness.RunLog("live"), None) is None
