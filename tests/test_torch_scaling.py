"""The port's multi-process scaling tools on the CPU over gloo, at the
fewest steps and frames that give their JSON rows:
``tools_torch/scaling_procs.py`` (N = 1 and N = 2 worker processes, each
pinned to one core by ``taskset``) and ``tools_torch/scaling_bench.py``
(``SCALING_SIZES=1,2``, one sequence a process, three frames: init,
warm-up, one timed step). The workers run with the card hidden, as
``tests/test_torch_sharded.py``'s do."""

import math

from tools_torch import scaling_bench, scaling_procs

ROW_KEYS = ("devices", "batch", "ms_per_step", "aggregate_fps", "iter_skew_frac_mean",
            "iter_skew_frac_max")


def test_scaling_procs_worlds_over_gloo():
    """One timed step of ``run_world`` at N = 1 and N = 2: the JAX tool's
    keys, finite positive fps from rank 0 of each group, and their
    efficiency."""
    row = scaling_procs.run(steps=1, device="cpu")
    assert tuple(row) == ("metric", "value", "unit", "fps_1proc_1core", "fps_2proc_2core",
                          "steps", "note")
    assert row["metric"] == "cross_process_scaling_efficiency" and row["steps"] == 1
    fps1, fps2 = row["fps_1proc_1core"], row["fps_2proc_2core"]
    assert all(math.isfinite(f) and f > 0 for f in (fps1, fps2))
    assert row["value"] == fps2 / (2 * fps1)


def test_scaling_bench_rows_over_gloo():
    """SCALING_SIZES=1,2 with one sequence a process over three frames: a
    row per N with the JAX tool's keys, finite, the batch N sequences, then
    the efficiency table (1.0 at N = 1)."""
    rows = scaling_bench.run(per_device=1, frames=3, sizes=[1, 2], device="cpu")
    assert [r.get("devices") for r in rows[:2]] == [1, 2]
    for n, r in zip((1, 2), rows[:2]):
        assert tuple(r) == ROW_KEYS and r["batch"] == n
        assert all(math.isfinite(r[k]) for k in ROW_KEYS[2:])
        assert r["aggregate_fps"] > 0 and 0 <= r["iter_skew_frac_mean"] <= r["iter_skew_frac_max"]
    summary = rows[2]
    assert summary["metric"] == "scaling_efficiency"
    assert [t["devices"] for t in summary["table"]] == [1, 2]
    assert summary["table"][0]["efficiency"] == 1.0
    assert all(math.isfinite(t["efficiency"]) for t in summary["table"])
