"""The port's long-drive tools (``tools_torch/``) on the CPU at the small
shapes, 6-10 frames each, on "hashgrid": each returns the JAX tool's keys
with finite values; the staleness sweep gives the chunk-1 trajectory bit
for bit at every chunk size; hull_ab's batched lane 0 at B = 2 equals its
own single-sequence surrogate drive bit for bit; each tool reads the JAX
tool's environment variables (or argv); without a card each ``__main__``
raises instead of running on the CPU.
"""

import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from tools_torch import (ablate_step, debug_loopclosure, hull_ab, long_validation,
                         micro_align, micro_linearize, scaling_bench, scaling_procs,
                         staleness_sweep, trace_frames)

REPO = Path(__file__).resolve().parent.parent
LV_KEYS = ("frames", "degrade", "noise", "posegraph", "ate_rmse_m", "ate_max_m", "drift_pct",
           "path_m", "keyframes", "evictions", "refine_rounds", "loop_edges",
           "kf_map_err_before_m", "kf_map_err_after_m", "wall_s")
LV_EXTRAS = ("ring_full_frame", "last_unforced_round_frame", "round_wall_ms",
             "peak_mem_frame50_mib", "peak_mem_end_mib")
SS_KEYS = ("chunk", "frames", "ate_rmse_m", "ate_max_m", "keyframes")
HAB_SINGLE_KEYS = ("config", "frames", "ate_rmse_m", "ate_max_m", "keyframes")
HAB_BATCHED_KEYS = ("config", "frames", "batch", "ate_rmse_m_per_seq", "ate_rmse_m_mean")
TRACE_KEYS = ("t", "init", "err_cm", "ms", "s2s_it", "s2s_nc", "s2s_cv", "s2s_e", "s2m_it",
              "s2m_nc", "s2m_cv", "s2m_e", "kf", "sp", "th", "chg")

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the drives run thousands of small tensor ops a
    frame, and under the parallel test run a thread pool over every core
    in two such workers spins them to a crawl (this file and
    ``test_torch_long_drive.py`` side by side took over 20 minutes that way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _finite(row: dict, keys) -> bool:
    values = []
    for k in keys:
        v = row[k]
        values.extend(v if isinstance(v, list) else [v])
    return all(math.isfinite(float(v)) for v in values)


def test_long_validation_rows():
    """The tool's drive, loop closure off then on, over the first 6 frames
    of its 120-frame small loop: the JAX tool's measured keys, finite, and
    the port's extras (no device memory on the CPU); GICP reads the host
    exactly once per LM step, and takes 1 to ``lm_max_iterations`` steps
    per outer iteration."""
    base = long_validation.make_config(small=True, max_kf=8).replace(nn_backend="hashgrid")
    world, render = long_validation.make_world(120, small=True)
    drives = [long_validation.drive(long_validation.with_posegraph(base, use, min_gap=0), world,
                                    long_validation.render_scans(world, render, 6, 0.01), "cpu")
              for use in (False, True)]
    for r, tr in drives:
        assert tuple(r) == LV_KEYS[4:] + LV_EXTRAS
        assert _finite(r, LV_KEYS[4:])
        assert 2 <= r["keyframes"] <= 8
        assert r["peak_mem_frame50_mib"] is None and r["peak_mem_end_mib"] is None
        lm_max = base.gicp.s2m.lm_max_iterations
        for t in range(1, 6):
            lm, lin = tr["lm_steps"][t], tr["linearizations"][t]
            assert tr["reads_by_module"][t]["gicp"] == lm
            assert tr["s2s_iterations"][t] + tr["s2m_iterations"][t] <= lin <= lm <= lin * lm_max
    (off, _), (on, _) = drives
    assert off["refine_rounds"] == 0 and off["round_wall_ms"] == []
    assert on["refine_rounds"] >= 1 and len(on["round_wall_ms"]) == on["refine_rounds"]


def test_staleness_sweep_chunks_give_one_trajectory():
    """The first 10 frames of the tool's 96-frame loop, chunks 1/4/8."""
    world, scans = staleness_sweep.make_scans(96)
    cfg = staleness_sweep.make_config().replace(nn_backend="hashgrid")
    rows = staleness_sweep.sweep(cfg, world, scans[:10], (1, 4, 8), "cpu")
    assert [r["chunk"] for r in rows] == [1, 4, 8]
    for r in rows:
        assert tuple(r)[: len(SS_KEYS)] == SS_KEYS and _finite(r, SS_KEYS)
        assert r["same_as_chunk1"] and r["max_dev_vs_chunk1_m"] == 0.0
        assert r["ate_rmse_m"] < 0.1


def test_hull_ab_rows_and_lane0_equals_its_single_drive():
    cfg = hull_ab.make_config().replace(nn_backend="hashgrid")
    world, beams = hull_ab.make_world(10)
    rows = [hull_ab.run_single(cfg, world, beams, True, "cpu"),
            hull_ab.run_single(cfg, world, beams, False, "cpu"),
            hull_ab.run_batched(cfg, world, beams, 2, "cpu")]
    assert [r["config"] for r in rows] == ["single_exact_hulls", "single_surrogate_hulls",
                                           "batched_surrogate_hulls"]
    for r in rows[:2]:
        assert tuple(r) == HAB_SINGLE_KEYS and _finite(r, HAB_SINGLE_KEYS[1:])
    batched = rows[2]
    assert tuple(batched)[: len(HAB_BATCHED_KEYS)] == HAB_BATCHED_KEYS
    assert _finite(batched, HAB_BATCHED_KEYS[1:]) and len(batched["ate_rmse_m_per_seq"]) == 2
    assert batched["lane0_vs_single_surrogate_max_m"] == 0.0


def test_trace_frames_rows():
    rows = trace_frames.run(frames=12, run_frames=10, device="cpu",
                            overrides=["nn_backend=hashgrid"], small=True)
    assert len(rows) == 10 and rows[0]["init"] and not any(r["init"] for r in rows[1:])
    for r in rows[1:]:
        assert tuple(r) == TRACE_KEYS and _finite(r, TRACE_KEYS)
        assert r["s2m_nc"] > 100
    assert trace_frames.format_row(rows[1]).startswith("t=  1 err=")


def test_environment_and_argv_parsing(monkeypatch):
    """Each tool reads the JAX tool's variables, and nothing else."""
    for var, value in {"SMALL": "1", "LV_FRAMES": "300", "LV_NOISE_BURST": "100:140:0.15",
                       "LV_MAX_KF": "128", "LV_MIN_GAP": "10", "LV_LOOP_RADIUS": "8.5",
                       "DEGRADE": "1", "LV_SOUP": "1", "SS_FRAMES": "48", "SS_CHUNKS": "1,4",
                       "STALE_SOUP": "1", "HAB_FRAMES": "30", "HAB_BATCH": "2",
                       "HULL_SOUP": "1"}.items():
        monkeypatch.setenv(var, value)
    monkeypatch.delenv("LV_NOISE", raising=False)
    assert long_validation.env_args() == dict(
        small=True, frames=300, degrade=True, noise=None, burst=(100, 140, 0.15), max_kf=128,
        min_gap=10, loop_radius=8.5, soup=True)
    assert staleness_sweep.env_args() == dict(small=True, frames=48, chunks=[1, 4], soup=True)
    assert hull_ab.env_args() == dict(frames=30, batch=2, soup=True)
    assert trace_frames.parse_argv(["60", "20", "--cpu", "nn_backend=hashgrid"]) == dict(
        frames=60, run_frames=20, device="cpu", overrides=["nn_backend=hashgrid"])
    assert trace_frames.parse_argv([]) == dict(frames=45, run_frames=45, device="cuda",
                                               overrides=[])


def test_new_tools_environment_and_argv(monkeypatch):
    """debug_loopclosure reads LV_FRAMES, LV_NOISE_BURST, LV_MAX_KF and
    DLC_CACHE (empty disables the cache); scaling_bench reads
    SCALING_BATCH, SCALING_FRAMES, SCALING_SIZES and SCALING_PLATFORM (the
    card unless "cpu"); scaling_procs takes ``[steps] [--device cpu]``."""
    for var in ("LV_FRAMES", "LV_NOISE_BURST", "LV_MAX_KF", "DLC_CACHE", "SCALING_BATCH",
                "SCALING_FRAMES", "SCALING_SIZES", "SCALING_PLATFORM"):
        monkeypatch.delenv(var, raising=False)
    assert debug_loopclosure.env_args() == dict(
        frames=300, burst=(100, 140, 0.15), max_kf=128,
        cache=os.path.join(tempfile.gettempdir(), "debug_lc_state.npz"))
    for var, value in {"LV_FRAMES": "120", "LV_NOISE_BURST": "10:20:0.3", "LV_MAX_KF": "24",
                       "DLC_CACHE": ""}.items():
        monkeypatch.setenv(var, value)
    assert debug_loopclosure.env_args() == dict(frames=120, burst=(10, 20, 0.3), max_kf=24,
                                                cache="")
    assert scaling_bench.env_args() == dict(per_device=2, frames=10, sizes=None, device="cuda")
    for var, value in {"SCALING_BATCH": "3", "SCALING_FRAMES": "5", "SCALING_SIZES": "1,2",
                       "SCALING_PLATFORM": "cpu"}.items():
        monkeypatch.setenv(var, value)
    assert scaling_bench.env_args() == dict(per_device=3, frames=5, sizes=[1, 2], device="cpu")
    monkeypatch.setenv("SCALING_PLATFORM", "tpu")
    assert scaling_bench.env_args()["device"] == "cuda"
    assert scaling_procs.parse_argv([]) == dict(steps=30, device="cuda")
    assert scaling_procs.parse_argv(["4", "--device", "cpu"]) == dict(steps=4, device="cpu")
    assert scaling_procs.parse_argv(["--device", "cpu", "7"]) == dict(steps=7, device="cpu")


def test_stage_tools_argv():
    """profile_stages and ablate_step take the JAX tools' ``[--small]``,
    micro_linearize ``[ns nt]``, micro_align nothing; anything else is
    refused."""
    assert ablate_step.parse_argv([]) == dict(small=False)
    assert ablate_step.parse_argv(["--small"]) == dict(small=True)
    for argv in (["--smal"], ["--device-preprocess"]):
        with pytest.raises(SystemExit):
            ablate_step.parse_argv(argv)
    assert micro_linearize.parse_argv([]) == {}
    assert micro_linearize.parse_argv(["4096", "8192"]) == dict(ns=4096, nt=8192)
    assert micro_align.parse_argv([]) == {}
    for tool, argv in ((micro_linearize, ["4096"]), (micro_align, ["--small"])):
        with pytest.raises(SystemExit):
            tool.parse_argv(argv)


@pytest.mark.parametrize("tool", ["long_validation", "staleness_sweep", "hull_ab",
                                  "trace_frames", "debug_loopclosure", "scaling_bench",
                                  "scaling_procs", "graft_entry_torch", "profile_stages",
                                  "ablate_step", "micro_align", "micro_linearize"])
def test_main_refuses_missing_cuda(tool):
    """``python3 tools_torch/<tool>.py`` (``graft_entry_torch.py`` at the
    repo root) without a card raises rather than running on the CPU."""
    path = REPO / f"{tool}.py" if tool == "graft_entry_torch" else REPO / "tools_torch" / f"{tool}.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["DLC_CACHE"] = ""
    proc = subprocess.run([sys.executable, str(path)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
