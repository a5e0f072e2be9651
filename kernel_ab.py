#!/usr/bin/env python3
"""A/B of the port across source trees on one NVIDIA GPU: the kernels
K1-K6 at the shapes of ``chip_smoke.py`` phase 3, and the per-frame drive
of its phase 4.

    mkdir -p _scratch/parent          # _scratch/ is in .gitignore
    git archive <commit> | tar -x -C _scratch/parent
    python3 kernel_ab.py _scratch/parent . . _scratch/parent

Each argument is the root of a checkout (its ``direct_lidar_odometry_tpu_torch``
and its ``chip_smoke.py``). Each runs in a process of its own, in the order
given, so two trees alternate in one call. A process builds that tree's
kernels with that tree's builder and goes through that tree's code only by
what every tree offers:

- ``kernels``: K2 through ``cuda_nn.query_1nn_sorted``, K4 through
  ``query_1nn_sorted(..., mxu=True)``, K3 through
  ``cuda_gicp.fused_linearize``, K1 through
  ``cuda_cov.radius_moments_sorted``, K5 through ``cuda_nn.query_1nn`` and
  K6 through ``cuda_cov.radius_moments`` (the JAX package's signatures),
  at S2M r 0.5 / 1.0 / 1.5, S2S r 1.0 and a loop edge (keyframe against
  keyframe at the loop gate) for K2, S2M r 0.5 / 1.0 / 1.5 for K4, S2M
  r 0.5 and S2S r 1.0 for K3 (cold), scan r 0.75 and keyframe r 1.5 for
  K1, the scan against the submap for K5 and the scan against itself at
  r 0.75 for K6, each also with every target valid and with the valid
  targets at random slots (``chip_smoke.check_exhaustive``'s clouds): the
  entry's device time (CUDA events behind a device sleep, median of 20),
  the device time per call of the kernel's own launches (torch.profiler,
  mean of 20 calls, the kernels picked by their names in either tree's
  sources; the rest of the entry, such as building candidate lists, is
  the difference), and the device operations of one entry call
  (``--kernels K5 K6`` times only those);
- ``drive``: the tree's own ``chip_smoke.drive`` (30 frames on "pallas"
  with that tree's checks), then six steady frames under torch.profiler on
  each backend ("pallas", "pallas_fused", "pallas_mxu";
  ``chip_smoke.device_ops_per_frame`` of this tree).

The inputs come from this tree's ``chip_smoke.kernel_inputs`` run against
each tree's package. The first tree's inputs and outputs are the
reference: the script fails if another tree saw other inputs, if K2's or
K4's or K5's idx, d2 or found differ in a bit, if K3's correspondences,
weights or payload differ in a bit or its H, b or error leave K3_REL of
their scale (the kernels may sum in another order), or if K1's or K6's
counts differ or their moments leave 1e-3 + 1e-5 |.|. Prints the card's name and power limit,
one JSON line per tree and case, then one line per case with every tree's
times and the first tree's mean over the second's. Imports torch and the
port, nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import re
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import torch

from tools_torch.devprof import KERNEL_NAMES

HERE = Path(__file__).resolve().parent
RUNS = 20
MODES = ("kernels", "drive")


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def profiled(fn, kernel: str, runs: int = RUNS) -> tuple[float, float, float, dict]:
    """(device us per call of the kernels whose name matches ``kernel``,
    their launches per call, device operations per call, their us per call
    by name) over ``runs`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    hits = [e for e in ops if re.search(kernel, e.name)]
    by_name: dict = {}
    for e in hits:
        by_name[e.name[:100]] = by_name.get(e.name[:100], 0.0) + e.time_range.elapsed_us() / runs
    return (sum(by_name.values()) if hits else float("nan"), len(hits) / runs, len(ops) / runs,
            by_name)


def search_cases(harness, cfg, kernels):
    """(kernel, label, radius, entry call, input tensors) of ``kernels``."""
    from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_gicp, cuda_nn, morton
    from direct_lidar_odometry_tpu_torch.registration.covariance import PLANE_EPS

    world, scans = harness.make_world()
    inp = harness.kernel_inputs(cfg, world, scans, torch.device("cuda"))
    k2 = [("S2M", inp.queries, inp.submap, r) for r in (0.5, 1.0, 1.5)]
    k2 += [("S2S", inp.queries, inp.s2s, 1.0),
           ("loop edge", inp.edge_src, inp.edge_tgt, cfg.posegraph.loop_corr_distance)]
    cases = []
    for label, q, t, r in k2:
        fn = partial(cuda_nn.query_1nn_sorted, t.points, t.mask, t.chunk_lo, t.chunk_hi,
                     q.points, q.mask, r)
        cases.append(("K2", label, r, fn, (q.points, q.mask, t.points, t.mask)))
    q, t = inp.queries, inp.submap
    for r in (0.5, 1.0, 1.5):
        fn = partial(cuda_nn.query_1nn_sorted, t.points, t.mask, t.chunk_lo, t.chunk_hi,
                     q.points, q.mask, r, mxu=True)
        cases.append(("K4", "S2M", r, fn, (q.points, q.mask, t.points, t.mask)))
    qw = q.mask & q.normals_valid
    for label, t, r in (("S2M", inp.submap, 0.5), ("S2S", inp.s2s, 1.0)):
        fn = partial(cuda_gicp.fused_linearize, t.points, t.mask, t.normals, t.normals_valid,
                     t.chunk_lo, t.chunk_hi, q.points, q.normals, qw, r, PLANE_EPS)
        cases.append(("K3", label, r, fn, (q.points, q.normals, qw, t.points, t.mask, t.normals,
                                           t.normals_valid)))
    for label, cloud, r in (("scan", inp.scan0, 0.75), ("keyframe", inp.kf0, 1.5)):
        clo, chi = morton.chunk_aabbs(cloud.points, cloud.mask, morton.TARGET_CHUNK)
        fn = partial(cuda_cov.radius_moments_sorted, cloud.points, cloud.mask, clo, chi,
                     cloud.points, cloud.mask, r)
        cases.append(("K1", label, r, fn, (cloud.points, cloud.mask)))
    dev = q.points.device
    dense_p, dense_m = harness.dense_cloud(scans[0], 32768, dev)
    sm = inp.submap
    for label, tp, tm in (("submap", sm.points, sm.mask), ("dense", dense_p, dense_m),
                          ("scattered", *harness.scattered(sm.points, sm.mask, 65536, 5))):
        fn = partial(cuda_nn.query_1nn, tp, tm, q.points, q.mask, 0.5)
        cases.append(("K5", label, 0.5, fn, (q.points, q.mask, tp, tm)))
    scan = inp.scan0
    for label, tp, tm in (("scan", scan.points, scan.mask), ("dense", dense_p, dense_m),
                          ("scattered", *harness.scattered(scan.points, scan.mask, 32768, 6))):
        fn = partial(cuda_cov.radius_moments, tp, tm, scan.points, 0.75)
        cases.append(("K6", label, 0.75, fn, (scan.points, tp, tm)))
    return [c for c in cases if c[0] in kernels]


def kept_outputs(kernel: str, out) -> list:
    """The outputs compared across trees, on the host: K2/K4/K5 (idx, d2,
    found), K3 (corr, weight, mu_b, n_b, best_d2, h, b, error), K1/K6 the
    moments."""
    if kernel == "K3":
        out = (out.corr, out.weight, out.mu_b, out.n_b, out.best_d2, out.h, out.b, out.error)
    elif kernel in ("K1", "K6"):
        out = (out,)
    return [o.cpu() for o in out]


def outputs_agree(kernel: str, got: list, want: list, k3_rel: float) -> bool:
    if kernel in ("K2", "K4", "K5"):
        return all(torch.equal(a, b) for a, b in zip(got, want))
    if kernel == "K3":
        exact = all(torch.equal(a, b) for a, b in zip(got[:5], want[:5]))
        scaled = all(float((a - b).abs().max()) <= k3_rel * float(b.abs().max())
                     for a, b in zip(got[5:], want[5:]))
        return exact and scaled
    a, b = got[0], want[0]
    return bool(torch.equal(a[:, 0], b[:, 0])) and bool(
        torch.all(torch.abs(a - b) <= 1e-3 + 1e-5 * torch.abs(b)))


def run_kernels(harness, cfg, tree: str, outputs: dict, kernels) -> None:
    for kernel, label, radius, fn, tensors in search_cases(harness, cfg, kernels):
        out = fn()
        torch.cuda.synchronize()
        entry_ms = harness.cuda_median_ms(fn)
        kernel_us, launches, ops, names = profiled(fn, KERNEL_NAMES[kernel])
        key = f"{kernel} {label} r={radius}"
        outputs[key] = dict(inputs=digest(*tensors), out=kept_outputs(kernel, out))
        print(json.dumps(dict(tree=tree, case=key, entry_ms=entry_ms, kernel_us=kernel_us,
                              kernel_launches_per_call=launches, device_ops_per_call=ops,
                              kernel_names=names)),
              flush=True)
        outputs[key].update(entry_ms=entry_ms, kernel_us=kernel_us)


def run_drive(harness, tree_smoke, tree: str, outputs: dict) -> None:
    cfg = tree_smoke.slice_config()
    world, scans = tree_smoke.make_world()
    main_path, _ = tree_smoke.drive(cfg, world, scans)
    prof = {b: harness.device_ops_per_frame(harness.slice_config(b), world, scans)
            for b in harness.BACKENDS}
    # launches by name in the profiled frames: a replayed graph's are not
    # counted by the wrappers
    traced = prof["pallas"].get("kernel_launches_per_frame") or {}
    line = dict(tree=tree, case="drive", ate_m=main_path["ate_m"],
                median_ms_per_frame=main_path["median_ms_per_frame"],
                k2_per_frame=traced.get("K2"), k1_per_frame=traced.get("K1"), profiled=prof)
    print(json.dumps(line), flush=True)
    outputs["drive"] = line


def worker(tree: Path, out_file: Path, modes: list[str], kernels: list[str]) -> None:
    sys.path.insert(0, str(tree))  # the tree's package wins over this one's
    import direct_lidar_odometry_tpu_torch as port
    from direct_lidar_odometry_tpu_torch.ops import cuda_build
    from direct_lidar_odometry_tpu_torch.utils.precision import pin_float32

    if not Path(port.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"kernel_ab: imported {port.__file__}, not the package under {tree}")
    harness = load_module("ab_harness", HERE / "chip_smoke.py")
    tree_smoke = load_module("tree_smoke", tree / "chip_smoke.py")
    _, build_s = cuda_build.build()
    cuda_build.library()
    print(f"# {tree}: kernels built in {build_s:.1f} s", flush=True)
    pin_float32()
    outputs: dict = {}
    if "kernels" in modes:
        run_kernels(harness, harness.slice_config(), str(tree), outputs, kernels)
    if "drive" in modes:
        run_drive(harness, tree_smoke, str(tree), outputs)
    torch.save(outputs, out_file)


def compare(trees: list[str], results: list[dict]) -> None:
    """Hold every tree's outputs against the first's and print each case's
    times by tree; fail at the end if a tree disagreed."""
    ref = results[0]
    names = list(dict.fromkeys(trees))
    k3_rel = load_module("ab_harness", HERE / "chip_smoke.py").K3_REL
    failures = []
    for key in ref:
        if key == "drive":
            def by_tree(field):
                return {n: [r["drive"][field] for t, r in zip(trees, results) if t == n]
                        for n in names}

            def profiled_by_tree(field):
                return {b: {n: [r["drive"]["profiled"][b].get(field) for t, r in zip(trees, results)
                                if t == n] for n in names} for b in ref["drive"]["profiled"]}

            print(json.dumps(dict(case="drive", median_ms_per_frame=by_tree("median_ms_per_frame"),
                                  device_ops_per_frame=profiled_by_tree("device_ops_per_frame"),
                                  device_busy_ms_per_frame=profiled_by_tree(
                                      "device_busy_ms_per_frame"))))
            continue
        agree = True
        for tree, res in zip(trees, results):
            got, want = res[key], ref[key]
            if got["inputs"] != want["inputs"]:
                raise SystemExit(f"kernel_ab: {key}: {tree} saw other inputs than {trees[0]}")
            if not outputs_agree(key.split()[0], got["out"], want["out"], k3_rel):
                failures.append(f"{key}: {tree} disagrees with {trees[0]}")
                agree = False
        line = dict(case=key, agree=agree)
        for field in ("entry_ms", "kernel_us"):
            by = {n: [r[key][field] for t, r in zip(trees, results) if t == n] for n in names}
            line[field] = by
            if len(names) == 2:
                line[f"{field}_ratio"] = float(np.mean(by[names[0]]) / np.mean(by[names[1]]))
        print(json.dumps(line))
    if failures:
        raise SystemExit("kernel_ab: " + "; ".join(failures))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path, help="checkout roots, in the order to run")
    ap.add_argument("--modes", nargs="+", choices=MODES, default=list(MODES))
    ap.add_argument("--kernels", nargs="+", choices=list(KERNEL_NAMES),
                    default=list(KERNEL_NAMES), help="the kernels the kernels mode times")
    ap.add_argument("--out", type=Path, default=HERE / "chiprun_out" / "kernel_ab")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    if args.worker is not None:
        worker(args.trees[0].resolve(), args.worker, args.modes, args.kernels)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    trees = [str(t.resolve()) for t in args.trees]
    results = []
    for i, tree in enumerate(trees):
        out_file = args.out / f"{i}.pt"
        subprocess.run([sys.executable, str(Path(__file__).resolve()), tree, "--worker",
                        str(out_file), "--modes", *args.modes, "--kernels", *args.kernels],
                       check=True)
        results.append(torch.load(out_file))
    compare(trees, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
