#!/usr/bin/env python3
"""A/B of the port across source trees on one NVIDIA GPU: the pruned
searches K2 and K1 at the shapes of ``chip_smoke.py`` phase 3, and the
per-frame drive of its phase 4.

    mkdir -p _scratch/parent          # _scratch/ is in .gitignore
    git archive <commit> | tar -x -C _scratch/parent
    python3 kernel_ab.py _scratch/parent . . _scratch/parent

Each argument is the root of a checkout (its ``direct_lidar_odometry_tpu_torch``
and its ``chip_smoke.py``). Each runs in a process of its own, in the order
given, so two trees alternate in one call. A process builds that tree's
kernels with that tree's builder and goes through that tree's code only by
what every tree offers:

- ``kernels``: K2 through ``cuda_nn.query_1nn_sorted`` and K1 through
  ``cuda_cov.radius_moments_sorted`` (the JAX package's signatures), at
  S2M r 0.5 / 1.0 / 1.5, S2S r 1.0 and a loop edge (keyframe against
  keyframe at the loop gate) for K2, scan r 0.75 and keyframe r 1.5 for
  K1: the entry's device time (CUDA events behind a device sleep, median
  of 20), the kernel's own device time (torch.profiler, mean of 20
  launches; the rest of the entry, such as building candidate lists, is
  the difference), and the device operations of one entry call;
- ``drive``: the tree's own ``chip_smoke.drive`` (30 frames on "pallas"
  with that tree's checks), then six steady frames under torch.profiler
  (``chip_smoke.device_ops_per_frame`` of this tree).

The inputs come from this tree's ``chip_smoke.kernel_inputs`` run against
each tree's package. The first tree's inputs and outputs are the
reference: the script fails if another tree saw other inputs, if K2's
idx or d2 differ in a bit, or if K1's counts differ or its moments leave
1e-3 + 1e-5 |.|. Prints the card's name and power limit, one JSON line per
tree and case, then one line per case with every tree's times and the
first tree's mean over the second's. Imports torch and the port, nothing
of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import torch

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


def profiled(fn, kernel: str, runs: int = RUNS) -> tuple[float, float, float]:
    """(mean device us of the kernels whose name holds ``kernel``, their
    launches per call, device operations per call) over ``runs`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    mine = [e.time_range.elapsed_us() for e in ops if kernel in e.name]
    return (float(np.mean(mine)) if mine else float("nan"), len(mine) / runs, len(ops) / runs)


def search_cases(harness, cfg):
    """(kernel, label, radius, entry call, kernel name, input tensors)."""
    from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_nn, morton

    world, scans = harness.make_world()
    inp = harness.kernel_inputs(cfg, world, scans, torch.device("cuda"))
    k2 = [("S2M", inp.queries, inp.submap, r) for r in (0.5, 1.0, 1.5)]
    k2 += [("S2S", inp.queries, inp.s2s, 1.0),
           ("loop edge", inp.edge_src, inp.edge_tgt, cfg.posegraph.loop_corr_distance)]
    cases = []
    for label, q, t, r in k2:
        fn = partial(cuda_nn.query_1nn_sorted, t.points, t.mask, t.chunk_lo, t.chunk_hi,
                     q.points, q.mask, r)
        cases.append(("K2", label, r, fn, "nn1_pruned", (q.points, q.mask, t.points, t.mask)))
    for label, cloud, r in (("scan", inp.scan0, 0.75), ("keyframe", inp.kf0, 1.5)):
        clo, chi = morton.chunk_aabbs(cloud.points, cloud.mask, morton.TARGET_CHUNK)
        fn = partial(cuda_cov.radius_moments_sorted, cloud.points, cloud.mask, clo, chi,
                     cloud.points, cloud.mask, r)
        cases.append(("K1", label, r, fn, "cov_pruned", (cloud.points, cloud.mask)))
    return cases


def run_kernels(harness, cfg, tree: str, outputs: dict) -> None:
    for kernel, label, radius, fn, name, tensors in search_cases(harness, cfg):
        out = fn()
        torch.cuda.synchronize()
        entry_ms = harness.cuda_median_ms(fn)
        kernel_us, launches, ops = profiled(fn, name)
        key = f"{kernel} {label} r={radius}"
        outputs[key] = dict(inputs=digest(*tensors),
                            out=[o.cpu() for o in out] if kernel == "K2" else [out.cpu()])
        print(json.dumps(dict(tree=tree, case=key, entry_ms=entry_ms, kernel_us=kernel_us,
                              kernel_launches_per_call=launches, device_ops_per_call=ops)),
              flush=True)
        outputs[key].update(entry_ms=entry_ms, kernel_us=kernel_us)


def run_drive(harness, tree_smoke, tree: str, outputs: dict) -> None:
    cfg = tree_smoke.slice_config()
    world, scans = tree_smoke.make_world()
    main_path, _ = tree_smoke.drive(cfg, world, scans)
    steps = main_path["frames"] - 1
    launches = main_path["launches"]
    prof = harness.device_ops_per_frame(cfg, world, scans)
    line = dict(tree=tree, case="drive", ate_m=main_path["ate_m"],
                median_ms_per_frame=main_path["median_ms_per_frame"],
                k2_per_frame=launches["nn1_pruned"]["cuda"] / steps,
                k1_per_frame=launches["cov_pruned"]["cuda"] / steps, **prof)
    print(json.dumps(line), flush=True)
    outputs["drive"] = line


def worker(tree: Path, out_file: Path, modes: list[str]) -> None:
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
        run_kernels(harness, harness.slice_config(), str(tree), outputs)
    if "drive" in modes:
        run_drive(harness, tree_smoke, str(tree), outputs)
    torch.save(outputs, out_file)


def compare(trees: list[str], results: list[dict]) -> None:
    """Hold every tree's outputs against the first's and print each case's
    times by tree."""
    ref = results[0]
    names = list(dict.fromkeys(trees))
    for key in ref:
        if key == "drive":
            per_tree = {n: [r["drive"]["median_ms_per_frame"] for t, r in zip(trees, results)
                            if t == n] for n in names}
            ops = {n: [r["drive"]["device_ops_per_frame"] for t, r in zip(trees, results)
                       if t == n] for n in names}
            print(json.dumps(dict(case="drive", median_ms_per_frame=per_tree,
                                  device_ops_per_frame=ops)))
            continue
        for tree, res in zip(trees, results):
            got, want = res[key], ref[key]
            if got["inputs"] != want["inputs"]:
                raise SystemExit(f"kernel_ab: {key}: {tree} saw other inputs than {trees[0]}")
            if key.startswith("K2"):
                same = all(torch.equal(a, b) for a, b in zip(got["out"], want["out"]))
            else:
                a, b = got["out"][0], want["out"][0]
                same = bool(torch.equal(a[:, 0], b[:, 0])) and bool(
                    torch.all(torch.abs(a - b) <= 1e-3 + 1e-5 * torch.abs(b)))
            if not same:
                raise SystemExit(f"kernel_ab: {key}: {tree} disagrees with {trees[0]}")
        line = dict(case=key, agree=True)
        for field in ("entry_ms", "kernel_us"):
            by = {n: [r[key][field] for t, r in zip(trees, results) if t == n] for n in names}
            line[field] = by
            if len(names) == 2:
                line[f"{field}_ratio"] = float(np.mean(by[names[0]]) / np.mean(by[names[1]]))
        print(json.dumps(line))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path, help="checkout roots, in the order to run")
    ap.add_argument("--modes", nargs="+", choices=MODES, default=list(MODES))
    ap.add_argument("--out", type=Path, default=HERE / "chiprun_out" / "kernel_ab")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    if args.worker is not None:
        worker(args.trees[0].resolve(), args.worker, args.modes)
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
                        str(out_file), "--modes", *args.modes], check=True)
        results.append(torch.load(out_file))
    compare(trees, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
