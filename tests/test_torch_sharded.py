"""The port's sharded forms (``parallel/sharded.py``) over
``torch.distributed`` with the gloo backend, on the CPU.

Three worker processes (this file run as a script, below) join two
process groups on free localhost ports: two ranks holding one lane each of
a B = 2 batched drive, and one rank alone (world size 1). Each runs the
sharded step (``make_sharded_step``) and the edge-split pose-graph
refinement (``make_distributed_refine``) and writes its results; the tests
hold them against the port's unsharded batched step and
``posegraph.refine``, and against the JAX package's ``make_sharded_step``
and ``make_distributed_refine`` on a 2-device CPU mesh. The lanes are two
worlds of tests/test_torch_batched.py, rendered here and handed to the
workers in a file, at the shapes of tests/test_pallas_e2e.py.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
B = 2
STEPS = 2
# tests/test_pallas_e2e.py pallas_cfg's shapes
SHAPES = dict(n_raw=4096, n_scan=2048, n_keyframe=1024, max_keyframes=16, max_submap_kf=4,
              n_submap_flat=4096, imu_window=32, grid_table_size=2 ** 12,
              submap_table_size=2 ** 12, cell_cap_1nn=8, cell_cap_knn=32, knn_query_chunk=1024,
              hull_directions=16)
REFINE_ITERS = 5


def load_frames(path):
    """[STEPS + 1] raw frames of B lanes: (points [B, n, 3], mask [B, n])."""
    f = np.load(path)
    return [(f[f"points_{t}"], f[f"mask_{t}"]) for t in range(STEPS + 1)]


def port_cfg():
    from direct_lidar_odometry_tpu_torch import config as tcfg

    return tcfg.DloConfig().replace(nn_backend="pallas", shapes=tcfg.ShapeConfig(**SHAPES))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(rank: int, world: int, port: int, frames_path: str, graph_path: str,
           out_path: str) -> None:
    """One rank: the sharded drive of its B / world lanes and the
    distributed refine, written to ``out_path``; at world size 1 also the
    unsharded forms on the same inputs, compared bit for bit."""
    import torch
    import torch.distributed as dist

    from direct_lidar_odometry_tpu_torch.parallel import batched, posegraph, sharded

    torch.set_num_threads(1)  # three workers share the test machine's cores
    sharded.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = sharded.make_mesh(world, device="cpu")
    assert (mesh.size, mesh.rank, mesh.group is not None) == (world, rank, True)
    cfg = port_cfg()
    data = [tuple(torch.from_numpy(a) for a in f) for f in load_frames(frames_path)]
    eye = torch.eye(4).expand(B, 4, 4).clone()
    init_fn, step_fn = batched.make_batched_fns(cfg)
    step = sharded.make_sharded_step(cfg, mesh)

    states = init_fn(sharded.shard_states(batched.batched_state(cfg, B, "cpu"), mesh),
                     *sharded.shard_states(data[0], mesh))
    if world == 1:
        plain = init_fn(batched.batched_state(cfg, B, "cpu"), *data[0])
    out = {}
    bitwise = True
    sharded.barrier("drive")
    for t in range(1, STEPS + 1):
        args = sharded.shard_states((*data[t], eye), mesh)
        states, res, mean_corr, max_err = step(states, *args)
        out[f"position_{t}"] = res.position.numpy()
        out[f"s2m_num_corr_{t}"] = res.s2m_num_corr.numpy()
        out[f"mean_corr_{t}"] = mean_corr.numpy()
        out[f"max_err_{t}"] = max_err.numpy()
        if world == 1:
            plain, pres = step_fn(plain, *data[t], eye)
            bitwise &= all(torch.equal(a, b) for a, b in zip(res, pres))
            bitwise &= all(torch.equal(a, b) for a, b in zip(states.keyframes, plain.keyframes))
            bitwise &= all(torch.equal(getattr(states, f), getattr(plain, f))
                           for f in states._fields if f not in ("keyframes", "submap_grid"))

    g = np.load(graph_path)
    graph = posegraph.PoseGraph(*(torch.from_numpy(g[f]) for f in posegraph.PoseGraph._fields))
    poses, err = sharded.make_distributed_refine(mesh, REFINE_ITERS)(graph)
    out["refine_poses"], out["refine_err"] = poses.numpy(), err.numpy()
    if world == 1:
        single, serr = posegraph.refine(graph, iterations=REFINE_ITERS)
        bitwise &= torch.equal(single, poses) and torch.equal(serr, err)
    out["bitwise"] = np.asarray(bitwise)
    np.savez(out_path, **out)
    sharded.barrier("done")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    """Two worlds' scans (tests/test_torch_batched.py), one a lane, in a
    file for the workers: (worlds, frames, path)."""
    from tests.test_torch_batched import _render, _stack, _world

    worlds = [_world(0), _world(1)]
    frames = [_stack([_render(w, t, 50 + t + 100 * b) for b, w in enumerate(worlds)],
                     SHAPES["n_raw"]) for t in range(STEPS + 1)]
    path = tmp_path_factory.mktemp("lanes") / "frames.npz"
    np.savez(path, **{f"{k}_{t}": a for t, f in enumerate(frames)
                      for k, a in zip(("points", "mask"), f)})
    return worlds, frames, str(path)


@pytest.fixture(scope="module")
def noisy_graph(tmp_path_factory):
    """The JAX package's noisy 10-keyframe chain (tests/test_parallel.py),
    16 edges, as numpy, and its file for the workers."""
    from tests.test_parallel import make_noisy_chain

    gt, noisy, edges, rels, emask = make_noisy_chain(np.random.default_rng(1), k=10, m=16)
    graph = dict(poses=noisy, pose_mask=np.ones(len(gt), bool), edges=edges.astype(np.int64),
                 rel=rels, edge_mask=emask, weights=np.ones(len(edges), np.float32))
    path = tmp_path_factory.mktemp("graph") / "graph.npz"
    np.savez(path, **graph)
    return graph, str(path)


@pytest.fixture(scope="module")
def ranks(lanes, noisy_graph, tmp_path_factory):
    """Run the three workers together: {(world, rank): results}."""
    out_dir = tmp_path_factory.mktemp("ranks")
    # no card for the workers, which ask for gloo on the CPU
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    jobs = {}
    for world in (2, 1):
        port = _free_port()
        for rank in range(world):
            out = out_dir / f"w{world}r{rank}.npz"
            cmd = [sys.executable, __file__, str(rank), str(world), str(port), lanes[2],
                   noisy_graph[1], str(out)]
            jobs[(world, rank)] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
                cwd=str(REPO)))
    logs = {}
    try:
        for key, (_, proc) in jobs.items():
            logs[key], _ = proc.communicate(timeout=600)
    finally:
        for _, proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
    for key, (out, proc) in jobs.items():
        tail = "\n".join(logs[key].splitlines()[-30:])
        assert proc.returncode == 0, f"world {key[0]} rank {key[1]} failed:\n{tail}"
    return {key: dict(np.load(out)) for key, (out, _) in jobs.items()}


@pytest.fixture(scope="module")
def unsharded(lanes):
    """The port's batched step on all B lanes, in this process."""
    import torch

    from direct_lidar_odometry_tpu_torch.parallel import batched

    cfg = port_cfg()
    data = [tuple(torch.from_numpy(a) for a in f) for f in lanes[1]]
    init_fn, step_fn = batched.make_batched_fns(cfg)
    states = init_fn(batched.batched_state(cfg, B, "cpu"), *data[0])
    eye = torch.eye(4).expand(B, 4, 4).clone()
    results = []
    for t in range(1, STEPS + 1):
        states, res = step_fn(states, *data[t], eye)
        results.append(res)
    return results


def test_one_lane_a_rank_equals_the_batched_step(lanes, ranks, unsharded):
    """Rank r of the 2-process group holds lane r: its poses equal lane r
    of the unsharded B = 2 step within 1e-5 m and track its world."""
    worlds = lanes[0]
    for t, res in enumerate(unsharded, start=1):
        for rank in range(2):
            got = ranks[(2, rank)][f"position_{t}"]
            assert got.shape == (1, 3)
            np.testing.assert_allclose(got[0], res.position[rank].numpy(), atol=1e-5)
            w = worlds[rank]
            gt = (np.linalg.inv(w.poses[0]) @ w.poses[t])[:3, 3]
            assert np.linalg.norm(got[0] - gt) < 0.05


def test_fleet_health_matches_jax_sharded_step(lanes, ranks, unsharded):
    """The all-reduced fleet health on both ranks: mean S2M correspondences
    equal to the unsharded lanes' mean and to the JAX package's
    ``make_sharded_step`` on a 2-device mesh exactly, max error within
    rtol 1e-4 of both."""
    import jax.numpy as jnp

    from direct_lidar_odometry_tpu.config import DloConfig, ShapeConfig
    from direct_lidar_odometry_tpu.parallel import batched as jbatched, sharded as jsharded

    jcfg = DloConfig().replace(nn_backend="pallas", shapes=ShapeConfig(**SHAPES))
    mesh = jsharded.make_mesh(2)
    init_fn, _ = jbatched.make_batched_fns(jcfg)
    step = jsharded.make_sharded_step(jcfg, mesh)
    data = lanes[1]
    states = jsharded.shard_states(
        init_fn(jbatched.batched_state(jcfg, B), *(jnp.asarray(a) for a in data[0])), mesh)
    eye = jnp.tile(jnp.eye(4, dtype=jnp.float32), (B, 1, 1))
    for t in range(1, STEPS + 1):
        states, res, mean_corr, max_err = step(states, *(jnp.asarray(a) for a in data[t]), eye)
        port = unsharded[t - 1]
        for rank in range(2):
            r = ranks[(2, rank)]
            assert float(r[f"mean_corr_{t}"]) == float(mean_corr)
            assert float(r[f"mean_corr_{t}"]) == float(port.s2m_num_corr.float().mean())
            np.testing.assert_allclose(float(r[f"max_err_{t}"]), float(max_err), rtol=1e-4)
            np.testing.assert_allclose(float(r[f"max_err_{t}"]), float(port.s2m_error.max()),
                                       rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(res.s2m_num_corr), port.s2m_num_corr.numpy())
        assert float(mean_corr) > 100


def test_distributed_refine_matches_single_and_jax(ranks, noisy_graph):
    """Edges split over the 2 ranks: the refined poses equal the port's
    ``posegraph.refine`` and the JAX package's ``make_distributed_refine``
    on a 2-device mesh within 2e-4 (tests/test_parallel.py), replicated on
    both ranks."""
    import jax.numpy as jnp
    import torch

    from direct_lidar_odometry_tpu.parallel import posegraph as jposegraph, sharded as jsharded
    from direct_lidar_odometry_tpu_torch.parallel import posegraph

    graph, _ = noisy_graph
    single, err_s = posegraph.refine(
        posegraph.PoseGraph(*(torch.from_numpy(graph[f]) for f in posegraph.PoseGraph._fields)),
        iterations=REFINE_ITERS)
    jgraph = jposegraph.PoseGraph(**{k: jnp.asarray(v) for k, v in graph.items()})
    jdist, jerr = jsharded.make_distributed_refine(jsharded.make_mesh(2, axis="edge"),
                                                   iterations=REFINE_ITERS)(jgraph)
    for rank in range(2):
        got = ranks[(2, rank)]
        np.testing.assert_allclose(got["refine_poses"], single.numpy(), atol=2e-4)
        np.testing.assert_allclose(got["refine_poses"], np.asarray(jdist), atol=2e-4)
        np.testing.assert_allclose(float(got["refine_err"]), float(err_s), rtol=1e-3, atol=1e-9)
        np.testing.assert_allclose(float(got["refine_err"]), float(jerr), rtol=1e-3, atol=1e-9)
    np.testing.assert_array_equal(ranks[(2, 0)]["refine_poses"], ranks[(2, 1)]["refine_poses"])


def test_world_size_one_is_bitwise_unsharded(ranks):
    """A group of one: the sharded step's states and results and the
    distributed refine equal the unsharded forms bit for bit."""
    assert bool(ranks[(1, 0)]["bitwise"])
    assert ranks[(1, 0)]["position_1"].shape == (B, 3)


def test_alone_without_a_group(monkeypatch):
    """No argument and no torchrun environment: no group is made, the mesh
    is this process alone and the barrier returns."""
    import torch.distributed as dist

    from direct_lidar_odometry_tpu_torch.parallel import sharded

    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    sharded.init_distributed(device="cpu")
    assert not dist.is_initialized()
    mesh = sharded.make_mesh(1, device="cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.device.type) == (1, 0, None, "cpu")
    sharded.barrier("alone")
    with pytest.raises(ValueError, match="group of that size"):
        sharded.make_mesh(2, device="cpu")


NO_CARD_CHECK = """
import sys, tempfile
import torch.distributed as dist
from direct_lidar_odometry_tpu_torch.parallel import sharded

for call in (sharded.make_mesh, lambda: sharded.make_mesh(1),
             lambda: sharded.init_distributed("127.0.0.1:{port}", 1, 0),
             lambda: sharded.init_distributed()):
    try:
        out = call()
    except RuntimeError as e:
        assert "CUDA is not available" in str(e), e
    else:
        sys.exit(f"returned {{out!r}} without a card")
    assert not dist.is_initialized()
mesh = sharded.make_mesh(device="cpu")
assert (mesh.size, mesh.rank, mesh.group, mesh.device.type) == (1, 0, None, "cpu")
with tempfile.TemporaryDirectory() as tmp:
    sharded.init_distributed(f"file://{{tmp}}/store", 1, 0, device="cpu")
    assert dist.get_backend() == "gloo"
    mesh = sharded.make_mesh(1, device="cpu")
    assert (mesh.size, mesh.device.type, mesh.group is not None) == (1, "cpu", True)
    dist.destroy_process_group()
print("ok")
"""


def test_no_silent_cpu_without_a_card():
    """With the card hidden, ``make_mesh()`` and ``init_distributed(...)``
    without a device raise (no CPU mesh, no gloo group); with
    ``device="cpu"`` they give a CPU mesh and a gloo group as before."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(name, None)
    proc = subprocess.run([sys.executable, "-c", NO_CARD_CHECK.format(port=_free_port())],
                          cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
