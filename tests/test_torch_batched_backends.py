"""The port's batched step on the tensor-op backends ("brute", "hashgrid"),
on the CPU.

- the exhaustive and hash-grid searches over B lanes equal their per-lane
  calls bit for bit, and agree with ``jax.vmap`` of the JAX package's
  searches within the single-lane tolerances of
  ``tests/test_torch_backends.py``; so do the k-NN normals;
- a batched ``hashgrid.build`` gives each lane the leaves of its own build
  and of ``jax.vmap(hashgrid.build)``, bit for bit;
- ``batched_state`` stacks the fresh hash grid;
- the batched step against the JAX package's ``make_batched_fns`` (plain
  XLA on these backends), and each lane against the port's own
  single-sequence ``odom_frame(hull_masks=None)``, also with lanes that
  take different branches in one step; host reads a step do not grow with
  B;
- the sharded step on "hashgrid": at world size 1 bitwise the batched
  step, and ``shard_states`` gives each rank its lanes' grid leaves.

The card's lanes: ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu.ops import bruteforce as jbf, hashgrid as jhg
from direct_lidar_odometry_tpu.parallel import batched as jbatched
from direct_lidar_odometry_tpu.registration import covariance as jcov
from direct_lidar_odometry_tpu_torch.odometry import pipeline as tpipe
from direct_lidar_odometry_tpu_torch.ops import bruteforce as tbf, hashgrid as thg
from direct_lidar_odometry_tpu_torch.parallel import batched, sharded
from direct_lidar_odometry_tpu_torch.registration import covariance as tcov, gicp as tgicp
from tests.test_pallas_e2e import pallas_cfg
from tests.test_torch_backends import _check_1nn, _check_knn, _cloud, _queries, _t
from tests.test_torch_batched import (
    N_FRAMES, _assert_lane_equals_single, _ate, _port_batched, _port_cfg, _port_single, _render,
    _stack, _world,
)

LANES = 3
BACKENDS = ["brute", "hashgrid"]


def _lanes(seeds, n=4096, noise=0.05, **kw):
    """Stacked clouds and queries, one seed a lane: numpy [B, ...]."""
    parts = []
    for s in seeds:
        pts, mask = _cloud(s, n=n, **kw)
        parts.append((pts, mask, *_queries(pts, mask, s + 50, n=2048, noise=noise)))
    return [np.stack(x) for x in zip(*parts)]


def _vmapped(fn, *args):
    return [np.asarray(a) for a in jax.vmap(fn)(*(jnp.asarray(a) for a in args))]


@pytest.mark.parametrize("backend,search", [("brute", "1nn"), ("brute", "knn"),
                                            ("hashgrid", "1nn"), ("hashgrid", "knn")])
def test_search_lanes_equal_per_lane_calls(backend, search, monkeypatch):
    """B = 3 lanes in one call: each lane's (idx, d2, found) is its own
    call's bit for bit (the brute tiles cut below one lane's size, so the
    lanes share several query tiles); against ``jax.vmap`` of the JAX
    search, each lane within the single-lane tolerances, on the clouds of
    the single-lane tests (``tests/test_torch_backends.py``)."""
    if search == "1nn":
        pts, mask, q, qm = _lanes([21, 22, 23], noise=0.3)
    elif backend == "brute":
        pts, mask, q, qm = _lanes([21, 22, 23], n=2048)
    else:
        pts, mask, q, qm = _lanes([21, 22, 23], extent=8.0)
    tp, tm, tq, tqm = (_t(a) for a in (pts, mask, q, qm))
    if backend == "brute":
        monkeypatch.setattr(tbf, "MAX_ELEMS", 300 * 2048)
        if search == "1nn":
            def port(p, m, x, xm):
                return tbf.query_1nn(p, m, x, xm, 0.5, tile=2048)

            def ref(p, m, x, xm):
                return jbf.query_1nn(p, m, x, xm, 0.5, tile=2048)
        else:
            def port(p, m, x, xm):
                return tbf.query_knn(p, m, x, xm, 10, chunk=1024)

            def ref(p, m, x, xm):
                return jbf.query_knn(p, m, x, xm, 10, chunk=1024)
        got = port(tp, tm, tq, tqm)
        per = [port(tp[b], tm[b], tq[b], tqm[b]) for b in range(LANES)]
        want = _vmapped(ref, pts, mask, q, qm)
    else:
        cap = 16 if search == "1nn" else 48
        grid = thg.build(tp, tm, 1.0, 2**12)
        if search == "1nn":
            def port(g, x, xm):
                return thg.query_1nn(g, x, xm, 1.0, cap)

            def ref(p, m, x, xm):
                return jhg.query_1nn(jhg.build(p, m, 1.0, 2**12), x, xm, 1.0, cap)
        else:
            def port(g, x, xm):
                return thg.query_knn(g, x, xm, 10, cap, chunk=1024)

            def ref(p, m, x, xm):
                return jhg.query_knn(jhg.build(p, m, 1.0, 2**12), x, xm, 10, cap, chunk=1024)
        got = port(grid, tq, tqm)
        per = [port(thg.build(tp[b], tm[b], 1.0, 2**12), tq[b], tqm[b]) for b in range(LANES)]
        want = _vmapped(ref, pts, mask, q, qm)
    for b in range(LANES):
        for x, y in zip(got, per[b]):
            assert x.dtype == y.dtype and torch.equal(x[b], y)
        ref_b, got_b = [w[b] for w in want], [x[b] for x in got]
        if search == "1nn":
            _check_1nn(ref_b, got_b, q[b], pts[b])
        else:
            # the exhaustive k-NN lanes are dense planar clouds: the JAX
            # package's own unbatched call swaps 1.1-2.1 % of their
            # neighbours at near-ties against the port, so up to 3 %
            _check_knn(ref_b, got_b, q[b], pts[b], share=0.03 if backend == "brute" else 0.01)


def test_hashgrid_build_lanes_match_single_and_vmapped_reference():
    """Every leaf of a B = 3 build, ``cell_size`` ([B]) included, is each
    lane's own build and ``jax.vmap(hashgrid.build)``'s, same dtype, same
    bits; the lanes' clouds differ in extent, so their tables differ."""
    pts, mask, _, _ = _lanes([31, 32, 33], n=4096)
    pts[1] *= 0.25
    grid = thg.build(_t(pts), _t(mask), 1.0, 2**12)
    ref = jax.vmap(lambda p, m: jhg.build(p, m, 1.0, 2**12))(jnp.asarray(pts), jnp.asarray(mask))
    assert grid.capacity == 4096 and grid.table_size == 2**12
    for f in thg.HashGrid._fields:
        got, want = getattr(grid, f), np.array(getattr(ref, f))
        assert got.shape[0] == LANES and got.dtype == _t(want).dtype, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
        for b in range(LANES):
            assert torch.equal(got[b], getattr(thg.build(_t(pts[b]), _t(mask[b]), 1.0, 2**12), f))
    assert not torch.equal(grid.count[0], grid.count[1])


@pytest.mark.parametrize("kind", ["brute", "twoscale"])
def test_normals_lanes_equal_per_lane_calls(kind):
    """``estimate_normals_brute`` / ``estimate_normals_twoscale`` over B = 3
    lanes: each lane's normals and valid mask are its own call's bit for
    bit; against ``jax.vmap`` of the JAX estimate, valid masks equal and
    normals within 1e-4 up to sign."""
    pts, mask, _, _ = _lanes([41, 42, 43], n=2048, extent=6.0)
    tp, tm = _t(pts), _t(mask)
    if kind == "brute":
        def port(p, m):
            return tcov.estimate_normals_brute(p, m, k=10, chunk=1024)

        def ref(p, m):
            return tuple(jcov.estimate_normals_brute(p, m, k=10, chunk=1024))
    else:
        def port(p, m):
            return tcov.estimate_normals_twoscale(p, m, k=10, cap=32, chunk=1024,
                                                  table_size=2**12)

        def ref(p, m):
            return tuple(jcov.estimate_normals_twoscale(p, m, k=10, cap=32, chunk=1024,
                                                        table_size=2**12))
    got = port(tp, tm)
    jn, jv = _vmapped(ref, pts, mask)
    for b in range(LANES):
        one = port(tp[b], tm[b])
        assert torch.equal(got.normals[b], one.normals) and torch.equal(got.valid[b], one.valid)
        np.testing.assert_array_equal(got.valid[b].numpy(), jv[b])
        assert jv[b].sum() > 1000
        dots = np.abs(np.sum(jn[b][jv[b]] * got.normals[b].numpy()[jv[b]], axis=-1))
        assert np.all(np.abs(dots - 1.0) <= 1e-4), dots.min()


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_state_stacks_the_fresh_grid(backend):
    """``batched_state`` takes both backends: on "hashgrid" the fresh S2M
    grid gets a leading [B] on every leaf (``cell_size`` [B]), each lane
    its own storage; "brute" carries no grid."""
    cfg = _port_cfg(pallas_cfg(nn_backend=backend))
    st = batched.batched_state(cfg, LANES, device="cpu")
    one = tpipe.fresh_state(cfg, device="cpu")
    if backend == "brute":
        assert st.submap_grid is None and one.submap_grid is None
        return
    assert st.submap_grid.cell_size.shape == (LANES,)
    for a, b in zip(one.submap_grid, st.submap_grid):
        assert b.shape == (LANES,) + a.shape
        assert all(torch.equal(b[i], a) for i in range(LANES))
    st.submap_grid.start[0].zero_()
    assert not torch.equal(st.submap_grid.start[1], st.submap_grid.start[0])


# --- the batched step -------------------------------------------------------

@pytest.fixture(scope="module")
def two_worlds():
    worlds = [_world(0), _world(1)]
    frames = [[_render(w, t, 50 + t + 100 * b) for b, w in enumerate(worlds)]
              for t in range(N_FRAMES)]
    return worlds, frames


@pytest.fixture(scope="module", params=BACKENDS)
def drive(request, two_worlds):
    """backend -> (cfg, the port's batched drive of B = 2 lanes, each lane's
    single-sequence drive)."""
    _, frames = two_worlds
    cfg = _port_cfg(pallas_cfg(nn_backend=request.param))
    singles = [_port_single(cfg, [f[b] for f in frames]) for b in range(2)]
    return request.param, cfg, _port_batched(cfg, frames), singles


def test_batched_step_matches_jax_make_batched_fns(two_worlds, drive):
    """B = 2 lanes, 5 frames: the port's batched step against the JAX
    package's vmapped step on the same raw scans: positions within 5e-3 m,
    the same spawn decisions per lane, ATE < 0.05 m for both."""
    worlds, frames = two_worlds
    backend, _, (port_res, _), _ = drive
    jcfg = pallas_cfg(nn_backend=backend)
    init_fn, step_fn = jbatched.make_batched_fns(jcfg)
    st = init_fn(jbatched.batched_state(jcfg, 2),
                 *(jnp.asarray(a) for a in _stack(frames[0], jcfg.shapes.n_raw)))
    eye = jnp.tile(jnp.eye(4, dtype=jnp.float32), (2, 1, 1))
    jres = []
    for scans in frames[1:]:
        st, res = step_fn(st, *(jnp.asarray(a) for a in _stack(scans, jcfg.shapes.n_raw)), eye)
        jres.append(jax.tree_util.tree_map(np.asarray, res))
    for rp, rj in zip(port_res, jres):
        np.testing.assert_allclose(rp.position.numpy(), rj.position, atol=5e-3)
        np.testing.assert_array_equal(rp.new_keyframe.numpy(), rj.new_keyframe)
    for b, w in enumerate(worlds):
        assert _ate(np.stack([r.position[b].numpy() for r in port_res]), w) < 0.05
        assert _ate(np.stack([r.position[b] for r in jres]), w) < 0.05


def test_each_lane_equals_its_single_sequence_run(drive):
    """Each lane against the port's single-sequence odom_frame(hull_masks=
    None) on its own scans: the same poses and S2M errors bit for bit, the
    same GICP iteration counts, spawns and submap changes; the B = 2 step
    reads no more than the slower lane's single run plus two."""
    _, _, (res, reads), singles = drive
    for b, (single_res, _) in enumerate(singles):
        _assert_lane_equals_single(res, b, single_res)
    for t, r in enumerate(reads):
        assert r <= max(s[1][t] for s in singles) + 2


def test_lanes_taking_different_branches_on_hashgrid(two_worlds):
    """Lane 0 moves through the first world and spawns, lane 1 stands still
    in it and never spawns; at the last step lane 1's scan is degraded (0.3
    m noise), so its S2M stage takes the rescue while lane 0's does not.
    The rescue's wide-gate grid (cell = ``rescue_corr_distance``) is built
    once, over lane 1's submap alone, and each lane still equals its own
    single run."""
    worlds, frames = two_worlds
    w = worlds[0]
    lane0 = [f[0] for f in frames]
    lane1 = [_render(w, 0, 90)] * (N_FRAMES - 1) + [_render(w, 0, 91, noise=0.3)]
    cfg = _port_cfg(pallas_cfg(nn_backend="hashgrid"))
    wide = cfg.gicp.rescue_corr_distance
    seen, wide_builds = [], []
    align, build = tgicp.align_batched, thg.build

    def spy_align(src, target, guess, stage, backend="pallas", active=None, cap=16):
        if active is not None:
            seen.append(list(active[1]))
        return align(src, target, guess, stage, backend, active, cap)

    def spy_build(points, mask, cell_size, table_size):
        if float(cell_size) == wide:
            wide_builds.append(tuple(points.shape))
        return build(points, mask, cell_size, table_size)

    tgicp.align_batched, thg.build = spy_align, spy_build
    try:
        res, _ = _port_batched(cfg, [[a, b] for a, b in zip(lane0, lane1)])
    finally:
        tgicp.align_batched, thg.build = align, build
    spawned = np.stack([r.new_keyframe.numpy() for r in res])
    assert spawned[:, 0].any() and not spawned[:, 1].any()
    assert seen and all(a == [False, True] for a in seen)
    assert wide_builds == [(1, cfg.shapes.n_submap_flat, 3)]
    _assert_lane_equals_single(res, 0, _port_single(cfg, lane0)[0])
    _assert_lane_equals_single(res, 1, _port_single(cfg, lane1)[0])


def test_host_reads_do_not_grow_with_lanes_on_hashgrid(two_worlds):
    """A B = 1 batched step reads the host as often as the single-sequence
    step; three copies of the same lane read exactly as often as one (the
    first three frames)."""
    _, frames = two_worlds
    cfg = _port_cfg(pallas_cfg(nn_backend="hashgrid"))
    lane = [f[0] for f in frames[:3]]
    one = _port_batched(cfg, [[s] for s in lane])[1]
    three = _port_batched(cfg, [[s, s, s] for s in lane])[1]
    assert one == _port_single(cfg, lane)[1]
    assert three == one


def test_sharded_step_on_hashgrid(two_worlds):
    """With no process group (world size 1) ``make_sharded_step`` gives the
    batched step's results and states bit for bit, the grid leaves
    included; at a two-rank mesh ``shard_states`` gives each rank its own
    lane's grid leaves (``cell_size`` too), and that rank's sharded step
    over them equals its lane of the batched step."""
    _, frames = two_worlds
    frames = frames[:3]
    cfg = _port_cfg(pallas_cfg(nn_backend="hashgrid"))
    init_fn, step_fn = batched.make_batched_fns(cfg)
    raw = [tuple(_t(a) for a in _stack(f, cfg.shapes.n_raw)) for f in frames]
    eye = torch.eye(4).expand(2, 4, 4).clone()

    def run(mesh):
        st = init_fn(sharded.shard_states(batched.batched_state(cfg, 2, device="cpu"), mesh),
                     *sharded.shard_states(raw[0], mesh))
        step, out = sharded.make_sharded_step(cfg, mesh), []
        for pts, mask in raw[1:]:
            st, res, mean_corr, max_err = step(st, *sharded.shard_states((pts, mask), mesh),
                                               sharded.shard_states(eye, mesh))
            out.append(res)
        return st, out

    st_b = init_fn(batched.batched_state(cfg, 2, device="cpu"), *raw[0])
    res_b = []
    for pts, mask in raw[1:]:
        st_b, res = step_fn(st_b, pts, mask, eye)
        res_b.append(res)
    st_1, res_1 = run(sharded.make_mesh(1, device="cpu"))
    for a, b in zip(res_1, res_b):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in zip(list(st_1.submap_grid) + list(st_1.keyframes) + [st_1.pose],
                    list(st_b.submap_grid) + list(st_b.keyframes) + [st_b.pose]):
        assert torch.equal(a, b)
    for rank in range(2):
        mesh = sharded.Mesh(size=2, rank=rank, device=torch.device("cpu"), group=None)
        part = sharded.shard_states(st_b, mesh)
        for a, b in zip(part.submap_grid, st_b.submap_grid):
            assert a.shape[0] == 1 and torch.equal(a[0], b[rank])
        st_r, res_r = run(mesh)
        for a, b in zip(res_r, res_b):
            assert all(torch.equal(x[0], y[rank]) for x, y in zip(a, b))
        assert all(torch.equal(a[0], b[rank]) for a, b in zip(st_r.submap_grid, st_b.submap_grid))
