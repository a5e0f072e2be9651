"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the fixture, never at import). On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: ``tests/conftest.py`` configures jax, which a machine
that runs only the port need not have.)

``chip_smoke.py`` runs the same comparisons at the full per-frame shapes.
"""

import contextlib

import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_gicp, cuda_lm, cuda_nn, morton

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _sorted_cloud(seed, n, dev, valid_frac=0.9, extent=12.0):
    rng = np.random.default_rng(seed)
    pts = np.column_stack([
        rng.uniform(-extent, extent, n), rng.uniform(-extent, extent, n),
        rng.uniform(0.0, 2.5, n),
    ]).astype(np.float32)
    mask = rng.random(n) < valid_frac
    pts[~mask] = 1e6
    p, m = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
    order = morton.sort_order(p, m)
    return p[order].contiguous(), m[order].contiguous()


def _search_kernels_match_plain(qp, qm, tp, tm, radius):
    """K2, K4 and K1 against their plain versions: K2's and K4's idx and d2
    bitwise equal, K1's counts identical and moments within
    1e-3 + 1e-5 |plain|, each kernel bitwise equal over two launches, and
    every kernel's candidate counts equal to its plain selection's. Returns
    (K2 idx, K1 moments, candidate counts)."""
    clo, chi = morton.chunk_aabbs(tp, tm, morton.TARGET_CHUNK)
    n_sub = qp.shape[0] // cuda_nn.SUB_TILE
    v_nn, v_mxu, v_cov = (torch.full((n_sub,), -1, dtype=torch.int32, device=qp.device)
                          for _ in range(3))
    before = (cuda_nn.launches["cuda"], cuda_nn.mxu_launches["cuda"], cuda_cov.launches["cuda"])
    ik, dk = cuda_nn.nn1_pruned(qp, qm, tp, tm, clo, chi, radius, v_nn)
    ik2, dk2 = cuda_nn.nn1_pruned(qp, qm, tp, tm, clo, chi, radius)
    ix, dx = cuda_nn.nn1_pruned_mxu(qp, qm, tp, tm, clo, chi, radius, v_mxu)
    ix2, dx2 = cuda_nn.nn1_pruned_mxu(qp, qm, tp, tm, clo, chi, radius)
    mk = cuda_cov.cov_pruned(tp, tm, qp, qm, clo, chi, radius, v_cov)
    mk2 = cuda_cov.cov_pruned(tp, tm, qp, qm, clo, chi, radius)
    ip, dp = cuda_nn.nn1_plain(qp, qm, tp, tm, radius)
    ixp, dxp = cuda_nn.nn1_mxu_plain(qp, qm, tp, tm, radius)
    mp = cuda_cov.cov_plain(tp, tm, qp, qm, radius)
    want = cuda_nn.subtile_candidates(qp, qm, clo, chi, radius).sum(dim=1, dtype=torch.int32)
    want_x = cuda_nn.expansion_candidates(qp, qm, clo, chi, radius).sum(dim=1, dtype=torch.int32)
    torch.cuda.synchronize()
    after = (cuda_nn.launches["cuda"], cuda_nn.mxu_launches["cuda"], cuda_cov.launches["cuda"])
    assert after == tuple(b + 2 for b in before)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)
    assert torch.equal(ix, ixp) and torch.equal(dx, dxp)
    assert torch.equal(ik, ik2) and torch.equal(dk, dk2) and torch.equal(mk, mk2)
    assert torch.equal(ix, ix2) and torch.equal(dx, dx2)
    assert torch.equal(mk[:, 0], mp[:, 0])
    torch.testing.assert_close(mk, mp, atol=1e-3, rtol=1e-5)
    assert torch.equal(v_nn, want) and torch.equal(v_cov, want) and torch.equal(v_mxu, want_x)
    return ik, mk, want


@pytest.mark.parametrize("radius", [0.5, 1.0, 1.5, 5.0])
def test_nn1_kernel_matches_plain(dev, radius):
    """Same distance formula and tie rule: idx and d2 bit-identical."""
    tp, tm = _sorted_cloud(0, 8192, dev)
    qp, qm = _sorted_cloud(1, 4096, dev)
    ik, _, _ = _search_kernels_match_plain(qp, qm, tp, tm, radius)
    assert (ik >= 0).sum() > 100


@pytest.mark.parametrize("radius", [0.75, 1.5])
def test_cov_kernel_matches_plain(dev, radius):
    """Neighbour counts exact; moments to summation-order rounding."""
    tp, tm = _sorted_cloud(2, 8192, dev, extent=8.0)
    _, mk, _ = _search_kernels_match_plain(tp, tm, tp, tm, radius)
    assert float(mk[tm, 0].mean()) > 4


def _lattice(dev, offset):
    """A 32 x 32 x 4 lattice of spacing 1 m (4096 points, all exact in f32),
    shifted by ``offset``, Morton-sorted."""
    g = np.stack(np.meshgrid(np.arange(32.0), np.arange(32.0), np.arange(4.0),
                             indexing="ij"), axis=-1).reshape(-1, 3)
    p = torch.from_numpy((g + np.asarray(offset)).astype(np.float32)).to(dev)
    m = torch.ones(p.shape[0], dtype=torch.bool, device=dev)
    order = morton.sort_order(p, m)
    return p[order].contiguous(), m[order].contiguous()


@pytest.mark.parametrize("case", [
    "c1024", "spanning", "invalid_tiles", "duplicates", "on_radius",
])
def test_search_kernels_adversarial(dev, case):
    """K2, K4 and K1 on inputs that stress the in-kernel selection, the merge
    and the boundary rules, each against its plain version
    (:func:`_search_kernels_match_plain`)."""
    radius = 1.0
    if case == "c1024":  # the most chunks a target may have
        tp, tm = _sorted_cloud(10, 512 * 1024, dev, extent=60.0)
        qp, qm = _sorted_cloud(11, 2048, dev, extent=60.0)
    elif case == "spanning":  # unsorted queries: every sub-tile spans the cloud
        tp, tm = _sorted_cloud(12, 32768, dev, extent=12.0)
        qp, qm = _sorted_cloud(13, 4096, dev, extent=12.0)
        perm = torch.from_numpy(np.random.default_rng(14).permutation(4096)).to(dev)
        qp, qm = qp[perm].contiguous(), qm[perm].contiguous()
    elif case == "invalid_tiles":  # whole invalid sub-tiles, an empty chunk
        tp, tm = _sorted_cloud(15, 8192, dev)
        qp, qm = _sorted_cloud(16, 4096, dev)
        qm = qm.clone()
        qm[:32] = False
        qm[96:224] = False
        qm[1000:1010] = False
        tm = tm.clone()
        tm[1024:1536] = False
    elif case == "duplicates":  # every target four times: ties to the lower index
        base, bm = _sorted_cloud(17, 2048, dev)
        # copies in other chunks and other warp slices, one pair adjacent
        tp = torch.cat([base, base.roll(37, 0), base.roll(300, 0), base]).contiguous()
        tm = torch.cat([bm, bm.roll(37, 0), bm.roll(300, 0), bm]).contiguous()
        dup = torch.argsort(base[:, 0])[:256]
        tp[dup + 1] = tp[dup]
        tm[dup + 1] = tm[dup]
        qp, qm = _sorted_cloud(18, 4096, dev)
    else:  # queries half way between lattice points: nearest targets at exactly r
        radius = 0.5
        tp, tm = _lattice(dev, (0.0, 0.0, 0.0))
        qp, qm = _lattice(dev, (0.5, 0.0, 0.0))
    ik, mk, visits = _search_kernels_match_plain(qp, qm, tp, tm, radius)
    n_chunks = tp.shape[0] // morton.TARGET_CHUNK
    if case == "c1024":
        assert n_chunks == 1024 and (ik >= 0).sum() > 10
    elif case == "spanning":
        assert int(visits.max()) > 32 and (ik >= 0).sum() > 100
    elif case == "invalid_tiles":
        assert int(visits[0]) == 0 and int(visits[3:7].max()) == 0
        assert (ik[~qm] == -1).all() and (mk[~qm] == 0).all()
    elif case == "duplicates":
        win = ik[ik >= 0].long()
        assert win.numel() > 100
        same = (tp[None, :, :] == tp[win][:, None, :]).all(dim=-1) & tm[None, :]
        assert torch.equal(same.int().argmax(dim=1), win)  # the first copy wins
    else:  # d2 == r^2 is never found (strict), always counted (inclusive)
        assert (ik == -1).all()
        interior = (qp[:, 0] < 31.0)
        assert (mk[interior, 0] == 2).all()


@pytest.mark.parametrize("radius", [0.5, 1.0, 1.5])
def test_nn1_mxu_kernel_matches_plain(dev, radius):
    """K4 and its plain version evaluate the expansion in the same order:
    idx and d2 bit-identical, also ~40 m from the origin where the
    expansion's rounding is largest; against the exact K2 the winner's d2
    is within the expansion's 2e-3 m^2 slack."""
    tp, tm = _sorted_cloud(0, 8192, dev)
    qp, qm = _sorted_cloud(1, 4096, dev)
    shift = torch.tensor([30.0, -25.0, 1.0], device=dev)
    far_t = torch.where(tm[:, None], tp + shift, tp).contiguous()
    far_q = torch.where(qm[:, None], qp + shift, qp).contiguous()
    clo, chi = morton.chunk_aabbs(far_t, tm, morton.TARGET_CHUNK)
    ik, dk = cuda_nn.nn1_pruned_mxu(far_q, qm, far_t, tm, clo, chi, radius)
    ip, dp = cuda_nn.nn1_mxu_plain(far_q, qm, far_t, tm, radius)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip) and torch.equal(dk, dp)
    clo, chi = morton.chunk_aabbs(tp, tm, morton.TARGET_CHUNK)
    before = cuda_nn.mxu_launches["cuda"]
    ik, dk = cuda_nn.nn1_pruned_mxu(qp, qm, tp, tm, clo, chi, radius)
    ip, dp = cuda_nn.nn1_mxu_plain(qp, qm, tp, tm, radius)
    ie, de = cuda_nn.nn1_plain(qp, qm, tp, tm, radius)
    torch.cuda.synchronize()
    assert cuda_nn.mxu_launches["cuda"] == before + 1
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)
    both = (ik >= 0) & (ie >= 0)
    assert both.sum() > 100
    d_exact = torch.sum((qp - tp[ik.clamp(min=0).long()]) ** 2, dim=-1)
    assert float((d_exact[both] - de[both]).max()) < 2e-3


EXHAUSTIVE_CASES = [8192, 1000, "all_invalid", "one_valid", "scattered", "duplicates",
                    "on_radius"]


def _exhaustive_case(dev, case, extent=12.0):
    """(targets, mask, queries, radius) of one K5/K6 case: a sorted cloud of
    8192 or of 1000 targets (a ragged last chunk), no valid target, one,
    65536 slots with a quarter valid at random positions, every target
    twice, and a lattice whose nearest targets lie at exactly r."""
    qp, _ = _sorted_cloud(4, 2048, dev, extent=extent)
    radius = 0.9
    if isinstance(case, int):
        tp, tm = _sorted_cloud(3, case, dev, extent=extent)
    elif case in ("all_invalid", "one_valid"):
        tp = torch.full((3000, 3), 1e6, device=dev)
        tm = torch.zeros(3000, dtype=torch.bool, device=dev)
        if case == "one_valid":
            tp[2417], tm[2417] = qp[5] + 0.25, True
    elif case == "scattered":
        base, _ = _sorted_cloud(6, 16384, dev, valid_frac=1.0, extent=extent)
        where = torch.from_numpy(np.random.default_rng(7).permutation(65536)[:16384]).to(dev)
        tp = torch.full((65536, 3), 1e6, device=dev)
        tm = torch.zeros(65536, dtype=torch.bool, device=dev)
        tp[where], tm[where] = base, True
    elif case == "duplicates":  # copies in other chunks, other slices and side by side
        base, bm = _sorted_cloud(17, 2048, dev, extent=extent)
        tp = torch.cat([base, base.roll(37, 0), base]).contiguous()
        tm = torch.cat([bm, bm.roll(37, 0), bm]).contiguous()
        tp[1::2], tm[1::2] = tp[0::2].clone(), tm[0::2].clone()
    else:
        tp, tm = _lattice(dev, (0.0, 0.0, 0.0))
        qp, radius = _lattice(dev, (0.5, 0.0, 0.0))[0][:2048].contiguous(), 0.5
    return tp.contiguous(), tm, qp, radius


@pytest.mark.parametrize("case", EXHAUSTIVE_CASES)
def test_nn1_exhaustive_kernel_matches_plain(dev, case):
    """K5: the raw minimum over every valid target, bitwise equal to the
    plain version (ties to the lower index) and over two launches; its
    device counts are the valid targets and one scan of their chunks per
    query tile."""
    tp, tm, qp, _ = _exhaustive_case(dev, case)
    before = cuda_nn.exhaustive_launches["cuda"]
    stats = torch.full((2,), -1, dtype=torch.int32, device=dev)
    ik, dk = cuda_nn.nn1_exhaustive(qp, tp, tm, stats)
    ik2, dk2 = cuda_nn.nn1_exhaustive(qp, tp, tm)
    ip, dp = cuda_nn.nn1_exhaustive_plain(qp, tp, tm)
    torch.cuda.synchronize()
    assert cuda_nn.exhaustive_launches["cuda"] == before + 2
    assert torch.equal(ik, ip) and torch.equal(dk, dp)
    assert torch.equal(ik, ik2) and torch.equal(dk, dk2)
    n_valid = int(tm.sum())
    assert stats.tolist() == [n_valid, (qp.shape[0] // 128) * -(-n_valid // 512)]
    if case == "all_invalid":
        assert (ik == -1).all() and torch.isinf(dk).all()
    elif case == "one_valid":
        assert (ik == 2417).all()
    else:
        assert (ik >= 0).all() and tm[ik.long()].all()
    if case == "duplicates":  # the first copy wins
        same = (tp[None, :, :] == tp[ik.long()][:, None, :]).all(dim=-1) & tm[None, :]
        assert torch.equal(same.int().argmax(dim=1), ik.long())
    if case == "on_radius":
        assert (dk == 0.25).all()


@pytest.mark.parametrize("case", EXHAUSTIVE_CASES)
def test_cov_exhaustive_kernel_matches_plain(dev, case):
    """K6: counts exact (inclusive radius), moments to summation order,
    two launches bitwise equal, the device counts as K5's."""
    tp, tm, qp, radius = _exhaustive_case(dev, case, extent=6.0)
    if isinstance(case, int):
        qp = tp[:896].contiguous()  # queries among the targets, invalid ones too
    every = torch.ones(qp.shape[0], dtype=torch.bool, device=dev)
    before = cuda_cov.exhaustive_launches["cuda"]
    stats = torch.full((2,), -1, dtype=torch.int32, device=dev)
    mk = cuda_cov.cov_exhaustive(tp, tm, qp, radius, stats)
    mk2 = cuda_cov.cov_exhaustive(tp, tm, qp, radius)
    mp = cuda_cov.cov_plain(tp, tm, qp, every, radius)
    torch.cuda.synchronize()
    assert cuda_cov.exhaustive_launches["cuda"] == before + 2
    assert torch.equal(mk[:, 0], mp[:, 0])
    torch.testing.assert_close(mk, mp, atol=1e-3, rtol=1e-5)
    assert torch.equal(mk, mk2)
    n_valid = int(tm.sum())
    assert stats.tolist() == [n_valid, (qp.shape[0] // 128) * -(-n_valid // 512)]
    if case == "all_invalid":
        assert not mk.any()
    elif case == "on_radius":  # d2 == r^2 is counted
        assert (mk[qp[:, 0] < 31.0, 0] == 2).all()
    elif case != "one_valid":
        assert float(mk[:, 0].mean()) > 1


def _fused_problem(dev, seed=0):
    rng = np.random.default_rng(seed)
    tp, tm = _sorted_cloud(seed, 8192, dev, extent=10.0)
    nrm = torch.from_numpy(rng.normal(size=(8192, 3)).astype(np.float32)).to(dev)
    nrm = (nrm / nrm.norm(dim=1, keepdim=True)).contiguous()
    nval = torch.from_numpy(rng.random(8192) > 0.1).to(dev)
    pick = torch.from_numpy(rng.choice(8192, 4096)).to(dev)
    p = (tp[pick] + torch.from_numpy(rng.normal(0, 0.05, (4096, 3)).astype(np.float32)).to(dev))
    qw = tm[pick] & torch.from_numpy(rng.random(4096) > 0.1).to(dev)
    p = torch.where(qw[:, None], p, 1e6).contiguous()
    m = torch.from_numpy(rng.normal(size=(4096, 3)).astype(np.float32)).to(dev)
    m = (m / m.norm(dim=1, keepdim=True)).contiguous()
    return tp, tm, nrm, nval, p, m, qw


@pytest.mark.parametrize("seeds", ["shuffled", "own"])
def test_fused_linearize_kernel_matches_plain(dev, seeds):
    """K3: correspondences and payload identical to the plain version,
    sub-tile sums within summation-order rounding, slots 29/30 (chunks
    visited, candidates) equal to the plain selection's cold and seeded,
    seeded == cold exactly, and two launches bit-identical (no atomics)."""
    tp, tm, nrm, nval, p, m, qw = _fused_problem(dev)
    radius = 0.5
    clo, chi = morton.chunk_aabbs(tp, tm, morton.TARGET_CHUNK)
    cold = torch.full((4096,), -1, dtype=torch.int32, device=dev)
    before = cuda_gicp.launches["cuda"]
    args = (tp, tm, nrm, nval, clo, chi, radius, 1e-3)
    hk, pk, ik = cuda_gicp.fused_linearize_pruned(p, m, qw, cold, *args)
    hp, pp, ip = cuda_gicp.fused_linearize_plain(p, m, qw, cold, *args)
    hk2, pk2, ik2 = cuda_gicp.fused_linearize_pruned(p, m, qw, cold, *args)
    # seeds: a shuffled copy of the cold correspondences (wrong but valid),
    # or the cold answer itself (the tightest bounds)
    seed = ik[torch.randperm(4096, device=dev)].contiguous() if seeds == "shuffled" else ik
    hs, ps, is_ = cuda_gicp.fused_linearize_pruned(p, m, qw, seed, *args)
    hsp, _, _ = cuda_gicp.fused_linearize_plain(p, m, qw, seed, *args)
    torch.cuda.synchronize()
    assert cuda_gicp.launches["cuda"] == before + 3
    assert torch.equal(ik, ip) and (ik >= 0).sum() > 1000
    assert torch.equal(pk[:, :7], pp[:, :7])
    assert torch.equal(hk, hk2) and torch.equal(pk, pk2)
    assert torch.equal(is_, ik) and torch.equal(ps, pk)
    assert torch.equal(hs[:, :29], hk[:, :29])
    assert torch.equal(hk[:, 29:31], hp[:, 29:31]) and torch.equal(hs[:, 29:31], hsp[:, 29:31])
    assert bool((hs[:, 29] <= hk[:, 29]).all())
    sk, sp = hk[:, :29].sum(0), hp[:, :29].sum(0)
    assert float((sk - sp).abs().max()) <= 2e-4 * float(sp.abs().max())


@pytest.mark.parametrize("backend", ["pallas", "pallas_mxu", "pallas_fused"])
def test_runner_on_cuda_uses_kernels(dev, backend):
    from direct_lidar_odometry_tpu_torch.config import DloConfig, ShapeConfig
    from direct_lidar_odometry_tpu_torch.io import synthetic
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner

    cfg = DloConfig(nn_backend=backend, shapes=ShapeConfig(
        n_raw=16384, n_scan=4096, n_keyframe=2048, max_keyframes=16, max_submap_kf=4,
        n_submap_flat=8192, hull_directions=16))
    rng = np.random.default_rng(0)
    world = synthetic.make_urban_world(rng, n_frames=6, speed=1.0, n_dynamic=0)
    beams = synthetic.BeamModel(n_beams=32, n_azimuth=512)
    runner = OdometryRunner(cfg, device="cuda")
    for mod in (cuda_nn, cuda_cov, cuda_gicp):
        mod.reset_launches()
    for t in range(6):
        scan = synthetic.render_raycast(world, t, rng, max_points=16384, beams=beams)
        runner.process_scan(scan, float(world.stamps[t]), sync=True)
    search = {"pallas": cuda_nn.launches, "pallas_mxu": cuda_nn.mxu_launches,
              "pallas_fused": cuda_gicp.launches}[backend]
    assert search["cuda"] > 0 and search["plain"] == 0
    assert cuda_cov.launches["cuda"] > 0 and cuda_cov.launches["plain"] == 0
    if backend != "pallas":
        assert cuda_nn.launches["cuda"] == 0
    assert np.isfinite(runner.trajectory()).all()


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4"])
def test_kernel_lanes_equal_single_launches(dev, kernel):
    """K1-K4 over B = 3 lanes in one launch: each lane bitwise equal to the
    same lane launched alone (unbatched), the visits counted per lane, the
    lane axis counted as one launch; K2 and K1 also against their plain
    versions lane by lane (K2 bitwise, K1's counts identical); K3's public
    entry gives a lane the same H and b in the batch as alone."""
    lanes = 3
    if kernel == "K3":
        probs = [_fused_problem(dev, seed) for seed in range(lanes)]
        tp, tm, nrm, nval, p, m, qw = (torch.stack(x) for x in zip(*probs))
        clo, chi = morton.chunk_aabbs(tp, tm, morton.TARGET_CHUNK)
        cold = torch.full(qw.shape, -1, dtype=torch.int32, device=dev)
        before = cuda_gicp.launches["cuda"]
        got = cuda_gicp.fused_linearize_pruned(p, m, qw, cold, tp, tm, nrm, nval, clo, chi, 0.5,
                                               1e-3)
        assert cuda_gicp.launches["cuda"] == before + 1
        fl = cuda_gicp.fused_linearize(tp, tm, nrm, nval, clo, chi, p, m, qw, 0.5)
        for b in range(lanes):
            one = cuda_gicp.fused_linearize_pruned(p[b], m[b], qw[b], cold[b], tp[b], tm[b],
                                                   nrm[b], nval[b], clo[b], chi[b], 0.5, 1e-3)
            assert all(torch.equal(x[b], y) for x, y in zip(got, one))
            alone = cuda_gicp.fused_linearize(*(a[b:b + 1] for a in (tp, tm, nrm, nval, clo, chi,
                                                                       p, m, qw)), 0.5)
            assert all(torch.equal(x[b], y[0]) for x, y in zip(fl, alone))
        return
    clouds = [(_sorted_cloud(10 + b, 8192, dev), _sorted_cloud(20 + b, 4096, dev))
              for b in range(lanes)]
    tp, tm = (torch.stack([c[0][i] for c in clouds]) for i in range(2))
    qp, qm = (torch.stack([c[1][i] for c in clouds]) for i in range(2))
    clo, chi = morton.chunk_aabbs(tp, tm, morton.TARGET_CHUNK)
    visits = torch.full((lanes, 4096 // cuda_nn.SUB_TILE), -1, dtype=torch.int32, device=dev)
    if kernel == "K1":
        def run(*a, v=None):
            return (cuda_cov.cov_pruned(a[2], a[3], a[0], a[1], a[4], a[5], 1.0, v),)
        counter = cuda_cov.launches
    else:
        fn = cuda_nn.nn1_pruned if kernel == "K2" else cuda_nn.nn1_pruned_mxu

        def run(*a, v=None):
            return fn(*a, 1.0, v)
        counter = cuda_nn.launches if kernel == "K2" else cuda_nn.mxu_launches
    before = counter["cuda"]
    got = run(qp, qm, tp, tm, clo, chi, v=visits)
    assert counter["cuda"] == before + 1
    for b in range(lanes):
        v = torch.full((4096 // cuda_nn.SUB_TILE,), -1, dtype=torch.int32, device=dev)
        one = run(qp[b], qm[b], tp[b], tm[b], clo[b], chi[b], v=v)
        assert all(torch.equal(x[b], y) for x, y in zip(got, one))
        assert torch.equal(visits[b], v)
    if kernel == "K2":
        ip, dp = cuda_nn.nn1_plain(qp, qm, tp, tm, 1.0)
        assert torch.equal(got[0], ip) and torch.equal(got[1], dp)
    elif kernel == "K1":
        mp = cuda_cov.cov_plain(tp, tm, qp, qm, 1.0)
        assert torch.equal(got[0][..., 0], mp[..., 0])


def test_batched_step_on_card_uses_kernels(dev):
    """The batched step at small shapes on the card: K1 and K2 launched,
    no plain version, and lane 0 within 1e-4 m of its single-sequence run."""
    from direct_lidar_odometry_tpu_torch.config import DloConfig, ShapeConfig
    from direct_lidar_odometry_tpu_torch.core import cloud
    from direct_lidar_odometry_tpu_torch.io import synthetic
    from direct_lidar_odometry_tpu_torch.odometry import hulls, pipeline
    from direct_lidar_odometry_tpu_torch.parallel import batched

    cfg = DloConfig(nn_backend="pallas", shapes=ShapeConfig(
        n_raw=16384, n_scan=4096, n_keyframe=2048, max_keyframes=16, max_submap_kf=4,
        n_submap_flat=8192, hull_directions=16))
    rng = np.random.default_rng(0)
    world = synthetic.make_urban_world(rng, n_frames=6, speed=1.0, n_dynamic=0)
    beams = synthetic.BeamModel(n_beams=32, n_azimuth=512)
    scans = [[cloud.from_numpy(synthetic.render_raycast(world, t, np.random.default_rng(b + 10 * t),
                                                        max_points=16384, beams=beams), 16384, dev)
              for b in range(2)] for t in range(6)]
    init_fn, step_fn = batched.make_batched_fns(cfg)
    for mod in (cuda_nn, cuda_cov, cuda_gicp):
        mod.reset_launches()
    st = init_fn(batched.batched_state(cfg, 2, dev),
                 *(torch.stack([getattr(c, f) for c in scans[0]]) for f in ("points", "mask")))
    eye = torch.eye(4, device=dev).expand(2, 4, 4).clone()
    poses = []
    for t in range(1, 6):
        st, res = step_fn(st, *(torch.stack([getattr(c, f) for c in scans[t]])
                                for f in ("points", "mask")), eye)
        poses.append(res.pose[0])
    assert cuda_nn.launches["cuda"] > 0 and cuda_cov.launches["cuda"] > 0
    assert cuda_nn.launches["plain"] == 0 and cuda_cov.launches["plain"] == 0
    directions = torch.from_numpy(hulls.fibonacci_directions(16)).to(dev)
    s = pipeline.init_frame(cfg, pipeline.fresh_state(cfg, device=dev), *scans[0][0])
    for t in range(1, 6):
        s, r = pipeline.odom_frame(cfg, directions, s, *scans[t][0], eye[0])
        assert float((r.pose - poses[t - 1]).abs().max()) <= 1e-4


def _drifted_loop_graph(k=96, radius=15.0, seed=3):
    """A circle of ``k`` keyframe poses that drifted over eight keyframes
    half way round, chained from the drifted estimates (the chain edges of
    the drifting stretch down-weighted, as the health weighting of
    ``loopclosure.build_refinement_graph`` does), plus one exact loop edge
    (0, k-1); with the ground-truth positions."""
    from direct_lidar_odometry_tpu_torch.core import se3
    from direct_lidar_odometry_tpu_torch.parallel import posegraph

    rng = np.random.default_rng(seed)
    a = 2 * np.pi * np.arange(k) / k
    gt = np.tile(np.eye(4), (k, 1, 1))
    c, s = np.cos(a + np.pi / 2), np.sin(a + np.pi / 2)
    gt[:, 0, 0], gt[:, 0, 1], gt[:, 1, 0], gt[:, 1, 1] = c, -s, s, c
    gt[:, :3, 3] = np.column_stack([radius * np.cos(a), radius * np.sin(a), np.zeros(k)])
    gt = np.linalg.inv(gt[0])[None] @ gt
    est = gt.copy()
    drift = np.cumsum(rng.normal(scale=0.05, size=(8, 3)), axis=0)
    for t in range(k // 2, k):
        est[t, :3, 3] += drift[min(t - k // 2, 7)]
    est = torch.from_numpy(est.astype(np.float32))
    chain = posegraph.odometry_chain_graph(
        est[:, :3, 3], se3.rotmat_to_quat(est[:, :3, :3]), torch.tensor(k))
    loop_rel = torch.from_numpy((np.linalg.inv(gt[0]) @ gt[k - 1]).astype(np.float32))[None]
    graph = posegraph.PoseGraph(
        poses=chain.poses, pose_mask=chain.pose_mask,
        edges=torch.cat([chain.edges, torch.tensor([[0, k - 1]])]),
        rel=torch.cat([chain.rel, loop_rel]),
        edge_mask=torch.cat([chain.edge_mask, torch.tensor([True])]),
        weights=torch.cat([torch.where((chain.edges[:, 1] >= k // 2) & (chain.edges[:, 1] < k // 2 + 8),
                                       0.01, chain.weights), torch.tensor([2.0])]),
    )
    return graph, gt[:, :3, 3]


def test_posegraph_refine_on_card_matches_cpu(dev):
    """The dense Gauss-Newton on the card agrees with the CPU run within
    1e-4 m: the einsums and the [6K, 6K] solve stay in full float32 (TF32
    off), and the loop edge repairs the drifted half."""
    from direct_lidar_odometry_tpu_torch.parallel import posegraph

    graph, gt_pos = _drifted_loop_graph()
    torch.backends.cuda.matmul.allow_tf32 = True  # refine must pin it off itself
    cpu_poses, cpu_err = posegraph.refine(graph, iterations=10)
    card = posegraph.PoseGraph(*(t.to(dev) for t in graph))
    card_poses, card_err = posegraph.refine(card, iterations=10)
    assert not torch.backends.cuda.matmul.allow_tf32
    got = card_poses.cpu().numpy()
    np.testing.assert_allclose(got[:, :3, 3], cpu_poses.numpy()[:, :3, 3], atol=1e-4)
    assert abs(float(card_err) - float(cpu_err)) <= 1e-3 * abs(float(cpu_err)) + 1e-6
    before = np.linalg.norm(graph.poses.numpy()[:, :3, 3] - gt_pos, axis=-1).mean()
    after = np.linalg.norm(got[:, :3, 3] - gt_pos, axis=-1).mean()
    assert after < before


def test_posegraph_normal_system_on_card_is_deterministic(dev):
    """Twenty builds of the normal system of a graph whose keyframes repeat
    across edges (the drifted loop's chain and every fourth keyframe closed
    to keyframe 0 three times over) give the same bits on the card."""
    from direct_lidar_odometry_tpu_torch.core import se3
    from direct_lidar_odometry_tpu_torch.parallel import posegraph

    graph, _ = _drifted_loop_graph()
    k = graph.poses.shape[0]
    loops = torch.tensor([[0, t] for t in range(4, k, 4)] * 3)
    twist = torch.from_numpy(np.random.default_rng(7).normal(
        scale=0.05, size=(len(loops), 6)).astype(np.float32))
    rel = (se3.se3_inverse(graph.poses[loops[:, 0]]) @ graph.poses[loops[:, 1]]
           @ se3.se3_exp(twist))
    graph = posegraph.PoseGraph(
        poses=graph.poses, pose_mask=graph.pose_mask,
        edges=torch.cat([graph.edges, loops]), rel=torch.cat([graph.rel, rel]),
        edge_mask=torch.cat([graph.edge_mask, torch.ones(len(loops), dtype=torch.bool)]),
        weights=torch.cat([graph.weights, torch.full((len(loops),), 2.0)]),
    )
    card = posegraph.PoseGraph(*(t.to(dev) for t in graph))
    first = posegraph.build_normal_system(card)
    for _ in range(19):
        again = posegraph.build_normal_system(card)
        assert all(torch.equal(a, f) for a, f in zip(again, first))
    cpu = posegraph.build_normal_system(graph)
    for got, want in zip(first, cpu):
        scale = max(float(want.abs().max()), 1.0)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("cell", [0.5, 3.0])
def test_hashgrid_on_card_matches_cpu(dev, cell):
    """The "hashgrid" tensor ops on the card give the CPU's grid bit for bit
    (true division by a device tensor, int64 hashing) and the CPU's 1-NN and
    k-NN; no hand kernel and no plain version runs."""
    from direct_lidar_odometry_tpu_torch.ops import hashgrid

    p, m = _sorted_cloud(11, 8192, "cpu")
    q = (p[:4096] + 0.2 * torch.randn(4096, 3, generator=torch.Generator().manual_seed(1))).contiguous()
    qm = m[:4096].clone()
    for mod in (cuda_nn, cuda_cov):
        mod.reset_launches()
    gc = hashgrid.build(p, m, cell, 2**12)
    gd = hashgrid.build(p.to(dev), m.to(dev), cell, 2**12)
    for f in hashgrid.HashGrid._fields:
        assert torch.equal(getattr(gd, f).cpu(), getattr(gc, f)), f
    for a, b in zip(hashgrid.query_1nn(gd, q.to(dev), qm.to(dev), cell, 16),
                    hashgrid.query_1nn(gc, q, qm, cell, 16)):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(hashgrid.query_knn(gd, q.to(dev), qm.to(dev), 10, 32, chunk=1024),
                    hashgrid.query_knn(gc, q, qm, 10, 32, chunk=1024)):
        assert torch.equal(a.cpu(), b)
    assert sum(cuda_nn.launches.values()) == 0 and sum(cuda_cov.launches.values()) == 0


def test_bruteforce_on_card_matches_cpu(dev):
    """The "brute" tensor ops on the card give the CPU's results (each
    distance is a chain of separate rounded operations, so the bits match)."""
    from direct_lidar_odometry_tpu_torch.ops import bruteforce

    p, m = _sorted_cloud(12, 8192, "cpu")
    q = (p[:4096] + 0.2 * torch.randn(4096, 3, generator=torch.Generator().manual_seed(2))).contiguous()
    qm = m[:4096].clone()
    for a, b in zip(bruteforce.query_1nn(p.to(dev), m.to(dev), q.to(dev), qm.to(dev), 1.0, tile=2048),
                    bruteforce.query_1nn(p, m, q, qm, 1.0, tile=2048)):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(bruteforce.query_knn(p.to(dev), m.to(dev), q.to(dev), qm.to(dev), 10, chunk=1024),
                    bruteforce.query_knn(p, m, q, qm, 10, chunk=1024)):
        assert torch.equal(a.cpu(), b)


def _lane_clouds(seeds, dev):
    """B lanes of 8192-point clouds and 4096 queries each, on ``dev``."""
    clouds = [_sorted_cloud(s, 8192, "cpu") for s in seeds]
    gen = torch.Generator().manual_seed(3)
    qs = [(p[:4096] + 0.2 * torch.randn(4096, 3, generator=gen)).contiguous() for p, _ in clouds]
    return (torch.stack([p for p, _ in clouds]).to(dev), torch.stack([m for _, m in clouds]).to(dev),
            torch.stack(qs).to(dev), torch.stack([m[:4096] for _, m in clouds]).to(dev))


@pytest.mark.parametrize("cell", [0.5, 3.0])
def test_hashgrid_lanes_on_card_equal_single_calls(dev, cell):
    """A B = 4 hash grid built on the card: every lane's leaves are its own
    build's bit for bit, and so are its 1-NN and k-NN results; no hand
    kernel and no plain version runs."""
    from direct_lidar_odometry_tpu_torch.ops import hashgrid

    p, m, q, qm = _lane_clouds([21, 22, 23, 24], dev)
    for mod in (cuda_nn, cuda_cov):
        mod.reset_launches()
    grid = hashgrid.build(p, m, cell, 2**12)
    one_nn = hashgrid.query_1nn(grid, q, qm, cell, 16)
    knn = hashgrid.query_knn(grid, q, qm, 10, 32, chunk=1024)
    for b in range(p.shape[0]):
        single = hashgrid.build(p[b], m[b], cell, 2**12)
        for f in hashgrid.HashGrid._fields:
            assert torch.equal(getattr(grid, f)[b], getattr(single, f)), f
        for x, y in zip(one_nn, hashgrid.query_1nn(single, q[b], qm[b], cell, 16)):
            assert torch.equal(x[b], y)
        for x, y in zip(knn, hashgrid.query_knn(single, q[b], qm[b], 10, 32, chunk=1024)):
            assert torch.equal(x[b], y)
    assert sum(cuda_nn.launches.values()) == 0 and sum(cuda_cov.launches.values()) == 0


def test_bruteforce_lanes_on_card_equal_single_calls(dev):
    """B = 4 lanes of the exhaustive 1-NN and k-NN on the card: every lane
    is its own call's bit for bit (the lanes cut the query tile)."""
    from direct_lidar_odometry_tpu_torch.ops import bruteforce

    p, m, q, qm = _lane_clouds([31, 32, 33, 34], dev)
    one_nn = bruteforce.query_1nn(p, m, q, qm, 1.0, tile=2048)
    knn = bruteforce.query_knn(p, m, q, qm, 10, chunk=1024)
    for b in range(p.shape[0]):
        for x, y in zip(one_nn, bruteforce.query_1nn(p[b], m[b], q[b], qm[b], 1.0, tile=2048)):
            assert torch.equal(x[b], y)
        for x, y in zip(knn, bruteforce.query_knn(p[b], m[b], q[b], qm[b], 10, chunk=1024)):
            assert torch.equal(x[b], y)


@pytest.mark.parametrize("kind", ["brute", "twoscale"])
def test_knn_normals_lanes_on_card_equal_single_calls(dev, kind):
    """The k-NN normals of B = 4 lanes on the card: every lane's normals and
    valid mask are its own call's bit for bit (the neighbourhood sums run
    per lane)."""
    from direct_lidar_odometry_tpu_torch.registration import covariance

    p, m, _, _ = _lane_clouds([41, 42, 43, 44], dev)
    if kind == "brute":
        def est(pts, mask):
            return covariance.estimate_normals_brute(pts, mask, k=10, chunk=2048)
    else:
        def est(pts, mask):
            return covariance.estimate_normals_twoscale(pts, mask, k=10, chunk=2048)
    got = est(p, m)
    for b in range(p.shape[0]):
        one = est(p[b], m[b])
        assert torch.equal(got.normals[b], one.normals) and torch.equal(got.valid[b], one.valid)


def _recorded_aligns(backend):
    """The first ``gicp.align`` call of each GICP stage (coarse S2S, S2S,
    S2M) of a short drive on the card, its inputs cloned, and the S2M call
    again with the rescue's wide gate: (stage, source, target, guess,
    stage config) each."""
    import dataclasses

    from direct_lidar_odometry_tpu_torch.config import DloConfig, ShapeConfig
    from direct_lidar_odometry_tpu_torch.io import synthetic
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
    from direct_lidar_odometry_tpu_torch.registration import gicp
    from direct_lidar_odometry_tpu_torch.utils import sync

    cfg = DloConfig(nn_backend=backend, shapes=ShapeConfig(
        n_raw=16384, n_scan=4096, n_keyframe=2048, max_keyframes=16, max_submap_kf=4,
        n_submap_flat=8192, hull_directions=16))
    rng = np.random.default_rng(0)
    world = synthetic.make_urban_world(rng, n_frames=4, speed=1.0, n_dynamic=0)
    beams = synthetic.BeamModel(n_beams=32, n_azimuth=512)
    calls = {}
    align = gicp.align

    def record(src, target, guess, stage_cfg, backend, cap=16):
        stage = sync.site()
        if stage not in calls:
            calls[stage] = (gicp.GicpSource(*map(gicp._clone, src)),
                            gicp.GicpTarget(*map(gicp._clone, target)), guess.clone(), stage_cfg)
        return align(src, target, guess, stage_cfg, backend, cap)

    gicp.align = record
    try:
        runner = OdometryRunner(cfg, device="cuda")
        for t in range(4):
            scan = synthetic.render_raycast(world, t, rng, max_points=16384, beams=beams)
            runner.process_scan(scan, float(world.stamps[t]), sync=True)
    finally:
        gicp.align = align
    assert set(calls) >= {"step.s2s_coarse", "step.s2s", "step.s2m"}, set(calls)
    src, target, guess, s2m = calls["step.s2m"]
    wide = dataclasses.replace(s2m, max_correspondence_distance=cfg.gicp.rescue_corr_distance)
    calls["step.rescue"] = (src, target, guess, wide)
    return calls


def _launch_counts():
    """K2, K4, K3 and K7 launches as their wrappers count them."""
    return (cuda_nn.launches["cuda"], cuda_nn.mxu_launches["cuda"], cuda_gicp.launches["cuda"],
            cuda_lm.launches["cuda"])


def _traced(fn):
    """``fn()`` and the K2, K4, K3 and K7 launches of its device trace, by
    their ``__global__`` names (a replayed graph's included)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from tools_torch import devprof

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [name for name, _, _ in devprof.device_events(prof)]
    return out, [sum(1 for n in names if re.search(devprof.KERNEL_NAMES[k], n))
                 for k in ("K2", "K4", "K3", "K7")]


@contextlib.contextmanager
def _eager_aligns():
    """``gicp.align`` issuing its operations one by one on the card."""
    from direct_lidar_odometry_tpu_torch.registration import gicp

    iterations = gicp._iterations
    gicp._iterations = lambda *args: (gicp._Iterations(*args), False)
    try:
        yield
    finally:
        gicp._iterations = iterations


@pytest.mark.parametrize("backend", ["pallas", "pallas_mxu", "pallas_fused"])
def test_gicp_graph_equals_eager_on_recorded_frames(dev, backend):
    """Each GICP stage's align, replayed from its captured graphs, gives
    the eager path's result bit for bit (a first call, which captures, and
    a second, which only replays), with one replay per LM step. The
    device trace of the replaying call holds the eager path's K2/K4/K3
    launches and one K7 launch per LM step, which the trace of the eager
    call shows the wrappers count; the wrappers count only the capture's
    one eager run, which launches the stage's kernel once and K7 twice
    (the iteration's trial and a retry). Every LM step counts one K7
    trial (``gicp_trial.kernel``)."""
    from direct_lidar_odometry_tpu_torch.registration import gicp
    from direct_lidar_odometry_tpu_torch.utils import sync

    fields = ("transform", "hessian", "final_error", "num_correspondences")
    for stage, (src, target, guess, cfg) in _recorded_aligns(backend).items():
        with _eager_aligns():
            before = _launch_counts()
            want, traced = _traced(lambda: gicp.align(src, target, guess, cfg, backend))
            eager_launches = [b - a for a, b in zip(before, _launch_counts())]
        assert traced == eager_launches, stage
        assert sum(eager_launches[:3]) == want.iterations > 0, stage
        warm = [int(n > 0) for n in eager_launches[:3]] + [2]
        gicp.release_graphs()
        for call in ("capture", "replay"):
            sync.reset()
            before = _launch_counts()
            with sync.span(stage):
                if call == "capture":
                    got = gicp.align(src, target, guess, cfg, backend)
                    torch.cuda.synchronize()
                else:
                    got, traced = _traced(lambda: gicp.align(src, target, guess, cfg, backend))
                    assert traced == eager_launches, stage
            for name in fields:
                assert torch.equal(getattr(got, name), getattr(want, name)), (stage, call, name)
            assert (got.iterations, got.converged, got.lm_failed) == (
                want.iterations, want.converged, want.lm_failed), (stage, call)
            counted = [b - a for a, b in zip(before, _launch_counts())]
            assert counted == (warm if call == "capture" else [0, 0, 0, 0]), (stage, call)
            steps = sync.counts[f"lm_steps.{stage}"]
            assert sync.counts["gicp_graph.replays"] == steps, stage
            assert sync.counts["gicp_trial.kernel"] == steps, stage
            if call == "replay":
                assert traced[3] == steps, stage
            assert sync.counts["gicp_graph.eager_iters"] == 0
            assert sync.counts["gicp_graph.captures"] == (2 if call == "capture" else 0), stage


def test_gicp_graph_keys_share_one_side_stream(dev):
    """A key captured after others holds no more device memory than its
    own static buffers and outputs: every capture runs on one side stream,
    so no key adds a cuBLAS workspace of its own (32 MiB on an H100)."""
    from direct_lidar_odometry_tpu_torch.registration import gicp

    from direct_lidar_odometry_tpu_torch.utils import graphs

    calls = _recorded_aligns("pallas")
    gicp.release_graphs()
    for stage in ("step.s2s_coarse", "step.s2s", "step.s2m"):
        src, target, guess, cfg = calls[stage]
        gicp.align(src, target, guess, cfg, "pallas")
    torch.cuda.synchronize()
    keys = set(gicp._GRAPHS)
    before = torch.cuda.memory_allocated(dev)
    src, target, guess, cfg = calls["step.rescue"]
    gicp.align(src, target, guess, cfg, "pallas")
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated(dev) - before
    (new,) = set(gicp._GRAPHS) - keys
    run = gicp._GRAPHS[new]
    owned = [t for t in (*run.src, *run.target, *run.st, *run.lin, run.flags, run.retry_flags)
             if t is not None]
    own_bytes = sum(-(-t.untyped_storage().nbytes() // 512) * 512 for t in owned)
    assert len(graphs._SIDE_STREAMS) == 1
    assert grown <= own_bytes + 2**20, (grown, own_bytes)


def test_gicp_graph_capture_beside_a_copying_thread(dev):
    """Captures made while another thread copies scans from pageable host
    memory to the card and waits for them (the offline benchmark's chunk
    worker, when a stage's key is first met inside the window): the
    captures succeed and replay the eager bits."""
    import threading

    from direct_lidar_odometry_tpu_torch.registration import gicp
    from direct_lidar_odometry_tpu_torch.utils import sync

    calls = _recorded_aligns("pallas")
    stop = threading.Event()
    copied = []

    def worker():
        host = torch.randn(16384, 3)
        while not stop.is_set():
            copied.append(sync.upload(host, dev).sum())
            torch.cuda.current_stream(dev).synchronize()

    with _eager_aligns():
        want = {stage: gicp.align(src, target, guess, cfg, "pallas")
                for stage, (src, target, guess, cfg) in calls.items()}
    gicp.release_graphs()
    sync.reset()
    thread = threading.Thread(target=worker)
    thread.start()
    try:
        got = {stage: gicp.align(src, target, guess, cfg, "pallas")
               for stage, (src, target, guess, cfg) in calls.items()}
    finally:
        stop.set()
        thread.join()
    torch.cuda.synchronize()
    assert sync.counts["gicp_graph.captures"] == 2 * len(calls) and len(copied) > 0
    for stage, res in got.items():
        for name in ("transform", "hessian", "final_error", "num_correspondences"):
            assert torch.equal(getattr(res, name), getattr(want[stage], name)), (stage, name)


def test_gicp_graph_results_do_not_alias(dev):
    """Two aligns of one key: the second leaves the first's result intact,
    and none of the results shares memory with the graphs."""
    from direct_lidar_odometry_tpu_torch.core import se3
    from direct_lidar_odometry_tpu_torch.registration import gicp

    src, target, guess, cfg = _recorded_aligns("pallas")["step.s2m"]
    first = gicp.align(src, target, guess, cfg, "pallas")
    kept = [t.clone() for t in (first.transform, first.hessian, first.final_error,
                                first.num_correspondences)]
    nudge = se3.se3_exp(torch.tensor([0.0, 0.0, 0.05, 0.2, 0.0, 0.0], device=dev))
    second = gicp.align(src, target, nudge @ guess, cfg, "pallas")
    torch.cuda.synchronize()
    assert not torch.equal(second.transform, first.transform)
    for a, b in zip(kept, (first.transform, first.hessian, first.final_error,
                           first.num_correspondences)):
        assert torch.equal(a, b)
    graphs = [g for k, g in gicp._GRAPHS.items() if k[0] == "pallas"]
    owned = {t.data_ptr() for g in graphs for t in (*g.lin, g.flags, *g.st)}
    for res in (first, second):
        for t in (res.transform, res.hessian, res.final_error, res.num_correspondences):
            assert t.data_ptr() not in owned


def _first_trial(src, target, guess, cfg, backend, dtype=torch.float32):
    """The state and the arguments of an align's first LM trial: the
    guess re-orthonormalized, the linearization there, lambda as
    ``gicp._iteration`` sets it; in ``dtype`` (float64: the yardstick)."""
    from direct_lidar_odometry_tpu_torch.registration import gicp
    from direct_lidar_odometry_tpu_torch.registration.covariance import PLANE_EPS

    x0 = cuda_lm.reorthonormalize_plain(guess.to(torch.float32))
    lin = gicp._linearize(x0, src, target, cfg, backend)
    lam0 = cfg.lm_init_lambda_factor * torch.max(torch.abs(torch.diagonal(lin.h)))
    state = [t.to(dtype) for t in (x0, lam0, torch.full((), 2.0, device=x0.device))]
    args = [t.to(dtype) for t in (lin.h, lin.b, lin.error, lin.mu_b, lin.n_b, lin.m0, lin.weight,
                                  src.points)]
    return state, args, (cfg.rotation_epsilon, cfg.transformation_epsilon, PLANE_EPS)


def _trial_error(state, args, eps):
    """The plain version's error at the estimate a trial from ``state``
    would try (its own dtype)."""
    from direct_lidar_odometry_tpu_torch.core import se3

    x, lam, _ = state
    h, b = args[:2]
    d = cuda_lm.solve6(h + lam * torch.eye(6, dtype=h.dtype, device=h.device), b)
    xi = cuda_lm.reorthonormalize_plain(se3.se3_exp(d) @ x)
    return cuda_lm.compute_error_plain(xi, args[7], *args[3:7], eps[2])


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_lm_trial_kernel_matches_plain_on_recorded_frames(dev, backend):
    """K7 against its plain version on each GICP stage's first LM trial of
    the recorded frames, once as it is and once rejected (the
    linearization's error set to 0): the same flags, nu equal, and x,
    lambda and the trial's error each as close to the float64 run of the
    plain version as the float32 plain version is, within 4 times its
    distance plus a floor of 1e-6 of the value's largest magnitude. The two differ by
    the error's summation order (per block, then a tree over blocks,
    against torch.sum's) and by their float32 LU of the damped 6x6
    system, whose rounding the system's condition number amplifies into
    the step; the float64 run bounds both. "pallas_fused" hands over K3's
    strided payload rows. The guess's re-orthonormalization on K7's
    one-thread entry is the plain version's within 1e-6."""
    for stage, (src, target, guess, cfg) in _recorded_aligns(backend).items():
        for case in ("first", "rejected"):
            runs = {}
            for route, dtype in (("kernel", torch.float32), ("plain", torch.float32),
                                 ("f64", torch.float64)):
                state, args, eps = _first_trial(src, target, guess, cfg, backend, dtype)
                if case == "rejected":
                    args[2] = torch.zeros_like(args[2])
                if route == "kernel":
                    work = cuda_lm.workspace(dev)
                    flags = cuda_lm.lm_trial(*state, *args, *eps, work)
                    error = work[cuda_lm.ERROR_SLOT]
                else:
                    error = _trial_error(state, args, eps)
                    flags = cuda_lm.lm_trial_plain(*state, *args, *eps)
                runs[route] = (flags.tolist(), *(t.double() for t in (*state, error)))
            (fk, xk, lk, nk, ek), (fp, xp, lp, np_, ep), (_, x64, l64, _, e64) = (
                runs["kernel"], runs["plain"], runs["f64"])
            where = (stage, case)
            assert fk == fp and not (case == "rejected" and fk[0]), (where, fk, fp)
            assert torch.equal(nk, np_), where
            for name, k, p, ref in (("x", xk, xp, x64), ("lambda", lk, lp, l64),
                                    ("error", ek, ep, e64)):
                floor = 1e-6 * float(ref.abs().max())
                far, plain_far = float((k - ref).abs().max()), float((p - ref).abs().max())
                assert far <= 4 * plain_far + floor, (where, name, far, plain_far, floor)
        x0 = guess.to(torch.float32)
        assert float((cuda_lm.reorthonormalize(x0) - cuda_lm.reorthonormalize_plain(x0))
                     .abs().max()) <= 1e-6, stage


def test_lm_trial_kernel_repeats_bit_for_bit(dev):
    """20 launches of K7 from one state on each recorded stage give the same
    x, lambda, nu, flags and trial error, bit for bit: no atomic decides a
    sum (the blocks' partials are summed by one block, in block order)."""
    for stage, (src, target, guess, cfg) in _recorded_aligns("pallas").items():
        state, args, eps = _first_trial(src, target, guess, cfg, "pallas")
        work = cuda_lm.workspace(dev)
        outs = []
        for _ in range(20):
            st = [t.clone() for t in state]
            flags = cuda_lm.lm_trial(*st, *args, *eps, work)
            outs.append((*st, flags, work[cuda_lm.ERROR_SLOT].clone(),
                         work[cuda_lm.RHO_SLOT].clone()))
        for out in outs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(out, outs[0])), stage


def test_device_constants_on_card_need_no_copy(dev):
    """The helpers' constants on the card: the values of the host copies
    they replace, built without a synchronizing call."""
    import warnings

    from direct_lidar_odometry_tpu_torch.utils import sync

    values = (0.0, -1.0, 0.5, 1.0)
    for dtype in (torch.float32, torch.float64):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the debug mode's own notice
            torch.cuda.set_sync_debug_mode("error")  # a synchronizing call raises
            try:
                got = sync.constant(values, dev, dtype)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert got.device.type == "cuda" and got.dtype == dtype
        assert torch.equal(got.cpu(), torch.tensor(values, dtype=dtype))
        assert sync.constant(values, got.device, dtype) is got


def test_every_sync_of_a_chunk_is_a_counted_wait(dev):
    """Over one chunk of ``process_chunk`` (its scans prepared inside it,
    host preprocessing, the wire encoding, the IMU prior), every call that
    ``torch.cuda.set_sync_debug_mode("warn")`` flags is made inside one of
    the tracer's ``read`` or ``copy`` waits, and each such wait is one
    flagged call; no ``index`` wait is left."""
    import dataclasses
    import warnings

    from direct_lidar_odometry_tpu_torch.config import DloConfig, ImuConfig, ShapeConfig
    from direct_lidar_odometry_tpu_torch.io import synthetic
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
    from direct_lidar_odometry_tpu_torch.utils import sync

    cfg = DloConfig(host_preprocess=True, quantize_transfer=True, s2s_prior="imu",
                    imu=ImuConfig(use=True, calib_time=0.2), shapes=ShapeConfig(
                        n_raw=16384, n_scan=4096, n_keyframe=2048, max_keyframes=16,
                        max_submap_kf=4, n_submap_flat=8192, hull_directions=16))
    cfg = cfg.replace(keyframe=dataclasses.replace(cfg.keyframe, thresh_dist=1.0))
    n = 17
    rng = np.random.default_rng(0)
    world = synthetic.make_urban_world(rng, n_frames=n, speed=1.0, n_dynamic=0)
    beams = synthetic.BeamModel(n_beams=32, n_azimuth=512)
    scans = [synthetic.render_raycast(world, t, rng, max_points=16384, beams=beams)
             for t in range(n)]
    stamps = [float(s) for s in world.stamps[:n]]
    runner = OdometryRunner(cfg, device="cuda")
    for t in np.arange(stamps[0] - 0.3, stamps[-1], 0.01):
        runner.push_imu(float(t), [0.0, 0.0, 0.01], [0.0, 0.0, 9.81])
    runner.process_scan(scans[0], stamps[0])
    runner.process_chunk(scans[1:9], stamps[1:9])  # warm
    torch.cuda.synchronize()
    flagged = []

    def hook(message, *args, **kwargs):
        if "synchronizing CUDA operation" in str(message):
            flagged.append(sync.site())

    sync.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            runner.process_chunk(scans[9:], stamps[9:])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    t = sync.totals()
    counted = {kind: sum(c for (k, *_), (c, _) in t.waits.items() if k == kind)
               for kind in ("read", "copy", "index", "event")}
    outside = [s for s in flagged if s not in ("wait.read", "wait.copy")]
    assert outside == [], (outside, counted)
    assert len(flagged) == counted["read"] + counted["copy"], counted
    assert counted["read"] == sync.counts["host_reads"] > 0 and counted["copy"] > 0
    assert counted["event"] == 8  # the hull positions' copy, waited for each frame
    assert counted["index"] == 0  # the keyframe ring is read by device gathers
    # the GICP iterations replayed from their graphs, none issued eagerly,
    # and the step's stretches outside GICP replayed from theirs
    assert sync.counts["gicp_graph.replays"] > 0 and sync.counts["gicp_graph.eager_iters"] == 0
    assert sync.counts["step_graph.replays"] > 0


@contextlib.contextmanager
def _eager_stretches():
    """``pipeline.odom_frame`` issuing its stretches outside GICP operation
    by operation on the card (the stage functions called eagerly)."""
    from direct_lidar_odometry_tpu_torch.odometry import pipeline
    from direct_lidar_odometry_tpu_torch.utils import graphs

    stretches = pipeline._stretches
    pipeline._stretches = lambda state, backend: graphs.eager
    try:
        yield
    finally:
        pipeline._stretches = stretches


def _same_state(a, b, where):
    """Two states bit for bit: the pose, the ring, the submap cache and its
    members, the carried scan and every other field."""
    from direct_lidar_odometry_tpu_torch.odometry.state import state_to_numpy

    na, nb = state_to_numpy(a), state_to_numpy(b)
    assert na.keys() == nb.keys()
    for k in na:
        np.testing.assert_array_equal(na[k], nb[k], err_msg=f"{where}: {k}")


def test_step_graphs_equal_the_eager_stage_functions(dev, tmp_path):
    """``odom_frame`` with its stretches outside GICP replayed from CUDA
    graphs against the same stage functions run eagerly, on twin runners
    over 46 frames of the small bench world, with an 8-slot ring that
    evicts: every frame's result (pose, keyframe decision, slot, eviction,
    count, submap change) and the whole state after it (ring, submap
    cache, members, carried scan) bit for bit, and the same host reads.
    Frames spawn, rebuild the submap and take the rescue (its gate forced
    on every fifth frame); a loop-closure re-anchoring moves both rings at
    frame 20; at frame 30 both runners resume from their checkpoints, and
    after frame 46 a second pair of runners drives again from the start.
    The graphed runner replays every stretch it has met before, and
    captures afresh after the resume and on the second runner, whose rings
    are new."""
    import dataclasses

    from bench_torch import make_bench_world, production_cfg
    from direct_lidar_odometry_tpu_torch.io import synthetic
    from direct_lidar_odometry_tpu_torch.odometry import loopclosure
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
    from direct_lidar_odometry_tpu_torch.utils import checkpoint, sync

    base = production_cfg(small=True)
    cfg = base.replace(shapes=dataclasses.replace(base.shapes, max_keyframes=8))
    forced = cfg.replace(gicp=dataclasses.replace(cfg.gicp, rescue_s2m_error=0.0))
    n = 46
    rng = np.random.default_rng(0)
    world, max_range, max_pts, beams = make_bench_world(n, rng, small=True)
    scans = [synthetic.render_scan(world, t, rng, max_range=max_range, max_points=max_pts,
                                   beams=beams) for t in range(n)]
    seen = dict(spawn=0, evict=0, rebuild=0, rescue=0)

    def step(runners, t):
        out = []
        for graphed, runner in zip((True, False), runners):
            runner.cfg = forced if t % 5 == 4 else cfg
            reads, rescues = sync.counts["host_reads"], sync.totals().spans.get(
                "step.rescue", (0,))[0]
            with contextlib.nullcontext() if graphed else _eager_stretches():
                res = runner.process_scan(scans[t], float(world.stamps[t]), sync=True)
            out.append((res, sync.counts["host_reads"] - reads,
                        sync.totals().spans.get("step.rescue", (0,))[0] - rescues))
        (got, got_reads, got_rescue), (want, want_reads, want_rescue) = out
        if t == 0:
            return
        for name in ("pose", "position", "quat", "kf_slot", "kf_evicted", "num_keyframes",
                     "spaciousness", "keyframe_thresh_dist", "s2s_error", "s2m_error"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (t, name)
        for name in ("new_keyframe", "submap_changed", "s2s_iterations", "s2m_iterations"):
            assert getattr(got, name) == getattr(want, name), (t, name)
        assert (got_reads, got_rescue) == (want_reads, want_rescue), t
        _same_state(runners[0].state, runners[1].state, f"frame {t}")
        seen["spawn"] += got.new_keyframe
        seen["evict"] += bool(got.kf_evicted)
        seen["rebuild"] += got.submap_changed
        seen["rescue"] += got_rescue

    def window(runners, frames):
        sync.reset()
        for t in frames:
            step(runners, t)
        return dict(sync.counts)

    runners = (OdometryRunner(cfg, dev), OdometryRunner(cfg, dev))
    first = window(runners, range(0, 20))
    for runner in runners:  # a loop-closure round's re-anchoring, the same on both rings
        slots = loopclosure._slot_poses(runner.state.keyframes)
        nudge = torch.eye(4, device=dev)
        nudge[:3, 3] = torch.tensor([0.03, -0.02, 0.0], device=dev)
        runner.state, _ = loopclosure.reanchor(runner.state, nudge @ slots)
    anchored = window(runners, range(20, 30))
    resumed = []
    for i, runner in enumerate(runners):
        path = tmp_path / f"state{i}.npz"
        checkpoint.save_state(str(path), runner.state)
        fresh = OdometryRunner(cfg, dev)
        fresh.state, _ = checkpoint.load_state(str(path), cfg, dev)
        fresh.prev_stamp = runner.prev_stamp
        resumed.append(fresh)
    after_resume = window(resumed, range(30, n))
    second = window((OdometryRunner(cfg, dev), OdometryRunner(cfg, dev)), range(0, 12))
    assert all(seen[k] > 0 for k in seen), seen
    for counts in (first, anchored, after_resume, second):
        assert counts["step_graph.replays"] > 0, counts
        # the eager twin counts nothing: its stretches are not the card's path
        assert counts.get("step_graph.eager", 0) == counts.get("step_graph.captures", 0)
    # a handful of captures a runner and configuration (the forced gate is
    # another configuration)
    assert first["step_graph.captures"] <= 16, first
    assert after_resume["step_graph.captures"] >= 4 and second["step_graph.captures"] >= 4
