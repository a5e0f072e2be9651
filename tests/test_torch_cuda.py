"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the fixture, never at import). On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: ``tests/conftest.py`` configures jax, which a machine
that runs only the port need not have.)

``chip_smoke.py`` runs the same comparisons at the full per-frame shapes.
"""

import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_gicp, cuda_nn, morton

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
