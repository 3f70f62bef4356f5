"""The XLA gridding operators against independent references.

Edge cases (out-of-bounds, edge and colliding records, chunking, grid
shapes, subgrid sizes, antenna ids, record order, run bounds, clustered
degridding, large kernel supports) checked directly on the operators the
program runs on every backend: against the float64 numpy oracle
(``utils/oracle.py``), a direct-DFT truth, or the grid/degrid dot-product
identity.  Runs in complex128 (conftest enables x64) unless stated.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_tpu.ops import (
    convgrid_aw,
    convgrid_wproj,
    degrid_wproj,
)
from ska_sdp_tpu.ops.idg import idg_degrid_wproj, idg_grid_wproj
from ska_sdp_tpu.ops.idg_aw import (
    aw_screens,
    count_pair_tile_runs,
    idg_degrid_aw,
    idg_grid_aw,
)
from ska_sdp_tpu.utils import oracle

N, THETA = 256, 0.05
NW, QPX = 4, 4


def _bank(rng, s=7, nw=NW, qpx=QPX):
    return (rng.standard_normal((nw, qpx, qpx, s, s))
            + 1j * rng.standard_normal((nw, qpx, qpx, s, s)))


def _records(rng, case: str, b: int = 200):
    """Scaled baselines p [b, 3] (±0.5 box) for one record-layout case."""
    p = rng.uniform(-0.4, 0.4, (b, 3))
    if case == "edge":            # patches straddle every grid border
        p[:, :2] = rng.choice([-1.0, 1.0], (b, 2)) * rng.uniform(
            0.485, 0.4999, (b, 2))
    elif case == "oob":           # a third fall wholly outside the grid
        p[: b // 3, :2] = rng.uniform(0.52, 0.7, (b // 3, 2))
    elif case == "colliding":     # groups of records on identical points
        p[:, :2] = np.repeat(p[: b // 10, :2], 10, axis=0)
    elif case == "dense":         # everything inside a few cells
        p[:, :2] = rng.uniform(0.1, 0.1 + 3.0 / N, (b, 2))
    return p


def _vis(rng, b):
    return rng.standard_normal(b) + 1j * rng.standard_normal(b)


CASES = ["interior", "edge", "oob", "colliding", "dense"]


class TestWProjection:
    @pytest.mark.parametrize("case", CASES)
    def test_grid_matches_oracle(self, rng, case):
        bank = _bank(rng)
        p = _records(rng, case)
        wbin = rng.integers(0, NW, p.shape[0])
        vis = _vis(rng, p.shape[0])
        got = convgrid_wproj(jnp.asarray(bank), jnp.zeros((N, N), complex),
                             jnp.asarray(p), jnp.asarray(wbin),
                             jnp.asarray(vis), chunk=64)
        want = oracle.convgrid_wproj(bank, np.zeros((N, N), complex), p,
                                     wbin, vis)
        np.testing.assert_allclose(np.asarray(got), want,
                                   atol=1e-12 * np.abs(want).max() + 1e-300)

    @pytest.mark.parametrize("case", CASES)
    def test_degrid_is_adjoint(self, rng, case):
        """<G, grid(v)> == <degrid(G), v>: the gather reads exactly what
        the scatter writes, OOB taps included (dropped both ways)."""
        bank = _bank(rng)
        p = _records(rng, case)
        wbin = rng.integers(0, NW, p.shape[0])
        vis = _vis(rng, p.shape[0])
        G = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
        # degrid applies conj(K) to what the scatter spreads with K
        Av = convgrid_wproj(jnp.asarray(bank),
                            jnp.zeros((N, N), complex), jnp.asarray(p),
                            jnp.asarray(wbin), jnp.asarray(vis), chunk=64)
        AtG = degrid_wproj(jnp.asarray(bank), jnp.asarray(G), jnp.asarray(p),
                           jnp.asarray(wbin), chunk=64)
        lhs = complex(jnp.vdot(jnp.asarray(G), Av))
        rhs = complex(jnp.vdot(AtG, jnp.asarray(vis)))
        assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), 1.0)

    @pytest.mark.parametrize("chunk", [7, 64, 1000])
    def test_chunk_invariance(self, rng, chunk):
        bank = _bank(rng)
        p = _records(rng, "interior", b=333)
        wbin = jnp.asarray(rng.integers(0, NW, p.shape[0]))
        vis = jnp.asarray(_vis(rng, p.shape[0]))
        g = [convgrid_wproj(jnp.asarray(bank), jnp.zeros((N, N), complex),
                            jnp.asarray(p), wbin, vis, chunk=c)
             for c in (chunk, 8192)]
        np.testing.assert_allclose(np.asarray(g[0]), np.asarray(g[1]),
                                   atol=1e-12 * float(jnp.abs(g[1]).max()))

    @pytest.mark.parametrize("shape", [(48, 80), (80, 48)])
    def test_rectangular_grid_matches_oracle(self, rng, shape):
        bank = _bank(rng)
        p = _records(rng, "interior", b=120)
        wbin = rng.integers(0, NW, p.shape[0])
        vis = _vis(rng, p.shape[0])
        got = convgrid_wproj(jnp.asarray(bank), jnp.zeros(shape, complex),
                             jnp.asarray(p), jnp.asarray(wbin),
                             jnp.asarray(vis), chunk=32)
        want = oracle.convgrid_wproj(bank, np.zeros(shape, complex), p,
                                     wbin, vis)
        np.testing.assert_allclose(np.asarray(got), want,
                                   atol=1e-12 * np.abs(want).max())

    @pytest.mark.parametrize("support", [17, 21, 25])
    def test_large_support_matches_oracle(self, rng, support):
        """Kernel patches wider than 16 taps: the XLA scatter has no tile
        halo, so any support grids exactly."""
        bank = _bank(rng, s=support, nw=2, qpx=2)
        p = _records(rng, "edge", b=60)
        wbin = rng.integers(0, 2, p.shape[0])
        vis = _vis(rng, p.shape[0])
        got = convgrid_wproj(jnp.asarray(bank), jnp.zeros((N, N), complex),
                             jnp.asarray(p), jnp.asarray(wbin),
                             jnp.asarray(vis), chunk=16)
        want = oracle.convgrid_wproj(bank, np.zeros((N, N), complex), p,
                                     wbin, vis)
        np.testing.assert_allclose(np.asarray(got), want,
                                   atol=1e-12 * np.abs(want).max())


class TestBankAW:
    @pytest.mark.parametrize("support", [15, 17])
    def test_matches_oracle_convolutions(self, rng, support):
        """conj(A1 ⊛ A2 ⊛ W) patches built per record with the oracle's
        FFT convolution (reference ``convolve2d`` semantics), scattered
        with the oracle — any support, no tile gate."""
        s, nant, b = support, 3, 24
        wk = _bank(rng, s=s, nw=2, qpx=2)
        ak = np.zeros((nant, s, s), complex)
        ak[:, s // 2, s // 2] = 1.0
        ak += 0.05 * (rng.standard_normal(ak.shape)
                      + 1j * rng.standard_normal(ak.shape))
        p = _records(rng, "edge", b=b)
        wbin = rng.integers(0, 2, b)
        a1 = rng.integers(0, nant, b)
        a2 = rng.integers(0, nant, b)
        vis = _vis(rng, b)
        got = convgrid_aw(jnp.asarray(wk), jnp.asarray(ak),
                          jnp.zeros((N, N), complex), jnp.asarray(p),
                          jnp.asarray(wbin), jnp.asarray(a1),
                          jnp.asarray(a2), jnp.asarray(vis), chunk=8)
        x, xf, y, yf = oracle.frac_coords((N, N), 2, p)
        want = np.zeros((N, N), complex)
        for k in range(b):
            aw = oracle.convolve2d(oracle.convolve2d(ak[a1[k]], ak[a2[k]]),
                                   wk[wbin[k], yf[k], xf[k]])
            oracle._scatter_patch(want, int(y[k]) - s // 2,
                                  int(x[k]) - s // 2, vis[k] * np.conj(aw))
        np.testing.assert_allclose(np.asarray(got), want,
                                   atol=1e-10 * np.abs(want).max())


# ---------------------------------------------------------------------------
# image-domain gridding
# ---------------------------------------------------------------------------


def _truth(p, w, vis, shape=(N, N), theta=THETA, screens=None, a1=None,
           a2=None):
    """Direct-DFT dirty image (complex, 1/(H·W)); ``screens`` [nant, H, W]
    fine A-screens multiply each record by conj(A_a1)·conj(A_a2)."""
    H, W = shape
    yf = (np.arange(H) - H // 2) / H
    xf = (np.arange(W) - W // 2) / W
    l = xf * theta * W / H
    m = yf * theta
    nlm = 1.0 - np.sqrt(1.0 - l[None, :] ** 2 - m[:, None] ** 2)
    img = np.zeros(shape, complex)
    for i in range(p.shape[0]):
        term = vis[i] * np.outer(np.exp(2j * np.pi * p[i, 1] * H * yf),
                                 np.exp(2j * np.pi * p[i, 0] * W * xf))
        term = term * np.exp(-2j * np.pi * w[i] * nlm)
        if screens is not None:
            term = term * np.conj(screens[a1[i]] * screens[a2[i]])
        img += term
    return img / (H * W)


def _corrected(grid, S, shape=(N, N)):
    from ska_sdp_tpu.ops import ifft_centered
    from ska_sdp_tpu.ops.idg import kaiser_taper, taper_fine

    H, W = shape
    ty = np.asarray(taper_fine(H, S, kaiser_taper(S, 12.0)))
    tx = np.asarray(taper_fine(W, S, kaiser_taper(S, 12.0)))
    return np.asarray(ifft_centered(jnp.asarray(grid))) / np.outer(ty, tx)


def _rel_disc(a, b):
    """Relative error inside radius 0.75 of the half-width (the IDG
    accuracy envelope of ops/idg.py)."""
    H, W = b.shape
    yy = (np.arange(H) - H // 2)[:, None] / (H / 2)
    xx = (np.arange(W) - W // 2)[None, :] / (W / 2)
    m = yy ** 2 + xx ** 2 <= 0.75 ** 2
    return np.linalg.norm((a - b)[m]) / np.linalg.norm(b[m])


def _track(rng, nant=5, ntime=40, spread=12.0, wmax=200.0):
    pairs = [(i, j) for i in range(nant) for j in range(i + 1, nant)]
    nbl = len(pairs)
    u0 = rng.uniform(-0.3, 0.3, (nbl, 2))
    du = rng.uniform(-spread / N, spread / N, (nbl, 2))
    w0 = rng.uniform(-wmax, wmax, nbl)
    rows = [(*(u0[b] + du[b] * t / ntime), w0[b], i, j)
            for t in range(ntime) for b, (i, j) in enumerate(pairs)]
    arr = np.asarray(rows)
    p = np.zeros((arr.shape[0], 3))
    p[:, :2] = arr[:, :2]
    return (p, arr[:, 2], arr[:, 3].astype(np.int32),
            arr[:, 4].astype(np.int32), _vis(rng, arr.shape[0]), nbl)


def _akerns(rng, nant, s=15, amp=0.05):
    ak = np.zeros((nant, s, s), complex)
    ak[:, s // 2, s // 2] = 1.0
    c = s // 2
    ak[:, c - 1:c + 2, c - 1:c + 2] += amp * (
        rng.standard_normal((nant, 3, 3))
        + 1j * rng.standard_normal((nant, 3, 3)))
    return ak


def _fine(ak, shape=(N, N)):
    H, W = shape
    s = ak.shape[-1]
    j = np.arange(s) - s // 2
    ey = np.exp(-2j * np.pi * np.outer((np.arange(H) - H // 2) / H, j))
    ex = np.exp(-2j * np.pi * np.outer((np.arange(W) - W // 2) / W, j))
    return np.einsum("qj,ajk,rk->aqr", ey, ak, ex)


def _max_runs(p, a1, a2, S, support=15, shape=(N, N)):
    return int(count_pair_tile_runs(shape, jnp.asarray(p), jnp.asarray(a1),
                                    jnp.asarray(a2), subgrid=S,
                                    support=support))


class TestIDG:
    @pytest.mark.parametrize("S", [32, 64, 128])
    def test_subgrid_sizes_match_truth(self, rng, S):
        p = rng.uniform(-0.42, 0.42, (150, 3))
        w = rng.uniform(-200, 200, 150)
        vis = _vis(rng, 150)
        g = idg_grid_wproj((N, N), jnp.asarray(p), jnp.asarray(w),
                           jnp.asarray(vis), theta=THETA, subgrid=S)
        assert _rel_disc(_corrected(g, S), _truth(p, w, vis)) < 1e-4

    @pytest.mark.parametrize("chunk,batch", [(32, 8), (128, 256), (256, 3)])
    def test_chunk_batch_invariance(self, rng, chunk, batch):
        p = rng.uniform(-0.42, 0.42, (300, 3))
        w = rng.uniform(-200, 200, 300)
        vis = jnp.asarray(_vis(rng, 300))
        args = ((N, N), jnp.asarray(p), jnp.asarray(w), vis)
        g0 = idg_grid_wproj(*args, theta=THETA, subgrid=32)
        g1 = idg_grid_wproj(*args, theta=THETA, subgrid=32, chunk=chunk,
                            batch=batch)
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g0),
                                   atol=1e-12 * float(jnp.abs(g0).max()))

    @pytest.mark.parametrize("shape", [(192, 320), (320, 192)])
    def test_rectangular_grid_matches_truth(self, rng, shape):
        H, W = shape
        p = rng.uniform(-0.42, 0.42, (120, 3))
        w = rng.uniform(-200, 200, 120)
        vis = _vis(rng, 120)
        g = idg_grid_wproj(shape, jnp.asarray(p), jnp.asarray(w),
                           jnp.asarray(vis), theta=THETA, subgrid=32)
        assert _rel_disc(_corrected(g, 32, shape),
                         _truth(p, w, vis, shape)) < 1e-4

    @pytest.mark.parametrize("case", ["edge", "oob"])
    def test_edge_records_adjoint(self, rng, case):
        p = _records(rng, case, b=150)
        w = rng.uniform(-200, 200, p.shape[0])
        vis = _vis(rng, p.shape[0])
        G = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
        Av = idg_grid_wproj((N, N), jnp.asarray(p), jnp.asarray(w),
                            jnp.asarray(vis), theta=THETA, subgrid=32)
        AtG = idg_degrid_wproj((N, N), jnp.asarray(p), jnp.asarray(w),
                               jnp.asarray(G), theta=THETA, subgrid=32)
        lhs = complex(jnp.vdot(jnp.asarray(G), Av))
        rhs = complex(jnp.vdot(AtG, jnp.asarray(vis)))
        # the plain-IDG taper and phase tables are float32 in both
        # directions, so the identity holds to ~1e-8, not 1e-16
        assert abs(lhs - rhs) <= 1e-6 * abs(lhs)

    @pytest.mark.parametrize("frac", [0.9, 0.99])
    def test_clustered_degrid_matches_fringe(self, rng, frac):
        """Many records in one or two subgrids (long per-subgrid chunk
        runs): the point-source prediction still equals the analytic
        fringe with the exact w screen."""
        from ska_sdp_tpu.ops import fft_centered
        from ska_sdp_tpu.ops.idg import kaiser_taper, taper_fine

        b, S = 2000, 32
        p = rng.uniform(-0.42, 0.42, (b, 3))
        k = int(frac * b)
        p[:k, :2] = rng.uniform(0.01, 0.03, (k, 2))
        w = rng.uniform(-200, 200, b)
        py, px = 150, 170
        img = np.zeros((N, N))
        img[py, px] = 1.0
        tf = np.asarray(taper_fine(N, S, kaiser_taper(S, 12.0)))
        grid = fft_centered(jnp.asarray(img / np.outer(tf, tf), complex))
        pred = np.asarray(idg_degrid_wproj((N, N), jnp.asarray(p),
                                           jnp.asarray(w), grid,
                                           theta=THETA, subgrid=S))
        l0, m0 = (px - N // 2) / N, (py - N // 2) / N
        n0 = 1.0 - np.sqrt(1.0 - (l0 * THETA) ** 2 - (m0 * THETA) ** 2)
        true = (np.exp(-2j * np.pi * (p[:, 0] * N * l0 + p[:, 1] * N * m0))
                * np.exp(2j * np.pi * w * n0))
        assert np.abs(pred - true).max() < 2e-4


class TestIDGAW:
    @pytest.mark.parametrize("S,support", [(32, 9), (64, 15), (128, 15)])
    def test_subgrid_sizes_match_truth(self, rng, S, support):
        p, w, a1, a2, vis, nbl = _track(rng)
        ak = _akerns(rng, 5, s=support)
        g, nd = idg_grid_aw(
            (N, N), jnp.asarray(p), jnp.asarray(a1), jnp.asarray(a2),
            jnp.asarray(w), jnp.asarray(vis),
            aw_screens(jnp.asarray(ak), S, dtype=jnp.complex128),
            theta=THETA, subgrid=S, support=support,
            max_runs=_max_runs(p, a1, a2, S, support))
        assert int(nd) == 0
        truth = _truth(p, w, vis, screens=_fine(ak), a1=a1, a2=a2)
        assert _rel_disc(_corrected(g, S), truth) < 3e-4

    @pytest.mark.parametrize("S,support", [(32, 9), (64, 15), (128, 15)])
    def test_subgrid_sizes_adjoint(self, rng, S, support):
        p, w, a1, a2, vis, nbl = _track(rng)
        scr = aw_screens(jnp.asarray(_akerns(rng, 5, s=support, amp=0.3)),
                         S, dtype=jnp.complex128)
        mr = _max_runs(p, a1, a2, S, support)
        G = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
        kw = dict(theta=THETA, subgrid=S, support=support, max_runs=mr)
        Av, nd1 = idg_grid_aw((N, N), jnp.asarray(p), jnp.asarray(a1),
                              jnp.asarray(a2), jnp.asarray(w),
                              jnp.asarray(vis), scr, **kw)
        AtG, nd2 = idg_degrid_aw((N, N), jnp.asarray(p), jnp.asarray(a1),
                                 jnp.asarray(a2), jnp.asarray(w),
                                 jnp.asarray(G), scr, **kw)
        assert int(nd1) == int(nd2) == 0
        lhs = complex(jnp.vdot(jnp.asarray(G), Av))
        rhs = complex(jnp.vdot(AtG, jnp.asarray(vis)))
        assert abs(lhs - rhs) <= 1e-10 * abs(lhs)

    @pytest.mark.parametrize("shape", [(192, 320), (320, 192)])
    def test_rectangular_grid_adjoint(self, rng, shape):
        p, w, a1, a2, vis, nbl = _track(rng, nant=4)
        scr = aw_screens(jnp.asarray(_akerns(rng, 4)), 64,
                         dtype=jnp.complex128)
        mr = _max_runs(p, a1, a2, 64, shape=shape)
        G = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
        kw = dict(theta=THETA, subgrid=64, max_runs=mr)
        Av, nd1 = idg_grid_aw(shape, jnp.asarray(p), jnp.asarray(a1),
                              jnp.asarray(a2), jnp.asarray(w),
                              jnp.asarray(vis), scr, **kw)
        AtG, nd2 = idg_degrid_aw(shape, jnp.asarray(p), jnp.asarray(a1),
                                 jnp.asarray(a2), jnp.asarray(w),
                                 jnp.asarray(G), scr, **kw)
        assert int(nd1) == int(nd2) == 0
        lhs = complex(jnp.vdot(jnp.asarray(G), Av))
        rhs = complex(jnp.vdot(AtG, jnp.asarray(vis)))
        assert abs(lhs - rhs) <= 1e-10 * abs(lhs)

    @pytest.mark.parametrize("chunk,batch", [(32, 5), (256, 64)])
    def test_chunk_batch_invariance_vs_truth(self, rng, chunk, batch):
        """Chunk length and batch change only how runs are cut, not what
        is gridded: every setting meets the same truth."""
        p, w, a1, a2, vis, nbl = _track(rng, nant=4)
        ak = _akerns(rng, 4)
        scr = aw_screens(jnp.asarray(ak), 64, dtype=jnp.complex128)
        g, nd = idg_grid_aw(
            (N, N), jnp.asarray(p), jnp.asarray(a1), jnp.asarray(a2),
            jnp.asarray(w), jnp.asarray(vis), scr, theta=THETA, subgrid=64,
            chunk=chunk, batch=batch, max_runs=_max_runs(p, a1, a2, 64))
        assert int(nd) == 0
        truth = _truth(p, w, vis, screens=_fine(ak), a1=a1, a2=a2)
        assert _rel_disc(_corrected(g, 64), truth) < 3e-4

    @pytest.mark.parametrize("offset", [128, 1000, 4000])
    def test_large_antenna_ids(self, rng, offset):
        """Antenna ids of 128 and more (SKA1-Low has 512 stations): the
        pair keys keep such pairs apart, so shifting every id by
        ``offset`` grids exactly the same chunks."""
        p, w, a1, a2, vis, nbl = _track(rng, nant=4)
        scr = np.asarray(aw_screens(jnp.asarray(_akerns(rng, 4, amp=0.3)),
                                    64, dtype=jnp.complex64))
        big = np.zeros((offset + 4, 64, 64), np.complex64)
        big[offset:] = scr
        mr = _max_runs(p, a1, a2, 64)
        kw = dict(theta=THETA, subgrid=64, max_runs=mr)
        g0, nd0 = idg_grid_aw((N, N), jnp.asarray(p), jnp.asarray(a1),
                              jnp.asarray(a2), jnp.asarray(w),
                              jnp.asarray(vis), jnp.asarray(scr), **kw)
        g1, nd1 = idg_grid_aw((N, N), jnp.asarray(p),
                              jnp.asarray(a1 + offset),
                              jnp.asarray(a2 + offset), jnp.asarray(w),
                              jnp.asarray(vis), jnp.asarray(big), **kw)
        assert int(nd0) == int(nd1) == 0
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g0),
                                   atol=1e-12 * float(jnp.abs(g0).max()))

    def test_ids_past_key_envelope_dropped_and_counted(self, rng):
        p, w, a1, a2, vis, nbl = _track(rng, nant=3)
        a1 = a1.copy()
        bad = a1 == 0
        a1[bad] = 2 ** 15
        scr = jnp.ones((2 ** 15 + 1, 64, 64), jnp.complex64)
        _, nd = idg_grid_aw((N, N), jnp.asarray(p), jnp.asarray(a1),
                            jnp.asarray(a2), jnp.asarray(w),
                            jnp.asarray(vis, jnp.complex64), scr,
                            theta=THETA, subgrid=64, max_runs=256)
        assert int(nd) == int(bad.sum())

    @pytest.mark.parametrize("nant", [3, 5])
    def test_degrid_record_order_invariance(self, rng, nant):
        """Time-major (as observed) and pair-major record streams sort to
        the same chunks: identical predictions, record for record."""
        p, w, a1, a2, vis, nbl = _track(rng, nant=nant)
        scr = aw_screens(jnp.asarray(_akerns(rng, nant, amp=0.3)), 64,
                         dtype=jnp.complex128)
        G = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
        mr = _max_runs(p, a1, a2, 64)

        def run(o):
            v, nd = idg_degrid_aw((N, N), jnp.asarray(p[o]),
                                  jnp.asarray(a1[o]), jnp.asarray(a2[o]),
                                  jnp.asarray(w[o]), jnp.asarray(G), scr,
                                  theta=THETA, subgrid=64, max_runs=mr)
            return np.asarray(v), int(nd)

        pm = np.argsort(a1 * 64 + a2, kind="stable")
        v0, nd0 = run(np.arange(p.shape[0]))
        v1, nd1 = run(pm)
        assert nd0 == nd1 == 0
        np.testing.assert_allclose(v1, v0[pm], atol=1e-12 * np.abs(v0).max())

    @pytest.mark.parametrize("nant", [4, 6])
    def test_run_count_is_the_exact_bound(self, rng, nant):
        """``count_pair_tile_runs`` is the least max_runs that drops
        nothing: one run fewer overflows into counted drops."""
        p, w, a1, a2, vis, nbl = _track(rng, nant=nant, spread=40.0)
        mr = _max_runs(p, a1, a2, 64)
        scr = jnp.ones((nant, 64, 64), jnp.complex128)
        res = [idg_grid_aw((N, N), jnp.asarray(p), jnp.asarray(a1),
                           jnp.asarray(a2), jnp.asarray(w),
                           jnp.asarray(vis), scr, theta=THETA, subgrid=64,
                           max_runs=m) for m in (mr, mr - 1)]
        assert int(res[0][1]) == 0
        assert int(res[1][1]) > 0
        assert np.all(np.isfinite(np.asarray(res[1][0])))

    @pytest.mark.parametrize("max_runs", [1, 2, 4])
    def test_drops_counted_alike_both_directions(self, rng, max_runs):
        p, w, a1, a2, vis, nbl = _track(rng, nant=4)
        scr = jnp.ones((4, 64, 64), jnp.complex128)
        kw = dict(theta=THETA, subgrid=64, max_runs=max_runs)
        _, nd1 = idg_grid_aw((N, N), jnp.asarray(p), jnp.asarray(a1),
                             jnp.asarray(a2), jnp.asarray(w),
                             jnp.asarray(vis), scr, **kw)
        v, nd2 = idg_degrid_aw((N, N), jnp.asarray(p), jnp.asarray(a1),
                               jnp.asarray(a2), jnp.asarray(w),
                               jnp.ones((N, N), complex), scr, **kw)
        assert 0 < int(nd1) == int(nd2) <= p.shape[0]
        # dropped records predict exactly zero, placed ones do not
        assert int(np.sum(np.asarray(v) == 0)) == int(nd2)

    def test_driver_run_bound_covers_the_data(self, rng):
        """``models.dataset.idg_aw_max_runs`` on metre uvw: at least the
        exact count, a multiple of 1024, and the pipeline drops 0."""
        from ska_sdp_tpu.models import dataset as ds

        p, w, a1, a2, vis, nbl = _track(rng, nant=6, spread=40.0)
        f = 299792458.0                     # 1 m == 1 wavelength
        lam = int(round(N / THETA))
        uvw = (p * lam).astype(np.float32)
        uvw[:, 2] = w
        mr = ds.idg_aw_max_runs(uvw, np.float32(f), a1, a2, theta=THETA,
                                lam=lam, subgrid=64)
        assert mr % 1024 == 0 and mr >= _max_runs(p, a1, a2, 64)
        scr = np.ones((6, 64, 64), np.complex64)
        _, _, nd = ds._aw_idg_pipeline(
            scr, uvw, a1, a2, np.float32(f), vis.astype(np.complex64),
            theta=THETA, lam=lam, max_runs=mr)
        assert int(nd) == 0
