"""Image-domain gridding: accuracy vs ground truth and vs the exact
scatter path.

IDG approximates the same imaging operator as the oversampled-bank
scatter (reference screen semantics, ``/root/reference/src/Gridding.hs:
651-667``) but places visibilities at their exact continuous positions.
Its accuracy is verified three ways:

1. against an independent direct-DFT ground truth (the operator both
   gridders approximate) — IDG lands ~1e-4;
2. against the exact scatter path gridding the SAME tapered-screen bank
   on oversample-lattice positions (methods differ only in realization)
   — ~1e-4;
3. through the grid/degrid dot-product identity (exact adjoints).

Versus the PLAIN reference bank the difference is bounded by the bank's
own truncation (untapered Dirichlet tails) + qpx quantization — that
bound is asserted too, as documentation of why it is loose.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_tpu.config import KernelOptions
from ska_sdp_tpu.ops import convgrid_wproj, find_closest, ifft_centered
from ska_sdp_tpu.ops.idg import (
    idg_grid_wproj,
    kaiser_taper,
    taper_fine,
    tapered_w_bank,
)

N, THETA, S, BETA = 256, 0.05, 32, 12.0
NW, WMAX = 8, 250.0


def _problem(rng, b=300, snap=None):
    p = rng.uniform(-0.42, 0.42, (b, 3))
    if snap:
        p[:, :2] = np.round(p[:, :2] * (snap * N)) / (snap * N)
    w = rng.uniform(-WMAX, WMAX, b).astype(np.float32)
    vis = (rng.standard_normal(b) + 1j * rng.standard_normal(b)).astype(
        np.complex64
    )
    return p.astype(np.float32), w, vis


def _truth_image(p, w, vis):
    xf = (np.arange(N) - N // 2) / N
    l = xf * THETA
    L, M = np.meshgrid(l, l, indexing="xy")
    n_lm = 1.0 - np.sqrt(1.0 - L**2 - M**2)
    img = np.zeros((N, N), np.complex128)
    for i in range(p.shape[0]):
        ey = np.exp(2j * np.pi * p[i, 1] * N * xf)
        ex = np.exp(2j * np.pi * p[i, 0] * N * xf)
        img += vis[i] * np.outer(ey, ex) * np.exp(-2j * np.pi * w[i] * n_lm)
    return img / (N * N)


def _corrected_image(grid, S=S, beta=BETA):
    tf = np.asarray(taper_fine(N, S, kaiser_taper(S, beta)))
    return np.asarray(ifft_centered(grid)) / np.outer(tf, tf)


def _crop(a):
    return a[N // 8 : -N // 8, N // 8 : -N // 8]


def _rel(a, b):
    return np.linalg.norm(_crop(a - b)) / np.linalg.norm(_crop(b))


class TestIDGAccuracy:
    def test_matches_direct_dft_truth(self, rng):
        p, w, vis = _problem(rng)
        g = idg_grid_wproj(
            (N, N), jnp.asarray(p), jnp.asarray(w), jnp.asarray(vis),
            theta=THETA,
        )
        img = _corrected_image(g)
        assert _rel(img, _truth_image(p, w, vis)) < 3e-4

    def test_matches_tapered_bank_scatter(self, rng):
        # same effective operator both ways; snap uv to the oversample
        # lattice so the bank path's quantization doesn't dominate
        p, w, vis = _problem(rng, snap=8)
        opts = KernelOptions(qpx=8, npix_ff=256, npix_kern=15)
        centers = np.linspace(-WMAX, WMAX, NW)
        wbin = find_closest(jnp.asarray(centers, jnp.float32), jnp.asarray(w))
        w_b = centers[np.asarray(wbin)].astype(np.float32)

        bank_t = tapered_w_bank(
            THETA, jnp.asarray(centers, jnp.float32), opts, BETA, S,
            dtype=jnp.float32,
        ).astype(jnp.complex64)
        g_ex = convgrid_wproj(
            bank_t, jnp.zeros((N, N), jnp.complex64), jnp.asarray(p), wbin,
            jnp.asarray(vis), chunk=64,
        )
        g_idg = idg_grid_wproj(
            (N, N), jnp.asarray(p), jnp.asarray(w_b), jnp.asarray(vis),
            theta=THETA,
        )
        assert _rel(_corrected_image(g_idg), _corrected_image(g_ex)) < 3e-4

    def test_plain_bank_difference_is_banks_truncation(self, rng):
        # vs the UNtapered reference bank: bounded by the bank's own
        # Dirichlet truncation + qpx quantization (documented, loose)
        from ska_sdp_tpu.ops import w_kernel_bank

        p, w, vis = _problem(rng)
        opts = KernelOptions(qpx=8, npix_ff=256, npix_kern=15)
        centers = np.linspace(-WMAX, WMAX, NW)
        wbin = find_closest(jnp.asarray(centers, jnp.float32), jnp.asarray(w))
        w_b = centers[np.asarray(wbin)].astype(np.float32)
        bank = w_kernel_bank(
            THETA, jnp.asarray(centers, jnp.float32), opts, dtype=jnp.float32
        ).astype(jnp.complex64)
        g_ex = convgrid_wproj(
            bank, jnp.zeros((N, N), jnp.complex64), jnp.asarray(p), wbin,
            jnp.asarray(vis), chunk=64,
        )
        g_idg = idg_grid_wproj(
            (N, N), jnp.asarray(p), jnp.asarray(w_b), jnp.asarray(vis),
            theta=THETA,
        )
        img_e = np.asarray(ifft_centered(g_ex))
        img_i = _corrected_image(g_idg)
        truth = _truth_image(p, w_b, vis)
        err_exact = _rel(img_e, truth)
        err_idg = _rel(img_i, truth)
        assert err_idg < 3e-4          # IDG is near-exact
        assert err_idg < err_exact     # and strictly closer than the bank
        assert _rel(img_i, img_e) < 2 * err_exact + 1e-3

    def test_single_vis_kernel_patch(self, rng):
        # without taper the IDG patch equals the reference's w-kernel taps
        # at an on-cell position (same screen, same normalization)
        from ska_sdp_tpu.ops import w_kernel_bank

        wval = 200.0
        opts = KernelOptions(qpx=8, npix_ff=256, npix_kern=15)
        bank = np.asarray(
            w_kernel_bank(THETA, jnp.asarray([wval], jnp.float32), opts,
                          dtype=jnp.float32)
        )
        K = bank[0, 0, 0]
        p = jnp.asarray([[10 / N, 20 / N, 0.0]], jnp.float32)
        g = np.asarray(
            idg_grid_wproj((N, N), p, jnp.asarray([wval], jnp.float32),
                           jnp.asarray([1 + 0j], jnp.complex64),
                           theta=THETA, taper_beta=0.0)
        )
        yc, xc = N // 2 + 20, N // 2 + 10
        patch = g[yc - 7 : yc + 8, xc - 7 : xc + 8]
        assert np.linalg.norm(patch - K) / np.linalg.norm(K) < 5e-3

    def test_oob_dropped_and_empty(self, rng):
        p = jnp.asarray([[0.55, 0.1, 0.0], [0.1, -0.6, 0.0]], jnp.float32)
        g = idg_grid_wproj(
            (N, N), p, jnp.zeros(2, jnp.float32),
            jnp.ones(2, jnp.complex64), theta=THETA,
        )
        assert float(jnp.abs(g).sum()) == 0.0


class TestIDGDegrid:
    def test_adjoint(self, rng):
        # <grid(vis), G> == <vis, degrid(G)> through the IDG pair
        from ska_sdp_tpu.ops.idg import idg_degrid_wproj

        p, w, vis = _problem(rng, b=300)
        G = (rng.standard_normal((N, N))
             + 1j * rng.standard_normal((N, N))).astype(np.complex64)
        Av = idg_grid_wproj(
            (N, N), jnp.asarray(p), jnp.asarray(w), jnp.asarray(vis),
            theta=THETA,
        )
        AtG = idg_degrid_wproj(
            (N, N), jnp.asarray(p), jnp.asarray(w), jnp.asarray(G),
            theta=THETA,
        )
        lhs = complex(jnp.vdot(jnp.asarray(G), Av))
        rhs = complex(jnp.vdot(AtG, jnp.asarray(vis)))
        assert abs(lhs - rhs) / max(abs(lhs), 1e-30) < 1e-5

    def test_point_source_prediction(self, rng):
        # predict from a delta-model image == the analytic fringe with the
        # exact w screen (continuous w, no quantization)
        from ska_sdp_tpu.ops import fft_centered
        from ska_sdp_tpu.ops.idg import idg_degrid_wproj

        p, w, _ = _problem(rng, b=200)
        py, px = 150, 170
        img = np.zeros((N, N), np.complex64)
        img[py, px] = 1.0
        tf = np.asarray(taper_fine(N, S, kaiser_taper(S, BETA)))
        grid = fft_centered(jnp.asarray(img / np.outer(tf, tf)))
        pred = np.asarray(
            idg_degrid_wproj((N, N), jnp.asarray(p), jnp.asarray(w),
                             grid, theta=THETA)
        )
        l0 = (px - N // 2) / N
        m0 = (py - N // 2) / N
        n0 = 1.0 - np.sqrt(1.0 - (l0 * THETA)**2 - (m0 * THETA)**2)
        true = (np.exp(-2j * np.pi * (p[:, 0] * N * l0 + p[:, 1] * N * m0))
                * np.exp(2j * np.pi * w * n0))
        valid = np.abs(pred) > 1e-3
        assert valid.sum() == p.shape[0]        # all in-bounds here
        assert np.abs(pred[valid] - true[valid]).max() < 2e-4

    def test_oob_zeroed(self, rng):
        from ska_sdp_tpu.ops.idg import idg_degrid_wproj

        p = jnp.asarray([[0.55, 0.1, 0.0], [0.1, 0.1, 0.0]], jnp.float32)
        G = jnp.ones((N, N), jnp.complex64)
        v = np.asarray(idg_degrid_wproj(
            (N, N), p, jnp.zeros(2, jnp.float32), G, theta=THETA
        ))
        assert v[0] == 0
        assert abs(v[1]) > 0


class TestIDGFovBound:
    """Quantified usable-FOV claims: the plain image is
    accurate inside 75% of the max-norm radius; the padded-FOV plan
    (``idg_fov_pad_plan``) bounds the FULL target-FOV error.  These assert
    the claimed bounds — measured in experiments/idg_fov_sweep.py —
    instead of silently cropping."""

    def test_plain_fov_interior_bound(self, rng):
        p, w, vis = _problem(rng, b=400)
        g = idg_grid_wproj(
            (N, N), jnp.asarray(p), jnp.asarray(w), jnp.asarray(vis),
            theta=THETA,
        )
        img = _corrected_image(g)
        ref = _truth_image(p, w, vis)
        yy, xx = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
        r = np.maximum(np.abs(yy - N // 2), np.abs(xx - N // 2)) / (N // 2)
        m = r <= 0.75
        err = np.linalg.norm((img - ref)[m]) / np.linalg.norm(ref[m])
        assert err < 1e-3, err

    def test_fov_pad_full_image_bound(self, rng):
        from ska_sdp_tpu.ops.idg import idg_fov_pad_plan

        p, w, vis = _problem(rng, b=400)
        n_pad, lo = idg_fov_pad_plan(N, 0.75)
        theta_g = THETA * n_pad / N
        g = idg_grid_wproj(
            (n_pad, n_pad), jnp.asarray(p), jnp.asarray(w),
            jnp.asarray(vis), theta=theta_g,
        )
        tf = np.asarray(taper_fine(n_pad, S, kaiser_taper(S, BETA)))
        img = np.asarray(ifft_centered(g)) / np.outer(tf, tf)
        img = img * (n_pad / N) ** 2          # iFFT 1/n² renormalization
        img = img[lo:lo + N, lo:lo + N]
        ref = _truth_image(p, w, vis)
        err = np.linalg.norm(img - ref) / np.linalg.norm(ref)
        assert err < 1e-3, err

    def test_fov_pad_plan_geometry(self):
        from ska_sdp_tpu.ops.idg import idg_fov_pad_plan

        n_pad, lo = idg_fov_pad_plan(2400, 0.75)
        assert n_pad >= 3200 and (n_pad - 2400) % 2 == 0
        assert lo == (n_pad - 2400) // 2
        assert idg_fov_pad_plan(256, 1.0) == (256, 0)
        with pytest.raises(ValueError):
            idg_fov_pad_plan(256, 0.0)


class TestIDGPredictFovPad:
    """fov_pad for the PREDICT direction: embedding the
    model in a padded FOV before the taper division bounds the error of
    predictions from edge sources — round-trip workflows no longer mix a
    padded forward with an edge-degraded reverse."""

    def _pred(self, rng, fov_pad):
        from ska_sdp_tpu.models.dataset import _idg_predict_pipeline
        from ska_sdp_tpu.ops.coords import SPEED_OF_LIGHT

        p, w, _ = _problem(rng, b=200)
        py, px = N - 7, N // 2 + 3       # r ≈ 0.95: unusable un-padded
        img = np.zeros((N, N), np.float32)
        img[py, px] = 1.0
        lam = int(round(N / THETA))
        uvw = np.stack(
            [p[:, 0] * lam, p[:, 1] * lam, w], axis=1).astype(np.float32)
        f = np.asarray([SPEED_OF_LIGHT], np.float32)
        pred = np.asarray(_idg_predict_pipeline(
            img, uvw, f, theta=THETA, lam=lam, subgrid=S,
            taper_beta=BETA, fov_pad=fov_pad,
        ))
        l0 = (px - N // 2) / N
        m0 = (py - N // 2) / N
        n0 = 1.0 - np.sqrt(1.0 - (l0 * THETA) ** 2 - (m0 * THETA) ** 2)
        true = (np.exp(-2j * np.pi * (p[:, 0] * N * l0 + p[:, 1] * N * m0))
                * np.exp(2j * np.pi * w * n0))
        return pred, true

    def test_edge_source_prediction_padded(self, rng):
        # fresh identically-seeded generators: both runs must see the
        # SAME problem (the fixture generator advances between draws)
        pred_plain, true = self._pred(np.random.default_rng(42), None)
        pred_pad, _ = self._pred(np.random.default_rng(42), 0.75)
        err_plain = np.abs(pred_plain - true).max()
        err_pad = np.abs(pred_pad - true).max()
        # the padded model maps the edge source to the accurate interior
        assert err_pad < 2e-3, err_pad
        assert err_pad < err_plain / 10, (err_pad, err_plain)

    def test_interior_source_unchanged(self, rng):
        """fov_pad must not perturb interior predictions (same operator
        on the shared support)."""
        from ska_sdp_tpu.models.dataset import _idg_predict_pipeline
        from ska_sdp_tpu.ops.coords import SPEED_OF_LIGHT

        p, w, _ = _problem(rng, b=100)
        img = np.zeros((N, N), np.float32)
        img[150, 170] = 1.0
        lam = int(round(N / THETA))
        uvw = np.stack(
            [p[:, 0] * lam, p[:, 1] * lam, w], axis=1).astype(np.float32)
        f = np.asarray([SPEED_OF_LIGHT], np.float32)
        out = [np.asarray(_idg_predict_pipeline(
            img, uvw, f, theta=THETA, lam=lam, subgrid=S,
            taper_beta=BETA, fov_pad=fp)) for fp in (None, 0.75)]
        np.testing.assert_allclose(out[1], out[0], atol=5e-4)


class TestIDGNonSquare:
    """H≠W grids through the whole IDG stack: grid/degrid adjointness on
    a rectangular grid."""

    def test_xla_grid_degrid_adjoint_rect(self, rng):
        from ska_sdp_tpu.ops.idg import idg_degrid_wproj

        H, W, b = 192, 320, 250
        p = rng.uniform(-0.42, 0.42, (b, 3)).astype(np.float32)
        w = rng.uniform(-WMAX, WMAX, b).astype(np.float32)
        vis = (rng.standard_normal(b)
               + 1j * rng.standard_normal(b)).astype(np.complex64)
        G = (rng.standard_normal((H, W))
             + 1j * rng.standard_normal((H, W))).astype(np.complex64)
        Av = np.asarray(idg_grid_wproj(
            (H, W), jnp.asarray(p), jnp.asarray(w), jnp.asarray(vis),
            theta=0.05,
        ))
        AtG = np.asarray(idg_degrid_wproj(
            (H, W), jnp.asarray(p), jnp.asarray(w), jnp.asarray(G),
            theta=0.05,
        ))
        lhs = np.vdot(G, Av)
        rhs = np.vdot(AtG, vis)
        assert abs(lhs - rhs) / max(abs(lhs), 1e-30) < 1e-3, (lhs, rhs)


# ---------------------------------------------------------------------------
# IDG-AW: image-domain antenna screens (ops/idg_aw.py)
# ---------------------------------------------------------------------------

SA = 64          # AW subgrids need taper + fit margin beyond the support


def _track_problem(rng, nant=6, ntime=96, nchan=4, wmax=WMAX):
    """Baseline-track data: per-pair smooth uv drift, time-major interleaved
    across baselines with channels inner — the real interferometer layout
    IDG-AW's pair-chunking is designed for."""
    pairs = [(i, j) for i in range(nant) for j in range(i + 1, nant)]
    nbl = len(pairs)
    u0 = rng.uniform(-0.30, 0.30, (nbl, 2))
    du = rng.uniform(-15.0 / N, 15.0 / N, (nbl, 2))
    w0 = rng.uniform(-wmax, wmax, nbl)
    dw = rng.uniform(-20.0, 20.0, nbl)
    fscale = 1.0 + 0.002 * np.arange(nchan)

    rows = []
    for t in range(ntime):
        ft = t / ntime
        for b, (i, j) in enumerate(pairs):
            uv = u0[b] + du[b] * ft
            for c in range(nchan):
                rows.append((uv[0] * fscale[c], uv[1] * fscale[c],
                             w0[b] + dw[b] * ft, i, j))
    arr = np.asarray(rows)
    n = arr.shape[0]
    p = np.zeros((n, 3))
    p[:, :2] = arr[:, :2]
    w = arr[:, 2]
    a1 = arr[:, 3].astype(np.int32)
    a2 = arr[:, 4].astype(np.int32)
    vis = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return p, w, a1, a2, vis, nbl


def _screen_truth_image(p, w, a1, a2, vis, screens_fine):
    """Direct-DFT truth with per-record conj(A1)·conj(A2) fine screens."""
    xf = (np.arange(N) - N // 2) / N
    l = xf * THETA
    L, M = np.meshgrid(l, l, indexing="xy")
    n_lm = 1.0 - np.sqrt(1.0 - L**2 - M**2)
    img = np.zeros((N, N), np.complex128)
    for i in range(p.shape[0]):
        ey = np.exp(2j * np.pi * p[i, 1] * N * xf)
        ex = np.exp(2j * np.pi * p[i, 0] * N * xf)
        scr = np.conj(screens_fine[a1[i]]) * np.conj(screens_fine[a2[i]])
        img += (vis[i] * scr * np.outer(ey, ex)
                * np.exp(-2j * np.pi * w[i] * n_lm))
    return img / (N * N)


def _fine_screens(ak):
    """Per-antenna screens on the FULL N-point fine image grid (the
    independent evaluation of what aw_screens samples at S points)."""
    s = ak.shape[-1]
    j = np.arange(s) - s // 2
    xf = (np.arange(N) - N // 2) / N           # l/theta in [-1/2, 1/2)
    E = np.exp(-2j * np.pi * np.outer(xf, j))
    return np.einsum("qj,ajk,rk->aqr", E, ak, E)


class TestIDGAW:
    def test_delta_screens_are_unit(self):
        from ska_sdp_tpu.ops.idg_aw import aw_screens

        s = 15
        ak = np.zeros((3, s, s), np.complex128)
        ak[:, s // 2, s // 2] = 1.0
        scr = np.asarray(aw_screens(jnp.asarray(ak), SA,
                                    dtype=jnp.complex128))
        np.testing.assert_allclose(scr, np.ones_like(scr), atol=1e-12)

    def test_matches_direct_truth_with_screens(self, rng):
        from ska_sdp_tpu.ops.idg_aw import aw_screens, idg_grid_aw

        p, w, a1, a2, vis, nbl = _track_problem(rng)
        s = 15
        nant = int(max(a1.max(), a2.max())) + 1
        ak = np.zeros((nant, s, s), np.complex128)
        ak[:, s // 2, s // 2] = 1.0
        ak += 0.3 * (rng.standard_normal((nant, s, s))
                     + 1j * rng.standard_normal((nant, s, s)))
        scr = aw_screens(jnp.asarray(ak), SA, dtype=jnp.complex128)
        g, nd = idg_grid_aw(
            (N, N), jnp.asarray(p), jnp.asarray(a1), jnp.asarray(a2),
            jnp.asarray(w), jnp.asarray(vis), scr, theta=THETA,
            subgrid=SA, max_runs=8 * nbl + p.shape[0] // 128 + 64,
        )
        assert int(nd) == 0
        img = _corrected_image(np.asarray(g), S=SA)
        truth = _screen_truth_image(p, w, a1, a2, vis, _fine_screens(ak))
        assert _rel(img, truth) < 3e-4

    def test_matches_bank_aw_scatter(self, rng):
        """Parity vs the reference-semantics spectral-convolution AW path
        on the tapered bank (cf. TestIDGAccuracy's w-only analog).

        A-perturbations are confined to the akerns' central 3x3 taps: the
        reference TRUNCATES aw = (a1 (*) a2) (*) w back to s pixels
        (``convolve2d``, Gridding.hs:795-811), so broad A-tails convolved
        with the 15-tap w-kernel fall outside the window — IDG-AW applies
        the UNtruncated operator (measured: full-stamp 1%-noise akerns
        diverge ~0.4 through truncation alone; central-3x3 noise ~8e-5)."""
        from ska_sdp_tpu.ops.gridding import convgrid_aw
        from ska_sdp_tpu.ops.idg_aw import aw_screens, idg_grid_aw

        p, w, a1, a2, vis, nbl = _track_problem(rng)
        p[:, :2] = np.round(p[:, :2] * (8 * N)) / (8 * N)    # snap lattice
        s = 15
        nant = int(max(a1.max(), a2.max())) + 1
        ak = np.zeros((nant, s, s), np.complex128)
        ak[:, s // 2, s // 2] = 1.0
        c = s // 2
        ak[:, c - 1:c + 2, c - 1:c + 2] += 0.05 * (
            rng.standard_normal((nant, 3, 3))
            + 1j * rng.standard_normal((nant, 3, 3)))
        opts = KernelOptions(qpx=8, npix_ff=256, npix_kern=s)
        centers = np.linspace(-WMAX, WMAX, NW)
        wbin = find_closest(jnp.asarray(centers), jnp.asarray(w))
        w_b = centers[np.asarray(wbin)]

        bank_t = tapered_w_bank(
            THETA, jnp.asarray(centers), opts, BETA, SA,
            dtype=jnp.float64,
        ).astype(jnp.complex128)
        g_ex = convgrid_aw(
            jnp.conj(bank_t), jnp.asarray(ak),
            jnp.zeros((N, N), jnp.complex128), jnp.asarray(p), wbin,
            jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(vis), chunk=256,
        )
        scr = aw_screens(jnp.asarray(ak), SA, dtype=jnp.complex128)
        g_idg, nd = idg_grid_aw(
            (N, N), jnp.asarray(p), jnp.asarray(a1), jnp.asarray(a2),
            jnp.asarray(w_b), jnp.asarray(vis), scr, theta=THETA,
            subgrid=SA, max_runs=8 * nbl + p.shape[0] // 128 + 64,
        )
        assert int(nd) == 0
        assert _rel(_corrected_image(np.asarray(g_idg), S=SA),
                    _corrected_image(np.asarray(g_ex), S=SA)) < 3e-4

    def test_interleaving_invariance(self, rng):
        """Chunking is by pair, not input order: the time-major interleaved
        layout (as generated) and an explicitly pair-major layout produce
        the SAME chunks after the op's stable sort, hence bit-identical
        grids.  (An arbitrary permutation would NOT be bit-identical: it
        reshuffles chunk membership, shifting subgrid origins and hence
        the ~1e-5-class aliasing term — measured, expected.)"""
        from ska_sdp_tpu.ops.idg_aw import aw_screens, idg_grid_aw

        p, w, a1, a2, vis, nbl = _track_problem(rng, nant=4, ntime=48)
        s = 15
        nant = 4
        ak = np.zeros((nant, s, s), np.complex128)
        ak[:, s // 2, s // 2] = 1.0
        ak += 0.1 * rng.standard_normal((nant, s, s))
        scr = aw_screens(jnp.asarray(ak), SA, dtype=jnp.complex128)

        def run(idx):
            g, nd = idg_grid_aw(
                (N, N), jnp.asarray(p[idx]), jnp.asarray(a1[idx]),
                jnp.asarray(a2[idx]), jnp.asarray(w[idx]),
                jnp.asarray(vis[idx]), scr, theta=THETA, subgrid=SA,
                max_runs=8 * nbl + p.shape[0] // 128 + 64,
            )
            return np.asarray(g), int(nd)

        ident = np.arange(p.shape[0])
        pair_major = np.argsort(a1.astype(np.int64) * 64 + a2,
                                kind="stable")
        g0, nd0 = run(ident)
        g1, nd1 = run(pair_major)
        assert nd0 == nd1 == 0
        np.testing.assert_allclose(g1, g0, atol=1e-12 * np.abs(g0).max())

    def test_nonfitting_records_dropped_and_counted(self, rng):
        """One pair with uv scattered across the whole grid: chunks cannot
        cover the spread; drops are COUNTED (the op's honesty contract)."""
        from ska_sdp_tpu.ops.idg_aw import aw_screens, idg_grid_aw

        b = 400
        p = np.zeros((b, 3))
        p[:, :2] = rng.uniform(-0.42, 0.42, (b, 2))
        w = rng.uniform(-WMAX, WMAX, b)
        vis = rng.standard_normal(b) + 1j * rng.standard_normal(b)
        a1 = np.zeros(b, np.int32)
        a2 = np.ones(b, np.int32)
        s = 15
        ak = np.zeros((2, s, s), np.complex128)
        ak[:, s // 2, s // 2] = 1.0
        scr = aw_screens(jnp.asarray(ak), SA, dtype=jnp.complex128)
        g, nd = idg_grid_aw(
            (N, N), jnp.asarray(p), jnp.asarray(a1), jnp.asarray(a2),
            jnp.asarray(w), jnp.asarray(vis), scr, theta=THETA,
            subgrid=SA, max_runs=8,
        )
        assert int(nd) > 0
        assert np.all(np.isfinite(np.asarray(g)))


class TestIDGAWDegrid:
    def test_adjoint_exact(self, rng):
        """<grid_aw(v), G> == <v, degrid_aw(G)> through the IDG-AW pair —
        identical chunking both directions makes the adjoint exact."""
        from ska_sdp_tpu.ops.idg_aw import (aw_screens, idg_degrid_aw,
                                            idg_grid_aw)

        p, w, a1, a2, vis, nbl = _track_problem(rng, nant=5, ntime=48)
        mr = 8 * nbl + p.shape[0] // 128 + 64
        s = 15
        ak = np.zeros((5, s, s), np.complex128)
        ak[:, s // 2, s // 2] = 1.0
        ak += 0.2 * (rng.standard_normal((5, s, s))
                     + 1j * rng.standard_normal((5, s, s)))
        scr = aw_screens(jnp.asarray(ak), SA, dtype=jnp.complex128)
        G = (rng.standard_normal((N, N))
             + 1j * rng.standard_normal((N, N)))
        Av, nd1 = idg_grid_aw(
            (N, N), jnp.asarray(p), jnp.asarray(a1), jnp.asarray(a2),
            jnp.asarray(w), jnp.asarray(vis), scr, theta=THETA, subgrid=SA,
            max_runs=mr,
        )
        AtG, nd2 = idg_degrid_aw(
            (N, N), jnp.asarray(p), jnp.asarray(a1), jnp.asarray(a2),
            jnp.asarray(w), jnp.asarray(G), scr, theta=THETA, subgrid=SA,
            max_runs=mr,
        )
        assert int(nd1) == int(nd2) == 0
        lhs = complex(jnp.vdot(jnp.asarray(G), Av))
        rhs = complex(jnp.vdot(AtG, jnp.asarray(vis)))
        assert abs(lhs - rhs) / max(abs(lhs), 1e-30) < 1e-10

    def test_roundtrip_matches_bank_aw_degrid(self, rng):
        """Predicting from a uv-grid with delta A-screens reduces to plain
        IDG degridding (screens == 1 ⇒ same operator)."""
        from ska_sdp_tpu.ops.idg import idg_degrid_wproj
        from ska_sdp_tpu.ops.idg_aw import aw_screens, idg_degrid_aw

        p, w, a1, a2, vis, nbl = _track_problem(rng, nant=4, ntime=48)
        mr = 8 * nbl + p.shape[0] // 128 + 64
        s = 15
        ak = np.zeros((4, s, s), np.complex128)
        ak[:, s // 2, s // 2] = 1.0
        scr = aw_screens(jnp.asarray(ak), SA, dtype=jnp.complex128)
        G = (rng.standard_normal((N, N))
             + 1j * rng.standard_normal((N, N)))
        got, nd = idg_degrid_aw(
            (N, N), jnp.asarray(p), jnp.asarray(a1), jnp.asarray(a2),
            jnp.asarray(w), jnp.asarray(G), scr, theta=THETA, subgrid=SA,
            max_runs=mr,
        )
        assert int(nd) == 0
        want = idg_degrid_wproj(
            (N, N), jnp.asarray(p), jnp.asarray(w), jnp.asarray(G),
            theta=THETA, subgrid=SA,
        )
        # same operator, different chunk geometry (dynamic origins vs the
        # fixed tiling): agreement is at the METHOD's aliasing level, not
        # bit-exact — both are ~1e-4-accurate vs the true operator
        d = np.linalg.norm(np.asarray(got) - np.asarray(want)) / \
            np.linalg.norm(np.asarray(want))
        assert d < 3e-4, d


class TestIDGAWFovPad:
    def test_fov_pad_with_offcenter_akerns_matches_truth(self, rng):
        """Padded-FOV IDG-AW with NON-delta A-kernels: screens must be
        sampled at the gridding FOV's angular scale (``fov_scale``), not
        the target FOV's — without the ratio the applied antenna pattern
        is angularly dilated by 1/fov_pad."""
        from ska_sdp_tpu.ops.idg import (fov_pad_geometry, kaiser_taper,
                                         taper_fine)
        from ska_sdp_tpu.ops.idg_aw import aw_screens, idg_grid_aw

        p, w, a1, a2, vis, nbl = _track_problem(rng, nant=4, ntime=48)
        mr = 8 * nbl + p.shape[0] // 128 + 64
        s = 15
        ak = np.zeros((4, s, s), np.complex128)
        ak[:, s // 2, s // 2] = 1.0
        c = s // 2
        ak[:, c - 3:c + 4, c - 3:c + 4] += 0.2 * (
            rng.standard_normal((4, 7, 7))
            + 1j * rng.standard_normal((4, 7, 7)))

        lam = N / THETA
        n, n_pad, theta_g, crop_lo = fov_pad_geometry(THETA, lam, 0.75)
        scr = aw_screens(jnp.asarray(ak), SA, dtype=jnp.complex128,
                         fov_scale=n_pad / n)
        g, nd = idg_grid_aw(
            (n_pad, n_pad), jnp.asarray(p), jnp.asarray(a1),
            jnp.asarray(a2), jnp.asarray(w), jnp.asarray(vis), scr,
            theta=theta_g, subgrid=SA, max_runs=mr,
        )
        assert int(nd) == 0
        tf = np.asarray(taper_fine(n_pad, SA, kaiser_taper(SA, BETA)))
        img = np.asarray(ifft_centered(np.asarray(g))).real / np.outer(tf, tf)
        img = img * ((n_pad / n) ** 2)
        img = img[crop_lo:crop_lo + n, crop_lo:crop_lo + n]

        truth = _screen_truth_image(p, w, a1, a2, vis, _fine_screens(ak))
        # full target FOV (that is what fov_pad buys); complex dirty image
        # vs real part of truth
        d = np.linalg.norm(img - truth.real) / np.linalg.norm(truth.real)
        assert d < 2e-3, d

