"""Slow-but-obviously-correct numpy float64 reference implementations.

Plays the role the Accelerate *interpreter backend* plays in the reference's
test strategy (SURVEY §4: ``I.run`` is the oracle against which the compiled
backends are compared; see also the miscompile repro preserved in
``/root/reference/old/BrokenNumbers.hs``).  Everything here is written with
explicit Python loops / numpy in float64 — no JAX — so that the JAX paths can
be diffed against genuinely independent code.
"""

from __future__ import annotations

import numpy as np


def frac_coord(n: int, qpx: int, p):
    x = n // 2 + np.asarray(p, dtype=np.float64) * n
    cell = np.floor(x + 0.5 / qpx)
    # np.round is round-half-to-even, matching Haskell `round`.
    frac = np.round((x - cell) * qpx)
    return cell.astype(np.int64), frac.astype(np.int64)


def frac_coords(shape_hw, qpx: int, p_uvw):
    h, w = shape_hw
    x, xf = frac_coord(w, qpx, p_uvw[:, 0])
    y, yf = frac_coord(h, qpx, p_uvw[:, 1])
    return x, xf, y, yf


def grid_nearest(guv, p, vis):
    guv = guv.copy()
    n = guv.shape[0]
    for k in range(len(vis)):
        y = n // 2 + int(np.floor(0.5 + n * p[k, 1]))
        x = n // 2 + int(np.floor(0.5 + n * p[k, 0]))
        if 0 <= y < n and 0 <= x < n:
            guv[y, x] += vis[k]
    return guv


def _scatter_patch(guv, y0: int, x0: int, patch):
    """Add one patch at top-left (y0, x0), dropping OOB elements."""
    H, W = guv.shape
    gh, gw = patch.shape
    for i in range(gh):
        for j in range(gw):
            y, x = y0 + i, x0 + j
            if 0 <= y < H and 0 <= x < W:
                guv[y, x] += patch[i, j]


def convgrid(gcf, guv, p, vis):
    """Single-kernel gridder; gcf [qpx,qpx,gh,gw] (ref convgrid)."""
    guv = guv.copy()
    qpx, _, gh, gw = gcf.shape
    x, xf, y, yf = frac_coords(guv.shape, qpx, p)
    for k in range(len(vis)):
        patch = vis[k] * gcf[yf[k], xf[k]]
        _scatter_patch(guv, int(y[k]) - gh // 2, int(x[k]) - gw // 2, patch)
    return guv


def convgrid_wproj(gcf_bank, guv, p, wbin, vis):
    """w-kernel-bank gridder; bank [nw,qpx,qpx,gh,gw] (ref convgrid2)."""
    guv = guv.copy()
    nw, qpx, _, gh, gw = gcf_bank.shape
    x, xf, y, yf = frac_coords(guv.shape, qpx, p)
    for k in range(len(vis)):
        patch = vis[k] * gcf_bank[wbin[k], yf[k], xf[k]]
        _scatter_patch(guv, int(y[k]) - gh // 2, int(x[k]) - gw // 2, patch)
    return guv


def pad_mid(ff, n: int):
    n0 = ff.shape[-1]
    if n == n0:
        return ff
    lo = n // 2 - n0 // 2
    hi = (n + 1) // 2 - (n0 + 1) // 2
    pad = [(0, 0)] * (ff.ndim - 2) + [(lo, hi), (lo, hi)]
    return np.pad(ff, pad)


def extract_mid(a, n: int):
    cx = a.shape[-2] // 2
    cy = a.shape[-1] // 2
    s = n // 2
    return a[..., cx - s : cx - s + n, cy - s : cy - s + n]


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def convolve2d(a1, a2):
    """Centered truncated linear convolution (ref convolve2d semantics)."""
    n = a1.shape[-1]
    m = _next_pow2(2 * n - 1)
    f1 = np.fft.ifft2(np.fft.ifftshift(pad_mid(a1, m), axes=(-2, -1)))
    f2 = np.fft.ifft2(np.fft.ifftshift(pad_mid(a2, m), axes=(-2, -1)))
    conv = np.fft.fftshift(np.fft.fft2(f1 * f2), axes=(-2, -1))
    return extract_mid(conv, n) * (m * m)


def convolve2d_direct(a1, a2):
    """O(n⁴) direct centered linear convolution — oracle for convolve2d.

    full[k, l] = Σ a1[i, j]·a2[k-i, l-j]; the centered same-size section
    starts at index (n-1) - (m/2 - n/2) ... derived from pad/extract algebra:
    extract_mid of the full (2n-1)² linear convolution embedded at center.
    """
    n = a1.shape[-1]
    full = np.zeros((2 * n - 1, 2 * n - 1), dtype=np.complex128)
    for i in range(n):
        for j in range(n):
            full[i : i + n, j : j + n] += a1[i, j] * a2
    # The FFT pipeline (pad_mid → ifftshift → spectral product → fftshift →
    # extract_mid) equals the window full[n//2 : n//2 + n] of the full
    # (2n-1)-sized linear convolution (derivation: the centered embedding
    # places support at c - n//2 + i, the two half-shifts cancel, and
    # extract_mid reads offsets r with full index l = r + n//2).
    start = n // 2
    return full[start : start + n, start : start + n]


def make_grid_hermitian(guv):
    n = guv.shape[0]
    out = guv.copy()
    for y in range(n):
        for x in range(n):
            if n % 2 == 0:
                if x == 0 or y == 0:
                    continue
                out[y, x] += np.conj(guv[n - y, n - x])
            else:
                out[y, x] += np.conj(guv[n - 1 - y, n - 1 - x])
    return out


def ifft_centered(grid):
    return np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(grid)))


def fft_centered(img):
    return np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(img)))


def doweight(theta: float, lam: int, uvw, vis):
    n = int(round(theta * lam))
    p = np.asarray(uvw, dtype=np.float64) / lam
    x, _, y, _ = frac_coords((n, n), 1, p)
    counts = {}
    for k in range(len(vis)):
        counts[(int(y[k]), int(x[k]))] = counts.get((int(y[k]), int(x[k])), 0) + 1
    out = np.array(
        [vis[k] / counts[(int(y[k]), int(x[k]))] for k in range(len(vis))],
        dtype=np.complex128,
    )
    return out


def mirror_uvw(uvw, vis):
    uvw = np.asarray(uvw, dtype=np.float64).copy()
    vis = np.asarray(vis, dtype=np.complex128).copy()
    for k in range(len(vis)):
        if uvw[k, 1] < 0:
            uvw[k] = -uvw[k]
            vis[k] = np.conj(vis[k])
    return uvw, vis


def w_kernel(theta: float, w: float, qpx: int, npix_ff: int, npix_kern: int):
    """Oversampled w-kernel [qpx,qpx,s,s] (ref w_kernel/kernel_oversample)."""
    n = npix_ff
    base = (np.arange(n, dtype=np.float64) - n // 2) / n
    l = np.broadcast_to(base[None, :], (n, n)) * theta
    m = np.broadcast_to(base[:, None], (n, n)) * theta
    r2 = l * l + m * m
    ph = 1.0 - np.sqrt(1.0 - r2)
    ff = np.exp(2j * np.pi * w * ph)
    padff = pad_mid(ff, n * qpx)
    af = ifft_centered(padff)
    na = af.shape[-1]
    cons = na // 2 - qpx * (npix_kern // 2)
    out = np.zeros((qpx, qpx, npix_kern, npix_kern), dtype=np.complex128)
    for yf in range(qpx):
        for xf in range(qpx):
            for y in range(npix_kern):
                for x in range(npix_kern):
                    out[yf, xf, y, x] = af[cons - yf + qpx * y, cons - xf + qpx * x]
    return out * (qpx * qpx)


def find_closest(sorted_vals, x):
    sorted_vals = np.asarray(sorted_vals)
    out = np.empty(len(x), dtype=np.int64)
    for k, w in enumerate(np.asarray(x)):
        d = np.abs(sorted_vals - w)
        # ties toward the larger index, like the reference's strict <
        best = 0
        for i in range(1, len(sorted_vals)):
            if d[i] <= d[best]:
                best = i
        out[k] = best
    return out
