"""Imaging pipelines: uvw → uv-grid → dirty image.

Rebuilds the reference's pipeline layer (L5,
``/root/reference/src/Gridding.hs:84-124, 399-549``):

  ``simple_imaging``   — nearest-cell gridding                    (:84-93)
  ``conv_imaging``     — fixed oversampled kernel                 (:115-124)
  ``w_cache_imaging``  — w-binned kernel bank built on the fly    (:399-449)
  ``aw_imaging``       — AW-projection with per-vis kernel convolution
                         (:452-478, new bulk path) / ``aw_imaging_old``
                         semantics are identical here because our batched
                         gridder already IS the bulk path.
  ``do_imaging``       — weight → mirror → grid → hermitian → ifft → real,
                         PSF, normalization                        (:509-549)

Each imaging function has the reference's ``ImagingFunction`` signature
(θ, lam, uvw, src, vis) → uv-grid, with kernels/options passed via closures —
the functional analog of the reference's ``OtherImagingArgs`` record.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import KernelOptions
from ..ops import (
    convgrid,
    doweight,
    find_closest,
    grid_nearest,
    ifft_centered,
    make_grid_hermitian,
    mirror_uvw,
    w_kernel_bank,
)


def _empty_grid(theta: float, lam: int, dtype):
    n = int(round(theta * lam))
    return jnp.zeros((n, n), dtype=dtype)


def simple_imaging(theta, lam, uvw, src, vis):
    """Nearest-cell imaging (ref ``simple_imaging`` Gridding.hs:84-93)."""
    guv = _empty_grid(theta, lam, vis.dtype)
    return grid_nearest(guv, uvw / lam, vis)


def conv_imaging(kv, theta, lam, uvw, src, vis, chunk: int = 8192):
    """Fixed-kernel imaging (ref ``conv_imaging`` Gridding.hs:115-124)."""
    guv = _empty_grid(theta, lam, vis.dtype)
    return convgrid(kv, guv, uvw / lam, vis, chunk=chunk)


def w_cache_imaging(
    theta,
    lam,
    uvw,
    src,
    vis,
    opts: KernelOptions = KernelOptions(),
    chunk: int = 8192,
    w_range: Optional[tuple] = None,
):
    """w-projection imaging with an on-the-fly w-kernel bank.

    Reference ``w_cache_imaging`` (Gridding.hs:399-449): round w to
    wstep-sized bins, synthesize one conjugated kernel per bin, grid with the
    bank.  The reference hosts a compile-per-bin loop; here the whole bank is
    one batched ``w_kernel_bank`` call.

    The bank shape depends on the w extent, which the reference computes
    with a *host* round-trip (``CPU.run`` at Gridding.hs:430).  Pass
    ``w_range=(minw, maxw)`` (static floats covering the data) to keep the
    whole function jittable/composable as an ``ImagingFunction`` — the bin
    grid is then derived statically and per-vis bins with jnp.  With
    ``w_range=None`` the extent is taken from concrete ``uvw`` on the host
    (un-jittable, the reference's staging).

    Note: with an explicit ``w_range`` that does not cover the data, w
    values outside it are silently clipped into the edge bins (the jnp.clip
    below) — numerically degraded, not an error.  Choose ``w_range`` from
    the dataset's true w extent.
    """
    import numpy as np

    wstep = opts.wstep
    if w_range is not None:
        minw = wstep * np.round(float(w_range[0]) / wstep)
        maxw = wstep * np.round(float(w_range[1]) / wstep)
        steps = int((maxw - minw) // wstep) + 1
        centers = minw + wstep * np.arange(steps, dtype=np.float64)
        w = uvw[:, 2]
        roundedw = jnp.clip(wstep * jnp.round(w / wstep), minw, maxw)
        wbin = ((roundedw - minw) // wstep).astype(jnp.int32)
    else:
        w = np.asarray(uvw[:, 2])
        roundedw = wstep * np.round(w / wstep)
        minw, maxw = roundedw.min(), roundedw.max()
        steps = int((maxw - minw) // wstep) + 1
        centers = minw + wstep * np.arange(steps, dtype=np.float64)
        wbin = (
            (jnp.asarray(roundedw.astype(np.float64)) - minw) // wstep
        ).astype(jnp.int32)

    real_dt = jnp.real(vis).dtype
    bank = w_kernel_bank(theta, centers.astype(real_dt), opts, dtype=real_dt)
    from ..ops import convgrid_wproj

    guv = _empty_grid(theta, lam, vis.dtype)
    return convgrid_wproj(bank, guv, uvw / lam, wbin, vis, chunk=chunk)


def wproj_imaging_from_bank(
    bank, wbin_centers, theta, lam, uvw, src, vis, chunk: int = 8192
):
    """w-projection with a preloaded (conjugated) kernel bank + bin centers.

    The per-visibility bin is the closest center in w (reference
    ``findClosest`` use at Gridding.hs:474).
    """
    from ..ops import convgrid_wproj

    wbin = find_closest(wbin_centers, uvw[:, 2])
    guv = _empty_grid(theta, lam, vis.dtype)
    return convgrid_wproj(bank, guv, uvw / lam, wbin, vis, chunk=chunk)


def aw_imaging(
    theta,
    lam,
    wkernels,
    wbin_centers,
    akernels,
    uvw,
    src,
    vis,
    chunk: int = 8192,
):
    """AW-projection imaging (ref ``aw_imaging`` Gridding.hs:452-478).

    Args:
      wkernels: [nw, qpx, qpx, s, s] UNconjugated w-kernel bank (dataset
        layout; the gridder conjugates the combined AW kernel).
      wbin_centers: [nw] w values of the bank planes (wavelengths).
      akernels: [nant, s, s] A-kernels.
      src: (a1, a2, time, freq) per-visibility arrays; a1/a2 used as
        A-kernel indices exactly like the reference (Gridding.hs:474-476).
    """
    a1, a2 = src[0].astype(jnp.int32), src[1].astype(jnp.int32)
    guv = _empty_grid(theta, lam, vis.dtype)
    wbin = find_closest(wbin_centers, uvw[:, 2])
    from ..ops import convgrid_aw

    return convgrid_aw(
        wkernels, akernels, guv, uvw / lam, wbin, a1, a2, vis, chunk=chunk,
    )


# `-old` path parity: the reference's convgrid3 differs from convgrid4 only
# in scheduling (n small scatters vs one bulk scatter); numerically they are
# identical, so both map to the same batched gridder here.
aw_imaging_old = aw_imaging


class ImagingResult(NamedTuple):
    image: jax.Array      # normalized dirty image [n, n] real
    psf: jax.Array        # normalized point-spread function [n, n] real
    pmax: jax.Array       # PSF peak used for normalization (scalar)


def do_imaging(theta, lam, uvw, a1, a2, t, f, vis, imgfn) -> ImagingResult:
    """Full imaging driver (ref ``do_imaging`` Gridding.hs:509-549).

    mirror → uniform weight → image grid & PSF grid via ``imgfn`` →
    hermitian completion → centered ifft → real part → normalize both by the
    PSF peak.
    """
    n = vis.shape[0]
    src = (a1, a2, t, jnp.full((n,), f, dtype=uvw.dtype))
    uvw1, vis1 = mirror_uvw(uvw, vis)
    ones = jnp.ones((n,), dtype=vis.dtype)
    wt = doweight(theta, lam, uvw1, ones)

    cdrt = imgfn(theta, lam, uvw1, src, wt * vis1)
    drt = jnp.real(ifft_centered(make_grid_hermitian(cdrt)))
    cpsf = imgfn(theta, lam, uvw1, src, wt)
    psf = jnp.real(ifft_centered(make_grid_hermitian(cpsf)))

    pmax = jnp.max(psf)
    return ImagingResult(image=drt / pmax, psf=psf / pmax, pmax=pmax)
