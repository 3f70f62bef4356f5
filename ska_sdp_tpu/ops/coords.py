"""uv→grid coordinate mapping and uvw preprocessing.

Batched re-design of the reference's coordinate machinery
(``/root/reference/src/Gridding.hs:111-151`` ``frac_coord``/``frac_coords``/
``toGridCell``, ``:551-562`` ``mirror_uvw``, ``src/ImageDataset.hs:181-187``
``uvw_lambda``).  Everything is expressed as batched jnp ops over the full
visibility vector — there is no per-visibility control flow anywhere, so the
whole preprocessing stage fuses into a handful of XLA elementwise kernels.

Conventions:
* ``p`` is the uvw baseline scaled into the ±0.5 box (u/lam etc.).
* Grid cells are ``(y, x) = (cell(v), cell(u))`` — the reference gridds
  ``a[y, x] += v`` (``src/Gridding.hs:106-109``) and we keep that layout.
* ``round`` below is round-half-to-even, matching Haskell ``round`` and
  numpy/jnp ``round``.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..types import SPEED_OF_LIGHT


def frac_coord(n, qpx, p):
    """Decompose scaled coordinates into (cell, oversampling-fraction).

    Semantics of ``src/Gridding.hs:126-140``::

        x     = n/2 + p * n
        cell  = floor(x + 0.5/qpx)
        frac  = round((x - cell) * qpx)     -- in [0, qpx-1]

    Computed as k = n/2·qpx + round(p·n·qpx), cell = k // qpx,
    frac = k mod qpx — the same cell and fraction (cell·qpx + frac is x·qpx
    rounded) except at exact .5 ties.  The position comes from ONE
    multiply and integer arithmetic follows: there is no multiply-add a
    compiler could contract into an FMA, so the GPU and the CPU pick the
    same kernel tap for the same p (with ``halfn + p*n`` they disagreed
    for records within an ulp of a tap boundary), and the rounding error
    is that of p·n·qpx alone.

    Args:
      n: grid extent along this axis (static int).
      qpx: oversampling factor (static int).
      p: array of scaled coordinates in ~[-0.5, 0.5].

    Returns:
      (cell, frac) int32 arrays of p's shape.
    """
    k = jnp.round(p * (n * qpx)).astype(jnp.int32) + (n // 2) * qpx
    return k // qpx, k % qpx


def frac_coords(shape_hw, qpx, p_uvw):
    """Apply :func:`frac_coord` to u (width) and v (height).

    Reference ``frac_coords`` (``src/Gridding.hs:142-151``) returns
    ``(x, xf, y, yf)``; we do the same as a 4-tuple of arrays.

    Args:
      shape_hw: (height, width) of the target grid (static ints).
      qpx: oversampling factor.
      p_uvw: [n, 3] scaled baselines.
    """
    h, w = shape_hw
    x, xf = frac_coord(w, qpx, p_uvw[..., 0])
    y, yf = frac_coord(h, qpx, p_uvw[..., 1])
    return x, xf, y, yf


def to_grid_cell(n, f):
    """Nearest-cell mapping of the no-kernel gridder.

    ``toGridCell`` (``src/Gridding.hs:111-112``): ``n/2 + floor(0.5 + n*f)``
    — note round-half-UP here, unlike frac_coord's banker's rounding.
    """
    halfn = n // 2
    return (halfn + jnp.floor(0.5 + n * f)).astype(jnp.int32)


def uvw_lambda(freq, uvw):
    """Scale uvw from metres into wavelengths: ``uvw * f / c``.

    Reference ``uvw_lambda`` (``src/ImageDataset.hs:181-187``).
    """
    scale = jnp.asarray(freq / SPEED_OF_LIGHT, dtype=uvw.dtype)
    return uvw * scale


def mirror_uvw(uvw, vis):
    """Mirror baselines into the v>=0 half-plane.

    Where v < 0: negate the whole uvw triple and conjugate the visibility
    (Hermitian symmetry of the measurement).  Reference ``mirror_uvw``
    (``src/Gridding.hs:551-562``).

    Args:
      uvw: [n, 3]
      vis: [n] complex
    Returns:
      (uvw', vis') with the mirrored rows.
    """
    neg = uvw[:, 1] < 0
    uvw_m = jnp.where(neg[:, None], -uvw, uvw)
    vis_m = jnp.where(neg, jnp.conj(vis), vis)
    return uvw_m, vis_m
