"""Uniform weighting of visibilities by uv-cell occupancy.

Reference ``doweight`` (``/root/reference/src/Gridding.hs:564-583``): count how
many visibilities land in each grid cell (at qpx=1 resolution) and divide each
visibility by its own cell's count.

Design: instead of materialising the full N×N occupancy grid and a
scatter + gather round-trip, we compute per-visibility counts directly with a
sort-free ``segment``-style trick on the *linearised* cell id — one
``.at[].add`` scatter into a length-N² histogram would also work, but for the
weighting we only ever read back the counts at the occupied cells, so we use
``jnp.unique``-free bincount-on-demand: scatter-add ones into a flat histogram
(XLA scatter, negligible cost vs gridding) then gather at each vis's cell.
"""

from __future__ import annotations

import jax.numpy as jnp

from .coords import frac_coords


def doweight(theta: float, lam: int, uvw, vis):
    """Divide each visibility by the number of visibilities in its uv-cell.

    Args:
      theta: field-of-view size (static float).
      lam: grid resolution in wavelengths (static int).
      uvw: [n, 3] baselines in wavelengths (NOT pre-scaled by lam).
      vis: [n] complex values to reweight (the reference passes ones here).

    Returns:
      [n] complex reweighted visibilities.
    """
    n = int(round(theta * lam))
    p = uvw / lam
    x, _, y, _ = frac_coords((n, n), 1, p)
    # y·n + x overflows int32 for n > 46340; such grids need x64 enabled
    if n * n > jnp.iinfo(jnp.int32).max:
        if not jnp.issubdtype(jnp.result_type(jnp.int64), jnp.int64):
            raise ValueError(
                f"grid {n}² needs int64 cell ids: enable jax_enable_x64"
            )
        idx_t = jnp.int64
    else:
        idx_t = jnp.int32
    flat = (y.astype(idx_t) * n + x.astype(idx_t)).ravel()
    counts = jnp.zeros((n * n,), dtype=uvw.dtype).at[flat].add(1.0)
    per_vis = counts[flat]
    return vis / per_vis.astype(vis.dtype)
