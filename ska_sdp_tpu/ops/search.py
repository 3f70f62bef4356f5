"""Closest-bin search over sorted bin centers.

Reference ``findClosest`` (``/root/reference/src/Gridding.hs:895-907``): a
device-side binary search returning the index of the closest element of a
sorted vector, with ties broken toward the *larger* index (the reference's
final comparison is strict ``<``).

Design: ``jnp.searchsorted`` (O(log n) vectorised binary search in
XLA) + a neighbour comparison — fully batched over the visibility vector, no
while-loops to trace.
"""

from __future__ import annotations

import jax.numpy as jnp


def find_closest(sorted_vals, x):
    """Index of the closest entry of ``sorted_vals`` for every element of x.

    Ties (exactly equidistant to both neighbours) resolve to the higher index,
    matching the reference's strict-< comparison at Gridding.hs:907.
    """
    n = sorted_vals.shape[0]
    hi = jnp.clip(jnp.searchsorted(sorted_vals, x, side="right"), 1, n - 1)
    lo = hi - 1
    d_lo = jnp.abs(x - sorted_vals[lo])
    d_hi = jnp.abs(x - sorted_vals[hi])
    return jnp.where(d_lo < d_hi, lo, hi).astype(jnp.int32)
