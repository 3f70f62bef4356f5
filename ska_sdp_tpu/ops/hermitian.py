"""Hermitian completion of the uv-grid.

Reference ``make_grid_hermitian`` (``/root/reference/src/Gridding.hs:585-605``):
add to the grid its conjugate mirrored through the zero-frequency point so the
inverse FFT yields a real image.  For even-sized grids the zero point is
off-center, so the mirror is ``g[n-y, n-x]`` with row 0 and column 0 of the
mirror zeroed; for odd sizes it is a plain full reversal.

Implemented with pure ``jnp.roll``/``flip`` data movement — no gathers — which
XLA lowers to plain device-memory copies.
"""

from __future__ import annotations

import jax.numpy as jnp


def make_grid_hermitian(guv):
    """g + conj(mirror(g)) with the reference's even/odd-size conventions."""
    n = guv.shape[-1]
    # Full reversal maps (y, x) <- (n-1-y, n-1-x); the even case needs
    # (n-y, n-x) mod n, i.e. reversal followed by roll of 1 on both axes.
    rev = jnp.flip(guv, axis=(-2, -1))
    if n % 2 == 0:
        mirr = jnp.roll(rev, shift=(1, 1), axis=(-2, -1))
        mirr = mirr.at[..., 0, :].set(0)
        mirr = mirr.at[..., :, 0].set(0)
    else:
        mirr = rev
    return guv + jnp.conj(mirr)
