"""Distributed centered 2-D FFT over a device mesh.

The reference's FFTs are single-device (accelerate-fft wrappers —
``/root/reference/src/Gridding.hs:815-834``).  For grids that outgrow one
device (SURVEY §5: grid size n = θ·λ), this module implements a
pencil-decomposition transform under ``shard_map``:

* the grid is **row-sharded** over a 1-D mesh axis;
* the fftshift/ifftshift sandwiches of the centered transform are folded
  into local ``(−1)^index`` masks via the shift theorem — **zero
  communication** (for even n: ``shift∘F∘ishift = (−1)^{k+n/2} · F[(−1)^j ·]``);
* each axis transform runs as a full-length local FFT, with ONE
  ``lax.all_to_all`` transpose between the two passes and one to restore
  row sharding — the collectives ride the ICI.

``fft2_centered_sharded`` is the inside-shard_map building block;
``make_sharded_ifft2`` wraps it into a jitted global-array function.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from .mesh import VIS_AXIS


def _sign_mask(n_rows, n_cols, row_offset):
    """(−1)^{global_row + col} mask for an [n_rows, n_cols] local block."""
    gy = row_offset + jnp.arange(n_rows)
    gx = jnp.arange(n_cols)
    return jnp.where((gy[:, None] + gx[None, :]) % 2 == 0, 1.0, -1.0)


def fft2_centered_sharded(x, axis_name: str = VIS_AXIS, inverse: bool = False):
    """Centered 2-D (i)FFT of a row-sharded grid; call inside shard_map.

    Args:
      x: local row block [H/P, W] complex of a global [H, W] array with
        H, W even and H divisible by P² (the all_to_all re-splits rows).
    Returns:
      The local row block of shift∘(i)fft2∘ishift of the global array.
    """
    P_ = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    hl, W = x.shape
    H = hl * P_
    fft = jnp.fft.ifft if inverse else jnp.fft.fft

    # ishift on both axes → (−1)^{j} pre-mask (shift theorem, even sizes)
    x = x * _sign_mask(hl, W, idx * hl).astype(x.dtype)

    # pass 1: full-width transform along the unsharded axis
    x = fft(x, axis=1)

    # transpose: [H/P, W] → [H, W/P] (split cols, concat rows by device id)
    x = jax.lax.all_to_all(x, axis_name, split_axis=1, concat_axis=0,
                           tiled=True)

    # pass 2: full-height transform
    x = fft(x, axis=0)

    # transpose back: [H, W/P] → [H/P, W]
    x = jax.lax.all_to_all(x, axis_name, split_axis=0, concat_axis=1,
                           tiled=True)

    # shift on both axes → (−1)^{k} post-mask and the constant
    # (−1)^{H/2 + W/2} from the two axis shifts
    sign = 1.0 if (H // 2 + W // 2) % 2 == 0 else -1.0
    post = _sign_mask(hl, W, idx * hl).astype(x.dtype) * sign
    return x * post


def make_sharded_ifft2(mesh: Mesh, axis_name: str = VIS_AXIS):
    """Jitted global-array centered inverse FFT, row-sharded over the mesh.

    The returned function takes/returns a global [H, W] array sharded
    P(axis_name) on rows (any H divisible by P², W even).
    """
    fn = shard_map(
        partial(fft2_centered_sharded, axis_name=axis_name, inverse=True),
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=P(axis_name),
    )
    return jax.jit(fn)
