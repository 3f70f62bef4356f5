"""w-kernel synthesis: phase screen → oversampled gridding kernel.

Batched rebuild of the reference's kernel-generation section
(``/root/reference/src/Gridding.hs:610-728``):

  ``w_kernel``       — compose the stages below                 (:610-619)
  ``kernel_coordinates`` / ``coordinates2`` — image-plane l/m   (:621-648)
  ``w_kernel_function`` — phase screen e^{2πi·w·(1-√(1-r²))}    (:651-667)
  ``kernel_oversample`` — pad → centered ifft → strided extract  (:669-680)
  ``extract_oversampled`` — qpx×qpx oversampled taps, ×qpx²      (:709-728)

Everything is batched over a *vector of w values* by construction (leading
axis), so building an entire w-kernel bank is one fused XLA program — the
reference instead compiled and ran one sub-program per w-plane on the host
(``src/Gridding.hs:434-448``).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import KernelOptions
from .fourier import ifft_centered, pad_mid


def kernel_coordinates(n: int, theta: float, opts: KernelOptions, dtype=jnp.float64):
    """Image-plane (l, m) coordinate grids of size n×n, scaled by theta.

    ``l`` varies along the last (x) axis, ``m`` along the first (y) axis,
    matching ``coordinates2``'s replicate orientation
    (``src/Gridding.hs:637-648``).  Optional pattern shift/transform applied
    as in ``kernel_coordinates`` (:621-635).
    """
    base = (jnp.arange(n, dtype=dtype) - n // 2) / n
    l = jnp.broadcast_to(base[None, :], (n, n)) * theta
    m = jnp.broadcast_to(base[:, None], (n, n)) * theta
    if opts.pat_trans_mat is not None:
        t = jnp.asarray(opts.pat_trans_mat, dtype=dtype).reshape(2, 2)
        l, m = t[0, 0] * l + t[1, 0] * m, t[0, 1] * l + t[1, 1] * m
    if opts.pat_hor_shift or opts.pat_ver_shift:
        l = l + opts.pat_hor_shift
        m = m + opts.pat_ver_shift
    return l, m


def w_kernel_function(l, m, w):
    """Far-field phase screen: exp(2πi · w · (1 - sqrt(1 - l² - m²))).

    Reference ``w_kernel_function`` (``src/Gridding.hs:651-667``).
    ``w`` may be scalar or a leading-batch vector ([nw] → [nw, n, n]).
    """
    r2 = l * l + m * m
    ph = 1.0 - jnp.sqrt(1.0 - r2)
    w = jnp.asarray(w, dtype=l.dtype)
    wph = jnp.multiply.outer(w, ph) if w.ndim else w * ph
    return jnp.exp(1j * (2.0 * jnp.pi) * wph).astype(
        jnp.complex64 if l.dtype == jnp.float32 else jnp.complex128
    )


def extract_oversampled(a, qpx: int, n: int):
    """Extract the qpx×qpx oversampled taps from an oversampled uv-plane.

    Output[yf, xf, y, x] = a[cons - yf + qpx·y, cons - xf + qpx·x] · qpx²
    with cons = na/2 - qpx·(n/2)  (``src/Gridding.hs:709-728``).
    Works on a leading-batched ``a`` ([..., na, na] → [..., qpx, qpx, n, n]).
    """
    na = a.shape[-1]
    cons = na // 2 - qpx * (n // 2)
    yf = jnp.arange(qpx)
    y = jnp.arange(n)
    rows = cons - yf[:, None] + qpx * y[None, :]      # [qpx, n]
    # Gather rows then columns; indices are the same for both axes.
    out = a[..., rows, :][..., :, :, rows]            # [..., qpx, n, qpx, n]
    out = jnp.moveaxis(out, -2, -3)                   # [..., qpx, qpx, n, n]
    return out * (qpx * qpx)


def w_kernel(theta: float, w, opts: KernelOptions, dtype=jnp.float64):
    """Oversampled w-kernel(s) of shape [qpx, qpx, s, s] (batched over w).

    Composition of the reference's ``w_kernel`` (``src/Gridding.hs:610-619``)
    and ``kernel_oversample`` (:669-680): phase screen on an npix_ff far
    field, zero-pad to npix_ff·qpx, centered ifft, strided extraction.

    Args:
      theta: field of view.
      w: scalar or [nw] vector of w-plane distances (wavelengths).
      opts: kernel options (qpx, npix_ff, npix_kern used).
    Returns:
      [qpx, qpx, s, s] (scalar w) or [nw, qpx, qpx, s, s] complex.
    """
    l, m = kernel_coordinates(opts.npix_ff, theta, opts, dtype=dtype)
    ff = w_kernel_function(l, m, w)
    padff = pad_mid(ff, opts.npix_ff * opts.qpx)
    af = ifft_centered(padff)
    return extract_oversampled(af, opts.qpx, opts.npix_kern)


def w_kernel_bank(theta: float, w_centers, opts: KernelOptions, dtype=jnp.float64):
    """Conjugated w-kernel bank [nw, qpx, qpx, s, s] for cache-based gridding.

    The reference conjugates each plane at bank-build time
    (``src/Gridding.hs:441``); we do the same so the gridder applies the bank
    directly.
    """
    return jnp.conj(w_kernel(theta, jnp.asarray(w_centers), opts, dtype=dtype))
