"""Centered FFT wrappers, padding and extraction.

Analog of the reference's FFT section
(``/root/reference/src/Gridding.hs:682-728, 815-834``): fftshift-sandwiched
2-D transforms plus the ``pad_mid`` / ``extract_mid`` center-crop pair used by
kernel synthesis.  Backed by ``jnp.fft`` (XLA's FFT); unlike the
reference we do NOT need to pad to powers of two for correctness — XLA handles
arbitrary sizes — but `convolve2d` still rounds up to a power of two because
small pow2 FFTs batch beautifully and it keeps parity with reference scaling.

All functions are shape-polymorphic over leading batch dimensions: the 2-D
transform always acts on the last two axes, so `jax.vmap`/batched use is free.
"""

from __future__ import annotations

import jax.numpy as jnp


def ifft_centered(grid):
    """Grid → image: ``fftshift(ifft2(ifftshift(g)))``.

    Reference ``ifft`` (``src/Gridding.hs:828-834``).  jnp.fft.ifft2 applies
    the 1/N² scaling, matching accelerate-fft's ``Inverse`` mode.
    """
    return jnp.fft.fftshift(
        jnp.fft.ifft2(jnp.fft.ifftshift(grid, axes=(-2, -1))), axes=(-2, -1)
    )


def fft_centered(img):
    """Image → grid: ``fftshift(fft2(ifftshift(m)))``.

    Reference ``fftO`` (``src/Gridding.hs:815-816``).
    """
    return jnp.fft.fftshift(
        jnp.fft.fft2(jnp.fft.ifftshift(img, axes=(-2, -1))), axes=(-2, -1)
    )


def pad_mid(ff, n: int):
    """Zero-pad a (…, n0, n0) far-field to (…, n, n), centered.

    Pad widths per side are ``n//2 - n0//2`` (leading) and
    ``(n+1)//2 - (n0+1)//2`` (trailing) exactly as the reference
    (``src/Gridding.hs:682-691``).
    """
    n0 = ff.shape[-1]
    if n == n0:
        return ff
    lo = n // 2 - n0 // 2
    hi = (n + 1) // 2 - (n0 + 1) // 2
    pad = [(0, 0)] * (ff.ndim - 2) + [(lo, hi), (lo, hi)]
    return jnp.pad(ff, pad)


def extract_mid(a, n: int):
    """Extract the centered (…, n, n) section; inverse of :func:`pad_mid`.

    Reference ``extract_mid`` (``src/Gridding.hs:694-707``): start offset is
    ``size//2 - n//2`` on each of the last two axes.
    """
    cx = a.shape[-2] // 2
    cy = a.shape[-1] // 2
    s = n // 2
    return a[..., cx - s : cx - s + n, cy - s : cy - s + n]


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (reference uses 2^ceil(log2 x))."""
    p = 1
    while p < x:
        p *= 2
    return p


def fft_pow2(img):
    """Forward centered FFT with power-of-two zero-padding + center crop.

    Parity with the reference's ``fft`` (``src/Gridding.hs:821-826``), which
    pads to 2^⌈log2 n⌉ before transforming and extracts the original size.
    XLA's FFT handles arbitrary smooth sizes, so :func:`fft_centered`
    is the production path; this variant exists for bit-level parity with
    reference outputs.
    """
    n = img.shape[-1]
    m = next_pow2(n)
    return extract_mid(fft_centered(pad_mid(img, m)), n)


def ifft_pow2(grid):
    """Inverse analog of :func:`fft_pow2` (reference ``ifftO``-with-padding
    composition; the reference's production ``ifft`` does NOT pad —
    ``src/Gridding.hs:828-834`` — and neither does our ``ifft_centered``)."""
    n = grid.shape[-1]
    m = next_pow2(n)
    return extract_mid(ifft_centered(pad_mid(grid, m)), n)
