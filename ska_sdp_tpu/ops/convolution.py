"""FFT-based 2-D convolution and AW-kernel combination.

Reference semantics (``/root/reference/src/Gridding.hs:761-811``):

  ``convolve2d a b``   — centered linear convolution: pad both kernels to the
                         power-of-two m >= 2n-1, centered-ifft each, multiply
                         spectra, centered-fft back, extract the middle n,
                         scale by m².
  ``aw_kernel_fn2``    — aw = convolve2d(convolve2d(a1, a2), wkern[yf, xf]).

Batched redesign: the reference computes this *per visibility inside a
sequential device loop* (``src/Gridding.hs:348-356``) — two fresh FFT
convolutions per visibility.  Here every stage is batched:

* spectra of all A-kernels are precomputed once per dataset
  (:func:`akernel_spectra`),
* spectra of all w-kernel taps are precomputed once per bank
  (:func:`wkernel_tap_spectra`),
* per-visibility work is a gather + pointwise spectral product + one small
  inverse/forward FFT pair, batched over the whole visibility vector with
  ``vmap``-free leading-axis broadcasting.

The truncation to n pixels *between* the two convolutions is part of the
reference semantics (it is not equivalent to one triple spectral product), so
we keep both stages.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from .fourier import extract_mid, next_pow2, pad_mid

# For the small centered transforms of the AW path (m ≤ 128) we
# materialize the composite linear maps (pad∘shift∘DFT and
# DFT∘shift∘extract) as dense (m, s)/(n, m) matrices and evaluate them as
# F · X · Fᵀ batched matmuls instead of batches of tiny FFTs.  Exact — same
# operator, different factorization.
_MM_MAX = 128   # use the matmul path for transforms up to this size


@lru_cache(maxsize=None)
def _analysis_mat(s: int, m: int):
    """A (m, s) with _spec(x, m) == A @ x @ A.T for (s, s) inputs."""
    j = np.arange(s)
    p = (j - s // 2) % m                 # pad_mid ∘ ifftshift placement
    k = np.arange(m)[:, None]
    return np.exp(2j * np.pi * k * p[None, :] / m) / m   # complex128


@lru_cache(maxsize=None)
def _synthesis_mat(n: int, m: int):
    """S (n, m) with _synth(X, n, m) == S @ X @ S.T for (m, m) spectra."""
    i = np.arange(n)
    rows = (i - n // 2) % m              # fftshift ∘ extract_mid selection
    l = np.arange(m)[None, :]
    # the reference's ×m² synthesis scale, split m per axis
    return np.exp(-2j * np.pi * rows[:, None] * l / m) * m   # complex128


def _sandwich(M, x):
    """M @ x @ M.T batched over leading axes of x (two matmuls)."""
    M = jnp.asarray(M, dtype=jnp.result_type(x, jnp.complex64))
    hp = __import__("jax").lax.Precision.HIGHEST
    t = jnp.einsum("ms,...st->...mt", M, x, precision=hp)
    return jnp.einsum("...mt,nt->...mn", t, M, precision=hp)


def _spec(a, m: int):
    """Centered analysis transform used by the reference: ifft∘ishift∘pad."""
    s = a.shape[-1]
    if m <= _MM_MAX:
        return _sandwich(jnp.asarray(_analysis_mat(s, m)), a)
    return jnp.fft.ifft2(jnp.fft.ifftshift(pad_mid(a, m), axes=(-2, -1)))


def _synth(spec, n: int, m: int):
    """Centered synthesis: shift∘fft, extract middle n, ×m²."""
    if m <= _MM_MAX:
        return _sandwich(jnp.asarray(_synthesis_mat(n, m)), spec)
    conv = jnp.fft.fftshift(jnp.fft.fft2(spec), axes=(-2, -1))
    return extract_mid(conv, n) * (m * m)


def convolve2d(a1, a2):
    """Centered linear convolution of two equal-size square kernels.

    Batched over leading axes of either argument (shapes must broadcast).
    Matches reference ``convolve2d`` (``src/Gridding.hs:795-811``) exactly,
    including the power-of-two padding and m² scaling.
    """
    n = a1.shape[-1]
    m = next_pow2(2 * n - 1)
    return _synth(_spec(a1, m) * _spec(a2, m), n, m)


def convolve2d_cheap(a1, a2):
    """Cheaper *circular* convolution variant: pads only to 2^⌈log2 n⌉.

    Parity with reference ``convolve2dO`` (``src/Gridding.hs:779-792``),
    used when kernels are known not to overflow the borders — wraparound
    aliasing is accepted in exchange for a smaller transform.
    """
    n = a1.shape[-1]
    m = next_pow2(n)
    return _synth(_spec(a1, m) * _spec(a2, m), n, m)


def aw_kernel(a1_kern, a2_kern, w_tap):
    """AW kernel for one (or a batch of) visibilities.

    aw = convolve2d(convolve2d(a1, a2), w_tap) — reference ``aw_kernel_fn2``
    (``src/Gridding.hs:761-775``).  All inputs [..., s, s].
    """
    return convolve2d(convolve2d(a1_kern, a2_kern), w_tap)


# ---------------------------------------------------------------------------
# Batched AW-kernel construction with precomputed spectra
# ---------------------------------------------------------------------------

def akernel_spectra(akerns):
    """Precompute analysis spectra of every A-kernel: [nant, m, m].

    m is the power-of-two pad for an s×s→s convolution (2s-1 rounded up).
    """
    s = akerns.shape[-1]
    m = next_pow2(2 * s - 1)
    return _spec(akerns, m)


def wkernel_tap_spectra(wkerns):
    """Precompute analysis spectra of every oversampled w-kernel tap.

    wkerns: [nw, qpx, qpx, s, s] → [nw, qpx, qpx, m, m].
    """
    s = wkerns.shape[-1]
    m = next_pow2(2 * s - 1)
    return _spec(wkerns, m)


def make_aw_kernels_batched(s: int):
    """Return a jit-friendly batched builder of conjugated AW kernels.

    The builder maps per-visibility indices to
    ``conj(convolve2d(convolve2d(a1, a2), w[wbin, yf, xf]))`` — the
    conjugation folded in exactly where the reference does it inside its
    gridder (``src/Gridding.hs:294,392``).  The truncation to s pixels
    *between* the two convolutions is reproduced (it is part of the
    semantics, not an optimisation artefact).

    Args of the returned function:
      a_spec: [nant, m, m] precomputed A-kernel spectra.
      w_spec: [nw, qpx, qpx, m, m] precomputed w-tap spectra.
      a1_idx, a2_idx, wbin, yf, xf: [b] int32 per-visibility indices.
    Returns:
      [b, s, s] complex AW kernels.

    Cost per visibility: one m×m FFT synth + one analysis + one synth
    (m = 32 for the SKA 15-pixel kernels), batched over the whole vector —
    versus the reference's two full convolutions inside a *sequential*
    device loop per visibility.
    """
    m = next_pow2(2 * s - 1)

    def build(a_spec, w_spec, a1_idx, a2_idx, wbin, yf, xf):
        prod1 = a_spec[a1_idx] * a_spec[a2_idx]              # [b, m, m]
        if m <= _MM_MAX:
            # synth(·, s) ∘ spec(·) is one dense (m, m) sandwich:
            # T = A_{m×s} @ S_{s×m} — rank s, the truncation is inside.
            T = jnp.asarray(
                _analysis_mat(s, m) @ _synthesis_mat(s, m)
            )
            aspec2 = _sandwich(T, prod1)                     # [b, m, m]
        else:
            akern = _synth(prod1, s, m)                      # [b, s, s]
            aspec2 = _spec(akern, m)                         # [b, m, m]
        wtap = w_spec[wbin, yf, xf]                          # [b, m, m]
        aw = _synth(aspec2 * wtap, s, m)                     # [b, s, s]
        return jnp.conj(aw)

    return build
