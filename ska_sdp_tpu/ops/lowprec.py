"""Experimental reduced-precision numerics for gridding.

Counterpart of the reference's disconnected Posit16 experiment
(``/root/reference/src/POSIT.hs`` — SURVEY §2 C14: bit-level Posit16↔IEEE
conversions written as device expressions, exploring reduced precision for
gridding; not wired into any pipeline).

This module provides:

* a vectorized **posit(16,1)** codec written entirely in jnp int32 bit ops
  (so it runs on any backend under jit) — :func:`p16_to_f32` / :func:`f32_to_p16`
  with the standard zero/NaR conventions, two's-complement negatives,
  regime/exponent/fraction decoding and round-to-nearest-even encoding that
  never rounds a nonzero value to zero or NaR;
* the accelerator low formats — **bfloat16** and (where the jax build has
  them) **float8** — applied to complex visibility/kernel data;
* :func:`gridding_quantization_error`, a small study harness measuring the
  dirty-grid RMS error introduced by each format, the question the
  reference's experiment was after.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_NAR = 0x8000
_MASK15 = 0x7FFF
_MASK16 = 0xFFFF


def p16_to_f32(p):
    """Decode posit(16,1) bit patterns (int32 holding uint16) to float32.

    Zero → 0.0, NaR (0x8000) → NaN; otherwise
    value = (-1)^s · 2^(2k+e) · (1 + f/2^nf).
    """
    p = jnp.asarray(p, jnp.int32) & _MASK16
    is_zero = p == 0
    is_nar = p == _NAR
    sign = (p >> 15) & 1
    mag = jnp.where(sign == 1, (0x10000 - p) & _MASK16, p)
    bits = mag & _MASK15

    r0 = (bits >> 14) & 1
    run_of = jnp.where(r0 == 1, bits, (~bits) & _MASK15)
    # length of the leading identical-bit run in the 15-bit field
    z = (~run_of) & _MASK15
    hb = 31 - jax.lax.clz(z)                     # highest zero position
    hb = jnp.where(z == 0, -1, hb)               # run reaches the end
    m = 14 - hb
    k = jnp.where(r0 == 1, m - 1, -m)

    rem = jnp.maximum(hb, 0)                     # bits below the terminator
    e = jnp.where(rem >= 1, (bits >> jnp.maximum(rem - 1, 0)) & 1, 0)
    nf = jnp.maximum(rem - 1, 0)
    frac = bits & ((1 << nf) - 1)

    # exact powers of two via ldexp (jnp.exp2 is a transcendental approx)
    val = 1.0 + jnp.ldexp(frac.astype(jnp.float32), -nf)
    val = jnp.ldexp(val, 2 * k + e).astype(jnp.float32)
    val = jnp.where(sign == 1, -val, val)
    val = jnp.where(is_zero, 0.0, val)
    return jnp.where(is_nar, jnp.nan, val).astype(jnp.float32)


def f32_to_p16(f):
    """Encode float32 to posit(16,1) with round-to-nearest-even.

    Nonzero values never round to zero (clamp to ±minpos) nor to NaR
    (clamp to ±maxpos); NaN/Inf → NaR.
    """
    f = jnp.asarray(f, jnp.float32)
    is_zero = f == 0.0
    is_nar = jnp.isnan(f) | jnp.isinf(f)
    sign = f < 0

    fb = jax.lax.bitcast_convert_type(jnp.abs(f), jnp.int32)
    biased = (fb >> 23) & 0xFF
    mant = fb & 0x7FFFFF
    E = jnp.where(biased == 0, -127, biased - 127)  # subnormals clamp anyway

    k = E >> 1            # floor division (arithmetic shift)
    e = E - 2 * k         # in {0, 1}

    clamp_max = k >= 14
    clamp_min = k <= -15
    ksafe = jnp.clip(k, -14, 13)

    regime_len = jnp.where(ksafe >= 0, ksafe + 2, 1 - ksafe)
    pattern = jnp.where(ksafe >= 0, ((1 << (ksafe + 1)) - 1) << 1, 1)
    bits_after = 15 - regime_len                 # in [0, 13]
    ef = (e << 23) | mant                        # 24 payload bits
    shift = 24 - bits_after                      # in [11, 24]

    q = (pattern << bits_after) | (ef >> shift)
    r = ef & ((1 << shift) - 1)
    half = 1 << (shift - 1)
    round_up = (r > half) | ((r == half) & ((q & 1) == 1))
    q = q + round_up.astype(jnp.int32)
    # carry through the regime is automatically a valid neighbouring posit;
    # clamp the two poles, never produce 0 or 0x8000 for nonzero input
    q = jnp.clip(q, 1, _MASK15)
    q = jnp.where(clamp_max, _MASK15, q)
    q = jnp.where(clamp_min, 1, q)

    p = jnp.where(sign, (0x10000 - q) & _MASK16, q)
    p = jnp.where(is_zero, 0, p)
    return jnp.where(is_nar, _NAR, p).astype(jnp.int32)


def quantize_posit16(x):
    """Round real/complex data through posit(16,1) and back to float32."""
    if jnp.issubdtype(jnp.asarray(x).dtype, jnp.complexfloating):
        return jax.lax.complex(
            p16_to_f32(f32_to_p16(jnp.real(x))),
            p16_to_f32(f32_to_p16(jnp.imag(x))),
        )
    return p16_to_f32(f32_to_p16(x))


def quantize_bf16(x):
    """Round real/complex data through bfloat16 (the tensor-core low format)."""
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        return jax.lax.complex(
            jnp.real(x).astype(jnp.bfloat16).astype(jnp.float32),
            jnp.imag(x).astype(jnp.bfloat16).astype(jnp.float32),
        )
    return x.astype(jnp.bfloat16).astype(x.dtype)


def quantize_f8(x, kind: str = "e4m3"):
    """Round through float8 (e4m3/e5m2) where the jax build supports it."""
    dt = {"e4m3": jnp.float8_e4m3fn, "e5m2": jnp.float8_e5m2}[kind]
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        return jax.lax.complex(
            jnp.real(x).astype(dt).astype(jnp.float32),
            jnp.imag(x).astype(dt).astype(jnp.float32),
        )
    return x.astype(dt).astype(x.dtype)


QUANTIZERS = {
    "posit16": quantize_posit16,
    "bf16": quantize_bf16,
    "f8_e4m3": lambda x: quantize_f8(x, "e4m3"),
    "f8_e5m2": lambda x: quantize_f8(x, "e5m2"),
}


def gridding_quantization_error(bank, p, wbin, vis, grid_shape, formats=None):
    """RMS dirty-grid error from quantizing visibilities + kernels.

    Runs the w-projection gridder with each reduced format applied to the
    inputs and reports relative RMS error vs the float32/complex64 grid —
    the quantitative version of the reference's Posit16 experiment.
    """
    from .gridding import convgrid_wproj

    formats = formats or ["bf16", "posit16"]
    guv = jnp.zeros(grid_shape, jnp.complex64)
    ref = convgrid_wproj(jnp.asarray(bank, jnp.complex64), guv, p, wbin,
                         jnp.asarray(vis, jnp.complex64))
    ref_norm = jnp.sqrt(jnp.mean(jnp.abs(ref) ** 2))
    out = {}
    for name in formats:
        q = QUANTIZERS[name]
        g = convgrid_wproj(q(jnp.asarray(bank, jnp.complex64)), guv, p, wbin,
                           q(jnp.asarray(vis, jnp.complex64)))
        err = jnp.sqrt(jnp.mean(jnp.abs(g - ref) ** 2)) / ref_norm
        out[name] = float(err)
    return out
