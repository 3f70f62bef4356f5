"""Kernel synthesis and convolution tests.

Validates against analytic properties + the independent numpy oracle
(SmallTest-style deterministic fixtures — SURVEY §4).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_tpu import KernelOptions, ops
from ska_sdp_tpu.utils import oracle


class TestConvolve2d:
    @pytest.mark.parametrize("n", [7, 8, 15, 16])
    def test_matches_direct_convolution(self, rng, n):
        a1 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        a2 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        got = np.asarray(ops.convolve2d(jnp.asarray(a1), jnp.asarray(a2)))
        want = oracle.convolve2d_direct(a1, a2)
        np.testing.assert_allclose(got, want, atol=1e-10)

    def test_matches_oracle_fft_impl(self, rng):
        n = 15
        a1 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        a2 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        got = np.asarray(ops.convolve2d(jnp.asarray(a1), jnp.asarray(a2)))
        np.testing.assert_allclose(got, oracle.convolve2d(a1, a2), atol=1e-10)

    def test_delta_identity(self):
        # convolving with a centered delta reproduces the input
        n = 15
        delta = np.zeros((n, n), dtype=np.complex128)
        delta[n // 2, n // 2] = 1.0
        a = np.arange(n * n, dtype=np.complex128).reshape(n, n)
        got = np.asarray(ops.convolve2d(jnp.asarray(a), jnp.asarray(delta)))
        np.testing.assert_allclose(got, a, atol=1e-10)

    def test_batched_leading_axes(self, rng):
        a = rng.standard_normal((3, 9, 9)) * (1 + 0j)
        b = rng.standard_normal((9, 9)) * (1 + 0j)
        got = np.asarray(ops.convolve2d(jnp.asarray(a), jnp.asarray(b)))
        for k in range(3):
            np.testing.assert_allclose(
                got[k], oracle.convolve2d_direct(a[k], b), atol=1e-10
            )


class TestWKernel:
    def test_matches_oracle(self):
        opts = KernelOptions(qpx=2, npix_ff=32, npix_kern=7)
        got = np.asarray(ops.w_kernel(0.1, 100.0, opts))
        want = oracle.w_kernel(0.1, 100.0, qpx=2, npix_ff=32, npix_kern=7)
        assert got.shape == (2, 2, 7, 7)
        np.testing.assert_allclose(got, want, atol=1e-12)

    def test_zero_w_is_delta_like(self):
        # w=0 phase screen is all-ones; its transform concentrates at the
        # zero tap: the (0,0)-offset kernel's center dominates.
        opts = KernelOptions(qpx=2, npix_ff=64, npix_kern=9)
        k = np.asarray(ops.w_kernel(0.05, 0.0, opts))
        center = abs(k[0, 0, 4, 4])
        rest = np.abs(k[0, 0]).sum() - center
        assert center > 10 * rest

    def test_kernel_sums_preserve_flux(self):
        # Σ taps of the (0,0) sub-kernel ≈ Σ far-field / (npix_ff²) · qpx²-ish:
        # flux conservation within a tolerance (truncation to npix_kern).
        opts = KernelOptions(qpx=4, npix_ff=64, npix_kern=15)
        k = np.asarray(ops.w_kernel(0.05, 50.0, opts))
        # each oversampled sub-kernel should carry ~the same total flux
        sums = np.abs(k.sum(axis=(-2, -1)))
        assert sums.std() / sums.mean() < 0.05

    def test_batched_w_vector(self):
        opts = KernelOptions(qpx=2, npix_ff=32, npix_kern=7)
        ws = jnp.asarray([0.0, 50.0, 100.0])
        bank = np.asarray(ops.w_kernel(0.1, ws, opts))
        assert bank.shape == (3, 2, 2, 7, 7)
        single = np.asarray(ops.w_kernel(0.1, 50.0, opts))
        np.testing.assert_allclose(bank[1], single, atol=1e-12)

    def test_bank_is_conjugated(self):
        opts = KernelOptions(qpx=2, npix_ff=32, npix_kern=7)
        bank = np.asarray(ops.w_kernel_bank(0.1, jnp.asarray([100.0]), opts))
        single = np.asarray(ops.w_kernel(0.1, 100.0, opts))
        np.testing.assert_allclose(bank[0], np.conj(single), atol=1e-12)


class TestAWKernels:
    def _fixtures(self, rng, s=15, nant=3, nw=2, qpx=2):
        ak = rng.standard_normal((nant, s, s)) + 1j * rng.standard_normal(
            (nant, s, s)
        )
        wk = rng.standard_normal((nw, qpx, qpx, s, s)) + 1j * rng.standard_normal(
            (nw, qpx, qpx, s, s)
        )
        return jnp.asarray(ak), jnp.asarray(wk)

    def test_batched_matches_composed(self, rng):
        ak, wk = self._fixtures(rng)
        a_spec = ops.akernel_spectra(ak)
        w_spec = ops.wkernel_tap_spectra(wk)
        build = ops.make_aw_kernels_batched(15)
        a1 = jnp.asarray([0, 1, 2, 0])
        a2 = jnp.asarray([1, 2, 0, 0])
        wbin = jnp.asarray([0, 1, 0, 1])
        yf = jnp.asarray([0, 1, 0, 1])
        xf = jnp.asarray([1, 0, 0, 1])
        got = np.asarray(build(a_spec, w_spec, a1, a2, wbin, yf, xf))
        for k in range(4):
            want = np.conj(
                np.asarray(
                    ops.aw_kernel(
                        ak[int(a1[k])],
                        ak[int(a2[k])],
                        wk[int(wbin[k]), int(yf[k]), int(xf[k])],
                    )
                )
            )
            np.testing.assert_allclose(got[k], want, atol=1e-9)

    def test_aw_kernel_against_direct(self, rng):
        # aw = trunc(conv(trunc(conv(a1,a2)), w)) — verify both stages
        # against the O(n⁴) direct convolution.
        s = 9
        a1 = rng.standard_normal((s, s)) * (1 + 0j)
        a2 = rng.standard_normal((s, s)) * (1 + 0j)
        w = rng.standard_normal((s, s)) * (1 + 0j)
        inner = oracle.convolve2d_direct(a1, a2)
        want = oracle.convolve2d_direct(inner, w)
        got = np.asarray(
            ops.aw_kernel(jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(w))
        )
        np.testing.assert_allclose(got, want, atol=1e-9)


class TestVariants:
    def test_fft_pow2_equals_direct_on_pow2_sizes(self, rng):
        from ska_sdp_tpu.ops import fft_centered, fft_pow2

        import jax.numpy as jnp
        a = jnp.asarray(rng.standard_normal((32, 32)) * (1 + 1j))
        np.testing.assert_allclose(
            np.asarray(fft_pow2(a)), np.asarray(fft_centered(a)), atol=1e-12
        )

    def test_convolve2d_cheap_matches_exact_for_compact_kernels(self, rng):
        # kernels concentrated near the center don't wrap: the cheap
        # (circular) variant agrees with the exact linear convolution
        from ska_sdp_tpu.ops import convolve2d, convolve2d_cheap

        import jax.numpy as jnp
        n = 16
        a = np.zeros((n, n), np.complex128)
        b = np.zeros((n, n), np.complex128)
        a[6:10, 6:10] = rng.standard_normal((4, 4))
        b[7:9, 7:9] = rng.standard_normal((2, 2))
        got = np.asarray(convolve2d_cheap(jnp.asarray(a), jnp.asarray(b)))
        want = np.asarray(convolve2d(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, atol=1e-10)

    def test_kernel_coordinate_pattern_options(self):
        # pattern shift / 2x2 transform hooks (ref kernel_coordinates opts)
        from ska_sdp_tpu import KernelOptions
        from ska_sdp_tpu.ops import kernel_coordinates

        base_l, base_m = kernel_coordinates(8, 0.1, KernelOptions())
        l2, m2 = kernel_coordinates(
            8, 0.1, KernelOptions(pat_hor_shift=3, pat_ver_shift=-2)
        )
        np.testing.assert_allclose(np.asarray(l2 - base_l), 3.0)
        np.testing.assert_allclose(np.asarray(m2 - base_m), -2.0)
        # transform matrix [[0,1],[1,0]] swaps l and m
        l3, m3 = kernel_coordinates(
            8, 0.1, KernelOptions(pat_trans_mat=(0.0, 1.0, 1.0, 0.0))
        )
        np.testing.assert_allclose(np.asarray(l3), np.asarray(base_m))
        np.testing.assert_allclose(np.asarray(m3), np.asarray(base_l))


class TestAWScreens:
    """``aw_screens`` (jnp, used inside jitted code) against its numpy
    twin ``aw_screens_host`` (what the drivers use): same transform."""

    @pytest.mark.parametrize("S,fov_scale", [(32, 1.0), (64, 1.0),
                                             (64, 1.33)])
    def test_matches_host_twin(self, rng, S, fov_scale):
        from ska_sdp_tpu.ops.idg_aw import aw_screens, aw_screens_host

        ak = (rng.standard_normal((3, 15, 15))
              + 1j * rng.standard_normal((3, 15, 15)))
        got = np.asarray(aw_screens(jnp.asarray(ak), S,
                                    dtype=jnp.complex128,
                                    fov_scale=fov_scale))
        want = aw_screens_host(ak, S, fov_scale=fov_scale)
        np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())

    def test_complex64_full_precision(self, rng):
        """The complex64 screens are pinned to full-precision f32 matmuls
        (no reduced-precision passes): error at f32 rounding level."""
        from ska_sdp_tpu.ops.idg_aw import aw_screens, aw_screens_host

        ak = (rng.standard_normal((4, 15, 15))
              + 1j * rng.standard_normal((4, 15, 15)))
        got = np.asarray(aw_screens(jnp.asarray(ak, jnp.complex64), 64,
                                    dtype=jnp.complex64))
        want = aw_screens_host(ak, 64)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 1e-6, rel
