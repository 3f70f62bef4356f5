"""Type vocabulary and precision policy for the gridding framework.

Plays the role of the reference's central type-alias module
(``/root/reference/src/Types.hs:1-28``): the reference fixes ``F = Double`` and
``Visibility = Complex Double``.  Accelerators run fp64 far slower than
fp32, so instead of a single hardwired scalar type we carry an explicit
:class:`Precision` policy through the pipelines:

* ``single`` — float32 / complex64: the production configuration.  The
  scatter accumulates each cell in float32; the few thousand contributions a
  cell receives keep the rounding error near 1e-6 relative.
* ``double`` — float64 / complex128: the parity/oracle configuration, used on
  CPU (with ``jax_enable_x64``) to reproduce the reference numerics exactly.

Array-shape conventions (mirroring the reference's rank contracts):

* visibilities: ``[n]`` complex
* uvw baselines: ``[n, 3]`` real (u, v, w)
* uv-grid: ``[N, N]`` complex, indexed ``[y(v), x(u)]`` like the reference
  (``/root/reference/src/Gridding.hs:106-109``)
* oversampled kernel: ``[qpx, qpx, gh, gw]`` complex  (reference DIM4 ``Kernel``)
* w-kernel bank: ``[nw, qpx, qpx, gh, gw]`` complex   (reference DIM5 ``WKernels``)
* A-kernels: ``[nant, ah, aw]`` complex               (reference DIM3 ``AKernels``)
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import jax.numpy as jnp
import numpy as np

SPEED_OF_LIGHT = 299792458.0  # m/s; reference: src/ImageDataset.hs:187


@dataclasses.dataclass(frozen=True)
class Precision:
    """Scalar-type policy threaded through every op."""

    real: jnp.dtype
    complex: jnp.dtype
    int: jnp.dtype

    @property
    def np_real(self) -> np.dtype:
        return np.dtype(self.real)

    @property
    def np_complex(self) -> np.dtype:
        return np.dtype(self.complex)


SINGLE = Precision(real=jnp.float32, complex=jnp.complex64, int=jnp.int32)
DOUBLE = Precision(real=jnp.float64, complex=jnp.complex128, int=jnp.int32)

PrecisionName = Literal["single", "double"]


def precision(name: PrecisionName | Precision = "single") -> Precision:
    if isinstance(name, Precision):
        return name
    if name == "single":
        return SINGLE
    if name == "double":
        return DOUBLE
    raise ValueError(f"unknown precision {name!r}")
