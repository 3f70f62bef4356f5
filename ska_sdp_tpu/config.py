"""Configuration surface of the framework.

Mirrors the reference's three-tier config system (SURVEY §5 / reference
``src/Gridding.hs:30-46`` ``KernelOptions``/``OtherImagingArgs``,
``app/Main.hs:17-26`` CLI, ``src/ImageDataset.hs:32-33`` observation
constants) — redesigned as frozen dataclasses so that every field is a static
(trace-time) constant under ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .types import Precision, precision


@dataclasses.dataclass(frozen=True)
class KernelOptions:
    """Options controlling w/A-kernel synthesis.

    Reference: ``src/Gridding.hs:30-38`` (same field meanings).  ``pat_*``
    fields implement the pattern-shift/transform hooks of
    ``kernel_coordinates`` (``src/Gridding.hs:621-635``).
    """

    qpx: int = 8                 # oversampling factor of the convolution kernel
    npix_ff: int = 256           # far-field (image-plane) pixel count
    npix_kern: int = 15          # extracted convolution-kernel support
    wstep: int = 2000            # w-binning step for the w-kernel cache
    pat_hor_shift: int = 0
    pat_ver_shift: int = 0
    pat_trans_mat: Optional[tuple] = None  # 2x2 row-major matrix or None


@dataclasses.dataclass(frozen=True)
class GridParams:
    """Observation/grid geometry: field of view and grid resolution.

    ``n = round(theta * lam)`` exactly as the reference computes it
    (``src/Gridding.hs:86-88``, hardcoded θ=0.008 / lam=300000 at
    ``src/ImageDataset.hs:32-33`` giving the 2400² grid).
    """

    theta: float = 0.008
    lam: int = 300000

    @property
    def n(self) -> int:
        # Python round() is round-half-to-even, same as Haskell P.round.
        return int(round(self.theta * self.lam))


@dataclasses.dataclass(frozen=True)
class ImagingConfig:
    """Full pipeline configuration (CLI surface analog, app/Main.hs:63-78)."""

    grid: GridParams = GridParams()
    kernel: KernelOptions = KernelOptions()
    precision_name: str = "single"
    n_vis: Optional[int] = None  # visibility-count cap (CLI -n); None = all
    use_old_path: bool = False   # CLI -old: per-vis scatter (convgrid3 analog)

    @property
    def precision(self) -> Precision:
        return precision(self.precision_name)  # type: ignore[arg-type]
