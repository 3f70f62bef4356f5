"""ska_sdp_tpu — SKA-SDP visibility gridding/degridding framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
``sakehl/SKA-SDP-Accelerate-gridding`` (reference mounted at
``/root/reference``): HDF5 visibility/kernel ingest, w-projection and
AW-projection kernel-convolved gridding, kernel synthesis from first
principles, Hermitian completion + FFT imaging, degridding, and multi-chip
scale-out via ``shard_map`` + ``psum`` over a device mesh.

Package layout (SURVEY §7 build plan):
  ops/       — batched jnp compute ops (coords, FFT, kernels, gridders)
  models/    — imaging pipelines (simple/conv/w-cache/AW) + dataset driver
  parallel/  — mesh construction and sharded imaging
  io/        — HDF5 schema, h5py + native C++ backends, synthetic datasets
  utils/     — numpy oracle, timing/profiling
"""

from . import ops
from .config import GridParams, ImagingConfig, KernelOptions
from .types import DOUBLE, SINGLE, Precision, precision

__version__ = "0.1.0"
