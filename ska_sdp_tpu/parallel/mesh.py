"""Device-mesh construction and sharding policy.

The reference has no model/multi-process parallelism (SURVEY §2, parallelism
inventory) — its scaling story ends at one GPU.  The scale-out design here
(SURVEY §5 "Distributed communication backend"):

* mesh axes: ``("vis",)`` on a single host — visibilities are the data
  axis, sharded over devices by baseline blocks; grows to
  ``("host", "vis")`` across hosts, where the partial-grid reduction is
  hierarchical (psum within a host, then across the network).
* the uv-grid is small (2400² complex64 = 46 MB) relative to HBM, so each
  chip accumulates a private partial grid and the merge is one ``psum`` —
  the classic "grid-parallelism" layout for scatter-heavy workloads.
* kernel banks are replicated (a few MB in each device's memory).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

VIS_AXIS = "vis"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the visibility axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (VIS_AXIS,))


def vis_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (visibility) axis."""
    return NamedSharding(mesh, P(VIS_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k
