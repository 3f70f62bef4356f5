"""Multi-host initialization and hierarchical meshes.

The reference is single-process (SURVEY §5: no MPI/NCCL/sockets anywhere).
The framework scales across hosts with ``jax.distributed``: every host
runs the same program, arrays are globally sharded over a ("host", "vis")
mesh, and the partial-grid reduction composes hierarchically — psum segments
ride the intra-host interconnect, then the network across hosts, scheduled
by XLA.

On a single machine this module is exercised via
``xla_force_host_platform_device_count`` (see ``tests/test_parallel.py`` and
``__graft_entry__.dryrun_multichip``).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX if a cluster spec is provided.

    No-op on a single process.  Env-variable driven
    (``SKA_SDP_TPU_COORDINATOR``/``_NPROCS``/``_PROC_ID``) or explicit args.
    """
    coordinator = coordinator or os.environ.get("SKA_SDP_TPU_COORDINATOR")
    if not coordinator:
        return
    num_processes = num_processes or int(os.environ["SKA_SDP_TPU_NPROCS"])
    process_id = process_id if process_id is not None else int(
        os.environ["SKA_SDP_TPU_PROC_ID"]
    )
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_host_vis_mesh(per_host: Optional[int] = None) -> Mesh:
    """2-D ("host", "vis") mesh over all global devices.

    With H processes of D local devices each, the mesh is H×D; the grid
    psum over both axes is hierarchical on the wire.
    """
    devices = np.asarray(jax.devices())
    nproc = jax.process_count()
    if per_host is None:
        per_host = len(devices) // nproc
    return Mesh(devices.reshape(nproc, per_host), ("host", "vis"))
