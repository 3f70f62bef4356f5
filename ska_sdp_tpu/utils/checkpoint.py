"""Checkpoint/resume for long gridding runs.

The reference is a single-shot batch job with no persistence beyond the
final image (SURVEY §5 "Checkpoint / resume: None").  Real SKA-scale runs
grid billions of visibilities; this module adds slab-granular
checkpointing: after each visibility slab the partial uv-grid and the
next-slab index are written to an HDF5 checkpoint (atomically, via a tmp
file + rename), and an interrupted run resumes from the last completed
slab.

A checkpoint carries a **config fingerprint** (θ, λ, kernel-bank shape,
precision — whatever the caller hashes in): resuming with a different
w-kernel file, precision or weighting would silently mix inconsistent
numerics into the accumulated grid, so a mismatch rejects the checkpoint
with a logged warning instead of a silent restart-from-zero.

Layout: ``/ckpt/grid_re``, ``/ckpt/grid_im`` ([n, n] at the RUN's real
precision — float32 runs write float32 slabs, halving checkpoint I/O),
``/ckpt/next`` (float64 [1] — visibilities already
gridded), ``/ckpt/total`` (float64 [1]), ``/ckpt/fpr`` (float64 [1] —
fingerprint; the fingerprint includes the precision, so a resume under a
different precision is rejected rather than silently cast).
"""

from __future__ import annotations

import logging
import os
import zlib
from typing import Optional, Tuple

import numpy as np

from ..io import h5

log = logging.getLogger("ska_sdp_tpu.checkpoint")


def _norm(path: str) -> str:
    """The io façade appends .h5 to extension-less names (reference
    fix_ext semantics); normalize once so save/load/exists agree."""
    return path if path.endswith(".h5") else path + ".h5"


GRID_RE = "/ckpt/grid_re"
GRID_IM = "/ckpt/grid_im"
NEXT = "/ckpt/next"
TOTAL = "/ckpt/total"
FPR = "/ckpt/fpr"


def fingerprint(*parts) -> int:
    """Small stable fingerprint of run-defining config values."""
    text = "|".join(repr(p) for p in parts)
    return zlib.crc32(text.encode())


def save(path: str, grid_re: np.ndarray, grid_im: np.ndarray, next_vis: int,
         total: int, fpr: int = 0) -> None:
    """Atomically write a gridding checkpoint."""
    path = _norm(path)
    tmp = path + ".tmp.h5"
    h5.create_file(tmp)
    grid_re = np.asarray(grid_re)
    dt = np.float32 if grid_re.dtype == np.float32 else np.float64
    h5.write_dataset(tmp, GRID_RE, np.asarray(grid_re, dt))
    h5.write_dataset(tmp, GRID_IM, np.asarray(grid_im, dt))
    h5.write_dataset(tmp, NEXT, np.asarray([float(next_vis)]))
    h5.write_dataset(tmp, TOTAL, np.asarray([float(total)]))
    h5.write_dataset(tmp, FPR, np.asarray([float(fpr)]))
    os.replace(tmp, path)


def load(path: str, n_grid: int, total: int,
         fpr: int = 0) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """Load a checkpoint; None if absent or inconsistent with the run.

    Every rejection of an *existing* file is logged — a corrupt or
    mismatched checkpoint silently restarting a multi-hour run from
    visibility 0 is exactly the failure mode this guards against.
    """
    path = _norm(path)
    if not os.path.exists(path):
        return None
    try:
        tot = int(np.asarray(h5.read_dataset(path, TOTAL))[0])
        if tot != total:
            log.warning(
                "checkpoint %s rejected: total %d != run total %d "
                "(restarting from 0)", path, tot, total,
            )
            return None
        try:
            got_fpr = int(np.asarray(h5.read_dataset(path, FPR))[0])
        except Exception:
            got_fpr = None  # pre-fingerprint checkpoint
        if got_fpr is not None and got_fpr != fpr:
            log.warning(
                "checkpoint %s rejected: config fingerprint %s != %s — "
                "different wkern bank/precision/θλ (restarting from 0)",
                path, got_fpr, fpr,
            )
            return None
        gre = np.asarray(h5.read_dataset(path, GRID_RE))
        gim = np.asarray(h5.read_dataset(path, GRID_IM))
        if gre.shape != (n_grid, n_grid):
            log.warning(
                "checkpoint %s rejected: grid shape %s != (%d, %d) "
                "(restarting from 0)", path, gre.shape, n_grid, n_grid,
            )
            return None
        nxt = int(np.asarray(h5.read_dataset(path, NEXT))[0])
        return gre, gim, nxt
    except Exception as e:
        log.warning(
            "checkpoint %s unreadable (%s: %s) — restarting from 0",
            path, type(e).__name__, e,
        )
        return None


def remove(path: str) -> None:
    path = _norm(path)
    if os.path.exists(path):
        os.remove(path)
