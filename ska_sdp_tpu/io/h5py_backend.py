"""h5py implementation of the HDF5 I/O contract.

One of two interchangeable backends behind :mod:`ska_sdp_tpu.io.h5` (the
other is the native C++ extension in ``io/native``).  The capability set
matches the reference's C++ layer (``/root/reference/hdf5/hdf5.cc``): n-D
double/complex/int64 read & write, stacked multi-dataset read, group-member
listing, file creation, ``.h5`` extension defaulting.
"""

from __future__ import annotations

import os

import numpy as np


def _h5py():
    """Import h5py on first use: it is an optional extra, and the rest of
    the package must import without it."""
    import h5py

    return h5py


def fix_ext(path: str) -> str:
    return path if path.endswith(".h5") else path + ".h5"


def create_file(path: str) -> None:
    with _h5py().File(fix_ext(path), "w"):
        pass


def read_dataset(path: str, name: str, dtype=None) -> np.ndarray:
    with _h5py().File(fix_ext(path), "r") as f:
        arr = np.asarray(f[name])
    return arr if dtype is None else arr.astype(dtype)


def read_dataset_slice(path: str, name: str, start: int, count: int,
                       dtype=None) -> np.ndarray:
    """Read rows [start, start+count) along the leading axis."""
    with _h5py().File(fix_ext(path), "r") as f:
        arr = np.asarray(f[name][start:start + count])
    return arr if dtype is None else arr.astype(dtype)


def read_datasets_stacked(path: str, names, dtype=None) -> np.ndarray:
    """Read a list of equal-shape datasets into one rank+1 array.

    Analog of the reference's single-buffer multi-read
    (``hdf5/hdf5.cc:271-321``).
    """
    with _h5py().File(fix_ext(path), "r") as f:
        arrs = [np.asarray(f[n]) for n in names]
    out = np.stack(arrs, axis=0)
    return out if dtype is None else out.astype(dtype)


def write_dataset(path: str, name: str, data: np.ndarray) -> None:
    """Create (or overwrite) a dataset, creating parent groups as needed."""
    path = fix_ext(path)
    mode = "a" if os.path.exists(path) else "w"
    with _h5py().File(path, mode) as f:
        if name in f:
            del f[name]
        f.create_dataset(name, data=np.ascontiguousarray(data))


def list_group(path: str, group: str) -> list[str]:
    with _h5py().File(fix_ext(path), "r") as f:
        return list(f[group].keys())


def dataset_shape(path: str, name: str) -> tuple[int, ...]:
    with _h5py().File(fix_ext(path), "r") as f:
        return tuple(f[name].shape)
