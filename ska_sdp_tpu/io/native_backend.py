"""ctypes bindings over the native C++ HDF5 library.

Python-visible API identical to :mod:`ska_sdp_tpu.io.h5py_backend`, so the
two backends are interchangeable behind the :mod:`ska_sdp_tpu.io.h5` façade
(cross-validated in ``tests/test_native_h5.py``).  The native layer is the
framework's counterpart of the reference's C++ component
(``/root/reference/hdf5/hdf5.cc`` — SURVEY §2 C1 ★).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None

_KF64, _KC128, _KI64, _KF32, _KI32, _KC64 = 0, 1, 2, 3, 4, 5
_KCI32 = 6  # {r, i} int32 compound — reference parity (hdf5.cc:204), no
            # numpy scalar type; exposed as COMPLEX_INT_DTYPE through the
            # generic read_dataset/write_dataset paths

_KIND_BY_DTYPE = {
    np.dtype(np.float64): _KF64,
    np.dtype(np.complex128): _KC128,
    np.dtype(np.int64): _KI64,
    np.dtype(np.float32): _KF32,
    np.dtype(np.int32): _KI32,
    np.dtype(np.complex64): _KC64,
}
_DTYPE_BY_KIND = {v: k for k, v in _KIND_BY_DTYPE.items()}

# numpy view of the {r, i} int32 compound (h5py reads it as this dtype)
COMPLEX_INT_DTYPE = np.dtype([("r", np.int32), ("i", np.int32)])


def ensure_loaded() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    from .native import build

    lib = ctypes.CDLL(build.build())
    lib.ska_h5_create.argtypes = [ctypes.c_char_p]
    lib.ska_h5_rank.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ska_h5_dims.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.ska_h5_read.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.ska_h5_read_stacked.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_longlong,
        ctypes.c_void_p,
    ]
    lib.ska_h5_read_slice.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_longlong,
        ctypes.c_longlong,
        ctypes.c_void_p,
    ]
    lib.ska_h5_write.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_void_p,
    ]
    lib.ska_h5_list_group.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_longlong,
    ]
    _lib = lib
    return lib


def fix_ext(path: str) -> str:
    return path if path.endswith(".h5") else path + ".h5"


def create_file(path: str) -> None:
    lib = ensure_loaded()
    if lib.ska_h5_create(path.encode()) != 0:
        raise OSError(f"ska_h5_create failed for {path!r}")


def dataset_shape(path: str, name: str) -> tuple[int, ...]:
    lib = ensure_loaded()
    dims = (ctypes.c_longlong * 16)()
    rank = lib.ska_h5_dims(path.encode(), name.encode(), dims)
    if rank < 0:
        raise OSError(f"dataset {name!r} not found in {path!r}")
    return tuple(int(dims[i]) for i in range(rank))


def read_dataset(path: str, name: str, dtype=None) -> np.ndarray:
    """Read a dataset; element type from ``dtype`` (float64/complex128/int64).

    When ``dtype`` is None, uses h5py (if available) just to sniff the
    stored type, else defaults to float64.  The data path itself is native.
    """
    lib = ensure_loaded()
    shape = dataset_shape(path, name)
    if dtype is None:
        dtype = _sniff_dtype(path, name)
    kind = _kind_of(np.dtype(dtype))
    out = np.empty(shape, dtype=np.dtype(dtype))
    rc = lib.ska_h5_read(
        path.encode(), name.encode(), kind,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise OSError(f"ska_h5_read({name!r}) failed rc={rc}")
    return out


def read_dataset_slice(path: str, name: str, start: int, count: int,
                       dtype=None) -> np.ndarray:
    """Leading-axis slice rows [start, start+count) via a native
    H5Sselect_hyperslab read (out-of-core streaming ingest)."""
    lib = ensure_loaded()
    shape = dataset_shape(path, name)
    if dtype is None:
        dtype = _sniff_dtype(path, name)
    kind = _kind_of(np.dtype(dtype))
    out = np.empty((count,) + shape[1:], dtype=np.dtype(dtype))
    rc = lib.ska_h5_read_slice(
        path.encode(), name.encode(), kind, start, count,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise OSError(
            f"ska_h5_read_slice({name!r}, {start}, {count}) failed rc={rc}"
        )
    return out


def _kind_of(dt: np.dtype) -> int:
    if dt == COMPLEX_INT_DTYPE:
        return _KCI32
    return _KIND_BY_DTYPE[dt]


def _sniff_dtype(path: str, name: str):
    """Stored-width dtype of a dataset (f32-stored data reads as f32 —
    run-precision checkpoints round-trip losslessly).

    Caller audit: the vis/
    wkern/akern loaders all pass explicit dtypes (``models/dataset.py``);
    the dtype-omitting callers read /vis/frequency and /img (always
    written float64 by this framework and the reference) or checkpoint
    slabs (run precision is the intended semantics).
    """
    try:
        import h5py

        with h5py.File(fix_ext(path), "r") as f:
            dt = f[name].dtype
        if dt.kind == "c":
            return np.complex64 if dt.itemsize == 8 else np.complex128
        if dt.names and set(dt.names) >= {"r", "i"}:
            sub = dt["r"]
            if sub.kind in "iu":
                return COMPLEX_INT_DTYPE
            return np.complex64 if sub.itemsize == 4 else np.complex128
        if dt.kind in "iu":
            return np.int32 if dt.itemsize <= 4 else np.int64
        return np.float32 if dt.itemsize == 4 else np.float64
    except Exception:
        return np.float64


def read_datasets_stacked(path: str, names, dtype=None) -> np.ndarray:
    lib = ensure_loaded()
    names = [str(n) for n in names]
    shape = dataset_shape(path, names[0])
    if dtype is None:
        dtype = _sniff_dtype(path, names[0])
    kind = _kind_of(np.dtype(dtype))
    elems = int(np.prod(shape)) if shape else 1
    out = np.empty((len(names),) + shape, dtype=np.dtype(dtype))
    joined = "\n".join(names).encode()
    rc = lib.ska_h5_read_stacked(
        path.encode(), joined, len(names), kind, elems,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise OSError(f"ska_h5_read_stacked failed rc={rc}")
    return out


def write_dataset(path: str, name: str, data: np.ndarray) -> None:
    lib = ensure_loaded()
    data = np.ascontiguousarray(data)
    if data.dtype not in _KIND_BY_DTYPE and data.dtype != COMPLEX_INT_DTYPE:
        if data.dtype.kind == "f":
            data = data.astype(np.float64)
        elif data.dtype.kind == "c":
            data = data.astype(np.complex128)
        elif data.dtype.kind in "iu":
            data = data.astype(np.int64)
        else:
            raise TypeError(f"unsupported dtype {data.dtype}")
    kind = _kind_of(data.dtype)
    dims = (ctypes.c_longlong * max(1, data.ndim))(*data.shape)
    rc = lib.ska_h5_write(
        path.encode(), name.encode(), kind, data.ndim, dims,
        data.ctypes.data_as(ctypes.c_void_p),
    )
    if rc == -5:
        # dataset exists: fall back to h5py for the delete-and-rewrite path
        from . import h5py_backend

        h5py_backend.write_dataset(path, name, data)
        return
    if rc != 0:
        raise OSError(f"ska_h5_write({name!r}) failed rc={rc}")


def list_group(path: str, group: str) -> list[str]:
    lib = ensure_loaded()
    buf = ctypes.create_string_buffer(1 << 20)
    n = lib.ska_h5_list_group(path.encode(), group.encode(), buf, len(buf))
    if n < 0:
        raise OSError(f"ska_h5_list_group({group!r}) failed rc={n}")
    if n == 0:
        return []
    return buf.value.decode().split("\n")
