"""HDF5 I/O façade: native C++ backend with h5py fallback.

The reference's only native component is its C++ HDF5 layer (SURVEY §2 C1,
``/root/reference/hdf5/hdf5.cc``).  This framework provides the same
capability as a C++ shared library (``io/native/``, bound via ctypes) and an
h5py implementation with the identical Python-visible API; the two are
interchangeable and cross-validated in the test suite.

Select with env ``SKA_SDP_TPU_H5_BACKEND`` in {"native", "h5py", "auto"}
(default auto: native if it builds/loads, else h5py).  The native library
needs ``g++`` and a system ``libhdf5`` at run time; h5py is an optional
extra (``pip install .[h5py]``).  Neither is imported until the first
HDF5 call, so the rest of the package imports without either.
"""

from __future__ import annotations

import os
from typing import Optional

from . import h5py_backend

_backend = None
_backend_name: Optional[str] = None


def _resolve():
    global _backend, _backend_name
    if _backend is not None:
        return _backend
    choice = os.environ.get("SKA_SDP_TPU_H5_BACKEND", "auto")
    native_error = None
    if choice in ("auto", "native"):
        try:
            from . import native_backend

            native_backend.ensure_loaded()
            _backend, _backend_name = native_backend, "native"
            return _backend
        except Exception as e:
            if choice == "native":
                raise
            native_error = e
    try:
        h5py_backend._h5py()
    except ImportError as e:
        raise RuntimeError(
            "no HDF5 backend available: the native library could not be "
            f"built or loaded ({native_error!r}; it needs g++ and a system "
            "libhdf5) and h5py is not installed"
        ) from e
    _backend, _backend_name = h5py_backend, "h5py"
    return _backend


def backend_name() -> str:
    _resolve()
    return _backend_name  # type: ignore[return-value]


def create_file(path):
    return _resolve().create_file(path)


def read_dataset(path, name, dtype=None):
    """Read a dataset; ``dtype`` selects the typed entry point (the
    reference's readDatasetComplex/Double/Int64 analog)."""
    return _resolve().read_dataset(path, name, dtype=dtype)


def read_dataset_slice(path, name, start, count, dtype=None):
    """Leading-axis slice read (out-of-core ingest and sharded ingest).

    Served by the selected backend: the native C++ layer implements it via
    an H5Sselect_hyperslab read (``ska_h5_read_slice``), h5py via fancy
    indexing — cross-validated in ``tests/test_native_h5.py``.
    """
    return _resolve().read_dataset_slice(path, name, start, count, dtype)


def read_datasets_stacked(path, names, dtype=None):
    return _resolve().read_datasets_stacked(path, names, dtype=dtype)


def write_dataset(path, name, data):
    return _resolve().write_dataset(path, name, data)


def list_group(path, group):
    return _resolve().list_group(path, group)


def dataset_shape(path, name):
    return _resolve().dataset_shape(path, name)
