"""Native C++ HDF5 backend: round-trips + cross-backend interop with h5py.

The native layer (``io/native/hdf5_native.cc`` + ctypes bindings) is the
framework's counterpart of the reference's C1 ★ component; these tests are
the asserted version of the reference's only self-checking test module
(SURVEY §4, ``test/Hdf5.hs`` write→read→compare round-trips), plus interop
in both directions since both backends must produce identical files.
"""

import numpy as np
import pytest

from ska_sdp_tpu.io import h5py_backend as hb

nb = pytest.importorskip("ska_sdp_tpu.io.native_backend")

try:
    nb.ensure_loaded()
    HAVE_NATIVE = True
except Exception:
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(
    not HAVE_NATIVE, reason="native HDF5 library unavailable"
)


class TestNativeRoundTrip:
    def test_f64(self, tmp_path, rng):
        p = str(tmp_path / "n1.h5")
        a = rng.standard_normal((3, 4, 5))
        nb.create_file(p)
        nb.write_dataset(p, "/deep/group/tree/x", a)
        np.testing.assert_array_equal(nb.read_dataset(p, "/deep/group/tree/x"), a)
        assert nb.dataset_shape(p, "/deep/group/tree/x") == (3, 4, 5)

    def test_c128(self, tmp_path, rng):
        p = str(tmp_path / "n2.h5")
        c = rng.standard_normal((6, 2)) + 1j * rng.standard_normal((6, 2))
        nb.create_file(p)
        nb.write_dataset(p, "/c", c)
        np.testing.assert_array_equal(
            nb.read_dataset(p, "/c", dtype=np.complex128), c
        )

    def test_i64(self, tmp_path, rng):
        p = str(tmp_path / "n3.h5")
        i = rng.integers(-(2**60), 2**60, size=9)
        nb.create_file(p)
        nb.write_dataset(p, "/i", i)
        np.testing.assert_array_equal(nb.read_dataset(p, "/i", dtype=np.int64), i)

    def test_slice_reads_match_h5py(self, tmp_path, rng):
        # hyperslab slice reads (out-of-core / sharded ingest)
        p = str(tmp_path / "nsl.h5")
        c = (rng.standard_normal((10, 3, 2))
             + 1j * rng.standard_normal((10, 3, 2))).astype(np.complex128)
        d = rng.standard_normal((8, 5))
        nb.create_file(p)
        nb.write_dataset(p, "/g/c", c)
        nb.write_dataset(p, "/g/d", d)
        for start, count in [(0, 10), (2, 5), (9, 1), (3, 0)]:
            np.testing.assert_array_equal(
                nb.read_dataset_slice(p, "/g/c", start, count),
                hb.read_dataset_slice(p, "/g/c", start, count),
            )
            np.testing.assert_array_equal(
                nb.read_dataset_slice(p, "/g/c", start, count),
                c[start:start + count],
            )
        np.testing.assert_array_equal(
            nb.read_dataset_slice(p, "/g/d", 1, 6), d[1:7]
        )
        with pytest.raises(OSError):
            nb.read_dataset_slice(p, "/g/d", 5, 10)  # beyond extent

    def test_facade_slice_routes_to_selected_backend(self, tmp_path, rng,
                                                     monkeypatch):
        import importlib

        from ska_sdp_tpu.io import h5 as h5f

        p = str(tmp_path / "nslf.h5")
        d = rng.standard_normal((6, 4))
        nb.create_file(p)
        nb.write_dataset(p, "/d", d)
        monkeypatch.setenv("SKA_SDP_TPU_H5_BACKEND", "native")
        monkeypatch.setattr(h5f, "_backend", None)
        monkeypatch.setattr(h5f, "_backend_name", None)
        got = h5f.read_dataset_slice(p, "/d", 2, 3)
        assert h5f.backend_name() == "native"
        np.testing.assert_array_equal(got, d[2:5])
        monkeypatch.setattr(h5f, "_backend", None)
        monkeypatch.setattr(h5f, "_backend_name", None)

    def test_rank4_kernel_shape(self, tmp_path, rng):
        p = str(tmp_path / "n4.h5")
        k = (rng.standard_normal((2, 2, 7, 7)) * (1 + 1j)).astype(np.complex128)
        nb.create_file(p)
        nb.write_dataset(p, "/wkern/0.008/100/kern", k)
        np.testing.assert_array_equal(
            nb.read_dataset(p, "/wkern/0.008/100/kern"), k
        )

    def test_stacked(self, tmp_path, rng):
        p = str(tmp_path / "n5.h5")
        nb.create_file(p)
        arrs = [rng.standard_normal((4, 4)) * (1 + 0.5j) for _ in range(4)]
        for k, a in enumerate(arrs):
            nb.write_dataset(p, f"/g/{k}/kern", a)
        got = nb.read_datasets_stacked(
            p, [f"/g/{k}/kern" for k in range(4)], dtype=np.complex128
        )
        np.testing.assert_array_equal(got, np.stack(arrs))

    def test_list_group(self, tmp_path):
        p = str(tmp_path / "n6.h5")
        nb.create_file(p)
        for name in ["-200", "0", "1500.5"]:
            nb.write_dataset(p, f"/wkern/0.1/{name}/kern", np.zeros((2, 2)))
        assert sorted(nb.list_group(p, "/wkern/0.1")) == ["-200", "0", "1500.5"]

    def test_ext_defaulting(self, tmp_path):
        p = str(tmp_path / "noext")
        nb.create_file(p)
        nb.write_dataset(p, "/d", np.ones(3))
        np.testing.assert_array_equal(nb.read_dataset(p + ".h5", "/d"), np.ones(3))

    def test_overwrite_via_fallback(self, tmp_path):
        p = str(tmp_path / "n7.h5")
        nb.create_file(p)
        nb.write_dataset(p, "/d", np.ones(3))
        nb.write_dataset(p, "/d", np.zeros(5))
        assert nb.dataset_shape(p, "/d") == (5,)

    def test_missing_dataset_raises(self, tmp_path):
        p = str(tmp_path / "n8.h5")
        nb.create_file(p)
        with pytest.raises(OSError):
            nb.read_dataset(p, "/nope", dtype=np.float64)


class TestCrossBackend:
    def test_native_reads_h5py_file(self, tmp_path, rng):
        p = str(tmp_path / "x1.h5")
        c = rng.standard_normal((5, 3)) + 1j * rng.standard_normal((5, 3))
        hb.create_file(p)
        hb.write_dataset(p, "/vis/vis", c)
        np.testing.assert_array_equal(
            nb.read_dataset(p, "/vis/vis", dtype=np.complex128), c
        )

    def test_h5py_reads_native_file(self, tmp_path, rng):
        p = str(tmp_path / "x2.h5")
        c = rng.standard_normal((5, 3)) + 1j * rng.standard_normal((5, 3))
        nb.create_file(p)
        nb.write_dataset(p, "/vis/vis", c)
        np.testing.assert_array_equal(hb.read_dataset(p, "/vis/vis"), c)

    def test_dtype_sniffing(self, tmp_path, rng):
        # no dtype given: native backend infers complex/int/double
        p = str(tmp_path / "x3.h5")
        hb.create_file(p)
        hb.write_dataset(p, "/c", np.ones(3, np.complex128) * (1 + 2j))
        hb.write_dataset(p, "/i", np.arange(3))
        hb.write_dataset(p, "/f", np.ones(3))
        assert nb.read_dataset(p, "/c").dtype == np.complex128
        assert nb.read_dataset(p, "/i").dtype == np.int64
        assert nb.read_dataset(p, "/f").dtype == np.float64

    def test_full_pipeline_on_native_backend(self, tmp_path, monkeypatch):
        # run the end-to-end w-projection driver forced onto the native
        # backend and compare against the h5py-backend result
        import importlib

        from ska_sdp_tpu.config import GridParams, ImagingConfig
        from ska_sdp_tpu.io import h5 as h5facade
        from ska_sdp_tpu.io.synthetic import SyntheticConfig, generate_dataset
        from ska_sdp_tpu.models import dataset as ds

        cfg = SyntheticConfig(
            theta=0.05, lam=1800, nant=6, ntime=3, nw_planes=4, qpx=2,
            npix_ff=64, npix_kern=9, seed=3,
        )
        icfg = ImagingConfig(
            grid=GridParams(theta=0.05, lam=1800), precision_name="double"
        )
        paths, _ = generate_dataset(str(tmp_path / "d"), cfg)

        results = {}
        for backend in ("h5py", "native"):
            monkeypatch.setenv("SKA_SDP_TPU_H5_BACKEND", backend)
            h5facade._backend = None  # reset façade cache
            h5facade._backend_name = None
            mx, img = ds.w_gridding(paths["wkern"], paths["vis"], config=icfg)
            results[backend] = (mx, img)
            assert h5facade.backend_name() == backend
        h5facade._backend = None
        h5facade._backend_name = None

        np.testing.assert_array_equal(results["h5py"][1], results["native"][1])
        assert results["h5py"][0] == results["native"][0]


class TestExtendedDtypes:
    """int32 / float32 / complex64 / {r,i}-int32 — the dtype completeness
    pass (reference parity: plain INT reads/writes and the
    {r,i} int compound, /root/reference/hdf5/hdf5.cc:80,106,204)."""

    @pytest.mark.parametrize("dtype", [np.float32, np.int32, np.complex64])
    def test_native_roundtrip(self, tmp_path, rng, dtype):
        p = str(tmp_path / "ext.h5")
        if np.dtype(dtype).kind == "c":
            a = (rng.standard_normal((4, 5))
                 + 1j * rng.standard_normal((4, 5))).astype(dtype)
        elif np.dtype(dtype).kind == "i":
            a = rng.integers(-1000, 1000, (4, 5)).astype(dtype)
        else:
            a = rng.standard_normal((4, 5)).astype(dtype)
        nb.create_file(p)
        nb.write_dataset(p, "/x", a)
        got = nb.read_dataset(p, "/x")
        assert got.dtype == a.dtype
        np.testing.assert_array_equal(got, a)

    @pytest.mark.parametrize("dtype", [np.float32, np.int32, np.complex64])
    def test_h5py_reads_native_file(self, tmp_path, rng, dtype):
        import h5py

        p = str(tmp_path / "ext2.h5")
        if np.dtype(dtype).kind == "c":
            a = (rng.standard_normal(7) + 1j * rng.standard_normal(7)
                 ).astype(dtype)
        else:
            a = np.arange(7).astype(dtype)
        nb.create_file(p)
        nb.write_dataset(p, "/x", a)
        with h5py.File(p, "r") as f:
            got = np.asarray(f["/x"])
            if np.dtype(dtype).kind == "c":
                got = got.astype(dtype)  # h5py may expose {r,i} view
            assert got.dtype == a.dtype
            np.testing.assert_array_equal(got, a)

    @pytest.mark.parametrize("dtype", [np.float32, np.int32, np.complex64])
    def test_native_reads_h5py_file(self, tmp_path, rng, dtype):
        import h5py

        p = str(tmp_path / "ext3.h5")
        if np.dtype(dtype).kind == "c":
            a = (rng.standard_normal(6) + 1j * rng.standard_normal(6)
                 ).astype(dtype)
        else:
            a = np.arange(6).astype(dtype)
        with h5py.File(p, "w") as f:
            f["/y"] = a
        got = nb.read_dataset(p, "/y")
        assert got.dtype == a.dtype
        np.testing.assert_array_equal(got, a)

    def test_complex_int_compound(self, tmp_path):
        """{r, i} int32 compound — the reference's complex-int type."""
        import h5py

        p = str(tmp_path / "ci.h5")
        ci = np.zeros((2, 3), dtype=nb.COMPLEX_INT_DTYPE)
        ci["r"] = np.arange(6).reshape(2, 3)
        ci["i"] = -np.arange(6).reshape(2, 3)
        nb.create_file(p)
        nb.write_dataset(p, "/ci", ci)
        got = nb.read_dataset(p, "/ci")
        assert got.dtype == nb.COMPLEX_INT_DTYPE
        np.testing.assert_array_equal(got["r"], ci["r"])
        np.testing.assert_array_equal(got["i"], ci["i"])
        with h5py.File(p, "r") as f:
            h = np.asarray(f["/ci"])
            np.testing.assert_array_equal(h["r"], ci["r"])
            np.testing.assert_array_equal(h["i"], ci["i"])

    def test_slice_read_f32(self, tmp_path, rng):
        p = str(tmp_path / "sl.h5")
        a = rng.standard_normal((10, 4)).astype(np.float32)
        nb.create_file(p)
        nb.write_dataset(p, "/s", a)
        got = nb.read_dataset_slice(p, "/s", 3, 5)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, a[3:8])
