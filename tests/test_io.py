"""HDF5 I/O tests: round-trips, schema tree, backend façade."""

import numpy as np
import pytest

from ska_sdp_tpu.io import h5, schema
from ska_sdp_tpu.io import h5py_backend as hb


class TestRoundTrip:
    def test_double_roundtrip(self, tmp_path, rng):
        p = str(tmp_path / "t1.h5")
        a = rng.standard_normal((4, 5, 6))
        hb.create_file(p)
        hb.write_dataset(p, "/x/y", a)
        np.testing.assert_array_equal(hb.read_dataset(p, "/x/y"), a)

    def test_complex_roundtrip(self, tmp_path, rng):
        p = str(tmp_path / "t2.h5")
        a = (rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3)))
        hb.create_file(p)
        hb.write_dataset(p, "/c", a)
        np.testing.assert_array_equal(hb.read_dataset(p, "/c"), a)

    def test_int64_roundtrip(self, tmp_path, rng):
        p = str(tmp_path / "t3.h5")
        a = rng.integers(-(2**40), 2**40, size=17)
        hb.create_file(p)
        hb.write_dataset(p, "/i", a)
        np.testing.assert_array_equal(hb.read_dataset(p, "/i"), a)

    def test_rank4_roundtrip(self, tmp_path, rng):
        p = str(tmp_path / "t4.h5")
        a = rng.standard_normal((2, 3, 4, 5)) * (1 + 1j)
        hb.create_file(p)
        hb.write_dataset(p, "/k", a)
        np.testing.assert_array_equal(hb.read_dataset(p, "/k"), a)

    def test_stacked_read(self, tmp_path, rng):
        p = str(tmp_path / "t5.h5")
        hb.create_file(p)
        arrs = [rng.standard_normal((4, 4)) * (1 + 0j) for _ in range(3)]
        for k, a in enumerate(arrs):
            hb.write_dataset(p, f"/g/{k}/kern", a)
        got = hb.read_datasets_stacked(p, [f"/g/{k}/kern" for k in range(3)])
        np.testing.assert_array_equal(got, np.stack(arrs))

    def test_list_group_and_ext_default(self, tmp_path):
        p = str(tmp_path / "t6")  # no .h5 — backend appends it
        hb.create_file(p)
        hb.write_dataset(p, "/w/100.0/kern", np.zeros((2, 2)))
        hb.write_dataset(p, "/w/-50.5/kern", np.zeros((2, 2)))
        members = hb.list_group(p, "/w")
        assert sorted(members) == sorted(["100.0", "-50.5"])

    def test_overwrite_dataset(self, tmp_path):
        p = str(tmp_path / "t7.h5")
        hb.create_file(p)
        hb.write_dataset(p, "/d", np.ones(3))
        hb.write_dataset(p, "/d", np.zeros(4))
        assert hb.read_dataset(p, "/d").shape == (4,)


class TestSchema:
    def test_parse_sorted_numeric(self):
        pairs = schema.parse_sorted(["10.5", "-3", "2", "100"])
        assert [v for v, _ in pairs] == [-3.0, 2.0, 10.5, 100.0]
        assert [s for _, s in pairs] == ["-3", "2", "10.5", "100"]

    def test_fmt_float(self):
        assert schema.fmt_float(0.008) == "0.008"
        assert schema.fmt_float(100.0) == "100"
        assert schema.fmt_float(-50.5) == "-50.5"

    def test_tree_paths(self):
        assert schema.wkern_dataset(0.008, "200") == "/wkern/0.008/200/kern"
        assert (
            schema.akern_dataset(0.008, "3", "55000", "150000000")
            == "/akern/0.008/3/55000/150000000/kern"
        )


class TestFacade:
    def test_facade_backend_resolves(self, tmp_path):
        p = str(tmp_path / "f.h5")
        h5.create_file(p)
        h5.write_dataset(p, "/z", np.arange(6.0).reshape(2, 3))
        np.testing.assert_array_equal(
            h5.read_dataset(p, "/z"), np.arange(6.0).reshape(2, 3)
        )
        assert h5.backend_name() in ("native", "h5py")


class TestCheckpointGuards:
    """Rejection of an existing checkpoint must warn, and a
    config-fingerprint mismatch must reject (not silently mix numerics)."""

    def test_fingerprint_mismatch_rejects_with_warning(self, tmp_path, rng,
                                                       caplog):
        import logging

        from ska_sdp_tpu.utils import checkpoint as ckpt

        path = str(tmp_path / "ck.h5")
        g = rng.standard_normal((8, 8))
        fpr_a = ckpt.fingerprint(0.008, 300000, (4, 2, 2, 15, 15), "f32")
        fpr_b = ckpt.fingerprint(0.008, 300000, (8, 2, 2, 15, 15), "f32")
        ckpt.save(path, g, g, 100, 200, fpr=fpr_a)
        assert ckpt.load(path, 8, 200, fpr=fpr_a) is not None
        with caplog.at_level(logging.WARNING, "ska_sdp_tpu.checkpoint"):
            assert ckpt.load(path, 8, 200, fpr=fpr_b) is None
        assert any("fingerprint" in r.message for r in caplog.records)

    def test_corrupt_checkpoint_warns(self, tmp_path, caplog):
        import logging

        from ska_sdp_tpu.utils import checkpoint as ckpt

        path = str(tmp_path / "bad.h5")
        with open(path, "wb") as f:
            f.write(b"not an hdf5 file")
        with caplog.at_level(logging.WARNING, "ska_sdp_tpu.checkpoint"):
            assert ckpt.load(path, 8, 100) is None
        assert any("restarting from 0" in r.message for r in caplog.records)

    def test_total_mismatch_warns(self, tmp_path, rng, caplog):
        import logging

        from ska_sdp_tpu.utils import checkpoint as ckpt

        path = str(tmp_path / "ck2.h5")
        g = rng.standard_normal((4, 4))
        ckpt.save(path, g, g, 10, 50, fpr=1)
        with caplog.at_level(logging.WARNING, "ska_sdp_tpu.checkpoint"):
            assert ckpt.load(path, 4, 60, fpr=1) is None
        assert any("total" in r.message for r in caplog.records)


class TestMetricsSink:
    def test_records_carry_process_index_and_atomic_lines(self, tmp_path):
        import json

        from ska_sdp_tpu.utils.metrics import MetricsSink

        path = str(tmp_path / "m.jsonl")
        sink = MetricsSink(path)
        sink.emit("a", x=1)
        sink.emit("b", y=2.5)
        lines = open(path).read().splitlines()
        assert len(lines) == 2
        recs = [json.loads(l) for l in lines]
        assert all("proc" in r and isinstance(r["proc"], int) for r in recs)
        assert recs[0]["event"] == "a" and recs[1]["y"] == 2.5


class TestCheckpointPrecision:
    def test_f32_checkpoint_stores_f32_and_halves_size(self, tmp_path, rng):
        """Checkpoints store grids at run precision —
        float32 runs must not pay 2x I/O for float64 slabs."""
        import os

        from ska_sdp_tpu.utils import checkpoint as ckpt

        n = 64
        g32 = rng.standard_normal((n, n)).astype("float32")
        p32 = str(tmp_path / "c32.h5")
        ckpt.save(p32, g32, g32, 10, 100, fpr=1)
        g64 = g32.astype("float64")
        p64 = str(tmp_path / "c64.h5")
        ckpt.save(p64, g64, g64, 10, 100, fpr=1)

        got = ckpt.load(p32, n, 100, fpr=1)
        assert got is not None
        gre, gim, nxt = got
        assert gre.dtype == np.float32 and nxt == 10
        np.testing.assert_array_equal(gre, g32)

        s32 = os.path.getsize(p32)
        s64 = os.path.getsize(p64)
        assert s32 < 0.75 * s64, (s32, s64)
