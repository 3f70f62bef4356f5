"""End-to-end pipeline tests on a synthetic observation.

The integration strategy mirrors the reference's de-facto integration test
(SURVEY §4: full aw_gridding with dumped intermediates) but asserted:

1. full-chain parity: the jitted w-projection pipeline in double precision
   vs an independent numpy-oracle pipeline on identical HDF5 inputs;
2. physics: point sources injected into the simulated visibilities must
   reappear at their (l, m) positions in the dirty image;
3. the AW pipeline with near-delta A-kernels must approximately agree with
   the w-projection image.
"""

import numpy as np
import pytest

from ska_sdp_tpu.config import GridParams, ImagingConfig
from ska_sdp_tpu.io import schema
from ska_sdp_tpu.io.synthetic import SyntheticConfig, generate_dataset
from ska_sdp_tpu.models import dataset as ds
from ska_sdp_tpu.utils import oracle

CFG = SyntheticConfig(
    theta=0.05,
    lam=3600,          # 180² grid — CPU-friendly
    nant=8,
    ntime=6,
    nsources=3,
    nw_planes=8,
    qpx=4,
    npix_ff=128,
    npix_kern=15,
    seed=7,
)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    paths, obs = generate_dataset(str(d), CFG)
    return paths, obs


@pytest.fixture(scope="module")
def imaging_config():
    return ImagingConfig(
        grid=GridParams(theta=CFG.theta, lam=CFG.lam), precision_name="double"
    )


def oracle_w_pipeline(paths, n_grid, theta, lam):
    """Independent numpy implementation of the full w-projection chain."""
    data = ds.load_vis_data(paths["vis"])
    bank, centers = ds.get_wkernels(paths["wkern"], theta)
    bank = np.conj(bank)

    scale = data.frequency / 299792458.0
    uvw0 = data.uvw * scale
    wt = oracle.doweight(theta, lam, uvw0, np.ones_like(data.vis))
    uvw1, vis1 = oracle.mirror_uvw(uvw0, data.vis)
    wbin = oracle.find_closest(centers, uvw1[:, 2])
    guv = oracle.convgrid_wproj(
        bank, np.zeros((n_grid, n_grid), np.complex128), uvw1 / lam, wbin,
        wt * vis1,
    )
    img = np.real(oracle.ifft_centered(oracle.make_grid_hermitian(guv)))
    return img


class TestWProjectionPipeline:
    def test_matches_oracle_full_chain(self, dataset, imaging_config):
        paths, obs = dataset
        mx, img = ds.w_gridding(
            paths["wkern"], paths["vis"], config=imaging_config
        )
        n_grid = imaging_config.grid.n
        want = oracle_w_pipeline(paths, n_grid, CFG.theta, CFG.lam)
        np.testing.assert_allclose(img, want, atol=1e-8 * np.abs(want).max())
        assert abs(mx - want.max()) < 1e-8 * abs(want.max())

    def test_sources_recovered(self, dataset, imaging_config):
        paths, obs = dataset
        mx, img = ds.w_gridding(
            paths["wkern"], paths["vis"], config=imaging_config
        )
        n = img.shape[0]
        # Image pixel for source (l, m): the centered inverse transform puts
        # l along +x with pixel scale 1/lam... derive empirically-free:
        # expected peak pixels
        for l, m, flux in obs["sources"]:
            iy = int(round(n / 2 + m * CFG.lam))
            ix = int(round(n / 2 + l * CFG.lam))
            window = img[max(0, iy - 2) : iy + 3, max(0, ix - 2) : ix + 3]
            # the local window must contain a strong positive response
            assert window.max() > 0.25 * img.max(), (l, m, flux)

    def test_peak_is_at_a_source(self, dataset, imaging_config):
        paths, obs = dataset
        _, img = ds.w_gridding(paths["wkern"], paths["vis"], config=imaging_config)
        n = img.shape[0]
        iy, ix = np.unravel_index(np.argmax(img), img.shape)
        dists = [
            abs(iy - (n / 2 + m * CFG.lam)) + abs(ix - (n / 2 + l * CFG.lam))
            for l, m, _ in obs["sources"]
        ]
        assert min(dists) <= 3.0


class TestAWPipeline:
    def test_aw_close_to_wproj_with_delta_akernels(self, dataset, imaging_config):
        paths, obs = dataset
        _, img_w = ds.w_gridding(paths["wkern"], paths["vis"], config=imaging_config)
        mx, img_aw = ds.aw_gridding(
            paths["wkern"], paths["akern"], paths["vis"], config=imaging_config
        )
        # A-kernels are delta + 1% noise convolved twice; images agree to a
        # few percent.
        scale = np.abs(img_w).max()
        assert np.abs(img_aw - img_w).max() < 0.15 * scale
        assert mx > 0

    def test_output_file_written(self, dataset, imaging_config, tmp_path):
        paths, obs = dataset
        out = str(tmp_path / "out.h5")
        mx, img = ds.aw_gridding(
            paths["wkern"], paths["akern"], paths["vis"],
            n=200, outfile=out, config=imaging_config,
        )
        from ska_sdp_tpu.io import h5

        back = h5.read_dataset(out, schema.IMG_DATASET)
        np.testing.assert_allclose(back, img)


class TestVisCap:
    def test_n_cap_subsets(self, dataset, imaging_config):
        paths, obs = dataset
        mx_small, img_small = ds.w_gridding(
            paths["wkern"], paths["vis"], n=50, config=imaging_config
        )
        assert img_small.shape == (imaging_config.grid.n,) * 2
        assert np.isfinite(mx_small)


class TestOtherPipelines:
    def test_w_cache_imaging_runs_and_matches_bank_path(self, rng):
        # w_cache builds its own bank from rounded w bins; check it against
        # manually building the same bank and gridding with convgrid_wproj.
        import jax.numpy as jnp

        from ska_sdp_tpu import KernelOptions, ops
        from ska_sdp_tpu.models.imaging import w_cache_imaging

        theta, lam = 0.05, 1280
        opts = KernelOptions(qpx=2, npix_ff=64, npix_kern=9, wstep=50)
        b = 40
        uvw = np.column_stack(
            [
                rng.uniform(-0.3 * lam, 0.3 * lam, b),
                rng.uniform(-0.3 * lam, 0.3 * lam, b),
                rng.uniform(-120, 120, b),
            ]
        )
        vis = rng.standard_normal(b) + 1j * rng.standard_normal(b)
        got = w_cache_imaging(
            theta, lam, jnp.asarray(uvw), None, jnp.asarray(vis), opts=opts,
            chunk=16,
        )

        wstep = opts.wstep
        roundedw = wstep * np.round(uvw[:, 2] / wstep)
        minw = roundedw.min()
        steps = int((roundedw.max() - minw) // wstep) + 1
        centers = minw + wstep * np.arange(steps)
        bank = ops.w_kernel_bank(theta, jnp.asarray(centers), opts)
        wbin = ((roundedw - minw) // wstep).astype(np.int32)
        n = int(round(theta * lam))
        want = ops.convgrid_wproj(
            bank, jnp.zeros((n, n), jnp.complex128), jnp.asarray(uvw) / lam,
            jnp.asarray(wbin), jnp.asarray(vis), chunk=16,
        )
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-12)

    def test_w_cache_imaging_jittable_with_static_w_range(self, rng):
        # with a static w_range the whole ImagingFunction is jittable and
        # matches the host-staged path
        import jax
        import jax.numpy as jnp

        from ska_sdp_tpu import KernelOptions
        from ska_sdp_tpu.models.imaging import w_cache_imaging

        theta, lam = 0.05, 1280
        opts = KernelOptions(qpx=2, npix_ff=64, npix_kern=9, wstep=50)
        b = 40
        uvw = np.column_stack(
            [
                rng.uniform(-0.3 * lam, 0.3 * lam, b),
                rng.uniform(-0.3 * lam, 0.3 * lam, b),
                rng.uniform(-120, 120, b),
            ]
        )
        vis = rng.standard_normal(b) + 1j * rng.standard_normal(b)

        host = w_cache_imaging(
            theta, lam, jnp.asarray(uvw), None, jnp.asarray(vis), opts=opts,
            chunk=16,
        )

        wr = (float(uvw[:, 2].min()), float(uvw[:, 2].max()))

        @jax.jit
        def step(uvw_j, vis_j):
            return w_cache_imaging(
                theta, lam, uvw_j, None, vis_j, opts=opts, chunk=16,
                w_range=wr,
            )

        jitted = step(jnp.asarray(uvw), jnp.asarray(vis))
        np.testing.assert_allclose(
            np.asarray(jitted), np.asarray(host), atol=1e-12
        )

    def test_do_imaging_simple(self, rng):
        import jax.numpy as jnp

        from ska_sdp_tpu.models.imaging import do_imaging, simple_imaging

        theta, lam = 0.05, 1280
        b = 30
        uvw = jnp.asarray(rng.uniform(-0.3 * lam, 0.3 * lam, (b, 3)))
        vis = jnp.asarray(rng.standard_normal(b) + 1j * rng.standard_normal(b))
        res = do_imaging(
            theta, lam, uvw,
            jnp.zeros(b, jnp.int32), jnp.ones(b, jnp.int32),
            jnp.zeros(b), 1.0, vis, simple_imaging,
        )
        n = int(round(theta * lam))
        assert res.image.shape == (n, n)
        assert float(res.psf.max()) == pytest.approx(1.0)  # PSF normalized
        assert np.isfinite(np.asarray(res.image)).all()


class TestPredict:
    def test_predict_roundtrip_cli(self, tmp_path, rng):
        """image → predict → vis: run the full CLI predict workflow."""
        import subprocess, sys, os

        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.getcwd()
        d = str(tmp_path / "obs")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--make-data", d,
             "--nant", "6", "--ntime", "4", "--nw", "4", "--qpx", "2",
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        img = str(tmp_path / "dirty.h5")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "w",
             "-i", d, "--all", "-o", img, "--backend", "cpu",
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        out = str(tmp_path / "pred.h5")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "predict",
             "-i", d, "--all", "--model", img, "-o", out,
             "--backend", "cpu", "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        assert "peak |vis|" in r.stdout
        from ska_sdp_tpu.io import h5

        pred = np.asarray(h5.read_dataset(out, "/vis/model"))
        assert pred.ndim == 1 and pred.size > 0
        assert np.isfinite(pred).all() and np.abs(pred).max() > 0

        # IDG predict on the same model: needs no wkern file, should give
        # a prediction of the same magnitude scale as the bank path
        out2 = str(tmp_path / "pred_idg.h5")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "predict",
             "--idg", "-i", d, "--all", "--model", img, "-o", out2,
             "--backend", "cpu", "--theta", "0.05", "--lam", "1600",
             "--subgrid", "32"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        pred2 = np.asarray(h5.read_dataset(out2, "/vis/model"))
        assert pred2.shape == pred.shape
        assert np.isfinite(pred2).all() and np.abs(pred2).max() > 0
        # the two degridding realizations predict the same signal up to
        # the bank's quantization/truncation error, which at this coarse
        # synthetic bank (qpx=2, nw=4) is large per-vis — assert strong
        # correlation rather than per-sample agreement
        corr = abs(np.vdot(pred2, pred)) / (
            np.linalg.norm(pred2) * np.linalg.norm(pred)
        )
        assert corr > 0.8, corr


class TestCLIModes:
    def test_wcache_conv_gridder_flags(self, tmp_path):
        """Every BASELINE.md config is reachable from the CLI: wcache and
        conv modes; --backend gpu is effective (refused without a GPU)."""
        import subprocess, sys, os

        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.getcwd()
        d = str(tmp_path / "obs")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--make-data", d,
             "--nant", "6", "--ntime", "4", "--nw", "4", "--qpx", "2",
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        for mode in ("wcache", "conv"):
            r = subprocess.run(
                [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", mode,
                 "-i", d, "--all", "--backend", "cpu",
                 "--theta", "0.05", "--lam", "1600"],
                capture_output=True, text=True, env=env,
            )
            assert r.returncode == 0, (mode, r.stderr)
            assert "image max:" in r.stdout
        # --backend gpu must be effective: error out when no GPU is visible
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "simple",
             "-i", d, "--all", "--backend", "gpu",
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 1
        assert "--backend gpu" in r.stderr


class TestCheckpointResume:
    def test_resume_matches_single_shot(self, tmp_path, rng):
        import subprocess, sys, os

        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.getcwd()
        d = str(tmp_path / "obs")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--make-data", d,
             "--nant", "8", "--ntime", "6", "--nw", "4", "--qpx", "2",
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr

        from ska_sdp_tpu.config import GridParams, ImagingConfig
        from ska_sdp_tpu.models import dataset as ds

        cfg = ImagingConfig(grid=GridParams(theta=0.05, lam=1600),
                            precision_name="double")
        wk = os.path.join(d, "wkern.h5")
        vi = os.path.join(d, "vis.h5")
        ck = str(tmp_path / "run.ckpt.h5")

        mx0, img0 = ds.w_gridding(wk, vi, config=cfg)

        # interrupted run: one slab, then resume to completion
        mx1, img1 = ds.w_gridding_checkpointed(
            wk, vi, ck, slab=64, config=cfg, _max_slabs=1
        )
        assert mx1 is None and os.path.exists(ck)
        mx2, img2 = ds.w_gridding_checkpointed(
            wk, vi, ck, slab=64, config=cfg
        )
        assert not os.path.exists(ck)      # cleaned up on success
        np.testing.assert_allclose(img2, img0, rtol=1e-10, atol=1e-12)
        assert abs(mx2 - mx0) < 1e-10


class TestOutOfCore:
    def test_streaming_matches_in_core(self, tmp_path, rng):
        import subprocess, sys, os

        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.getcwd()
        d = str(tmp_path / "obs")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--make-data", d,
             "--nant", "8", "--ntime", "6", "--nw", "4", "--qpx", "2",
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr

        from ska_sdp_tpu.config import GridParams, ImagingConfig
        from ska_sdp_tpu.models import dataset as ds

        cfg = ImagingConfig(grid=GridParams(theta=0.05, lam=1600),
                            precision_name="double")
        wk = os.path.join(d, "wkern.h5")
        vi = os.path.join(d, "vis.h5")
        ck = str(tmp_path / "ooc.ckpt.h5")

        mx0, img0 = ds.w_gridding(wk, vi, config=cfg)
        mx1, img1 = ds.w_gridding_out_of_core(wk, vi, ck, slab=64,
                                              config=cfg)
        np.testing.assert_allclose(img1, img0, rtol=1e-10, atol=1e-12)
        assert abs(mx1 - mx0) < 1e-10


class TestCLIMissingInputs:
    def test_aw_mode_precheck_missing_akern(self, tmp_path):
        """--mode aw must fail fast on a missing akern.h5
        in the CLI existence pre-check, not deep inside ingest."""
        import os
        import subprocess
        import sys

        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.getcwd()
        d = str(tmp_path / "obs")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--make-data", d,
             "--nant", "6", "--ntime", "3", "--nw", "4", "--qpx", "2",
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        os.remove(os.path.join(d, "akern.h5"))
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "aw",
             "-i", d, "--all", "--backend", "cpu",
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 1
        assert "input file not found" in r.stderr
        assert "akern" in r.stderr


class TestDevicePhases:
    def test_device_phase_breakdown_printed(self, tmp_path):
        """--device-phases prints a per-stage device-time
        breakdown (preprocess / scatter / FFT) plus the dispatch floor."""
        import os
        import subprocess
        import sys

        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.getcwd()
        d = str(tmp_path / "obs")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--make-data", d,
             "--nant", "6", "--ntime", "3", "--nw", "4", "--qpx", "2",
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "w",
             "-i", d, "--all", "--backend", "cpu", "--device-phases",
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        for stage in ("dispatch-floor", "preprocess", "scatter",
                      "hermitian+ifft"):
            assert f"[device-phase] {stage}" in r.stdout, r.stdout
        assert "image max:" in r.stdout


class TestIDGStagedParity:
    def test_staged_fov_pad_matches_pipeline(self, dataset, imaging_config):
        """--device-phases must not change the image: the staged IDG path
        honors fov_pad exactly like the fused pipeline."""
        paths, obs = dataset
        mx_p, img_p = ds.idg_gridding(
            paths["vis"], config=imaging_config, fov_pad=0.75
        )
        mx_s, img_s = ds.idg_gridding(
            paths["vis"], config=imaging_config, fov_pad=0.75,
            device_phases=True,
        )
        assert img_s.shape == img_p.shape
        scale = np.abs(img_p).max()
        np.testing.assert_allclose(img_s, img_p, atol=1e-10 * scale)
        assert abs(mx_s - mx_p) < 1e-10 * scale


class TestAWStagedParity:
    """--device-phases covers the AW modes; the staged
    variants must be bit-compatible with the fused pipelines."""

    def test_fused_aw_staged_matches_pipeline(self, dataset, imaging_config):
        paths, obs = dataset
        mx_p, img_p = ds.aw_gridding(
            paths["wkern"], paths["akern"], paths["vis"],
            config=imaging_config,
        )
        mx_s, img_s = ds.aw_gridding(
            paths["wkern"], paths["akern"], paths["vis"],
            config=imaging_config, device_phases=True,
        )
        scale = np.abs(img_p).max()
        np.testing.assert_allclose(img_s, img_p, atol=1e-10 * scale)
        assert abs(mx_s - mx_p) < 1e-10 * scale

    def test_idg_aw_staged_matches_pipeline(self, dataset, imaging_config):
        paths, obs = dataset
        mx_p, img_p = ds.aw_gridding(
            paths["wkern"], paths["akern"], paths["vis"],
            config=imaging_config, idg=True, fov_pad=0.75,
        )
        mx_s, img_s = ds.aw_gridding(
            paths["wkern"], paths["akern"], paths["vis"],
            config=imaging_config, idg=True, fov_pad=0.75,
            device_phases=True,
        )
        assert img_s.shape == img_p.shape
        scale = np.abs(img_p).max()
        np.testing.assert_allclose(img_s, img_p, atol=1e-10 * scale)
        assert abs(mx_s - mx_p) < 1e-10 * scale

    def test_cli_aw_device_phases_printed(self, tmp_path):
        """--device-phases --mode aw prints the fused-AW stage breakdown
        (and --idg the IDG-AW one)."""
        import os
        import subprocess
        import sys

        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.getcwd()
        d = str(tmp_path / "obs")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--make-data", d,
             "--nant", "6", "--ntime", "3", "--nw", "4", "--qpx", "2",
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "aw",
             "-i", d, "--all", "--backend", "cpu", "--device-phases",
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        for stage in ("dispatch-floor", "preprocess", "aw-grid",
                      "hermitian+ifft"):
            assert f"[device-phase] {stage}" in r.stdout, r.stdout
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "aw",
             "--idg", "-i", d, "--all", "--backend", "cpu",
             "--device-phases", "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        for stage in ("dispatch-floor", "preprocess",
                      "hermitian+ifft+taper"):
            assert f"[device-phase] {stage}" in r.stdout, r.stdout
        assert "[device-phase] idg-aw-grid" in r.stdout, r.stdout


class TestRecordOrder:
    """IDG-AW groups records by (pair, uv tile) with stable sorts, so the
    file's time-major raster and its pair-major transpose grid the same
    chunks: identical images and drop counts."""

    def _pair_major(self, data):
        n = data.vis.shape[0]
        nbl = int(np.argmax(data.time != data.time[0]))
        return np.arange(n).reshape(n // nbl, nbl).T.ravel()

    def test_pair_major_is_a_permutation(self, dataset):
        paths, obs = dataset
        data = ds.load_vis_data(paths["vis"])
        perm = self._pair_major(data)
        assert np.array_equal(np.sort(perm), np.arange(data.vis.shape[0]))
        a = data.antenna1[perm] * 1000 + data.antenna2[perm]
        assert np.all(np.diff(a) >= 0)        # pair-major: pairs sorted

    def test_pipeline_transpose_invariance(self, dataset, imaging_config):
        """A pair-major transpose only reorders the record stream; the
        image must be identical (gridding is an order-invariant sum)."""
        paths, obs = dataset
        data = ds.load_vis_data(paths["vis"])
        from ska_sdp_tpu.ops.idg_aw import aw_screens_host

        ak = ds.get_akernels(paths["akern"], CFG.theta,
                             float(data.time[0]), data.frequency)
        scr = aw_screens_host(np.asarray(ak, np.complex64), 64)
        kw = dict(theta=CFG.theta, lam=CFG.lam, max_runs=4096)
        out = [ds._aw_idg_pipeline(
            scr.astype(np.complex64),
            np.asarray(data.uvw[o], np.float32),
            np.asarray(data.antenna1[o], np.int32),
            np.asarray(data.antenna2[o], np.int32),
            np.asarray(data.frequency, np.float32),
            np.asarray(data.vis[o], np.complex64), **kw)
            for o in (slice(None), self._pair_major(data))]
        np.testing.assert_allclose(
            np.asarray(out[1][0]), np.asarray(out[0][0]),
            atol=1e-5 * float(np.abs(np.asarray(out[0][0])).max()))
        assert int(out[0][2]) == int(out[1][2])


class TestDumpIntermediates:
    def test_debug_dump_tree(self, tmp_path):
        """--dump-intermediates writes the uv-grid planes + image (the
        reference's GridTesting convolveTest.h5 dumps, asserted)."""
        import os
        import subprocess
        import sys

        import h5py

        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.getcwd()
        d = str(tmp_path / "obs")
        subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--make-data", d,
             "--nant", "6", "--ntime", "3", "--nw", "4", "--qpx", "2",
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env, check=True,
        )
        dbg = str(tmp_path / "dbg.h5")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "w",
             "-i", d, "--all", "--backend", "cpu",
             "--dump-intermediates", dbg,
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        with h5py.File(dbg, "r") as f:
            n = 80
            assert f["/debug/uvgrid_re"].shape == (n, n)
            assert f["/debug/uvgrid_im"].shape == (n, n)
            assert f["/debug/img"].shape == (n, n)
            import numpy as np

            assert np.isfinite(np.asarray(f["/debug/img"])).all()


class TestAWIDGPipeline:
    @pytest.fixture(scope="class")
    def track_dataset(self, tmp_path_factory):
        # denser time sampling than the module dataset: IDG-AW chunks a
        # pair's records together, so per-chunk uv spread must stay small
        cfg = SyntheticConfig(
            theta=0.05, lam=3600, nant=6, ntime=48, nsources=3,
            nw_planes=4, qpx=4, npix_ff=128, npix_kern=15, seed=11,
        )
        d = tmp_path_factory.mktemp("tracks")
        paths, obs = generate_dataset(str(d), cfg)
        return paths, obs

    def test_aw_idg_close_to_fused_aw(self, track_dataset, imaging_config):
        """IDG-AW vs the spectral-convolution AW path on the same
        observation.  The synthetic akerns carry FULL-STAMP 1% noise,
        whose convolution with the 15-tap w-kernel the reference path
        TRUNCATES (measured ~0.4 of the noise term — see
        tests/test_idg.py::test_matches_bank_aw_scatter); IDG-AW keeps
        it, so the images differ by ~the truncated noise energy (~15%
        here).  Tight parity with compact akerns is asserted in
        test_idg.py; this test pins the end-to-end wiring + physics."""
        paths, obs = track_dataset
        from ska_sdp_tpu.utils.timing import PhaseTimer

        mx_aw, img_aw = ds.aw_gridding(
            paths["wkern"], paths["akern"], paths["vis"],
            config=imaging_config,
        )
        t = PhaseTimer()
        mx_idg, img_idg = ds.aw_gridding(
            paths["wkern"], paths["akern"], paths["vis"],
            config=imaging_config, idg=True, timer=t,
        )
        assert t.counters.get("idg_aw/dropped") == 0.0
        scale = np.abs(img_aw).max()
        assert np.abs(img_idg - img_aw).max() < 0.25 * scale
        assert mx_idg > 0

    def test_aw_idg_sources_recovered(self, track_dataset, imaging_config):
        paths, obs = track_dataset
        _, img = ds.aw_gridding(
            paths["wkern"], paths["akern"], paths["vis"],
            config=imaging_config, idg=True,
        )
        n = img.shape[0]
        for l, m, flux in obs["sources"]:
            iy = int(round(n / 2 + m * 3600))
            ix = int(round(n / 2 + l * 3600))
            window = img[max(0, iy - 2): iy + 3, max(0, ix - 2): ix + 3]
            assert window.max() > 0.25 * img.max(), (l, m, flux)

    def test_cli_aw_idg_needs_no_wkern(self, track_dataset, tmp_path):
        """--mode aw --idg runs without wkern.h5 (the screens replace the
        w-kernel bank entirely)."""
        import os
        import shutil
        import subprocess
        import sys

        paths, _ = track_dataset
        d = str(tmp_path / "obs")
        os.makedirs(d)
        shutil.copy(paths["vis"], os.path.join(d, "vis.h5"))
        shutil.copy(paths["akern"], os.path.join(d, "akern.h5"))
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.getcwd()
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "aw",
             "--idg", "-i", d, "--all", "--backend", "cpu",
             "--theta", "0.05", "--lam", "3600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        assert "image max:" in r.stdout
        assert "warning: IDG-AW dropped" not in r.stderr


class TestAWPredict:
    def test_aw_predict_delta_equals_idg_predict(self, dataset,
                                                 imaging_config, tmp_path):
        """With delta A-kernels the IDG-AW adjoint reduces to plain IDG
        degridding — aw_predict == idg_predict at the same subgrid."""
        import h5py

        paths, obs = dataset
        # model image from a w-projection run
        model = str(tmp_path / "model.h5")
        ds.w_gridding(paths["wkern"], paths["vis"], outfile=model,
                      config=imaging_config)
        # delta akern file (one time/freq slot per antenna)
        from ska_sdp_tpu.io import h5, schema

        afile = str(tmp_path / "akern_delta.h5")
        h5.create_file(afile)
        s = 15
        k = np.zeros((s, s), np.complex128)
        k[s // 2, s // 2] = 1.0
        data = ds.load_vis_data(paths["vis"])
        t0 = schema.fmt_float(float(data.time[0]))
        f0 = schema.fmt_float(data.frequency)
        for ant in range(8):
            h5.write_dataset(
                afile, schema.akern_dataset(CFG.theta, str(ant), t0, f0), k)

        pred_aw, peak_aw = ds.aw_predict(
            afile, paths["vis"], model, config=imaging_config, subgrid=64)
        pred_idg, peak_idg = ds.idg_predict(
            paths["vis"], model, config=imaging_config, subgrid=64)
        # the two degridders share the operator but not the subgrid
        # geometry (pair-tile chunks vs fixed tiling): each carries its
        # own ~1e-3-class subgrid-aliasing term, amplified by the 1/taper²
        # model division at the image edges — agreement is method-level,
        # not bitwise (measured ~8e-3).  Exactness of the AW adjoint
        # itself is pinned by test_idg.py::TestIDGAWDegrid.
        rel = (np.linalg.norm(pred_aw - pred_idg)
               / np.linalg.norm(pred_idg))
        assert rel < 0.03, rel
        assert abs(peak_aw - peak_idg) / peak_idg < 0.05

    def test_predict_fov_pad_drivers(self, dataset, imaging_config,
                                     tmp_path):
        """The predict direction accepts fov_pad.  With an
        interior-dominated model the padded and plain operators agree at
        method level (edge accuracy itself is pinned by
        test_idg.py::TestIDGPredictFovPad); the IDG-AW driver resamples
        its screens at the padded scale."""
        import h5py

        paths, obs = dataset
        model = str(tmp_path / "model.h5")
        ds.w_gridding(paths["wkern"], paths["vis"], outfile=model,
                      config=imaging_config)
        pred_plain, _ = ds.idg_predict(
            paths["vis"], model, config=imaging_config, subgrid=64)
        pred_pad, _ = ds.idg_predict(
            paths["vis"], model, config=imaging_config, subgrid=64,
            fov_pad=0.75)
        rel = (np.linalg.norm(pred_pad - pred_plain)
               / np.linalg.norm(pred_plain))
        assert rel < 0.03, rel

        # IDG-AW predict with delta screens + fov_pad stays consistent
        from ska_sdp_tpu.io import h5, schema

        afile = str(tmp_path / "akern_delta.h5")
        h5.create_file(afile)
        s = 15
        k = np.zeros((s, s), np.complex128)
        k[s // 2, s // 2] = 1.0
        data = ds.load_vis_data(paths["vis"])
        t0 = schema.fmt_float(float(data.time[0]))
        f0 = schema.fmt_float(data.frequency)
        for ant in range(8):
            h5.write_dataset(
                afile, schema.akern_dataset(CFG.theta, str(ant), t0, f0), k)
        pred_aw_pad, peak = ds.aw_predict(
            afile, paths["vis"], model, config=imaging_config, subgrid=64,
            fov_pad=0.75)
        assert np.isfinite(peak) and peak > 0
        rel = (np.linalg.norm(pred_aw_pad - pred_pad)
               / np.linalg.norm(pred_pad))
        assert rel < 0.03, rel

    def test_cli_predict_aterms(self, dataset, tmp_path):
        import os
        import shutil
        import subprocess
        import sys

        paths, _ = dataset
        d = str(tmp_path / "obs")
        os.makedirs(d)
        for k in ("vis", "wkern", "akern"):
            shutil.copy(paths[k], os.path.join(d, f"{k}.h5"))
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.getcwd()
        model = str(tmp_path / "model.h5")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "w",
             "-i", d, "--all", "--backend", "cpu", "-o", model,
             "--theta", "0.05", "--lam", "3600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "predict",
             "--idg", "--aterms", "-i", d, "--all", "--model", model,
             "--backend", "cpu", "--theta", "0.05", "--lam", "3600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        assert "peak |vis|:" in r.stdout
        # --aterms without --idg: clean error
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "predict",
             "--aterms", "-i", d, "--all", "--model", model,
             "--backend", "cpu", "--theta", "0.05", "--lam", "3600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 1
        assert "--aterms requires" in r.stderr
