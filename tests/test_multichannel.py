"""Multi-channel (spectral-cube) imaging: every channel at its own frequency.

The reference reads the whole ``/vis/frequency`` vector but images only
channel 0 (``/root/reference/src/ImageDataset.hs:99-106``).  The
multi-channel drivers (``models/spectral.py``) image EVERY channel at
its own frequency, with uniform weights shared per channel group.

Contracts asserted here:

1. ``plan_channel_groups`` covers all channels with contiguous groups
   whose per-channel coordinate drift fits the slack.
2. Group pipelines: a channel at ratio r is gridded at its dilated
   coordinates — its image equals the single-channel pipeline run at
   f_ref·r — and IDG-AW chunking drops are counted per channel.
3. Driver-level: every channel of the cube matches a single-channel run
   of the same pipeline on a file holding only that channel.
4. The CLI ``--channels N`` path writes ``/img_cube`` [nch, n, n] with
   ``/img`` the channel mean.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_tpu.config import GridParams, ImagingConfig
from ska_sdp_tpu.io import h5, schema
from ska_sdp_tpu.io.synthetic import (
    SyntheticConfig,
    generate_dataset,
    write_vis_file,
)
from ska_sdp_tpu.models import dataset as ds
from ska_sdp_tpu.models import spectral

N, THETA = 256, 0.05


# ---------------------------------------------------------------------------
# group planning
# ---------------------------------------------------------------------------


class TestPlanChannelGroups:
    def test_narrowband_single_group(self):
        # span 1.5e6 Hz about f_ref -> max|r-1|*ext ~ 4.98 cells <= 6
        freqs = 1.5e8 + 1e5 * np.arange(16)
        groups = spectral.plan_channel_groups(freqs, 1000.0, 6.0)
        assert len(groups) == 1
        i, j, f_ref, drift = groups[0]
        assert (i, j) == (0, 16)
        assert drift <= 6

    def test_wideband_splits_and_tiles(self):
        # 40% fractional bandwidth over 32 channels, 100-cell lever arm
        freqs = 1.5e8 * (1.0 + 0.4 * np.arange(32) / 31)
        ext, slack = 100.0, 3.0
        groups = spectral.plan_channel_groups(freqs, ext, slack)
        assert len(groups) > 1
        # contiguous exact tiling of [0, nch)
        stops = [0] + [g[1] for g in groups]
        starts = [g[0] for g in groups] + [32]
        assert stops == starts
        # every group honors the drift bound it reports
        for i, j, f_ref, drift in groups:
            d = np.max(np.abs(freqs[i:j] / f_ref - 1.0)) * ext
            assert d <= slack + 1e-9
            assert drift >= int(np.floor(d))

    def test_degenerate_single_channel_groups(self):
        # drift bound unsatisfiable -> every channel its own group
        freqs = np.array([1.0e8, 2.0e8, 3.0e8])
        groups = spectral.plan_channel_groups(freqs, 1e6, 1.0)
        assert [(g[0], g[1]) for g in groups] == [(0, 1), (1, 2), (2, 3)]


# ---------------------------------------------------------------------------
# group pipelines: channel dilation == a run at the channel's own frequency
# ---------------------------------------------------------------------------

C_LIGHT = 299792458.0
F_REF = 1.5e8


def _track_records(rng, nant=4, ntime=48):
    """Baseline-track records in metres (time-major), for the IDG-AW
    pair-chunking; uv stays inside ±0.3 of the grid at F_REF."""
    pairs = [(i, j) for i in range(nant) for j in range(i + 1, nant)]
    nbl = len(pairs)
    scale = N / THETA * C_LIGHT / F_REF          # lam in metres
    u0 = rng.uniform(-0.25, 0.25, (nbl, 2)) * scale
    du = rng.uniform(-15.0 / N, 15.0 / N, (nbl, 2)) * scale
    w0 = rng.uniform(-250.0, 250.0, nbl) * C_LIGHT / F_REF
    rows = []
    for t in range(ntime):
        for b, (i, j) in enumerate(pairs):
            uv = u0[b] + du[b] * t / ntime
            rows.append((uv[0], uv[1], w0[b], i, j))
    arr = np.asarray(rows)
    vis = (rng.standard_normal(arr.shape[0])
           + 1j * rng.standard_normal(arr.shape[0]))
    return (arr[:, :3].astype(np.float32), arr[:, 3].astype(np.int32),
            arr[:, 4].astype(np.int32), vis.astype(np.complex64))


def _channel_args(vis, r):
    return (np.asarray([r], np.float32),
            np.asarray(vis.real, np.float32)[None],
            np.asarray(vis.imag, np.float32)[None])


class TestChannelRecordUpdate:
    """A channel at ratio r = f_c/f_ref is gridded at its dilated
    coordinates (uv·r, w·r about the grid center): with per-channel
    weights its image equals the single-channel pipeline run at f_c."""

    LAM = int(round(N / THETA))

    @pytest.mark.parametrize("r", [0.97, 1.0, 1.02])
    def test_idg_channel_equals_own_frequency_run(self, rng, r):
        uvw, _, _, vis = _track_records(rng)
        img, masked = spectral._idg_multi_pipeline(
            uvw, np.float32(F_REF), *_channel_args(vis, r), theta=THETA,
            lam=self.LAM, g=1, subgrid=32, exact_weights=True)
        want, _ = ds._idg_pipeline(
            uvw, np.float32(F_REF * r), vis, theta=THETA, lam=self.LAM,
            subgrid=32, taper_beta=12.0)
        assert int(np.asarray(masked)[0]) == 0
        # central 75% FOV (the taper division amplifies rounding at the
        # edges); uv·r and uv at f·r differ by float32 rounding, ~1e-5
        assert _crop_rel(np.asarray(img)[0], np.asarray(want), N) < 1e-4

    @pytest.mark.parametrize("r", [0.97, 1.0, 1.02])
    def test_idg_aw_channel_equals_own_frequency_run(self, rng, r):
        from ska_sdp_tpu.ops.idg_aw import aw_screens_host

        uvw, a1, a2, vis = _track_records(rng)
        ak = np.zeros((4, 15, 15), np.complex64)
        ak[:, 7, 7] = 1.0
        ak[:, 6:9, 6:9] += 0.05 * rng.standard_normal((4, 3, 3))
        scr = aw_screens_host(ak, 64).astype(np.complex64)
        img, nd = spectral._idg_aw_multi_pipeline(
            scr, uvw, a1, a2, np.float32(F_REF), *_channel_args(vis, r),
            theta=THETA, lam=self.LAM, g=1, subgrid=64, max_runs=1024,
            exact_weights=True)
        want, _, nd_want = ds._aw_idg_pipeline(
            scr, uvw, a1, a2, np.float32(F_REF * r), vis, theta=THETA,
            lam=self.LAM, subgrid=64, max_runs=1024)
        assert int(np.asarray(nd)[0]) == int(nd_want) == 0
        # central 75% FOV (the taper division amplifies rounding at the
        # edges); uv·r and uv at f·r differ by float32 rounding, ~1e-5
        assert _crop_rel(np.asarray(img)[0], np.asarray(want), N) < 1e-4

    def test_drift_overflow_masked_and_counted(self, rng):
        """A run bound too small for a channel's records drops and
        COUNTS them per channel, exactly as the single-channel op does
        at that channel's coordinates."""
        from ska_sdp_tpu.ops.idg_aw import aw_screens_host, idg_grid_aw

        uvw, a1, a2, vis = _track_records(rng)
        ak = np.zeros((4, 15, 15), np.complex64)
        ak[:, 7, 7] = 1.0
        scr = aw_screens_host(ak, 64).astype(np.complex64)
        ratios = np.asarray([0.98, 1.03], np.float32)
        _, nd = spectral._idg_aw_multi_pipeline(
            scr, uvw, a1, a2, np.float32(F_REF), ratios,
            np.stack([vis.real, vis.real]).astype(np.float32),
            np.stack([vis.imag, vis.imag]).astype(np.float32),
            theta=THETA, lam=self.LAM, g=2, subgrid=64, max_runs=3)
        nd = np.asarray(nd)
        assert np.all(nd > 0)
        uvw0 = uvw.astype(np.float64) * F_REF / C_LIGHT
        for c, r in enumerate(ratios):
            m = np.where(uvw0[:, 1:2] < 0, -uvw0, uvw0) * r
            _, nd_c = idg_grid_aw(
                (N, N), jnp.asarray(m / self.LAM, jnp.float32),
                jnp.asarray(a1), jnp.asarray(a2),
                jnp.asarray(m[:, 2], jnp.float32), jnp.asarray(vis),
                jnp.asarray(scr), theta=THETA, subgrid=64, max_runs=3)
            assert abs(int(nd[c]) - int(nd_c)) <= 2, (c, nd, int(nd_c))

# ---------------------------------------------------------------------------
# driver-level: cube channels == single-channel runs
# ---------------------------------------------------------------------------


CFG = SyntheticConfig(
    theta=0.05, lam=3600, nant=6, ntime=48, nsources=3, nw_planes=4,
    qpx=4, npix_ff=128, npix_kern=15, seed=11, nchan=4, chan_bw=2.0e6,
)


@pytest.fixture(scope="module")
def spectral_dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("spectral")
    paths, obs = generate_dataset(str(d), CFG)
    # per-channel single-channel files: the parity reference
    chan_files = []
    for c in range(CFG.nchan):
        o = dict(obs)
        o["vis"] = obs["vis"][:, :, c:c + 1]
        o["frequency"] = obs["frequency"][c:c + 1]
        pth = os.path.join(str(d), f"vis_c{c}.h5")
        write_vis_file(pth, o)
        chan_files.append(pth)
    return paths, obs, chan_files


@pytest.fixture(scope="module")
def imaging_config():
    return ImagingConfig(
        grid=GridParams(theta=CFG.theta, lam=CFG.lam),
        precision_name="double",
    )


def _crop_rel(a, b, n_grid):
    cr = n_grid // 8
    d = (a - b)[cr:-cr, cr:-cr]
    return np.linalg.norm(d) / np.linalg.norm(b[cr:-cr, cr:-cr])


class TestSpectralDrivers:
    def test_synthetic_frequency_vector(self, spectral_dataset):
        _, obs, _ = spectral_dataset
        assert obs["frequency"].shape == (CFG.nchan,)
        assert obs["vis"].shape[2] == CFG.nchan
        np.testing.assert_allclose(np.diff(obs["frequency"]), CFG.chan_bw)

    def test_narrowband_plans_one_group(self, spectral_dataset):
        """The parity runs below must actually exercise the shared-binning
        path: assert the plan is a single group."""
        _, obs, _ = spectral_dataset
        n_grid = int(round(CFG.theta * CFG.lam))
        ext = spectral.uv_extent_cells(
            obs["uvw"], float(obs["frequency"][-1]), CFG.lam, n_grid)
        groups = spectral.plan_channel_groups(obs["frequency"], ext, 7.0)
        assert len(groups) == 1

    def test_idg_cube_matches_single_channel_runs(self, spectral_dataset,
                                                  imaging_config,
                                                  monkeypatch):
        # bit-parity with per-channel single-channel runs requires the
        # per-channel weight histograms; the DEFAULT multi-channel
        # weighting shares the group-reference histogram (the standard
        # combined-density uniform weighting -- _weights_multi)
        monkeypatch.setenv("SKA_SDP_TPU_EXACT_WEIGHTS", "1")
        paths, obs, chan_files = spectral_dataset
        n_grid = int(round(CFG.theta * CFG.lam))
        mx, img, cube = spectral.idg_gridding_multi(
            paths["vis"], CFG.nchan, config=imaging_config)
        assert cube.shape == (CFG.nchan, n_grid, n_grid)
        for c, f in enumerate(chan_files):
            _, img1 = ds.idg_gridding(f, config=imaging_config)
            assert _crop_rel(cube[c], img1, n_grid) < 1e-10, c
        np.testing.assert_allclose(img, cube.mean(axis=0))
        assert mx == pytest.approx(float(img.max()))

    def test_w_cube_matches_single_channel_runs(self, spectral_dataset,
                                                imaging_config,
                                                monkeypatch):
        monkeypatch.setenv("SKA_SDP_TPU_EXACT_WEIGHTS", "1")
        paths, obs, chan_files = spectral_dataset
        mx, img, cube = spectral.w_gridding_multi(
            paths["wkern"], paths["vis"], CFG.nchan, config=imaging_config)
        for c, f in enumerate(chan_files):
            _, img1 = ds.w_gridding(paths["wkern"], f,
                                    config=imaging_config)
            rel = (np.linalg.norm(cube[c] - img1)
                   / np.linalg.norm(img1))
            assert rel < 1e-10, (c, rel)

    def test_aw_idg_cube_matches_single_channel_runs(self, spectral_dataset,
                                                     imaging_config,
                                                     monkeypatch):
        monkeypatch.setenv("SKA_SDP_TPU_EXACT_WEIGHTS", "1")
        paths, obs, chan_files = spectral_dataset
        n_grid = int(round(CFG.theta * CFG.lam))
        mx, img, cube = spectral.aw_idg_gridding_multi(
            paths["akern"], paths["vis"], CFG.nchan, config=imaging_config)
        for c, f in enumerate(chan_files):
            _, img1 = ds.aw_gridding(paths["wkern"], paths["akern"], f,
                                     config=imaging_config, idg=True)
            assert _crop_rel(cube[c], img1, n_grid) < 1e-10, c

    def test_default_shared_weights_close_to_exact(self, spectral_dataset,
                                                    imaging_config,
                                                    monkeypatch):
        """DEFAULT weighting shares the group-reference density histogram
        (combined uniform weighting, the CASA/WSClean convention for
        multi-channel data); per-channel-exact is env-gated.  The two
        agree on the image to the weighting convention's own tolerance
        at this narrowband spacing, and the cube stays finite."""
        paths, _, _ = spectral_dataset
        _, _, cube = spectral.idg_gridding_multi(
            paths["vis"], CFG.nchan, config=imaging_config)
        assert np.all(np.isfinite(cube))
        monkeypatch.setenv("SKA_SDP_TPU_EXACT_WEIGHTS", "1")
        _, _, cube_x = spectral.idg_gridding_multi(
            paths["vis"], CFG.nchan, config=imaging_config)
        rel = (np.linalg.norm(cube - cube_x)
               / np.linalg.norm(cube_x))
        assert rel < 0.5, rel    # same field, same peaks; weighting-level

    def test_output_file_layout(self, spectral_dataset, imaging_config,
                                tmp_path):
        paths, _, _ = spectral_dataset
        out = str(tmp_path / "cube.h5")
        mx, img, cube = spectral.idg_gridding_multi(
            paths["vis"], CFG.nchan, outfile=out, config=imaging_config)
        got_img = h5.read_dataset(out, schema.IMG_DATASET)
        got_cube = h5.read_dataset(out, schema.IMG_CUBE_DATASET)
        np.testing.assert_allclose(got_img, img)
        np.testing.assert_allclose(got_cube, cube)

    def test_channels_spectrally_distinct(self, spectral_dataset,
                                          imaging_config):
        """Different frequencies genuinely produce different images (the
        cube is not nch copies of channel 0)."""
        paths, _, _ = spectral_dataset
        _, _, cube = spectral.idg_gridding_multi(
            paths["vis"], CFG.nchan, config=imaging_config)
        d = np.linalg.norm(cube[0] - cube[-1]) / np.linalg.norm(cube[0])
        assert d > 1e-4


class TestStreamingChannelZero:
    """The single-channel STREAMING paths must keep the reference's
    channel-0 semantics on multi-channel files — record counts exclude
    the channel axis (regression: n was computed as ntime*nbl*nch and the
    uvw slab reads ran off the end of the file)."""

    def test_out_of_core_matches_in_core_on_multichannel_file(
            self, spectral_dataset, imaging_config, tmp_path):
        paths, obs, _ = spectral_dataset
        mx_i, img_i = ds.w_gridding(paths["wkern"], paths["vis"],
                                    config=imaging_config)
        mx_o, img_o = ds.w_gridding_out_of_core(
            paths["wkern"], paths["vis"], str(tmp_path / "ooc.ckpt"),
            slab=100, config=imaging_config)
        np.testing.assert_allclose(img_o, img_i, rtol=1e-9, atol=1e-12)

    def test_sharded_ingest_reads_channel_zero(self, spectral_dataset):
        from jax.sharding import Mesh

        from ska_sdp_tpu.parallel.ingest import load_vis_sharded

        paths, obs, _ = spectral_dataset
        mesh = Mesh(np.array(jax.devices()), ("v",))
        uvw, vis, freq = load_vis_sharded(paths["vis"], mesh)
        data = ds.load_vis_data(paths["vis"])
        n = vis.shape[0]
        assert n == data.vis.shape[0] - data.vis.shape[0] % 8
        np.testing.assert_allclose(np.asarray(vis), data.vis[:n])
        np.testing.assert_allclose(np.asarray(uvw), data.uvw[:n])
        assert freq == float(data.frequency)


class TestShardedSpectral:
    """Multi-chip spectral driver: vis-parallel within
    each channel group, per-channel partial grids psum'd over the mesh."""

    def test_sharded_cube_matches_local_driver(self, spectral_dataset,
                                               imaging_config):
        paths, obs, _ = spectral_dataset
        n_grid = int(round(CFG.theta * CFG.lam))
        n = obs["n"] - 3          # not a mesh multiple: exercises the
        #                           zero-weight mask padding
        mx_l, img_l, cube_l = spectral.idg_gridding_multi(
            paths["vis"], CFG.nchan, n=n, config=imaging_config)
        mx_s, img_s, cube_s = spectral.idg_gridding_multi_sharded(
            paths["vis"], CFG.nchan, n=n, config=imaging_config)
        assert cube_s.shape == cube_l.shape
        for c in range(CFG.nchan):
            assert _crop_rel(cube_s[c], cube_l[c], n_grid) < 1e-8, c
        assert mx_s == pytest.approx(mx_l, rel=1e-8)

    def test_sharded_step_group_weight_parity(self, spectral_dataset,
                                              imaging_config):
        """The step's psum'd masked histogram reproduces the local
        group-shared doweight exactly (padded records weightless)."""
        from ska_sdp_tpu.parallel.mesh import make_mesh
        from ska_sdp_tpu.parallel.sharded import (
            make_sharded_spectral_idg_step)

        paths, obs, _ = spectral_dataset
        prec = imaging_config.precision
        n = 8 * 40
        f_ref = float(np.mean(obs["frequency"][:2]))
        ratios = (obs["frequency"][:2] / f_ref).astype(prec.np_real)
        vis_mc = obs["vis"][:, :, :2].reshape(-1, 2).T[:, :n]
        uvw = np.asarray(obs["uvw"][:n], prec.np_real)
        step = make_sharded_spectral_idg_step(
            make_mesh(), CFG.theta, CFG.lam, g=2, subgrid=32)
        cube = np.asarray(step(
            jnp.asarray(uvw), jnp.ones((n,), prec.np_real),
            jnp.asarray(f_ref, prec.np_real), jnp.asarray(ratios),
            jnp.asarray(vis_mc.real.astype(prec.np_real)),
            jnp.asarray(vis_mc.imag.astype(prec.np_real))))
        ref, _ = spectral._idg_multi_pipeline(
            jnp.asarray(uvw), np.asarray(f_ref, prec.np_real),
            jnp.asarray(ratios),
            jnp.asarray(vis_mc.real.astype(prec.np_real)),
            jnp.asarray(vis_mc.imag.astype(prec.np_real)),
            theta=CFG.theta, lam=CFG.lam, g=2, subgrid=32,
            exact_weights=False)
        n_grid = int(round(CFG.theta * CFG.lam))
        for c in range(2):
            assert _crop_rel(cube[c], np.asarray(ref)[c], n_grid) < 1e-8


class TestCLIChannels:
    def test_cli_images_four_channels(self, tmp_path):
        import subprocess
        import sys

        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.getcwd()
        d = str(tmp_path / "obs")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--make-data", d,
             "--nant", "6", "--ntime", "8", "--nw", "4", "--qpx", "2",
             "--theta", "0.05", "--lam", "1600", "--nchan", "4"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        out = str(tmp_path / "cube.h5")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "idg",
             "-i", d, "--all", "--backend", "cpu", "--channels", "4",
             "-o", out, "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        assert "imaged 4 channels" in r.stdout
        cube = h5.read_dataset(out, schema.IMG_CUBE_DATASET)
        img = h5.read_dataset(out, schema.IMG_DATASET)
        assert cube.shape == (4, 80, 80)
        # CLI default precision is single: /img is the f32 channel mean
        np.testing.assert_allclose(img, cube.mean(axis=0),
                                   rtol=1e-5, atol=1e-6)

    def test_cli_distributed_channels(self, tmp_path):
        """``--distributed --mode idg --channels 2`` runs the sharded
        spectral driver over the 8-device virtual mesh
        and matches the single-device CLI run."""
        import subprocess
        import sys

        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env["PYTHONPATH"] = os.getcwd()
        d = str(tmp_path / "obs")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--make-data", d,
             "--nant", "6", "--ntime", "8", "--nw", "4", "--qpx", "2",
             "--theta", "0.05", "--lam", "1600", "--nchan", "2"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        out_s = str(tmp_path / "cube_sharded.h5")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "idg",
             "-i", d, "--all", "--backend", "cpu", "--channels", "2",
             "--distributed", "-o", out_s, "--theta", "0.05",
             "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        assert "8 device(s)" in r.stdout
        assert "imaged 2 channels" in r.stdout
        out_l = str(tmp_path / "cube_local.h5")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "idg",
             "-i", d, "--all", "--backend", "cpu", "--channels", "2",
             "-o", out_l, "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        cube_s = h5.read_dataset(out_s, schema.IMG_CUBE_DATASET)
        cube_l = h5.read_dataset(out_l, schema.IMG_CUBE_DATASET)
        assert cube_s.shape == cube_l.shape == (2, 80, 80)
        for c in range(2):
            assert _crop_rel(cube_s[c], cube_l[c], 80) < 1e-4

    def test_cli_distributed_single_channel_idg(self, tmp_path):
        """``--distributed --mode idg`` (single channel) runs the sharded
        IDG step end-to-end from the CLI."""
        import subprocess
        import sys

        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env["PYTHONPATH"] = os.getcwd()
        d = str(tmp_path / "obs")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--make-data", d,
             "--nant", "6", "--ntime", "8", "--nw", "4", "--qpx", "2",
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--mode", "idg",
             "-i", d, "--all", "--backend", "cpu", "--distributed",
             "--subgrid", "32", "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        assert "image max:" in r.stdout
