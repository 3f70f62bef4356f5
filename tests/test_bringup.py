"""What running on a GPU machine needs: backend choice, the start line,
the compile cache, HDF5 without h5py, the smoke script's truth and its
refusal without a GPU, and the array-level drivers."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from ska_sdp_tpu import cli
from ska_sdp_tpu.io import synthetic
from ska_sdp_tpu.models import dataset as ds
from ska_sdp_tpu.utils import cache, oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = synthetic.SyntheticConfig(theta=0.05, lam=3600, nant=6, ntime=4,
                                  nw_planes=4, qpx=2, npix_ff=64, seed=3)


def _env(**kw):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env.update(kw)
    return env


@pytest.fixture(scope="module")
def small_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("small")
    paths, obs = synthetic.generate_dataset(str(d), SMALL)
    return d, paths, obs


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------


class TestCompileCache:
    def test_env_var_is_used_exactly(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.compile_cache_dir() == str(tmp_path)

    def test_fixed_checkout_directory_otherwise(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = cache.compile_cache_dir()
        assert path == os.path.join(REPO, ".jax_cache")
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()

    def test_enable_sets_jax_config(self, monkeypatch, tmp_path):
        old = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        try:
            assert cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        finally:
            jax.config.update("jax_compilation_cache_dir", old)


# ---------------------------------------------------------------------------
# CLI backend, start line, removed options
# ---------------------------------------------------------------------------


class TestCLIBackend:
    def test_backend_gpu_refused_without_gpu(self, capsys, small_files):
        d, _, _ = small_files
        rc = cli.main(["--mode", "simple", "-i", str(d), "--all",
                       "--backend", "gpu", "--theta", "0.05",
                       "--lam", "3600"])
        assert rc == 1
        assert "--backend gpu requested" in capsys.readouterr().err

    def test_start_line_names_the_device(self, capsys, small_files):
        d, _, _ = small_files
        old = jax.config.jax_compilation_cache_dir
        try:
            rc = cli.main(["--mode", "idg", "-i", str(d), "--all",
                           "--theta", "0.05", "--lam", "3600"])
        finally:                    # the CLI enables the compile cache
            jax.config.update("jax_compilation_cache_dir", old)
        assert rc == 0
        out = capsys.readouterr().out
        dev = jax.devices()[0]
        assert (f"start imaging on {dev.platform} ({dev.device_kind}) "
                f"x{len(jax.devices())}") in out

    @pytest.mark.parametrize("argv", [
        ["--gridder", "xla"],
        ["--gridder", "pallas"],
        ["--gridder", "auto"],
    ])
    def test_removed_options_rejected(self, capsys, argv):
        with pytest.raises(SystemExit) as e:
            cli.build_parser().parse_args(argv)
        assert e.value.code == 2


# ---------------------------------------------------------------------------
# HDF5 without h5py
# ---------------------------------------------------------------------------

_BLOCK_H5PY = (
    "import sys\n"
    "class _Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name == 'h5py' or name.startswith('h5py.'):\n"
    "            raise ImportError('h5py blocked')\n"
    "sys.meta_path.insert(0, _Block())\n"
)


class TestHDF5WithoutH5py:
    def test_main_path_imports_without_h5py(self):
        code = _BLOCK_H5PY + (
            "import ska_sdp_tpu.cli, ska_sdp_tpu.models.dataset, "
            "ska_sdp_tpu.models.spectral, ska_sdp_tpu.parallel\n"
            "assert 'h5py' not in sys.modules\n"
            "print('ok')\n")
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                           capture_output=True, text=True, env=_env())
        assert r.returncode == 0, r.stderr
        assert r.stdout.strip() == "ok"

    def test_native_backend_serves_without_h5py(self, tmp_path):
        code = _BLOCK_H5PY + (
            "import numpy as np\n"
            "from ska_sdp_tpu.io import h5\n"
            f"p = {str(tmp_path / 'x.h5')!r}\n"
            "h5.create_file(p)\n"
            "h5.write_dataset(p, '/a/b', np.arange(6.0).reshape(2, 3))\n"
            "assert h5.read_dataset(p, '/a/b').sum() == 15.0\n"
            "print(h5.backend_name())\n")
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                           capture_output=True, text=True, env=_env())
        assert r.returncode == 0, r.stderr
        assert r.stdout.strip() == "native"

    def test_clear_error_when_no_backend(self):
        code = _BLOCK_H5PY + (
            "from ska_sdp_tpu.io import h5, native_backend\n"
            "def broken():\n"
            "    raise OSError('libhdf5 missing')\n"
            "native_backend.ensure_loaded = broken\n"
            "try:\n"
            "    h5.backend_name()\n"
            "except RuntimeError as e:\n"
            "    print('ERR', e)\n")
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                           capture_output=True, text=True, env=_env())
        assert r.returncode == 0, r.stderr
        assert r.stdout.startswith("ERR no HDF5 backend available")
        assert "h5py is not installed" in r.stdout


# ---------------------------------------------------------------------------
# array-level drivers == file-level drivers
# ---------------------------------------------------------------------------


class TestArrayDrivers:
    def test_vis_data_from_observation_matches_file(self, small_files):
        _, paths, obs = small_files
        a = ds.vis_data_from_observation(obs)
        b = ds.load_vis_data(paths["vis"])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_kernel_generators_match_files(self, small_files):
        _, paths, obs = small_files
        bank, centers = ds.get_wkernels(paths["wkern"], SMALL.theta)
        gen = synthetic.wkern_bank(synthetic.w_plane_centers(obs, SMALL),
                                   SMALL)
        np.testing.assert_allclose(gen, bank, rtol=1e-12)
        ak = ds.get_akernels(paths["akern"], SMALL.theta,
                             float(obs["time"][0]),
                             float(obs["frequency"][0]))
        np.testing.assert_array_equal(synthetic.akerns_at_start(obs, SMALL),
                                      ak)

    @pytest.mark.parametrize("mode", ["w", "idg", "aw_idg"])
    def test_image_functions_match_file_drivers(self, small_files, mode):
        _, paths, obs = small_files
        from ska_sdp_tpu.config import GridParams, ImagingConfig

        cfg = ImagingConfig(grid=GridParams(theta=SMALL.theta,
                                            lam=SMALL.lam))
        data = ds.vis_data_from_observation(obs)
        bank, centers = ds.get_wkernels(paths["wkern"], SMALL.theta)
        ak = synthetic.akerns_at_start(obs, SMALL)
        if mode == "w":
            got = ds.w_image(data, bank, centers, config=cfg)
            want = ds.w_gridding(paths["wkern"], paths["vis"], config=cfg)
        elif mode == "idg":
            got = ds.idg_image(data, config=cfg)
            want = ds.idg_gridding(paths["vis"], config=cfg)
        else:
            got = ds.aw_image(data, ak, config=cfg, idg=True)
            want = ds.aw_gridding(paths["wkern"], paths["akern"],
                                  paths["vis"], config=cfg, idg=True)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# chip_smoke.py
# ---------------------------------------------------------------------------


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


class TestChipSmokeTruth:
    def test_uniform_weights_match_oracle(self, rng):
        cs = _chip_smoke()
        uvw = rng.uniform(-800, 800, (300, 3))
        uvw[100:150] = uvw[:50]                 # shared cells
        got = cs.uniform_weights(uvw, cs.C_LIGHT, 0.05, 3600)
        want = oracle.doweight(0.05, 3600, uvw, np.ones(300))
        np.testing.assert_allclose(got, want.real, rtol=1e-15)

    def test_float32_weights_match_the_pipeline(self, rng):
        """float32 cells reproduce ``ops.doweight`` of a single-precision
        run exactly, edge records included."""
        import jax.numpy as jnp

        from ska_sdp_tpu.ops import doweight, uvw_lambda

        cs = _chip_smoke()
        n, lam, f = 180, 3600, np.float32(1.5e8)
        # records straddling cell edges by less than a float32 ulp
        k = rng.integers(-80, 80, (400, 3)).astype(np.float64)
        uvw = ((k + 0.5) * lam / n * cs.C_LIGHT / 1.5e8
               * (1 + rng.uniform(-1e-7, 1e-7, (400, 3))))
        got = cs.uniform_weights(uvw, f, 0.05, lam, np.float32)
        u32 = jnp.asarray(uvw, jnp.float32)
        want = np.asarray(doweight(0.05, lam, uvw_lambda(jnp.asarray(f), u32),
                                   jnp.ones(400, jnp.float32)))
        np.testing.assert_array_equal(got.astype(np.float32), want)

    @pytest.mark.parametrize("screens", [False, True])
    def test_truth_matches_oracle_image(self, rng, screens):
        """The sampled float64 truth equals a full dense image built from
        utils/oracle's weighting, mirroring, hermitian completion and
        centered inverse FFT semantics (direct DFT, exact w-screen)."""
        cs = _chip_smoke()
        theta, lam, b = 0.05, 1280, 60
        n = int(round(theta * lam))
        freq = 299792458.0                       # metres == wavelengths
        uvw = rng.uniform(-0.4 * lam, 0.4 * lam, (b, 3))
        uvw[:, 2] = rng.uniform(-200, 200, b)
        vis = rng.standard_normal(b) + 1j * rng.standard_normal(b)
        a1 = rng.integers(0, 3, b)
        a2 = rng.integers(0, 3, b)
        ak = None
        if screens:
            ak = np.zeros((3, 5, 5), complex)
            ak[:, 2, 2] = 1.0
            ak += 0.2 * rng.standard_normal((3, 5, 5))
        ys, xs = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        got = cs.dirty_image_truth(uvw, vis, freq, theta, lam, ys.ravel(),
                                   xs.ravel(), a1=a1, a2=a2, akerns=ak,
                                   chunk=17, weights_dtype=np.float64
                                   ).reshape(n, n)
        wt = oracle.doweight(theta, lam, uvw, np.ones(b))
        uvw1, vis1 = oracle.mirror_uvw(uvw, vis)
        vis1 = vis1 * wt
        xf = (np.arange(n) - n // 2) / n
        l = xf * theta
        L, M = np.meshgrid(l, l, indexing="xy")
        nlm = 1.0 - np.sqrt(1.0 - L ** 2 - M ** 2)
        scr = np.ones((3, n, n))
        if screens:
            scr = cs.fine_screens(ak, n, ys.ravel(), xs.ravel()).reshape(
                3, n, n)
        img = np.zeros((n, n), complex)
        for k in range(b):
            img += (vis1[k] * np.exp(2j * np.pi * (uvw1[k, 0] * L
                                                   + uvw1[k, 1] * M
                                                   - uvw1[k, 2] * nlm))
                    * np.conj(scr[a1[k]] * scr[a2[k]]))
        want = 2.0 * np.real(img) / (n * n)
        np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())

    def test_truth_matches_idg_pipeline(self, small_files):
        """End to end on CPU: the IDG driver's image meets the truth inside
        the central disc at the documented envelope."""
        cs = _chip_smoke()
        _, _, obs = small_files
        from ska_sdp_tpu.config import GridParams, ImagingConfig

        data = ds.vis_data_from_observation(obs)
        cfg = ImagingConfig(grid=GridParams(theta=SMALL.theta,
                                            lam=SMALL.lam))
        _, img = ds.idg_image(data, config=cfg)
        n = img.shape[0]
        ys, xs = np.nonzero(cs.central_disc(n))
        truth = cs.dirty_image_truth(data.uvw, data.vis, data.frequency,
                                     SMALL.theta, SMALL.lam, ys, xs)
        assert cs.rel_err(img[ys, xs], truth) < 1e-4


class TestChipSmokeRefusals:
    def test_exits_nonzero_on_cpu(self):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                           capture_output=True, text=True, env=_env(),
                           timeout=300)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
        assert "no GPU" in r.stderr

    def test_exits_nonzero_without_the_package(self, tmp_path):
        import shutil

        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        env = _env()
        env.pop("PYTHONPATH")
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, env=env,
                           timeout=300)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
        assert "cannot import the package" in r.stderr


@pytest.mark.gpu
class TestOnGPU:
    def test_wproj_grid_gpu_matches_cpu(self, gpu, rng):
        """Card-only: the bank scatter on the GPU agrees with the CPU run
        of the same jitted function (atomic-add order only)."""
        import jax.numpy as jnp

        from ska_sdp_tpu.ops import convgrid_wproj

        bank = (rng.standard_normal((4, 4, 4, 7, 7))
                + 1j * rng.standard_normal((4, 4, 4, 7, 7))
                ).astype(np.complex64)
        p = rng.uniform(-0.4, 0.4, (5000, 3)).astype(np.float32)
        wbin = rng.integers(0, 4, 5000).astype(np.int32)
        vis = (rng.standard_normal(5000)
               + 1j * rng.standard_normal(5000)).astype(np.complex64)
        z = np.zeros((256, 256), np.complex64)
        f = jax.jit(lambda *a: convgrid_wproj(*a, chunk=1024))
        args = (bank, z, p, wbin, vis)
        got = np.asarray(f(*jax.device_put(args, gpu)))
        want = np.asarray(f(*jax.device_put(args, jax.devices("cpu")[0])))
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
