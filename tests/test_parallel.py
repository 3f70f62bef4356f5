"""Sharded-imaging tests on the 8-device virtual CPU mesh.

Asserts the partial-grid psum design gives bit-level agreement with the
single-device pipeline (modulo scatter-order — exact in f64 for these sizes).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_tpu import ops
from ska_sdp_tpu.parallel import (
    make_mesh,
    make_sharded_wproj_step,
    sharded_wproj_grid,
    sharded_wproj_image,
)


def _rand_cplx(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


class TestShardedGrid:
    def test_matches_single_device(self, rng, mesh):
        n, nw, qpx, gs = 64, 3, 2, 7
        b = 8 * 13
        bank = jnp.asarray(_rand_cplx(rng, (nw, qpx, qpx, gs, gs)))
        p = jnp.asarray(rng.uniform(-0.35, 0.35, size=(b, 3)))
        wbin = jnp.asarray(rng.integers(0, nw, size=b))
        vis = jnp.asarray(_rand_cplx(rng, b))

        got = sharded_wproj_grid(mesh, bank, p, wbin, vis, n, chunk=8)
        want = ops.convgrid_wproj(
            bank, jnp.zeros((n, n), jnp.complex128), p, wbin, vis, chunk=8
        )
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-12)

    def test_uses_all_devices(self, mesh):
        assert mesh.devices.size == 8


class TestShardedStep:
    def test_full_step_matches_unsharded(self, rng, mesh):
        theta, lam = 0.05, 1280   # 64² grid
        nw, qpx, gs = 3, 2, 7
        b = 8 * 11
        bank = jnp.asarray(_rand_cplx(rng, (nw, qpx, qpx, gs, gs)))
        centers = jnp.asarray(np.linspace(-100, 100, nw))
        uvw = jnp.asarray(rng.uniform(-0.3 * lam, 0.3 * lam, size=(b, 3)))
        vis = jnp.asarray(_rand_cplx(rng, b))
        freq = jnp.asarray(299792458.0)  # scale 1.0

        step = make_sharded_wproj_step(mesh, theta, lam, chunk=16)
        img = step(bank, centers, uvw, freq, vis)

        # unsharded reference chain
        uvw_l = ops.uvw_lambda(freq, uvw)
        wt = ops.doweight(theta, lam, uvw_l, jnp.ones_like(vis))
        uvw1, vis1 = ops.mirror_uvw(uvw_l, vis)
        wbin = ops.find_closest(centers, uvw1[:, 2])
        n = int(round(theta * lam))
        guv = ops.convgrid_wproj(
            bank, jnp.zeros((n, n), jnp.complex128), uvw1 / lam, wbin,
            wt * vis1, chunk=16,
        )
        want = jnp.real(ops.ifft_centered(ops.make_grid_hermitian(guv)))
        np.testing.assert_allclose(
            np.asarray(img), np.asarray(want), atol=1e-11
        )

    def test_sharded_image_helper(self, rng, mesh):
        theta, lam = 0.05, 1280
        nw, qpx, gs = 2, 2, 5
        b = 8 * 5
        bank = jnp.asarray(_rand_cplx(rng, (nw, qpx, qpx, gs, gs)))
        centers = jnp.asarray(np.linspace(-50, 50, nw))
        uvw_l = jnp.asarray(rng.uniform(-0.3 * lam, 0.3 * lam, size=(b, 3)))
        vis = jnp.asarray(_rand_cplx(rng, b))
        img = sharded_wproj_image(
            mesh, bank, centers, uvw_l, vis, theta, lam, chunk=8
        )
        assert img.shape == (64, 64)
        assert np.isfinite(np.asarray(img)).all()


class TestDistributedImage:
    """``sharded_image`` — the ``--distributed`` step the CLI runs —
    against the one-device array drivers on the same data."""

    def _data(self):
        from ska_sdp_tpu.io import synthetic
        from ska_sdp_tpu.models.dataset import vis_data_from_observation

        cfg = synthetic.SyntheticConfig(theta=0.05, lam=3600, nant=8,
                                        ntime=6, nw_planes=4, qpx=2,
                                        npix_ff=64, seed=11)
        obs = synthetic.simulate_observation(cfg)
        bank = synthetic.wkern_bank(synthetic.w_plane_centers(obs, cfg),
                                    cfg)
        return cfg, vis_data_from_observation(obs), bank, \
            synthetic.w_plane_centers(obs, cfg)

    @pytest.mark.parametrize("mode", ["w", "idg"])
    def test_matches_one_device_driver(self, mesh, mode):
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ska_sdp_tpu.config import GridParams, ImagingConfig
        from ska_sdp_tpu.models import dataset as ds
        from ska_sdp_tpu.parallel.sharded import sharded_image

        cfg, data, bank, centers = self._data()
        config = ImagingConfig(grid=GridParams(theta=cfg.theta, lam=cfg.lam),
                               precision_name="double")
        prec = config.precision
        sh = NamedSharding(mesh, P("vis"))
        uvw = jax.device_put(np.asarray(data.uvw, prec.np_real), sh)
        vis = jax.device_put(np.asarray(data.vis, prec.np_complex), sh)
        img = np.asarray(sharded_image(
            mesh, mode, uvw, vis, data.frequency, theta=cfg.theta,
            lam=cfg.lam, precision=prec, subgrid=64, wkerns=bank,
            wbins=centers))
        if mode == "w":
            _, ref = ds.w_image(data, bank, centers, config=config)
        else:
            _, ref = ds.idg_image(data, config=config, subgrid=64)
            # IDG is compared in its central 75% FOV: the taper division
            # amplifies rounding toward the corners
            n = ref.shape[0]
            r = np.arange(n) - n // 2
            disc = r[:, None] ** 2 + r[None, :] ** 2 <= (0.375 * n) ** 2
            img, ref = img[disc], ref[disc]
        np.testing.assert_allclose(img, ref, rtol=0,
                                   atol=1e-9 * np.abs(ref).max())

    def test_other_modes_rejected(self, mesh):
        from ska_sdp_tpu.config import ImagingConfig
        from ska_sdp_tpu.parallel.sharded import sharded_image

        with pytest.raises(ValueError, match="no sharded step"):
            sharded_image(mesh, "aw", None, None, 1.0, theta=0.05, lam=3600,
                          precision=ImagingConfig().precision)


class TestShardedFFT:
    def test_sharded_ifft_matches_local(self, rng):
        from ska_sdp_tpu.ops.fourier import ifft_centered
        from ska_sdp_tpu.parallel.fft import make_sharded_ifft2
        from ska_sdp_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(8)
        H = W = 320
        x = jnp.asarray(
            (rng.standard_normal((H, W))
             + 1j * rng.standard_normal((H, W)))
        )
        want = np.asarray(ifft_centered(x))
        got = np.asarray(make_sharded_ifft2(mesh)(x))
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)

    def test_gridfft_step_matches_replicated_step(self, rng):
        from ska_sdp_tpu.parallel.mesh import make_mesh
        from ska_sdp_tpu.parallel.sharded import (
            make_sharded_wproj_step,
            make_sharded_wproj_step_gridfft,
        )
        from ska_sdp_tpu.ops import w_kernel_bank
        from ska_sdp_tpu.config import KernelOptions

        mesh = make_mesh(8)
        theta, lam = 0.02, 16000     # 320² grid = 8²·5 rows
        nw, qpx, s = 4, 2, 15
        n_vis = 512
        opts = KernelOptions(qpx=qpx, npix_ff=64, npix_kern=s)
        centers = jnp.linspace(-500.0, 500.0, nw)
        bank = w_kernel_bank(theta, centers, opts).astype(jnp.complex128)
        uvw = rng.uniform(-0.4 * lam, 0.4 * lam, size=(n_vis, 3))
        uvw[:, 2] = rng.uniform(-450, 450, size=n_vis)
        uvw = jnp.asarray(uvw)
        vis = jnp.asarray(
            rng.standard_normal(n_vis) + 1j * rng.standard_normal(n_vis)
        )
        freq = jnp.asarray(299792458.0)

        # same step as make_sharded_wproj_step (incl. weighting), FFT
        # distributed — the two must agree to fp precision
        img_grid_fft = np.asarray(
            make_sharded_wproj_step_gridfft(mesh, theta, lam, chunk=128)(
                bank, centers, uvw, freq, vis
            )
        )
        want = np.asarray(
            make_sharded_wproj_step(mesh, theta, lam, chunk=128)(
                bank, centers, uvw, freq, vis
            )
        )
        np.testing.assert_allclose(img_grid_fft, want, rtol=1e-9, atol=1e-11)


_DIST_WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from ska_sdp_tpu.parallel.distributed import initialize, make_host_vis_mesh
from jax.sharding import PartitionSpec as P
from jax import shard_map

initialize()  # env-driven: SKA_SDP_TPU_COORDINATOR/_NPROCS/_PROC_ID
assert jax.process_count() == 2, jax.process_count()
mesh = make_host_vis_mesh()
assert mesh.devices.shape == (2, 4), mesh.devices.shape

# global psum over the 2-D ("host", "vis") mesh: every process contributes
def local(x):
    s = jax.lax.psum(jnp.sum(x), ("host", "vis"))
    return s.reshape(1)

n_global = 8 * 16
x = jnp.arange(n_global, dtype=jnp.float32)
fn = shard_map(local, mesh=mesh, in_specs=P(("host", "vis")),
               out_specs=P(("host", "vis")))
out = np.asarray(jax.jit(fn)(x).addressable_shards[0].data)
expect = n_global * (n_global - 1) / 2
assert abs(out[0] - expect) < 1e-3, (out, expect)
print("DIST_OK", flush=True)
"""


class TestMultiProcessDistributed:
    def test_two_process_psum(self, tmp_path):
        """Real multi-host path: 2 OS processes, jax.distributed, one psum."""
        import socket
        import subprocess
        import sys

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]

        script = tmp_path / "worker.py"
        script.write_text(_DIST_WORKER)
        procs = []
        for pid in range(2):
            env = dict(os.environ)
            env.update(
                JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4",
                PYTHONPATH=os.getcwd(),
                SKA_SDP_TPU_COORDINATOR=f"127.0.0.1:{port}",
                SKA_SDP_TPU_NPROCS="2",
                SKA_SDP_TPU_PROC_ID=str(pid),
            )
            procs.append(subprocess.Popen(
                [sys.executable, str(script)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env,
            ))
        outs = [p.communicate(timeout=180) for p in procs]
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, err[-2000:]
            assert "DIST_OK" in out


_INGEST_WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from ska_sdp_tpu.parallel.distributed import initialize
from ska_sdp_tpu.parallel.ingest import load_vis_sharded
from ska_sdp_tpu.parallel.mesh import make_mesh
from ska_sdp_tpu.parallel.sharded import make_sharded_wproj_step
from ska_sdp_tpu.models.dataset import get_wkernels

initialize()
assert jax.process_count() == 2
mesh = make_mesh()   # 1-D ("vis",) mesh over all 8 global devices

d = os.environ["SKA_TEST_DATA"]
theta, lam = 0.05, 1600
uvw, vis, freq = load_vis_sharded(os.path.join(d, "vis.h5"), mesh)
wk, centers = get_wkernels(os.path.join(d, "wkern.h5"), theta)
bank = np.conj(np.asarray(wk, np.complex128))
step = make_sharded_wproj_step(mesh, theta, lam, chunk=64)
img = step(bank, np.asarray(centers), uvw, jnp.asarray(float(freq)), vis)
mx = float(jnp.max(img))

# grid-distributed variant: cross-process reduce_scatter + ppermute
# hermitian + pencil-FFT all_to_all (80 = n_grid, 80 % 8^2 != 0 -> use a
# finer grid via lam2); exercises every collective across OS processes
from ska_sdp_tpu.parallel.sharded import make_sharded_wproj_step_gridscatter
theta2, lam2 = 0.02, 16000           # 320^2, 320 % 64 == 0
step2 = make_sharded_wproj_step_gridscatter(mesh, theta2, lam2, chunk=64)
img2 = step2(bank, np.asarray(centers), uvw, jnp.asarray(float(freq)), vis)
from ska_sdp_tpu.parallel.sharded import make_sharded_wproj_step as mk
img2_ref = mk(mesh, theta2, lam2, chunk=64)(
    bank, np.asarray(centers), uvw, jnp.asarray(float(freq)), vis)
d2 = float(jnp.max(jnp.abs(img2 - img2_ref)) / (jnp.max(jnp.abs(img2_ref)) + 1e-30))
assert d2 < 1e-5, d2

print(f"INGEST_OK {mx:.12e}", flush=True)
"""


class TestShardedIngest:
    def test_two_process_sharded_ingest_imaging(self, tmp_path):
        """Each process reads only its slice; global image matches 1-proc."""
        import socket
        import subprocess
        import sys

        env0 = dict(os.environ)
        env0["JAX_PLATFORMS"] = "cpu"
        env0["PYTHONPATH"] = os.getcwd()
        d = str(tmp_path / "obs")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--make-data", d,
             "--nant", "8", "--ntime", "8", "--nw", "4", "--qpx", "2",
             "--theta", "0.05", "--lam", "1600"],
            capture_output=True, text=True, env=env0,
        )
        assert r.returncode == 0, r.stderr

        # single-process reference (full load, all 8 local devices)
        from ska_sdp_tpu.config import GridParams, ImagingConfig
        from ska_sdp_tpu.models import dataset as ds

        cfg = ImagingConfig(grid=GridParams(theta=0.05, lam=1600),
                            precision_name="double")
        mx_ref, _ = ds.w_gridding(os.path.join(d, "wkern.h5"),
                                  os.path.join(d, "vis.h5"), config=cfg)

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        script = tmp_path / "worker.py"
        script.write_text(_INGEST_WORKER)
        procs = []
        for pid in range(2):
            env = dict(env0)
            env.update(
                XLA_FLAGS="--xla_force_host_platform_device_count=4",
                SKA_SDP_TPU_COORDINATOR=f"127.0.0.1:{port}",
                SKA_SDP_TPU_NPROCS="2",
                SKA_SDP_TPU_PROC_ID=str(pid),
                SKA_TEST_DATA=d,
            )
            procs.append(subprocess.Popen(
                [sys.executable, str(script)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env,
            ))
        outs = [p.communicate(timeout=240) for p in procs]
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, err[-2000:]
            assert "INGEST_OK" in out, out
            mx = float(out.strip().split()[-1])
            # n here is divisible by the device count; only the psum
            # reduction order differs from the single-process pipeline
            assert abs(mx - mx_ref) / abs(mx_ref) < 1e-6, (mx, mx_ref)


_SPECTRAL_WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
from ska_sdp_tpu.config import GridParams, ImagingConfig
from ska_sdp_tpu.models import spectral
from ska_sdp_tpu.parallel.distributed import initialize
from ska_sdp_tpu.parallel.mesh import make_mesh

initialize()
assert jax.process_count() == 2
mesh = make_mesh()           # 1-D ("vis",) mesh over all 8 global devices

d = os.environ["SKA_TEST_DATA"]
cfg = ImagingConfig(grid=GridParams(theta=0.05, lam=1600),
                    precision_name="double")
mx, img, cube = spectral.idg_gridding_multi_sharded(
    os.path.join(d, "vis.h5"), 2, config=cfg, mesh=mesh)
assert cube.shape[0] == 2
assert np.all(np.isfinite(cube))
print(f"SPECTRAL_OK {mx:.12e}", flush=True)
"""


class TestTwoProcessSpectral:
    def test_two_process_sharded_spectral(self, tmp_path):
        """The sharded multi-channel driver across 2 OS processes
        (jax.distributed) matches the single-process local driver."""
        import socket
        import subprocess
        import sys

        env0 = dict(os.environ)
        env0["JAX_PLATFORMS"] = "cpu"
        env0["PYTHONPATH"] = os.getcwd()
        d = str(tmp_path / "obs")
        r = subprocess.run(
            [sys.executable, "-m", "ska_sdp_tpu.cli", "--make-data", d,
             "--nant", "8", "--ntime", "8", "--nw", "4", "--qpx", "2",
             "--theta", "0.05", "--lam", "1600", "--nchan", "2"],
            capture_output=True, text=True, env=env0,
        )
        assert r.returncode == 0, r.stderr

        from ska_sdp_tpu.config import GridParams, ImagingConfig
        from ska_sdp_tpu.models import spectral as sp

        cfg = ImagingConfig(grid=GridParams(theta=0.05, lam=1600),
                            precision_name="double")
        mx_ref, _, _ = sp.idg_gridding_multi(
            os.path.join(d, "vis.h5"), 2, config=cfg)

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        script = tmp_path / "worker.py"
        script.write_text(_SPECTRAL_WORKER)
        procs = []
        for pid in range(2):
            env = dict(env0)
            env.update(
                XLA_FLAGS="--xla_force_host_platform_device_count=4",
                SKA_SDP_TPU_COORDINATOR=f"127.0.0.1:{port}",
                SKA_SDP_TPU_NPROCS="2",
                SKA_SDP_TPU_PROC_ID=str(pid),
                SKA_TEST_DATA=d,
            )
            procs.append(subprocess.Popen(
                [sys.executable, str(script)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env,
            ))
        outs = [p.communicate(timeout=240) for p in procs]
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, err[-2000:]
            assert "SPECTRAL_OK" in out, out
            mx = float(out.strip().split()[-1])
            assert abs(mx - mx_ref) / abs(mx_ref) < 1e-6, (mx, mx_ref)


class TestShardedPredict:
    def test_sharded_predict_matches_local(self, rng):
        from ska_sdp_tpu.config import KernelOptions
        from ska_sdp_tpu.ops import (degrid_wproj, fft_centered,
                                     find_closest, uvw_lambda, w_kernel_bank)
        from ska_sdp_tpu.parallel.mesh import make_mesh
        from ska_sdp_tpu.parallel.sharded import make_sharded_predict_step

        mesh = make_mesh(8)
        theta, lam = 0.02, 16000
        nw, qpx, s = 4, 2, 15
        n_vis = 512
        n_grid = int(round(theta * lam))
        opts = KernelOptions(qpx=qpx, npix_ff=64, npix_kern=s)
        centers = jnp.linspace(-500.0, 500.0, nw)
        bank = w_kernel_bank(theta, centers, opts).astype(jnp.complex128)
        img = jnp.asarray(rng.standard_normal((n_grid, n_grid)))
        uvw = rng.uniform(-0.4 * lam, 0.4 * lam, size=(n_vis, 3))
        uvw[:, 2] = rng.uniform(-450, 450, size=n_vis)
        uvw = jnp.asarray(uvw)
        freq = jnp.asarray(299792458.0)

        got = np.asarray(
            make_sharded_predict_step(mesh, theta, lam, chunk=128)(
                bank, centers, img, uvw, freq
            )
        )
        uvw_l = uvw_lambda(freq, uvw)
        grid = fft_centered(img.astype(bank.dtype))
        wbin = find_closest(centers, uvw_l[:, 2])
        want = np.asarray(
            degrid_wproj(bank, grid, uvw_l / lam, wbin, chunk=128)
        )
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


class TestGridScatterStep:
    def test_matches_replicated_step(self, rng):
        from ska_sdp_tpu.config import KernelOptions
        from ska_sdp_tpu.ops import w_kernel_bank
        from ska_sdp_tpu.parallel.mesh import make_mesh
        from ska_sdp_tpu.parallel.sharded import (
            make_sharded_wproj_step,
            make_sharded_wproj_step_gridscatter,
        )

        mesh = make_mesh(8)
        theta, lam = 0.02, 16000     # 320² grid, 320 % 64 == 0
        nw, qpx, s = 4, 2, 15
        n_vis = 512
        opts = KernelOptions(qpx=qpx, npix_ff=64, npix_kern=s)
        centers = jnp.linspace(-500.0, 500.0, nw)
        bank = w_kernel_bank(theta, centers, opts).astype(jnp.complex128)
        uvw = rng.uniform(-0.4 * lam, 0.4 * lam, size=(n_vis, 3))
        uvw[:, 2] = rng.uniform(-450, 450, size=n_vis)
        uvw = jnp.asarray(uvw)
        vis = jnp.asarray(
            rng.standard_normal(n_vis) + 1j * rng.standard_normal(n_vis)
        )
        freq = jnp.asarray(299792458.0)

        got = np.asarray(
            make_sharded_wproj_step_gridscatter(mesh, theta, lam, chunk=128)(
                bank, centers, uvw, freq, vis
            )
        )
        want = np.asarray(
            make_sharded_wproj_step(mesh, theta, lam, chunk=128)(
                bank, centers, uvw, freq, vis
            )
        )
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)


class TestShardedIDG:
    def test_idg_step_matches_unsharded(self, rng, mesh):
        from ska_sdp_tpu.ops.idg import (
            idg_grid_wproj,
            kaiser_taper,
            taper_fine,
        )
        from ska_sdp_tpu.parallel import make_sharded_idg_step

        theta, lam = 0.05, 2560   # 128² grid
        b = 8 * 11
        uvw = jnp.asarray(rng.uniform(-0.3 * lam, 0.3 * lam, size=(b, 3)))
        vis = jnp.asarray(_rand_cplx(rng, b)).astype(jnp.complex128)
        freq = jnp.asarray(299792458.0)

        step = make_sharded_idg_step(mesh, theta, lam, subgrid=32)
        img = step(uvw, freq, vis)

        # unsharded reference chain (same weighting + IDG + correction)
        n = int(round(theta * lam))
        uvw_l = ops.uvw_lambda(freq, uvw)
        wt = ops.doweight(theta, lam, uvw_l, jnp.ones_like(vis))
        uvw1, vis1 = ops.mirror_uvw(uvw_l, vis)
        guv = idg_grid_wproj(
            (n, n), uvw1 / lam, uvw1[:, 2], wt * vis1, theta=theta,
            subgrid=32,
        )
        want = jnp.real(ops.ifft_centered(ops.make_grid_hermitian(guv)))
        tf = np.asarray(taper_fine(n, 32, kaiser_taper(32, 12.0)))
        want = np.asarray(want) / np.outer(tf, tf)
        np.testing.assert_allclose(np.asarray(img), want, atol=1e-9)


class TestShardedIDGAW:
    def test_idg_aw_step_matches_unsharded(self, rng, mesh):
        """Sharded IDG-AW vs the local XLA chain: tile-derived subgrid
        origins are device-independent, so shard-splitting a pair's run
        changes only summation order."""
        from ska_sdp_tpu.ops.idg import kaiser_taper, taper_fine
        from ska_sdp_tpu.ops.idg_aw import aw_screens, idg_grid_aw
        from ska_sdp_tpu.parallel import make_sharded_idg_aw_step

        theta, lam = 0.05, 2560   # 128² grid
        b = 8 * 16
        nant = 4
        uvw = jnp.asarray(rng.uniform(-0.25 * lam, 0.25 * lam, size=(b, 3)))
        vis = jnp.asarray(_rand_cplx(rng, b)).astype(jnp.complex128)
        a1 = jnp.asarray(rng.integers(0, nant - 1, b), jnp.int32)
        a2 = jnp.asarray(np.asarray(a1) + 1, jnp.int32)
        freq = jnp.asarray(299792458.0)
        s = 9
        ak = np.zeros((nant, s, s), np.complex128)
        ak[:, s // 2, s // 2] = 1.0
        ak += 0.1 * rng.standard_normal((nant, s, s))
        scr = aw_screens(jnp.asarray(ak), 64, dtype=jnp.complex128)
        mr = 2048

        step = make_sharded_idg_aw_step(mesh, theta, lam, subgrid=64,
                                        max_runs=mr)
        img, nd = step(uvw, freq, vis, a1, a2, scr)

        n = int(round(theta * lam))
        uvw_l = ops.uvw_lambda(freq, uvw)
        wt = ops.doweight(theta, lam, uvw_l, jnp.ones_like(vis))
        uvw1, vis1 = ops.mirror_uvw(uvw_l, vis)
        guv, nd_w = idg_grid_aw(
            (n, n), uvw1 / lam, a1, a2, uvw1[:, 2], wt * vis1, scr,
            theta=theta, subgrid=64, max_runs=mr,
        )
        want = jnp.real(ops.ifft_centered(ops.make_grid_hermitian(guv)))
        tf = np.asarray(taper_fine(n, 64, kaiser_taper(64, 12.0)))
        want = np.asarray(want) / np.outer(tf, tf)
        assert int(nd) == int(nd_w)
        np.testing.assert_allclose(np.asarray(img), want, atol=1e-9)
