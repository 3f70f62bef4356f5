"""Benchmark: visibilities gridded per second at the SKA1-Low shape, one GPU.

Times the jitted operators of the imaging modes on the GPU that JAX
selects, at the reference's shape (2400² grid, theta=0.008, lam=300000; a
32-plane qpx=8 bank of 15² kernels; 2^20 visibilities per step, 2^19 for
bank AW).  Each step runs once to compile, then ``REPS`` times, each run
ending in ``block_until_ready``; a metric reports the median step time,
its spread (min, max) and the rate n / median.  The record names the
device (platform, ``device_kind``, count) and the card's name and power
limit as nvidia-smi reports them.  Without a GPU the script exits
non-zero and prints no record.

Usage (from the repository root, on the GPU machine)::

    python3 bench.py        # one JSON line on stdout

The headline is image-domain gridding, the w-projection operator that
places visibilities at their exact continuous (u, v, w); ``vs_baseline``
divides it by H100_CLASS_VIS_PER_SEC, the ROADMAP's bar for an H100-class
gridder on 15² kernels (published GPU gridders, PAPERS.md: ~1-3 Gvis/s).
No roofline share is reported until the benchmark defines the card's
peaks.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

H100_CLASS_VIS_PER_SEC = 2.0e9

THETA, LAM = 0.008, 300000
NW, QPX, S = 32, 8, 15
NANT = 64
N_VIS = 1 << 20
N_VIS_AW = 1 << 19
REPS = 5


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def _timed(step, args, n: int) -> dict:
    """Median, min and max wall time of ``step(*args)`` over REPS runs
    after one compile run; every run ends in block_until_ready."""
    import jax

    jax.block_until_ready(step(*args))
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(step(*args))
        ts.append(time.perf_counter() - t0)
    med = statistics.median(ts)
    return {"value": round(n / med, 1), "unit": "vis/s",
            "step_s_median": med, "step_s_min": min(ts),
            "step_s_max": max(ts), "reps": REPS}


def main() -> int:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: no GPU (JAX selected {devs[0].platform!r})",
              file=sys.stderr)
        return 1
    from ska_sdp_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from ska_sdp_tpu.models.dataset import idg_aw_max_runs
    from ska_sdp_tpu.ops import (
        convgrid_aw,
        convgrid_wproj,
        degrid_wproj,
        find_closest,
        ifft_centered,
        make_grid_hermitian,
        mirror_uvw,
    )
    from ska_sdp_tpu.ops.idg import idg_degrid_wproj, idg_grid_wproj
    from ska_sdp_tpu.ops.idg_aw import (aw_screens_host, idg_degrid_aw,
                                        idg_grid_aw)

    n_grid = int(round(THETA * LAM))
    rng = np.random.default_rng(0)
    bank = jnp.asarray((rng.standard_normal((NW, QPX, QPX, S, S))
                        + 1j * rng.standard_normal((NW, QPX, QPX, S, S))
                        ).astype(np.complex64))
    centers = jnp.asarray(np.linspace(-4000, 4000, NW), jnp.float32)
    uvw = rng.uniform(-0.42 * LAM, 0.42 * LAM, size=(N_VIS, 3))
    uvw[:, 2] = rng.uniform(-3800, 3800, size=N_VIS)
    uvw = jnp.asarray(uvw, jnp.float32)
    vis = jnp.asarray((rng.standard_normal(N_VIS)
                       + 1j * rng.standard_normal(N_VIS)).astype(np.complex64))
    grid = jnp.asarray((rng.standard_normal((n_grid, n_grid))
                        + 1j * rng.standard_normal((n_grid, n_grid))
                        ).astype(np.complex64))
    zeros = jnp.zeros((n_grid, n_grid), jnp.complex64)

    def prep(uvw_l, v):
        uvw1, vis1 = mirror_uvw(uvw_l, v)
        return uvw1, vis1, find_closest(centers, uvw1[:, 2])

    record = {}
    extras = []

    # headline: image-domain gridding
    @jax.jit
    def idg_step(uvw_l, v):
        uvw1, vis1, _ = prep(uvw_l, v)
        return idg_grid_wproj((n_grid, n_grid), uvw1 / LAM, uvw1[:, 2],
                              vis1, theta=THETA, subgrid=64)

    r = _timed(idg_step, (uvw, vis), N_VIS)
    record.update({
        "metric": ("visibilities gridded/sec (SKA1-Low w-projection by "
                   "image-domain gridding, 2400^2 grid, complex64, "
                   "subgrid 64)"),
        **r, "vs_baseline": round(r["value"] / H100_CLASS_VIS_PER_SEC, 4),
    })

    @jax.jit
    def wproj_step(uvw_l, v):
        uvw1, vis1, wbin = prep(uvw_l, v)
        return convgrid_wproj(bank, zeros, uvw1 / LAM, wbin, vis1,
                              chunk=8192)

    extras.append({"metric": "w-projection, kernel-bank scatter (qpx=8, "
                             "15^2 taps)", **_timed(wproj_step, (uvw, vis),
                                                    N_VIS)})

    @jax.jit
    def full_step(uvw_l, v):
        g = wproj_step(uvw_l, v)
        return jnp.real(ifft_centered(make_grid_hermitian(g)))

    extras.append({"metric": "full imaging step (bank scatter + hermitian "
                             "+ centered iFFT)",
                   **_timed(full_step, (uvw, vis), N_VIS)})

    @jax.jit
    def degrid_step(uvw_l, g):
        uvw1, _, wbin = prep(uvw_l, jnp.zeros(uvw_l.shape[0], jnp.complex64))
        return degrid_wproj(bank, g, uvw1 / LAM, wbin, chunk=8192)

    extras.append({"metric": "w-projection degridding (kernel-bank gather)",
                   **_timed(degrid_step, (uvw, grid), N_VIS)})

    @jax.jit
    def idg_degrid_step(uvw_l, g):
        uvw1, _, _ = prep(uvw_l, jnp.zeros(uvw_l.shape[0], jnp.complex64))
        return idg_degrid_wproj((n_grid, n_grid), uvw1 / LAM, uvw1[:, 2], g,
                                theta=THETA, subgrid=64)

    extras.append({"metric": "IDG degridding (exact continuous-w)",
                   **_timed(idg_degrid_step, (uvw, grid), N_VIS)})

    # IDG-AW on baseline-track data (the layout it is built for)
    ii, jj = np.triu_indices(NANT, k=1)
    nbl = ii.shape[0]
    ntime = N_VIS // nbl
    u0 = rng.uniform(-0.40, 0.40, (nbl, 2))
    du = rng.uniform(-30.0 / n_grid, 30.0 / n_grid, (nbl, 2))
    ft = (np.arange(ntime) / ntime)[:, None]
    pT = np.zeros((ntime * nbl, 3), np.float32)
    pT[:, 0] = (u0[None, :, 0] + du[None, :, 0] * ft).ravel()
    pT[:, 1] = (u0[None, :, 1] + du[None, :, 1] * ft).ravel()
    wT = rng.uniform(-3800, 3800, ntime * nbl).astype(np.float32)
    a1T = np.broadcast_to(ii[None, :], (ntime, nbl)).ravel().astype(np.int32)
    a2T = np.broadcast_to(jj[None, :], (ntime, nbl)).ravel().astype(np.int32)
    ak = (rng.standard_normal((NANT, S, S))
          + 1j * rng.standard_normal((NANT, S, S)))
    scr = jnp.asarray(aw_screens_host(ak, 64).astype(np.complex64))
    c_light = 299792458.0
    max_runs = idg_aw_max_runs(pT * LAM, np.float32(c_light), a1T, a2T,
                               theta=THETA, lam=LAM, subgrid=64,
                               mirror=False)
    argsT = (jnp.asarray(pT), jnp.asarray(a1T), jnp.asarray(a2T),
             jnp.asarray(wT), vis[:pT.shape[0]])

    @jax.jit
    def aw_idg_step(p, a1, a2, w, v):
        return idg_grid_aw((n_grid, n_grid), p, a1, a2, w, v, scr,
                           theta=THETA, subgrid=64, max_runs=max_runs)

    _, nd = aw_idg_step(*argsT)
    extras.append({"metric": ("IDG-AW gridding (image-domain A-screens, "
                              f"baseline tracks, {NANT} antennas)"),
                   **_timed(aw_idg_step, argsT, pT.shape[0]),
                   "dropped": int(nd)})

    @jax.jit
    def aw_idg_degrid_step(p, a1, a2, w, g):
        return idg_degrid_aw((n_grid, n_grid), p, a1, a2, w, g, scr,
                             theta=THETA, subgrid=64, max_runs=max_runs)

    extras.append({"metric": "IDG-AW degridding (with A-terms)",
                   **_timed(aw_idg_degrid_step, argsT[:4] + (grid,),
                            pT.shape[0])})

    akj = jnp.asarray(ak.astype(np.complex64))
    a1r = jnp.asarray(rng.integers(0, NANT, N_VIS_AW).astype(np.int32))
    a2r = jnp.asarray(rng.integers(0, NANT, N_VIS_AW).astype(np.int32))

    @jax.jit
    def aw_step(uvw_l, v, a1, a2):
        uvw1, vis1, wbin = prep(uvw_l, v)
        return convgrid_aw(bank, akj, zeros, uvw1 / LAM, wbin, a1, a2, vis1,
                           chunk=8192)

    extras.append({"metric": ("bank AW-projection (on-the-fly A1*A2*W "
                              "kernels, random uv)"),
                   **_timed(aw_step, (uvw[:N_VIS_AW], vis[:N_VIS_AW], a1r,
                                      a2r), N_VIS_AW)})

    d = devs[0]
    record["extra_metrics"] = extras
    record["device"] = {"platform": d.platform, "kind": d.device_kind,
                        "count": len(devs), "card": _card()}
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
