"""Synthetic SKA1_Low-style dataset generation.

The reference ships its datasets as git-lfs stubs (SURVEY §2 C18), so this
module generates physically meaningful substitutes with the exact HDF5 tree
layout of :mod:`ska_sdp_tpu.io.schema`:

* an interferometer observation — antennas on a random compact layout,
  Earth-rotation-synthesized uvw tracks, visibilities simulated from a small
  sky of point sources:

      V(u, v, w) = Σ_s  A_s · exp(-2πi (u·l_s + v·m_s + w·(√(1-l²-m²) - 1)))

  which is the measurement equation the w-projection algorithm inverts, so
  end-to-end imaging tests can assert that sources reappear at (l_s, m_s);

* a w-kernel bank synthesized from first principles with
  :func:`ska_sdp_tpu.ops.w_kernel` semantics (stored UNconjugated, matching
  how the reference datasets are consumed);

* A-kernels: near-delta antenna patterns with small deterministic
  perturbations per antenna/time/frequency.

Everything is numpy float64 on the host — dataset generation is I/O-side
work and never touches the accelerator.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..utils import oracle
from . import h5, schema


@dataclass(frozen=True)
class SyntheticConfig:
    theta: float = 0.008          # field of view (radians-ish l,m extent)
    lam: int = 300000             # grid resolution in wavelengths
    nant: int = 16
    ntime: int = 24
    freq: float = 1.5e8           # Hz (first channel)
    nchan: int = 1                # spectral channels (/vis/frequency [nch])
    chan_bw: float = 1.0e5        # channel spacing in Hz
    declination: float = 0.7      # radians
    # Maximum antenna-layout diameter in metres.  None (default) derives it
    # from the grid: baselines must stay inside the ±lam/2 uv box, so the
    # layout diameter is capped at ~0.42·lam wavelengths.
    max_baseline_m: float | None = None
    nsources: int = 5
    nw_planes: int = 16
    qpx: int = 4
    npix_ff: int = 256
    npix_kern: int = 15
    akern_size: int = 15
    seed: int = 1234


def simulate_observation(cfg: SyntheticConfig):
    """Generate uvw tracks + point-source visibilities.

    Returns a dict of numpy arrays matching the /vis ingest contract.
    """
    rng = np.random.default_rng(cfg.seed)
    max_baseline_m = cfg.max_baseline_m
    if max_baseline_m is None:
        max_baseline_m = 0.42 * cfg.lam * 299792458.0 / cfg.freq
    # Antenna positions: random within a disk; heights ~ 0.
    r = max_baseline_m / 2 * np.sqrt(rng.uniform(0.03, 1.0, cfg.nant))
    az = rng.uniform(0, 2 * np.pi, cfg.nant)
    ants = np.stack([r * np.cos(az), r * np.sin(az), rng.normal(0, 5, cfg.nant)], 1)

    i_idx, j_idx = np.triu_indices(cfg.nant, k=1)
    L = ants[j_idx] - ants[i_idx]                      # [nbl, 3] metres
    nbl = L.shape[0]

    hours = np.linspace(-0.5, 0.5, cfg.ntime)          # hour angles (rad)
    sd, cd = np.sin(cfg.declination), np.cos(cfg.declination)
    uvw = np.empty((cfg.ntime, nbl, 3))
    for t, h in enumerate(hours):
        sh, ch = np.sin(h), np.cos(h)
        rot = np.array(
            [
                [sh, ch, 0.0],
                [-sd * ch, sd * sh, cd],
                [cd * ch, -cd * sh, sd],
            ]
        )
        uvw[t] = L @ rot.T
    uvw = uvw.reshape(-1, 3)                            # metres
    n = uvw.shape[0]

    a1 = np.tile(i_idx, cfg.ntime).astype(np.int64)
    a2 = np.tile(j_idx, cfg.ntime).astype(np.int64)
    time = np.repeat(np.linspace(55000.0, 55000.01, cfg.ntime), nbl)

    # Sky: point sources within the field of view.
    lm_extent = 0.35 * cfg.theta
    srcs_l = rng.uniform(-lm_extent, lm_extent, cfg.nsources)
    srcs_m = rng.uniform(-lm_extent, lm_extent, cfg.nsources)
    flux = rng.uniform(0.5, 2.0, cfg.nsources)

    # per-channel measurement equation: channel c observes the same sky
    # through uvw scaled by f_c/c (the physical baseline is in metres;
    # reference stores /vis/frequency as a VECTOR — ImageDataset.hs:99-106
    # reads it whole even though only element 0 is consumed there)
    freqs = cfg.freq + cfg.chan_bw * np.arange(cfg.nchan)
    phase_geom = (
        uvw[:, 0:1] * srcs_l[None, :]
        + uvw[:, 1:2] * srcs_m[None, :]
        + uvw[:, 2:3]
        * (np.sqrt(1.0 - srcs_l**2 - srcs_m**2) - 1.0)[None, :]
    )                                                   # [n, nsrc] metres
    scale = freqs / 299792458.0                         # [nch] 1/m
    arg = phase_geom[:, None, :] * scale[None, :, None]  # [n, nch, nsrc]
    vis = (np.exp(-2j * np.pi * arg) * flux[None, None, :]).sum(axis=2)

    return {
        "uvw": uvw,
        "vis": vis.reshape(cfg.ntime, nbl, cfg.nchan),
        "antenna1": a1,
        "antenna2": a2,
        "time": time,
        "frequency": freqs,
        "sources": np.stack([srcs_l, srcs_m, flux], axis=1),
        "n": n,
    }


def write_vis_file(path: str, obs) -> None:
    h5.create_file(path)
    h5.write_dataset(path, schema.VIS_VIS, obs["vis"].astype(np.complex128))
    h5.write_dataset(path, schema.VIS_UVW, obs["uvw"].astype(np.float64))
    h5.write_dataset(path, schema.VIS_ANTENNA1, obs["antenna1"])
    h5.write_dataset(path, schema.VIS_ANTENNA2, obs["antenna2"])
    h5.write_dataset(path, schema.VIS_TIME, obs["time"].astype(np.float64))
    h5.write_dataset(path, schema.VIS_FREQUENCY, obs["frequency"].astype(np.float64))


def w_plane_centers(obs, cfg: SyntheticConfig) -> np.ndarray:
    """Evenly spaced w-plane centers covering the observed ±w range (λ)."""
    f_top = float(obs["frequency"][-1])     # highest channel bounds |w|
    w_l = np.abs(obs["uvw"][:, 2]) * (f_top / 299792458.0)
    wmax = float(w_l.max()) * 1.05 + 1e-3
    return np.linspace(-wmax, wmax, cfg.nw_planes)


def wkern_bank(centers, cfg: SyntheticConfig) -> np.ndarray:
    """The oversampled w-kernel bank [nw, qpx, qpx, s, s] (unconjugated),
    one plane per center — what :func:`write_wkern_file` stores."""
    return np.stack([
        oracle.w_kernel(cfg.theta, float(w), qpx=cfg.qpx,
                        npix_ff=cfg.npix_ff, npix_kern=cfg.npix_kern)
        for w in centers
    ])


def write_wkern_file(path: str, centers, cfg: SyntheticConfig) -> None:
    """Synthesize and store the oversampled w-kernel bank (unconjugated)."""
    h5.create_file(path)
    for w, kern in zip(centers, wkern_bank(centers, cfg)):
        h5.write_dataset(
            path, schema.wkern_dataset(cfg.theta, schema.fmt_float(w)), kern
        )


def akern_stamps(obs, cfg: SyntheticConfig):
    """Near-delta A-kernels per antenna at a few times/frequencies: a list
    of ((antenna, time, frequency), [s, s] kernel) in the order
    :func:`write_akern_file` stores them.  The first time and frequency
    are the observation's own, so ``akerns_at_start`` picks those."""
    rng = np.random.default_rng(cfg.seed + 1)
    s = cfg.akern_size
    t0 = float(obs["time"][0])
    times = [t0, t0 + 0.02]
    freqs = [float(obs["frequency"][0]), float(obs["frequency"][0]) * 1.1]
    out = []
    for ant in range(cfg.nant):
        for tt in times:
            for ff in freqs:
                k = np.zeros((s, s), dtype=np.complex128)
                k[s // 2, s // 2] = 1.0
                k += 0.01 * (
                    rng.standard_normal((s, s)) + 1j * rng.standard_normal((s, s))
                )
                out.append(((ant, tt, ff), k))
    return out


def akerns_at_start(obs, cfg: SyntheticConfig) -> np.ndarray:
    """[nant, s, s] A-kernels at the observation's first time and
    frequency — what ``models.dataset.get_akernels`` selects from the
    file :func:`write_akern_file` writes."""
    t0 = float(obs["time"][0])
    f0 = float(obs["frequency"][0])
    return np.stack([k for (_, tt, ff), k in akern_stamps(obs, cfg)
                     if tt == t0 and ff == f0])


def write_akern_file(path: str, obs, cfg: SyntheticConfig) -> None:
    """Store :func:`akern_stamps` in the reference's akern tree layout."""
    h5.create_file(path)
    for (ant, tt, ff), k in akern_stamps(obs, cfg):
        h5.write_dataset(
            path,
            schema.akern_dataset(
                cfg.theta,
                str(ant),
                schema.fmt_float(tt),
                schema.fmt_float(ff),
            ),
            k,
        )


def generate_dataset(dirpath: str, cfg: SyntheticConfig = SyntheticConfig()):
    """Write vis/wkern/akern .h5 files; returns (paths dict, obs dict)."""
    os.makedirs(dirpath, exist_ok=True)
    obs = simulate_observation(cfg)
    paths = {
        "vis": os.path.join(dirpath, "vis.h5"),
        "wkern": os.path.join(dirpath, "wkern.h5"),
        "akern": os.path.join(dirpath, "akern.h5"),
    }
    write_vis_file(paths["vis"], obs)
    centers = w_plane_centers(obs, cfg)
    write_wkern_file(paths["wkern"], centers, cfg)
    write_akern_file(paths["akern"], obs, cfg)
    return paths, obs
