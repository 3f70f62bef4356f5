#!/usr/bin/env python3
"""Smoke test of the imaging main path on one NVIDIA GPU, at full width.

Run from the repository root on a machine with a GPU::

    python3 chip_smoke.py              # one card: every imaging mode
    python3 chip_smoke.py --four-gpus  # four cards: the --distributed path

Data: the SKA1-Low shape of the reference (2400² uv-grid, theta=0.008,
lam=300000) with 64 antennas × 512 times = 1,032,192 visibilities, a
32-plane qpx=8 bank of 15² w-kernels and 15² A-kernels, all generated from
``--seed`` by ``ska_sdp_tpu.io.synthetic`` (the data ``--make-data``
writes).  Every phase runs the array-level driver the CLI mode calls
(``models.dataset.w_image`` and friends): host preparation plus the jitted
device program.  HDF5 ingest and output are not part of the smoke.

Phases (one card):

1. ``w``: w-projection with the kernel bank, ``idg``: image-domain
   gridding, ``aw_idg``: IDG-AW, ``aw``: bank AW, ``predict_idg`` and
   ``predict_w``: degridding of the IDG and w images.  Each prints its
   cold time (compilation or compile-cache load included), warm time,
   image peak and checks.
2. ``parity``: each operator those modes use, jitted once and run on the
   GPU and on the host CPU backend of this same process with identical
   2^16-visibility float32 inputs at the full 2400² width.
3. Image truth: for the IDG modes a float64 direct-DFT dirty image at 257
   pixels of the central 75% FOV; for the bank modes the image peak must
   sit on an injected source.

The last line of standard output is one JSON object
``{"ok": true, "device": {...}}``, printed only when every check passed.
Without a GPU, or with any failed check, the script exits non-zero and
prints no such line.  One process drives the card(s).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

C_LIGHT = 299792458.0
THETA, LAM = 0.008, 300000          # the CLI defaults: a 2400² grid
NANT, NTIME, NW, QPX = 64, 512, 32, 8
SUBGRID = 64                        # the CLI's --subgrid default
N_PARITY = 1 << 16
N_ORACLE = 1 << 12
N_TRUTH_PIXELS = 256

# Limits, each with the precision it is taken at and its reason.
LIMITS = {
    # GPU vs host CPU, same jitted function, float32/complex64 on both,
    # relative Frobenius error.
    # Bank operators (w-projection grid/degrid, bank AW): identical kernel
    # taps (ops.coords.frac_coord has no contractible multiply-add), so
    # only summation order differs — the GPU's atomic scatter-add sums a
    # cell's contributions in a run-dependent order and reductions
    # associate differently: ~sqrt(k)·6e-8 relative for k terms.
    "parity_bank_rel": 1e-5,
    # IDG and IDG-AW: matmuls pinned HIGHEST (true FP32, no TF32) on both,
    # but the float32 record positions N/2 + p·N (~2464 cells, ulp 2.4e-4
    # cells) are rounded once with the GPU's fused multiply-add and twice
    # on the CPU, and the two sin/cos libraries differ by ~1 ulp of
    # arguments up to ~110 rad: phase differences up to ~1e-4 rad, a few
    # 1e-5 relative in the grid.
    "parity_idg_rel": 1e-4,
    # GPU float32 w-projection grid vs the float64 numpy oracle
    # (utils/oracle.convgrid_wproj) on records placed at least 1/4 of an
    # oversampling step from a tap boundary, so both precisions pick the
    # same taps: complex64 taps and float32 accumulation, ~1e-7 expected.
    "oracle_rel": 1e-5,
    # IDG dirty image vs the float64 direct-DFT truth with the run's own
    # (float32) uniform weights, central 75% FOV: the documented IDG
    # envelope (ops/idg.py idg_fov_pad_plan: <=5e-5 inside r<=0.75,
    # Fresnel w-term split ~3e-6 rad) plus float32 positions.
    "truth_rel": 1e-4,
    # bank modes: L1 pixel distance of the image peak from the nearest
    # injected source — the tolerance of the CPU tests of those modes
    # (tests/test_end_to_end.py::test_peak_is_at_a_source).
    "peak_px": 3.0,
    # --four-gpus: sharded image vs the one-card image of the same data,
    # max |difference| over the peak (psum order + per-shard scatter order;
    # IDG compared in its accurate central 75% FOV).
    "sharded_rel": 1e-5,
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_name_and_power() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return r.stdout.strip() or f"nvidia-smi gave nothing (rc={r.returncode})"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


# ---------------------------------------------------------------------------
# float64 host truth
# ---------------------------------------------------------------------------


def uniform_weights(uvw, freq: float, theta: float, lam: int,
                    dtype=np.float64) -> np.ndarray:
    """1 / (records in the record's uv cell) for uvw in metres —
    ``ops.doweight`` semantics (qpx=1 cells of the unmirrored uvw).

    ``dtype`` is the precision the cells are found in, with the same
    operations the pipeline applies (uvw·(f/c), /lam, ·n, round): float32
    reproduces the weights a single-precision run gives each record;
    float64 is ``utils.oracle.doweight``.  A record within float32
    rounding of a cell edge can change cells between the two, and with
    it the weights of both cells' records."""
    n = int(round(theta * lam))
    scale = dtype(freq) / dtype(C_LIGHT)
    p = (np.asarray(uvw, dtype) * scale) / dtype(lam)
    k = np.round(p[:, :2] * dtype(n)).astype(np.int64) + n // 2
    _, inv, cnt = np.unique(k[:, 1] * n + k[:, 0], return_inverse=True,
                            return_counts=True)
    return 1.0 / cnt[inv.ravel()]


def fine_screens(akerns, n: int, ys, xs) -> np.ndarray:
    """A-screens [nant, npix] at image pixels (ys, xs) — the full-grid
    evaluation of what ``ops.idg_aw.aw_screens`` samples on subgrids."""
    ak = np.asarray(akerns, np.complex128)
    s = ak.shape[-1]
    j = np.arange(s) - s // 2
    ey = np.exp(-2j * np.pi * np.outer((np.asarray(ys) - n // 2) / n, j))
    ex = np.exp(-2j * np.pi * np.outer((np.asarray(xs) - n // 2) / n, j))
    return np.einsum("pj,ajk,pk->ap", ey, ak, ex)


def dirty_image_truth(uvw, vis, freq: float, theta: float, lam: int, ys, xs,
                      a1=None, a2=None, akerns=None, chunk: int = 8192,
                      weights_dtype=np.float32):
    """float64 direct-DFT dirty image at pixels (ys, xs).

    The imaging pipelines' semantics: uvw (metres) scaled to wavelengths,
    uniform weights from the unmirrored cells (found in ``weights_dtype``,
    the run's precision — see :func:`uniform_weights`), records mirrored
    into v >= 0 (uvw negated, vis conjugated), hermitian completion (the
    2·Re below) and the centered inverse FFT's 1/N² — with the exact
    w-screen e^{-2πi w (1 - sqrt(1 - l² - m²))}.  With ``akerns`` each
    record also carries conj(A_a1)·conj(A_a2), the IDG-AW gridding screen.
    """
    n = int(round(theta * lam))
    uvw0 = np.asarray(uvw, np.float64) * (float(freq) / C_LIGHT)
    wt = uniform_weights(uvw, freq, theta, lam, weights_dtype)
    neg = uvw0[:, 1] < 0
    uvw1 = np.where(neg[:, None], -uvw0, uvw0)
    vis1 = np.where(neg, np.conj(vis), vis).astype(np.complex128) * wt
    ys = np.asarray(ys)
    xs = np.asarray(xs)
    l = (xs - n // 2) * theta / n
    m = (ys - n // 2) * theta / n
    nlm = 1.0 - np.sqrt(1.0 - l * l - m * m)
    scr = None if akerns is None else np.conj(fine_screens(akerns, n, ys, xs))
    out = np.zeros(ys.shape[0])
    for s0 in range(0, uvw1.shape[0], chunk):
        u = uvw1[s0:s0 + chunk]
        ph = 2.0 * np.pi * (np.outer(u[:, 0], l) + np.outer(u[:, 1], m)
                            - np.outer(u[:, 2], nlm))
        term = vis1[s0:s0 + chunk, None] * np.exp(1j * ph)
        if scr is not None:
            term *= scr[a1[s0:s0 + chunk]] * scr[a2[s0:s0 + chunk]]
        out += np.real(term.sum(axis=0))
    return 2.0 * out / (n * n)


def central_disc(n: int) -> np.ndarray:
    """[n, n] mask of the central 75% FOV: radius <= 0.75 of the image
    half-width, where ops/idg.py documents the IDG error envelope (the
    taper division amplifies rounding toward the edges and corners)."""
    r = np.arange(n) - n // 2
    return r[:, None] ** 2 + r[None, :] ** 2 <= (0.375 * n) ** 2


def truth_pixels(n: int, rng, peak_yx) -> tuple:
    """256 random pixels of the central 75% FOV plus the image peak."""
    ys, xs = np.nonzero(central_disc(n))
    pick = rng.choice(ys.size, N_TRUTH_PIXELS, replace=False)
    return np.r_[ys[pick], peak_yx[0]], np.r_[xs[pick], peak_yx[1]]


def rel_err(got, want) -> float:
    got = np.asarray(got)
    want = np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


class Smoke:
    def __init__(self):
        self.failures = []

    def check(self, phase: str, name: str, value: float, limit: float,
              ok: bool) -> None:
        print(f"  check {phase}/{name}: {value:.3e} (limit {limit:.1e}) "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failures.append(f"{phase}/{name}={value:.3e} "
                                 f"(limit {limit:.1e})")

    def run(self, phase: str, fn):
        """Call ``fn`` twice (cold, then warm) and print both times."""
        try:
            t0 = time.perf_counter()
            fn()
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = fn()
            warm = time.perf_counter() - t0
        except Exception as e:             # report, then fail the smoke
            self.failures.append(f"{phase}: {type(e).__name__}: {e}")
            print(f"phase {phase}: ERROR {type(e).__name__}: {e}",
                  flush=True)
            return None
        print(f"phase {phase}: cold {cold:.3f} s (compile or cache load "
              f"included), warm {warm:.3f} s", flush=True)
        return out


def peak_on_source(img, sources, lam: int) -> float:
    n = img.shape[0]
    iy, ix = np.unravel_index(np.argmax(img), img.shape)
    return min(abs(iy - (n / 2 + m * lam)) + abs(ix - (n / 2 + l * lam))
               for l, m, _ in sources)


def make_data(seed: int):
    from ska_sdp_tpu.io import synthetic
    from ska_sdp_tpu.models.dataset import vis_data_from_observation

    cfg = synthetic.SyntheticConfig(theta=THETA, lam=LAM, nant=NANT,
                                    ntime=NTIME, nw_planes=NW, qpx=QPX,
                                    seed=seed)
    obs = synthetic.simulate_observation(cfg)
    centers = synthetic.w_plane_centers(obs, cfg)
    bank = synthetic.wkern_bank(centers, cfg)
    akerns = synthetic.akerns_at_start(obs, cfg)
    return cfg, obs, vis_data_from_observation(obs), bank, centers, akerns


def single_card(smoke: Smoke, seed: int) -> None:
    import jax

    from ska_sdp_tpu.config import GridParams, ImagingConfig
    from ska_sdp_tpu.models import dataset as ds
    from ska_sdp_tpu.utils.timing import PhaseTimer

    t0 = time.perf_counter()
    cfg, obs, data, bank, centers, akerns = make_data(seed)
    n_vis = data.vis.shape[0]
    print(f"data: {n_vis} visibilities, {NANT} antennas x {NTIME} times, "
          f"{int(round(THETA * LAM))}^2 grid, w bank {bank.shape}, "
          f"A-kernels {akerns.shape} (seed {seed}; generated in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    config = ImagingConfig(grid=GridParams(theta=THETA, lam=LAM))
    rng = np.random.default_rng(seed + 17)
    n = config.grid.n

    # -- 1. w-projection with the kernel bank
    res = smoke.run("w", lambda: ds.w_image(data, bank, centers,
                                            config=config))
    img_w = None
    if res is not None:
        mx, img_w = res
        print(f"  peak {mx:.6f}", flush=True)
        d = peak_on_source(img_w, obs["sources"], LAM)
        smoke.check("w", "peak_px_from_source", d, LIMITS["peak_px"],
                    d <= LIMITS["peak_px"])

    # -- 2. image-domain gridding
    res = smoke.run("idg", lambda: ds.idg_image(data, config=config,
                                                subgrid=SUBGRID))
    img_idg = None
    if res is not None:
        mx, img_idg = res
        print(f"  peak {mx:.6f}", flush=True)
        ys, xs = truth_pixels(n, rng, np.unravel_index(np.argmax(img_idg),
                                                       img_idg.shape))
        t = time.perf_counter()
        truth = dirty_image_truth(data.uvw, data.vis, data.frequency, THETA,
                                  LAM, ys, xs)
        e = rel_err(img_idg[ys, xs], truth)
        print(f"  truth: {ys.size} pixels, float64 direct DFT on the host "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
        smoke.check("idg", "truth_rel", e, LIMITS["truth_rel"],
                    e <= LIMITS["truth_rel"])

    # -- 3. IDG-AW
    timer = PhaseTimer(enabled=False)
    res = smoke.run("aw_idg", lambda: ds.aw_image(
        data, akerns, config=config, timer=timer, idg=True,
        subgrid=SUBGRID))
    if res is not None:
        mx, img = res
        nd = timer.counters.get("idg_aw/dropped", float("nan"))
        print(f"  peak {mx:.6f}, idg_aw/dropped {nd:.0f}", flush=True)
        smoke.check("aw_idg", "dropped", nd, 0.0, nd == 0)
        ys, xs = truth_pixels(n, rng, np.unravel_index(np.argmax(img),
                                                       img.shape))
        truth = dirty_image_truth(
            data.uvw, data.vis, data.frequency, THETA, LAM, ys, xs,
            a1=data.antenna1, a2=data.antenna2, akerns=akerns)
        e = rel_err(img[ys, xs], truth)
        smoke.check("aw_idg", "truth_rel", e, LIMITS["truth_rel"],
                    e <= LIMITS["truth_rel"])

    # -- 4. bank AW (the CLI's default mode)
    res = smoke.run("aw", lambda: ds.aw_image(data, akerns, bank, centers,
                                              config=config))
    if res is not None:
        mx, img = res
        print(f"  peak {mx:.6f}", flush=True)
        d = peak_on_source(img, obs["sources"], LAM)
        smoke.check("aw", "peak_px_from_source", d, LIMITS["peak_px"],
                    d <= LIMITS["peak_px"])

    # -- 5. degridding: predict from the IDG and the w images
    for name, fn in (
        ("predict_idg", lambda: ds.idg_predict_vis(
            data, img_idg, config=config, subgrid=SUBGRID)),
        ("predict_w", lambda: ds.w_predict_vis(
            data, bank, centers, img_w, config=config)),
    ):
        if (img_idg if name == "predict_idg" else img_w) is None:
            smoke.failures.append(f"{name}: no model image")
            continue
        pred = smoke.run(name, fn)
        if pred is not None:
            ok = pred.shape == (n_vis,) and bool(np.all(np.isfinite(pred)))
            peak = float(np.abs(pred).max())
            print(f"  {pred.shape[0]} predicted visibilities, peak |vis| "
                  f"{peak:.6f}", flush=True)
            smoke.check(name, "finite_shape_nonzero", float(ok and peak > 0),
                        1.0, ok and peak > 0)

    parity(smoke, data, bank, centers, akerns, seed)


def parity(smoke: Smoke, data, bank, centers, akerns, seed: int) -> None:
    """Each operator, jitted once, on the GPU and on the host CPU with
    identical float32 inputs: 2^16 visibilities at the full grid width."""
    import jax
    import jax.numpy as jnp

    from ska_sdp_tpu.models.dataset import idg_aw_max_runs
    from ska_sdp_tpu.ops import (convgrid_aw, convgrid_wproj, degrid_wproj,
                                 find_closest)
    from ska_sdp_tpu.ops.idg import idg_degrid_wproj, idg_grid_wproj
    from ska_sdp_tpu.ops.idg_aw import (aw_screens_host, idg_degrid_aw,
                                        idg_grid_aw)
    from ska_sdp_tpu.utils import oracle

    n = int(round(THETA * LAM))
    k = N_PARITY
    uvw0 = np.asarray(data.uvw[:k], np.float64) * (data.frequency / C_LIGHT)
    vis0 = np.asarray(data.vis[:k], np.complex128)
    neg = uvw0[:, 1] < 0
    uvw1 = np.where(neg[:, None], -uvw0, uvw0)
    vis1 = np.where(neg, np.conj(vis0), vis0).astype(np.complex64)
    p = (uvw1 / LAM).astype(np.float32)
    w = uvw1[:, 2].astype(np.float32)
    a1 = np.asarray(data.antenna1[:k], np.int32)
    a2 = np.asarray(data.antenna2[:k], np.int32)
    c32 = np.asarray(centers, np.float32)
    wbin = np.asarray(find_closest(jnp.asarray(c32), jnp.asarray(w)))
    bank64 = np.asarray(bank, np.complex64)
    bank_conj = np.conj(bank64)
    ak64 = np.asarray(akerns, np.complex64)
    scr = aw_screens_host(ak64, SUBGRID).astype(np.complex64)
    max_runs = idg_aw_max_runs(
        np.asarray(data.uvw[:k], np.float32), np.float32(data.frequency),
        a1, a2, theta=THETA, lam=LAM, subgrid=SUBGRID, mirror=True)
    rng = np.random.default_rng(seed + 29)
    grid = (rng.standard_normal((n, n))
            + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    z = np.zeros((n, n), np.complex64)
    kw = dict(theta=THETA, subgrid=SUBGRID)

    ops = {
        "wproj_grid": (lambda b, g, p, wb, v: convgrid_wproj(
            b, g, p, wb, v, chunk=8192), (bank_conj, z, p, wbin, vis1)),
        "wproj_degrid": (lambda b, g, p, wb: degrid_wproj(
            b, g, p, wb, chunk=8192), (bank64, grid, p, wbin)),
        "idg_grid": (lambda p, w, v: idg_grid_wproj(
            (n, n), p, w, v, **kw), (p, w, vis1)),
        "idg_degrid": (lambda p, w, g: idg_degrid_wproj(
            (n, n), p, w, g, **kw), (p, w, grid)),
        "idg_aw_grid": (lambda p, a1, a2, w, v, s: idg_grid_aw(
            (n, n), p, a1, a2, w, v, s, max_runs=max_runs, **kw),
            (p, a1, a2, w, vis1, scr)),
        "idg_aw_degrid": (lambda p, a1, a2, w, g, s: idg_degrid_aw(
            (n, n), p, a1, a2, w, g, s, max_runs=max_runs, **kw),
            (p, a1, a2, w, grid, scr)),
        "aw_grid": (lambda b, a, g, p, wb, a1, a2, v: convgrid_aw(
            b, a, g, p, wb, a1, a2, v, chunk=8192),
            (bank64, ak64, z, p, wbin, a1, a2, vis1)),
    }
    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    print(f"parity: {k} visibilities at {n}^2, jitted operators on "
          f"{gpu.device_kind} vs host CPU, float32/complex64 on both",
          flush=True)
    for name, (fn, args) in ops.items():
        f = jax.jit(fn)
        try:
            t0 = time.perf_counter()
            got = jax.tree_util.tree_map(
                np.asarray, f(*jax.device_put(args, gpu)))
            t_gpu = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = jax.tree_util.tree_map(
                np.asarray, f(*jax.device_put(args, cpu)))
            t_cpu = time.perf_counter() - t0
        except Exception as e:
            smoke.failures.append(f"parity/{name}: {type(e).__name__}: {e}")
            print(f"  parity {name}: ERROR {type(e).__name__}: {e}",
                  flush=True)
            continue
        if isinstance(got, tuple):            # IDG-AW: (values, n_dropped)
            if int(got[1]) != int(want[1]):
                smoke.failures.append(f"parity/{name}: dropped "
                                      f"{int(got[1])} vs {int(want[1])}")
            print(f"  {name}: dropped {int(got[1])} (gpu) "
                  f"{int(want[1])} (cpu)", flush=True)
            got, want = got[0], want[0]
        e = rel_err(got, want)
        lim = LIMITS["parity_idg_rel" if name.startswith("idg")
                     else "parity_bank_rel"]
        print(f"  {name}: gpu {t_gpu:.2f} s, cpu {t_cpu:.2f} s (both incl. "
              "compile)", flush=True)
        smoke.check("parity", name + "_rel", e, lim, e <= lim)

    # the GPU w-projection grid of the first 2^12 records vs the float64
    # numpy oracle, each record moved to within 1/4 oversampling step of
    # a tap centre: float32 rounding then cannot change its tap
    j = N_ORACLE
    step = float(n * QPX)
    k = np.round(p[:j, :2].astype(np.float64) * step)
    ps = p[:j].copy()
    ps[:, :2] = ((k + rng.uniform(-0.25, 0.25, k.shape)) / step
                 ).astype(np.float32)
    t0 = time.perf_counter()
    want = oracle.convgrid_wproj(
        np.conj(np.asarray(bank, np.complex128)), np.zeros((n, n),
                                                           np.complex128),
        ps.astype(np.float64), wbin[:j], vis1[:j].astype(np.complex128))
    got = np.asarray(jax.jit(lambda b, g, p, wb, v: convgrid_wproj(
        b, g, p, wb, v, chunk=4096))(
        *jax.device_put((bank_conj, z, ps, wbin[:j], vis1[:j]), gpu)))
    e = rel_err(got, want)
    print(f"  oracle: {j} records, float64 numpy oracle "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    smoke.check("oracle", "wproj_grid_rel", e, LIMITS["oracle_rel"],
                e <= LIMITS["oracle_rel"])


def four_cards(smoke: Smoke, seed: int) -> None:
    """``--distributed`` (the visibility-sharded psum step of modes w and
    idg) over all four cards, against the one-card image of the data."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ska_sdp_tpu.config import GridParams, ImagingConfig
    from ska_sdp_tpu.models import dataset as ds
    from ska_sdp_tpu.parallel.mesh import VIS_AXIS, make_mesh
    from ska_sdp_tpu.parallel.sharded import sharded_image

    cfg, obs, data, bank, centers, akerns = make_data(seed)
    config = ImagingConfig(grid=GridParams(theta=THETA, lam=LAM))
    prec = config.precision
    mesh = make_mesh()
    print(f"mesh: {mesh.devices.size} devices {list(mesh.devices.ravel())}, "
          f"axes {mesh.axis_names}", flush=True)
    if mesh.devices.size != 4:
        smoke.failures.append(f"--four-gpus needs 4 devices, JAX sees "
                              f"{mesh.devices.size}")
        return
    sharding = NamedSharding(mesh, P(VIS_AXIS))
    uvw = jax.device_put(np.asarray(data.uvw, prec.np_real), sharding)
    vis = jax.device_put(np.asarray(data.vis, prec.np_complex), sharding)
    shards = sorted((str(s.device), s.data.shape)
                    for s in uvw.addressable_shards)
    print(f"uvw shards: {shards}", flush=True)
    ok = len({d for d, _ in shards}) == 4
    smoke.check("sharding", "devices_holding_shards", len(shards), 4, ok)

    for mode, single in (
        ("w", lambda: ds.w_image(data, bank, centers, config=config)),
        ("idg", lambda: ds.idg_image(data, config=config, subgrid=SUBGRID)),
    ):
        img = smoke.run(f"distributed_{mode}", lambda: np.asarray(
            sharded_image(mesh, mode, uvw, vis, data.frequency, theta=THETA,
                          lam=LAM, precision=prec, subgrid=SUBGRID,
                          wkerns=bank, wbins=centers)))
        ref = smoke.run(f"single_card_{mode}", single)
        if img is None or ref is None:
            continue
        ref = ref[1]
        if mode == "idg":
            disc = central_disc(ref.shape[0])
            img, ref = img[disc], ref[disc]
        d = float(np.abs(img - ref).max() / np.abs(ref).max())
        print(f"  peak sharded {img.max():.6f}, one card {ref.max():.6f} "
              f"({'central 75% FOV' if mode == 'idg' else 'whole image'})",
              flush=True)
        smoke.check(f"distributed_{mode}", "max_abs_diff_over_peak", d,
                    LIMITS["sharded_rel"], d <= LIMITS["sharded_rel"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1234,
                    help="seed of the synthetic observation and kernels")
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the --distributed path over four cards "
                         "and the one-card image it is compared with")
    args = ap.parse_args(argv)

    # the parity phase runs operators on the host CPU backend of this same
    # process, so keep it available next to the GPU
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"
    try:
        import jax

        import ska_sdp_tpu  # noqa: F401
        from ska_sdp_tpu.utils.cache import enable_compile_cache
    except ImportError as e:
        fail(f"cannot import the package ({e}); run from the repository "
             "root")
    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU: JAX selected {devs[0].platform!r} "
             f"({devs[0].device_kind})")
    cache = enable_compile_cache()
    print(gpu_name_and_power(), flush=True)     # e.g. "NVIDIA H200, 700.00 W"
    print(f"jax {jax.__version__} devices: {devs}", flush=True)
    print(f"compile cache: {cache}", flush=True)
    print("HDF5 ingest and output: not exercised (the smoke drives the "
          "array-level drivers on generated data)", flush=True)

    smoke = Smoke()
    t0 = time.perf_counter()
    if args.four_gpus:
        four_cards(smoke, args.seed)
    else:
        single_card(smoke, args.seed)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if smoke.failures:
        fail("; ".join(smoke.failures))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
