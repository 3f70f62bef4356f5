"""Multi-channel (spectral) imaging drivers.

The reference reads the whole ``/vis/frequency`` vector but images only
channel 0 (``/root/reference/src/ImageDataset.hs:99-106``).  These
drivers image EVERY channel at its own frequency, each gridded at its own
exact coordinates.

Physics: channel c's scaled baseline is uvw·f_c/c_light — a pure radial
dilation of the reference channel's by r = f_c/f_ref.  Channels are
planned into GROUPS host-side from the actual uv extent
(:func:`plan_channel_groups`): within a group the dilation moves no
record by more than a few cells, so the group shares one weighting
histogram; wideband data simply gets more groups.

Weighting: uniform weighting defaults to the GROUP-combined sample
density (one histogram at the group's reference channel, shared by its
members — the CASA/WSClean convention for multi-channel selections, and
one histogram per group instead of one per channel).
``SKA_SDP_TPU_EXACT_WEIGHTS=1`` selects per-channel histograms on each
channel's own scaled cells instead, making every channel's image
bit-comparable to a single-channel run of the same pipeline at that
frequency (the parity tests in ``tests/test_multichannel.py`` pin this
mode; see :func:`_weights_multi`).

Outputs: the per-channel dirty-image cube [nch, n, n] plus the channel
mean (the continuum image, written to ``/img`` for reference-layout
compatibility; the cube goes to ``/img_cube`` — ``io/schema.py``).
"""

from __future__ import annotations

import math
import os
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ImagingConfig
from ..io import h5, schema
from ..ops import (
    convgrid_wproj,
    doweight,
    find_closest,
    ifft_centered,
    make_grid_hermitian,
    mirror_uvw,
    uvw_lambda,
)
from ..utils.cplx import complex_safe_jit
from ..utils.timing import PhaseTimer
from .dataset import (
    get_akernels,
    get_wkernels,
    idg_aw_max_runs,
    load_vis_data,
)

C_LIGHT = 299792458.0


def plan_channel_groups(freqs, extent_cells: float, slack_cells: float):
    """Split channels into contiguous groups whose coordinate drift fits
    the per-channel recheck slack.

    For a group binned at its center frequency f_ref, channel c's scaled
    coordinates dilate by r = f_c/f_ref; a record at ``extent_cells``
    from the grid center moves by |r−1|·extent_cells cells.  The group is
    admissible when that stays ≤ ``slack_cells`` for every member.

    Greedy left-to-right with halving — O(nch log nch) host work.
    Returns a list of (start, stop, f_ref, drift_cells) tuples.
    """
    freqs = np.asarray(freqs, np.float64)
    nch = freqs.shape[0]
    groups = []
    i = 0
    while i < nch:
        j = nch
        while True:
            f_ref = 0.5 * (freqs[i] + freqs[j - 1])
            drift = float(
                np.max(np.abs(freqs[i:j] / f_ref - 1.0)) * extent_cells
            )
            if drift <= slack_cells or j == i + 1:
                break
            j = i + max(1, (j - i) // 2)
        groups.append((i, j, f_ref, int(math.ceil(drift))))
        i = j
    return groups


def uv_extent_cells(uvw, f_top: float, lam: float, n_grid: int) -> float:
    """Max |u|,|v| grid-cell distance from the grid center at the highest
    frequency — the lever arm of per-channel coordinate drift."""
    uvw_l = np.asarray(uvw)[:, :2] * (f_top / C_LIGHT)
    if uvw_l.size == 0:
        return 0.0
    return float(np.max(np.abs(uvw_l)) / lam * n_grid)


# ---------------------------------------------------------------------------
# jitted group pipelines
# ---------------------------------------------------------------------------


def _weights_multi(theta, lam, uvw0, ratios, n_live, exact: bool = False):
    """Per-channel uniform weights [g, n].

    Default: ONE sample-density histogram at the group's REFERENCE
    channel, shared by every channel of the group — the group planner
    already bounds each channel's uv-cell drift from f_ref, so the
    density estimate matches to the same tolerance (one scatter
    histogram per group instead of one per channel).
    ``exact=True`` (driver env ``SKA_SDP_TPU_EXACT_WEIGHTS=1``)
    restores per-channel histograms on each channel's own scaled cells
    (bit-parity with running the single-channel pipeline per channel).
    """
    ones = jnp.ones((uvw0.shape[0],), uvw0.dtype)
    del n_live
    if exact:
        def one(r):
            return jnp.real(doweight(theta, lam, uvw0 * r, ones))

        return jax.vmap(one)(ratios)
    w = jnp.real(doweight(theta, lam, uvw0, ones))
    return jnp.broadcast_to(w[None, :], (ratios.shape[0],
                                         uvw0.shape[0]))


def _group_vis(theta, lam, uvw0, ratios, vis_mc, exact_weights):
    """Weighted, mirrored channel-group visibilities [g, n] and the
    mirrored reference-channel uvw (wavelengths)."""
    wts = _weights_multi(theta, lam, uvw0, ratios, vis_mc.shape[1],
                         exact=exact_weights)
    uvw1, _ = mirror_uvw(uvw0, vis_mc[0])
    neg = uvw0[:, 1] < 0
    vis1 = jnp.where(neg[None, :], jnp.conj(vis_mc), vis_mc) \
        * wts.astype(vis_mc.dtype)
    return uvw1, vis1


def _taper_cube(grids, n_t, n_grid, crop_lo, subgrid, taper_beta):
    """Per-channel hermitian + iFFT + taper division (+ padded-FOV crop)."""
    from ..ops.idg import kaiser_taper, taper_fine

    img = jnp.real(ifft_centered(make_grid_hermitian(grids)))
    tf = taper_fine(n_grid, subgrid, kaiser_taper(subgrid, taper_beta)
                    ).astype(img.dtype)
    img = img / (tf[None, :, None] * tf[None, None, :])
    if n_grid != n_t:
        img = img * ((n_grid / n_t) ** 2)
        img = img[:, crop_lo:crop_lo + n_t, crop_lo:crop_lo + n_t]
    return img


@partial(complex_safe_jit,
         static_argnames=("theta", "lam", "g", "subgrid", "taper_beta",
                          "fov_pad", "exact_weights"))
def _idg_multi_pipeline(uvw, f_ref, ratios, vis_re_mc, vis_im_mc, *,
                        theta, lam, g, subgrid=64, taper_beta=12.0,
                        fov_pad=None, exact_weights=False):
    """One channel GROUP through plain IDG: channel c is gridded at its
    own dilated coordinates, with the group's shared weights.  Returns
    (cube [g, n, n], per-channel drop counts [g] — always zero: plain IDG
    drops nothing in bounds).

    The vis planes arrive as REAL re/im arrays so the driver can stage
    them onto the device explicitly and time the transfer under its own
    phase (see ``idg_gridding_multi``)."""
    from ..ops.idg import fov_pad_geometry, idg_grid_wproj

    vis_mc = jax.lax.complex(vis_re_mc, vis_im_mc)
    n_t, n_grid, theta_g, crop_lo = fov_pad_geometry(theta, lam, fov_pad)
    uvw0 = uvw_lambda(f_ref, uvw)                  # reference wavelengths
    uvw1, vis1 = _group_vis(theta, lam, uvw0, ratios, vis_mc, exact_weights)
    grids = jnp.stack([
        idg_grid_wproj(
            (n_grid, n_grid), uvw1 / lam * ratios[c], uvw1[:, 2] * ratios[c],
            vis1[c], theta=theta_g, subgrid=subgrid, taper_beta=taper_beta,
        )
        for c in range(g)
    ])
    img = _taper_cube(grids, n_t, n_grid, crop_lo, subgrid, taper_beta)
    return img, jnp.zeros((g,), jnp.int32)


@partial(complex_safe_jit,
         static_argnames=("theta", "lam", "g", "subgrid", "taper_beta",
                          "max_runs", "fov_pad", "exact_weights"))
def _idg_aw_multi_pipeline(screens, uvw, a1, a2, f_ref, ratios,
                           vis_re_mc, vis_im_mc, *,
                           theta, lam, g, subgrid=64, taper_beta=12.0,
                           max_runs=4096, fov_pad=None,
                           exact_weights=False):
    """One channel GROUP through IDG-AW (image-domain antenna screens):
    channel c is gridded at its own dilated coordinates.  Returns
    (cube [g, n, n], per-channel drop counts [g])."""
    from ..ops.idg import fov_pad_geometry
    from ..ops.idg_aw import idg_grid_aw

    vis_mc = jax.lax.complex(vis_re_mc, vis_im_mc)
    n_t, n_grid, theta_g, crop_lo = fov_pad_geometry(theta, lam, fov_pad)
    uvw0 = uvw_lambda(f_ref, uvw)
    uvw1, vis1 = _group_vis(theta, lam, uvw0, ratios, vis_mc, exact_weights)
    gs, ds = [], []
    for c in range(g):
        r = ratios[c]
        guv, nd = idg_grid_aw(
            (n_grid, n_grid), uvw1 / lam * r, a1, a2, uvw1[:, 2] * r,
            vis1[c], screens, theta=theta_g, subgrid=subgrid,
            taper_beta=taper_beta, max_runs=max_runs,
        )
        gs.append(guv)
        ds.append(nd)
    img = _taper_cube(jnp.stack(gs), n_t, n_grid, crop_lo, subgrid,
                      taper_beta)
    return img, jnp.stack(ds)


@partial(complex_safe_jit,
         static_argnames=("theta", "lam", "g", "chunk", "exact_weights"))
def _wproj_multi_pipeline(bank_conj, wbins, uvw, f_ref, ratios, vis_mc, *,
                          theta, lam, g, chunk=8192,
                          exact_weights=False):
    """One channel GROUP through w-projection.  The scatter needs no
    binning at all, so per-channel work is simply the scaled scatter — a
    ``lax.scan`` over channels sharing one compiled body.  Returns the
    cube [g, n, n]."""
    n_grid = int(round(theta * lam))
    uvw0 = uvw_lambda(f_ref, uvw)
    uvw1, vis1 = _group_vis(theta, lam, uvw0, ratios, vis_mc, exact_weights)

    def body(_, rv):
        r, vc = rv
        p_c = uvw1 * r / lam
        wbin = find_closest(wbins, uvw1[:, 2] * r)
        guv = convgrid_wproj(bank_conj, jnp.zeros((n_grid, n_grid), vc.dtype),
                             p_c, wbin, vc, chunk=chunk)
        return 0, guv

    _, grids = jax.lax.scan(body, 0,
                            (ratios.astype(uvw0.dtype), vis1))
    return jnp.real(ifft_centered(make_grid_hermitian(grids)))


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def _finish_cube(cube, outfile, timer):
    img_mean = cube.mean(axis=0)
    mx = float(img_mean.max()) if img_mean.size else 0.0
    if outfile is not None:
        with timer.phase("write/img"):
            h5.create_file(outfile)
            h5.write_dataset(outfile, schema.IMG_DATASET,
                             np.asarray(img_mean, np.float64))
            h5.write_dataset(outfile, schema.IMG_CUBE_DATASET,
                             np.asarray(cube, np.float64))
    return mx, img_mean


def _surface_drops(dropped_per_chan, n, timer):
    import sys

    total = int(np.sum(dropped_per_chan))
    timer.counters["multichannel/dropped"] = float(total)
    if total > 0:
        print(
            f"warning: multi-channel run dropped {total} channel-records "
            f"({100.0 * total / max(n, 1):.3f}% of channel-visibilities) "
            "that IDG-AW's pair-chunking could not place — "
            "per-channel counts: "
            + ",".join(str(int(d)) for d in dropped_per_chan),
            file=sys.stderr,
        )


def idg_gridding_multi(
    datfile: str,
    channels: int,
    n: Optional[int] = None,
    outfile: Optional[str] = None,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
    subgrid: int = 64,
    taper_beta: float = 12.0,
    fov_pad: Optional[float] = None,
):
    """Multi-channel IDG imaging: every channel imaged at its own
    frequency, binning amortized per channel group.  Returns
    (continuum-image max, continuum image, cube [nch, n, n])."""
    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam

    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    n = n if n is not None else data.vis.shape[0]
    nch = min(channels, data.frequencies.shape[0])
    freqs = np.asarray(data.frequencies[:nch], np.float64)
    with timer.phase("host/prep"):
        vis_mc = np.ascontiguousarray(
            data.vis_chan[:n, :nch].T.astype(prec.np_complex))

        from ..ops.idg import fov_pad_geometry

        _, n_grid, _, _ = fov_pad_geometry(theta, lam, fov_pad)
        ext = uv_extent_cells(data.uvw[:n], float(freqs.max()), lam,
                              n_grid)
        # channels of one group share one weighting histogram; the
        # slack bounds their uv-cell drift from the group's f_ref
        S, s = subgrid, 15
        slack = (S - s) // 2 - S // 4 - 1
        groups = plan_channel_groups(freqs, ext, max(slack, 1))

    cube = np.zeros((nch, int(round(theta * lam)), int(round(theta * lam))),
                    prec.np_real)
    drops = np.zeros((nch,), np.int64)
    # explicit h2d staging under its own phase, so the compute phase
    # below times device work only
    import jax as _jax

    with timer.phase("h2d/vis+uvw"):
        uvw_d = _jax.device_put(np.asarray(data.uvw[:n], prec.np_real))
        vr_d = _jax.device_put(np.ascontiguousarray(vis_mc.real))
        vi_d = _jax.device_put(np.ascontiguousarray(vis_mc.imag))
        _jax.block_until_ready((uvw_d, vr_d, vi_d))
    with timer.phase("compile+grid+fft"):
        imgs = []
        for (i, j, f_ref, _drift) in groups:
            ratios = (freqs[i:j] / f_ref).astype(prec.np_real)
            img, masked = _idg_multi_pipeline(
                uvw_d, np.asarray(f_ref, prec.np_real),
                ratios, vr_d[i:j], vi_d[i:j],
                theta=theta, lam=lam, g=j - i, subgrid=subgrid,
                taper_beta=taper_beta, fov_pad=fov_pad,
                exact_weights=_exact_weights(),
            )
            imgs.append((i, j, img, masked))
        _jax.block_until_ready([im for (_, _, im, _) in imgs])
    with timer.phase("d2h/cube"):
        for (i, j, img, masked) in imgs:
            cube[i:j] = np.asarray(img)
            drops[i:j] = np.asarray(masked)
    _surface_drops(drops, n, timer)
    mx, img_mean = _finish_cube(cube, outfile, timer)
    return mx, img_mean, cube


def aw_idg_gridding_multi(
    afile: str,
    datfile: str,
    channels: int,
    n: Optional[int] = None,
    outfile: Optional[str] = None,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
    subgrid: int = 64,
    taper_beta: float = 12.0,
    fov_pad: Optional[float] = None,
):
    """Multi-channel IDG-AW imaging (direction-dependent antenna screens).
    A-kernels are picked at the closest time/frequency per GROUP (the
    reference's closest-slot semantics, per group center).  Returns
    (continuum max, continuum image, cube)."""
    from ..ops.idg import fov_pad_geometry
    from ..ops.idg_aw import aw_screens_host

    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam

    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    n = n if n is not None else data.vis.shape[0]
    nch = min(channels, data.frequencies.shape[0])
    freqs = np.asarray(data.frequencies[:nch], np.float64)
    with timer.phase("host/prep"):
        vis_mc = np.ascontiguousarray(
            data.vis_chan[:n, :nch].T.astype(prec.np_complex))
        a1 = np.asarray(data.antenna1[:n], np.int64)
        a2 = np.asarray(data.antenna2[:n], np.int64)

        n_t, n_grid, _, _ = fov_pad_geometry(theta, lam, fov_pad)
        fov_scale = n_grid / n_t
        ext = uv_extent_cells(data.uvw[:n], float(freqs.max()), lam,
                              n_grid)
        margin_full = subgrid // 2 - 15 // 2 - 12
        # channels of one group share one weighting histogram
        groups = plan_channel_groups(freqs, ext, max(margin_full // 2, 1))

    cube = np.zeros((nch, n_t, n_t), prec.np_real)
    drops = np.zeros((nch,), np.int64)
    # explicit h2d staging + device-phase split: same contract as
    # idg_gridding_multi
    import jax as _jax

    with timer.phase("h2d/vis+uvw"):
        uvw_d = _jax.device_put(np.asarray(data.uvw[:n], prec.np_real))
        a1_d = _jax.device_put(a1.astype(np.int32))
        a2_d = _jax.device_put(a2.astype(np.int32))
        vr_d = _jax.device_put(np.ascontiguousarray(vis_mc.real))
        vi_d = _jax.device_put(np.ascontiguousarray(vis_mc.imag))
        _jax.block_until_ready((uvw_d, a1_d, a2_d, vr_d, vi_d))
    with timer.phase("compile+grid+fft"):
        imgs = []
        for (i, j, f_ref, _drift) in groups:
            with timer.phase("ingest/akern"):
                akerns = get_akernels(afile, theta, float(data.time[0]),
                                      f_ref)
            screens = aw_screens_host(
                np.asarray(akerns, prec.np_complex), subgrid,
                fov_scale=fov_scale,
            ).astype(prec.np_complex)
            ratios = (freqs[i:j] / f_ref).astype(prec.np_real)
            max_runs = idg_aw_max_runs(
                uvw_d, np.asarray(f_ref, prec.np_real), a1_d, a2_d,
                theta=theta, lam=lam, subgrid=subgrid, fov_pad=fov_pad,
                ratios=[float(r) for r in ratios])
            img, nd = _idg_aw_multi_pipeline(
                screens, uvw_d, a1_d, a2_d,
                np.asarray(f_ref, prec.np_real),
                ratios, vr_d[i:j], vi_d[i:j],
                theta=theta, lam=lam, g=j - i, subgrid=subgrid,
                taper_beta=taper_beta, max_runs=max_runs,
                fov_pad=fov_pad, exact_weights=_exact_weights(),
            )
            imgs.append((i, j, img, nd))
        _jax.block_until_ready([im for (_, _, im, _) in imgs])
    with timer.phase("d2h/cube"):
        for (i, j, img, nd) in imgs:
            cube[i:j] = np.asarray(img)
            drops[i:j] = np.asarray(nd)
    _surface_drops(drops, n, timer)
    mx, img_mean = _finish_cube(cube, outfile, timer)
    return mx, img_mean, cube


def w_gridding_multi(
    wfile: str,
    datfile: str,
    channels: int,
    n: Optional[int] = None,
    outfile: Optional[str] = None,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
):
    """Multi-channel w-projection imaging.  The resident-grid scatter
    consumes records in arbitrary order (no binning), so channels scan
    through one kernel instance with scaled coordinates.  Returns
    (continuum max, continuum image, cube)."""
    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam

    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("ingest/wkern"):
        wkerns, wbins = get_wkernels(wfile, theta)
    n = n if n is not None else data.vis.shape[0]
    nch = min(channels, data.frequencies.shape[0])
    freqs = np.asarray(data.frequencies[:nch], np.float64)
    vis_mc = np.ascontiguousarray(
        data.vis_chan[:n, :nch].T.astype(prec.np_complex))

    # one group: w-projection has no binning to drift out of; the w-plane
    # assignment re-runs per channel (find_closest on scaled w)
    f_ref = 0.5 * (freqs[0] + freqs[-1])
    ratios = (freqs / f_ref).astype(prec.np_real)
    with timer.phase("h2d+compile+grid+fft"):
        cube = _wproj_multi_pipeline(
            np.conj(np.asarray(wkerns, prec.np_complex)),
            np.asarray(wbins, prec.np_real),
            np.asarray(data.uvw[:n], prec.np_real),
            np.asarray(f_ref, prec.np_real),
            ratios, vis_mc,
            theta=theta, lam=lam, g=nch, chunk=min(8192, max(256, n)),
            exact_weights=_exact_weights(),
        )
        cube = np.asarray(cube)
    mx, img_mean = _finish_cube(cube, outfile, timer)
    return mx, img_mean, cube


def idg_gridding_multi_sharded(
    datfile: str,
    channels: int,
    n: Optional[int] = None,
    outfile: Optional[str] = None,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
    subgrid: int = 64,
    taper_beta: float = 12.0,
    mesh=None,
):
    """Multi-chip multi-channel IDG imaging: records
    shard over the mesh's visibility axes, each channel grids
    vis-parallel with one psum per channel merging the partial grids
    (``parallel.sharded.make_sharded_spectral_idg_step``).

    Semantics match the local driver (``_idg_multi_pipeline``): channel c
    is gridded at its OWN dilated coordinates, while uniform weights stay
    GROUP-shared (one
    globally-psum'd histogram at the group's reference channel, the
    same convention as the local driver).  Records are padded to a mesh
    multiple with zero-weight masked entries, so any record count is
    exact.

    Multi-process: every process calls this with the same arguments
    under ``jax.distributed`` (``parallel.initialize``); each passes its
    process-local slice and the cube is replicated to all.  Only
    process 0 writes ``outfile``.  Returns (continuum max, continuum
    image, cube [nch, n, n]).
    """
    import jax as _jax
    from jax.sharding import NamedSharding, PartitionSpec as _P

    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import make_sharded_spectral_idg_step

    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam
    if mesh is None:
        mesh = make_mesh()
    ndev = int(mesh.devices.size)
    axes = tuple(mesh.axis_names)

    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    n = n if n is not None else data.vis.shape[0]
    nch = min(channels, data.frequencies.shape[0])
    freqs = np.asarray(data.frequencies[:nch], np.float64)
    with timer.phase("host/prep"):
        n_pad = ((n + ndev - 1) // ndev) * ndev
        uvw_h = np.zeros((n_pad, 3), prec.np_real)
        uvw_h[:n] = np.asarray(data.uvw[:n], prec.np_real)
        mask_h = np.zeros((n_pad,), prec.np_real)
        mask_h[:n] = 1.0
        vis_h = np.zeros((nch, n_pad), prec.np_complex)
        vis_h[:, :n] = data.vis_chan[:n, :nch].T
        # group planning shares the weights histogram exactly like the
        # local driver (the gridding itself is per-channel exact here)
        n_grid = int(round(theta * lam))
        ext = uv_extent_cells(data.uvw[:n], float(freqs.max()), lam,
                              n_grid)
        slack = (subgrid - 15) // 2 - subgrid // 4 - 1
        groups = plan_channel_groups(freqs, ext, max(slack, 1))

    with timer.phase("h2d/shard"):
        vspec = NamedSharding(mesh, _P(axes))
        cspec = NamedSharding(mesh, _P(None, axes))
        nproc = _jax.process_count()
        if nproc > 1:
            per = n_pad // nproc
            pid = _jax.process_index()
            sl = slice(pid * per, (pid + 1) * per)
            uvw_d = _jax.make_array_from_process_local_data(
                vspec, np.ascontiguousarray(uvw_h[sl]), (n_pad, 3))
            mask_d = _jax.make_array_from_process_local_data(
                vspec, np.ascontiguousarray(mask_h[sl]), (n_pad,))
            vr_d = _jax.make_array_from_process_local_data(
                cspec, np.ascontiguousarray(vis_h.real[:, sl]),
                (nch, n_pad))
            vi_d = _jax.make_array_from_process_local_data(
                cspec, np.ascontiguousarray(vis_h.imag[:, sl]),
                (nch, n_pad))
        else:
            uvw_d = _jax.device_put(uvw_h, vspec)
            mask_d = _jax.device_put(mask_h, vspec)
            vr_d = _jax.device_put(np.ascontiguousarray(vis_h.real), cspec)
            vi_d = _jax.device_put(np.ascontiguousarray(vis_h.imag), cspec)

    cube = np.zeros((nch, n_grid, n_grid), prec.np_real)
    with timer.phase("compile+grid+fft"):
        steps = {}
        imgs = []
        for (i, j, f_ref, _drift) in groups:
            g = j - i
            if g not in steps:
                steps[g] = make_sharded_spectral_idg_step(
                    mesh, theta, lam, g, subgrid=subgrid,
                    taper_beta=taper_beta)
            ratios = jnp.asarray((freqs[i:j] / f_ref), prec.np_real)
            img = steps[g](uvw_d, mask_d,
                           jnp.asarray(f_ref, prec.np_real), ratios,
                           vr_d[i:j], vi_d[i:j])
            imgs.append((i, j, img))
        _jax.block_until_ready([im for (_, _, im) in imgs])
    with timer.phase("d2h/cube"):
        for (i, j, img) in imgs:
            cube[i:j] = np.asarray(img)
    if _jax.process_index() == 0:
        mx, img_mean = _finish_cube(cube, outfile, timer)
    else:  # non-zero processes return the same numbers, write nothing
        mx, img_mean = _finish_cube(cube, None, timer)
    return mx, img_mean, cube


def _exact_weights() -> bool:
    """SKA_SDP_TPU_EXACT_WEIGHTS=1: per-channel uniform-weight
    histograms on each channel's own scaled uv cells (see
    :func:`_weights_multi`); read per driver call and passed as a
    static arg so changing it retraces."""
    return os.environ.get("SKA_SDP_TPU_EXACT_WEIGHTS", "0") == "1"
