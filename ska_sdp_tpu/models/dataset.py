"""End-to-end dataset driver: HDF5 in → AW/w-projection imaging → HDF5 out.

Rebuild of the reference's L6 layer
(``/root/reference/src/ImageDataset.hs:29-148`` ``aw_gridding`` +
``getAKernels``/``getWKernels``): ingest visibilities and kernel banks,
preprocess uvw, run the imaging pipeline under one ``jax.jit``, Hermitian-
complete, inverse-FFT, return the dirty image and its maximum, optionally
writing ``/img`` back to HDF5.

Each file-level driver (``w_gridding``, ``idg_gridding``, ``aw_gridding``
and the ``*_predict`` drivers) is ingest → an array-level function
(``w_image``, ``idg_image``, ``aw_image``, ``w_predict_vis``,
``idg_predict_vis``, ``aw_predict_vis``) → write.  The array-level
functions hold everything between the two — host-side preparation and
the jitted device program — and take a :class:`VisData` plus kernel
arrays, so a caller with data already in memory runs the same path
without HDF5.

Host/device split: HDF5, kernel selection and run bounds happen on the
host with numpy; the single jitted device program covers uvw scaling →
weighting → mirroring → gridding → hermitian → ifft (the reference JITs
the same region via its ``run`` backend injection,
``ImageDataset.hs:76-77``).
"""

from __future__ import annotations

import sys
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ImagingConfig
from ..io import h5, schema
from ..ops import (
    convgrid_wproj,
    degrid_wproj,
    doweight,
    fft_centered,
    find_closest,
    ifft_centered,
    make_grid_hermitian,
    mirror_uvw,
    uvw_lambda,
)
from ..ops.idg import (
    fov_pad_finish,
    fov_pad_geometry,
    fov_pad_start,
    idg_degrid_wproj,
    idg_grid_wproj,
    kaiser_taper,
    taper_fine,
)
from ..ops.idg_aw import (
    aw_screens_host,
    count_pair_tile_runs,
    idg_degrid_aw,
    idg_grid_aw,
)
from ..utils.cplx import complex_safe_jit
from ..utils.timing import PhaseTimer
from .imaging import aw_imaging


class VisData(NamedTuple):
    vis: np.ndarray        # [n] complex — channel 0 (reference semantics)
    uvw: np.ndarray        # [n, 3] float (metres)
    antenna1: np.ndarray   # [n] int64
    antenna2: np.ndarray   # [n] int64
    time: np.ndarray       # [n] float
    frequency: float       # channel 0 (Hz) — reference uses only this
    vis_chan: np.ndarray = None    # [n, nch] complex — all channels
    frequencies: np.ndarray = None  # [nch] float64 (Hz)


def _require_file(path: str) -> None:
    """Fail fast with a clear message when an input file is absent.

    The reference checks file existence before every read
    (``src/Hdf5.hs:117-118``); same contract here.
    """
    import os

    p = path if path.endswith(".h5") else path + ".h5"
    if not os.path.exists(p):
        raise FileNotFoundError(f"input HDF5 file does not exist: {p}")


def _vis_data(raw, uvw, a1, a2, t, f) -> VisData:
    """Assemble a :class:`VisData` from the /vis arrays.

    The rank-3 vis block's trailing axis is the spectral channel; the
    reference flattens it and images every (record, channel) at the
    channel-0 frequency (``ImageDataset.hs:99-106`` reads the whole
    frequency vector, uses only element 0).  We keep that reference
    semantics in ``vis``/``frequency`` (channel 0 only) and expose the
    full spectral data as ``vis_chan [n, nch]`` + ``frequencies [nch]``
    for the multi-channel drivers (``channels=`` arguments).
    """
    f = np.asarray(f, np.float64).reshape(-1)
    nch = f.shape[0]
    if nch > 1 and raw.ndim >= 1 and raw.shape[-1] == nch:
        vis_chan = raw.reshape(-1, nch)
    else:
        vis_chan = raw.reshape(-1, 1)     # single channel (or legacy file)
    return VisData(vis_chan[:, 0], uvw, a1, a2, t, float(f[0]),
                   vis_chan, f[:vis_chan.shape[1]])


def load_vis_data(datfile: str) -> VisData:
    """Read the /vis tree (reference readVis/readBaselines/readSource,
    ``ImageDataset.hs:86-106``)."""
    _require_file(datfile)
    return _vis_data(
        h5.read_dataset(datfile, schema.VIS_VIS, dtype=np.complex128),
        h5.read_dataset(datfile, schema.VIS_UVW, dtype=np.float64),
        h5.read_dataset(datfile, schema.VIS_ANTENNA1, dtype=np.int64),
        h5.read_dataset(datfile, schema.VIS_ANTENNA2, dtype=np.int64),
        h5.read_dataset(datfile, schema.VIS_TIME, dtype=np.float64),
        h5.read_dataset(datfile, schema.VIS_FREQUENCY, dtype=np.float64),
    )


def vis_data_from_observation(obs) -> VisData:
    """The :class:`VisData` that :func:`load_vis_data` returns for a file
    written from ``io.synthetic.simulate_observation``'s ``obs``."""
    return _vis_data(
        np.asarray(obs["vis"], np.complex128),
        np.asarray(obs["uvw"], np.float64),
        np.asarray(obs["antenna1"], np.int64),
        np.asarray(obs["antenna2"], np.int64),
        np.asarray(obs["time"], np.float64),
        obs["frequency"],
    )


def _closest(sorted_pairs, x: float) -> str:
    vals = [v for v, _ in sorted_pairs]
    idx = int(np.argmin([abs(v - x) for v in vals]))
    return sorted_pairs[idx][1]


def get_akernels(afile: str, theta: float, t: float, f: float) -> np.ndarray:
    """Stack per-antenna A-kernels at the closest time & frequency → [nant,s,s].

    Reference ``getAKernels`` (``ImageDataset.hs:108-133``).  Note: the
    reference accidentally searches the *time* list when picking the closest
    frequency (``ImageDataset.hs:125`` uses tsSorted); we search the actual
    frequency list — a deliberate bug-fix divergence.
    """
    _require_file(afile)
    ants = schema.parse_sorted(h5.list_group(afile, schema.akern_group(theta)))
    a0 = ants[0][1]
    times = schema.parse_sorted(
        h5.list_group(afile, f"{schema.akern_group(theta)}/{a0}")
    )
    closest_t = _closest(times, t)
    freqs = schema.parse_sorted(
        h5.list_group(afile, f"{schema.akern_group(theta)}/{a0}/{closest_t}")
    )
    closest_f = _closest(freqs, f)
    names = [
        schema.akern_dataset(theta, ant, closest_t, closest_f) for _, ant in ants
    ]
    return h5.read_datasets_stacked(afile, names, dtype=np.complex128)


def get_wkernels(wfile: str, theta: float):
    """Load the w-kernel bank sorted by plane center → ([nw,qpx,qpx,s,s], [nw]).

    Reference ``getWKernels`` (``ImageDataset.hs:136-148``).
    """
    _require_file(wfile)
    wbins = schema.parse_sorted(h5.list_group(wfile, schema.wkern_group(theta)))
    names = [schema.wkern_dataset(theta, name) for _, name in wbins]
    bank = h5.read_datasets_stacked(wfile, names, dtype=np.complex128)
    centers = np.array([v for v, _ in wbins], dtype=np.float64)
    return bank, centers


def _write_img(outfile, img, timer) -> None:
    if outfile is not None:
        with timer.phase("write/img"):
            h5.create_file(outfile)
            h5.write_dataset(outfile, schema.IMG_DATASET,
                             np.asarray(img).astype(np.float64))


def _write_model_vis(outfile, pred, timer, phase="write/vis") -> None:
    if outfile is not None:
        with timer.phase(phase):
            h5.create_file(outfile)
            h5.write_dataset(outfile, "/vis/model",
                             pred.astype(np.complex128))


def _read_model(modelfile, theta, lam, timer) -> np.ndarray:
    with timer.phase("ingest/model"):
        img = np.asarray(h5.read_dataset(modelfile, schema.IMG_DATASET))
    n_grid = int(round(theta * lam))
    if img.shape != (n_grid, n_grid):
        raise ValueError(
            f"model image {img.shape} does not match grid "
            f"({n_grid}, {n_grid}) for theta={theta}, lam={lam}"
        )
    return img


def _taper_correct(img, n, n_grid, crop_lo, subgrid, taper_beta):
    """Divide the IDG dirty image by the subgrid taper's fine-grid
    interpolation and crop a padded FOV back to the target grid."""
    tf = taper_fine(n_grid, subgrid, kaiser_taper(subgrid, taper_beta)
                    ).astype(img.dtype)
    img = img / (tf[:, None] * tf[None, :])
    return fov_pad_finish(img, n, n_grid, crop_lo)


def _model_grid(img, n, n_grid, crop_lo, subgrid, taper_beta):
    """Model image → uv-grid for IDG degridding: embed in the padded FOV,
    divide by the taper, forward FFT."""
    imgp = fov_pad_start(img, n, n_grid, crop_lo)
    tf = taper_fine(n_grid, subgrid, kaiser_taper(subgrid, taper_beta))
    tf2 = (tf[:, None] * tf[None, :]).astype(img.dtype)
    return fft_centered((imgp / tf2).astype(
        jnp.complex64 if img.dtype == jnp.float32 else jnp.complex128))


@partial(jax.jit, static_argnames=("lam", "n_grid", "subgrid", "mirror"))
def _run_count(uvw, f, a1, a2, ratio, *, lam, n_grid, subgrid, mirror):
    uvw0 = uvw_lambda(f, uvw)
    if mirror:
        uvw0, _ = mirror_uvw(uvw0, jnp.zeros((uvw.shape[0],), jnp.complex64))
    return count_pair_tile_runs((n_grid, n_grid), uvw0 / lam * ratio, a1, a2,
                                subgrid=subgrid)


def idg_aw_max_runs(uvw, f, a1, a2, *, theta, lam, subgrid, fov_pad=None,
                    mirror=True, ratios=(1.0,)) -> int:
    """Static ``max_runs`` for IDG-AW on these records.

    The exact (pair, uv-tile) run count of the chunking
    (``ops.idg_aw.count_pair_tile_runs``) on the coordinates the pipeline
    grids — mirrored for gridding, unmirrored for degridding, dilated by
    each channel ``ratio`` — plus 1/64 + 64 slack for float rounding
    between this count and the jitted pipeline's own coordinates, rounded
    up to a multiple of 1024 so similar datasets share one compiled
    program.  Records are never dropped for want of runs; drops that do
    occur are still counted by the gridder."""
    _, n_grid, _, _ = fov_pad_geometry(theta, lam, fov_pad)
    runs = max(
        int(_run_count(uvw, f, a1, a2, r, lam=lam, n_grid=n_grid,
                       subgrid=subgrid, mirror=mirror))
        for r in ratios)
    bound = runs + runs // 64 + 64
    return -(-bound // 1024) * 1024


@partial(complex_safe_jit, static_argnames=("theta", "lam", "chunk"))
def _aw_pipeline(wkerns, wbins, akerns, uvw, a1, a2, ts, f, vis, *, theta,
                 lam, chunk):
    """The jitted device program: preprocess → AW grid → hermitian → image."""
    uvw0 = uvw_lambda(f, uvw)
    wt = doweight(theta, lam, uvw0, jnp.ones_like(vis))
    uvw1, vis1 = mirror_uvw(uvw0, vis)
    src = (a1, a2, ts, f)
    guv = aw_imaging(
        theta, lam, wkerns, wbins, akerns, uvw1, src, wt * vis1, chunk=chunk,
    )
    img = jnp.real(ifft_centered(make_grid_hermitian(guv)))
    return img, jnp.max(img)


def _wproj_staged(bank_conj, wbins, uvw, f, vis, *, theta, lam, chunk,
                  timer, dump_to=None):
    """Stage-synchronized w-projection pipeline for device-time
    attribution (see ``w_image(device_phases=True)``).

    Complex data never crosses the host boundary: stages exchange (re, im)
    real planes; intermediates stay on device between dispatches.
    """
    n_grid = int(round(theta * lam))
    timer.dispatch_floor()

    @partial(jax.jit, static_argnames=("theta", "lam"))
    def prep(wbins, uvw, f, vr, vi, *, theta, lam):
        uvw0 = uvw_lambda(f, uvw)
        wt = doweight(theta, lam, uvw0, jnp.ones_like(vr))
        uvw1, vis1 = mirror_uvw(uvw0, jax.lax.complex(vr, vi))
        vis1 = vis1 * wt.astype(vis1.dtype)
        wbin = find_closest(wbins, uvw1[:, 2])
        return uvw1, wbin, jnp.real(vis1), jnp.imag(vis1)

    @partial(jax.jit, static_argnames=("lam", "chunk"))
    def scatter(bank_re, bank_im, uvw1, wbin, vr1, vi1, *, lam, chunk):
        bank = jax.lax.complex(bank_re, bank_im)
        vis1 = jax.lax.complex(vr1, vi1)
        g = convgrid_wproj(bank, jnp.zeros((n_grid, n_grid), vis1.dtype),
                           uvw1 / lam, wbin, vis1, chunk=chunk)
        return jnp.real(g), jnp.imag(g)

    @jax.jit
    def image(g_re, g_im):
        g = jax.lax.complex(g_re, g_im)
        img = jnp.real(ifft_centered(make_grid_hermitian(g)))
        return img, jnp.max(img)

    vr = np.ascontiguousarray(np.asarray(vis).real)
    vi = np.ascontiguousarray(np.asarray(vis).imag)
    bank_re = np.ascontiguousarray(np.asarray(bank_conj).real)
    bank_im = np.ascontiguousarray(np.asarray(bank_conj).imag)

    uvw1, wbin, vr1, vi1 = timer.device_stage(
        "preprocess", prep, wbins, uvw, f, vr, vi, theta=theta, lam=lam)
    g_re, g_im = timer.device_stage(
        "scatter", scatter, bank_re, bank_im, uvw1, wbin, vr1, vi1,
        lam=lam, chunk=chunk)
    img, mx = timer.device_stage("hermitian+ifft", image, g_re, g_im)
    if dump_to is not None:
        # debug-dump the pipeline intermediates — the asserted-pipeline
        # analog of the reference's GridTesting.hs convolveTest.h5 dumps
        # (/root/reference/test/GridTesting.hs:538-546)
        h5.create_file(dump_to)
        h5.write_dataset(dump_to, "/debug/uvgrid_re",
                         np.asarray(g_re, np.float32))
        h5.write_dataset(dump_to, "/debug/uvgrid_im",
                         np.asarray(g_im, np.float32))
        h5.write_dataset(dump_to, "/debug/wbin",
                         np.asarray(wbin, np.int32))
        h5.write_dataset(dump_to, "/debug/img",
                         np.asarray(img, np.float32))
    return np.asarray(img), float(mx)


@partial(complex_safe_jit, static_argnames=("theta", "lam", "chunk"))
def _wproj_pipeline(bank_conj, wbins, uvw, f, vis, *, theta, lam, chunk):
    """w-projection-only device program (headline bench config)."""
    uvw0 = uvw_lambda(f, uvw)
    wt = doweight(theta, lam, uvw0, jnp.ones_like(vis))
    uvw1, vis1 = mirror_uvw(uvw0, vis)
    n = int(round(theta * lam))
    wbin = find_closest(wbins, uvw1[:, 2])
    guv = convgrid_wproj(bank_conj, jnp.zeros((n, n), vis1.dtype),
                         uvw1 / lam, wbin, wt * vis1, chunk=chunk)
    img = jnp.real(ifft_centered(make_grid_hermitian(guv)))
    return img, jnp.max(img)


def _aw_fused_staged(wkerns, wbins, akerns, uvw, a1, a2, ts, f, vis, *,
                     theta, lam, chunk, timer):
    """Stage-synchronized bank-AW pipeline (``--device-phases --mode
    aw``): preprocess / AW gridder / hermitian+iFFT device times
    (cf. ``_aw_pipeline``; results identical, cross-stage fusion lost)."""
    timer.dispatch_floor()

    @partial(jax.jit, static_argnames=("theta", "lam"))
    def prep(uvw, f, vr, vi, *, theta, lam):
        uvw0 = uvw_lambda(f, uvw)
        wt = doweight(theta, lam, uvw0, jnp.ones_like(vr))
        uvw1, vis1 = mirror_uvw(uvw0, jax.lax.complex(vr, vi))
        vis1 = vis1 * wt.astype(vis1.dtype)
        return uvw1, jnp.real(vis1), jnp.imag(vis1)

    @partial(jax.jit, static_argnames=("theta", "lam", "chunk"))
    def kern(wk_re, wk_im, wbins, ak_re, ak_im, uvw1, a1, a2, ts, f,
             vr1, vi1, *, theta, lam, chunk):
        g = aw_imaging(
            theta, lam, jax.lax.complex(wk_re, wk_im), wbins,
            jax.lax.complex(ak_re, ak_im), uvw1, (a1, a2, ts, f),
            jax.lax.complex(vr1, vi1), chunk=chunk,
        )
        return jnp.real(g), jnp.imag(g)

    @jax.jit
    def image(g_re, g_im):
        g = jax.lax.complex(g_re, g_im)
        img = jnp.real(ifft_centered(make_grid_hermitian(g)))
        return img, jnp.max(img)

    vr = np.ascontiguousarray(np.asarray(vis).real)
    vi = np.ascontiguousarray(np.asarray(vis).imag)
    uvw1, vr1, vi1 = timer.device_stage(
        "preprocess", prep, uvw, f, vr, vi, theta=theta, lam=lam)
    g_re, g_im = timer.device_stage(
        "aw-grid", kern,
        np.ascontiguousarray(np.asarray(wkerns).real),
        np.ascontiguousarray(np.asarray(wkerns).imag),
        np.asarray(wbins),
        np.ascontiguousarray(np.asarray(akerns).real),
        np.ascontiguousarray(np.asarray(akerns).imag),
        uvw1, a1, a2, ts, f, vr1, vi1,
        theta=theta, lam=lam, chunk=chunk)
    img, mx = timer.device_stage("hermitian+ifft", image, g_re, g_im)
    return np.asarray(img), float(mx)


def _aw_idg_staged(screens, uvw, a1, a2, f, vis, *, theta, lam, subgrid,
                   taper_beta, max_runs, timer, fov_pad=None):
    """Stage-synchronized IDG-AW pipeline (``--device-phases --mode aw
    --idg``): preprocess / grid / image device times
    (cf. ``_aw_idg_pipeline``; same fov_pad semantics)."""
    n, n_grid, theta_g, crop_lo = fov_pad_geometry(theta, lam, fov_pad)
    timer.dispatch_floor()

    @partial(jax.jit, static_argnames=("theta", "lam"))
    def prep(uvw, f, vr, vi, *, theta, lam):
        uvw0 = uvw_lambda(f, uvw)
        wt = doweight(theta, lam, uvw0, jnp.ones_like(vr))
        uvw1, vis1 = mirror_uvw(uvw0, jax.lax.complex(vr, vi))
        vis1 = vis1 * wt.astype(vis1.dtype)
        return uvw1, jnp.real(vis1), jnp.imag(vis1)

    @jax.jit
    def grid_stage(uvw1, a1, a2, vr1, vi1, s_re, s_im):
        g, nd = idg_grid_aw(
            (n_grid, n_grid), uvw1 / lam, a1, a2, uvw1[:, 2],
            jax.lax.complex(vr1, vi1),
            jax.lax.complex(s_re, s_im), theta=theta_g,
            subgrid=subgrid, taper_beta=taper_beta,
            max_runs=max_runs,
        )
        return jnp.real(g), jnp.imag(g), nd

    @jax.jit
    def image(g_re, g_im):
        g = jax.lax.complex(g_re, g_im)
        img = jnp.real(ifft_centered(make_grid_hermitian(g)))
        img = _taper_correct(img, n, n_grid, crop_lo, subgrid, taper_beta)
        return img, jnp.max(img)

    vr = np.ascontiguousarray(np.asarray(vis).real)
    vi = np.ascontiguousarray(np.asarray(vis).imag)
    s_re = np.ascontiguousarray(np.asarray(screens).real)
    s_im = np.ascontiguousarray(np.asarray(screens).imag)
    uvw1, vr1, vi1 = timer.device_stage(
        "preprocess", prep, uvw, f, vr, vi, theta=theta, lam=lam)
    g_re, g_im, nd = timer.device_stage(
        "idg-aw-grid", grid_stage, uvw1, a1, a2, vr1, vi1, s_re, s_im)
    img, mx = timer.device_stage("hermitian+ifft+taper", image, g_re, g_im)
    return np.asarray(img), float(mx), int(nd)


@partial(complex_safe_jit,
         static_argnames=("theta", "lam", "subgrid", "taper_beta",
                          "max_runs", "fov_pad"))
def _aw_idg_pipeline(screens, uvw, a1, a2, f, vis, *, theta, lam,
                     subgrid=64, taper_beta=12.0, max_runs=4096,
                     fov_pad=None):
    """IDG-AW device program: image-domain A-screens on pair-chunked
    subgrids (``ops/idg_aw.py``) — continuous w, no w-kernel bank.

    ``fov_pad`` follows ``_idg_pipeline``'s padded-FOV/crop semantics
    (the A-screens are θ-independent — integer-cell taps sampled at the
    subgrid's own lattice — so padding only rescales the grid).

    Returns (img, img max, n_dropped): ``n_dropped`` is the IDG-AW
    honesty count (in-bounds records whose chunk could not cover their
    uv spread — zero for track-like layouts; the caller must surface it).
    """
    uvw0 = uvw_lambda(f, uvw)
    n, n_grid, theta_g, crop_lo = fov_pad_geometry(theta, lam, fov_pad)
    # uniform weighting ALWAYS uses the target-FOV uv histogram: fov_pad
    # is a numerical-accuracy device and must not change the weighting
    # semantics (the padded grid's finer uv cells would)
    wt = doweight(theta, lam, uvw0, jnp.ones_like(vis))
    uvw1, vis1 = mirror_uvw(uvw0, vis)
    guv, nd = idg_grid_aw(
        (n_grid, n_grid), uvw1 / lam, a1, a2, uvw1[:, 2], wt * vis1,
        screens, theta=theta_g, subgrid=subgrid, taper_beta=taper_beta,
        max_runs=max_runs,
    )
    img = jnp.real(ifft_centered(make_grid_hermitian(guv)))
    img = _taper_correct(img, n, n_grid, crop_lo, subgrid, taper_beta)
    return img, jnp.max(img), nd


def _aw_screens(akerns, theta, lam, subgrid, fov_pad, prec):
    """Host screens for IDG-AW, sampled at the GRIDDING FOV's angular
    scale — with fov_pad the grid FOV is theta·n_pad/n (``aw_screens``
    docstring; delta stamps are scale-invariant, real ones are not)."""
    n_t, n_g, _, _ = fov_pad_geometry(theta, lam, fov_pad)
    return aw_screens_host(np.asarray(akerns, prec.np_complex), subgrid,
                           fov_scale=n_g / n_t).astype(prec.np_complex)


def aw_image(
    data: VisData,
    akerns,
    wkerns=None,
    wbins=None,
    n: Optional[int] = None,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
    idg: bool = False,
    fov_pad: Optional[float] = None,
    subgrid: int = 64,
    device_phases: bool = False,
):
    """AW-projection imaging of in-memory data (the array-level half of
    :func:`aw_gridding`).  ``idg=False`` grids with the on-the-fly
    A1⊛A2⊛W bank kernels (``wkerns``/``wbins`` required); ``idg=True``
    with image-domain A-screens (IDG-AW), whose drop count goes to
    ``timer.counters["idg_aw/dropped"]`` and to stderr when non-zero.
    Returns (image max, image ndarray)."""
    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam
    n = n if n is not None else data.vis.shape[0]
    uvw = np.asarray(data.uvw[:n], prec.np_real)
    f = np.asarray(data.frequency, prec.np_real)
    vis = np.asarray(data.vis[:n], prec.np_complex)
    a1 = np.asarray(data.antenna1[:n], np.int32)
    a2 = np.asarray(data.antenna2[:n], np.int32)
    if idg:
        with timer.phase("h2d+compile+grid+fft"):
            max_runs = idg_aw_max_runs(uvw, f, a1, a2, theta=theta, lam=lam,
                                       subgrid=subgrid, fov_pad=fov_pad)
            screens = _aw_screens(akerns, theta, lam, subgrid, fov_pad, prec)
            kw = dict(theta=theta, lam=lam, subgrid=subgrid, taper_beta=12.0,
                      max_runs=max_runs, fov_pad=fov_pad)
            if device_phases:
                img, mx, nd = _aw_idg_staged(screens, uvw, a1, a2, f, vis,
                                             timer=timer, **kw)
            else:
                img, mx, nd = _aw_idg_pipeline(screens, uvw, a1, a2, f, vis,
                                               **kw)
            img = np.asarray(img)
            mx = float(mx)
            nd = int(nd)
        if nd > 0:
            print(f"warning: IDG-AW dropped {nd}/{n} visibilities "
                  f"({100.0 * nd / max(n, 1):.2f}%) whose uv spread "
                  "exceeded their pair-chunk's subgrid — the data is not "
                  "track-ordered enough for IDG-AW; use the bank AW mode",
                  file=sys.stderr)
        timer.counters["idg_aw/dropped"] = float(nd)
        return mx, img
    with timer.phase("h2d+compile+grid+fft"):
        # complex data stays numpy until the complex-safe jit boundary
        aw_args = (
            np.asarray(wkerns, prec.np_complex),
            np.asarray(wbins, prec.np_real),
            np.asarray(akerns, prec.np_complex),
            uvw, a1, a2,
            np.asarray(data.time[:n], prec.np_real),
            f, vis,
        )
        chunk = min(8192, max(256, n))
        if device_phases:
            img, mx = _aw_fused_staged(*aw_args, theta=theta, lam=lam,
                                       chunk=chunk, timer=timer)
        else:
            img, mx = _aw_pipeline(*aw_args, theta=theta, lam=lam,
                                   chunk=chunk)
        img = np.asarray(img)
        mx = float(mx)
    return mx, img


def aw_gridding(
    wfile: str,
    afile: str,
    datfile: str,
    n: Optional[int] = None,
    outfile: Optional[str] = None,
    old: bool = False,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
    idg: bool = False,
    fov_pad: Optional[float] = None,
    subgrid: int = 64,
    device_phases: bool = False,
):
    """Full AW-projection imaging run (reference ``aw_gridding``,
    ``ImageDataset.hs:29-83``).  Returns (image max, image ndarray).

    ``device_phases=True`` runs stage-synchronized variants with
    per-stage device times (``_aw_fused_staged`` / ``_aw_idg_staged``) —
    the observability analog of the reference's ``dump_phases``.

    ``old`` selects the reference's convgrid3 scheduling variant; our batched
    gridder is numerically identical for both, so it only changes logging.
    ``idg=True`` selects the IDG-AW mode (image-domain A-screens on
    pair-chunked subgrids, ``ops/idg_aw.py``): exact continuous-w, needs
    no w-kernel file; chunking drops are surfaced as a warning.
    """
    timer = timer or PhaseTimer()
    theta = config.grid.theta
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("ingest/akern"):
        akerns = get_akernels(afile, theta, float(data.time[0]), data.frequency)
    wkerns = wbins = None
    if not idg:
        with timer.phase("ingest/wkern"):
            wkerns, wbins = get_wkernels(wfile, theta)
    mx, img = aw_image(data, akerns, wkerns, wbins, n=n, config=config,
                       timer=timer, idg=idg, fov_pad=fov_pad,
                       subgrid=subgrid, device_phases=device_phases)
    _write_img(outfile, img, timer)
    return mx, img


def w_image(
    data: VisData,
    wkerns,
    wbins,
    n: Optional[int] = None,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
    device_phases: bool = False,
    dump_intermediates: Optional[str] = None,
):
    """w-projection imaging of in-memory data (the array-level half of
    :func:`w_gridding`).  Returns (image max, image ndarray)."""
    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam
    n = n if n is not None else data.vis.shape[0]
    args = (
        np.conj(np.asarray(wkerns, prec.np_complex)),
        np.asarray(wbins, prec.np_real),
        np.asarray(data.uvw[:n], prec.np_real),
        np.asarray(data.frequency, prec.np_real),
        np.asarray(data.vis[:n], prec.np_complex),
    )
    chunk = min(8192, max(256, n))
    if device_phases or dump_intermediates:
        img, mx = _wproj_staged(*args, theta=theta, lam=lam, chunk=chunk,
                                timer=timer, dump_to=dump_intermediates)
        return mx, img
    with timer.phase("h2d+compile+grid+fft"):
        img, mx = _wproj_pipeline(*args, theta=theta, lam=lam, chunk=chunk)
        # the blocking fetch belongs INSIDE the phase: jit dispatch is
        # async, so without it the phase measures only trace/dispatch
        img = np.asarray(img)
        mx = float(mx)
    return mx, img


def w_gridding(
    wfile: str,
    datfile: str,
    n: Optional[int] = None,
    outfile: Optional[str] = None,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
    device_phases: bool = False,
    dump_intermediates: Optional[str] = None,
):
    """w-projection-only imaging run (no A-kernels): the headline benchmark
    configuration (BASELINE.md config #2).

    ``device_phases=True`` runs the pipeline as separately-synchronized
    stages (preprocess / scatter / hermitian+iFFT) so per-stage device
    times are attributable — the observability analog of the reference's
    Accelerate ``dump_phases``.  Results are identical; the staged run
    loses cross-stage fusion and each stage's time includes one dispatch
    round-trip (reported as dispatch-floor).
    """
    timer = timer or PhaseTimer()
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("ingest/wkern"):
        wkerns, wbins = get_wkernels(wfile, config.grid.theta)
    mx, img = w_image(data, wkerns, wbins, n=n, config=config, timer=timer,
                      device_phases=device_phases,
                      dump_intermediates=dump_intermediates)
    _write_img(outfile, img, timer)
    return mx, img


def _idg_staged(uvw, f, vis, *, theta, lam, subgrid, taper_beta, timer,
                fov_pad=None):
    """Stage-synchronized IDG pipeline: preprocess / grid /
    hermitian+ifft+taper device times (cf. ``_idg_pipeline``; same
    ``fov_pad`` padded-FOV/crop semantics)."""
    n, n_grid, theta_g, crop_lo = fov_pad_geometry(theta, lam, fov_pad)
    timer.dispatch_floor()

    @partial(jax.jit, static_argnames=("theta", "lam"))
    def prep(uvw, f, vr, vi, *, theta, lam):
        uvw0 = uvw_lambda(f, uvw)
        wt = doweight(theta, lam, uvw0, jnp.ones_like(vr))
        uvw1, vis1 = mirror_uvw(uvw0, jax.lax.complex(vr, vi))
        vis1 = vis1 * wt.astype(vis1.dtype)
        return uvw1, jnp.real(vis1), jnp.imag(vis1)

    @jax.jit
    def grid_stage(uvw1, vr1, vi1):
        g = idg_grid_wproj(
            (n_grid, n_grid), uvw1 / lam, uvw1[:, 2],
            jax.lax.complex(vr1, vi1), theta=theta_g, subgrid=subgrid,
            taper_beta=taper_beta,
        )
        return jnp.real(g), jnp.imag(g)

    @jax.jit
    def image(g_re, g_im):
        g = jax.lax.complex(g_re, g_im)
        img = jnp.real(ifft_centered(make_grid_hermitian(g)))
        img = _taper_correct(img, n, n_grid, crop_lo, subgrid, taper_beta)
        return img, jnp.max(img)

    vr = np.ascontiguousarray(np.asarray(vis).real)
    vi = np.ascontiguousarray(np.asarray(vis).imag)
    # weighting on the TARGET theta (fov_pad must not change weights)
    uvw1, vr1, vi1 = timer.device_stage(
        "preprocess", prep, uvw, f, vr, vi, theta=theta, lam=lam)
    g_re, g_im = timer.device_stage("idg-grid", grid_stage, uvw1, vr1, vi1)
    img, mx = timer.device_stage("hermitian+ifft+taper", image, g_re, g_im)
    return np.asarray(img), float(mx)


@partial(complex_safe_jit,
         static_argnames=("theta", "lam", "subgrid", "taper_beta",
                          "fov_pad"))
def _idg_pipeline(uvw, f, vis, *, theta, lam, subgrid, taper_beta,
                  fov_pad=None):
    """Image-domain-gridding device program.

    Same step shape as ``_wproj_pipeline`` but the gridder is IDG (no
    kernel bank needed — the w screens are applied analytically) and the
    final image is taper-corrected.

    ``fov_pad`` (a fraction f ≤ 1, e.g. 0.75) grids a padded FOV θ/f at
    the same pixel size and crops the center, bounding the FULL
    target-FOV error at ~1e-3 (``ops.idg.idg_fov_pad_plan`` for the
    measured radial error profile).  ``None`` images the plain FOV —
    quantifiably accurate inside ~75–87% of the image radius.
    """
    uvw0 = uvw_lambda(f, uvw)
    n, n_pad, theta_g, crop_lo = fov_pad_geometry(theta, lam, fov_pad)
    # target-FOV weighting histogram regardless of fov_pad
    wt = doweight(theta, lam, uvw0, jnp.ones_like(vis))
    uvw1, vis1 = mirror_uvw(uvw0, vis)
    guv = idg_grid_wproj((n_pad, n_pad), uvw1 / lam, uvw1[:, 2], wt * vis1,
                         theta=theta_g, subgrid=subgrid,
                         taper_beta=taper_beta)
    img = jnp.real(ifft_centered(make_grid_hermitian(guv)))
    img = _taper_correct(img, n, n_pad, crop_lo, subgrid, taper_beta)
    return img, jnp.max(img)


def idg_image(
    data: VisData,
    n: Optional[int] = None,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
    subgrid: int = 64,
    taper_beta: float = 12.0,
    fov_pad: Optional[float] = None,
    device_phases: bool = False,
):
    """Image-domain-gridding imaging of in-memory data (the array-level
    half of :func:`idg_gridding`).  Returns (image max, image)."""
    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam
    n = n if n is not None else data.vis.shape[0]
    args = (
        np.asarray(data.uvw[:n], prec.np_real),
        np.asarray(data.frequency, prec.np_real),
        np.asarray(data.vis[:n], prec.np_complex),
    )
    kw = dict(theta=theta, lam=lam, subgrid=subgrid, taper_beta=taper_beta,
              fov_pad=fov_pad)
    if device_phases:
        img, mx = _idg_staged(*args, timer=timer, **kw)
        return mx, img
    with timer.phase("h2d+compile+grid+fft"):
        img, mx = _idg_pipeline(*args, **kw)
        # blocking fetch inside the phase (async jit dispatch)
        img = np.asarray(img)
        mx = float(mx)
    return mx, img


def idg_gridding(
    datfile: str,
    n: Optional[int] = None,
    outfile: Optional[str] = None,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
    subgrid: int = 64,
    taper_beta: float = 12.0,
    fov_pad: Optional[float] = None,
    device_phases: bool = False,
):
    """Image-domain-gridding imaging run (PAPERS.md #1; ``ops/idg.py`` for
    the math and accuracy bounds).  Needs no w-kernel file: the screens
    the reference tabulates (``src/Gridding.hs:651-667``) are applied
    analytically in the image domain.  ``fov_pad`` < 1 buys a full-FOV
    accuracy guarantee by gridding a padded FOV and cropping
    (``ops.idg.idg_fov_pad_plan``).  Returns (image max, image)."""
    timer = timer or PhaseTimer()
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    mx, img = idg_image(data, n=n, config=config, timer=timer,
                        subgrid=subgrid, taper_beta=taper_beta,
                        fov_pad=fov_pad, device_phases=device_phases)
    _write_img(outfile, img, timer)
    return mx, img


@partial(complex_safe_jit, static_argnames=("theta", "lam", "chunk"))
def _predict_pipeline(wkerns, wbins, img, uvw, f, *, theta, lam, chunk):
    """Model image → uv-grid → per-visibility prediction (degridding)."""
    uvw0 = uvw_lambda(f, uvw)
    grid = fft_centered(img.astype(wkerns.dtype))
    wbin = find_closest(wbins, uvw0[:, 2])
    return degrid_wproj(wkerns, grid, uvw0 / lam, wbin, chunk=chunk)


@partial(complex_safe_jit,
         static_argnames=("theta", "lam", "subgrid", "taper_beta",
                          "fov_pad"))
def _idg_predict_pipeline(img, uvw, f, *, theta, lam, subgrid, taper_beta,
                          fov_pad=None):
    """Model image → IDG degridding (exact continuous-w prediction).

    ``fov_pad`` embeds the model in a padded FOV before the taper
    division (``fov_pad_start``), so predictions from edge sources carry
    the same bounded accuracy as the padded gridding direction
    (round-trip workflows never mix a padded forward with an
    edge-degraded reverse)."""
    uvw0 = uvw_lambda(f, uvw)
    n, n_grid, theta_g, crop_lo = fov_pad_geometry(theta, lam, fov_pad)
    grid = _model_grid(img, n, n_grid, crop_lo, subgrid, taper_beta)
    return idg_degrid_wproj(
        (n_grid, n_grid), uvw0 / lam, uvw0[:, 2], grid, theta=theta_g,
        subgrid=subgrid, taper_beta=taper_beta,
    )


@partial(complex_safe_jit,
         static_argnames=("theta", "lam", "subgrid", "taper_beta",
                          "max_runs", "fov_pad"))
def _aw_idg_predict_pipeline(screens, img, uvw, a1, a2, f, *, theta, lam,
                             subgrid, taper_beta, max_runs, fov_pad=None):
    """Model image → IDG-AW degridding: continuous-(u,v,w) prediction
    WITH direction-dependent antenna terms (the exact adjoint of the
    IDG-AW gridder).  Returns (vis, n_dropped).

    ``fov_pad`` as in :func:`_idg_predict_pipeline`; the caller must
    sample ``screens`` at the padded FOV's angular scale
    (``aw_screens_host(..., fov_scale=n_grid/n)``), mirroring the
    gridding direction."""
    uvw0 = uvw_lambda(f, uvw)
    n, n_grid, theta_g, crop_lo = fov_pad_geometry(theta, lam, fov_pad)
    grid = _model_grid(img, n, n_grid, crop_lo, subgrid, taper_beta)
    return idg_degrid_aw(
        (n_grid, n_grid), uvw0 / lam, a1, a2, uvw0[:, 2], grid, screens,
        theta=theta_g, subgrid=subgrid, taper_beta=taper_beta,
        max_runs=max_runs,
    )


def aw_predict_vis(
    data: VisData,
    akerns,
    img,
    n: Optional[int] = None,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
    subgrid: int = 64,
    taper_beta: float = 12.0,
    fov_pad: Optional[float] = None,
):
    """IDG-AW prediction from an in-memory model image (the array-level
    half of :func:`aw_predict`).  Drops are counted in
    ``timer.counters["idg_aw/dropped"]`` and reported on stderr.
    Returns the predicted visibilities."""
    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam
    n = n if n is not None else data.uvw.shape[0]
    uvw = np.asarray(data.uvw[:n], prec.np_real)
    f = np.asarray(data.frequency, prec.np_real)
    a1 = np.asarray(data.antenna1[:n], np.int32)
    a2 = np.asarray(data.antenna2[:n], np.int32)
    with timer.phase("h2d+compile+fft+degrid"):
        max_runs = idg_aw_max_runs(uvw, f, a1, a2, theta=theta, lam=lam,
                                   subgrid=subgrid, fov_pad=fov_pad,
                                   mirror=False)
        screens = _aw_screens(akerns, theta, lam, subgrid, fov_pad, prec)
        pred, nd = _aw_idg_predict_pipeline(
            screens, np.asarray(img, prec.np_real), uvw, a1, a2, f,
            theta=theta, lam=lam, subgrid=subgrid, taper_beta=taper_beta,
            max_runs=max_runs, fov_pad=fov_pad,
        )
        pred = np.asarray(pred)
        nd = int(nd)
    if nd > 0:
        print(f"warning: IDG-AW predict dropped {nd}/{n} visibilities "
              f"({100.0 * nd / max(n, 1):.2f}%) — data not track-ordered "
              "enough for pair-chunking (predictions are 0 there)",
              file=sys.stderr)
    timer.counters["idg_aw/dropped"] = float(nd)
    return pred


def aw_predict(
    afile: str,
    datfile: str,
    modelfile: str,
    n: Optional[int] = None,
    outfile: Optional[str] = None,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
    subgrid: int = 64,
    taper_beta: float = 12.0,
    fov_pad: Optional[float] = None,
):
    """Predict visibilities with direction-dependent antenna terms via
    IDG-AW degridding (cf. :func:`idg_predict`; screens from the akern
    bank at the dataset's closest time/frequency).  Chunking drops are
    surfaced like the gridding direction.  ``fov_pad`` embeds the model
    in a padded FOV (edge-accurate predictions; screens resampled at the
    padded scale).  Returns (pred, peak |vis|)."""
    timer = timer or PhaseTimer()
    theta, lam = config.grid.theta, config.grid.lam
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("ingest/akern"):
        akerns = get_akernels(afile, theta, float(data.time[0]),
                              data.frequency)
    img = _read_model(modelfile, theta, lam, timer)
    pred = aw_predict_vis(data, akerns, img, n=n, config=config, timer=timer,
                          subgrid=subgrid, taper_beta=taper_beta,
                          fov_pad=fov_pad)
    peak = float(np.abs(pred).max()) if pred.size else 0.0
    _write_model_vis(outfile, pred, timer)
    return pred, peak


def idg_predict_vis(
    data: VisData,
    img,
    n: Optional[int] = None,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
    subgrid: int = 32,
    taper_beta: float = 12.0,
    fov_pad: Optional[float] = None,
):
    """IDG prediction from an in-memory model image (the array-level
    half of :func:`idg_predict`).  Returns the predicted visibilities."""
    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam
    n = n if n is not None else data.uvw.shape[0]
    with timer.phase("h2d+compile+fft+degrid"):
        pred = _idg_predict_pipeline(
            np.asarray(img, prec.np_real),
            np.asarray(data.uvw[:n], prec.np_real),
            np.asarray(data.frequency, prec.np_real),
            theta=theta, lam=lam, subgrid=subgrid, taper_beta=taper_beta,
            fov_pad=fov_pad,
        )
        return np.asarray(pred)


def idg_predict(
    datfile: str,
    modelfile: str,
    n: Optional[int] = None,
    outfile: Optional[str] = None,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
    subgrid: int = 32,
    taper_beta: float = 12.0,
    fov_pad: Optional[float] = None,
):
    """Predict visibilities via IDG degridding — exact continuous
    (u, v, w) evaluation, no kernel bank needed (cf. :func:`w_predict`).
    ``fov_pad`` embeds the model in a padded FOV for edge-accurate
    predictions.  Returns (predicted ndarray, peak |vis|)."""
    timer = timer or PhaseTimer()
    theta, lam = config.grid.theta, config.grid.lam
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    img = _read_model(modelfile, theta, lam, timer)
    pred = idg_predict_vis(data, img, n=n, config=config, timer=timer,
                           subgrid=subgrid, taper_beta=taper_beta,
                           fov_pad=fov_pad)
    peak = float(np.abs(pred).max()) if pred.size else 0.0
    _write_model_vis(outfile, pred, timer)
    return pred, peak


def w_predict_vis(
    data: VisData,
    wkerns,
    wbins,
    img,
    n: Optional[int] = None,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
):
    """w-projection prediction from an in-memory model image (the
    array-level half of :func:`w_predict`).  Returns the predicted
    visibilities."""
    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam
    n = n if n is not None else data.uvw.shape[0]
    with timer.phase("h2d+compile+fft+degrid"):
        pred = _predict_pipeline(
            np.asarray(wkerns, prec.np_complex),
            np.asarray(wbins, prec.np_real),
            np.asarray(img, prec.np_real),
            np.asarray(data.uvw[:n], prec.np_real),
            np.asarray(data.frequency, prec.np_real),
            theta=theta,
            lam=lam,
            chunk=min(8192, max(256, n)),
        )
        return np.asarray(pred)


def w_predict(
    wfile: str,
    datfile: str,
    modelfile: str,
    n: Optional[int] = None,
    outfile: Optional[str] = None,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
):
    """Predict visibilities from a model image at the dataset's uvw samples.

    The degridding (grid→vis) direction — the exact adjoint of the
    w-projection gridder.  Absent from the reference (SURVEY §7.4) but
    required for model subtraction / self-calibration loops.  Reads the
    model from ``modelfile``'s ``/img``, writes predictions to
    ``outfile``'s ``/vis/model`` (complex, same order as ``/vis/uvw``).

    Returns (predicted ndarray, peak |vis|).
    """
    timer = timer or PhaseTimer()
    theta, lam = config.grid.theta, config.grid.lam
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("ingest/wkern"):
        wkerns, wbins = get_wkernels(wfile, theta)
    img = _read_model(modelfile, theta, lam, timer)
    pred = w_predict_vis(data, wkerns, wbins, img, n=n, config=config,
                         timer=timer)
    _write_model_vis(outfile, pred, timer, phase="write/model-vis")
    return pred, float(np.abs(pred).max())


@partial(complex_safe_jit, static_argnames=("theta", "lam", "chunk"))
def _wgrid_slab(bank_conj, wbins, uvw_l, wt, vis, grid, *, theta, lam, chunk):
    """Grid one visibility slab into the running uv-grid (resumable)."""
    uvw1, vis1 = mirror_uvw(uvw_l, vis)
    wbin = find_closest(wbins, uvw1[:, 2])
    return convgrid_wproj(bank_conj, grid, uvw1 / lam, wbin,
                          wt.astype(vis.dtype) * vis1, chunk=chunk)


@partial(complex_safe_jit, static_argnames=())
def _wfinish(grid):
    img = jnp.real(ifft_centered(make_grid_hermitian(grid)))
    return img, jnp.max(img)


def w_gridding_checkpointed(
    wfile: str,
    datfile: str,
    checkpoint: str,
    n: Optional[int] = None,
    outfile: Optional[str] = None,
    slab: int = 1 << 20,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
    _max_slabs: Optional[int] = None,
):
    """Resumable w-projection imaging: slab-granular checkpoint/resume.

    After each ``slab`` visibilities the partial uv-grid is written
    atomically to ``checkpoint``; an interrupted run picks up from the
    last completed slab (the reference has no persistence at all —
    SURVEY §5).  ``_max_slabs`` is a test hook that stops early, simulating
    an interruption.  Returns (image max, image) or (None, None) if
    stopped early.
    """
    from ..utils import checkpoint as ckpt

    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam
    n_grid = int(round(theta * lam))

    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("ingest/wkern"):
        wkerns, wbins = get_wkernels(wfile, theta)
    n = n if n is not None else data.vis.shape[0]
    bank_conj = np.conj(np.asarray(wkerns, prec.np_complex))
    wbins = np.asarray(wbins, prec.np_real)

    # global uniform weighting over the full run (slab-independent)
    uvw_l = np.asarray(
        uvw_lambda(jnp.asarray(data.frequency, prec.np_real),
                   jnp.asarray(data.uvw[:n], prec.np_real))
    )
    wt = np.asarray(
        doweight(theta, lam, jnp.asarray(uvw_l),
                 jnp.ones(n, prec.np_real))
    ).real.astype(prec.np_real)

    # run-defining config: resuming under a different bank/precision/θλ
    # must reject the checkpoint, not mix numerics
    fpr = ckpt.fingerprint(theta, lam, wkerns.shape, str(prec.np_real), "wproj")
    state = ckpt.load(checkpoint, n_grid, n, fpr=fpr)
    if state is not None:
        g_re, g_im, start = state
        g_re = g_re.astype(prec.np_real)
        g_im = g_im.astype(prec.np_real)
    else:
        g_re = np.zeros((n_grid, n_grid), prec.np_real)
        g_im = np.zeros((n_grid, n_grid), prec.np_real)
        start = 0

    slabs_done = 0
    s0 = start
    while s0 < n:
        take = min(slab, n - s0)
        # fixed slab shape (zero-weight padding) → one compiled program
        uvw_s = np.zeros((slab, 3), prec.np_real)
        wt_s = np.zeros((slab,), prec.np_real)
        vis_s = np.zeros((slab,), prec.np_complex)
        uvw_s[:take] = uvw_l[s0:s0 + take]
        wt_s[:take] = wt[s0:s0 + take]
        vis_s[:take] = np.asarray(data.vis[s0:s0 + take], prec.np_complex)
        with timer.phase("grid/slab"):
            g = _wgrid_slab(
                bank_conj, wbins, uvw_s, wt_s, vis_s,
                (g_re + 1j * g_im).astype(prec.np_complex),
                theta=theta, lam=lam, chunk=min(8192, slab),
            )
            g_re = np.real(np.asarray(g)).astype(prec.np_real)
            g_im = np.imag(np.asarray(g)).astype(prec.np_real)
        s0 += take
        with timer.phase("checkpoint/write"):
            ckpt.save(checkpoint, g_re, g_im, s0, n, fpr=fpr)
        slabs_done += 1
        if _max_slabs is not None and slabs_done >= _max_slabs and s0 < n:
            return None, None

    with timer.phase("finish/fft"):
        img, mx = _wfinish((g_re + 1j * g_im).astype(prec.np_complex))
        img = np.asarray(img)
        mx = float(mx)
    if outfile is not None:
        with timer.phase("write/img"):
            h5.create_file(outfile)
            h5.write_dataset(outfile, schema.IMG_DATASET,
                             img.astype(np.float64))
    ckpt.remove(checkpoint)
    return mx, img


def vis_record_geometry(datfile: str):
    """(records_total, records_per_row, nch) of the /vis/vis block.

    A RECORD is one (time, baseline) row — the unit ``/vis/uvw`` etc. are
    indexed by.  Multi-channel files carry nch values per record in the
    trailing vis axis (``io/schema.py``); the single-channel streaming
    paths consume channel 0 only (the reference semantics,
    ``ImageDataset.hs:99-106``), so record counts must NOT include the
    channel axis.  Channel detection mirrors :func:`load_vis_data`:
    trailing axis == len(/vis/frequency) > 1."""
    vshape = h5.dataset_shape(datfile, schema.VIS_VIS)
    f = np.asarray(h5.read_dataset(datfile, schema.VIS_FREQUENCY)).ravel()
    nch = f.shape[0]
    if not (nch > 1 and len(vshape) >= 1 and vshape[-1] == nch):
        nch = 1
    total = int(np.prod(vshape)) // nch
    per_row = (int(np.prod(vshape[1:])) // nch) if len(vshape) > 1 else 1
    return total, max(per_row, 1), nch


def _flat_vis_reader(datfile: str, per_row: int, nch: int = 1):
    """Reader for flat RECORD-order slices of the rank-3 /vis/vis block
    (channel 0 of multi-channel files)."""

    def read(start: int, count: int) -> np.ndarray:
        t0 = start // per_row
        t1 = (start + count - 1) // per_row + 1
        block = h5.read_dataset_slice(
            datfile, schema.VIS_VIS, t0, t1 - t0
        ).reshape(-1, nch)[:, 0]
        off = start - t0 * per_row
        return block[off:off + count]

    return read


def w_gridding_out_of_core(
    wfile: str,
    datfile: str,
    checkpoint: str,
    n: Optional[int] = None,
    outfile: Optional[str] = None,
    slab: int = 1 << 20,
    config: ImagingConfig = ImagingConfig(),
    timer: Optional[PhaseTimer] = None,
):
    """Streaming w-projection imaging for datasets larger than memory.

    Two streaming passes over the visibility file with a background
    prefetch thread (``io.stream.SlabPrefetcher``) so HDF5 reads overlap
    device compute — the reference loads whole datasets up front
    (``ImageDataset.hs:36-41``); SURVEY §7 hard part (e).  Pass 1
    accumulates the uniform-weighting cell histogram; pass 2 grids
    weighted slabs, checkpointing after each (same checkpoint format and
    resume semantics as :func:`w_gridding_checkpointed`).
    """
    from ..io.stream import SlabPrefetcher
    from ..utils import checkpoint as ckpt
    from ..utils.oracle import frac_coord as frac_coord_np

    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam
    n_grid = int(round(theta * lam))

    _require_file(datfile)
    n_total, per_row, nch = vis_record_geometry(datfile)
    n = min(n, n_total) if n is not None else n_total
    freq = float(
        np.asarray(h5.read_dataset(datfile, schema.VIS_FREQUENCY)).ravel()[0]
    )
    with timer.phase("ingest/wkern"):
        wkerns, wbins = get_wkernels(wfile, theta)
    bank_conj = np.conj(np.asarray(wkerns, prec.np_complex))
    wbins = np.asarray(wbins, prec.np_real)

    scale = freq / 299792458.0
    uvw_reader = lambda s0, c: h5.read_dataset_slice(
        datfile, schema.VIS_UVW, s0, c
    )

    # pass 1: uniform-weighting occupancy histogram (streaming, host).
    # OOB semantics match the jnp path: scatter drops, gather clamps.
    with timer.phase("weight/histogram"):
        counts = np.zeros(n_grid * n_grid, np.int64)
        for s0, sl in SlabPrefetcher({"uvw": uvw_reader}, n, slab):
            uvw_l = sl["uvw"] * scale
            x, _ = frac_coord_np(n_grid, 1, uvw_l[:, 0] / lam)
            y, _ = frac_coord_np(n_grid, 1, uvw_l[:, 1] / lam)
            flat = y * n_grid + x
            inb = (flat >= 0) & (flat < n_grid * n_grid)
            np.add.at(counts, flat[inb], 1)
        counts[counts == 0] = 1

    fpr = ckpt.fingerprint(theta, lam, wkerns.shape, str(prec.np_real), "wproj-ooc")
    state = ckpt.load(checkpoint, n_grid, n, fpr=fpr)
    if state is not None:
        g_re, g_im, start = state
        g_re = g_re.astype(prec.np_real)
        g_im = g_im.astype(prec.np_real)
    else:
        g_re = np.zeros((n_grid, n_grid), prec.np_real)
        g_im = np.zeros((n_grid, n_grid), prec.np_real)
        start = 0

    # pass 2: stream + grid (prefetch overlaps device compute)
    readers = {"uvw": uvw_reader,
               "vis": _flat_vis_reader(datfile, per_row, nch)}
    for s0, sl in SlabPrefetcher(readers, n, slab, start=start):
        take = sl["uvw"].shape[0]
        uvw_l = (sl["uvw"] * scale).astype(prec.np_real)
        x, _ = frac_coord_np(n_grid, 1, uvw_l[:, 0] / lam)
        y, _ = frac_coord_np(n_grid, 1, uvw_l[:, 1] / lam)
        flat = np.clip(y * n_grid + x, 0, n_grid * n_grid - 1)
        wt = (1.0 / counts[flat]).astype(prec.np_real)

        uvw_s = np.zeros((slab, 3), prec.np_real)
        wt_s = np.zeros((slab,), prec.np_real)
        vis_s = np.zeros((slab,), prec.np_complex)
        uvw_s[:take] = uvw_l
        wt_s[:take] = wt
        vis_s[:take] = sl["vis"].astype(prec.np_complex)
        with timer.phase("grid/slab"):
            g = _wgrid_slab(
                bank_conj, wbins, uvw_s, wt_s, vis_s,
                (g_re + 1j * g_im).astype(prec.np_complex),
                theta=theta, lam=lam, chunk=min(8192, slab),
            )
            g_re = np.real(np.asarray(g)).astype(prec.np_real)
            g_im = np.imag(np.asarray(g)).astype(prec.np_real)
        with timer.phase("checkpoint/write"):
            ckpt.save(checkpoint, g_re, g_im, s0 + take, n, fpr=fpr)

    with timer.phase("finish/fft"):
        img, mx = _wfinish((g_re + 1j * g_im).astype(prec.np_complex))
        img = np.asarray(img)
        mx = float(mx)
    if outfile is not None:
        with timer.phase("write/img"):
            h5.create_file(outfile)
            h5.write_dataset(outfile, schema.IMG_DATASET,
                             img.astype(np.float64))
    ckpt.remove(checkpoint)
    return mx, img
