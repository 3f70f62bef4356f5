"""Sharded imaging: visibility-parallel gridding with partial-grid psum.

Multi-device replacement for the reference's (nonexistent) scale-out story
(SURVEY §2 parallelism inventory; §5 "Distributed communication backend"):

* visibilities (uvw, vis, per-vis kernel indices) are sharded over the
  ``vis`` mesh axis — each chip grids its shard into a **private partial
  uv-grid** (collision-freedom across chips by construction);
* one ``jax.lax.psum`` over the device interconnect merges the partial
  grids;
* hermitian completion + inverse FFT then run on the (now replicated) grid.

Entry points:
  ``sharded_wproj_grid``  — the sharded hot kernel only (grid out)
  ``sharded_wproj_image`` — grid + hermitian + ifft (dirty image out)
  ``sharded_wproj_step``  — full preprocessing + imaging step, jitted under
                            ``shard_map`` (what ``dryrun_multichip`` runs)

Multi-host: the same program runs under ``jax.distributed.initialize`` with
a global mesh — psum over a 2-D ("host", "vis") mesh is hierarchical on the
wire (within a host, then across hosts) without code changes; see
``parallel/distributed.py``.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import (
    convgrid_wproj,
    doweight,
    find_closest,
    ifft_centered,
    make_grid_hermitian,
    mirror_uvw,
    uvw_lambda,
)
from .mesh import VIS_AXIS


def _varying_zeros(shape, dtype):
    """Per-shard zero accumulator, typed as device-varying.

    Under shard_map's varying-manual-axes typing a plain ``jnp.zeros`` is
    replicated, which conflicts with the per-device scatter carry inside
    ``lax.scan``; ``pcast(to='varying')`` gives each device its own private
    accumulator (the whole point of the partial-grid design).
    """
    z = jnp.zeros(shape, dtype)
    return jax.lax.pcast(z, (VIS_AXIS,), to="varying")


def sharded_wproj_grid(mesh: Mesh, bank_conj, p, wbin, vis, n_grid: int,
                       chunk: int = 8192):
    """Grid sharded visibilities; returns the merged [n, n] uv-grid.

    Args are global arrays; ``p``/``wbin``/``vis`` lead with the sharded
    visibility axis (length divisible by mesh size).
    """

    def local(bank_conj, p, wbin, vis):
        guv = _varying_zeros((n_grid, n_grid), vis.dtype)
        part = convgrid_wproj(bank_conj, guv, p, wbin, vis,
                              chunk=chunk)
        return jax.lax.psum(part, VIS_AXIS)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(VIS_AXIS), P(VIS_AXIS), P(VIS_AXIS)),
        out_specs=P(),
    )
    return fn(bank_conj, p, wbin, vis)


def sharded_wproj_image(mesh: Mesh, bank_conj, wbin_centers, uvw_l, vis,
                        theta: float, lam: int, chunk: int = 8192):
    """Sharded w-projection dirty image from λ-scaled uvw.

    Pre-gridding per-vis work (weighting, mirroring, bin search) happens
    inside the shard — fully local, no communication until the single psum.
    """
    n_grid = int(round(theta * lam))

    def local(bank_conj, centers, uvw_l, vis):
        wt = doweight(theta, lam, uvw_l, jnp.ones_like(vis))
        uvw1, vis1 = mirror_uvw(uvw_l, vis)
        wbin = find_closest(centers, uvw1[:, 2])
        guv = _varying_zeros((n_grid, n_grid), vis.dtype)
        part = convgrid_wproj(bank_conj, guv, uvw1 / lam, wbin,
                              wt * vis1, chunk=chunk)
        full = jax.lax.psum(part, VIS_AXIS)
        img = jnp.real(ifft_centered(make_grid_hermitian(full)))
        return img

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(VIS_AXIS), P(VIS_AXIS)),
        out_specs=P(),
    )
    return fn(bank_conj, wbin_centers, uvw_l, vis)


def make_sharded_wproj_step(mesh: Mesh, theta: float, lam: int,
                            chunk: int = 1024):
    """Jitted full sharded step: (bank, centers, uvw_m, freq, vis) → image.

    NOTE on ``doweight``: per-shard weighting normalizes by the *local* cell
    occupancy.  For exact parity with single-device weighting the counts
    must be globally reduced; this variant does that with a psum over the
    occupancy histogram.
    """
    n_grid = int(round(theta * lam))

    def local(bank_conj, centers, uvw, freq, vis):
        uvw_l = uvw_lambda(freq, uvw)
        # global uniform weighting: psum the cell-occupancy histogram
        from ..ops.coords import frac_coords

        p = uvw_l / lam
        x, _, y, _ = frac_coords((n_grid, n_grid), 1, p)
        flat = (y * n_grid + x).ravel()
        counts = _varying_zeros((n_grid * n_grid,), uvw.dtype).at[flat].add(1.0)
        counts = jax.lax.psum(counts, VIS_AXIS)
        wt = (1.0 / counts[flat]).astype(vis.dtype)

        uvw1, vis1 = mirror_uvw(uvw_l, vis)
        wbin = find_closest(centers, uvw1[:, 2])
        guv = _varying_zeros((n_grid, n_grid), vis.dtype)
        part = convgrid_wproj(bank_conj, guv, uvw1 / lam,
                              wbin, wt * vis1, chunk=chunk)
        full = jax.lax.psum(part, VIS_AXIS)
        return jnp.real(ifft_centered(make_grid_hermitian(full)))

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(VIS_AXIS), P(), P(VIS_AXIS)),
        out_specs=P(),
    )
    return jax.jit(fn)


def make_sharded_wproj_step_gridfft(mesh: Mesh, theta: float, lam: int,
                                    chunk: int = 1024):
    """Sharded step whose FFT is ALSO distributed (grid-parallel finish).

    Same numerical step as :func:`make_sharded_wproj_step` (global
    psum'd uniform weighting included) but the FFT is distributed:
    vis-sharded gridding → psum (grid replicated) → local hermitian →
    each device keeps its row block → pencil-decomposition centered
    inverse FFT (one all_to_all each way, riding ICI) → row-sharded dirty
    image.  This is the scale-out path for grids that outgrow a single
    chip's FFT (SURVEY §5: n = θ·λ).

    Requires n_grid divisible by mesh_size² (all_to_all re-split).
    """
    from .fft import fft2_centered_sharded

    n_grid = int(round(theta * lam))
    n_dev = mesh.devices.size
    if n_grid % (n_dev * n_dev) != 0:
        raise ValueError(
            f"grid {n_grid} not divisible by mesh_size² = {n_dev**2}"
        )
    hl = n_grid // n_dev

    def local(bank_conj, centers, uvw, freq, vis):
        uvw_l = uvw_lambda(freq, uvw)
        # global uniform weighting (same psum'd histogram as
        # make_sharded_wproj_step — the two steps must agree numerically)
        from ..ops.coords import frac_coords

        p = uvw_l / lam
        x, _, y, _ = frac_coords((n_grid, n_grid), 1, p)
        flat = (y * n_grid + x).ravel()
        counts = _varying_zeros((n_grid * n_grid,), uvw.dtype).at[flat].add(1.0)
        counts = jax.lax.psum(counts, VIS_AXIS)
        wt = (1.0 / counts[flat]).astype(vis.dtype)

        uvw1, vis1 = mirror_uvw(uvw_l, vis)
        wbin = find_closest(centers, uvw1[:, 2])
        guv = _varying_zeros((n_grid, n_grid), vis.dtype)
        part = convgrid_wproj(bank_conj, guv, uvw1 / lam,
                              wbin, wt * vis1, chunk=chunk)
        full = jax.lax.psum(part, VIS_AXIS)
        herm = make_grid_hermitian(full)
        row0 = jax.lax.axis_index(VIS_AXIS).astype(jnp.int32) * hl
        block = jax.lax.dynamic_slice(herm, (row0, jnp.int32(0)), (hl, n_grid))
        return jnp.real(
            fft2_centered_sharded(block, VIS_AXIS, inverse=True)
        )

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(VIS_AXIS), P(), P(VIS_AXIS)),
        out_specs=P(VIS_AXIS),   # dirty image stays row-sharded
    )
    return jax.jit(fn)


def make_sharded_idg_step(mesh: Mesh, theta: float, lam: int,
                          subgrid: int = 32, taper_beta: float = 12.0):
    """Jitted sharded image-domain-gridding step:
    (uvw_m, freq, vis) → taper-corrected dirty image.

    The IDG mode scaled out exactly like the bank path: each chip bins and
    grids its visibility shard (subgrid matmuls are shard-local), one psum
    merges the partial uv-grids, hermitian + iFFT + taper correction run
    replicated.  No kernel bank to replicate at all — the screens are
    analytic (``ops/idg.py``).
    """
    from ..ops.idg import idg_grid_wproj
    from ..ops.idg import kaiser_taper, taper_fine

    n_grid = int(round(theta * lam))

    def local(uvw, freq, vis):
        uvw_l = uvw_lambda(freq, uvw)
        from ..ops.coords import frac_coords

        p = uvw_l / lam
        x, _, y, _ = frac_coords((n_grid, n_grid), 1, p)
        flat = (y * n_grid + x).ravel()
        counts = _varying_zeros((n_grid * n_grid,), uvw.dtype).at[flat].add(1.0)
        counts = jax.lax.psum(counts, VIS_AXIS)
        wt = (1.0 / counts[flat]).astype(vis.dtype)

        uvw1, vis1 = mirror_uvw(uvw_l, vis)
        part = idg_grid_wproj(
            (n_grid, n_grid), uvw1 / lam, uvw1[:, 2], wt * vis1,
            theta=theta, subgrid=subgrid, taper_beta=taper_beta,
        )
        full = jax.lax.psum(part, VIS_AXIS)
        img = jnp.real(ifft_centered(make_grid_hermitian(full)))
        tf = taper_fine(n_grid, subgrid,
                        kaiser_taper(subgrid, taper_beta)).astype(img.dtype)
        return img / (tf[:, None] * tf[None, :])

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(VIS_AXIS), P(), P(VIS_AXIS)),
        out_specs=P(),
    )
    return jax.jit(fn)


def make_sharded_predict_step(mesh: Mesh, theta: float, lam: int,
                              chunk: int = 1024):
    """Jitted sharded predict: (bank, centers, image, uvw, freq) → vis.

    The adjoint direction scaled out: the model image is replicated, each
    chip degrids its visibility shard — embarrassingly parallel, zero
    collectives.  Output visibilities stay sharded like the inputs.
    """
    from ..ops.gridding import degrid_wproj
    from ..ops import fft_centered

    n_grid = int(round(theta * lam))

    def local(bank, centers, img, uvw, freq):
        uvw_l = uvw_lambda(freq, uvw)
        grid = fft_centered(img.astype(bank.dtype))
        wbin = find_closest(centers, uvw_l[:, 2])
        return degrid_wproj(bank, grid, uvw_l / lam, wbin, chunk=chunk)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(VIS_AXIS), P()),
        out_specs=P(VIS_AXIS),
    )
    return jax.jit(fn)


def _hermitian_rows_sharded(block, n_grid: int, axis=VIS_AXIS):
    """Distributed hermitian completion of a row-sharded even-size grid.

    Reproduces ``ops.hermitian.make_grid_hermitian`` exactly without ever
    materializing the full grid: the mirror's rows come from the opposite
    device (one ppermute of the row-reversed block + one ppermute of a
    single boundary row), the column mirror/zeroing is local.
    """
    P_ = jax.lax.axis_size(axis)
    d = jax.lax.axis_index(axis)
    h = block.shape[0]

    # rows n−y for y in my range live (reversed) on device P−1−d …
    flipped = jnp.flip(block, axis=0)
    recv = jax.lax.ppermute(
        flipped, axis, perm=[(s, P_ - 1 - s) for s in range(P_)]
    )
    # … except row n−d·h, which is the FIRST row of device (P−d) mod P
    first = block[:1]
    extra = jax.lax.ppermute(
        first, axis, perm=[(s, (P_ - s) % P_) for s in range(P_)]
    )
    mrows = jnp.concatenate([extra, recv[: h - 1]], axis=0)
    # global row 0 of the mirror is zeroed (even-grid reference semantics)
    mrows = jnp.where(d == 0,
                      mrows.at[0].set(0),
                      mrows)
    # column mirror x ← (n−x) mod n, col 0 zeroed — purely local
    mirr = jnp.roll(jnp.flip(mrows, axis=1), 1, axis=1)
    mirr = mirr.at[:, 0].set(0)
    return block + jnp.conj(mirr)


def make_sharded_wproj_step_gridscatter(mesh: Mesh, theta: float, lam: int,
                                        chunk: int = 1024):
    """Fully grid-distributed sharded step: the uv-grid NEVER materializes
    on one device.

    Identical numerics to :func:`make_sharded_wproj_step` but: partial
    grids merge with ``psum_scatter`` (reduce_scatter — half the wire
    traffic of psum, each chip keeps only its row block), hermitian
    completion runs distributed (two ppermutes), and the centered inverse
    FFT is the pencil-decomposition transform.  Memory and communication
    per chip scale as n²/P — this is the large-grid path (SURVEY §5c).

    Requires n_grid divisible by mesh_size².
    """
    from .fft import fft2_centered_sharded

    n_grid = int(round(theta * lam))
    n_dev = mesh.devices.size
    if n_grid % (n_dev * n_dev) != 0:
        raise ValueError(
            f"grid {n_grid} not divisible by mesh_size² = {n_dev**2}"
        )

    def local(bank_conj, centers, uvw, freq, vis):
        uvw_l = uvw_lambda(freq, uvw)
        from ..ops.coords import frac_coords

        p = uvw_l / lam
        x, _, y, _ = frac_coords((n_grid, n_grid), 1, p)
        flat = (y * n_grid + x).ravel()
        counts = _varying_zeros((n_grid * n_grid,), uvw.dtype).at[flat].add(1.0)
        counts = jax.lax.psum(counts, VIS_AXIS)
        wt = (1.0 / counts[flat]).astype(vis.dtype)

        uvw1, vis1 = mirror_uvw(uvw_l, vis)
        wbin = find_closest(centers, uvw1[:, 2])
        guv = _varying_zeros((n_grid, n_grid), vis.dtype)
        part = convgrid_wproj(bank_conj, guv, uvw1 / lam,
                              wbin, wt * vis1, chunk=chunk)
        block = jax.lax.psum_scatter(part, VIS_AXIS, scatter_dimension=0,
                                     tiled=True)
        herm = _hermitian_rows_sharded(block, n_grid)
        return jnp.real(fft2_centered_sharded(herm, VIS_AXIS, inverse=True))

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(VIS_AXIS), P(), P(VIS_AXIS)),
        out_specs=P(VIS_AXIS),
    )
    return jax.jit(fn)


def make_sharded_spectral_idg_step(mesh: Mesh, theta: float, lam: int,
                                   g: int, subgrid: int = 64,
                                   taper_beta: float = 12.0):
    """Jitted sharded multi-channel IDG group step:
    (uvw_m, mask, f_ref, ratios, vis_re_mc, vis_im_mc) →
    taper-corrected dirty-image cube [g, n, n].

    The spectral driver's group pipeline (``models/spectral.py``,
    ``_idg_multi_pipeline`` semantics) scaled out vis-parallel: records
    shard over the ``vis`` axis, each chip grids its shard per channel
    (channel c's coordinates are the reference channel's dilated by
    ``ratios[c]`` — the same elementwise geometry update as the local
    driver), and one psum per channel merges the partial grids.
    Hermitian completion + per-channel iFFT + taper correction run
    replicated (the cube is the deliverable on every host).

    Group-shared uniform weighting matches the local driver exactly:
    ONE sample-density histogram at the group's reference channel,
    globally psum'd.  ``mask`` (1.0 real record, 0.0 padding) makes
    shard-padding to a mesh multiple exact: padded records neither
    count in the histogram nor carry weight.
    """
    from ..ops.idg import idg_grid_wproj
    from ..ops.idg import kaiser_taper, taper_fine

    n_grid = int(round(theta * lam))

    def local(uvw, mask, f_ref, ratios, vis_re_mc, vis_im_mc):
        vis_mc = jax.lax.complex(vis_re_mc, vis_im_mc)
        uvw0 = uvw_lambda(f_ref, uvw)
        # group-shared uniform weights: psum'd masked histogram at the
        # reference channel (≡ ops.doweight = 1/cell-count for real
        # records; padded records get weight 0)
        from ..ops.coords import frac_coords

        p = uvw0 / lam
        x, _, y, _ = frac_coords((n_grid, n_grid), 1, p)
        flat = (y * n_grid + x).ravel()
        counts = _varying_zeros((n_grid * n_grid,),
                                uvw.dtype).at[flat].add(mask)
        counts = jax.lax.psum(counts, VIS_AXIS)
        wt = (mask / jnp.maximum(counts[flat], 1.0)).astype(vis_mc.dtype)

        uvw1, _ = mirror_uvw(uvw0, vis_mc[0])
        neg = uvw0[:, 1] < 0
        vis1 = jnp.where(neg[None, :], jnp.conj(vis_mc), vis_mc) \
            * wt[None, :]

        def body(_, rv):
            r, vc = rv
            part = idg_grid_wproj(
                (n_grid, n_grid), uvw1 * r / lam, uvw1[:, 2] * r, vc,
                theta=theta, subgrid=subgrid, taper_beta=taper_beta,
            )
            return 0, jax.lax.psum(part, VIS_AXIS)

        _, grids = jax.lax.scan(
            body, 0, (ratios.astype(uvw.dtype), vis1))
        img = jnp.real(ifft_centered(make_grid_hermitian(grids)))
        tf = taper_fine(n_grid, subgrid,
                        kaiser_taper(subgrid, taper_beta)).astype(img.dtype)
        return img / (tf[None, :, None] * tf[None, None, :])

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(VIS_AXIS), P(VIS_AXIS), P(), P(),
                  P(None, VIS_AXIS), P(None, VIS_AXIS)),
        out_specs=P(),
    )
    return jax.jit(fn)


def make_sharded_idg_aw_step(mesh: Mesh, theta: float, lam: int,
                             subgrid: int = 64, taper_beta: float = 12.0,
                             max_runs: int = 4096):
    """Jitted sharded IDG-AW step: (uvw_m, freq, vis, a1, a2, screens) →
    (taper-corrected dirty image, total dropped count).

    IDG-AW shards like the other vis-parallel steps: each chip chunks and
    grids its own record shard (subgrid origins are a pure function of
    the uv TILE — device-independent, so splitting a pair's run across
    shards changes only summation order, not the operator), one psum
    merges the partial grids, and the drop counts psum to a global
    honesty figure.  Screens are replicated (nant·S² ≪ grid).
    """
    from ..ops.idg_aw import idg_grid_aw
    from ..ops.idg import kaiser_taper, taper_fine

    n_grid = int(round(theta * lam))

    def local(uvw, freq, vis, a1, a2, screens):
        uvw_l = uvw_lambda(freq, uvw)
        from ..ops.coords import frac_coords

        p = uvw_l / lam
        x, _, y, _ = frac_coords((n_grid, n_grid), 1, p)
        flat = (y * n_grid + x).ravel()
        counts = _varying_zeros((n_grid * n_grid,), uvw.dtype).at[flat].add(1.0)
        counts = jax.lax.psum(counts, VIS_AXIS)
        wt = (1.0 / counts[flat]).astype(vis.dtype)

        uvw1, vis1 = mirror_uvw(uvw_l, vis)
        part, nd = idg_grid_aw(
            (n_grid, n_grid), uvw1 / lam, a1, a2, uvw1[:, 2], wt * vis1,
            screens, theta=theta, subgrid=subgrid, taper_beta=taper_beta,
            max_runs=max_runs,
        )
        full = jax.lax.psum(part, VIS_AXIS)
        nd = jax.lax.psum(nd, VIS_AXIS)
        img = jnp.real(ifft_centered(make_grid_hermitian(full)))
        tf = taper_fine(n_grid, subgrid,
                        kaiser_taper(subgrid, taper_beta)).astype(img.dtype)
        return img / (tf[:, None] * tf[None, :]), nd

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(VIS_AXIS), P(), P(VIS_AXIS), P(VIS_AXIS), P(VIS_AXIS),
                  P()),
        out_specs=(P(), P()),
    )
    return jax.jit(fn)


def sharded_image(mesh: Mesh, mode: str, uvw, vis, freq, *, theta: float,
                  lam: int, precision, subgrid: int = 64, wkerns=None,
                  wbins=None):
    """The ``--distributed`` imaging step: ``mode`` "w" (bank
    w-projection, needs ``wkerns``/``wbins``) or "idg" on visibility-
    sharded global ``uvw`` [n, 3] (metres) and ``vis`` [n], one
    psum-merged step over ``mesh``.  Returns the replicated [N, N] dirty
    image."""
    import numpy as np

    f = jnp.asarray(freq, precision.np_real)
    if mode == "w":
        step = _cached_step(make_sharded_wproj_step, mesh, theta, lam)
        bank_conj = np.conj(np.asarray(wkerns, precision.np_complex))
        return step(jax.device_put(bank_conj),
                    jax.device_put(np.asarray(wbins, precision.np_real)),
                    uvw, f, vis)
    if mode == "idg":
        step = _cached_step(make_sharded_idg_step, mesh, theta, lam,
                            subgrid=subgrid)
        return step(uvw, f, vis)
    raise ValueError(f"no sharded step for mode {mode!r} (w, idg)")


@lru_cache(maxsize=16)
def _cached_step(factory, mesh, theta, lam, **kw):
    """One jitted step per (factory, mesh, geometry): repeated calls reuse
    its compiled program."""
    return factory(mesh, theta, lam, **kw)
