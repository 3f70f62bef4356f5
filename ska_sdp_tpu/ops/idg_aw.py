"""Image-domain AW-projection gridding (IDG-AW): A-screens on subgrids.

The original selling point of IDG (van der Tol et al. 2018 — method only;
the realization here is this repo's own): direction-dependent
antenna terms are applied as IMAGE-domain multiplications on per-chunk
subgrids instead of per-visibility uv convolutions.  Where the reference
convolves ``conj(A1 ⊛ A2 ⊛ W)`` per visibility inside a sequential device
loop (``/root/reference/src/Gridding.hs:318-396,452-478``), IDG-AW:

1. groups visibilities into CHUNKS that share one antenna pair — the
   natural layout of interferometer data (baseline-major, time/channel
   within; one stable sort per dataset),
2. accumulates each chunk onto a small subgrid image via the same
   rank-1-phase batched matmuls as plain IDG (``ops/idg.py``),
3. multiplies the chunk's subgrid image ONCE by
   ``conj(A1(l,m)) · conj(A2(l,m))`` — the per-pair A-screen — plus the
   Kaiser taper, with the w screen applied per record (continuous w,
   Fresnel-separable, like plain IDG),
4. DFT-sandwiches the subgrid to uv and overlap-adds it at the chunk's
   own uv origin.

Because the A-screen cost is ONE S×S complex multiply per chunk (~128-256
visibilities), IDG-AW runs at essentially plain-IDG throughput — versus
the spectral-convolution path's per-visibility m×m sandwich matmuls.

**Chunk geometry.**  Unlike plain IDG's fixed subgrid tiling, each chunk
gets a subgrid at its OWN origin (the chunk's uv midrange), because chunk
membership is dictated by the antenna pair, not by uv locality.  A chunk
therefore only accumulates records whose support fits inside its subgrid
(``fit_margin``); non-fitting records are DROPPED AND COUNTED — the
returned drop count is part of the contract, and callers/tests assert it
is zero for track-like data (a chunk of consecutive time/channel samples
of one baseline spans a few uv cells).  Random-uv data is NOT the use
case — the spectral-convolution path (``ops.gridding.convgrid_aw``)
covers it.

Accuracy: the A-screen product equals the UNtruncated (a1⊛a2)⊛w
convolution — the reference truncates to s pixels both between and after
its convolutions (``convolve2d``, Gridding.hs:795-811), so for A-kernels
with significant off-center taps the two operators genuinely differ
(measured in ``tests/test_idg.py``: full-stamp 1%-noise akerns diverge
~0.4 through the reference's truncation alone; compact perturbations
agree to ~8e-5).  IDG-AW is the more faithful operator; w placement is
exact continuous-w.  Verified against the reference-semantics bank path
with ``tapered_w_bank`` and against a direct-DFT screen truth in
``tests/test_idg.py``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .idg import _dft_matrix, kaiser_taper

# Default record chunk (contraction depth of the accumulation matmuls).
CHUNK_AW = 128


def auto_fit_margin(S: int, support: int) -> int:
    """Default taper-tail fit margin: ``S/2 − support/2 − taper(S)``.

    The Kaiser taper's argument is ``x/(S/2)``, so its decay region is a
    fixed FRACTION of the subgrid half-width — the 12-cell tail measured
    at S=64 (round-3 FOV sweep) is 12/32 of the half-width at every
    subgrid size.  Scaling it keeps S=32/128 at the same taper
    attenuation (and therefore the same ≤1e-4 accuracy envelope) instead
    of pinning an absolute cell count that leaves S=32 with no margin at
    all.  Shared by the gridder, the degridder and the run counter so the
    operator geometry is identical everywhere."""
    return S // 2 - support // 2 - max(6, (12 * S) // 64)


def aw_screens(akerns, S: int, dtype=jnp.complex64, fov_scale: float = 1.0):
    """Image-domain antenna screens on the S-point subgrid image grid.

    ``akerns``: [nant, s, s] uv-domain A-kernel stamps — integer-cell
    taps on the TARGET-θ uv lattice (spacing 1/θ, the dataset layout the
    bank path consumes).  Returns [nant, S, S] screens
    a(l_q, m_r) = Σ_{j,i} ak[j,i]·e^{-2πi·fov_scale·[(j-s/2)(q-S/2)+(i-s/2)(r-S/2)]/S}
    — the centered synthesis transform matching ``ifft_centered``'s
    analysis convention, so a delta stamp gives the unit screen.

    ``fov_scale`` = θ_grid/θ: when gridding a PADDED FOV (``fov_pad``),
    subgrid pixel q sits at l = (q-S/2)·θ_grid/S while the taps live on
    the 1/θ lattice, so the phase carries the ratio — without it the
    applied antenna pattern would be angularly dilated by θ_grid/θ
    (screens are only θ-independent for delta stamps).

    Row/col orientation follows the bank kernels: axis -2 = y (m), -1 = x
    (l).  The GRIDDING screen is ``conj(a1)·conj(a2)`` (the bank path
    grids with ``conj(A1 ⊛ A2 ⊛ W)``, Gridding.hs:294,392).
    """
    s = akerns.shape[-1]
    ftype = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    j = jnp.arange(s, dtype=ftype) - s // 2
    q = jnp.arange(S, dtype=ftype) - S // 2
    E = jnp.exp(-2j * jnp.pi * fov_scale / S * jnp.outer(q, j).astype(ftype)
                ).astype(dtype)
    return jnp.einsum("qj,ajk,rk->aqr", E, akerns.astype(dtype), E,
                      precision=jax.lax.Precision.HIGHEST)


def aw_screens_host(akerns, S: int, fov_scale: float = 1.0) -> "np.ndarray":
    """Host-side numpy twin of :func:`aw_screens` (complex128): the
    model drivers build screens on the host from the ingested A-kernels
    and pass them into the jitted pipelines as data."""
    ak = np.asarray(akerns)
    s = ak.shape[-1]
    j = np.arange(s) - s // 2
    q = np.arange(S) - S // 2
    E = np.exp(-2j * np.pi * fov_scale / S * np.outer(q, j))
    return np.einsum("qj,ajk,rk->aqr", E, ak, E)


def _record_keys(grid_shape, p, a1, a2, subgrid: int, support: int,
                 fit_margin: int, rdt=None):
    """Shared (pair, uv-tile) key/offset geometry of the IDG-AW chunking
    (gridder, degridder, run counter): per-record sort keys, dy/dx from
    the record's OWN tile (origins are a pure function of the tile id),
    validity and fit masks.  Records that are OOB **or unfit** carry the
    sentinel key 2^30 — they form tail runs that are never gridded, so
    drop accounting never double-counts a record as both unfit and
    overflowed.  Returns (pkey, tkey, dy, dx, valid, fit, Tc, ntx_t,
    HP, WP)."""
    N, Nx = grid_shape
    S = subgrid
    s = support
    if fit_margin == 0:
        fit_margin = auto_fit_margin(S, s)
    assert fit_margin > 0, "subgrid too small for support + taper margin"
    PADM = S
    HP, WP = N + 2 * PADM, Nx + 2 * PADM
    if rdt is None:
        rdt = jnp.float32

    ycf = (N // 2 + p[:, 1] * N + PADM).astype(rdt)
    xcf = (Nx // 2 + p[:, 0] * Nx + PADM).astype(rdt)
    yc = jnp.floor(ycf - PADM + 0.5).astype(jnp.int32)
    xc = jnp.floor(xcf - PADM + 0.5).astype(jnp.int32)
    valid = ((yc - s // 2 > -s) & (yc - s // 2 < N)
             & (xc - s // 2 > -s) & (xc - s // 2 < Nx))
    # pair-key envelope: a1·2¹⁵ + a2 corrupts run grouping (and collides
    # with the 2³⁰ sentinel) once an index reaches 2¹⁵ — such records get
    # the sentinel key via the fit mask below, so they are dropped AND
    # COUNTED (the valid & ~fit term) instead of corrupting silently.
    # 32767 antenna/slot ids is far beyond any SKA layout.
    ant_ok = ((a1 >= 0) & (a1 < 2**15) & (a2 >= 0) & (a2 < 2**15))

    Tc = max(2 * fit_margin - 2, 8)
    ty = jnp.clip(ycf, 0, HP - 1).astype(jnp.int32) // Tc
    tx = jnp.clip(xcf, 0, WP - 1).astype(jnp.int32) // Tc
    ntx_t = WP // Tc + 1
    tkey = ty * ntx_t + tx

    y0r = jnp.clip(ty * Tc - (S - Tc) // 2, 0, HP - S)
    x0r = jnp.clip(tx * Tc - (S - Tc) // 2, 0, WP - S)
    dy = ycf - (y0r.astype(rdt) + S // 2)
    dx = xcf - (x0r.astype(rdt) + S // 2)
    fit = (jnp.abs(dy) <= fit_margin) & (jnp.abs(dx) <= fit_margin) & ant_ok
    pkey = jnp.where(valid & fit,
                     a1.astype(jnp.int32) * jnp.int32(2**15)
                     + a2.astype(jnp.int32), jnp.int32(2**30))
    return pkey, tkey, dy, dx, valid, fit, Tc, ntx_t, HP, WP


@partial(jax.jit, static_argnames=("grid_shape", "subgrid", "support",
                                   "fit_margin"))
def count_pair_tile_runs(grid_shape, p, a1, a2, *, subgrid: int = 64,
                         support: int = 15, fit_margin: int = 0):
    """Number of (pair, uv-tile) runs :func:`idg_grid_aw` forms for these
    records — the least ``max_runs`` that loses nothing to run overflow.

    Same keys and the same two stable sorts as the chunking, so the count
    is exact for the same ``p``.  Records that cannot be placed share the
    sentinel key and add their own (never gridded) runs: a small
    over-count, never an under-count.  Returns an int32 scalar."""
    if p.shape[0] == 0:
        return jnp.int32(0)
    rdt = p.dtype if jnp.issubdtype(p.dtype, jnp.floating) else jnp.float32
    pkey, tkey, *_ = _record_keys(grid_shape, p, a1, a2, subgrid, support,
                                  fit_margin, rdt=rdt)
    o1 = jnp.argsort(tkey, stable=True)
    order = o1[jnp.argsort(pkey[o1], stable=True)]
    k, t = pkey[order], tkey[order]
    new_run = (k[1:] != k[:-1]) | (t[1:] != t[:-1])
    return 1 + jnp.sum(new_run.astype(jnp.int32))


def _chunk_pair_runs(grid_shape, p, a1, a2, w, vis, *, subgrid: int,
                     chunk: int, support: int, max_runs: int,
                     fit_margin: int):
    """(pair, uv-tile)-run chunking: group records by antenna pair AND a
    coarse uv tile of side ``2·fit_margin - 2``, pad runs to whole chunks,
    pick each chunk's subgrid origin, and mask non-fitting records.

    The tile split bounds every chunk's uv spread BY CONSTRUCTION (a
    smooth track simply splits at tile crossings — a few extra runs), so
    the fit test is a safety net, not the normal drop path.  Two stable
    sorts (tile, then pair) preserve time/channel order within a group.

    Returns (dy, dx, wv, vv [n_chunks, chunk], y0, x0, ia1, ia2
    [n_chunks], n_dropped, geometry (S, PADM, HP, WP, n_chunks),
    maps (order, src, ok2, use) — the slot↔record correspondence the
    degrid epilogue inverts; ``use`` masks OOB and unfit outputs to 0).

    ``n_dropped`` counts in-bounds records that could not be gridded:
    run overflow past ``max_runs`` plus residual fit failures — zero when
    ``max_runs`` covers the data's (pair, tile) run count.
    """
    S = subgrid
    n = p.shape[0]
    rdt = jnp.float64 if vis.dtype == jnp.complex128 else jnp.float32
    (pkey, tkey, dyr, dxr, valid, fit, Tc, ntx_t,
     HP, WP) = _record_keys(grid_shape, p, a1, a2, S, support, fit_margin,
                            rdt=rdt)
    PADM = S
    use = valid & fit

    # composite stable sort: tile-major within pair-major — two stable
    # passes (int32 keys; a single composite key would overflow int32)
    o1 = jnp.argsort(tkey, stable=True)
    order = o1[jnp.argsort(pkey[o1], stable=True)]
    key_s = pkey[order]
    tkey_s = tkey[order]
    use_s = use[order]
    dy_s = dyr[order]
    dx_s = dxr[order]
    w_s = w[order].astype(rdt)
    vis_s = jnp.where(use, vis, 0)[order]
    a1_s = a1[order].astype(jnp.int32)
    a2_s = a2[order].astype(jnp.int32)

    # run boundaries -> run ids -> per-run counts -> chunk-padded starts
    new_run = jnp.concatenate(
        [jnp.ones((1,), jnp.int32),
         ((key_s[1:] != key_s[:-1])
          | (tkey_s[1:] != tkey_s[:-1])).astype(jnp.int32)]
    )
    run_id = jnp.cumsum(new_run) - 1                     # [n]
    overflow = run_id >= max_runs
    run_id_c = jnp.minimum(run_id, max_runs - 1)
    counts = jnp.zeros((max_runs,), jnp.int32).at[run_id_c].add(
        (~overflow).astype(jnp.int32))
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts).astype(jnp.int32)]
    )
    counts_pad = ((counts + chunk - 1) // chunk) * chunk
    starts_pad = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(counts_pad).astype(jnp.int32)]
    )
    n_chunks = n // chunk + max_runs + 1
    n_pad = n_chunks * chunk

    from .idg import _spread_i32

    j = jnp.arange(n_pad, dtype=jnp.int32)
    starts_pad_j = _spread_i32(starts_pad[:-1], starts_pad[:-1], n_pad)
    starts_j = _spread_i32(starts[:-1], starts_pad[:-1], n_pad)
    counts_j = _spread_i32(counts, starts_pad[:-1], n_pad)
    local = j - starts_pad_j
    ok = local < counts_j
    src = jnp.where(ok, starts_j + local, 0)

    # chunk origin: a pure function of the chunk's uv TILE — the subgrid
    # centered on the tile; per-record dy/dx come straight from
    # _record_keys (unfit/OOB records carry the sentinel key, so real
    # runs contain only placeable records by construction)
    first = src.reshape(n_chunks, chunk)[:, 0]
    tk_c = tkey_s[first]
    ty_c = tk_c // ntx_t
    tx_c = tk_c - ty_c * ntx_t
    y0 = jnp.clip(ty_c * Tc - (S - Tc) // 2, 0, HP - S)
    x0 = jnp.clip(tx_c * Tc - (S - Tc) // 2, 0, WP - S)

    dy = dy_s[src].reshape(n_chunks, chunk)
    dx = dx_s[src].reshape(n_chunks, chunk)

    # chunk pair ids: first padded slot of every chunk is a real record
    # whenever the chunk has any (run-padding appends at run tails)
    ia1 = a1_s[first]
    ia2 = a2_s[first]
    pair_match = (a1_s[src].reshape(n_chunks, chunk) == ia1[:, None]) & \
                 (a2_s[src].reshape(n_chunks, chunk) == ia2[:, None])

    use_slot = use_s[src].reshape(n_chunks, chunk)
    ok2 = ok.reshape(n_chunks, chunk) & pair_match & use_slot
    vv = (vis_s[src].reshape(n_chunks, chunk)
          * ok2.astype(vis.dtype))
    wv = w_s[src].reshape(n_chunks, chunk)
    # honesty count (disjoint terms): in-bounds records the chunking
    # could not place — fit failures (sentinel-keyed, never in real
    # runs), run overflow of placeable records, and the residual
    # chunk-level safety net.  OOB records are the usual silent drop
    # every gridding mode applies, not a chunking failure.
    n_dropped = (jnp.sum(valid & ~fit)
                 + jnp.sum(overflow & use_s)
                 + jnp.sum(ok.reshape(n_chunks, chunk) & use_slot & ~ok2))
    geom = (S, PADM, HP, WP, n_chunks)
    maps = (order, src, ok2.reshape(-1), use)
    return dy, dx, wv, vv, y0, x0, ia1, ia2, n_dropped, geom, maps


@partial(jax.jit, static_argnames=("grid_shape", "theta", "subgrid",
                                   "chunk", "batch", "support",
                                   "taper_beta", "max_runs", "fit_margin"))
def idg_grid_aw(grid_shape, p, a1, a2, w, vis, screens, *, theta: float,
                subgrid: int = 64, chunk: int = CHUNK_AW,
                batch: int = 64, support: int = 15,
                taper_beta: float = 12.0, max_runs: int = 4096,
                fit_margin: int = 0):
    """AW-projection gridding via image-domain pair screens (XLA path).

    Drop-in for ``convgrid_aw``'s role (same downstream pipeline as
    ``idg_grid_wproj``: hermitian + ifft + ``taper_fine`` division).

    Args:
      grid_shape: (H, W) static.
      p: [n, 3] scaled baselines (uvw/lam).
      a1, a2: [n] int antenna(-slot) indices into ``screens``.
      w: [n] w in wavelengths.
      vis: [n] complex visibilities (weights folded in).
      screens: [nant, S, S] image screens from :func:`aw_screens` —
        UNconjugated; the conjugated pair product is applied here.
      theta: H-axis field of view.
      subgrid, chunk, batch, support, taper_beta: as ``idg_grid_wproj``.
      max_runs: static bound on distinct (pair) runs (≥ number of
        baselines × A-term slots; overflow records are dropped+counted).
      fit_margin: max |uv offset| (cells) from the chunk's subgrid center
        (0 → auto: ``auto_fit_margin`` — the S-scaled taper-tail margin measured
        in ``tests/test_idg.py``).

    Returns (guv [H, W], n_dropped).
    """
    cdt = vis.dtype
    S = subgrid
    if fit_margin == 0:
        fit_margin = auto_fit_margin(S, support)
    assert fit_margin > 0, "subgrid too small for support + taper margin"
    dy, dx, wv, vv, y0, x0, ia1, ia2, n_dropped, geom, _ = \
        _chunk_pair_runs(
            grid_shape, p, a1, a2, w, vis, subgrid=S, chunk=chunk,
            support=support, max_runs=max_runs, fit_margin=fit_margin,
        )
    S, PADM, HP, WP, n_chunks = geom
    N, Nx = grid_shape

    ftype = jnp.float64 if cdt == jnp.complex128 else jnp.float32
    q = jnp.arange(S, dtype=ftype) - S // 2
    theta_x = theta * Nx / N
    lq2y = (q * (theta / S)) ** 2
    lq2x = (q * (theta_x / S)) ** 2
    F = _dft_matrix(S, cdt)
    t1 = kaiser_taper(S, taper_beta, ftype) if taper_beta > 0 else \
        jnp.ones((S,), ftype)
    scr = jnp.conj(screens).astype(cdt)                  # [nant, S, S]

    def scan_body(gp, args):
        dy_b, dx_b, w_b, v_b, y0_b, x0_b, a1_b, a2_b = args
        ph_y = (2.0 * jnp.pi / S) * dy_b[..., None] * q[None, None, :] \
            - jnp.pi * w_b[..., None] * lq2y[None, None, :]
        ph_x = (2.0 * jnp.pi / S) * dx_b[..., None] * q[None, None, :] \
            - jnp.pi * w_b[..., None] * lq2x[None, None, :]
        Ey = jnp.exp(1j * ph_y).astype(cdt)
        Ex = jnp.exp(1j * ph_x).astype(cdt)
        a = jnp.einsum("cbq,cbr->cqr", Ey * v_b[..., None], Ex,
                       preferred_element_type=cdt,
                       precision=jax.lax.Precision.HIGHEST) / (S * S)
        a = a * (scr[a1_b] * scr[a2_b])                  # pair A-screen
        a = a * (t1[None, :, None] * t1[None, None, :]).astype(cdt)
        patches = jnp.einsum("yq,cqr,xr->cyx", F, a, F,
                             preferred_element_type=cdt,
                             precision=jax.lax.Precision.HIGHEST)

        def fold_one(i, gp):
            win = jax.lax.dynamic_slice(
                gp, (y0_b[i], x0_b[i]), (S, S))
            return jax.lax.dynamic_update_slice(
                gp, win + patches[i], (y0_b[i], x0_b[i]))

        return jax.lax.fori_loop(0, y0_b.shape[0], fold_one, gp), None

    nb = -(-n_chunks // batch)
    pad_c = nb * batch - n_chunks

    def pad2(x):
        return jnp.pad(x, ((0, pad_c), (0, 0))).reshape(
            nb, batch, x.shape[1])

    def pad1(x):
        return jnp.pad(x, (0, pad_c)).reshape(nb, batch)

    args = (pad2(dy), pad2(dx), pad2(wv), pad2(vv),
            pad1(y0), pad1(x0), pad1(ia1), pad1(ia2))
    # + 0·data inherits device-varying typing under shard_map so the fold
    # carry type-checks (cf. idg_grid_wproj's sub_imgs); no-op otherwise
    gp = jnp.zeros((HP, WP), cdt) + vv.ravel()[0] * 0
    gp, _ = jax.lax.scan(scan_body, gp, args)
    return gp[PADM:PADM + N, PADM:PADM + Nx], n_dropped


@partial(jax.jit, static_argnames=("grid_shape", "theta", "subgrid",
                                   "chunk", "batch", "support",
                                   "taper_beta", "max_runs", "fit_margin"))
def idg_degrid_aw(grid_shape, p, a1, a2, w, grid, screens, *, theta: float,
                  subgrid: int = 64, chunk: int = CHUNK_AW,
                  batch: int = 64, support: int = 15,
                  taper_beta: float = 12.0, max_runs: int = 4096,
                  fit_margin: int = 0):
    """AW-projection DEgridding: the exact adjoint of :func:`idg_grid_aw`.

    Per pair-chunk the uv window at the chunk's own origin is
    adjoint-sandwiched to a coarse image, multiplied by the UNconjugated
    pair screen ``A[a1]·A[a2]`` (the adjoint of the forward's conjugated
    multiply), and each visibility reads its value as a rank-1
    contraction against the conjugated phase factors — continuous
    (u, v, w) model prediction with direction-dependent antenna terms.

    Args mirror :func:`idg_grid_aw`; ``grid`` is the [H, W] uv-grid.
    Returns ([n] complex visibilities, n_dropped) — records the chunking
    could not place predict 0 and are counted, exactly like the forward.
    """
    cdt = grid.dtype
    S = subgrid
    if fit_margin == 0:
        fit_margin = auto_fit_margin(S, support)
    assert fit_margin > 0, "subgrid too small for support + taper margin"
    n = p.shape[0]
    dummy_vis = jnp.ones((n,), cdt)      # chunking only needs positions
    dy, dx, wv, vv, y0, x0, ia1, ia2, n_dropped, geom, maps = \
        _chunk_pair_runs(
            grid_shape, p, a1, a2, w, dummy_vis, subgrid=S, chunk=chunk,
            support=support, max_runs=max_runs, fit_margin=fit_margin,
        )
    S, PADM, HP, WP, n_chunks = geom
    N, Nx = grid_shape

    ftype = jnp.float64 if cdt == jnp.complex128 else jnp.float32
    q = jnp.arange(S, dtype=ftype) - S // 2
    theta_x = theta * Nx / N
    lq2y = (q * (theta / S)) ** 2
    lq2x = (q * (theta_x / S)) ** 2
    F = _dft_matrix(S, cdt)
    if taper_beta > 0:
        t1 = kaiser_taper(S, taper_beta, ftype)
        F = F * t1[None, :].astype(cdt)
    scr_u = screens.astype(cdt)                      # UNconjugated product

    gp = jnp.zeros((HP, WP), cdt)
    gp = gp.at[PADM:PADM + N, PADM:PADM + Nx].set(grid)

    def scan_body(_, args):
        dy_b, dx_b, w_b, m_b, y0_b, x0_b, a1_b, a2_b = args

        def win_one(i):
            return jax.lax.dynamic_slice(gp, (y0_b[i], x0_b[i]), (S, S))

        wins = jax.vmap(win_one)(jnp.arange(y0_b.shape[0]))   # [B, S, S]
        a_sub = jnp.einsum("qy,cyx,xr->cqr", jnp.conj(F).T, wins,
                           jnp.conj(F), preferred_element_type=cdt,
                           precision=jax.lax.Precision.HIGHEST) / (S * S)
        a_sub = a_sub * (scr_u[a1_b] * scr_u[a2_b])
        ph_y = (2.0 * jnp.pi / S) * dy_b[..., None] * q[None, None, :] \
            - jnp.pi * w_b[..., None] * lq2y[None, None, :]
        ph_x = (2.0 * jnp.pi / S) * dx_b[..., None] * q[None, None, :] \
            - jnp.pi * w_b[..., None] * lq2x[None, None, :]
        ey_c = jnp.exp(-1j * ph_y).astype(cdt)
        ex_c = jnp.exp(-1j * ph_x).astype(cdt)
        v = jnp.einsum("cqr,cbq,cbr->cb", a_sub, ey_c, ex_c,
                       preferred_element_type=cdt,
                       precision=jax.lax.Precision.HIGHEST)
        return None, v * m_b                     # mask dropped/pad slots

    nb = -(-n_chunks // batch)
    pad_c = nb * batch - n_chunks

    def pad2(x):
        return jnp.pad(x, ((0, pad_c), (0, 0))).reshape(nb, batch,
                                                        x.shape[1])

    def pad1(x):
        return jnp.pad(x, (0, pad_c)).reshape(nb, batch)

    mask = vv                                     # 1 where placed, else 0
    args = (pad2(dy), pad2(dx), pad2(wv), pad2(mask),
            pad1(y0), pad1(x0), pad1(ia1), pad1(ia2))
    _, v_blocks = jax.lax.scan(scan_body, None, args)
    v_slots = v_blocks.reshape(-1)[: n_chunks * chunk]

    # unsort: padded slot -> sorted position -> original order (the
    # ``idg_degrid_wproj`` epilogue on the chunking's own maps)
    order, src, ok2, use = maps
    sorted_v = jnp.zeros((n,), cdt).at[
        jnp.where(ok2, src, n)
    ].set(v_slots, mode="drop")
    _, v_re, v_im = jax.lax.sort(
        [order, jnp.real(sorted_v), jnp.imag(sorted_v)], num_keys=1
    )
    out = jax.lax.complex(v_re, v_im).astype(cdt)
    return jnp.where(use, out, 0), n_dropped
