"""Image-domain gridding (IDG): w-projection as batched matmuls.

An alternative gridding algorithm for the reference's w-projection
semantics (``/root/reference/src/Gridding.hs:199-244`` + the kernel screen
of ``:651-667``) that turns the scatter into dense matrix products
(PAPERS.md #1, van der Tol et al. 2018 — method only; the realization here
is this repo's own):

The uv-plane is tiled into overlapping **subgrids** (size ``S``, stride
``T``).  Each visibility's kernel support fits inside one subgrid, so its
contribution to that subgrid is the centered FFT of a rank-1 image-plane
term: ``vis · e^{2πi(u'l + v'm + w·n(l,m))}`` sampled on the subgrid's
S×S coarse image grid.  Summing over a batch of visibilities BEFORE the
FFT turns gridding into

    a[q, r] = Σ_b (vis_b·E_y[b, q]) · E_x[b, r]        — a complex matmul,
    subgrid  = F · a · Fᵀ                              — DFT sandwich,
    master grid += overlap-add of subgrids             — dense fold,

i.e. ~2·S² complex MACs per visibility in matmuls, ~zero scatter.  Three
properties versus the exact oversampled-bank scatter:

* **No oversampling quantization** — the phase factors place each
  visibility at its EXACT continuous uv position (the bank path quantizes
  to 1/qpx of a cell), so IDG is *more* accurate than the bank for the
  same screen.
* **w-term separability** — the screen ``e^{2πi w(1−√(1−l²−m²))}`` is
  factored as ``e^{πiwl²}·e^{πiwm²}`` (Fresnel form).  The neglected
  cross/quartic residual is ``2πw(l²+m²)²/8`` ≈ 3e-6 rad at SKA1_Low scale
  (θ=0.008, w≤4000) — far below the bank path's own truncation error.
  Valid for the small-FOV regime w-projection itself assumes.
* **Kernel support = subgrid** — the effective kernel is the S-point DFT
  of the screen (the bank truncates at npix_kern taps); the screen's tail
  aliases periodically within the subgrid instead of being cut off.

**The taper.**  A visibility's band-limited placement kernel (periodic
sinc) has 1/x tails across the whole grid; windowing it to one subgrid
truncates them (≈18% RMS — the same error class as the reference's 15-tap
Dirichlet truncation).  IDG therefore multiplies every subgrid image by a
separable taper ``t(l)·t(m)`` (Kaiser window) whose uv-transform is
concentrated well inside the subgrid margin, and divides the FINAL dirty
image by the taper's fine-grid interpolation (every subgrid shares the
same full-FOV taper, so it factors out of the whole image exactly).  With
β≈12 the method error drops to ~1e-3 and the effective gridding kernel is
``DFT(taper·screen)`` — use :func:`tapered_w_bank` to build the SAME
operator for the exact scatter path when tight cross-method parity is
wanted (``tests/test_idg.py``).

Parity versus the plain reference bank is bounded by the reference's own
truncation error; verified both ways in ``tests/test_idg.py``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .coords import frac_coord


def _spread_i32(vals_at_starts, starts, n_pad):
    """Per-slot broadcast of per-segment values (boundary scatter +
    cumsum instead of a searchsorted/gather over n_pad)."""
    buf = jnp.zeros((n_pad,), jnp.int32)
    deltas = vals_at_starts - jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), vals_at_starts[:-1]]
    )
    buf = buf.at[starts].add(deltas)
    return jnp.cumsum(buf)


def kaiser_taper(S: int, beta: float, dtype=jnp.float32):
    """Separable Kaiser image-domain taper sampled on the S-point coarse
    grid: t[q] = I0(β√(1-(2(q-S/2)/S)²)) / I0(β)."""
    fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    q = (jnp.arange(S, dtype=fdt) - S // 2) / (S / 2)
    t = jnp.i0(beta * jnp.sqrt(jnp.clip(1.0 - q * q, 0.0, 1.0)))
    return (t / jnp.i0(jnp.asarray(beta, fdt))).astype(dtype)


def taper_fine(N: int, S: int, taper_1d):
    """Fine-grid divisor for the final dirty image: the band-limited
    interpolation of the coarse S-point taper onto N points (zero-padded
    centered DFT round-trip — exactly the function the subgrid pipeline
    multiplied in)."""
    cdt = jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64
    t = jnp.asarray(taper_1d, cdt)
    spec = jnp.fft.fftshift(jnp.fft.fft(jnp.fft.ifftshift(t)))
    lo = N // 2 - S // 2
    padded = jnp.zeros((N,), cdt).at[lo:lo + S].set(spec)
    fine = jnp.fft.fftshift(jnp.fft.ifft(jnp.fft.ifftshift(padded)))
    return jnp.real(fine) * (N / S)


def tapered_w_bank(theta: float, w_centers, opts, taper_beta: float,
                   subgrid: int, dtype=jnp.float64):
    """Conjugated oversampled kernel bank of the TAPERED screen
    ``t(l)t(m)·e^{2πiw n(l,m)}`` — the exact-scatter operator that matches
    IDG's effective kernel (same pipeline as ``ops.wkernel.w_kernel_bank``,
    screen multiplied by the Kaiser taper evaluated on the npix_ff grid
    at the subgrid's coarse-sampling width)."""
    from .fourier import ifft_centered, pad_mid
    from .wkernel import kernel_coordinates, w_kernel_function, \
        extract_oversampled

    l, m = kernel_coordinates(opts.npix_ff, theta, opts, dtype=dtype)
    ff = w_kernel_function(l, m, jnp.asarray(w_centers))
    # taper as a function of l/θ ∈ [-1/2, 1/2): same analytic window the
    # subgrid pipeline samples at S points
    x = l[0] / theta * 2.0                       # ∈ [-1, 1)
    t1 = jnp.i0(taper_beta * jnp.sqrt(jnp.clip(1.0 - x * x, 0.0, 1.0)))
    t1 = t1 / jnp.i0(jnp.asarray(taper_beta, jnp.float64))
    ff = ff * (t1[None, :] * t1[:, None]).astype(ff.dtype)
    padff = pad_mid(ff, opts.npix_ff * opts.qpx)
    af = ifft_centered(padff)
    return jnp.conj(extract_oversampled(af, opts.qpx, opts.npix_kern))



def _bin_chunk_records(grid_shape, p, w, subgrid: int, chunk: int,
                       support: int):
    """Shared binning/sorting/chunk-padding for the XLA IDG grid/degrid
    pair: assign each record to its subgrid, sort, pad every subgrid's run
    to whole chunks, and derive per-padded-slot positions relative to the
    subgrid center.  Returns
    (dy, dx, wv [n_pad], chunk_sub [n_chunks_max], ok, src, order, valid,
    geometry (S, T, PADM, nty, ntx, n_sub, n_pad, n_chunks_max)).

    Non-square grids are supported: subgrid tiling, assignment and
    positions are per-axis."""
    N, Nx = grid_shape
    S, T = subgrid, subgrid // 2
    s = support
    if s > T + 1:
        raise ValueError(
            f"IDG needs support <= subgrid/2+1; got s={s}, S={S} — use a "
            "larger subgrid")
    PADM = T
    nty = -(-(N + 2 * PADM) // T) + 1
    ntx = -(-(Nx + 2 * PADM) // T) + 1
    n_sub = nty * ntx
    n = p.shape[0]

    # assignment: anchor = top-left of the support, like the bank
    # gridder's patch origin y0 (``ops.gridding.convgrid_wproj``)
    yc, _ = frac_coord(N, 1, p[:, 1])
    xc, _ = frac_coord(Nx, 1, p[:, 0])
    y0 = yc - s // 2
    x0 = xc - s // 2
    valid = (y0 > -s) & (y0 < N) & (x0 > -s) & (x0 < Nx)
    y0p = jnp.where(valid, y0 + PADM, 0)
    x0p = jnp.where(valid, x0 + PADM, 0)
    gy = y0p // T
    gx = x0p // T
    t = jnp.where(valid, gy * ntx + gx, n_sub).astype(jnp.int32)
    order = jnp.argsort(t)
    t_s = t[order]

    # continuous padded-grid cell positions (exact placement, no rounding)
    ycf = (N // 2 + p[:, 1] * N + PADM)[order]
    xcf = (Nx // 2 + p[:, 0] * Nx + PADM)[order]
    w_s = w[order]

    # pad each subgrid's run to whole chunks (records of one chunk all
    # belong to one subgrid)
    starts = jnp.searchsorted(t_s, jnp.arange(n_sub + 1)).astype(jnp.int32)
    counts = starts[1:] - starts[:-1]
    counts_pad = ((counts + chunk - 1) // chunk) * chunk
    starts_pad = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts_pad).astype(jnp.int32)]
    )
    n_chunks_max = n // chunk + n_sub + 1
    n_pad = n_chunks_max * chunk

    j = jnp.arange(n_pad, dtype=jnp.int32)
    starts_pad_j = _spread_i32(starts_pad[:-1], starts_pad[:-1], n_pad)
    starts_j = _spread_i32(starts[:-1], starts_pad[:-1], n_pad)
    counts_j = _spread_i32(counts, starts_pad[:-1], n_pad)
    tile_j = _spread_i32(jnp.arange(n_sub, dtype=jnp.int32),
                         starts_pad[:-1], n_pad)
    local = j - starts_pad_j
    ok = local < counts_j
    src = jnp.where(ok, starts_j + local, 0)

    gy_j = tile_j // ntx
    gx_j = tile_j - gy_j * ntx
    # position relative to the subgrid's center cell (S/2 inside the block)
    dy = ycf[src] - (gy_j * T).astype(p.dtype) - (S // 2)
    dx = xcf[src] - (gx_j * T).astype(p.dtype) - (S // 2)
    wv = w_s[src]
    chunk_sub = tile_j[::chunk]                          # [n_chunks_max]
    geom = (S, T, PADM, nty, ntx, n_sub, n_pad, n_chunks_max)
    return dy, dx, wv, chunk_sub, ok, src, order, valid, geom


def idg_fov_pad_plan(N: int, fov_fraction: float):
    """Padded-FOV plan for full-FOV-accurate IDG imaging.

    The taper division amplifies error toward the image edge: measured on
    the direct-DFT truth (max-norm radius bands, S=64, β=12):

        r ≤ 0.75 : ≤ 5e-5      0.75–0.875 : ~7e-4
        0.875–0.95 : ~1e-2     r > 0.95   : O(0.3) — unusable

    So the plain image is quantifiably accurate only inside ~75–87% of
    the FOV.  For a FULL-FOV guarantee, grid a padded FOV so the target
    image maps to the usable interior: with ``fov_fraction`` f the grid
    becomes N′ = N/f (same pixel size, θ′ = θ·N′/N) and the center N
    pixels are cropped.  f = 0.75 bounds the full target-FOV error at
    ≤ ~1e-3 (dominated by the 0.75-radius ring) for ~1.8× grid area.

    Returns (N_pad, crop_lo): grid at N_pad (same parity as N, so the
    center crop is exact), crop rows/cols [crop_lo, crop_lo + N).
    """
    if not (0.0 < fov_fraction <= 1.0):
        raise ValueError("fov_fraction must be in (0, 1]")
    extra = int(-(-N * (1.0 / fov_fraction - 1.0) // 2)) * 2
    return N + extra, extra // 2


def fov_pad_geometry(theta: float, lam: int, fov_pad):
    """One shared padded-FOV plan for every IDG-family pipeline: returns
    (n_target, n_grid, theta_grid, crop_lo).  ``fov_pad=None`` → plain
    FOV.  Keep the companion :func:`fov_pad_finish` in sync."""
    n = int(round(theta * lam))
    if fov_pad is not None:
        n_grid, crop_lo = idg_fov_pad_plan(n, fov_pad)
        return n, n_grid, theta * n_grid / n, crop_lo
    return n, n, theta, 0


def fov_pad_finish(img, n: int, n_grid: int, crop_lo: int):
    """Rescale + center-crop a padded-FOV dirty image back to the target
    grid (the centered iFFT scales by 1/n_grid²; restore the target-grid
    normalization so padded and plain runs share the image scale)."""
    if n_grid == n:
        return img
    img = img * ((n_grid / n) ** 2)
    return img[crop_lo:crop_lo + n, crop_lo:crop_lo + n]


def fov_pad_start(img, n: int, n_grid: int, crop_lo: int):
    """PREDICT-direction companion of :func:`fov_pad_finish`: embed the
    target-FOV model image into the padded grid (zeros outside — the
    model asserts no sources beyond the target FOV).  No amplitude
    rescale: the forward FFT is unnormalized, so each model pixel
    contributes the same phase ramp regardless of grid size; padding
    only moves the taper division to the padded image's interior, where
    its error is bounded (``idg_fov_pad_plan`` bands)."""
    if n_grid == n:
        return img
    return jnp.zeros((n_grid, n_grid), img.dtype).at[
        crop_lo:crop_lo + n, crop_lo:crop_lo + n].set(img)


def _dft_matrix(S: int, dtype):
    """Centered forward DFT matrix: F[y, q] = e^{-2πi (y-S/2)(q-S/2)/S}.

    Phases are built at the precision the target dtype implies so the
    complex128 oracle path is not capped at f32 phase accuracy: f64
    phases for complex128 (when x64 is enabled)."""
    ftype = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    k = jnp.arange(S, dtype=ftype) - S // 2
    ph = -2.0 * jnp.pi * jnp.outer(k, k) / S
    return jnp.exp(1j * ph.astype(ftype)).astype(dtype)


def _fold_overlap(blocks, nty: int, ntx: int, S: int, T: int):
    """Overlap-add subgrid blocks (stride T, size S = 2T) into the padded
    grid — four dense reshape-adds, no scatter."""
    assert S == 2 * T
    core = blocks[:, :, :T, :T]
    right = blocks[:, :, :T, T:]
    down = blocks[:, :, T:, :T]
    corner = blocks[:, :, T:, T:]
    g = jnp.zeros((nty + 1, T, ntx + 1, T), blocks.dtype)
    g = g.at[:nty, :, :ntx, :].add(core.transpose(0, 2, 1, 3))
    g = g.at[:nty, :, 1:, :].add(right.transpose(0, 2, 1, 3))
    g = g.at[1:, :, :ntx, :].add(down.transpose(0, 2, 1, 3))
    g = g.at[1:, :, 1:, :].add(corner.transpose(0, 2, 1, 3))
    return g.reshape((nty + 1) * T, (ntx + 1) * T)


@partial(jax.jit, static_argnames=("grid_shape", "theta", "subgrid",
                                   "chunk", "batch", "support",
                                   "taper_beta"))
def idg_grid_wproj(grid_shape, p, w, vis, *, theta: float,
                   subgrid: int = 32, chunk: int = 128,
                   batch: int = 256, support: int = 15,
                   taper_beta: float = 12.0):
    """w-projection gridding via image-domain subgrid matmuls.

    Drop-in for ``convgrid_wproj``'s role: returns the [H, W] uv-grid to
    feed hermitian completion + ``ifft_centered``.  The resulting dirty
    image must be divided by ``taper_fine(N, S, kaiser_taper(S, β))`` per
    axis (outer product) — see ``models.dataset._idg_pipeline``.

    Args:
      grid_shape: (H, W) static — non-square supported (theta is the
        H-axis FOV; the W-axis FOV is theta·W/H, same pixel size).
      p: [n, 3] scaled baselines (±0.5 box, uvw/lam).
      w: [n] w in wavelengths (``uvw_l[:, 2]`` — NOT divided by lam).
      vis: [n] complex visibilities (weights folded in).
      theta: field of view (the screen needs physical l, m).
      subgrid: S, subgrid pixel size (stride is S/2).
      chunk: records per matmul group (contraction length).
      batch: chunks per scan step (bounds phase-matrix memory).
      support: assumed kernel support for subgrid assignment + OOB drop
        (must be ≤ S/2 + 1).
      taper_beta: Kaiser β of the subgrid taper (0 disables — then the
        placement sinc is box-truncated at the subgrid, ~18% RMS).
    """
    cdt = vis.dtype
    dy, dx, wv, chunk_sub, ok, src, order, valid, geom = _bin_chunk_records(
        grid_shape, p, w, subgrid, chunk, support
    )
    S, T, PADM, nty, ntx, n_sub, n_pad, n_chunks_max = geom
    N, Nx = grid_shape
    vis_s = jnp.where(valid, vis, 0)[order]
    vv = vis_s[src] * ok.astype(cdt)

    # ---- phase factors.  Subgrid image pixel q sits at image coordinate
    # l_q = (q - S/2)·θ/S (full FOV θ at coarse S-point sampling).  Its
    # placement phase vs the centered S-point DFT is e^{2πi (q-S/2)·dy/S};
    # the w screen contributes e^{-πi w l²} per axis (Fresnel-separable
    # e^{-2πi w n(l,m)} — the sign matches the pre-CONJUGATED bank the
    # exact path grids with, ``ops.wkernel.w_kernel_bank``).
    # per-axis image coordinates: theta is the Y-axis FOV; the pixel size
    # is shared, so the X-axis FOV scales with the grid aspect (square
    # grids reduce to the old single-theta form)
    q = jnp.arange(S, dtype=jnp.float32) - S // 2        # [S]
    theta_x = theta * Nx / N
    lq2y = (q * (theta / S)) ** 2
    lq2x = (q * (theta_x / S)) ** 2

    dy_c = dy.reshape(n_chunks_max, chunk)
    dx_c = dx.reshape(n_chunks_max, chunk)
    wv_c = wv.reshape(n_chunks_max, chunk)
    vv_c = vv.reshape(n_chunks_max, chunk)

    F = _dft_matrix(S, cdt)                              # [S(y'), S(q)]

    def scan_body(acc, args):
        dy_b, dx_b, w_b, v_b, sub_b = args
        # [B, chunk, S] phase matrices
        ph_y = (2.0 * jnp.pi / S) * dy_b[..., None] * q[None, None, :] \
            - jnp.pi * w_b[..., None] * lq2y[None, None, :]
        ph_x = (2.0 * jnp.pi / S) * dx_b[..., None] * q[None, None, :] \
            - jnp.pi * w_b[..., None] * lq2x[None, None, :]
        Ey = jnp.exp(1j * ph_y).astype(cdt)
        Ex = jnp.exp(1j * ph_x).astype(cdt)
        a = jnp.einsum("cbq,cbr->cqr", Ey * v_b[..., None], Ex,
                       preferred_element_type=cdt,
                       precision=jax.lax.Precision.HIGHEST)
        a = a / (S * S)
        return acc.at[sub_b].add(a), None

    nb = -(-n_chunks_max // batch)
    pad_c = nb * batch - n_chunks_max
    args = (
        jnp.pad(dy_c, ((0, pad_c), (0, 0))).reshape(nb, batch, chunk),
        jnp.pad(dx_c, ((0, pad_c), (0, 0))).reshape(nb, batch, chunk),
        jnp.pad(wv_c, ((0, pad_c), (0, 0))).reshape(nb, batch, chunk),
        jnp.pad(vv_c, ((0, pad_c), (0, 0))).reshape(nb, batch, chunk),
        jnp.pad(chunk_sub, (0, pad_c),
                constant_values=n_sub).reshape(nb, batch),
    )
    # +1 = dropped slot; the `+ 0·data` term inherits device-varying typing
    # under shard_map so the scan carry type-checks (cf. sharded.py's
    # _varying_zeros) and is a no-op otherwise
    sub_imgs = jnp.zeros((n_sub + 1, S, S), cdt) + vv_c.ravel()[0] * 0
    sub_imgs, _ = jax.lax.scan(scan_body, sub_imgs, args)
    sub_imgs = sub_imgs[:n_sub]

    if taper_beta > 0:
        t1 = kaiser_taper(S, taper_beta, jnp.float32)
        sub_imgs = sub_imgs * (t1[None, :, None] * t1[None, None, :]
                               ).astype(cdt)

    # ---- subgrid uv patches: centered DFT sandwich (matmuls), overlap-add
    patches = jnp.einsum("yq,sqr,xr->syx", F, sub_imgs, F,
                         preferred_element_type=cdt,
                         precision=jax.lax.Precision.HIGHEST)
    gp = _fold_overlap(patches.reshape(nty, ntx, S, S), nty, ntx, S, T)
    return gp[PADM:PADM + N, PADM:PADM + Nx]


def _overlap_windows(gp, nty: int, S: int, T: int, ntx: int = None):
    """All S×S subgrid windows (stride T, S = 2T) of the padded grid —
    the inverse of :func:`_fold_overlap`, four dense block stacks."""
    assert S == 2 * T
    if ntx is None:
        ntx = nty
    b = gp.reshape(nty + 1, T, ntx + 1, T).transpose(0, 2, 1, 3)
    tl = b[:nty, :ntx]
    tr = b[:nty, 1:]
    bl = b[1:, :ntx]
    br = b[1:, 1:]
    top = jnp.concatenate([tl, tr], axis=-1)      # [nty, nty, T, 2T]
    bot = jnp.concatenate([bl, br], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)   # [nty, nty, 2T, 2T]


@partial(jax.jit, static_argnames=("grid_shape", "theta", "subgrid",
                                   "chunk", "batch", "support",
                                   "taper_beta"))
def idg_degrid_wproj(grid_shape, p, w, grid, *, theta: float,
                     subgrid: int = 32, chunk: int = 128,
                     batch: int = 256, support: int = 15,
                     taper_beta: float = 12.0):
    """Image-domain DEgridding: the exact adjoint of :func:`idg_grid_wproj`.

    Per subgrid the uv window is inverse-DFT-sandwiched back to a coarse
    image, and each visibility reads its value as a rank-1 contraction
    against the conjugated phase factors — exact continuous (u, v, w)
    evaluation, no oversampling quantization (the bank path's
    ``degrid_wproj`` quantizes to 1/qpx cells).

    For model PREDICTION divide the model image by the taper before the
    forward FFT: ``predict = idg_degrid_wproj(fft(img / taper²))`` — the
    taper inside the operator then cancels (standard IDG degridding).

    Args mirror :func:`idg_grid_wproj`; ``grid`` is the [N, N] uv-grid.
    Returns [n] complex visibilities (OOB records → 0).
    """
    cdt = grid.dtype
    n = p.shape[0]
    # ---- identical binning/sort to the gridder
    dy, dx, wv, chunk_sub, ok, src, order, valid, geom = _bin_chunk_records(
        grid_shape, p, w, subgrid, chunk, support
    )
    S, T, PADM, nty, ntx, n_sub, n_pad, n_chunks_max = geom
    N, Nx = grid_shape

    # ---- subgrid coarse images: adjoint sandwich a = F'ᴴ · W · conj(F')
    gp = jnp.zeros(((nty + 1) * T, (ntx + 1) * T), cdt)
    gp = gp.at[PADM:PADM + N, PADM:PADM + Nx].set(grid)
    wins = _overlap_windows(gp, nty, S, T, ntx).reshape(n_sub, S, S)
    F = _dft_matrix(S, cdt)
    if taper_beta > 0:
        t1 = kaiser_taper(S, taper_beta, jnp.float32)
        F = F * t1[None, :].astype(cdt)
    Fc = jnp.conj(F)
    a_sub = jnp.einsum("qy,syx,xr->sqr", jnp.conj(F).T, wins, Fc,
                       preferred_element_type=cdt,
                       precision=jax.lax.Precision.HIGHEST) / (S * S)
    a_sub = jnp.concatenate(
        [a_sub, jnp.zeros((1, S, S), cdt)], axis=0     # dropped-slot row
    )

    q = jnp.arange(S, dtype=jnp.float32) - S // 2
    theta_x = theta * Nx / N
    lq2y = (q * (theta / S)) ** 2
    lq2x = (q * (theta_x / S)) ** 2
    dy_c = dy.reshape(n_chunks_max, chunk)
    dx_c = dx.reshape(n_chunks_max, chunk)
    wv_c = wv.reshape(n_chunks_max, chunk)

    def scan_body(_, args):
        dy_b, dx_b, w_b, sub_b = args
        ph_y = (2.0 * jnp.pi / S) * dy_b[..., None] * q[None, None, :] \
            - jnp.pi * w_b[..., None] * lq2y[None, None, :]
        ph_x = (2.0 * jnp.pi / S) * dx_b[..., None] * q[None, None, :] \
            - jnp.pi * w_b[..., None] * lq2x[None, None, :]
        ey_c = jnp.exp(-1j * ph_y).astype(cdt)         # conj(E_y)
        ex_c = jnp.exp(-1j * ph_x).astype(cdt)
        a_b = a_sub[sub_b]                             # [B, S, S] row gather
        v = jnp.einsum("cqr,cbq,cbr->cb", a_b, ey_c, ex_c,
                       preferred_element_type=cdt,
                       precision=jax.lax.Precision.HIGHEST)
        return None, v

    nb = -(-n_chunks_max // batch)
    pad_c = nb * batch - n_chunks_max
    args = (
        jnp.pad(dy_c, ((0, pad_c), (0, 0))).reshape(nb, batch, chunk),
        jnp.pad(dx_c, ((0, pad_c), (0, 0))).reshape(nb, batch, chunk),
        jnp.pad(wv_c, ((0, pad_c), (0, 0))).reshape(nb, batch, chunk),
        jnp.pad(chunk_sub, (0, pad_c),
                constant_values=n_sub).reshape(nb, batch),
    )
    _, v_blocks = jax.lax.scan(scan_body, None, args)
    v_pad = v_blocks.reshape(-1)[: n_pad]

    # ---- unsort: padded slot → sorted position → original order (scatter
    # with drop for masked slots, then one key-payload sort by `order`)
    sorted_v = jnp.zeros((n,), cdt).at[
        jnp.where(ok, src, n)
    ].set(v_pad, mode="drop")
    _, v_re, v_im = jax.lax.sort(
        [order, jnp.real(sorted_v), jnp.imag(sorted_v)], num_keys=1
    )
    out = jax.lax.complex(v_re, v_im).astype(cdt)
    return jnp.where(valid, out, 0)
