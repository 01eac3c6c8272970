"""Pallas kernels (Triton route): per-tile front-to-back alpha blend, forward
and backward.

The reference's hottest kernel pair is the tile blend
(/root/reference/apps/gsrast/gscuda/GSCuda.cu:543-677) plus the hand-derived
backward the reference never implemented (SURVEY.md §2.3 "no backward pass").
Both kernels keep its shape: one program per tile, one lane per pixel, and a
loop inside the program over the tile's own depth-ordered segment
`[tile_starts[t], tile_starts[t+1])`. Programs run in parallel and share
nothing; each loads its own segment bounds.

Features arrive as ONE (FROWS, C) array in global depth-sorted order: row f
holds feature f of every intersection,
    rows [mx, my, conic_a, conic_b, conic_c, opacity, r, g, b, 0..].

Forward: the reference's sequential per-pixel recurrence. Each gaussian's
nine features are scalar loads; every pixel of the tile updates its own
transmittance T, colour and contribution count. The program stops once every
pixel has saturated (checked every FWD_BATCH gaussians).

Backward: the tile's segment is replayed in reverse, BWD_CHUNK gaussians at a
time, as a (P, BWD_CHUNK) block. Transmittance before each gaussian comes
from a running log-transmittance and an in-chunk prefix sum of log(1 - alpha);
the suffix colour term S_g = sum_{h>g} (dC.c_h) alpha_h T_h is a prefix sum
subtracted from the chunk total. Each pixel's replay is gated by its own
n_contrib. Per-gaussian gradients are sums over the pixel axis, written with a
masked store to the tile's own columns only: no two programs write the same
column, and columns no program writes stay at the zeros the output aliases.

Blend math (identical semantics to GSCuda.cu:634-676):
  power = -1/2 (A dx^2 + C dy^2) - B dx dy        [dx = mean - pixel]
  alpha = min(0.99, opacity * exp(power)); skip power > 0 or alpha < 1/255
  P_i = T_i (1 - alpha_i);  include_i = P_i >= 1e-4 (monotone done flag)
  C += c_i alpha_i T_i; final_T = last included P_i.
n_contrib is the count of segment positions before saturation (include=True
positions), which is what the backward's replay gate needs; the oracle paths
(render/tiled.py, render/dense.py) use the same definition.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import config as cfg

FROWS = 16  # feature rows of the packed layout (9 used)

# feature row indices
F_MX, F_MY, F_CA, F_CB, F_CC, F_OP, F_R, F_G, F_B = range(9)
# output ROWS of the (T, OUT_ROWS, P) per-tile forward result
OUT_ROWS = 8
OC_R, OC_G, OC_B = 0, 1, 2
OC_FT = 3   # final transmittance
OC_NC = 4   # n_contrib as f32 (exact below 2^24)
# aux ROWS of the (T, 8, P) per-pixel backward input
A_DR, A_DG, A_DB, A_DFT, A_FT, A_NC = range(6)

FWD_BATCH = 32   # gaussians between two saturation checks in the forward
BWD_CHUNK = 16   # gaussians per backward replay block
MAX_TILE_PIXELS = 1024


def check_tile_shape(tile_h: int, tile_w: int) -> None:
    """The kernels hold a tile's pixels as one power-of-two vector, at most
    MAX_TILE_PIXELS long (four pixels a thread at eight warps)."""
    for name, v in (("tile_h", tile_h), ("tile_w", tile_w)):
        if v <= 0 or v & (v - 1):
            raise ValueError(f"pallas backend needs power-of-two tiles; "
                             f"{name}={v}")
    if tile_h * tile_w > MAX_TILE_PIXELS:
        raise ValueError(f"pallas backend tiles hold at most "
                         f"{MAX_TILE_PIXELS} pixels, got {tile_h}x{tile_w}")


def _num_warps(p: int, pixels_per_thread: int) -> int:
    return max(1, min(8, p // (32 * pixels_per_thread)))


def _check_interpret(interpret: bool) -> None:
    if interpret and jax.default_backend() == "gpu":
        raise ValueError(
            "interpret=True would run the Pallas interpreter on the GPU; "
            "the blend kernels run compiled there")


def _pixel_coords(tmap_ref, t, grid_w: int, tile_h: int, tile_w: int):
    """Absolute pixel centres of local tile t as (P,) f32 vectors. The
    tile-sharded path renders global tile row tmap[0] + local_row * tmap[1],
    same column."""
    pidx = jnp.arange(tile_h * tile_w, dtype=jnp.int32)
    ty = tmap_ref[0] + jax.lax.div(t, grid_w) * tmap_ref[1]
    tx = jax.lax.rem(t, grid_w)
    px = tx * tile_w + jax.lax.rem(pidx, tile_w)
    py = ty * tile_h + jax.lax.div(pidx, tile_w)
    return px.astype(jnp.float32), py.astype(jnp.float32)


def _forward_kernel(starts_ref, tmap_ref, feat_ref, out_ref, *, grid_w: int,
                    tile_h: int, tile_w: int):
    t = pl.program_id(0)
    start = starts_ref[t]
    end = starts_ref[t + 1]
    px, py = _pixel_coords(tmap_ref, t, grid_w, tile_h, tile_w)
    p = tile_h * tile_w

    def gauss(i, c):
        tr, r, g, b, nc, live = c
        dx = feat_ref[F_MX, i] - px
        dy = feat_ref[F_MY, i] - py
        # Same operation order as the oracle (render/tiled.py), so the two
        # round alike near the ALPHA_MIN cut.
        power = (-0.5 * (feat_ref[F_CA, i] * dx * dx
                         + feat_ref[F_CC, i] * dy * dy)
                 - feat_ref[F_CB, i] * dx * dy)
        alpha = jnp.minimum(cfg.ALPHA_MAX, feat_ref[F_OP, i] * jnp.exp(power))
        ok = (power <= 0.0) & (alpha >= cfg.ALPHA_MIN)
        a = jnp.where(ok, alpha, 0.0)
        test = tr * (1.0 - a)
        # include is monotone: once a pixel saturates it stays done.
        inc = (live > 0.0) & (test >= cfg.TRANSMITTANCE_MIN)
        w = jnp.where(inc, a * tr, 0.0)
        return (
            jnp.where(inc, test, tr),
            r + w * feat_ref[F_R, i],
            g + w * feat_ref[F_G, i],
            b + w * feat_ref[F_B, i],
            nc + jnp.where(inc, 1.0, 0.0),
            jnp.where(inc, 1.0, 0.0),
        )

    def batch_cond(c):
        lo, st = c
        return (lo < end) & (jnp.max(st[5]) > 0.0)

    def batch_body(c):
        lo, st = c
        hi = jnp.minimum(lo + FWD_BATCH, end)
        return hi, jax.lax.fori_loop(lo, hi, gauss, st)

    ones = jnp.ones((p,), jnp.float32)
    zeros = jnp.zeros((p,), jnp.float32)
    _, (tr, r, g, b, nc, _live) = jax.lax.while_loop(
        batch_cond, batch_body, (start, (ones, zeros, zeros, zeros, zeros,
                                         ones)))
    out_ref[OC_R, :] = r
    out_ref[OC_G, :] = g
    out_ref[OC_B, :] = b
    out_ref[OC_FT, :] = tr
    out_ref[OC_NC, :] = nc


def blend_forward(
    feat_packed: jax.Array,  # (FROWS, C) f32: transposed sorted-order feats
    tile_starts: jax.Array,  # (T+1,) i32 segment bounds
    grid_h: int,
    grid_w: int,
    tile_h: int,
    tile_w: int,
    interpret: bool = False,
    num_tiles: int | None = None,
    tile_map: jax.Array | None = None,
) -> jax.Array:
    """Returns (T, OUT_ROWS, P): rows 0:3 rgb, row 3 final_T, row 4
    n_contrib (rows 5:8 unused).

    `num_tiles`/`tile_map` support the tile-sharded path: blend `num_tiles`
    LOCAL tiles whose global tile ROW (for pixel coordinates) is
    tile_map[0] + local_row * tile_map[1], same column."""
    _check_interpret(interpret)
    check_tile_shape(tile_h, tile_w)
    if num_tiles is None:
        num_tiles = grid_h * grid_w
    if tile_map is None:
        tile_map = jnp.array([0, 1], jnp.int32)
    p = tile_h * tile_w
    whole = pl.BlockSpec()
    return pl.pallas_call(
        functools.partial(_forward_kernel, grid_w=grid_w, tile_h=tile_h,
                          tile_w=tile_w),
        grid=(num_tiles,),
        in_specs=[whole, whole, whole],
        out_specs=pl.BlockSpec((None, OUT_ROWS, p), lambda t: (t, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((num_tiles, OUT_ROWS, p), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_num_warps(p, 2),
                                             num_stages=2),
        interpret=interpret,
        name="gsrast_blend_fwd",
    )(tile_starts.astype(jnp.int32), tile_map.astype(jnp.int32), feat_packed)


def _backward_kernel(starts_ref, tmap_ref, feat_ref, aux_ref, _zeros_ref,
                     dfeat_ref, *, grid_w: int, tile_h: int, tile_w: int):
    t = pl.program_id(0)
    start = starts_ref[t]
    px, py = _pixel_coords(tmap_ref, t, grid_w, tile_h, tile_w)
    px, py = px[:, None], py[:, None]
    d_r = aux_ref[A_DR, :][:, None]
    d_g = aux_ref[A_DG, :][:, None]
    d_b = aux_ref[A_DB, :][:, None]
    ft = aux_ref[A_FT, :]
    dft_ft = (aux_ref[A_DFT, :] * ft)[:, None]
    nc = aux_ref[A_NC, :]
    nc_col = nc[:, None]
    # Positions past the tile's last contributor have zero gradient: the
    # replay starts at the chunk holding it, and the aliased zeros stand
    # for the rest of the segment.
    live_end = start + jnp.max(nc).astype(jnp.int32)
    nchunks = jax.lax.div(live_end - start + BWD_CHUNK - 1, BWD_CHUNK)
    lane = jnp.arange(BWD_CHUNK, dtype=jnp.int32)

    def chunk(j, carry):
        log_t, q = carry  # per pixel: log T after this chunk, suffix sum
        c = nchunks - 1 - j
        c0 = start + c * BWD_CHUNK
        col_ok = c0 + lane < live_end
        cols = pl.ds(c0, BWD_CHUNK)

        def row(f):
            return plgpu.load(feat_ref.at[f, cols], mask=col_ok, other=0.0)

        ca, cb, cc = row(F_CA), row(F_CB), row(F_CC)
        dx = row(F_MX)[None, :] - px
        dy = row(F_MY)[None, :] - py
        power = (-0.5 * (ca[None, :] * dx * dx + cc[None, :] * dy * dy)
                 - cb[None, :] * dx * dy)
        gv = jnp.exp(power)
        og = row(F_OP)[None, :] * gv
        alpha = jnp.minimum(cfg.ALPHA_MAX, og)
        idx = (c * BWD_CHUNK + lane).astype(jnp.float32)[None, :]
        applied = ((power <= 0.0) & (alpha >= cfg.ALPHA_MIN)
                   & (idx < nc_col) & col_ok[None, :])
        a_m = jnp.where(applied, alpha, 0.0)
        om = 1.0 - a_m  # >= 1 - ALPHA_MAX = 0.01
        lom = jnp.log(om)
        lom_tot = jnp.sum(lom, axis=1)
        # log T before gaussian g = log T_after - sum_{h >= g} lom_h.
        t_g = jnp.exp((log_t - lom_tot)[:, None] + jnp.cumsum(lom, axis=1)
                      - lom)
        w = a_m * t_g
        u = (d_r * row(F_R)[None, :] + d_g * row(F_G)[None, :]
             + d_b * row(F_B)[None, :])
        uw = u * w
        uw_tot = jnp.sum(uw, axis=1)
        suffix = uw_tot[:, None] - jnp.cumsum(uw, axis=1)  # sum_{h>g}
        dalpha = t_g * u - (suffix + q[:, None] + dft_ft) / om
        # alpha = min(0.99, o*G): the clamped branch has zero gradient.
        da_g = jnp.where(applied & (og < cfg.ALPHA_MAX), dalpha, 0.0)
        dpower = da_g * og
        dpx = dpower * dx
        dpy = dpower * dy
        sx = jnp.sum(dpx, axis=0)
        sy = jnp.sum(dpy, axis=0)
        grads = (
            (F_MX, -(ca * sx + cb * sy)),
            (F_MY, -(cc * sy + cb * sx)),
            (F_CA, -0.5 * jnp.sum(dpx * dx, axis=0)),
            (F_CB, -jnp.sum(dpx * dy, axis=0)),
            (F_CC, -0.5 * jnp.sum(dpy * dy, axis=0)),
            (F_OP, jnp.sum(da_g * gv, axis=0)),
            (F_R, jnp.sum(w * d_r, axis=0)),
            (F_G, jnp.sum(w * d_g, axis=0)),
            (F_B, jnp.sum(w * d_b, axis=0)),
        )
        for f, val in grads:
            plgpu.store(dfeat_ref.at[f, cols], val, mask=col_ok)
        return log_t - lom_tot, q + uw_tot

    jax.lax.fori_loop(
        0, nchunks, chunk, (jnp.log(ft), jnp.zeros_like(ft)))


def blend_backward(
    feat_packed: jax.Array,  # (FROWS, C)
    tile_starts: jax.Array,  # (T+1,) i32 segment bounds
    aux: jax.Array,  # (T, 8, P): d_rgb | d_ft | saved final_T | saved nc
    grid_h: int,
    grid_w: int,
    tile_h: int,
    tile_w: int,
    interpret: bool = False,
    num_tiles: int | None = None,
    tile_map: jax.Array | None = None,
) -> jax.Array:
    """Per-intersection feature gradients (FROWS, C) in the packed layout;
    rows 9: and every column no tile's replay reaches are zero."""
    _check_interpret(interpret)
    check_tile_shape(tile_h, tile_w)
    if num_tiles is None:
        num_tiles = grid_h * grid_w
    if tile_map is None:
        tile_map = jnp.array([0, 1], jnp.int32)
    p = tile_h * tile_w
    whole = pl.BlockSpec()
    return pl.pallas_call(
        functools.partial(_backward_kernel, grid_w=grid_w, tile_h=tile_h,
                          tile_w=tile_w),
        grid=(num_tiles,),
        in_specs=[whole, whole, whole,
                  pl.BlockSpec((None, 8, p), lambda t: (t, 0, 0)), whole],
        out_specs=whole,
        out_shape=jax.ShapeDtypeStruct(feat_packed.shape, jnp.float32),
        input_output_aliases={4: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_num_warps(p, 1),
                                             num_stages=2),
        interpret=interpret,
        name="gsrast_blend_bwd",
    )(tile_starts.astype(jnp.int32), tile_map.astype(jnp.int32), feat_packed,
      aux, jnp.zeros(feat_packed.shape, jnp.float32))
