"""North-star benchmark + per-stage decomposition, shared by the root
`bench.py` driver entry and `python -m gsrast_tpu bench`.

The reference publishes no numbers (BASELINE.md); the target metric is
Mpixels/s per card forward+backward at 1080p with 1M Gaussians
(BASELINE.json). Keeping the shipped number and the stage profile in ONE
module means they cannot diverge.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp


def bench_config(backend: str):
    """THE benchmark base RenderConfig. Single source of truth for every
    harness (bench.py, the CLI bench table, profile scripts). 16x16 tiles,
    the reference's (GSCuda.cu:20-21). The tier spec is NOT hardcoded here: every bench derives it from the
    scene's measured count distribution via the product auto-config
    (render/api.py auto_render_config), same as `gsrast_tpu render/train`."""
    from . import config as cfg

    return cfg.RenderConfig(
        backend=backend,
        tile_h=16,
        tile_w=16,
        intersect_capacity_factor=5.0,
        max_per_tile=4096,
        tile_chunk=8,
        max_tiles_per_gaussian=16,
    )


def bench_scene_camera(n: int, width: int, height: int, sh: int = 3,
                       seed: int = 0):
    from .camera import Camera, look_at
    from .scene.gaussians import random_scene

    scene = random_scene(
        jax.random.PRNGKey(seed), n, sh_degree=sh, isotropic=False,
        scale_range=(0.002, 0.008),
    )
    camera = Camera(
        view=look_at(jnp.array([0.0, 0.0, -2.5]), jnp.zeros(3)),
        fov_x=jnp.float32(1.2), fov_y=jnp.float32(1.0),
        width=width, height=height,
    )
    return scene, camera


def scene_tile_counts(scene, camera, rcfg):
    """Per-Gaussian owned-tile counts (delegates to render/api.py)."""
    from .render.api import scene_tile_counts as _stc

    return _stc(scene, camera, rcfg)


def auto_tiers_for(scene, camera, rcfg):
    """Tier spec from one preprocess pass over (scene, camera): per-Gaussian
    owned-tile counts -> ops.binning.auto_tiers."""
    from .ops import binning as binning_ops

    return binning_ops.auto_tiers(scene_tile_counts(scene, camera, rcfg))


def timeit(fn: Callable, *args, iters: int = 3) -> float:
    """Best-of-iters wall ms with a compile warmup."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def run_bench(n: int, width: int, height: int, backend: str,
              fwd_only: bool = False, iters: int = 10, scene=None,
              camera=None, chain: int = 1, **cfg_overrides):
    """Time the north-star step. Returns (best_ms, mpix_s).

    `chain` > 1 measures STEADY-STATE throughput: a lax.scan of `chain`
    data-dependent steps inside ONE executable, timed with one sync and
    divided by `chain`: a real training loop enqueues step N+1 while N
    runs, so per-dispatch overhead is not part of a step. The scan carries the params through a zero-magnitude update derived from
    each step's gradients, so steps stay dependent (no CSE/DCE) exactly
    like a real optimizer chain."""
    from .render.api import render
    from .scene.gaussians import merge_params, split_params

    rcfg = bench_config(backend)
    if scene is None:
        scene, camera = bench_scene_camera(n, width, height)
    else:
        # Trained scenes carry radius/count skew the random bench scene
        # lacks; they also need a larger legacy-capacity fallback.
        cfg_overrides.setdefault("intersect_capacity_factor",
                                 max(64.0, 8e6 / max(n, 1)))
    # EVERY bench (random or trained scene) derives its tier spec from the
    # scene's measured tile-count distribution via the PRODUCT's own
    # auto-config (render/api.py auto_render_config — the same path
    # `gsrast_tpu render/train` runs): no hand-picked knobs.
    auto = "tiers" not in cfg_overrides
    auto_w = auto and "tile_w" not in cfg_overrides
    rcfg = rcfg.replace(**cfg_overrides)
    if auto:
        from .render.api import auto_render_config

        rcfg = auto_render_config(
            scene, camera, backend, base=rcfg, auto_tile_w=auto_w)
    params, mask = split_params(scene)

    # mask enters as an ARGUMENT, not a closure constant: a closed-over
    # device array is lowered into the HLO as a constant.
    if fwd_only:
        def one(params, mask):
            s = merge_params(params, mask)
            return render(s.activated(), camera, rcfg).image
    else:
        def one(params, mask):
            def loss(p):
                s = merge_params(p, mask)
                img = render(s.activated(), camera, rcfg).image
                return jnp.mean(img * img)

            return jax.grad(loss)(params)

    if chain <= 1:
        step = jax.jit(one)
    else:
        @jax.jit
        def step(params, mask):
            def body(p, _):
                out = one(p, mask)
                # zero-magnitude but data-dependent carry update: keeps the
                # chain sequential like an optimizer without changing the
                # measured math (0.0 * grad / 0.0 * pixel-mean).
                if fwd_only:
                    eps = 0.0 * jnp.mean(out)
                    p2 = jax.tree.map(lambda a: a + eps, p)
                else:
                    p2 = jax.tree.map(lambda a, g: a + 0.0 * g, p, out)
                return p2, None

            return jax.lax.scan(body, params, None, length=chain)[0]

    best_ms = timeit(step, params, mask, iters=iters) / max(chain, 1)
    mpix_s = camera.width * camera.height / best_ms / 1e3
    return best_ms, mpix_s


def stage_table(n: int, width: int, height: int, backend: str,
                iters: int = 3, scene=None, camera=None,
                rcfg=None) -> dict:
    """Per-stage fwd+bwd decomposition at bench scale (random scene by
    default; pass scene/camera for a trained scene). Returns {stage: ms}; stages nest
    (pack includes its gather, pack_blend includes pack, full includes
    everything + untile/assembly)."""
    from .ops import binning as binning_ops
    from .ops.preprocess import preprocess
    from .render import pallas_pipeline as pp
    from .render.api import auto_render_config, render

    if scene is None:
        scene, camera = bench_scene_camera(n, width, height)
    if rcfg is None:
        rcfg = auto_render_config(
            scene, camera, backend, base=bench_config(backend))
    n = scene.means.shape[0]
    act = scene.activated()
    grid_h, grid_w = rcfg.grid_shape(camera.height, camera.width)
    capacity = rcfg.capacity(n)

    prep = jax.jit(lambda a: preprocess(a, camera, rcfg))(act)
    jax.block_until_ready(prep)

    out = {}
    afloats = {k: getattr(act, k)
               for k in ("means", "scales", "quats", "opacities", "sh")}

    def prep_loss(floats):
        p = preprocess(act.replace(**floats), camera, rcfg)
        return (jnp.sum(p.mean2d) + jnp.sum(p.conic) + jnp.sum(p.color)
                + jnp.sum(p.opacity))

    out["prep"] = timeit(jax.jit(jax.grad(prep_loss)), afloats, iters=iters)

    pfloats = {k: getattr(prep, k)
               for k in ("mean2d", "conic", "color", "opacity")}

    if rcfg.tiers:
        num_tiles = grid_h * grid_w
        plan_fn = jax.jit(lambda p: binning_ops.plan_tiers(
            p, grid_h, grid_w, rcfg))
        out["binning_fwd"] = timeit(plan_fn, prep, iters=iters)
        plan = plan_fn(prep)

        # `plan` enters the jitted stage fns as an ARGUMENT: closing over
        # device arrays bakes them into the HLO as constants.
        def pack_loss(pfl, pl):
            p2 = prep._replace(**pfl)
            fp, _ts = pp.fused_pack(
                pp.feature_rows(p2), pl.tile_key, pl.depth_key,
                pl.slot, pl.gauss, pl.order, rcfg.tiers, n, num_tiles)
            return jnp.sum(fp * fp)

        out["pack"] = timeit(jax.jit(jax.grad(pack_loss)), pfloats, plan,
                             iters=iters)

        if backend == "pallas":
            def blend_loss(pfl, pl):
                p2 = prep._replace(**pfl)
                feat, ts = pp.fused_pack(
                    pp.feature_rows(p2), pl.tile_key, pl.depth_key,
                    pl.slot, pl.gauss, pl.order, rcfg.tiers, n,
                    num_tiles)
                rgb, ft, nc = pp._blend(
                    feat, ts, jnp.array([0, 1], jnp.int32),
                    grid_h, grid_w, rcfg.tile_h, rcfg.tile_w,
                    rcfg.interpret, num_tiles)
                return jnp.sum(rgb) + jnp.sum(ft)

            out["pack_blend"] = timeit(jax.jit(jax.grad(blend_loss)),
                                       pfloats, plan, iters=iters)
    else:
        binning_fn = jax.jit(lambda p: binning_ops.build_binning(
            p, grid_h, grid_w, rcfg, capacity))
        out["binning_fwd"] = timeit(binning_fn, prep, iters=iters)
        binning = binning_fn(prep)
        jax.block_until_ready(binning)

        def pack_loss(pfl, b):
            p2 = prep._replace(**pfl)
            return jnp.sum(
                pp.pack_features(p2, b, rcfg))

        out["pack"] = timeit(jax.jit(jax.grad(pack_loss)), pfloats, binning,
                             iters=iters)

        if backend == "pallas":
            def blend_loss(pfl, b):
                p2 = prep._replace(**pfl)
                feat = pp.pack_features(p2, b, rcfg)
                rgb, ft, nc = pp._blend(
                    feat, b.tile_starts, jnp.array([0, 1], jnp.int32),
                    grid_h, grid_w, rcfg.tile_h, rcfg.tile_w,
                    rcfg.interpret, grid_h * grid_w)
                return jnp.sum(rgb) + jnp.sum(ft)

            out["pack_blend"] = timeit(jax.jit(jax.grad(blend_loss)),
                                       pfloats, binning, iters=iters)

    def loss(floats):
        a = act.replace(**floats)
        return jnp.sum(render(a, camera, rcfg).image)

    out["full"] = timeit(jax.jit(jax.grad(loss)), afloats, iters=iters)
    return out


def format_stage_table(stages: dict, width: int, height: int) -> str:
    lines = ["stage                 fwd+bwd ms"]
    for k, v in stages.items():
        lines.append(f"{k:<20} {v:>10.2f}")
    full = stages.get("full")
    if full:
        lines.append(f"=> {width * height / full / 1e3:.2f} Mpixels/s fwd+bwd")
    return "\n".join(lines)
