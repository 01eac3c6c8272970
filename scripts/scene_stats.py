"""Print intersection statistics of the bench scene at a given tile shape.

Grounds capacity/tile-shape tuning and the BASELINE.md roofline: true total
intersections, per-gaussian tile counts, per-tile segment load distribution.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--tile-h", type=int, default=16)
    ap.add_argument("--tile-w", type=int, default=16)
    args = ap.parse_args()

    from gsrast_tpu import benchmark
    from gsrast_tpu.ops import binning as binning_ops
    from gsrast_tpu.ops.preprocess import preprocess
    from gsrast_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    rcfg = benchmark.bench_config("xla").replace(
        tile_h=args.tile_h, tile_w=args.tile_w)
    scene, camera = benchmark.bench_scene_camera(
        args.n, args.width, args.height)
    grid_h, grid_w = rcfg.grid_shape(camera.height, camera.width)
    capacity = rcfg.capacity(args.n)

    @jax.jit
    def stats(act):
        prep = preprocess(act, camera, rcfg)
        b = binning_ops.build_binning(prep, grid_h, grid_w, rcfg, capacity)
        seg = b.tile_starts[1:] - b.tile_starts[:-1]
        counts = prep.tiles_touched  # true (uncapped) per-gaussian tiles
        return {
            "visible": jnp.sum(prep.radius > 0),
            "total_isect": jnp.sum(counts),
            "max_tiles_per_gaussian": jnp.max(counts),
            "mean_tiles_per_visible": jnp.sum(counts)
            / jnp.maximum(jnp.sum(counts > 0), 1),
            "overflow_capacity": b.overflow_capacity,
            "overflow_tile_cap": b.overflow_tile_cap,
            "max_segment": jnp.max(seg),
            "mean_segment": jnp.mean(seg.astype(jnp.float32)),
            "nonempty_tiles": jnp.sum(seg > 0),
        }

    out = stats(scene.activated())
    gh, gw = grid_h, grid_w
    print(f"tile {args.tile_h}x{args.tile_w} grid {gh}x{gw} "
          f"({gh*gw} tiles) capacity {capacity}")
    for k, v in out.items():
        print(f"  {k:28s} {float(v):.2f}")


if __name__ == "__main__":
    main()
