"""Multi-HOST smoke: 2 real processes, jax.distributed, one global mesh.

Exercises the actual multi-host path: the CLI's
--dist parsing -> parallel.mesh.initialize_distributed ->
jax.distributed.initialize on a localhost coordinator, a mesh spanning BOTH
processes' devices, one psum across it, and one tiny tile-sharded render.
The north star's "N>=2 hosts" clause is unmeasurable for throughput here
(both processes share this host's cores), but the BOOTSTRAP + cross-process
collective correctness is exactly what this proves.

Run one process per rank (tests/test_multihost.py launches both):
  python scripts/multihost_smoke.py --coord localhost:PORT --nprocs 2 --rank R
Prints MULTIHOST_OK <loss> on success; both ranks must print the same loss.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coord", required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    args = ap.parse_args()

    # Go through the CLI's own --dist plumbing (cli._maybe_distributed).
    from gsrast_tpu import cli as gs_cli

    ns = argparse.Namespace(dist=f"{args.coord},{args.nprocs},{args.rank}")
    gs_cli._maybe_distributed(ns)

    assert jax.process_count() == args.nprocs, jax.process_count()
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == args.nprocs * n_local, (n_global, n_local)

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from gsrast_tpu import Camera, RenderConfig, random_scene
    from gsrast_tpu.camera import look_at
    from gsrast_tpu.parallel.mesh import TILE_AXIS, make_mesh
    from gsrast_tpu.parallel.sharded import render_tile_sharded

    mesh = make_mesh((1, n_global), jax.devices())

    # 1. one psum across BOTH processes' devices
    def f(x):
        return jax.lax.psum(x, TILE_AXIS)

    y = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(TILE_AXIS),), out_specs=P(TILE_AXIS)
    ))(jnp.ones((n_global,), jnp.float32))
    total = float(jax.device_get(y.addressable_shards[0].data)[0])
    assert total == float(n_global), total

    # 2. one tiny tile-sharded render (fused multi-tier path) spanning hosts
    scene = random_scene(jax.random.PRNGKey(0), 256, sh_degree=0,
                         scale_range=(0.03, 0.1))
    camera = Camera(
        view=look_at(jnp.array([0.0, 0.0, -3.0]), jnp.zeros(3)),
        fov_x=jnp.float32(1.2), fov_y=jnp.float32(1.0), width=256, height=64,
    )
    cfg = RenderConfig(backend="xla", max_per_tile=512, tile_chunk=2,
                       tiers=((2, 1.0), (8, 0.5), (32, 0.25)))

    @jax.jit
    def loss(act):
        out = render_tile_sharded(act, camera, cfg, mesh)
        return jnp.sum(out.image)

    val = loss(scene.activated())
    # Replicated scalar: every process can read it; both ranks print it and
    # the launcher asserts they match.
    print(f"MULTIHOST_OK {float(jax.device_get(val)):.6f}", flush=True)


if __name__ == "__main__":
    main()
