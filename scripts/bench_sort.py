"""Micro-benchmark of sort strategies for the binning stage on the current
backend."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, iters=10):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    c = 800_000
    t_tiles = 700
    rng = np.random.default_rng(0)
    tile = jnp.asarray(rng.integers(0, t_tiles + 1, c), jnp.int32)
    depth = jnp.asarray(rng.random(c), jnp.float32)
    depth_bits = depth.view(jnp.int32)
    gauss = jnp.arange(c, dtype=jnp.int32)
    packed = (tile << 21) | (depth_bits >> 11)

    f = jax.jit(lambda a, b, g: jax.lax.sort((a, b, g), dimension=0,
                                             num_keys=2, is_stable=True))
    print(f"2-key (tile,depth)+payload : {timeit(f, tile, depth_bits, gauss)*1e3:8.2f} ms")

    f1 = jax.jit(lambda k, g: jax.lax.sort((k, g), dimension=0,
                                           num_keys=1, is_stable=True))
    print(f"1-key packed u32 + payload : {timeit(f1, packed, gauss)*1e3:8.2f} ms")

    f1u = jax.jit(lambda k, g: jax.lax.sort((k, g), dimension=0,
                                            num_keys=1, is_stable=False))
    print(f"1-key packed unstable      : {timeit(f1u, packed, gauss)*1e3:8.2f} ms")

    ftile = jax.jit(lambda k, g: jax.lax.sort((k, g), dimension=0,
                                              num_keys=1, is_stable=True))
    print(f"1-key tile-only stable     : {timeit(ftile, tile, gauss)*1e3:8.2f} ms")

    fargsort = jax.jit(lambda k: jnp.argsort(k))
    print(f"argsort packed             : {timeit(fargsort, packed)*1e3:8.2f} ms")

    fsortonly = jax.jit(lambda k: jnp.sort(k))
    print(f"sort packed (no payload)   : {timeit(fsortonly, packed)*1e3:8.2f} ms")

    # N-sized gaussian depth argsort (the presort alternative)
    n = 100_000
    dn = jnp.asarray(rng.random(n), jnp.float32)
    fn_ = jax.jit(lambda k: jnp.argsort(k))
    print(f"argsort 100k depths        : {timeit(fn_, dn)*1e3:8.2f} ms")

    # float-key sort: keys as f32 (comparator on float)
    fkey = depth + tile.astype(jnp.float32) * 2.0
    ff = jax.jit(lambda k, g: jax.lax.sort((k, g), dimension=0,
                                           num_keys=1, is_stable=True))
    print(f"1-key f32 + payload        : {timeit(ff, fkey, gauss)*1e3:8.2f} ms")


if __name__ == "__main__":
    main()
