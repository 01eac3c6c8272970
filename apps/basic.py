"""Minimal end-to-end smoke app.

Analog of the reference's `basic` executable (/root/reference/main.cpp:5-16:
orange clear + magenta triangle) — the smallest program proving the stack
works: a tiny random scene rendered over an orange background to a PNG.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from gsrast_tpu import Camera, RenderConfig, random_scene
from gsrast_tpu.camera import look_at
from gsrast_tpu.render.api import default_backend, render
from gsrast_tpu.utils.image import save_png
import jax.numpy as jnp


def main(out: str = "basic.png") -> str:
    scene = random_scene(jax.random.PRNGKey(0), 256, sh_degree=0,
                         scale_range=(0.02, 0.08))
    camera = Camera(
        view=look_at(jnp.array([0.0, 0.0, -3.0]), jnp.zeros(3)),
        fov_x=jnp.float32(1.2), fov_y=jnp.float32(1.0),
        width=256, height=256,
    )
    cfg = RenderConfig(
        backend=default_backend(),
        background=(1.0, 0.5, 0.0),  # the orange clear color
    )
    img = render(scene.activated(), camera, cfg).image
    path = save_png(img, out)
    print(f"basic: wrote {path}")
    return path


if __name__ == "__main__":
    main(*sys.argv[1:])
