"""Nested render-target smoke app.

Analog of the reference's `fbtest` (/root/reference/apps/fbtest/
FBTestWindow.cpp:14-36: a triangle rendered into a 200x100 HDR offscreen
framebuffer, then composited to the screen): here a small scene is rendered
into a 200x100 inner target, which is blitted (scaled) into a larger outer
target through the RenderStack — exercising the nested-composition machinery
(gsrast_tpu/utils/compositor.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from gsrast_tpu import Camera, RenderConfig, random_scene
from gsrast_tpu.camera import look_at
from gsrast_tpu.render.api import default_backend, render
from gsrast_tpu.utils.compositor import RenderStack, blit
from gsrast_tpu.utils.image import save_png


def main(out: str = "fbtest.png") -> str:
    scene = random_scene(jax.random.PRNGKey(2), 128, sh_degree=0,
                         scale_range=(0.03, 0.1))
    inner_cam = Camera(
        view=look_at(jnp.array([0.0, 0.0, -3.0]), jnp.zeros(3)),
        fov_x=jnp.float32(1.4), fov_y=jnp.float32(0.8),
        width=200, height=100,
    )
    cfg = RenderConfig(backend=default_backend())
    inner = render(scene.activated(), inner_cam, cfg).image  # the 200x100 FBO

    stack = RenderStack(480, 640, clear=(0.1, 0.1, 0.15))
    stack.push(100, 200, y=40, x=40)       # bind the offscreen target
    stack.draw(inner)                      # draw the scene into it
    stack.pop()                            # composite into the outer target
    # and once more, scaled, like the sampler-quad stretch:
    stack.draw(lambda img: blit(img, inner, y=200, x=40, scale_to=(200, 400)))

    path = save_png(stack.image, out)
    print(f"fbtest: wrote {path}")
    return path


if __name__ == "__main__":
    main(*sys.argv[1:])
