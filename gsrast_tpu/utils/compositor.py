"""Nested render-target composition.

The analog of the reference's Framebuffer system
(/root/reference/Framebuffer.cpp:22-107 and the global viewport/FBO stacks,
Config.hpp:33-44): where the reference renders children into an offscreen GL
texture (pushing/popping viewport state so targets nest) and then draws that
texture as a quad into the outer target, here a RenderTarget is a pure
function producing an (H, W, C) array, and nesting is function composition —
`blit` places a child target's output into a parent image at a viewport
rectangle (scaling like the sampler quad draw, Framebuffer.cpp:104-107).

HDR parity: the reference's `hdr` flag picks float vs u8 texels
(Framebuffer.cpp:28-35); arrays here are float32 throughout and `to_uint8`
(utils/image.py) is the display conversion.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import jax
import jax.numpy as jnp


def solid(height: int, width: int, color=(0.0, 0.0, 0.0)) -> jax.Array:
    """A cleared render target (glClearColor + Clear, Window.cpp:143-147)."""
    return jnp.broadcast_to(
        jnp.asarray(color, jnp.float32), (height, width, 3)
    )


def resize_nearest(img: jax.Array, height: int, width: int) -> jax.Array:
    """Nearest-neighbor resample (the sampler-quad stretch of a framebuffer
    texture onto a differently-sized viewport)."""
    h, w = img.shape[0], img.shape[1]
    ys = (jnp.arange(height) * h // height).astype(jnp.int32)
    xs = (jnp.arange(width) * w // width).astype(jnp.int32)
    return img[ys][:, xs]


def blit(
    parent: jax.Array,
    child: jax.Array,
    y: int = 0,
    x: int = 0,
    scale_to: Tuple[int, int] | None = None,
) -> jax.Array:
    """Draw `child` into `parent` at viewport (y, x) — the Framebuffer quad
    draw into the outer target (Framebuffer.cpp:93-107). Out-of-bounds parts
    are clipped, like GL viewport clipping."""
    if scale_to is not None:
        child = resize_nearest(child, *scale_to)
    ph, pw = parent.shape[0], parent.shape[1]
    ch, cw = child.shape[0], child.shape[1]
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + ch, ph), min(x + cw, pw)
    if y1 <= y0 or x1 <= x0:
        return parent
    return parent.at[y0:y1, x0:x1].set(child[y0 - y : y1 - y, x0 - x : x1 - x])


def overlay(
    parent: jax.Array, child_rgba: jax.Array, y: int = 0, x: int = 0
) -> jax.Array:
    """Alpha-composite an RGBA child over the parent (the ImGui-overlay slot
    in the draw order, GSRastWindow.cpp:44-47)."""
    ph, pw = parent.shape[0], parent.shape[1]
    ch, cw = child_rgba.shape[0], child_rgba.shape[1]
    y1, x1 = min(y + ch, ph), min(x + cw, pw)
    region = parent[y:y1, x:x1]
    child = child_rgba[: y1 - y, : x1 - x]
    a = child[..., 3:4]
    return parent.at[y:y1, x:x1].set(child[..., :3] * a + region * (1.0 - a))


class RenderStack:
    """Explicit viewport/target stack mirroring the reference's GlobalStacks
    (Config.hpp:38-44): push a target, draw into it, pop composites it into
    the target below. Purely host-side orchestration over arrays."""

    def __init__(self, height: int, width: int, clear=(0.0, 0.0, 0.0)):
        self._stack = [solid(height, width, clear)]
        self._viewports = [(0, 0)]

    def push(self, height: int, width: int, y: int = 0, x: int = 0,
             clear=(0.0, 0.0, 0.0)) -> None:
        self._stack.append(solid(height, width, clear))
        self._viewports.append((y, x))

    def draw(self, fn_or_array) -> None:
        """Draw into the current target: either an array to blit at (0,0) or
        a callable image -> image."""
        top = self._stack[-1]
        if callable(fn_or_array):
            self._stack[-1] = fn_or_array(top)
        else:
            self._stack[-1] = blit(top, jnp.asarray(fn_or_array))

    def pop(self) -> jax.Array:
        """Composite the top target into the one below at its viewport
        (Framebuffer.cpp:84-92 rebinding the outer target)."""
        child = self._stack.pop()
        y, x = self._viewports.pop()
        if not self._stack:
            return child
        self._stack[-1] = blit(self._stack[-1], child, y, x)
        return child

    @property
    def image(self) -> jax.Array:
        return self._stack[0]
