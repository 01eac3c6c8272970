"""Cameras.

The replacement for the reference camera stack
(/root/reference/CameraBase.hpp:8-21, FirstPersonCamera.cpp:28-114): instead of
a stateful first-person GLFW-driven object, a `Camera` is an immutable pytree
carrying the world->camera view matrix plus intrinsics; helper constructors
reproduce the reference behaviors (lookAt from yaw/pitch, perspective from
fov/aspect, auto-framing from a scene bbox — GSRastWindow.cpp:30-37) as pure
functions.

Conventions (matching the Gaussian-splatting rasterizer the reference feeds —
GSGaussians.cpp:160-169 flips the GL view matrix's Z row to get these):
  * view @ [p, 1] gives camera-space coordinates with +z pointing INTO the
    screen, so visible points have depth = p_cam.z > 0.
  * proj maps camera space to clip space; NDC in [-1, 1]; pixel x to the right,
    pixel y DOWN (image row 0 at the top).
  * focal_y = height / (2 tan(fov_y / 2)) (reference GSCuda.cu:721).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import config as cfg
from .utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class Camera:
    """An immutable camera: world->camera transform + pinhole intrinsics.

    `width`/`height` are static (pytree aux data) so image shapes stay static
    under jit.
    """

    view: jax.Array  # (4, 4) world -> camera (z forward, y down)
    fov_x: jax.Array  # scalar, radians
    fov_y: jax.Array  # scalar, radians
    znear: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(cfg.DEFAULT_NEAR))
    zfar: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(cfg.DEFAULT_FAR))
    width: int = static_field(default=cfg.DEFAULT_WIDTH)
    height: int = static_field(default=cfg.DEFAULT_HEIGHT)

    # ---- derived quantities -------------------------------------------------

    @property
    def tan_fov_x(self) -> jax.Array:
        return jnp.tan(self.fov_x * 0.5)

    @property
    def tan_fov_y(self) -> jax.Array:
        return jnp.tan(self.fov_y * 0.5)

    @property
    def focal_x(self) -> jax.Array:
        # reference GSCuda.cu:720-721 (focal from image size and tan fov)
        return self.width / (2.0 * self.tan_fov_x)

    @property
    def focal_y(self) -> jax.Array:
        return self.height / (2.0 * self.tan_fov_y)

    @property
    def position(self) -> jax.Array:
        """Camera center in world space (inverse of the view transform)."""
        rot = self.view[:3, :3]
        t = self.view[:3, 3]
        return -jnp.matmul(rot.T, t, precision=jax.lax.Precision.HIGHEST)

    @property
    def front(self) -> jax.Array:
        """World-space forward (+z camera row)."""
        return self.view[2, :3]

    def projection(self) -> jax.Array:
        """Perspective projection matrix (camera -> clip).

        Matches the Gaussian-splatting convention: z_clip/w in [0, 1] over
        [znear, zfar], y NOT flipped (pixel y grows downward already in camera
        space).
        """
        return perspective(self.fov_x, self.fov_y, self.znear, self.zfar)

    def full_projection(self) -> jax.Array:
        """world -> clip: proj @ view."""
        return jnp.matmul(
            self.projection(), self.view, precision=jax.lax.Precision.HIGHEST
        )

    def replace_pose(self, view: jax.Array) -> "Camera":
        return self.replace(view=view)


def perspective(fov_x, fov_y, znear, zfar) -> jax.Array:
    """GS-style perspective matrix: z mapped to [0,1], +z forward."""
    tx = jnp.tan(fov_x * 0.5)
    ty = jnp.tan(fov_y * 0.5)
    z_sign = 1.0
    p = jnp.zeros((4, 4), dtype=jnp.float32)
    p = p.at[0, 0].set(1.0 / tx)
    p = p.at[1, 1].set(1.0 / ty)
    p = p.at[2, 2].set(z_sign * zfar / (zfar - znear))
    p = p.at[2, 3].set(-(zfar * znear) / (zfar - znear))
    p = p.at[3, 2].set(z_sign)
    return p


def look_at(eye, target, up=(0.0, -1.0, 0.0)) -> jax.Array:
    """Build a world->camera view matrix looking from `eye` to `target`.

    Default `up` is -Y: trained GS scenes are Y-down, which the reference
    handles with FirstPersonCamera::invertUp (FirstPersonCamera.cpp:30,47;
    enabled at GSRastWindow.cpp:20).
    """
    eye = jnp.asarray(eye, jnp.float32)
    target = jnp.asarray(target, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    fwd = target - eye
    fwd = fwd / (jnp.linalg.norm(fwd) + 1e-12)
    right = jnp.cross(fwd, up)
    right = right / (jnp.linalg.norm(right) + 1e-12)
    down = jnp.cross(fwd, right)  # camera +y (image down)
    rot = jnp.stack([right, down, fwd])  # rows: camera axes in world space
    trans = -jnp.matmul(rot, eye, precision=jax.lax.Precision.HIGHEST)
    view = jnp.eye(4, dtype=jnp.float32)
    view = view.at[:3, :3].set(rot)
    view = view.at[:3, 3].set(trans)
    return view


def from_yaw_pitch(eye, yaw, pitch, up=(0.0, -1.0, 0.0)) -> jax.Array:
    """First-person pose from yaw/pitch (reference FirstPersonCamera.cpp:40-60).

    yaw=0 looks down +x; pitch clamped to +-(pi/2 - eps) as the reference
    clamps in applyDelta (FirstPersonCamera.cpp:45-50).
    """
    lim = cfg.PI / 2.0 - 0.05
    pitch = jnp.clip(pitch, -lim, lim)
    front = jnp.stack(
        [jnp.cos(yaw) * jnp.cos(pitch), jnp.sin(pitch), jnp.sin(yaw) * jnp.cos(pitch)]
    )
    eye = jnp.asarray(eye, jnp.float32)
    return look_at(eye, eye + front, up)


class FirstPersonState(NamedTuple):
    """The reference FirstPersonCamera's motion/speed state machine
    (/root/reference/FirstPersonCamera.cpp:28-100, Window.cpp:110-128) as a
    pure pytree: WASD motion scaled by speed*dt, mouse-look yaw/pitch deltas
    with the pitch clamp, speed doubling/halving (GSRastWindow.cpp:66-73 Up/
    Down keys), and the invert-up flip used because trained GS scenes are
    Y-down (GSRastWindow.cpp:20)."""

    eye: jax.Array            # (3,) world position
    yaw: jax.Array            # scalar
    pitch: jax.Array          # scalar
    speed: jax.Array          # units/second
    invert_up: bool = True    # trained GS scenes are Y-down


def fp_init(eye, yaw=0.0, pitch=0.0, speed=1.0,
            invert_up: bool = True) -> FirstPersonState:
    return FirstPersonState(
        eye=jnp.asarray(eye, jnp.float32),
        yaw=jnp.float32(yaw),
        pitch=jnp.float32(pitch),
        speed=jnp.float32(speed),
        invert_up=invert_up,
    )


def _fp_basis(state: FirstPersonState):
    front = jnp.stack([
        jnp.cos(state.yaw) * jnp.cos(state.pitch),
        jnp.sin(state.pitch),
        jnp.sin(state.yaw) * jnp.cos(state.pitch),
    ])
    up = jnp.asarray(
        (0.0, -1.0, 0.0) if state.invert_up else (0.0, 1.0, 0.0), jnp.float32
    )
    right = jnp.cross(front, up)
    right = right / (jnp.linalg.norm(right) + 1e-12)
    return front, right, up


def fp_move(state: FirstPersonState, forward: float = 0.0,
            strafe: float = 0.0, dt: float = 1.0 / 60.0) -> FirstPersonState:
    """WASD step: forward/strafe in {-1, 0, 1} (reference Window.cpp:110-128
    applies motion = speed * dt along front/right each polled frame)."""
    front, right, _ = _fp_basis(state)
    delta = (front * forward + right * strafe) * state.speed * dt
    return state._replace(eye=state.eye + delta)


def fp_look(state: FirstPersonState, dyaw: float, dpitch: float,
            sensitivity: float = 0.005) -> FirstPersonState:
    """Mouse-look: yaw/pitch deltas with the +-(pi/2 - eps) pitch clamp
    (reference FirstPersonCamera.cpp:45-50 applyDelta)."""
    lim = cfg.PI / 2.0 - 0.05
    return state._replace(
        yaw=state.yaw + jnp.float32(dyaw) * sensitivity,
        pitch=jnp.clip(
            state.pitch + jnp.float32(dpitch) * sensitivity, -lim, lim
        ),
    )


def fp_speed(state: FirstPersonState, factor: float) -> FirstPersonState:
    """Speed x2 / /2 (reference GSRastWindow.cpp:66-73 Up/Down keys)."""
    return state._replace(speed=state.speed * jnp.float32(factor))


def fp_camera(state: FirstPersonState, width: int, height: int,
              fov_deg: float = cfg.DEFAULT_FOV_DEG) -> Camera:
    """Rebuild the Camera from the controller state — the reference's
    per-frame update() (FirstPersonCamera.cpp:28-38)."""
    up = (0.0, -1.0, 0.0) if state.invert_up else (0.0, 1.0, 0.0)
    view = from_yaw_pitch(state.eye, state.yaw, state.pitch, up)
    fov = jnp.float32(fov_deg * cfg.PI / 180.0)
    aspect = width / height
    return Camera(
        view=view, fov_x=fov * aspect, fov_y=fov, width=width, height=height
    )


def auto_frame(bbox_min, bbox_max, width: int, height: int,
               fov_deg: float = cfg.DEFAULT_FOV_DEG) -> Camera:
    """Frame a scene bbox the way the reference auto-frames on load
    (GSRastWindow.cpp:30-37): place the camera back from the center by the
    bbox span and look at the center.
    """
    bbox_min = np.asarray(bbox_min, np.float32)
    bbox_max = np.asarray(bbox_max, np.float32)
    center = 0.5 * (bbox_min + bbox_max)
    span = float(np.linalg.norm(bbox_max - bbox_min))
    eye = center + np.array([0.0, 0.0, -max(span, 1e-3)], np.float32)
    fov_y = jnp.float32(np.deg2rad(fov_deg))
    aspect = width / height
    fov_x = jnp.float32(2.0 * np.arctan(np.tan(np.deg2rad(fov_deg) / 2.0) * aspect))
    return Camera(
        view=look_at(eye, center),
        fov_x=fov_x,
        fov_y=fov_y,
        zfar=jnp.float32(max(cfg.DEFAULT_FAR, 4.0 * span)),
        width=width,
        height=height,
    )


def camera_rays(camera: Camera) -> Tuple[jax.Array, jax.Array]:
    """Per-pixel world-space ray origins and directions (for the ellipsoid
    ray-trace debug mode — the analog of splats/fragment.glsl:30-83)."""
    h, w = camera.height, camera.width
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w * 2.0 - 1.0
    ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h * 2.0 - 1.0
    px, py = jnp.meshgrid(xs, ys)  # (h, w)
    dir_cam = jnp.stack(
        [px * camera.tan_fov_x, py * camera.tan_fov_y, jnp.ones_like(px)], axis=-1
    )
    rot = camera.view[:3, :3]
    # R^T applied to each dir
    dir_world = jnp.matmul(dir_cam, rot, precision=jax.lax.Precision.HIGHEST)
    dir_world = dir_world / jnp.linalg.norm(dir_world, axis=-1, keepdims=True)
    origin = jnp.broadcast_to(camera.position, (h, w, 3))
    return origin, dir_world


def debug_camera(width: int = 979, height: int = 546) -> Camera:
    """A frozen, deterministic pose for numerical A/B comparisons — the role
    of the reference's DebugCamera (hardcoded SIBR-captured matrices,
    /root/reference/apps/gsrast/DebugCamera.cpp:6-17). Our values are our own
    fixed pose, not the reference's: what matters is that every run sees the
    identical camera."""
    eye = jnp.array([1.25, -0.75, -2.0], jnp.float32)
    target = jnp.array([0.0, 0.0, 0.0], jnp.float32)
    return Camera(
        view=look_at(eye, target),
        fov_x=jnp.float32(1.222),
        fov_y=jnp.float32(0.733),
        width=width,
        height=height,
    )


# ---- pose (de)serialization — replaces the LMDB cam_pose store ------------

def pose_to_dict(camera: Camera) -> dict:
    return {
        "view": np.asarray(camera.view).tolist(),
        "fov_x": float(camera.fov_x),
        "fov_y": float(camera.fov_y),
        "znear": float(camera.znear),
        "zfar": float(camera.zfar),
        "width": camera.width,
        "height": camera.height,
    }


def pose_from_dict(d: dict) -> Camera:
    return Camera(
        view=jnp.asarray(d["view"], jnp.float32),
        fov_x=jnp.float32(d["fov_x"]),
        fov_y=jnp.float32(d["fov_y"]),
        znear=jnp.float32(d.get("znear", cfg.DEFAULT_NEAR)),
        zfar=jnp.float32(d.get("zfar", cfg.DEFAULT_FAR)),
        width=int(d["width"]),
        height=int(d["height"]),
    )
