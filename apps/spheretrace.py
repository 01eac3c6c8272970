"""Ellipsoid-projection math sandbox.

Analog of the reference's `spheretrace` app (/root/reference/apps/spheretrace/:
one movable/rotatable/scalable ellipsoid ray-traced in a fragment shader, with
the 'P' key printing projected-axes diagnostics to stdout,
SphereTraceWindow.cpp:104-147). Here the single parameterized ellipsoid is
rendered by the analytic ray-tracer (gsrast_tpu/viz/ellipsoids.py) and the
diagnostics — camera-space position, 3D covariance, EWA-projected 2D
covariance, its eigenvalues and projected screen axes — print every run,
serving the same role: hand-checking the projection math the rasterizer
depends on.

Usage: python apps/spheretrace.py [--pos x y z] [--scale sx sy sz]
                                  [--rot-axis x y z --rot-deg d] [--out png]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from gsrast_tpu import Camera
from gsrast_tpu.camera import look_at
from gsrast_tpu.ops.covariance import (compute_cov2d, compute_cov3d,
                                       quat_to_rotmat)
from gsrast_tpu.ops.projection import to_camera
from gsrast_tpu.scene.gaussians import from_arrays
from gsrast_tpu.utils.image import save_png
from gsrast_tpu.viz.ellipsoids import render_ellipsoids


def axis_angle_quat(axis, deg):
    axis = np.asarray(axis, np.float32)
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    half = np.deg2rad(deg) / 2.0
    return np.concatenate([[np.cos(half)], np.sin(half) * axis]).astype(np.float32)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pos", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    ap.add_argument("--scale", type=float, nargs=3, default=[0.6, 0.3, 0.15])
    ap.add_argument("--rot-axis", type=float, nargs=3, default=[0.0, 1.0, 0.0])
    ap.add_argument("--rot-deg", type=float, default=30.0)
    ap.add_argument("--out", default="spheretrace.png")
    args = ap.parse_args()

    quat = axis_angle_quat(args.rot_axis, args.rot_deg)
    scene = from_arrays(
        means=np.asarray([args.pos], np.float32),
        log_scales=np.log(np.asarray([args.scale], np.float32)),
        quats=quat[None],
        opacity_logits=np.asarray([3.0], np.float32),  # sigmoid(3) ~ 0.95
        sh=np.asarray([1.0, 0.2, 0.2], np.float32).reshape(1, 1, 3),
    )
    camera = Camera(
        view=look_at(jnp.array([0.0, 0.0, -3.0]), jnp.asarray(args.pos)),
        fov_x=jnp.float32(1.2), fov_y=jnp.float32(1.0),
        width=512, height=512,
    )
    act = scene.activated()

    img = render_ellipsoids(act, camera, background=(0.05, 0.05, 0.08))
    path = save_png(img, args.out)

    # ---- the 'P'-key diagnostics (SphereTraceWindow.cpp:104-147) ----------
    mean_cam_all = to_camera(act.means, camera.view)
    mean_cam = mean_cam_all[0]
    cov6 = compute_cov3d(act.scales, act.quats)
    cov3d = cov6[0]  # symmetric upper 6
    cov2d = compute_cov2d(
        mean_cam_all, cov6, camera.view[:3, :3],
        camera.focal_x, camera.focal_y, camera.tan_fov_x, camera.tan_fov_y,
    )[0]
    a, b, c = float(cov2d[0]), float(cov2d[1]), float(cov2d[2])
    mid = 0.5 * (a + c)
    det = a * c - b * b
    disc = max(mid * mid - det, 0.0) ** 0.5
    lam1, lam2 = mid + disc, mid - disc
    theta = 0.5 * np.arctan2(2 * b, a - c)
    rot = quat_to_rotmat(act.quats)[0]

    print(f"spheretrace: wrote {path}")
    print(f"  world pos        : {np.asarray(act.means[0])}")
    print(f"  camera-space pos : {np.asarray(mean_cam)} (depth={float(mean_cam[2]):.4f})")
    print(f"  rot matrix       :\n{np.asarray(rot)}")
    print(f"  cov3d (upper6)   : {np.asarray(cov3d)}")
    print(f"  cov2d [a b c]    : [{a:.5f} {b:.5f} {c:.5f}] det={det:.6f}")
    print(f"  eigenvalues      : {lam1:.5f}, {lam2:.5f}")
    print(f"  projected axes   : major={3*lam1**0.5:.2f}px minor={3*lam2**0.5:.2f}px "
          f"angle={np.rad2deg(theta):.2f}deg  (3-sigma extents)")


if __name__ == "__main__":
    main()
