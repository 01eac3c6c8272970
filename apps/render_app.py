"""The main viewer app, offline.

Analog of the reference's `gsrast` app (GSRastWindow +
Inspector, /root/reference/apps/gsrast/): loads a scene, auto-frames the
camera from its bbox (GSRastWindow.cpp:30-37), renders an orbit of frames in
any of the three modes (the frame loop, main.cpp:7-13), records FrameStats
(the FPS plot), writes screenshots, and prints the inspector report.

Usage: python apps/render_app.py scene.ply [--mode gaussians] [--frames 8]
       [--outdir frames] [--width W --height H]
If scene.ply does not exist, a random scene is used (so the app always runs).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from gsrast_tpu import Camera, RenderConfig, load_ply, random_scene
from gsrast_tpu.camera import auto_frame, look_at
from gsrast_tpu.render.api import default_backend, render
from gsrast_tpu.utils.image import save_png
from gsrast_tpu.utils.inspector import FrameStats, camera_report, scene_report
from gsrast_tpu.utils.posedb import PoseDB
from gsrast_tpu.viz.ellipsoids import render_ellipsoids
from gsrast_tpu.viz.pointcloud import render_pointcloud


def orbit_view(center, radius, angle, height=0.3):
    eye = center + np.array(
        [radius * np.sin(angle), -height * radius, -radius * np.cos(angle)],
        np.float32,
    )
    return look_at(jnp.asarray(eye), jnp.asarray(center))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default="data.ply")
    ap.add_argument("--mode", default="gaussians",
                    choices=["gaussians", "ellipsoids", "pointcloud"])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--outdir", default="frames")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=768)
    ap.add_argument("--save-pose", default=None)
    ap.add_argument("--flythrough", action="store_true",
                    help="drive the first-person controller (WASD/mouse "
                         "state machine) instead of the orbit rig")
    args = ap.parse_args()

    if os.path.exists(args.scene):
        scene = load_ply(args.scene)
    else:
        print(f"{args.scene} not found; using a 50k random scene")
        scene = random_scene(jax.random.PRNGKey(0), 50_000,
                             scale_range=(0.005, 0.03))
    mn, mx = scene.bbox()
    base = auto_frame(np.asarray(mn), np.asarray(mx), args.width, args.height)
    center = 0.5 * (np.asarray(mn) + np.asarray(mx))
    radius = float(np.linalg.norm(np.asarray(mx) - np.asarray(mn)))

    print("scene:", scene_report(scene))
    print("camera:", camera_report(base))
    if args.save_pose:
        PoseDB().save(args.save_pose, base)

    if args.mode == "gaussians":
        # Product auto-config: fused multi-tier pipeline, tiers derived from
        # the scene's own count distribution (same path as the CLI).
        from gsrast_tpu.render.api import auto_render_config

        cfg = auto_render_config(scene, base)
    else:
        cfg = RenderConfig(backend=default_backend())
    act = scene.activated()

    def draw(cam):
        if args.mode == "gaussians":
            return render(act, cam, cfg).image
        if args.mode == "ellipsoids":
            return render_ellipsoids(act, cam)
        return render_pointcloud(act, cam)

    jitted = jax.jit(lambda view: draw(base.replace(view=view)))
    stats = FrameStats()
    os.makedirs(args.outdir, exist_ok=True)

    if args.flythrough:
        # Scripted WASD+mouse session through the first-person state machine
        # (the reference's interactive Window.cpp:110-128 loop, replayed
        # deterministically): walk forward, strafe, look around, change
        # speed.
        from gsrast_tpu.camera import fp_camera, fp_init, fp_look, fp_move, \
            fp_speed

        st = fp_init(center + np.array([0, 0, -max(radius, 1e-3)]),
                     yaw=np.pi / 2, speed=radius)
        script = (
            [("move", 1.0, 0.0)] * (args.frames // 2)
            + [("speed", 2.0)]
            + [("look", 40.0, -10.0), ("move", 0.0, 1.0)]
        )
        views = []
        for op in script:
            if op[0] == "move":
                st = fp_move(st, forward=op[1], strafe=op[2], dt=1 / 30)
            elif op[0] == "look":
                st = fp_look(st, op[1], op[2])
            else:
                st = fp_speed(st, op[1])
            views.append(fp_camera(st, args.width, args.height).view)
        views = views[: args.frames]
    else:
        views = [
            orbit_view(center, max(radius, 1e-3),
                       2.0 * np.pi * i / max(args.frames, 1))
            for i in range(args.frames)
        ]

    for i, view in enumerate(views):
        t0 = time.perf_counter()
        img = jax.block_until_ready(jitted(view))
        stats.record(time.perf_counter() - t0,
                     pixels=args.width * args.height)
        save_png(img, os.path.join(args.outdir, f"frame_{i:03d}.png"))
    print("frames:", stats.report())


if __name__ == "__main__":
    main()
