"""Command-line entry points.

The reference app is `main()` running a window loop over a hardcoded
"data.ply" (/root/reference/apps/gsrast/main.cpp:4-15, GSRastWindow.cpp:24);
SURVEY.md §5 calls for real CLI entry points instead: `render`, `info`,
`train`, `bench`. Run as `python -m gsrast_tpu <cmd> ...`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--backend", default=None,
                    choices=["pallas", "xla", "dense"])
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--pose", default=None,
                    help="named pose from the pose store (default: auto-frame)")
    ap.add_argument("--store", default="gsrast_store.json",
                    help="pose-store path (the LMDB analog)")
    ap.add_argument("--dist", default=None, metavar="COORD:PORT,NPROCS,RANK",
                    help="multi-host bootstrap (jax.distributed): "
                         "coordinator address, process count, process id")


def _maybe_distributed(args) -> None:
    """Multi-host pod bootstrap — must run before the first jax backend use
    (parallel/mesh.py initialize_distributed)."""
    if not getattr(args, "dist", None):
        return
    from .parallel.mesh import initialize_distributed

    coord, nprocs, rank = args.dist.rsplit(",", 2)
    initialize_distributed(coord, int(nprocs), int(rank))


def _load(scene_path: str):
    from .scene.ply import load_ply

    return load_ply(scene_path)


def _camera(args, scene):
    import jax.numpy as jnp

    from . import config as cfg
    from .camera import auto_frame
    from .utils.posedb import PoseDB

    width = args.width or cfg.DEFAULT_WIDTH
    height = args.height or cfg.DEFAULT_HEIGHT
    if args.pose:
        cam = PoseDB(path=args.store).load(args.pose)
        if cam is None:
            sys.exit(f"pose {args.pose!r} not found in {args.store}")
        return cam.replace(width=width, height=height)
    mn, mx = scene.bbox()
    return auto_frame(mn, mx, width, height)


def _backend(args) -> str:
    from .render.api import default_backend

    return args.backend or default_backend()


def _auto_cfg(args, scene, camera, margin: float = 1.12):
    """The product-default RenderConfig: fused multi-tier binning derived
    from the scene's own tile-count distribution (render/api.py)."""
    from .render.api import auto_render_config

    backend = _backend(args)
    if backend == "dense":
        from . import config as cfg

        return cfg.RenderConfig(
            backend=backend,
            sh_degree=min(args.sh_degree, scene.sh_degree))
    rcfg = auto_render_config(scene, camera, backend, margin=margin)
    return rcfg.replace(sh_degree=min(args.sh_degree, scene.sh_degree))


def cmd_render(argv) -> None:
    ap = argparse.ArgumentParser(prog="gsrast_tpu render")
    ap.add_argument("scene")
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--mode", default="gaussians",
                    choices=["gaussians", "ellipsoids", "pointcloud"])
    _add_common(ap)
    args = ap.parse_args(argv)
    _maybe_distributed(args)

    import jax

    from .render.api import render
    from .utils.image import save_png
    from .viz.ellipsoids import render_ellipsoids
    from .viz.pointcloud import render_pointcloud

    scene = _load(args.scene)
    camera = _camera(args, scene)
    act = scene.activated()
    t0 = time.perf_counter()
    if args.mode == "gaussians":
        # Product default = the flagship fused multi-tier path with
        # auto-derived binning — no hand-set K knobs.
        rcfg = _auto_cfg(args, scene, camera)
        img = render(act, camera, rcfg).image
    elif args.mode == "ellipsoids":
        img = render_ellipsoids(act, camera)
    else:
        img = render_pointcloud(act, camera)
    jax.block_until_ready(img)
    dt = time.perf_counter() - t0
    path = save_png(img, args.out)
    n_pix = camera.width * camera.height
    print(f"{args.mode}: {camera.width}x{camera.height} in {dt:.3f}s "
          f"({n_pix / dt / 1e6:.2f} Mpix/s incl. compile) -> {path}")


def cmd_info(argv) -> None:
    ap = argparse.ArgumentParser(prog="gsrast_tpu info")
    ap.add_argument("scene")
    ap.add_argument("--gaussian", type=int, default=None,
                    help="peek one Gaussian's render state (the CUDA panel)")
    _add_common(ap)
    args = ap.parse_args(argv)
    _maybe_distributed(args)

    from .utils.inspector import camera_report, peek_gaussian, scene_report

    scene = _load(args.scene)
    camera = _camera(args, scene)
    report = {
        "scene": scene_report(scene),
        "camera": camera_report(camera),
    }
    if args.gaussian is not None:
        report["gaussian"] = peek_gaussian(scene, camera, args.gaussian)
    print(json.dumps(report, indent=2, default=str))


def cmd_pose(argv) -> None:
    """Pose save/restore/delete/list — the Inspector pose table
    (Inspector.cpp:306-358) as a CLI."""
    ap = argparse.ArgumentParser(prog="gsrast_tpu pose")
    ap.add_argument("action", choices=["list", "save", "delete", "show"])
    ap.add_argument("name", nargs="?")
    ap.add_argument("--scene", default=None,
                    help="scene to auto-frame when saving")
    _add_common(ap)
    args = ap.parse_args(argv)
    _maybe_distributed(args)

    from .camera import pose_to_dict
    from .utils.posedb import PoseDB

    db = PoseDB(path=args.store)
    if args.action == "list":
        print(json.dumps(db.names()))
    elif args.action == "show":
        cam = db.load(args.name)
        print(json.dumps(pose_to_dict(cam) if cam else None, indent=2))
    elif args.action == "delete":
        print(db.delete(args.name))
    else:  # save
        if not args.scene:
            sys.exit("pose save requires --scene to derive the framing")
        scene = _load(args.scene)
        db.save(args.name, _camera(args, scene))
        print(f"saved {args.name!r}")


def cmd_train(argv) -> None:
    ap = argparse.ArgumentParser(prog="gsrast_tpu train")
    ap.add_argument("--scene", required=True,
                    help=".ply initialization, 'random:N', or 'colmap' "
                         "(initialize from --data's SfM points3D.bin)")
    ap.add_argument("--data", default=None,
                    help="multi-view dataset directory: COLMAP "
                         "(sparse[/0]/cameras.bin + images/) or this "
                         "framework's cameras.json + PNGs — round-robin "
                         "per step")
    ap.add_argument("--downscale", type=int, default=1,
                    help="integer image downscale for COLMAP datasets")
    ap.add_argument("--target", default=None,
                    help="target image PNG for single-view fitting demo")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--ckpt-dir", default="ckpts")
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save-ply", default=None,
                    help="write the trained scene as .ply when done")
    ap.add_argument("--capacity", type=int, default=None,
                    help="scene capacity (free slots for densification)")
    ap.add_argument("--densify-from", type=int, default=None,
                    help="first densification step (default 500)")
    ap.add_argument("--densify-every", type=int, default=None,
                    help="steps between densifications (default 100)")
    _add_common(ap)
    args = ap.parse_args(argv)
    _maybe_distributed(args)

    import jax
    import jax.numpy as jnp

    import numpy as np

    from .render.api import render
    from .scene.gaussians import pad_to_capacity, random_scene
    from .train import checkpoint as ckpt
    from .train.trainer import (TrainConfig, init_train_state, make_optimizer,
                                make_train_step, maybe_densify)
    from .utils.image import load_png

    scene = None
    if args.scene.startswith("random:"):
        scene = random_scene(jax.random.PRNGKey(0),
                             int(args.scene.split(":")[1]))
    elif args.scene != "colmap":
        scene = _load(args.scene)
    if scene is None and not args.data:
        sys.exit("--scene colmap requires a COLMAP --data directory")

    if args.data:
        from .scene.colmap import (init_scene_from_points, is_colmap_dir,
                                   load_colmap)

        if is_colmap_dir(args.data):
            # The format real GS scenes ship in (BASELINE config 4).
            ds, xyz, rgbp = load_colmap(args.data,
                                        downscale=args.downscale)
            if scene is None:
                if xyz is None:
                    sys.exit("--scene colmap needs points3D.bin in --data")
                scene = init_scene_from_points(xyz, rgbp)
                print(f"initialized {xyz.shape[0]} gaussians from COLMAP "
                      "SfM points")
        else:
            if scene is None:
                sys.exit("--scene colmap requires a COLMAP --data directory")
            from .scene.dataset import load_dataset

            ds = load_dataset(args.data)
        frames = [(ds.cameras[i], jnp.asarray(ds.images[i]))
                  for i in range(ds.num_frames)]
        print(f"dataset: {ds.num_frames} views "
              f"{ds.cameras[0].width}x{ds.cameras[0].height} from {args.data}")
        # Product default = fused multi-tier path, binning auto-derived from
        # the init scene + first view; the wide margin covers densification
        # reshaping the count distribution (overflow stays counted).
        rcfg = _auto_cfg(args, scene, frames[0][0], margin=1.5)
    else:
        camera = _camera(args, scene)
        if args.target:
            target = jnp.asarray(load_png(args.target))
            camera = camera.replace(width=target.shape[1],
                                    height=target.shape[0])
            rcfg = _auto_cfg(args, scene, camera, margin=1.5)
        else:
            # Self-distillation demo: fit to the scene's own render.
            rcfg = _auto_cfg(args, scene, camera, margin=1.5)
            target = render(scene.activated(), camera, rcfg).image
        frames = [(camera, target)]

    if args.capacity:
        scene = pad_to_capacity(scene, args.capacity)
    mn, mx = scene.bbox()
    extent = float(np.linalg.norm(np.asarray(mx) - np.asarray(mn))) or 1.0
    tc = TrainConfig()
    if args.densify_from is not None:
        tc = dataclasses.replace(tc, densify_from=args.densify_from)
    if args.densify_every is not None:
        tc = dataclasses.replace(tc, densify_every=args.densify_every)
    optimizer = make_optimizer(tc, extent)
    state = init_train_state(scene, optimizer)
    if args.resume:
        restored = ckpt.restore(args.ckpt_dir, state)
        if restored is not None:
            state = restored
            print(f"resumed from step {int(state.step)}")
    step_fn = jax.jit(make_train_step(rcfg, tc, optimizer))

    def one_step(st, i):
        camera, target = frames[i % len(frames)]
        st, metrics = step_fn(st, camera, target)
        sub = jax.random.fold_in(jax.random.PRNGKey(1), i)
        st, _info = maybe_densify(st, tc, sub, extent, optimizer)
        if i % 100 == 0 or i == args.steps - 1:
            print(f"step {i}: loss={float(metrics['loss']):.5f} "
                  f"psnr={float(metrics['psnr']):.2f} "
                  f"active={int(metrics['num_active'])}")
        return st, metrics

    # Survival loop: checkpoints, NaN rollback, SIGTERM-preemption save,
    # heartbeat (train/resilience.py).
    from .train.resilience import ResilienceConfig, run_resilient

    rc = ResilienceConfig(
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every or 500,
        heartbeat_path=f"{args.ckpt_dir}/heartbeat.json",
    )
    state, stopped = run_resilient(state, args.steps, one_step, rc)
    if stopped:
        print("stopped early on preemption signal (checkpoint saved)")
    if args.save_ply:
        from .scene.ply import save_ply

        save_ply(state.scene, args.save_ply)
        print(f"saved trained scene -> {args.save_ply}")
    print(f"done; checkpoints in {args.ckpt_dir}")


def cmd_make_dataset(argv) -> None:
    """Render a scene from an orbit rig into a multi-view training dataset
    (the synthetic ground-truth generator for `train --data`)."""
    ap = argparse.ArgumentParser(prog="gsrast_tpu make-dataset")
    ap.add_argument("scene", help=".ply scene (or 'random:N')")
    ap.add_argument("--out", required=True, help="dataset directory")
    ap.add_argument("--views", type=int, default=16)
    _add_common(ap)
    args = ap.parse_args(argv)
    _maybe_distributed(args)

    import jax

    from .camera import auto_frame
    from .scene.dataset import render_synthetic_dataset
    from .scene.gaussians import random_scene

    if args.scene.startswith("random:"):
        scene = random_scene(jax.random.PRNGKey(0),
                             int(args.scene.split(":")[1]))
    else:
        scene = _load(args.scene)
    width = args.width or 256
    height = args.height or 256
    mn, mx = scene.bbox()
    rcfg = _auto_cfg(args, scene, auto_frame(mn, mx, width, height),
                     margin=1.5)
    path, cams = render_synthetic_dataset(
        scene, args.out, n_views=args.views, width=width, height=height,
        render_cfg=rcfg,
    )
    print(f"wrote {len(cams)} views to {path}")


def cmd_bench(argv) -> None:
    """North-star benchmark + per-stage fwd+bwd decomposition. The headline
    number uses the SAME code path and config as the driver's bench.py
    (gsrast_tpu/benchmark.py is the single source of truth)."""
    ap = argparse.ArgumentParser(prog="gsrast_tpu bench")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--scene", default=None,
                    help="bench a trained .ply instead of the random scene "
                         "(real scenes carry radius/depth skew)")
    ap.add_argument("--backend", default=None, choices=["pallas", "xla"])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--chain", type=int, default=1,
                    help="steps chained inside one dispatch (steady-state "
                         "timing of a dependent step sequence)")
    ap.add_argument("--no-stages", action="store_true",
                    help="skip the per-stage table (headline only)")
    args = ap.parse_args(argv)
    _maybe_distributed(args)

    from . import benchmark
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    backend = _backend(args)

    scene = camera = None
    if args.scene:
        from .camera import auto_frame

        scene = _load(args.scene)
        mn, mx = scene.bbox()
        camera = auto_frame(mn, mx, args.width, args.height)
        args.n = scene.capacity

    if not args.no_stages:
        stages = benchmark.stage_table(
            args.n, args.width, args.height, backend, iters=args.iters,
            scene=scene, camera=camera)
        print(benchmark.format_stage_table(stages, args.width, args.height))

    best_ms, mpix_s = benchmark.run_bench(
        args.n, args.width, args.height, backend, iters=args.iters,
        scene=scene, camera=camera, chain=args.chain)
    print(json.dumps({
        "metric": "mpixels_per_s_per_chip_fwd_bwd",
        "n": args.n, "width": args.width, "height": args.height,
        "scene": args.scene, "backend": backend, "best_ms": round(best_ms, 2),
        "value": round(mpix_s, 3), "unit": "Mpixels/s/chip",
    }))


COMMANDS = {
    "render": cmd_render,
    "info": cmd_info,
    "pose": cmd_pose,
    "train": cmd_train,
    "make-dataset": cmd_make_dataset,
    "bench": cmd_bench,
}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: python -m gsrast_tpu {{{','.join(COMMANDS)}}} ...")
        return
    cmd = argv[0]
    if cmd not in COMMANDS:
        sys.exit(f"unknown command {cmd!r}; expected one of {list(COMMANDS)}")
    COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    main()
