"""One-command regeneration of the >=1M trained bench fixture.

Runs the framework's own end-to-end pipeline:
  1. make-dataset: render a 16-view orbit of a random 1M scene at 800x800;
  2. train: fit a fresh 1.1M scene to those views (densify+prune active);
  3. save the trained .ply, plus a 5x-replicated-with-jitter variant at
     ~5.5M gaussians carrying trained-STATISTICS splat-size skew at
     BASELINE config-3 scale (the scene used by the config-3 rows in
     BASELINE.md).

    python scripts/make_trained_fixture.py --out .smoke/fixtures \
        [--steps 700] [--small]   # --small: 120k-scale smoke variant

Determinism note: training uses fixed seeds, but kernel scheduling makes the
result bit-nondeterministic across runs; the fixture's ROLE (trained
statistics: scale spread, count skew) is reproduced exactly, metrics within
noise (PSNR ~32 at the default settings).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=".smoke/fixtures")
    ap.add_argument("--steps", type=int, default=700)
    ap.add_argument("--small", action="store_true",
                    help="120k-scale smoke variant (fast)")
    ap.add_argument("--skip-5m", action="store_true",
                    help="skip the 5.5M replicated-statistics variant")
    args = ap.parse_args()

    from gsrast_tpu import cli

    os.makedirs(args.out, exist_ok=True)
    if args.small:
        n_data, n_train, cap, views, size = 120_000, 130_000, 170_000, 24, 512
    else:
        n_data, n_train, cap, views, size = (1_000_000, 1_100_000, 1_300_000,
                                             16, 800)
    data_dir = os.path.join(args.out, "dataset")
    ply = os.path.join(args.out, f"trained_{n_train // 1000}k.ply")

    cli.cmd_make_dataset([
        f"random:{n_data}", "--out", data_dir, "--views", str(views),
        "--width", str(size), "--height", str(size)])
    cli.cmd_train([
        "--scene", f"random:{n_train}", "--capacity", str(cap),
        "--data", data_dir, "--steps", str(args.steps),
        "--ckpt-dir", os.path.join(args.out, "ckpts"),
        "--save-ply", ply])
    print(f"trained fixture: {ply}")

    if not args.skip_5m:
        import jax.numpy as jnp
        import numpy as np

        from gsrast_tpu.scene.ply import load_ply, save_ply

        scene = load_ply(ply)
        rng = np.random.default_rng(0)
        reps = [
            scene.replace(means=scene.means + jnp.asarray(
                rng.normal(0.0, 0.02, size=scene.means.shape),
                jnp.float32))
            for _ in range(5)
        ]
        big = scene.replace(**{
            k: jnp.concatenate([getattr(r, k) for r in reps], axis=0)
            for k in ("means", "log_scales", "quats", "opacity_logits",
                      "sh", "mask")})
        big_ply = os.path.join(args.out, "trained_stats_5m.ply")
        save_ply(big, big_ply)
        print(f"5x trained-statistics fixture: {big_ply}")


if __name__ == "__main__":
    main()
