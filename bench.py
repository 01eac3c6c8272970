"""Benchmark: Mpixels/s/chip forward+backward at 1080p, 1M Gaussians.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} for the
driver (BASELINE.json north-star metric). The reference publishes no numbers
(BASELINE.md), so vs_baseline is reported against the driver-set target
rather than a reference measurement.

The measurement itself lives in gsrast_tpu/benchmark.py, shared with
`python -m gsrast_tpu bench` (which adds the per-stage table) so the shipped
number and the profile can never diverge.

Usage: python bench.py [--small] [--fwd-only] [--backend pallas|xla]
"""

from __future__ import annotations

import argparse
import json
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="100k gaussians at 800x800 (BASELINE config 2)")
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--backend", default=None, choices=["pallas", "xla"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--chain", type=int, default=1,
                    help="steps chained inside one dispatch; above 1 the "
                         "per-dispatch time is measured too")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()

    from gsrast_tpu import benchmark
    from gsrast_tpu.render.api import default_backend
    from gsrast_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    backend = args.backend or default_backend()

    if args.small:
        n, width, height = 100_000, 800, 800
    else:
        n, width, height = 1_000_000, 1920, 1080

    best_ms, mpix_s = benchmark.run_bench(
        n, width, height, backend, fwd_only=args.fwd_only, iters=args.iters,
        chain=args.chain,
    )
    # Both timing bases ship: the chained number is steady state (dispatch
    # overhead amortized, like an async training loop); the per-dispatch
    # number pays one dispatch per step.
    if args.chain > 1:
        pd_ms, pd_mpix = benchmark.run_bench(
            n, width, height, backend, fwd_only=args.fwd_only,
            iters=max(3, args.iters // 2), chain=1,
        )
    else:
        pd_ms, pd_mpix = best_ms, mpix_s

    if args.verbose:
        print(
            f"# backend={backend} n={n} {width}x{height} "
            f"fwd{'_only' if args.fwd_only else '+bwd'} best={best_ms:.2f}ms "
            f"per_dispatch={pd_ms:.2f}ms",
            file=sys.stderr,
        )

    # No published reference numbers exist; the 60 Mpix/s target and its
    # derivation live in BASELINE.md ("The vs_baseline denominator").
    target = 60.0
    print(json.dumps({
        "metric": "mpixels_per_s_per_chip_fwd_bwd_1080p_1m",
        "value": round(mpix_s, 3),
        "unit": "Mpixels/s/chip",
        "vs_baseline": round(mpix_s / target, 4),
        "chain": args.chain,
        "chained_ms": round(best_ms, 2),
        "per_dispatch_ms": round(pd_ms, 2),
        "per_dispatch_mpix_s": round(pd_mpix, 3),
    }))


if __name__ == "__main__":
    main()
