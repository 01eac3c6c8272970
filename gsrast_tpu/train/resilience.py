"""Failure detection and elastic recovery for training loops.

The reference prints errors to stderr and limps on (SURVEY.md §5: "errors
print ... with '?' and the app limps on", e.g. ShaderBase.cpp:8-10); a
production training system needs real failure handling — jobs get preempted,
kernels can emit NaNs, hosts die. This module provides the single-host pieces
that compose with jax.distributed for multi-host (parallel/mesh.py
initialize_distributed is the pod bootstrap/barrier):

  * NaN/Inf step detection with automatic rollback to the last good
    checkpoint (poisoned updates never reach the persisted state);
  * preemption handling: SIGTERM/SIGINT trigger a final checkpoint before
    exit (the usual cluster eviction contract);
  * heartbeat file: periodic {step, time, pid} JSON an external supervisor
    (or another host over DCN) can watch for liveness;
  * fault injection hooks for tests — deliberate NaN at step k, simulated
    preemption — so the recovery paths are exercised, not just written.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from . import checkpoint as ckpt_mod


@dataclasses.dataclass
class ResilienceConfig:
    ckpt_dir: str = "ckpts"
    ckpt_every: int = 500
    heartbeat_path: Optional[str] = None
    heartbeat_every: int = 50
    max_rollbacks: int = 3          # consecutive NaN rollbacks before abort
    inject_nan_at_step: Optional[int] = None   # fault injection (tests)


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that request a graceful stop; the
    training loop checkpoints and exits at the next step boundary. Restores
    previous handlers on __exit__ (safe under pytest)."""

    def __init__(self):
        self.stop_requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.stop_requested = True

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:  # non-main thread: polling-only mode
                pass
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False


def write_heartbeat(path: str, step: int) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, "time": time.time(), "pid": os.getpid()},
                  f)
    os.replace(tmp, path)  # atomic: watchers never see a partial write


def read_heartbeat(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _all_finite(tree) -> bool:
    leaves = [jnp.all(jnp.isfinite(x)) for x in jax.tree.leaves(tree)
              if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)]
    if not leaves:
        return True
    return bool(jax.device_get(jnp.all(jnp.stack(leaves))))


def run_resilient(
    state,
    num_steps: int,
    step_fn: Callable,          # (state, step_idx) -> (state, metrics)
    rc: ResilienceConfig,
    log: Callable[[str], None] = print,
):
    """Drive `step_fn` with checkpointing, NaN rollback, preemption-safe
    shutdown, and heartbeats. Returns (final_state, stopped_early: bool).

    step_fn owns the model specifics (camera selection, densify, ...); this
    loop owns survival. Rollback restores the LAST SAVED state and continues
    from its step counter — deterministic given deterministic step_fn.
    """
    rollbacks = 0
    last_saved = int(state.step)
    ckpt_mod.save(rc.ckpt_dir, state)

    with PreemptionGuard() as guard:
        i = int(state.step)
        while i < num_steps:
            new_state, metrics = step_fn(state, i)

            if rc.inject_nan_at_step is not None and i == rc.inject_nan_at_step:
                # Fault injection: poison the scene params once.
                poisoned = new_state.scene.replace(
                    means=new_state.scene.means * jnp.float32(jnp.nan)
                )
                new_state = new_state._replace(scene=poisoned)
                rc = dataclasses.replace(rc, inject_nan_at_step=None)

            loss = metrics.get("loss")
            # Check the WHOLE state pytree (scene params + optimizer
            # moments): NaN/Inf confined to quats/scales/sh/opacities or the
            # Adam moments would otherwise be checkpointed as "good" and
            # poison the rollback target.
            bad = (loss is not None and not _all_finite(loss)) or (
                not _all_finite(new_state)
            )
            if bad:
                rollbacks += 1
                log(f"step {i}: NON-FINITE state detected; rolling back to "
                    f"checkpoint step {last_saved} "
                    f"({rollbacks}/{rc.max_rollbacks})")
                if rollbacks > rc.max_rollbacks:
                    raise RuntimeError(
                        f"aborting: {rollbacks} consecutive non-finite steps"
                    )
                restored = ckpt_mod.restore(rc.ckpt_dir, state)
                if restored is None:
                    raise RuntimeError("no checkpoint to roll back to")
                state = restored
                i = int(state.step)
                continue

            rollbacks = 0
            state = new_state
            i += 1

            if rc.heartbeat_path and i % rc.heartbeat_every == 0:
                write_heartbeat(rc.heartbeat_path, i)
            if rc.ckpt_every and i % rc.ckpt_every == 0:
                ckpt_mod.save(rc.ckpt_dir, state)
                last_saved = i
            if guard.stop_requested:
                log(f"step {i}: preemption requested; checkpointing and "
                    "stopping")
                ckpt_mod.save(rc.ckpt_dir, state)
                if rc.heartbeat_path:
                    write_heartbeat(rc.heartbeat_path, i)
                return state, True

    ckpt_mod.save(rc.ckpt_dir, state)
    if rc.heartbeat_path:
        write_heartbeat(rc.heartbeat_path, int(state.step))
    return state, False
