"""Checkpoint / resume.

The reference persists only UI state (camera poses + screenshot path in LMDB,
/root/reference/apps/gsrast/Inspector.cpp:408-427) and reloads the scene from
.ply every start (GSRastWindow.cpp:24). SURVEY.md §5 requires real training
checkpointing: the full Gaussian parameter pytree + optimizer + densify state
+ step, with deterministic resume (training preempted at step k and resumed
produces the same states as an uninterrupted run, given the same camera
stream).

Each step's state is a directory `ckpt_dir/step_XXXXXXXX` holding one
numpy `state.npz`: the TrainState's leaves in pytree order. A restore reads
them back into the structure of a template state.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import jax
import numpy as np

from .trainer import TrainState

_STATE_FILE = "state.npz"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def save(ckpt_dir: str, state: TrainState, keep: int = 3) -> str:
    """Save a TrainState; prunes old checkpoints beyond `keep`. The step
    directory appears only once complete (written aside, then renamed)."""
    step = int(state.step)
    path = _step_dir(ckpt_dir, step)
    leaves = jax.tree.leaves(jax.device_get(state))
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _STATE_FILE),
             **{f"leaf_{i:05d}": np.asarray(x) for i, x in enumerate(leaves)})
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    _prune(ckpt_dir, keep)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template: TrainState,
            step: Optional[int] = None) -> Optional[TrainState]:
    """Restore the given (or latest) step. `template` supplies the pytree
    structure/dtypes; returns None when no checkpoint exists."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    with np.load(os.path.join(_step_dir(ckpt_dir, step), _STATE_FILE)) as z:
        leaves = [z[f"leaf_{i:05d}"] for i in range(len(z.files))]
    t_leaves, treedef = jax.tree.flatten(template)
    if len(leaves) != len(t_leaves):
        raise ValueError(f"checkpoint step {step} holds {len(leaves)} "
                         f"leaves; the template has {len(t_leaves)}")
    return jax.tree.unflatten(treedef, [
        jax.numpy.asarray(r, getattr(t, "dtype", None))
        for t, r in zip(t_leaves, leaves)])


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    )
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
