"""Optimizer/parameter checkpointing for inverse rendering.

The reference has no checkpoint/resume (SURVEY.md §5); the analogue here is
saving the Adam state + trainable scene parameters so a fit can resume. A
checkpoint is one NumPy ``.npz`` holding the leaves of the state pytree in
``jax.tree_util`` order; restoring needs a template of the same structure.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}.npz")


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    """Save a pytree (params + opt_state + metadata) as
    ``directory/step_{step}.npz``; returns the path. The file is written
    under a temporary name and renamed, so a crash never leaves a partial
    checkpoint under the final name."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    leaves = jax.tree_util.tree_leaves(state)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and name.endswith(".npz"):
            try:
                steps.append(int(name[5:-4]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore_checkpoint(directory: str, template: Any,
                       step: Optional[int] = None) -> Any:
    """Restore the pytree saved at ``step`` (default: latest) into the
    structure of ``template``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    treedef = jax.tree_util.tree_structure(template)
    with np.load(_path(directory, step)) as data:
        leaves = [jnp.asarray(data[f"leaf_{i}"])
                  for i in range(len(data.files))]
    if len(leaves) != treedef.num_leaves:
        raise ValueError(
            f"checkpoint step {step} holds {len(leaves)} leaves; the template "
            f"has {treedef.num_leaves}")
    return jax.tree_util.tree_unflatten(treedef, leaves)
