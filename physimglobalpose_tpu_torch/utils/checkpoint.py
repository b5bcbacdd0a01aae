"""Checkpoint / resume for trainable components (FCN, detector) and search state.

The reference has no computation checkpointing (SURVEY.md section 5): NN
weights are load-only, results are per-scene files. Here, as in the JAX
package's utils/checkpoint.py:
- a training state (the model's parameters, the optimizer's state and the
  step) saves and restores with torch.save / torch.load of state_dicts (JAX
  uses orbax);
- dataset sweeps resume through the JSONL log (pipeline/evaluate.py);
- search snapshots keep a scene's best assignment, its cost and the seed, as
  JSON with the JAX package's keys.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch


def save_train_state(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     step: int) -> None:
    """Save the model's and the optimizer's state_dicts and the step."""
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "step": int(step)}, path)


def load_train_state(path: str, model: torch.nn.Module,
                     optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Restore a state saved by save_train_state into `model` (and
    `optimizer`, when given), onto the model's device; returns the step."""
    dev = next(model.parameters()).device
    state = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def save_search_snapshot(path: str, scene_dir: str, assignment, best_cost: float,
                         seed: int) -> None:
    """Persist an MCTS/greedy search outcome for a scene (resume/inspection)."""
    with open(path, "w") as fh:
        json.dump(
            {
                "scene": scene_dir,
                "assignment": [int(a) for a in assignment],
                "best_cost": float(best_cost),
                "seed": int(seed),
            },
            fh,
        )


def load_search_snapshot(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh)
