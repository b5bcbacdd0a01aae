"""Debug artifact dumps.

The reference persists every intermediate per scene: segment and model PLYs
and prob images into debug_super4PCS/, per-state depth renders and search
traces into debug_search/ (SURVEY.md section 5). Here, as in the JAX
package's utils/debug.py, the equivalents are npz and PNG artifacts written
under a debug directory when one is given, with the same file names and npz
keys: per-object segment clouds and probabilities, probability images, the
cleaned depth, hypotheses, and final pose overlays. Tensors are taken to the
host here.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from physimglobalpose_tpu_torch.geometry import depthio
from physimglobalpose_tpu_torch.utils import viz


def _np(x) -> np.ndarray:
    """A torch tensor (on any device) or array-like -> numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class DebugDump:
    def __init__(self, root: Optional[str]):
        self.root = root
        if root:
            os.makedirs(root, exist_ok=True)

    @property
    def enabled(self) -> bool:
        return self.root is not None

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def depth(self, name: str, depth) -> None:
        if self.enabled:
            depth = _np(depth)
            depthio.write_depth_png(self._path(f"{name}.png"), depth)
            viz.save_depth_image(self._path(f"{name}_viz.png"), depth)

    def prob_image(self, name: str, prob) -> None:
        if self.enabled:
            depthio.write_prob_png(self._path(f"{name}_prob.png"), _np(prob))

    def segment(self, name: str, pts, nrm, prob, mask) -> None:
        if self.enabled:
            np.savez(self._path(f"{name}_segment.npz"), pts=_np(pts), nrm=_np(nrm),
                     prob=_np(prob), mask=_np(mask))

    def hypotheses(self, name: str, transforms, scores) -> None:
        if self.enabled:
            np.savez(self._path(f"{name}_hypotheses.npz"), transforms=_np(transforms),
                     scores=_np(scores))

    def overlay(self, name: str, color, intrinsics, model_clouds: Sequence,
                poses_cam: Sequence) -> None:
        if self.enabled:
            viz.save_overlay(self._path(f"{name}.png"), _np(color), _np(intrinsics),
                             [_np(c) for c in model_clouds], [_np(p) for p in poses_cam])

    def info(self, name: str, payload: Dict) -> None:
        if self.enabled:
            with open(self._path(f"{name}.json"), "w") as fh:
                json.dump(payload, fh, indent=2, default=float)
