"""Spans and counters around the calls into the program's layers.

The benchmark records them from its own files: it wraps the program's entry
point by patching its module attribute for the run and puts it back on
close. The wrapper opens a profiler range named "gpubench::<layer>" (so the
device trace can attribute kernels to the layer):

- lcp: ops/lcp.lcp_scores, the LCP scoring of a hypothesis set; while a
  trace is recorded, each call's shapes (hypotheses, model points, the
  segment's mask) for the roofline of metrics/lcp_roofline.*.

The sweep load opens "gpubench::sweep" around each sweep call itself.
"""

from __future__ import annotations

import threading

import torch


class Layers:
    def __init__(self):
        self.lock = threading.Lock()
        self.lcp_shapes = []  # while recording: (hypotheses, model points, segment mask, tier)
        self.recording = False
        self._undo = []

    def _patch(self, owner, attr, wrapper):
        orig = getattr(owner, attr)
        setattr(owner, attr, wrapper(orig))
        self._undo.append((owner, attr, orig))

    def install(self) -> "Layers":
        from physimglobalpose_tpu_torch.ops import lcp

        def lcp_wrapper(orig):
            def lcp_scores(transforms, model_pts, model_nrm, seg_pts, seg_nrm, seg_prob,
                           seg_mask, *args, **kwargs):
                if self.recording:
                    tier = kwargs.get("matmul_precision", args[3] if len(args) > 3 else None)
                    with self.lock:
                        self.lcp_shapes.append(
                            (int(transforms.shape[0]), int(model_pts.shape[0]), seg_mask, tier))
                with torch.profiler.record_function("gpubench::lcp"):
                    return orig(transforms, model_pts, model_nrm, seg_pts, seg_nrm, seg_prob,
                                seg_mask, *args, **kwargs)
            return lcp_scores

        self._patch(lcp, "lcp_scores", lcp_wrapper)
        return self

    def lcp_calls(self) -> list:
        """(hypotheses, model points, valid segment points, tier) of the
        calls recorded; reads the masks back, so only after the trace."""
        return [(h, nv, int(mask.sum().item()), tier) for h, nv, mask, tier in self.lcp_shapes]

    def close(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()
        self.lcp_shapes.clear()
