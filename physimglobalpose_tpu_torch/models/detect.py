"""Learned object detection network (the Faster-RCNN service slot), serving.

Reference: the RCNN segmentation strategies call a Faster-RCNN ROS service
(rcnn_detection_package/bin/detect_bbox:24-39) whose `detect` returns, per
requested class, the top-9 boxes by class score (recognition.py:27-61). The
JAX package fills the slot with a single-shot anchor-free detector (CenterNet
semantics: a per-class centre heatmap and box log-sizes at stride 8, a 3x3
max-pool peak test, a top-k per class); this is its port, with the shipped
weights carried across by models/fcn.flax_to_state_dict and the numerics of
models/fcn.py (bf16 convs, float32 GroupNorm and heads, lax's SAME padding:
three of the eight blocks are stride-2 and pad (0, 1) on even inputs).
Training stays with the JAX package for now.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physimglobalpose_tpu_torch import _torchcfg
from physimglobalpose_tpu_torch.models.fcn import (
    WEIGHTS_DIR, Conv, GroupNorm, load_flax_params, load_params_npz, resize_bilinear,
)

STRIDE = 8
NUM_CLASSES = 11  # APC object classes (ids 1..11; channel = id - 1)
_SHIPPED = "detector_synth_apc.npz"


class ConvBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, stride=stride, bias=False, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(features, num_groups=8)

    def forward(self, x):
        return F.relu(self.GroupNorm_0(self.Conv_0(x)))


class CenterNetDetector(nn.Module):
    """Anchor-free single-shot detector at stride 8. forward(x [B, 3, H, W])
    -> (heat [B, num_classes, H/8, W/8] centre logits, size [B, 2, H/8, W/8]
    log box sizes in stride units). Class id c is channel c - 1; background
    has no channel."""

    def __init__(self, num_classes: int, width: int = 32, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        w = width
        plan = [(w, 1), (w, 2), (w * 2, 1), (w * 2, 2), (w * 4, 1), (w * 4, 2), (w * 4, 1),
                (w * 4, 1)]
        cin = 3
        for i, (feat, stride) in enumerate(plan):
            self.add_module(f"ConvBlock_{i}", ConvBlock(cin, feat, stride, dtype))
            cin = feat
        self.n_blocks = len(plan)
        self.heat = Conv(cin, num_classes, 1, dtype=torch.float32)
        self.size = Conv(cin, 2, 1, dtype=torch.float32)

    def forward(self, x: torch.Tensor):
        x = x.to(self.dtype)
        for i in range(self.n_blocks):
            x = getattr(self, f"ConvBlock_{i}")(x)
        return self.heat(x), self.size(x)


def decode_boxes(heat_logits: torch.Tensor, size_pred: torch.Tensor, top: int = 9):
    """Per-class top-k peak decoding.

    heat_logits [gh, gw, C], size_pred [gh, gw, 2] (the JAX function's
    layout) -> (boxes [C, top, 4] pixel tl_x, tl_y, br_x, br_y; scores
    [C, top]). A point is a peak iff it is its 3x3 neighbourhood's maximum;
    tied scores keep index order, as jax.lax.top_k does.
    """
    gh, gw, c = heat_logits.shape
    p = torch.sigmoid(heat_logits)
    pooled = F.max_pool2d(p.permute(2, 0, 1)[None], 3, stride=1, padding=1)[0].permute(1, 2, 0)
    peaks = torch.where(p >= pooled, p, 0.0)
    flat = peaks.reshape(gh * gw, c).T  # [C, gh*gw]
    order = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, idx = order.values[:, :top], order.indices[:, :top]
    cy, cx = idx // gw, idx % gw
    sz = torch.exp(size_pred.reshape(gh * gw, 2))[idx]  # [C, top, 2]
    bw, bh = sz[..., 0], sz[..., 1]
    x = (cx.to(torch.float32) + 0.5) * STRIDE
    y = (cy.to(torch.float32) + 0.5) * STRIDE
    boxes = torch.stack(
        [x - bw * STRIDE / 2, y - bh * STRIDE / 2, x + bw * STRIDE / 2, y + bh * STRIDE / 2],
        dim=-1,
    )
    return boxes, scores


def shipped_checkpoint_path() -> str:
    return os.path.normpath(os.path.join(WEIGHTS_DIR, _SHIPPED))


def make_box_predictor(model: nn.Module, input_size=(480, 640), top: int = 9):
    """color [H, W, 3] uint8 -> (boxes [C, top, 4] float64 in the input's
    pixels, scores [C, top]): resize to input_size, forward, decode, all on
    the model's device (it holds its weights); the boxes are scaled back and
    clipped to the image on the host (recognition.py:27-61: the top `top`
    boxes per class)."""
    hh, ww = input_size

    def predict(color: np.ndarray):
        h0, w0 = color.shape[:2]
        dev = next(model.parameters()).device
        with torch.no_grad():
            img = torch.as_tensor(np.asarray(color)).to(dev).permute(2, 0, 1)
            img = resize_bilinear(img[None].to(torch.float32) / 255.0, (hh, ww))
            heat, size = model(img)
            boxes, scores = decode_boxes(heat[0].permute(1, 2, 0), size[0].permute(1, 2, 0), top)
        boxes = boxes.cpu().numpy().astype(np.float64)
        boxes[..., 0::2] *= w0 / ww
        boxes[..., 1::2] *= h0 / hh
        np.clip(boxes[..., 0::2], 0, w0 - 1, out=boxes[..., 0::2])
        np.clip(boxes[..., 1::2], 0, h0 - 1, out=boxes[..., 1::2])
        return boxes, scores.cpu().numpy()

    return predict


def load_shipped_box_predictor(input_size=None, top: int = 9, device=None):
    """The shipped synthetic-trained detector, on the card unless
    device="cpu". input_size defaults to the checkpoint's training
    resolution (meta "input_size", 240x320)."""
    path = shipped_checkpoint_path()
    if not os.path.exists(path):
        raise FileNotFoundError(f"no shipped detector checkpoint at {path}")
    flat, meta = load_params_npz(path)
    if input_size is None:
        input_size = tuple(meta.get("input_size", (240, 320)))
    model = CenterNetDetector(num_classes=meta.get("num_classes", NUM_CLASSES),
                              width=meta.get("width", 32))
    model = load_flax_params(model, flat).to(_torchcfg.resolve_device(device))
    return make_box_predictor(model, input_size=input_size, top=top)
