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
Training is ported too: make_targets (numpy), detector_loss and an Adam
train step; checkpoints are the FCN zoo's flat .npz (models/fcn.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physimglobalpose_tpu_torch import _torchcfg
from physimglobalpose_tpu_torch.models.fcn import (  # noqa: F401  (one checkpoint format)
    WEIGHTS_DIR, Conv, GroupNorm, load_flax_params, load_params_npz, resize_bilinear,
    save_params_npz,
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


# ------------------------------------------------------------------ targets


def make_targets(label: np.ndarray, num_classes: int):
    """Training targets from a GT class-id mask [H, W].

    Returns (heat [H/8, W/8, num_classes] gaussian center map,
    size [H/8, W/8, 2] log stride-unit sizes, pos [H/8, W/8] center mask).
    One box per class present (the scenes place one instance per class, as
    the reference's APC setting does - Segmentation.cpp keeps one box per
    class too). A numpy copy of the JAX package's function.
    """
    h, w = label.shape
    gh, gw = h // STRIDE, w // STRIDE
    heat = np.zeros((gh, gw, num_classes), np.float32)
    size = np.zeros((gh, gw, 2), np.float32)
    pos = np.zeros((gh, gw), bool)
    for cid in np.unique(label):
        if cid == 0 or cid > num_classes:
            continue
        ys, xs = np.nonzero(label == cid)
        if len(ys) < 8:
            continue
        x1, x2, y1, y2 = xs.min(), xs.max(), ys.min(), ys.max()
        bw, bh = (x2 - x1 + 1) / STRIDE, (y2 - y1 + 1) / STRIDE
        cx = min(int((x1 + x2) / 2 / STRIDE), gw - 1)
        cy = min(int((y1 + y2) / 2 / STRIDE), gh - 1)
        # CenterNet gaussian: radius ~ box size / 3.
        sigma = max(1.0, min(bw, bh) / 3.0)
        yy, xx = np.mgrid[0:gh, 0:gw]
        g = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma ** 2))
        heat[:, :, cid - 1] = np.maximum(heat[:, :, cid - 1], g)
        size[cy, cx] = [np.log(max(bw, 1e-3)), np.log(max(bh, 1e-3))]
        pos[cy, cx] = True
    return heat, size, pos


def detector_loss(heat_logits, size_pred, heat_tgt, size_tgt, pos_mask) -> torch.Tensor:
    """CenterNet penalty-reduced focal loss + 0.5 L1 size loss at centers.

    All in the JAX layout, channels last: heat_logits and heat_tgt
    [B, gh, gw, C], size_pred and size_tgt [B, gh, gw, 2], pos_mask
    [B, gh, gw] bool."""
    p = torch.sigmoid(heat_logits)
    eps = 1e-6
    is_center = heat_tgt >= 0.999
    pos_loss = -torch.log(p + eps) * (1 - p) ** 2 * is_center
    neg_loss = -torch.log(1 - p + eps) * p ** 2 * (1 - heat_tgt) ** 4 * ~is_center
    n_pos = torch.clamp(torch.sum(is_center), min=1).to(torch.float32)
    heat_loss = (torch.sum(pos_loss) + torch.sum(neg_loss)) / n_pos
    pos = pos_mask.to(torch.float32)
    size_loss = torch.sum(torch.abs(size_pred - size_tgt) * pos[..., None]) / torch.clamp(
        torch.sum(pos), min=1.0)
    return heat_loss + 0.5 * size_loss


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer):
    """Returns train_step(images [B, H, W, 3], heat_tgt, size_tgt, pos_mask)
    -> the batch's loss before the update, taking one optimizer step. The
    inputs are in the JAX layout (channels last, as make_targets gives them)
    and go to the model's device."""

    def train_step(images, heat_tgt, size_tgt, pos_mask):
        dev = next(model.parameters()).device
        as_dev = lambda a, dt=torch.float32: torch.as_tensor(a).to(dev, dt)  # noqa: E731
        x = as_dev(images).permute(0, 3, 1, 2)
        optimizer.zero_grad(set_to_none=True)
        heat, size = model(x)
        loss = detector_loss(heat.permute(0, 2, 3, 1), size.permute(0, 2, 3, 1),
                             as_dev(heat_tgt), as_dev(size_tgt), as_dev(pos_mask, torch.bool))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


# ------------------------------------------------------------------ decoding


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
