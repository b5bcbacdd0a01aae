"""FCN semantic segmentation model zoo (torch.nn) and its serving predictor.

Reference: fcn_segmentation_package/models.py defines FCN_Vgg16_32s
(:41-92), AtrousFCN_Vgg16_16s (:93-144), FCN_Resnet50_32s (:145-189) and
AtrousFCN_Resnet50_16s (:190-227), served at 640x640 with 12 (APC) classes by
the `predict` ROS node, which normalizes each class probability map to max 1
(predict:64-155). This is the port of the JAX package's Flax zoo: serving,
and training (the loss ignoring the last label, an Adam train step, and
save_params_npz, which writes the JAX package's flat checkpoint layout).

The numerics are the Flax modules', reproduced with explicit casts rather
than autocast:
- a conv of dtype bf16 casts its input and its float32 kernel to bf16,
  convolves (float32 accumulation), rounds to bf16 and adds the bias in bf16;
  GroupNorm (epsilon 1e-6, variance as E[x^2] - E[x]^2) and the `score`,
  `heat` and `size` heads run in float32;
- padding "SAME" is lax's: (k_eff - 1) split low/high with the extra row on
  the high side, so a stride-2 conv on an even input pads (0, 1) - applied
  with F.pad ahead of an unpadded conv; a SAME max-pool pads with -inf;
- jax.image.resize(..., "bilinear") is F.interpolate(bilinear,
  align_corners=False, antialias=True): both antialias when shrinking.

Modules are NCHW inside. Their submodules carry the Flax parameter paths as
names (VGGBlock_0.block1_conv1, Bottleneck_3.GroupNorm_1, ...), so the JAX
package's flat checkpoint dict converts to a state_dict by renaming
(flax_to_state_dict): HWIO kernels become OIHW, GroupNorm's `scale` becomes
`weight`; state_dict_to_flax is the inverse, so one checkpoint serves both
packages. The shipped checkpoints are the JAX package's .npz files under
physimglobalpose_tpu/models/weights/, read here as data with numpy.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physimglobalpose_tpu_torch import _torchcfg

# Sentinel keys a predictor's output dict carries beside the per-class
# probability maps (negative, so they never collide with class ids).
PREDICTOR_LABEL_KEY = -1  # argmax class image (fcn.mask.png analogue)
PREDICTOR_BACKGROUND_KEY = -2  # background channel map (background.png)

GN_EPS = 1e-6  # Flax GroupNorm's epsilon


# ---------------------------------------------------------------- layers


def same_pads(size: int, k: int, stride: int = 1, dilation: int = 1) -> tuple[int, int]:
    """lax's SAME padding of one spatial dim: (low, high)."""
    k_eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, stride: int = 1, dilation: int = 1,
             value: float = 0.0) -> torch.Tensor:
    """Pad NCHW x for a SAME window of k x k at stride and dilation."""
    top, bottom = same_pads(x.shape[-2], k, stride, dilation)
    left, right = same_pads(x.shape[-1], k, stride, dilation)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """jax.image.resize(..., "bilinear") of NCHW float32 x to size (h, w)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=True)


class Conv(nn.Conv2d):
    """Flax nn.Conv with padding SAME: computed in `dtype` (see the module
    docstring), float32 parameters."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__(cin, cout, k, stride=stride, dilation=dilation, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad_same(x, self.kernel_size[0], self.stride[0], self.dilation[0])
        dt = self.compute_dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, 0, self.dilation)
        if self.bias is not None:
            y = y + self.bias.to(dt)[:, None, None]
        return y


class GroupNorm(nn.GroupNorm):
    """Flax nn.GroupNorm(dtype=float32): float32 statistics with
    var = E[x^2] - E[x]^2 (clipped at 0), epsilon 1e-6, float32 output."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__(num_groups, channels, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        x = x.to(torch.float32)
        g = x.reshape(n, self.num_groups, -1)
        mean = torch.mean(g, dim=-1)  # [n, G]
        var = torch.clamp(torch.mean(g * g, dim=-1) - mean * mean, min=0.0)
        rep = c // self.num_groups
        # Flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias.
        mul = torch.rsqrt(var + self.eps).repeat_interleave(rep, dim=1) * self.weight
        y = x - mean.repeat_interleave(rep, dim=1)[:, :, None, None]
        return y * mul[:, :, None, None] + self.bias[:, None, None]


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Flax nn.max_pool(padding="SAME"): -inf padding, lax's split."""
    return F.max_pool2d(pad_same(x, k, stride, value=-torch.inf), k, stride)


# ---------------------------------------------------------------- VGG16 FCNs


class VGGBlock(nn.Module):
    def __init__(self, cin: int, features: int, convs: int, prefix: str,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.names = [f"{prefix}_conv{i + 1}" for i in range(convs)]
        for i, name in enumerate(self.names):
            self.add_module(name, Conv(cin if i == 0 else features, features, 3, dtype=dtype))

    def forward(self, x):
        for name in self.names:
            x = F.relu(getattr(self, name)(x))
        return F.max_pool2d(x, 2, 2)


class FCNVgg16(nn.Module):
    """FCN_Vgg16_32s (stride 32) and AtrousFCN_Vgg16_16s (dilated fc6, stride
    16); width_scale < 1 shrinks every channel count (the "small" entries)."""

    def __init__(self, num_classes: int, atrous: bool = False,
                 dtype: torch.dtype = torch.bfloat16, width_scale: float = 1.0):
        super().__init__()
        self.atrous, self.dtype = atrous, dtype

        def c(n):
            return max(8, int(n * width_scale))

        cin = 3
        blocks = [(64, 2), (128, 2), (256, 3), (512, 3)] + ([] if atrous else [(512, 3)])
        for i, (feat, convs) in enumerate(blocks):
            self.add_module(f"VGGBlock_{i}", VGGBlock(cin, c(feat), convs, f"block{i + 1}", dtype))
            cin = c(feat)
        self.n_blocks = len(blocks)
        if atrous:
            # 16s variant: no 5th pool; the fifth block's convs and a dilated fc6.
            for i in range(3):
                self.add_module(f"block5_conv{i + 1}", Conv(cin, c(512), 3, dtype=dtype))
            self.fc6 = Conv(c(512), c(4096), 7, dilation=2, dtype=dtype)
        else:
            self.fc6 = Conv(c(512), c(4096), 7, dtype=dtype)
        self.fc7 = Conv(c(4096), c(4096), 1, dtype=dtype)
        self.score = Conv(c(4096), num_classes, 1, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        x = x.to(self.dtype)
        for i in range(self.n_blocks):
            x = getattr(self, f"VGGBlock_{i}")(x)
        if self.atrous:
            for i in range(3):
                x = F.relu(getattr(self, f"block5_conv{i + 1}")(x))
        x = F.relu(self.fc6(x))  # dropout is the identity when serving
        x = F.relu(self.fc7(x))
        return resize_bilinear(self.score(x), (h, w))


# ---------------------------------------------------------------- ResNet50 FCNs


class Bottleneck(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1, dilation: int = 1,
                 project: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 1, stride=stride, bias=False, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, dilation=dilation, bias=False, dtype=dtype)
        self.GroupNorm_1 = GroupNorm(filters)
        self.Conv_2 = Conv(filters, filters * 4, 1, bias=False, dtype=dtype)
        self.GroupNorm_2 = GroupNorm(filters * 4)
        self.projects = project or cin != filters * 4 or stride != 1
        if self.projects:
            self.Conv_3 = Conv(cin, filters * 4, 1, stride=stride, bias=False, dtype=dtype)
            self.GroupNorm_3 = GroupNorm(filters * 4)

    def forward(self, x):
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = F.relu(self.GroupNorm_1(self.Conv_1(y)))
        y = self.GroupNorm_2(self.Conv_2(y))
        residual = self.GroupNorm_3(self.Conv_3(x)) if self.projects else x
        return F.relu(y + residual)


class FCNResnet50(nn.Module):
    """FCN_Resnet50_32s and AtrousFCN_Resnet50_16s, with the Flax zoo's
    GroupNorm in place of the reference's BatchNorm."""

    def __init__(self, num_classes: int, atrous: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(3, 64, 7, stride=2, bias=False, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(64)
        stages = [(64, 3, 1, 1), (128, 4, 2, 1), (256, 6, 2, 1)]
        stages.append((512, 3, 1, 2) if atrous else (512, 3, 2, 1))
        cin, i = 64, 0
        for filters, blocks, stride, dilation in stages:
            for j in range(blocks):
                self.add_module(f"Bottleneck_{i}", Bottleneck(
                    cin, filters, stride=stride if j == 0 else 1, dilation=dilation,
                    project=j == 0, dtype=dtype))
                cin, i = filters * 4, i + 1
        self.n_blocks = i
        self.score = Conv(cin, num_classes, 1, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        x = F.relu(self.GroupNorm_0(self.Conv_0(x.to(self.dtype))))
        x = max_pool_same(x, 3, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"Bottleneck_{i}")(x)
        return resize_bilinear(self.score(x), (h, w))


MODEL_ZOO: dict[str, Callable[..., nn.Module]] = {
    "FCN_Vgg16_32s": functools.partial(FCNVgg16, atrous=False),
    "AtrousFCN_Vgg16_16s": functools.partial(FCNVgg16, atrous=True),
    "FCN_Resnet50_32s": functools.partial(FCNResnet50, atrous=False),
    "AtrousFCN_Resnet50_16s": functools.partial(FCNResnet50, atrous=True),
    # 1/8-width variants (~2 M parameters): the shipped checkpoints' size.
    "FCN_Vgg16_32s_small": functools.partial(FCNVgg16, atrous=False, width_scale=0.125),
    "AtrousFCN_Vgg16_16s_small": functools.partial(FCNVgg16, atrous=True, width_scale=0.125),
}


def build_model(name: str, num_classes: int, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    return MODEL_ZOO[name](num_classes=num_classes, dtype=dtype)


# ------------------------------------------------------------- checkpoint I/O


def load_params_npz(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """A flat checkpoint .npz of the JAX package: ({"a/b/kernel": float32
    array, ...}, meta) with meta decoded from the `__meta__` entry ({} when
    absent). numpy only."""
    meta, flat = {}, {}
    with np.load(path) as z:
        for k in z.files:
            if k == "__meta__":
                meta = json.loads(z[k].tobytes().decode())
            else:
                flat[k] = np.asarray(z[k], dtype=np.float32)
    return flat, meta


def flax_to_state_dict(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The JAX package's flat parameter dict as this package's state_dict:
    "a/b/kernel" [kh, kw, in, out] -> "a.b.weight" [out, in, kh, kw];
    "a/b/scale" (GroupNorm) -> "a.b.weight"; "a/b/bias" -> "a.b.bias"."""
    out = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            arr, leaf = arr.transpose(3, 2, 0, 1), "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"unexpected parameter {key!r}")
        out[".".join(path + [leaf])] = torch.tensor(arr)
    return out


def state_dict_to_flax(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The inverse of flax_to_state_dict: this package's state_dict (or any
    dict keyed like it, such as the parameters' gradients) as the JAX
    package's flat parameter dict: a 4-D "a.b.weight" [out, in, kh, kw] ->
    "a/b/kernel" [kh, kw, in, out]; a 1-D "a.b.weight" (GroupNorm, the only
    1-D weight of the zoo and the detector) -> "a/b/scale"; biases keep
    their name. float32 numpy arrays on the host."""
    out = {}
    for key, value in state.items():
        *path, leaf = key.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight" and arr.ndim == 4:
            arr, leaf = arr.transpose(2, 3, 1, 0), "kernel"
        elif leaf == "weight" and arr.ndim == 1:
            leaf = "scale"
        elif leaf != "bias":
            raise ValueError(f"unexpected parameter {key!r}")
        out["/".join(path + [leaf])] = np.ascontiguousarray(arr)
    return out


def save_params_npz(path: str, model: nn.Module, meta: dict | None = None, dtype=None) -> None:
    """Save the model's parameters as the JAX package's flat .npz (Flax
    paths, HWIO kernels, GroupNorm `scale`), which both packages'
    load_params_npz read. meta goes into a `__meta__` uint8 JSON entry;
    dtype=np.float16 halves the file (load_params_npz casts back to
    float32)."""
    arrays = {k: (v.astype(dtype) if dtype is not None else v)
              for k, v in state_dict_to_flax(model.state_dict()).items()}
    if meta:
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_flax_params(model: nn.Module, flat: dict[str, np.ndarray]) -> nn.Module:
    """Load a flat Flax parameter dict into `model` (every parameter must be
    present, and nothing else); returns the model in eval mode."""
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    return model.eval()


_SHIPPED_CKPTS = {
    "small": "fcn_synth_apc.npz",  # width-scaled AtrousFCN_Vgg16_16s (2.1 M)
    "full": "fcn_synth_apc_vgg16_16s_full.npz",  # retired: no file ships
    "transfer": "fcn_synth_apc_transfer.npz",
    "prior": "fcn_synth_apc_prior.npz",  # product-appearance-prior training
}

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
                           "physimglobalpose_tpu", "models", "weights")


def shipped_checkpoint_path(variant: str = "small") -> str:
    """The in-repo synthetic-APC checkpoint of `variant` (the JAX package's
    weights directory, read as data)."""
    return os.path.normpath(os.path.join(WEIGHTS_DIR, _SHIPPED_CKPTS[variant]))


def load_shipped_predictor(input_size=(640, 640), variant: str = "small", tta_scales=(1.0,),
                           device=None):
    """The predictor of the shipped checkpoint, on the card unless
    device="cpu": the default for --segmentation FCN when no predictor is
    injected. Raises FileNotFoundError when the variant ships no file (the
    retired "full")."""
    path = shipped_checkpoint_path(variant)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no shipped FCN checkpoint at {path}")
    flat, meta = load_params_npz(path)
    model = load_flax_params(build_model(meta["model"], num_classes=meta["num_classes"]), flat)
    return make_predictor(model.to(_torchcfg.resolve_device(device)), input_size=input_size,
                          tta_scales=tta_scales)


# ---------------------------------------------------------------- serving


def _tta_probs(model: nn.Module, img: torch.Tensor, input_size, scales) -> torch.Tensor:
    """Softmax probabilities [C, h, w] of img [3, h, w] (float in [0, 1]),
    summed over the TTA scales: at 1.0 the image is padded to the serving
    canvas input_size; at another scale it is resized and padded to the net's
    stride-16 grid, and the probabilities cropped and resized back."""
    h, w = img.shape[-2:]
    ph, pw = input_size
    acc = None
    for s in scales:
        if s == 1.0:
            x, sh, sw, chs, cws = img[None], h, w, ph, pw
        else:
            sh, sw = int(round(h * s)), int(round(w * s))
            x = resize_bilinear(img[None], (sh, sw))
            chs, cws = (sh + 15) // 16 * 16, (sw + 15) // 16 * 16
        x = F.pad(x, (0, cws - sw, 0, chs - sh))
        logits = model(x)[0]
        probs = torch.softmax(logits[:, :sh, :sw].to(torch.float32), dim=0)
        if s != 1.0:
            probs = resize_bilinear(probs[None], (h, w))[0]
        acc = probs if acc is None else acc + probs
    return acc


def _image_tensor(color, device) -> torch.Tensor:
    """uint8 [h, w, 3] (clipped if another dtype) -> float [3, h, w] in [0, 1]
    on device; the upload is the uint8 image."""
    img = np.asarray(color)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    return torch.as_tensor(img).to(device).permute(2, 0, 1).to(torch.float32) / 255.0


def _param_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_labeler(model: nn.Module, height: int, width: int, input_size=(640, 640),
                 tta_scales=(1.0,)):
    """Full-class argmax labeler for evaluation (IoU against a GT class mask),
    with make_predictor's TTA. The model holds its weights and runs on its
    device. Returns labeler(color_u8 [h, w, 3]) -> int64 label [height, width]."""
    scales = tuple(tta_scales)
    if 1.0 not in scales:
        raise ValueError("tta_scales must include the native scale 1.0")

    def labeler(color):
        img = _image_tensor(np.asarray(color)[:height, :width], _param_device(model))
        with torch.no_grad():
            return torch.argmax(_tta_probs(model, img, input_size, scales), dim=0).cpu().numpy()

    return labeler


def make_predictor(model: nn.Module, input_size=(640, 640), tta_scales=(1.0,)):
    """An nn_predictor callable for pipeline/segmentation.py, serving as the
    reference `predict` node does: pad to the square canvas, softmax, the
    wanted classes max-normalized (predict:107-117), crop.

    The model holds its weights and runs on its device (the JAX function's
    params and unused class_ids arguments have no counterpart: the predictor
    takes the wanted ids per call). tta_scales averages the softmax over the
    image at each scale (fcn_tta: 0.5, 0.75, 1.0). All of it runs on the
    device; the uint8 image goes up, and three outputs come back: the wanted
    classes' maps as float16, the argmax class image (the plain FCN
    strategy's input) and the background channel's max-normalized map (the
    FCNThreshold gate).
    """
    scales = tuple(tta_scales)
    if 1.0 not in scales:
        raise ValueError("tta_scales must include the native scale 1.0")

    def run(img, idx):
        probs = _tta_probs(model, img, input_size, scales) / len(scales)
        sel = probs[idx]  # [k, h, w]
        m = torch.amax(sel, dim=(1, 2))
        sel = sel / torch.clamp(m, min=1e-20)[:, None, None]  # max == 0 stays all-zero
        label = torch.argmax(probs, dim=0).to(torch.uint8)
        bg = probs[0] / torch.clamp(torch.max(probs[0]), min=1e-20)
        return sel.to(torch.float16), label, bg.to(torch.float16)

    def predictor(color, wanted_ids):
        dev = _param_device(model)
        ids = [int(c) for c in wanted_ids]
        with torch.no_grad():
            sel, label, bg = run(_image_tensor(color, dev),
                                 torch.as_tensor(ids, dtype=torch.int64, device=dev))
        sel = sel.cpu().numpy().astype(np.float32)
        out = {c: sel[i] for i, c in enumerate(ids)}
        out[PREDICTOR_LABEL_KEY] = label.cpu().numpy().astype(np.int32)
        out[PREDICTOR_BACKGROUND_KEY] = bg.cpu().numpy().astype(np.float32)
        return out

    return predictor


# ---------------------------------------------------------------- training


def init_like_flax(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialise `model` in place as Flax initialises the JAX modules: every
    conv kernel lecun_normal (a normal of variance 1/fan_in truncated at two
    standard deviations), conv biases 0, GroupNorm scale 1 and bias 0. The
    draws come from a CPU torch.Generator seeded with `seed` (JAX's key
    stream is not reproduced). Returns the model."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
                # 0.8796...: the std of a unit normal truncated at +-2.
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                # Inverse-CDF draw of the truncated normal: u uniform on
                # [Phi(-2), Phi(2)], then sqrt(2) erfinv(2u - 1).
                lo, hi = 0.022750131948179195, 0.9772498680518208
                u = lo + (hi - lo) * torch.rand(mod.weight.shape, generator=gen)
                mod.weight.copy_(std * 2.0 ** 0.5 * torch.erfinv(2.0 * u - 1.0))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    return model


def softmax_xent_ignore_last(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sparse softmax cross-entropy ignoring the last class label.

    logits [..., C] (the JAX layout, classes last), labels [...] integer.
    Reference loss_function.py: pixels labeled num_classes (the "ignore"
    label) contribute nothing; the mean is over the other pixels.
    """
    num_classes = logits.shape[-1]
    valid = labels < num_classes
    safe = torch.where(valid, labels, 0).to(torch.int64)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer):
    """Returns train_step(images [B, H, W, 3] float, labels [B, H, W] int)
    -> the batch's loss before the update (a 0-d tensor), taking one
    optimizer step. The inputs are in the JAX package's layout and go to the
    model's device; torch.optim.Adam(params, lr) is optax.adam(lr) (b1 0.9,
    b2 0.999, eps 1e-8)."""

    def train_step(images, labels):
        dev = _param_device(model)
        x = torch.as_tensor(images, dtype=torch.float32).to(dev).permute(0, 3, 1, 2)
        y = torch.as_tensor(labels).to(dev)
        optimizer.zero_grad(set_to_none=True)
        loss = softmax_xent_ignore_last(model(x).permute(0, 2, 3, 1), y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
