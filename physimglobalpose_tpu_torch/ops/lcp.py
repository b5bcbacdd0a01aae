"""LCP / weighted-LCP verification: score H pose hypotheses at once.

Reference semantics (match4pcsBase.cc:1699-1766):
- Verify: fraction of (dense) model points whose transformed position has a
  scene-segment point within delta.
- WeightedVerify: same nearest-neighbour query, but a match only counts if
  the rotated model normal agrees with the matched segment point's normal
  within 30 degrees (folded: |cos| >= cos 30), and it contributes that
  segment point's segmentation probability instead of 1. Score normalized by
  model size.

Implementations of one function, in the segment-centred formulation:
- two CUDA kernels in csrc/lcp_segside.cu, which lcp_scores launches for
  tensors on the card: lcp_segside (one hypothesis at a time per block) and
  lcp_segside_hb (a group of hypotheses per block, for small models such as
  the coarse ranking pass); uses_hypothesis_block picks between them;
- lcp_scores_plain, plain PyTorch, which lcp_scores uses for tensors on the
  CPU and which the tests and chip_smoke.py hold the kernels against.
Exactly tied nearest distances take the max probability and the max |ndot|
(the TPU kernel's tie rule).

matmul_precision names the tier of the d^2 and normal-dot products, with the
rounding places of the TPU kernels: None / "highest" is float32; "default"
rounds both operands of each product to bf16 (float32 products and sums);
"high3" splits each operand into bf16 hi and lo parts and sums
hi*hi + hi*lo + lo*hi. Probabilities and the tie rule are float32 in every
tier. The hypothesis-block kernel has no "high3" tier and runs it in float32,
as the TPU kernel does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from physimglobalpose_tpu_torch import _build
from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)

# Largest segment the kernels hold in shared memory (96 KB packed in the
# weighted "high3" tier).
MAX_SEGMENT_POINTS = 2048
_BIG = 1e9
# matmul_precision -> the kernels' tier argument.
TIERS = {None: 0, "highest": 0, "default": 1, "high3": 2}


def segment_centroid(seg_pts, seg_mask):
    """Mean [3] of the unmasked segment points."""
    return torch.sum(torch.where(seg_mask[:, None], seg_pts, 0.0), dim=0) / torch.clamp(
        seg_mask.sum(), min=1
    )


def center_at_segment(transforms, seg_pts, seg_mask):
    """Shift segment and hypotheses to the masked segment centroid.

    Returns (centred seg_pts [Ns, 3], transforms with t - c [H, 4, 4]).
    """
    c = segment_centroid(seg_pts, seg_mask)
    tr = transforms.clone()
    tr[:, :3, 3] -= c
    return seg_pts - c, tr


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bf16 value, kept in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_bf16(x: torch.Tensor):
    """(hi, lo) bf16-valued float32 pair with hi + lo ~= x."""
    hi = round_bf16(x)
    return hi, round_bf16(x - hi)


def rotate_points(rot, pts, t=None):
    """(R p [+ t]) for rot [B, 3, 3], pts [N, 3], t [B, 3] -> [B, N, 3], as
    elementwise products and sums in the kernels' order ((r0 x + r1 y) + r2 z)
    + t, each rounded on its own, so the kernels' lowered tiers see the same
    float32 values before they round to bf16."""
    x, y, z = pts.unbind(-1)
    rows = []
    for k in range(3):
        v = (rot[:, k, 0, None] * x + rot[:, k, 1, None] * y) + rot[:, k, 2, None] * z
        rows.append(v if t is None else v + t[:, k, None])
    return torch.stack(rows, dim=-1)


def _lowered_products(rot, t, model_pts, model_nrm, seg_c, seg_sq, seg_nrm, tier, weighted):
    """d2 [B, Nv, Ns] and |ndot| (or None) of the "default" / "high3" tiers,
    term by term in the kernels' order: products of bf16 values are exact in
    float32, so this matches the kernels bit for bit."""
    u = rotate_points(rot, model_pts, t)
    usq = (u[..., 0] * u[..., 0] + u[..., 1] * u[..., 1]) + u[..., 2] * u[..., 2]
    a = -2.0 * u
    if tier == "default":
        s, a = round_bf16(seg_c), round_bf16(a)
        d2 = round_bf16(seg_sq) + round_bf16(usq)[..., None]
        for ax in (2, 1, 0):
            d2 = s[:, ax] * a[..., ax, None] + d2
    else:
        (sh, sl), (ah, al) = split_bf16(seg_c), split_bf16(a)
        (qh, ql), (uh, ul) = split_bf16(seg_sq), split_bf16(usq)
        d2 = (qh + ql) + (uh + ul)[..., None]
        for ax in (2, 1, 0):
            d2 = sl[:, ax] * ah[..., ax, None] + d2
            d2 = sh[:, ax] * al[..., ax, None] + d2
            d2 = sh[:, ax] * ah[..., ax, None] + d2
    if not weighted:
        return d2, None
    un = rotate_points(rot, model_nrm)
    if tier == "default":
        sn, un = round_bf16(seg_nrm), round_bf16(un)
        ndot = (sn[:, 0] * un[..., 0, None] + sn[:, 1] * un[..., 1, None]) + sn[:, 2] * un[..., 2, None]
    else:
        (nh, nl), (bh, bl) = split_bf16(seg_nrm), split_bf16(un)
        ndot = 0.0
        for ax in (0, 1, 2):
            ndot = nl[:, ax] * bh[..., ax, None] + ndot
            ndot = nh[:, ax] * bl[..., ax, None] + ndot
            ndot = nh[:, ax] * bh[..., ax, None] + ndot
    return d2, torch.abs(ndot)


def lcp_scores_plain(
    transforms: torch.Tensor,
    model_pts: torch.Tensor,
    model_nrm: torch.Tensor,
    seg_pts: torch.Tensor,
    seg_nrm: torch.Tensor,
    seg_prob: torch.Tensor,
    seg_mask: torch.Tensor,
    delta: float = 0.005,
    normal_gate_deg: float = 30.0,
    weighted: bool = True,
    h_chunk: int = 32,
    matmul_precision: str | None = None,
) -> torch.Tensor:
    """Plain PyTorch LCP scores [H], the same function as the kernels.

    Args:
      transforms: [H, 4, 4] model->scene candidate poses.
      model_pts/model_nrm: [Nv, 3] dense validation cloud (+unit normals).
      seg_pts/seg_nrm: [Ns, 3]; seg_prob/seg_mask: [Ns].
      matmul_precision: None / "highest", "default" or "high3" (module note).
    Hypotheses run in chunks of h_chunk so no [H, Nv, Ns] block is built whole.
    """
    tier = matmul_precision if TIERS[matmul_precision] else None
    nv = model_pts.shape[0]
    seg_c, tr = center_at_segment(transforms, seg_pts, seg_mask)
    seg_sq = torch.where(seg_mask, torch.sum(seg_c * seg_c, dim=-1), _BIG)
    cos_gate = math.cos(math.radians(normal_gate_deg))
    out = []
    for tc in tr.split(h_chunk):
        rot, t = tc[:, :3, :3], tc[:, :3, 3]
        if tier is None:
            u = torch.einsum("hij,nj->hni", rot, model_pts) + t[:, None, :]  # [hc, Nv, 3]
            usq = torch.sum(u * u, dim=-1)
            d2 = seg_sq + usq[..., None] - 2.0 * (u @ seg_c.T)  # [hc, Nv, Ns]
            ndot = None
            if weighted:
                un = torch.einsum("hij,nj->hni", rot, model_nrm)
                ndot = torch.abs(un @ seg_nrm.T)  # [hc, Nv, Ns]
        else:
            d2, ndot = _lowered_products(
                rot, t, model_pts, model_nrm, seg_c, seg_sq, seg_nrm, tier, weighted
            )
        m = torch.amin(d2, dim=-1)
        within = m <= delta * delta
        if not weighted:
            out.append(torch.sum(within, dim=-1) / nv)
            continue
        is_best = d2 <= m[..., None]
        prob_best = torch.amax(torch.where(is_best, seg_prob, -1.0), dim=-1)
        dot_best = torch.amax(torch.where(is_best, ndot, -1.0), dim=-1)
        contrib = torch.where(within & (dot_best >= cos_gate), prob_best, 0.0)
        out.append(torch.sum(contrib, dim=-1) / nv)
    return torch.cat(out).to(torch.float32)


def pad128(n: int) -> int:
    return n + (-n) % 128


def uses_hypothesis_block(nv: int, ns: int, hb_lane_pack: bool | None = None) -> bool:
    """Whether a call of this shape takes the hypothesis-block kernel.

    The JAX package's rule, copied so that a shape takes the same route in
    both packages: the hypothesis-block kernel when 8 models padded to 128
    fit a lane budget that shrinks with the segment (the coarse ranking
    shape), never when hb_lane_pack is False, and at any model size when
    hb_lane_pack is True as long as the budget leaves 128 lanes per
    hypothesis. The numbers are routing constants here, not memory sizes of
    the card.
    """
    if hb_lane_pack is False:
        return False
    budget_lanes = max(512, ((1 << 20) // (pad128(ns) + 256)) // 128 * 128)
    if 8 * pad128(nv) <= budget_lanes:
        return True
    return bool(hb_lane_pack) and (budget_lanes // 8) // 128 * 128 >= 128


def _launcher(symbol: str):
    fn = getattr(_build.load("lcp_segside"), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, symbol, tr12, model_pts, model_nrm, segcat, delta2, cos_gate,
            weighted, tier):
    name = wrapper.__name__
    tensors = (tr12, model_pts, model_nrm, segcat)
    dev = tr12.device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} takes CUDA tensors on one device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous float32 tensors")
    h, nv, ns = tr12.shape[0], model_pts.shape[0], segcat.shape[0]
    if tr12.shape != (h, 12) or model_pts.shape != (nv, 3) or model_nrm.shape != (nv, 3):
        raise ValueError(f"{name}: bad transform or model shape")
    if segcat.shape != (ns, 8):
        raise ValueError(f"{name}: segcat must be [Ns, 8]")
    if ns > MAX_SEGMENT_POINTS:
        raise NotImplementedError(
            f"segments above {MAX_SEGMENT_POINTS} points need the model-stationary "
            "kernel, which is not ported yet"
        )
    out = torch.empty(h, dtype=torch.float32, device=dev)
    rc = _launcher(symbol)(
        tr12.data_ptr(), model_pts.data_ptr(), model_nrm.data_ptr(), segcat.data_ptr(),
        out.data_ptr(), h, nv, ns, delta2, cos_gate, int(weighted), tier,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    wrapper.launches += 1
    wrapper.tier_launches[tier] += 1
    return out


def lcp_segside(
    tr12: torch.Tensor,
    model_pts: torch.Tensor,
    model_nrm: torch.Tensor,
    segcat: torch.Tensor,
    delta2: float,
    cos_gate: float,
    weighted: bool,
    matmul_precision: str | None = None,
) -> torch.Tensor:
    """Launch lcp_segside_kernel (csrc/lcp_segside.cu) on the current stream.

    Args:
      tr12: [H, 12] row-major (R | t) per hypothesis, in the centred frame.
      model_pts/model_nrm: [Nv, 3].
      segcat: [Ns, 8] packed centred segment: x, y, z, |s|^2 (1e9 where
        masked), nx, ny, nz, prob.
      matmul_precision: None / "highest", "default" or "high3".
    Returns scores [H] float32. Counts its launches in lcp_segside.launches
    and, per tier (fp32, "default", "high3"), in lcp_segside.tier_launches.
    """
    return _launch(lcp_segside, "lcp_segside_launch", tr12, model_pts, model_nrm, segcat,
                   delta2, cos_gate, weighted, TIERS[matmul_precision])


lcp_segside.launches = 0
lcp_segside.tier_launches = [0, 0, 0]


def lcp_segside_hb(
    tr12: torch.Tensor,
    model_pts: torch.Tensor,
    model_nrm: torch.Tensor,
    segcat: torch.Tensor,
    delta2: float,
    cos_gate: float,
    weighted: bool,
    matmul_precision: str | None = None,
) -> torch.Tensor:
    """Launch lcp_segside_hb_kernel, the hypothesis-block kernel: the same
    arguments and scores as lcp_segside, tiers None / "highest" and "default".
    Counts its launches in lcp_segside_hb.launches and .tier_launches."""
    if TIERS[matmul_precision] == 2:
        raise ValueError("lcp_segside_hb has no high3 tier")
    return _launch(lcp_segside_hb, "lcp_segside_hb_launch", tr12, model_pts, model_nrm,
                   segcat, delta2, cos_gate, weighted, TIERS[matmul_precision])


lcp_segside_hb.launches = 0
lcp_segside_hb.tier_launches = [0, 0, 0]


def pack_segment(seg_c, seg_nrm, seg_prob, seg_mask) -> torch.Tensor:
    """[Ns, 8] kernel layout of a centred segment."""
    seg_sq = torch.where(seg_mask, torch.sum(seg_c * seg_c, dim=-1), _BIG)
    return torch.cat(
        [seg_c, seg_sq[:, None], seg_nrm, seg_prob[:, None]], dim=1
    ).to(torch.float32).contiguous()


def lcp_scores(
    transforms,
    model_pts,
    model_nrm,
    seg_pts,
    seg_nrm,
    seg_prob,
    seg_mask,
    delta: float = 0.005,
    normal_gate_deg: float = 30.0,
    weighted: bool = True,
    matmul_precision: str | None = None,
    hb_lane_pack: bool | None = None,
) -> torch.Tensor:
    """LCP scores [H]: a CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU.

    matmul_precision: None / "highest", "default" or "high3" (module note).
    hb_lane_pack: None lets uses_hypothesis_block pick the kernel from the
    shape; True asks for the hypothesis-block kernel, False forbids it. On
    that route "high3" is computed in float32.
    """
    if matmul_precision not in TIERS:
        raise ValueError(f"unknown matmul_precision {matmul_precision!r}")
    hyp_block = uses_hypothesis_block(model_pts.shape[0], seg_pts.shape[0], hb_lane_pack)
    if hyp_block and matmul_precision == "high3":
        matmul_precision = None
    if transforms.device.type == "cpu":
        return lcp_scores_plain(
            transforms, model_pts, model_nrm, seg_pts, seg_nrm, seg_prob, seg_mask,
            delta=delta, normal_gate_deg=normal_gate_deg, weighted=weighted,
            matmul_precision=matmul_precision,
        )
    seg_c, tr = center_at_segment(transforms, seg_pts, seg_mask)
    kernel = lcp_segside_hb if hyp_block else lcp_segside
    return kernel(
        tr[:, :3, :].reshape(-1, 12).to(torch.float32).contiguous(),
        model_pts.to(torch.float32).contiguous(),
        model_nrm.to(torch.float32).contiguous(),
        pack_segment(seg_c, seg_nrm, seg_prob, seg_mask),
        float(delta) * float(delta),
        math.cos(math.radians(normal_gate_deg)),
        weighted,
        matmul_precision,
    )
