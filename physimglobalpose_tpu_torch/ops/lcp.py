"""LCP / weighted-LCP verification: score H pose hypotheses at once.

Reference semantics (match4pcsBase.cc:1699-1766):
- Verify: fraction of (dense) model points whose transformed position has a
  scene-segment point within delta.
- WeightedVerify: same nearest-neighbour query, but a match only counts if
  the rotated model normal agrees with the matched segment point's normal
  within 30 degrees (folded: |cos| >= cos 30), and it contributes that
  segment point's segmentation probability instead of 1. Score normalized by
  model size.

Two implementations of one function, in the segment-centred formulation:
- the CUDA kernel csrc/lcp_segside.cu (lcp_segside below), which lcp_scores
  launches for tensors on the card;
- lcp_scores_plain, plain PyTorch, which lcp_scores uses for tensors on the
  CPU and which the tests and chip_smoke.py hold the kernel against.
Exactly tied nearest distances take the max probability and the max |ndot|
(the TPU kernel's tie rule).
"""

from __future__ import annotations

import ctypes
import math

import torch

from physimglobalpose_tpu_torch import _build
from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)

# Largest segment the kernel holds in shared memory (64 KB packed).
MAX_SEGMENT_POINTS = 2048
_BIG = 1e9


def center_at_segment(transforms, seg_pts, seg_mask):
    """Shift segment and hypotheses to the masked segment centroid.

    Returns (centred seg_pts [Ns, 3], transforms with t - c [H, 4, 4]).
    """
    c = torch.sum(torch.where(seg_mask[:, None], seg_pts, 0.0), dim=0) / torch.clamp(
        seg_mask.sum(), min=1
    )
    tr = transforms.clone()
    tr[:, :3, 3] -= c
    return seg_pts - c, tr


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
) -> torch.Tensor:
    """Plain PyTorch LCP scores [H], the same function as the kernel.

    Args:
      transforms: [H, 4, 4] model->scene candidate poses.
      model_pts/model_nrm: [Nv, 3] dense validation cloud (+unit normals).
      seg_pts/seg_nrm: [Ns, 3]; seg_prob/seg_mask: [Ns].
    Hypotheses run in chunks of h_chunk so no [H, Nv, Ns] block is built whole.
    """
    nv = model_pts.shape[0]
    seg_c, tr = center_at_segment(transforms, seg_pts, seg_mask)
    seg_sq = torch.where(seg_mask, torch.sum(seg_c * seg_c, dim=-1), _BIG)
    cos_gate = math.cos(math.radians(normal_gate_deg))
    out = []
    for tc in tr.split(h_chunk):
        rot, t = tc[:, :3, :3], tc[:, :3, 3]
        u = torch.einsum("hij,nj->hni", rot, model_pts) + t[:, None, :]  # [hc, Nv, 3]
        usq = torch.sum(u * u, dim=-1)
        d2 = seg_sq + usq[..., None] - 2.0 * (u @ seg_c.T)  # [hc, Nv, Ns]
        m = torch.amin(d2, dim=-1)
        within = m <= delta * delta
        if not weighted:
            out.append(torch.sum(within, dim=-1) / nv)
            continue
        un = torch.einsum("hij,nj->hni", rot, model_nrm)
        ndot = torch.abs(un @ seg_nrm.T)  # [hc, Nv, Ns]
        is_best = d2 <= m[..., None]
        prob_best = torch.amax(torch.where(is_best, seg_prob, -1.0), dim=-1)
        dot_best = torch.amax(torch.where(is_best, ndot, -1.0), dim=-1)
        contrib = torch.where(within & (dot_best >= cos_gate), prob_best, 0.0)
        out.append(torch.sum(contrib, dim=-1) / nv)
    return torch.cat(out).to(torch.float32)


def _launcher():
    fn = _build.load("lcp_segside").lcp_segside_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def lcp_segside(
    tr12: torch.Tensor,
    model_pts: torch.Tensor,
    model_nrm: torch.Tensor,
    segcat: torch.Tensor,
    delta2: float,
    cos_gate: float,
    weighted: bool,
) -> torch.Tensor:
    """Launch csrc/lcp_segside.cu on the current stream.

    Args:
      tr12: [H, 12] row-major (R | t) per hypothesis, in the centred frame.
      model_pts/model_nrm: [Nv, 3].
      segcat: [Ns, 8] packed centred segment: x, y, z, |s|^2 (1e9 where
        masked), nx, ny, nz, prob.
    Returns scores [H] float32. Counts its launches in lcp_segside.launches.
    """
    tensors = (tr12, model_pts, model_nrm, segcat)
    dev = tr12.device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("lcp_segside takes CUDA tensors on one device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("lcp_segside takes contiguous float32 tensors")
    h, nv, ns = tr12.shape[0], model_pts.shape[0], segcat.shape[0]
    if tr12.shape != (h, 12) or model_pts.shape != (nv, 3) or model_nrm.shape != (nv, 3):
        raise ValueError("lcp_segside: bad transform or model shape")
    if segcat.shape != (ns, 8):
        raise ValueError("lcp_segside: segcat must be [Ns, 8]")
    if ns > MAX_SEGMENT_POINTS:
        raise NotImplementedError(
            f"segments above {MAX_SEGMENT_POINTS} points need the model-stationary "
            "kernel, which is not ported yet"
        )
    out = torch.empty(h, dtype=torch.float32, device=dev)
    rc = _launcher()(
        tr12.data_ptr(), model_pts.data_ptr(), model_nrm.data_ptr(), segcat.data_ptr(),
        out.data_ptr(), h, nv, ns, delta2, cos_gate, int(weighted),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lcp_segside launch failed with CUDA error {rc}")
    lcp_segside.launches += 1
    return out


lcp_segside.launches = 0


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
) -> torch.Tensor:
    """LCP scores [H]: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU.

    matmul_precision: None / "highest" is the fp32 tier. The lower tiers of
    the TPU kernel ("default", "high3") are not ported to the card yet and
    raise there; on the CPU every tier is computed in fp32.
    """
    if transforms.device.type == "cpu":
        return lcp_scores_plain(
            transforms, model_pts, model_nrm, seg_pts, seg_nrm, seg_prob, seg_mask,
            delta=delta, normal_gate_deg=normal_gate_deg, weighted=weighted,
        )
    if matmul_precision not in (None, "highest"):
        raise NotImplementedError(
            f"matmul_precision={matmul_precision!r} is not ported to the CUDA kernel yet"
        )
    seg_c, tr = center_at_segment(transforms, seg_pts, seg_mask)
    return lcp_segside(
        tr[:, :3, :].reshape(-1, 12).to(torch.float32).contiguous(),
        model_pts.to(torch.float32).contiguous(),
        model_nrm.to(torch.float32).contiguous(),
        pack_segment(seg_c, seg_nrm, seg_prob, seg_mask),
        float(delta) * float(delta),
        math.cos(math.radians(normal_gate_deg)),
        weighted,
    )
