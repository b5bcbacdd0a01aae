"""LCP / weighted-LCP verification: score H pose hypotheses at once.

Reference semantics (match4pcsBase.cc:1699-1766):
- Verify: fraction of (dense) model points whose transformed position has a
  scene-segment point within delta.
- WeightedVerify: same nearest-neighbour query, but a match only counts if
  the rotated model normal agrees with the matched segment point's normal
  within 30 degrees (folded: |cos| >= cos 30), and it contributes that
  segment point's segmentation probability instead of 1. Score normalized by
  model size.

Two formulations of that score, each with CUDA kernels for tensors on the
card and a plain PyTorch version for tensors on the CPU, which the tests and
chip_smoke.py hold the kernels against. lcp_scores routes by segment size.

Segment-stationary, for segments of up to MAX_SEGMENT_POINTS points, in
coordinates centred at the segment:
- two CUDA kernels in csrc/lcp_segside.cu: lcp_segside (one hypothesis and
  one tile of model points per warp; its launcher takes the CUDA cores or,
  for the unweighted lowered tiers of large calls, finds the candidates on
  the tensor cores: the scores are the same bits) and lcp_segside_hb (a
  group of hypotheses per block, for small models such as the coarse ranking
  pass; its launcher takes the tensor cores for the unweighted "default"
  tier, the CUDA cores otherwise); uses_hypothesis_block picks between them;
- lcp_scores_plain, their plain version.
Exactly tied nearest distances take the max probability and the max |ndot|
over all ties (the TPU kernel's tie rule).

Streaming, for a segment of any size, in the model frame without centring
(lcp_scores_stream, lcp_scores_stream_wide): the segment passes by in tiles
of ns_tile points, each carried into the model frame of its hypothesis,
q = R^T (s - t), so that d2 = |m|^2 + |s - t|^2 - 2 m . q.
- two CUDA kernels in csrc/lcp_stream.cu: lcp_stream (one hypothesis and a
  tile of model points per block) and lcp_stream_wide (a group of hypotheses
  per block sharing the work on each segment tile);
- lcp_scores_stream_plain, their plain version.
Their tie rule depends on the tile: within a tile of ns_tile segment points
ties take the max probability and the max |ndot|, but a later tile replaces
the running nearest only when it is strictly nearer, so an equal distance in
a later tile is ignored (the TPU kernels' rule; ns_tile is an argument of the
function, not a tuning knob).

matmul_precision names the tier of the d^2 and normal-dot products, with the
rounding places of the TPU kernels: None / "highest" is float32; "default"
rounds both operands of each product to bf16 (float32 products and sums);
"high3" splits each operand into bf16 hi and lo parts and sums
hi*hi + hi*lo + lo*hi. Probabilities and the tie rule are float32 in every
tier. The hypothesis-block kernel and the streaming kernels have no "high3"
tier and run it in float32, as the TPU kernels do.
"""

from __future__ import annotations

import ctypes
import math

import torch

from physimglobalpose_tpu_torch import _build
from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)

# The routing constant, copied from the JAX package: a segment of up to this
# many points (padding included) takes the segment-stationary kernels, which
# hold it in shared memory (96 KB packed in the weighted "high3" tier); a
# larger one takes the streaming kernel.
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


def _plain_products(tc, model_pts, model_nrm, seg_c, seg_sq, seg_nrm, tier, weighted):
    """d2 [hc, Nv, Ns] and |ndot| (or None) of lcp_scores_plain for centred
    poses tc [hc, 4, 4]: a matrix product in float32, term by term in the
    lowered tiers (_lowered_products)."""
    rot, t = tc[:, :3, :3], tc[:, :3, 3]
    if tier is not None:
        return _lowered_products(rot, t, model_pts, model_nrm, seg_c, seg_sq, seg_nrm, tier,
                                 weighted)
    u = torch.einsum("hij,nj->hni", rot, model_pts) + t[:, None, :]  # [hc, Nv, 3]
    usq = torch.sum(u * u, dim=-1)
    d2 = seg_sq + usq[..., None] - 2.0 * (u @ seg_c.T)  # [hc, Nv, Ns]
    if not weighted:
        return d2, None
    un = torch.einsum("hij,nj->hni", rot, model_nrm)
    return d2, torch.abs(un @ seg_nrm.T)  # [hc, Nv, Ns]


def nearest_d2_plain(transforms, model_pts, seg_pts, seg_mask,
                     matmul_precision=None) -> torch.Tensor:
    """The nearest d2 [H, Nv] that lcp_scores_plain compares with delta^2,
    in its arithmetic for the tier (for constructing inputs on the edge)."""
    tier = matmul_precision if TIERS[matmul_precision] else None
    seg_c, tr = center_at_segment(transforms, seg_pts, seg_mask)
    seg_sq = torch.where(seg_mask, torch.sum(seg_c * seg_c, dim=-1), _BIG)
    return torch.cat([
        torch.amin(_plain_products(tc, model_pts, None, seg_c, seg_sq, None, tier, False)[0],
                   dim=-1)
        for tc in tr.split(32)])


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
        d2, ndot = _plain_products(tc, model_pts, model_nrm, seg_c, seg_sq, seg_nrm, tier,
                                   weighted)
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


def _launcher(symbol: str, head: list):
    """The C launcher `symbol` of csrc/lcp_segside.cu: arguments of the ctypes
    `head`, then H, Nv, Ns, delta^2, cos gate, weighted, tier, stream."""
    fn = getattr(_build.load("lcp_segside"), symbol)
    if fn.argtypes is None:
        fn.argtypes = head + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _check_launch_args(name, tr12, model_pts, model_nrm, segcat):
    """Raise on what the LCP kernels do not take; returns (H, Nv, Ns)."""
    dev = tr12.device
    for t in (tr12, model_pts, model_nrm, segcat):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} takes CUDA tensors on one device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous float32 tensors")
    h, nv, ns = tr12.shape[0], model_pts.shape[0], segcat.shape[0]
    if tr12.shape != (h, 12) or model_pts.shape != (nv, 3) or model_nrm.shape != (nv, 3):
        raise ValueError(f"{name}: bad transform or model shape")
    if segcat.shape != (ns, 8):
        raise ValueError(f"{name}: segcat must be [Ns, 8]")
    return h, nv, ns


def _count_launch(wrapper, rc, tier):
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed with CUDA error {rc}")
    wrapper.launches += 1
    wrapper.tier_launches[tier] += 1


def _launch(wrapper, symbol, tr12, model_pts, model_nrm, segcat, delta2, cos_gate,
            weighted, tier, tiled_sums=False, unit=None, after_out=()):
    """Check the arguments, launch `symbol` on the current stream and count
    it. tiled_sums: the kernel writes one partial sum per (hypothesis, model
    tile) into a workspace handed in before `out` (lcp_segside). unit: the
    launcher's leading argument, where it has one. after_out: pointers the
    launcher takes after `out`."""
    name = wrapper.__name__
    h, nv, ns = _check_launch_args(name, tr12, model_pts, model_nrm, segcat)
    if ns > MAX_SEGMENT_POINTS:
        raise ValueError(
            f"{name} holds at most {MAX_SEGMENT_POINTS} segment points in shared "
            "memory; a larger segment takes lcp_stream"
        )
    dev = tr12.device
    out = torch.empty(h, dtype=torch.float32, device=dev)
    head = [tr12.data_ptr(), model_pts.data_ptr(), model_nrm.data_ptr(), segcat.data_ptr()]
    if tiled_sums:
        n_tiles = _build.load("lcp_segside").lcp_segside_workspace_tiles(nv)
        partial = torch.empty((h, n_tiles), dtype=torch.float32, device=dev)
        head.append(partial.data_ptr())
    head += [out.data_ptr(), *after_out]
    types = [ctypes.c_void_p] * len(head)
    if unit is not None:
        head, types = [unit] + head, [ctypes.c_int] + types
    # The runtime launches on the host thread's current device: make it the
    # tensors' own, so a shard on cuda:1 runs in cuda:1's context.
    with torch.cuda.device(dev):
        rc = _launcher(symbol, types)(
            *head, h, nv, ns, delta2, cos_gate, int(weighted), tier,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _count_launch(wrapper, rc, tier)
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
                   delta2, cos_gate, weighted, TIERS[matmul_precision], tiled_sums=True)


lcp_segside.launches = 0
lcp_segside.tier_launches = [0, 0, 0]

# The units lcp_segside's launcher chooses between (csrc/lcp_segside.cu). The
# two functions below serve measurements and checks only; no caller in the
# package uses them.
_UNIT_CUDA_CORES, _UNIT_TENSOR_CORES = 1, 2


def _lcp_segside_on_unit(unit, tr12, model_pts, model_nrm, segcat, delta2, cos_gate, weighted,
                         matmul_precision=None) -> torch.Tensor:
    """lcp_segside with the launcher's choice of kernel taken away:
    _UNIT_CUDA_CORES, or _UNIT_TENSOR_CORES (the unweighted lowered tiers'
    filter on the tensor cores; the launcher refuses it for float32 and for a
    weighted call). Same arguments, same scores; counted as a launch of
    lcp_segside."""
    return _launch(lcp_segside, "lcp_segside_launch_on", tr12, model_pts, model_nrm, segcat,
                   delta2, cos_gate, weighted, TIERS[matmul_precision], tiled_sums=True,
                   unit=int(unit))


def _lcp_segside_unit_for(h: int, nv: int, ns: int, weighted: bool,
                          matmul_precision: str | None = None) -> int:
    """The unit lcp_segside's launcher takes for a call of this shape."""
    return _build.load("lcp_segside").lcp_segside_unit_for(
        h, nv, ns, int(weighted), TIERS[matmul_precision])


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

# The units lcp_segside_hb's launcher chooses between (csrc/lcp_segside.cu):
# the CUDA cores, and the tensor-core filter (unweighted "default" only). The
# functions below serve measurements and checks only.
_HB_UNIT_CUDA_CORES, _HB_UNIT_TENSOR_CORES = 1, 2


def _lcp_segside_hb_on_unit(unit, tr12, model_pts, model_nrm, segcat, delta2, cos_gate,
                            weighted, matmul_precision=None, band_rows=None) -> torch.Tensor:
    """lcp_segside_hb on a named unit: same arguments, same scores; counted
    as a launch of lcp_segside_hb. band_rows: None, or a one-element int32
    CUDA tensor to which the tensor-core filter adds the number of rows that
    walked the band between its two thresholds."""
    if TIERS[matmul_precision] == 2:
        raise ValueError("lcp_segside_hb has no high3 tier")
    extra = (0 if band_rows is None else band_rows.data_ptr(),)
    return _launch(lcp_segside_hb, "lcp_segside_hb_launch_on", tr12, model_pts, model_nrm,
                   segcat, delta2, cos_gate, weighted, TIERS[matmul_precision], unit=int(unit),
                   after_out=extra)


def _lcp_segside_hb_unit_for(weighted: bool, matmul_precision: str | None = None) -> int:
    """The unit lcp_segside_hb's launcher takes for such a call."""
    return _build.load("lcp_segside").lcp_segside_hb_unit_for(
        int(weighted), TIERS[matmul_precision])


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

    A segment of up to MAX_SEGMENT_POINTS points takes the segment-stationary
    formulation, a larger one the streaming one (lcp_scores_stream): the JAX
    package's rule, by the shape handed in, padding included.
    matmul_precision: None / "highest", "default" or "high3" (module note).
    hb_lane_pack: None lets uses_hypothesis_block pick the kernel from the
    shape; True asks for the hypothesis-block kernel, False forbids it. On
    that route and on the streaming one "high3" is computed in float32;
    hb_lane_pack does not apply to the streaming route.
    """
    if matmul_precision not in TIERS:
        raise ValueError(f"unknown matmul_precision {matmul_precision!r}")
    if seg_pts.shape[0] > MAX_SEGMENT_POINTS:
        return lcp_scores_stream(
            transforms, model_pts, model_nrm, seg_pts, seg_nrm, seg_prob, seg_mask,
            delta=delta, normal_gate_deg=normal_gate_deg, weighted=weighted,
            matmul_precision=matmul_precision,
        )
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


# ------------------------------------------------------- streaming formulation

# Segment points per tile, as the TPU wrappers set them: the streaming kernel
# takes min(1024, pad128(Ns)), the wide kernel 128.
STREAM_NS_TILE = 1024
STREAM_WIDE_NS_TILE = 128


def stream_ns_tile(ns: int, ns_tile: int = STREAM_NS_TILE) -> int:
    """The tile the streaming kernel uses for a segment of ns points."""
    return min(ns_tile, pad128(ns))


def _stream_tier(matmul_precision, wide: bool = False):
    """matmul_precision of a streaming call -> None or "default"."""
    if matmul_precision not in TIERS:
        raise ValueError(f"unknown matmul_precision {matmul_precision!r}")
    if matmul_precision == "high3":
        if wide:
            raise ValueError("lcp_scores_stream_wide has no high3 tier")
        return None  # the streaming kernel degrades it to float32
    return matmul_precision if TIERS[matmul_precision] else None


def _rotate_rows(rot, v):
    """rot [B, 3, 3] applied to v [B, N, 3] row by row, ((r0 x + r1 y) + r2 z)
    with every product and sum rounded on its own (the kernels' order)."""
    x, y, z = v.unbind(-1)
    return torch.stack(
        [(rot[:, k, 0, None] * x + rot[:, k, 1, None] * y) + rot[:, k, 2, None] * z
         for k in range(3)], dim=-1)


def fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x * y + z rounded once to float32, the card's fused multiply-add: the
    product of two float32 values is exact in float64, and rounding the
    float64 sum to float32 gives the fused result (but for a double rounding
    about once in 2^29)."""
    return (x.double() * y.double() + z.double()).to(torch.float32)


def _plain_block_values(device) -> int:
    """Values per elementwise block of the streaming plain versions: small
    enough for the cache on the CPU, large enough to keep the number of
    launches down on the card."""
    return 1 << (20 if device.type == "cpu" else 24)


def lcp_scores_stream_plain(
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
    ns_tile: int = STREAM_NS_TILE,
    matmul_precision: str | None = None,
    h_chunk: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the streaming kernels: LCP scores [H] for a
    segment of any size (arguments as lcp_scores_plain).

    Per hypothesis the segment is carried into the model frame,
    q = R^T (s - t), c = |s - t|^2 (1e9 where masked), bn = R^T n_s, and
    d2 = (c + |m|^2) - 2 m . q, |ndot| = |n_m . bn|, summed term by term in
    the kernels' order with their fused multiply-adds (fma), so both find the
    same nearest points in every tier. The segment passes by in tiles of
    stream_ns_tile(Ns, ns_tile) points: within a tile exact ties take the max
    probability and the max |ndot|; a later tile replaces the running nearest
    only when strictly nearer. "default" rounds both operands of the two
    products to bf16: (m, |m|^2, n_m) and (-2q, c, bn); "high3" is computed in
    float32. Hypotheses run in chunks of h_chunk (by default so that a
    [h_chunk, Nv, tile] block holds _plain_block_values values).
    """
    lowp = _stream_tier(matmul_precision) == "default"
    nv, ns = model_pts.shape[0], seg_pts.shape[0]
    tile = stream_ns_tile(ns, ns_tile)
    if h_chunk is None:
        h_chunk = max(1, _plain_block_values(transforms.device) // (nv * tile))
    cos_gate = math.cos(math.radians(normal_gate_deg))
    op = round_bf16 if lowp else (lambda x: x)
    mx, my, mz = model_pts.unbind(-1)
    m = op(model_pts)
    msq = op((mx * mx + my * my) + mz * mz)
    mn = op(model_nrm)
    out = []
    for tc in transforms.split(h_chunk):
        rot_t, t = tc[:, :3, :3].transpose(1, 2), tc[:, :3, 3]
        d = seg_pts[None, :, :] - t[:, None, :]  # [hc, Ns, 3]
        a = op(-2.0 * _rotate_rows(rot_t, d))
        c = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        c = op(torch.where(seg_mask, c, _BIG))  # [hc, Ns]
        bn = op(rotate_points(rot_t, seg_nrm)) if weighted else None
        run_min = torch.full((tc.shape[0], nv), _BIG, dtype=torch.float32, device=tc.device)
        run_prob = torch.zeros_like(run_min)
        run_dot = torch.zeros_like(run_min)
        for s0 in range(0, ns, tile):
            sl = slice(s0, min(s0 + tile, ns))
            d2 = c[:, None, sl] + msq[None, :, None]  # [hc, Nv, tile]
            for ax in (2, 1, 0):
                d2 = fma(m[None, :, ax, None], a[:, None, sl, ax], d2)
            tile_min = torch.amin(d2, dim=-1)
            better = tile_min < run_min
            run_min = torch.where(better, tile_min, run_min)
            if not weighted:
                continue
            ndot = mn[None, :, 0, None] * bn[:, None, sl, 0]
            for ax in (1, 2):
                ndot = fma(mn[None, :, ax, None], bn[:, None, sl, ax], ndot)
            is_best = d2 <= tile_min[..., None]
            tile_prob = torch.amax(torch.where(is_best, seg_prob[sl], -1.0), dim=-1)
            tile_dot = torch.amax(torch.where(is_best, torch.abs(ndot), -1.0), dim=-1)
            run_prob = torch.where(better, tile_prob, run_prob)
            run_dot = torch.where(better, tile_dot, run_dot)
        within = run_min <= delta * delta
        if weighted:
            contrib = torch.where(within & (run_dot >= cos_gate), run_prob, 0.0)
        else:
            contrib = within.to(torch.float32)
        out.append(torch.sum(contrib, dim=-1) / nv)
    return torch.cat(out).to(torch.float32)


def pack_stream_segment(seg_pts, seg_nrm, seg_prob, seg_mask) -> torch.Tensor:
    """[Ns, 8] layout of the streaming kernels: x, y, z, mask (1 or 0), nx,
    ny, nz, prob, in the scene frame as given."""
    return torch.cat(
        [seg_pts, seg_mask.to(torch.float32)[:, None], seg_nrm, seg_prob[:, None]], dim=1
    ).to(torch.float32).contiguous()


def _stream_launcher(symbol: str):
    fn = getattr(_build.load("lcp_stream"), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _launch_stream(wrapper, symbol, model_tile, tr12, model_pts, model_nrm,
                   segcat, delta2, cos_gate, weighted, matmul_precision, ns_tile):
    name = wrapper.__name__
    tier = TIERS.get(matmul_precision)
    if tier not in (0, 1):
        raise ValueError(f"{name} has no {matmul_precision!r} tier")
    h, nv, ns = _check_launch_args(name, tr12, model_pts, model_nrm, segcat)
    if ns_tile < 1:
        raise ValueError(f"{name}: ns_tile must be positive")
    dev = tr12.device
    out = torch.empty(h, dtype=torch.float32, device=dev)
    # One partial sum per (hypothesis, model tile); the launcher's second
    # kernel adds them per hypothesis in tile order.
    n_tiles = -(-nv // model_tile)
    partial = torch.empty((h, n_tiles), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # launch in the tensors' own context
        rc = _stream_launcher(symbol)(
            tr12.data_ptr(), model_pts.data_ptr(), model_nrm.data_ptr(), segcat.data_ptr(),
            partial.data_ptr(), out.data_ptr(), h, nv, ns, int(ns_tile), delta2, cos_gate,
            int(weighted), tier, torch.cuda.current_stream(dev).cuda_stream,
        )
    _count_launch(wrapper, rc, tier)
    return out


# Model points a block of each streaming kernel takes (kThreads * kSlots and
# 32 * kWidePts in csrc/lcp_stream.cu).
_STREAM_MODEL_TILE, _STREAM_WIDE_MODEL_TILE = 1024, 256


def lcp_stream(
    tr12: torch.Tensor,
    model_pts: torch.Tensor,
    model_nrm: torch.Tensor,
    segcat: torch.Tensor,
    delta2: float,
    cos_gate: float,
    weighted: bool,
    matmul_precision: str | None = None,
    ns_tile: int = STREAM_NS_TILE,
) -> torch.Tensor:
    """Launch lcp_stream_kernel (csrc/lcp_stream.cu) on the current stream.

    Args:
      tr12: [H, 12] row-major (R | t) per hypothesis, in the scene frame.
      model_pts/model_nrm: [Nv, 3].
      segcat: [Ns, 8] from pack_stream_segment, any Ns.
      matmul_precision: None / "highest" or "default".
      ns_tile: segment points per tile of the tie rule (module note).
    Returns scores [H] float32. Counts its launches in lcp_stream.launches and,
    per tier (fp32, "default"), in lcp_stream.tier_launches.
    """
    return _launch_stream(lcp_stream, "lcp_stream_launch", _STREAM_MODEL_TILE, tr12,
                          model_pts, model_nrm, segcat, delta2, cos_gate, weighted,
                          matmul_precision, ns_tile)


lcp_stream.launches = 0
lcp_stream.tier_launches = [0, 0, 0]


def lcp_stream_wide(
    tr12: torch.Tensor,
    model_pts: torch.Tensor,
    model_nrm: torch.Tensor,
    segcat: torch.Tensor,
    delta2: float,
    cos_gate: float,
    weighted: bool,
    matmul_precision: str | None = None,
    ns_tile: int = STREAM_WIDE_NS_TILE,
) -> torch.Tensor:
    """Launch lcp_stream_wide_kernel, a group of hypotheses per block: the
    same arguments and scores as lcp_stream. Counts its launches in
    lcp_stream_wide.launches and .tier_launches."""
    return _launch_stream(lcp_stream_wide, "lcp_stream_wide_launch", _STREAM_WIDE_MODEL_TILE,
                          tr12, model_pts, model_nrm, segcat, delta2, cos_gate, weighted,
                          matmul_precision, ns_tile)


lcp_stream_wide.launches = 0
lcp_stream_wide.tier_launches = [0, 0, 0]


def _scores_stream(kernel, tier, ns_tile, transforms, model_pts, model_nrm, seg_pts, seg_nrm,
                   seg_prob, seg_mask, delta, normal_gate_deg, weighted):
    if transforms.device.type == "cpu":
        return lcp_scores_stream_plain(
            transforms, model_pts, model_nrm, seg_pts, seg_nrm, seg_prob, seg_mask,
            delta=delta, normal_gate_deg=normal_gate_deg, weighted=weighted,
            ns_tile=ns_tile, matmul_precision=tier,
        )
    return kernel(
        transforms[:, :3, :].reshape(-1, 12).to(torch.float32).contiguous(),
        model_pts.to(torch.float32).contiguous(),
        model_nrm.to(torch.float32).contiguous(),
        pack_stream_segment(seg_pts, seg_nrm, seg_prob, seg_mask),
        float(delta) * float(delta),
        math.cos(math.radians(normal_gate_deg)),
        weighted, tier, ns_tile,
    )


def lcp_scores_stream(
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
    ns_tile: int = STREAM_NS_TILE,
    matmul_precision: str | None = None,
) -> torch.Tensor:
    """Streaming LCP scores [H] for a segment of any size (the JAX package's
    lcp_scores_pallas): lcp_stream for tensors on the card,
    lcp_scores_stream_plain for tensors on the CPU. The tile of the tie rule
    is stream_ns_tile(Ns, ns_tile); "high3" is computed in float32."""
    return _scores_stream(
        lcp_stream, _stream_tier(matmul_precision), stream_ns_tile(seg_pts.shape[0], ns_tile),
        transforms, model_pts, model_nrm, seg_pts, seg_nrm, seg_prob, seg_mask,
        delta, normal_gate_deg, weighted)


def lcp_scores_stream_wide(
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
    ns_tile: int = STREAM_WIDE_NS_TILE,
) -> torch.Tensor:
    """The streaming score with a group of hypotheses per block (the JAX
    package's experimental lcp_scores_pallas_wide): lcp_stream_wide for
    tensors on the card, lcp_scores_stream_plain for tensors on the CPU. The
    tile of the tie rule is ns_tile itself (128 as in the TPU wrapper); tiers
    None / "highest" and "default". lcp_scores never routes here."""
    return _scores_stream(
        lcp_stream_wide, _stream_tier(matmul_precision, wide=True), ns_tile,
        transforms, model_pts, model_nrm, seg_pts, seg_nrm, seg_prob, seg_mask,
        delta, normal_gate_deg, weighted)
