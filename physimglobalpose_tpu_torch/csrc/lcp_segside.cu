// Weighted / unweighted LCP scores of H rigid hypotheses, segment-stationary:
// kernels that compute one function.
//
//   lcp_segside_launch     replaces the TPU kernel
//       physimglobalpose_tpu/ops/lcp.py::_lcp_kernel_segside
//     (tiers fp32 / "default" / "high3") with lcp_segside_kernel, one hypothesis
//     and one model tile per warp on the CUDA cores, or, for the unweighted
//     lowered tiers of large calls, with lcp_segside_mma_kernel, which finds the
//     candidates on the tensor cores;
//   lcp_segside_hb_launch  replaces
//       physimglobalpose_tpu/ops/lcp.py::_lcp_kernel_segside_hb
//     (a group of hypotheses per block, tiers fp32 / "default"; whole-model and
//     model-tiled modes of the TPU kernel are one loop over model tiles here)
//     with lcp_segside_hb_mma_kernel for the unweighted "default" tier (the
//     coarse ranking call), which finds the candidates on the tensor cores,
//     and with lcp_segside_hb_kernel on the CUDA cores for the rest.
//
// For each hypothesis (R, t) and each model point m_i, u_i = R m_i + t; the
// nearest segment point j* minimises
//   d2 = |s_j|^2 + |u_i|^2 - 2 s_j . u_i
// (the same expansion as the TPU kernels, so both round alike). Masked or padded
// segment points carry |s|^2 = 1e9 and never match (lcp_segside_kernel leaves
// them out when it stages the segment; the other kernels scan them). The point
// contributes
//   unweighted: 1[d2* <= delta^2]
//   weighted:   1[d2* <= delta^2] * 1[|n_j* . R n_i| >= cos_gate] * prob_j*,
// where exact ties in d2 take the max prob and the max |ndot| (the TPU
// kernel's global min followed by max over ties). score = sum / Nv.
// Coordinates arrive centred at the masked segment centroid (the wrapper
// shifts t), which keeps |s|^2 and s.u at segment scale.
//
// Tiers (the rounding places of the TPU kernels' matmul_precision):
//   fp32      every operand and product in float32;
//   "default" both operands of the d2 product (s, |s|^2, -2u, |u|^2) and of the
//             normal dot are rounded to bf16, products and sums in float32;
//   "high3"   each operand split hi = bf16(x), lo = bf16(x - hi); every term is
//             s_hi a_hi + s_hi a_lo + s_lo a_hi (three products instead of one).
// The probabilities and the tie rule are float32 in every tier. A product of two
// bf16 values is exact in float32, so round + fmaf on the CUDA cores is the same
// function as a bf16 matrix pass with a float32 sum, up to the order of the sum.
// The segment side is rounded once when it is staged into shared memory, the
// model side once per (hypothesis, point) in registers. u, |u|^2 and R n are
// computed with separately rounded products and sums in a fixed order, so the
// plain PyTorch version reproduces the lowered tiers' d2 bit for bit.
//
// What bounds them: the instruction rate of the CUDA cores. Per (hypothesis, model
// point, segment point) pair the fp32 and "default" tiers execute 1 add + 3 FMA +
// the running min (5 instructions, counted as 8 FLOP), "high3" 1 add + 9 FMA + the
// min (about 20 FLOP). Against the 67 TFLOP/s fp32 peak of an H100 SXM the inputs
// (a few hundred KB) make memory traffic negligible. On the CUDA cores "default"
// costs what fp32 costs and "high3" more.
// What the design does about it:
//  - a block loads the packed segment into shared memory once ([Ns] float4
//    positions, [Ns] float4 lo parts for "high3", [Ns] float4 normals/prob when
//    weighted; above 48 KB through the dynamic shared memory opt-in);
//  - every thread keeps its (hypothesis, model point) pairs in registers, so
//    each broadcast shared-memory read of a segment point feeds that many
//    independent FMA chains;
//  - lcp_segside_kernel: the unit of work is one warp on one (hypothesis, model
//    tile of 32 * kS points); kS = 8, 4 or 2 follows Nv so that at most a quarter
//    of the slots hold padding (Nv = 256 fills kS = 8 exactly; a call of few
//    items takes 4 in place of 8), and the grid covers H x model tiles whatever
//    H is: 32 hypotheses of 4,096 points are 1,024 warps on 256 blocks, not 8
//    blocks. After the segment is staged the warps of a block never meet again.
//    A block stages only the segment's valid points, in index order from slot
//    0 (a ballot per warp, a prefix over the block's warps), and its scans stop
//    at their count rounded up to a chunk: a padded segment costs what its
//    valid points cost, and every block finds the same count, so it never
//    leaves the device (block 0 adds it to the caller's counter). The order
//    does not move a score: the nearest d2 is an exact minimum and ties take
//    maxima.
//    A call with many items gives a warp four of them in turn, so the staging
//    is shared by more work. A warp writes one partial sum per item; a second
//    kernel adds a hypothesis's tiles in index order (a model of one tile is
//    written straight out);
//  - its weighted variant runs the unweighted inner loop: only the running
//    minimum, taken over chunks of 32 segment points. After a chunk two
//    compares per slot keep a bit mask of the chunks that reached the minimum
//    (a nearer chunk resets it, an equal one joins: in the lowered tiers equal
//    d2 are common). After the scan a slot within delta^2 recomputes d2 over
//    those chunks with the same instructions, hence the same bits, and takes
//    prob and |ndot| of every point that equals the minimum; the model normal
//    is rotated and the normal dot taken only there. The pose and the normals
//    of all such slots are loaded first, so their latencies overlap, and a
//    chunk's 32 compares fill a bit mask with no branch: at H 10,000, Nv 4,096
//    and 210 valid points this pass takes ~0.8 ms where it took ~2.2 (H100).
//    The lanes walk their chunks in rotated order so that 32 different chunks
//    are read without bank conflicts; the order does not matter, the tie rule
//    is a max. ptxas gives the weighted variants 123 / 123 / 165 registers at
//    kS = 8 (fp32 / "default" / "high3") and 64 / 64 / 103 at kS = 4 (28
//    bytes spilled in the first two), the unweighted 64 / 64 / 101 at kS = 8;
//  - lcp_segside_mma_kernel (unweighted): in the lowered tiers d2 is a product
//    of bf16 operands, which one mma.sync computes for 16 model points x 8
//    segment points, leaving one min per pair to the CUDA cores. The matrix
//    unit only finds candidates; the exact minimum is taken with the chain
//    above (its own note below), so the scores are the same bits on either
//    unit. A weighted variant of it measured slower than the chunk scan at
//    every shape (PERF.md) and is not built;
//  - lcp_segside_hb_kernel gives a thread one model point under kHbSlots = 4
//    hypotheses of its block's group (two groups of threads a block) and runs
//    lcp_segside_kernel's scans on them: the running minimum alone, and when
//    weighted the chunk mask and the attributes after the scan (no per-pair
//    branch). The scan it replaced held 8 hypotheses a thread and branched per
//    pair: 171 registers unweighted and 224 / 228 weighted, one block an SM;
//  - lcp_segside_hb_mma_kernel (unweighted "default"): lcp_segside_mma_kernel's
//    filter for a hypothesis group (its own note below);
//  - per-hypothesis sums are a warp-shuffle tree and a fixed-order sum: no
//    atomics, so scores are deterministic.
// TMA and wgmma are not used here: K is 8 or 16, one mma.sync deep, and the
// operands of a tile are built by the block itself, not copied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;     // the hypothesis-block kernels; the most lcp_segside_kernel takes
constexpr int kHypGroup = 8;      // the hypothesis-block kernels: hypotheses a block takes together
constexpr int kHbSlots = 4;       // lcp_segside_hb_kernel: hypotheses a thread holds its point under
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;        // lcp_segside_kernel: segment points a chunk of the weighted scan
constexpr int kItemsPerWarp = 4;  // the warp-item kernels: items a warp takes in a large call
constexpr int kSMs = 132;         // H100 SXM; only sizes the grid
constexpr float kMasked = 1e9f;   // |s|^2 of a masked point (ops/lcp.py _BIG)

constexpr int kFp32 = 0;
constexpr int kBf16 = 1;
constexpr int kHigh3 = 2;

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (a x + b y) + c z with every product and sum rounded on its own: no FMA
// contraction, so an elementwise PyTorch expression gives the same bits.
__device__ __forceinline__ float dot3_rn(float a, float x, float b, float y, float c, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

// One (hypothesis, model point) pair: the model-side operands of the d2
// product per tier, the rotated normal (set where a weighted score needs it),
// and the running nearest d2.
struct Slot {
  float ax, ay, az;  // -2u: fp32 | bf16(-2u) | hi part
  float lx, ly, lz;  // "high3" only: lo part of -2u
  float uq;          // |u|^2: fp32 | bf16 | hi + lo
  float uql;         // "high3" only: lo part of |u|^2 (the hi part is uq - uql)
  float nx, ny, nz;  // R n: fp32 | bf16 | fp32 (split where it is used)
  float best;
};

// R n as the normal dot of the tier takes it.
template <int kTier>
__device__ __forceinline__ void rotate_normal(Slot& s, const float* r, float mnx, float mny,
                                              float mnz) {
  s.nx = dot3_rn(r[0], mnx, r[1], mny, r[2], mnz);
  s.ny = dot3_rn(r[4], mnx, r[5], mny, r[6], mnz);
  s.nz = dot3_rn(r[8], mnx, r[9], mny, r[10], mnz);
  if constexpr (kTier == kBf16) {
    s.nx = bf(s.nx); s.ny = bf(s.ny); s.nz = bf(s.nz);
  }
}

template <int kTier>
__device__ __forceinline__ void make_slot(Slot& s, const float* r, float mx, float my, float mz) {
  const float ux = __fadd_rn(dot3_rn(r[0], mx, r[1], my, r[2], mz), r[3]);
  const float uy = __fadd_rn(dot3_rn(r[4], mx, r[5], my, r[6], mz), r[7]);
  const float uz = __fadd_rn(dot3_rn(r[8], mx, r[9], my, r[10], mz), r[11]);
  const float ax = -2.f * ux, ay = -2.f * uy, az = -2.f * uz;
  const float usq = dot3_rn(ux, ux, uy, uy, uz, uz);
  if constexpr (kTier == kFp32) {
    s.ax = ax; s.ay = ay; s.az = az; s.uq = usq;
  } else if constexpr (kTier == kBf16) {
    s.ax = bf(ax); s.ay = bf(ay); s.az = bf(az); s.uq = bf(usq);
  } else {
    s.ax = bf(ax); s.ay = bf(ay); s.az = bf(az);
    s.lx = bf(ax - s.ax); s.ly = bf(ay - s.ay); s.lz = bf(az - s.az);
    const float uh = bf(usq);
    s.uql = bf(usq - uh);
    s.uq = __fadd_rn(uh, s.uql);
  }
  s.best = INFINITY;
}

// Shared memory: [Ns] positions, then [Ns] lo parts ("high3"), then [Ns]
// normals + prob (weighted).
// Point j of the segment goes to slot d.
template <int kTier, bool kWeighted>
__device__ __forceinline__ void stage_segment_point(const float4* __restrict__ seg, float4* s_pos,
                                                    float4* s_lo, float4* s_nrm, int j, int d) {
  float4 p = seg[2 * j];
  if constexpr (kTier == kBf16) {
    p = make_float4(bf(p.x), bf(p.y), bf(p.z), bf(p.w));
  } else if constexpr (kTier == kHigh3) {
    const float4 hi = make_float4(bf(p.x), bf(p.y), bf(p.z), bf(p.w));
    s_lo[d] = make_float4(bf(p.x - hi.x), bf(p.y - hi.y), bf(p.z - hi.z), 0.f);
    p = make_float4(hi.x, hi.y, hi.z, __fadd_rn(hi.w, bf(p.w - hi.w)));
  }
  s_pos[d] = p;
  if constexpr (kWeighted) {
    float4 n = seg[2 * j + 1];
    if constexpr (kTier == kBf16) n = make_float4(bf(n.x), bf(n.y), bf(n.z), n.w);
    s_nrm[d] = n;
  }
}

// The same for a block of any size, with the positions padded to a whole
// number of chunks by points at infinity: their d2 is +inf against every
// model point, so they are never the nearest and never tie.
template <int kTier, bool kWeighted>
__device__ __forceinline__ void stage_segment_chunks(const float4* __restrict__ seg,
                                                     float4* s_pos, float4* s_lo, float4* s_nrm,
                                                     int Ns, int Nsp) {
  for (int j = threadIdx.x; j < Nsp; j += blockDim.x) {
    if (j < Ns) {
      stage_segment_point<kTier, kWeighted>(seg, s_pos, s_lo, s_nrm, j, j);
    } else {
      s_pos[j] = make_float4(0.f, 0.f, 0.f, INFINITY);
      if constexpr (kTier == kHigh3) s_lo[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// lcp_segside_kernel's staging: only the segment's valid points (|s|^2 not
// kMasked, as ops/lcp.pack_segment marks them), in index order, from slot 0,
// then points at infinity up to a whole number of chunks. Each round of
// blockDim points is placed by a ballot per warp and a prefix over the
// block's warps. Returns the valid count, the same in every thread.
template <int kTier, bool kWeighted>
__device__ __forceinline__ int stage_segment_compact(const float4* __restrict__ seg,
                                                     float4* s_pos, float4* s_lo, float4* s_nrm,
                                                     int Ns) {
  __shared__ int s_warp_valid[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  int n = 0;
  for (int j0 = 0; j0 < Ns; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const bool valid = j < Ns && seg[2 * j].w != kMasked;
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) s_warp_valid[w] = __popc(ballot);
    __syncthreads();
    int d = n;
    for (int v = 0; v < n_warps; ++v) {
      const int c = s_warp_valid[v];
      d += v < w ? c : 0;
      n += c;
    }
    if (valid) {
      d += __popc(ballot & ((1u << lane) - 1u));
      stage_segment_point<kTier, kWeighted>(seg, s_pos, s_lo, s_nrm, j, d);
    }
    __syncthreads();  // before the next round overwrites s_warp_valid
  }
  const int n_scan = (n + kChunk - 1) / kChunk * kChunk;
  for (int j = n + threadIdx.x; j < n_scan; j += blockDim.x) {
    s_pos[j] = make_float4(0.f, 0.f, 0.f, INFINITY);
    if constexpr (kTier == kHigh3) s_lo[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return n;
}

template <int kTier>
__device__ __forceinline__ float normal_dot(const float4& n, const Slot& s) {
  if constexpr (kTier == kFp32) {
    return fabsf(n.x * s.nx + n.y * s.ny + n.z * s.nz);
  } else if constexpr (kTier == kBf16) {
    return fabsf(fmaf(n.z, s.nz, fmaf(n.y, s.ny, n.x * s.nx)));
  } else {
    const float ahx = bf(n.x), ahy = bf(n.y), ahz = bf(n.z);
    const float alx = bf(n.x - ahx), aly = bf(n.y - ahy), alz = bf(n.z - ahz);
    const float bhx = bf(s.nx), bhy = bf(s.ny), bhz = bf(s.nz);
    const float blx = bf(s.nx - bhx), bly = bf(s.ny - bhy), blz = bf(s.nz - bhz);
    float acc = alx * bhx;
    acc = fmaf(ahx, blx, acc);
    acc = fmaf(ahx, bhx, acc);
    acc = fmaf(aly, bhy, acc);
    acc = fmaf(ahy, bly, acc);
    acc = fmaf(ahy, bhy, acc);
    acc = fmaf(alz, bhz, acc);
    acc = fmaf(ahz, blz, acc);
    acc = fmaf(ahz, bhz, acc);
    return fabsf(acc);
  }
}

// d2 of one pair: staged segment point (s, and l for "high3") against the
// model side of slot q, summed in this fixed order in every kernel here.
template <int kTier>
__device__ __forceinline__ float pair_d2(const float4& s, const float4& l, const Slot& q) {
  float d = __fadd_rn(s.w, q.uq);
  if constexpr (kTier == kHigh3) {
    d = fmaf(l.z, q.az, d);
    d = fmaf(s.z, q.lz, d);
    d = fmaf(s.z, q.az, d);
    d = fmaf(l.y, q.ay, d);
    d = fmaf(s.y, q.ly, d);
    d = fmaf(s.y, q.ay, d);
    d = fmaf(l.x, q.ax, d);
    d = fmaf(s.x, q.lx, d);
    d = fmaf(s.x, q.ax, d);
  } else {
    d = fmaf(s.x, q.ax, fmaf(s.y, q.ay, fmaf(s.z, q.az, d)));
  }
  return d;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void load_point(const float* __restrict__ pts, int i, int n,
                                           float& x, float& y, float& z) {
  x = y = z = 0.f;
  if (i < n) {
    x = pts[3 * i];
    y = pts[3 * i + 1];
    z = pts[3 * i + 2];
  }
}

// Row-major (R | t) of hypothesis h.
__device__ __forceinline__ void load_pose(const float* __restrict__ tr, int h, float (&r)[12]) {
#pragma unroll
  for (int c = 0; c < 12; ++c) r[c] = tr[12 * h + c];
}

#define LCP_KERNEL_ARGS                                                                    \
  const float* __restrict__ tr,          /* [H, 12] row-major (R | t) */                   \
  const float* __restrict__ model_pts,   /* [Nv, 3] */                                     \
  const float* __restrict__ model_nrm,   /* [Nv, 3] */                                     \
  const float4* __restrict__ seg,        /* [Ns, 2]: (x, y, z, |s|^2), (nx, ny, nz, prob) */ \
  float* __restrict__ out,               /* [H] */                                         \
  int H, int Nv, int Ns, float delta2, float cos_gate

// ---- lcp_segside_kernel: a warp per (hypothesis, model tile) item.

// Unweighted scan: the running nearest d2 of kS slots over the padded segment,
// a chunk of kChunk points at a time: a loop of fixed length inside (with the
// count staged at run time as its bound, one loop over all points measured 13 %
// slower on a full segment, H100).
template <int kTier, int kS>
__device__ __forceinline__ void scan_nearest(Slot (&slot)[kS], const float4* s_pos,
                                             const float4* s_lo, int Nsp) {
  for (int c = 0; c < Nsp; c += kChunk) {
#pragma unroll 8
    for (int jj = 0; jj < kChunk; ++jj) {
      const float4 s = s_pos[c + jj];
      float4 l = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kTier == kHigh3) l = s_lo[c + jj];
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        slot[k].best = fminf(slot[k].best, pair_d2<kTier>(s, l, slot[k]));
      }
    }
  }
}

// Weighted scan: the same inner loop over chunks of kChunk points; per slot the
// nearest d2 and, in hit[k], which chunks reached it: chunk c sets bit
// (c / kChunk) mod 32, so above 1,024 segment points two chunks share a bit.
template <int kTier, int kS>
__device__ __forceinline__ void scan_nearest_chunks(Slot (&slot)[kS], unsigned (&hit)[kS],
                                                    const float4* s_pos, const float4* s_lo,
                                                    int Nsp) {
  for (int c = 0; c < Nsp; c += kChunk) {
    float cm[kS];
#pragma unroll
    for (int k = 0; k < kS; ++k) cm[k] = INFINITY;
#pragma unroll 8
    for (int jj = 0; jj < kChunk; ++jj) {
      const float4 s = s_pos[c + jj];
      float4 l = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kTier == kHigh3) l = s_lo[c + jj];
#pragma unroll
      for (int k = 0; k < kS; ++k) cm[k] = fminf(cm[k], pair_d2<kTier>(s, l, slot[k]));
    }
    const unsigned bit = 1u << ((c / kChunk) & 31);
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const unsigned joined = (cm[k] == slot[k].best) ? (hit[k] | bit) : hit[k];
      hit[k] = (cm[k] < slot[k].best) ? bit : joined;
      slot[k].best = fminf(slot[k].best, cm[k]);
    }
  }
}

// What a slot within delta^2 contributes when weighted: prob of the nearest
// segment point if its normal agrees, max prob and max |ndot| over exact ties.
// d2 is recomputed over the chunks named in `hit` with the scan's
// instructions; lane L starts at point L of each chunk so that the lanes'
// reads fall on different banks. The 32 compares of a chunk fill a bit mask
// with no branch (unrolled, they overlap), and only the points in it read
// their normal and probability. A chunk that shares its bit without holding
// the minimum costs its 32 points and changes nothing.
template <int kTier>
__device__ __forceinline__ float nearest_attributes(const Slot& q, unsigned hit, int lane,
                                                    const float4* s_pos, const float4* s_lo,
                                                    const float4* s_nrm, int Ns, int Nsp,
                                                    float cos_gate) {
  float pb = -INFINITY, ab = -1.f;
  for (; hit != 0u; hit &= hit - 1u) {
    for (int c = (__ffs(hit) - 1) * kChunk; c < Nsp; c += 32 * kChunk) {
      unsigned eq = 0u;
#pragma unroll 8
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c + ((jj + lane) & (kChunk - 1));
        const float4 s = s_pos[j];
        float4 l = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (kTier == kHigh3) l = s_lo[j];
        eq |= (pair_d2<kTier>(s, l, q) == q.best) ? (1u << jj) : 0u;
      }
      for (; eq != 0u; eq &= eq - 1u) {
        const int j = c + ((__ffs(eq) - 1 + lane) & (kChunk - 1));
        if (j < Ns) {
          const float4 n = s_nrm[j];
          pb = fmaxf(pb, n.w);
          ab = fmaxf(ab, normal_dot<kTier>(n, q));
        }
      }
    }
  }
  return (ab >= cos_gate) ? pb : 0.f;
}

// Grid: ceil(H * n_mtiles / (warps of the block * items_per_warp)) blocks. Item
// it = h * n_mtiles + mt is hypothesis h on model points [mt, mt + 1) * 32 * kS;
// lane L holds points mt * 32 * kS + k * 32 + L, k < kS. The scans cover the
// segment's n valid points (stage_segment_compact), n_scan rounded up to a
// chunk; block 0 adds n_scan to *scan_points where it is given.
template <int kTier, bool kWeighted, int kS>
__global__ void __launch_bounds__(kThreads)
lcp_segside_kernel(LCP_KERNEL_ARGS, float* __restrict__ partial /* [H, n_mtiles] */,
                   int n_mtiles, int items_per_warp, unsigned long long* scan_points) {
  extern __shared__ float4 smem[];
  const int Nsp = (Ns + kChunk - 1) / kChunk * kChunk;
  float4* s_pos = smem;
  float4* s_lo = smem + Nsp;
  float4* s_nrm = smem + (kTier == kHigh3 ? 2 : 1) * Nsp;

  const int n = stage_segment_compact<kTier, kWeighted>(seg, s_pos, s_lo, s_nrm, Ns);
  const int n_scan = (n + kChunk - 1) / kChunk * kChunk;
  if (scan_points != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(scan_points, static_cast<unsigned long long>(n_scan));
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = static_cast<int>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int items = H * n_mtiles;
  const int it_end = min(items, (warp + 1) * items_per_warp);
  for (int it = warp * items_per_warp; it < it_end; ++it) {
    const int h = it / n_mtiles;
    const int base = (it - h * n_mtiles) * 32 * kS + lane;

    Slot slot[kS];
    {
      float rr[12];
      load_pose(tr, h, rr);
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        float mx, my, mz;
        load_point(model_pts, base + k * 32, Nv, mx, my, mz);
        make_slot<kTier>(slot[k], rr, mx, my, mz);
      }
    }

    float acc = 0.f;
    if constexpr (kWeighted) {
      unsigned hit[kS];
#pragma unroll
      for (int k = 0; k < kS; ++k) hit[k] = 0u;
      scan_nearest_chunks<kTier, kS>(slot, hit, s_pos, s_lo, n_scan);
      // The pose and the model normals of the slots within delta^2 are loaded
      // before any is used, so their latencies overlap.
      float rr[12], mn[kS][3];
      load_pose(tr, h, rr);
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        const int i = base + k * 32;
        mn[k][0] = mn[k][1] = mn[k][2] = 0.f;
        if (i < Nv && slot[k].best <= delta2) {
          load_point(model_nrm, i, Nv, mn[k][0], mn[k][1], mn[k][2]);
        }
      }
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        if (base + k * 32 < Nv && slot[k].best <= delta2) {
          rotate_normal<kTier>(slot[k], rr, mn[k][0], mn[k][1], mn[k][2]);
          acc += nearest_attributes<kTier>(slot[k], hit[k], lane, s_pos, s_lo, s_nrm, n, n_scan,
                                           cos_gate);
        }
      }
    } else {
      scan_nearest<kTier, kS>(slot, s_pos, s_lo, n_scan);
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        if (base + k * 32 < Nv && slot[k].best <= delta2) acc += 1.f;
      }
    }

    // Fixed-order sum of the tile: a warp shuffle tree.
    acc = warp_sum(acc);
    if (lane == 0) {
      if (n_mtiles == 1) {
        out[h] = acc / static_cast<float>(Nv);
      } else {
        partial[it] = acc;
      }
    }
  }
}

// ---- lcp_segside_mma_kernel: the lowered tiers with d2 on the tensor cores.
//
// The lowered tiers are products of bf16 values summed in float32: one
// mma.sync (bf16 operands, float32 accumulate) computes d2 for 16 model points x
// 8 segment points, with the tier's terms laid along K ("default" K = 5 of 8,
// "high3" K = 13 of 16):
//   "default"  model (ax, ay, az, 1, |u|^2)          segment (sx, sy, sz, |s|^2, 1)
//   "high3"    model (axh, axl, axh, .., 1, 1, uh, ul) segment (lx, sx, sx, .., sh, sl, 1, 1)
// Every product is exact, so the matrix unit computes the tier's d2 up to the
// order and rounding of its float32 sum: a few ulp of the terms' size from the
// chain of pair_d2. The scores must not depend on that, so the matrix unit only
// FILTERS: per model point the scan keeps the smallest d2 it saw and a bit mask
// of the chunks of kMmaChunk segment points whose minimum came within `eps` of
// it (eps bounds twice the difference between the two sums for any pair near
// the nearest). Afterwards a model point whose filtered minimum is within
// delta^2 + eps walks those chunks with pair_d2 on the CUDA cores and takes the
// exact minimum there: the same bits as lcp_segside_kernel and the plain
// version, at one min per pair in the scan instead of five instructions. One
// whose filtered minimum is under delta^2 - eps is an inlier without the walk.
// Unweighted calls only: the score needs no attribute of the nearest point.
// A warp takes kMmaRows = 128 model points of one hypothesis (8 row tiles of 16,
// the A fragments, in registers) and walks the segment's B fragments, staged
// once per block in fragment order. Lane (g, t) = (lane / 4, lane % 4) sees
// rows g and g + 8 of every row tile and columns 2t, 2t + 1 of every column
// tile; the four lanes of a row merge after the scan, then lane (g, t) finishes
// the rows of row tiles t and t + 4.

constexpr int kMmaRows = 128;   // model points per warp item
constexpr int kMmaChunk = 128;  // segment points per chunk of the filter's mask
constexpr int kRowTiles = kMmaRows / 16;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// bf16x2 words of one point's K vector: 4 (K = 8) or 8 (K = 16).
template <int kTier>
constexpr int kWordsOf = kTier == kHigh3 ? 8 : 4;

// The model side's words from the chain's operands (all bf16-valued).
template <int kTier>
__device__ __forceinline__ void model_words(const Slot& q, unsigned (&w)[7]) {
  if constexpr (kTier == kHigh3) {
    w[0] = pack_bf16(q.ax, q.lx);
    w[1] = pack_bf16(q.ax, q.ay);
    w[2] = pack_bf16(q.ly, q.ay);
    w[3] = pack_bf16(q.az, q.lz);
    w[4] = pack_bf16(q.az, 1.f);
    w[5] = pack_bf16(1.f, q.uq - q.uql);
    w[6] = pack_bf16(q.uql, 0.f);
  } else {
    w[0] = pack_bf16(q.ax, q.ay);
    w[1] = pack_bf16(q.az, 1.f);
    w[2] = pack_bf16(q.uq, 0.f);
  }
}

// Word kp of segment point j in the fragment-ordered array: column tile j / 8,
// lane (j % 8) * 4 + kp % 4, register kp / 4.
template <int kTier>
__device__ __forceinline__ int frag_index(int j, int kp) {
  constexpr int kRegs = kWordsOf<kTier> / 4;
  return (j >> 3) * (32 * kRegs) + (((j & 7) << 2) + (kp & 3)) * kRegs + (kp >> 2);
}

// Stage the segment for the filter and for the exact pass: s_pos / s_lo as
// stage_segment_point leaves them, and the segment side's words.
// Points from Ns to Nsp (a whole number of chunks) get |s|^2 = 1e30.
template <int kTier>
__device__ __forceinline__ void stage_segment_mma(const float4* __restrict__ seg, float4* s_pos,
                                                  float4* s_lo, unsigned* s_frag, int Ns,
                                                  int Nsp) {
  for (int j = threadIdx.x; j < Nsp; j += blockDim.x) {
    unsigned w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    if (j < Ns) {
      stage_segment_point<kTier, false>(seg, s_pos, s_lo, nullptr, j, j);
      const float4 s = s_pos[j];
      if constexpr (kTier == kHigh3) {
        const float4 l = s_lo[j];
        const float raw = seg[2 * j].w;
        const float sh = bf(raw), sl = bf(raw - sh);
        w[0] = pack_bf16(l.x, s.x);
        w[1] = pack_bf16(s.x, l.y);
        w[2] = pack_bf16(s.y, s.y);
        w[3] = pack_bf16(l.z, s.z);
        w[4] = pack_bf16(s.z, sh);
        w[5] = pack_bf16(sl, 1.f);
        w[6] = pack_bf16(1.f, 0.f);
      } else {
        w[0] = pack_bf16(s.x, s.y);
        w[1] = pack_bf16(s.z, s.w);
        w[2] = pack_bf16(1.f, 0.f);
      }
    } else {
      s_pos[j] = make_float4(0.f, 0.f, 0.f, INFINITY);
      if constexpr (kTier == kHigh3) {
        s_lo[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        w[4] = pack_bf16(0.f, 1e30f);
        w[5] = pack_bf16(0.f, 1.f);
        w[6] = pack_bf16(1.f, 0.f);
      } else {
        w[1] = pack_bf16(0.f, 1e30f);
        w[2] = pack_bf16(1.f, 0.f);
      }
    }
#pragma unroll
    for (int kp = 0; kp < kWordsOf<kTier>; ++kp) s_frag[frag_index<kTier>(j, kp)] = w[kp];
  }
}

// d[0..3] = A (16 x K, row-major) * B (K x 8, column-major) in float32.
template <int kTier>
__device__ __forceinline__ void mma_d2(float (&d)[4], const unsigned* a, const unsigned* b) {
  if constexpr (kTier == kHigh3) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
  } else {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b[0]), "f"(0.f));
  }
}

// The filter's margin for model points with |u|^2 <= uq: more than twice the
// most the two sums can differ for a pair whose d2 is within delta^2. There
// |s| <= |u| + delta, and every partial sum of either order is at most the sum
// of the terms' sizes, |s|^2 + |u|^2 + 2 |s| |u| = (|s| + |u|)^2 <=
// (2 |u| + delta)^2 =: M. Each sum rounds (or truncates) at most K + 2 times
// ("default", K = 5) or K + 5 times ("high3", K = 13, with the hi + lo of
// |u|^2 and |s|^2) by one ulp <= 2^-23 M: 14 and 36 ulp for the two sums, 28
// and 72 twice, under the 32 and 96 taken. The margin also covers the tier's
// own rounding of the operands to bf16 (|s|^2 and |u|^2 each within 2^-8 of
// the rounded points' own), which lets |s| pass |u| + delta by up to |u| / 11:
// under 10 % of M, against the 14 % left. A pair further off than
// delta^2 + eps never decides a score, whatever its error.
template <int kTier>
__device__ __forceinline__ float filter_eps(float uq, float delta2) {
  const float reach = 2.f * sqrtf(uq) + sqrtf(delta2);
  return (kTier == kHigh3 ? 96.f : 32.f) * 1.1920929e-7f * reach * reach;
}

// The filter after a chunk whose smallest d2 on this lane's columns is cm:
// the running minimum, and a mask of the chunks whose minimum came within eps
// of it (a chunk more than eps under it resets the mask).
__device__ __forceinline__ void filter_chunk(float cm, float& best, unsigned& hits,
                                             unsigned bit, float eps) {
  const unsigned joined = (cm <= best + eps) ? (hits | bit) : hits;
  hits = (cm < best - eps) ? bit : joined;
  best = fminf(best, cm);
}

// The four lanes of a row (lane / 4): the smallest of their minima, and the
// chunks of the lanes that came near it.
__device__ __forceinline__ void filter_merge_quad(float& best, unsigned& hits, float eps) {
  float low = fminf(best, __shfl_xor_sync(0xffffffffu, best, 1));
  low = fminf(low, __shfl_xor_sync(0xffffffffu, low, 2));
  unsigned mask = (best <= low + eps) ? hits : 0u;
  mask |= __shfl_xor_sync(0xffffffffu, mask, 1);
  mask |= __shfl_xor_sync(0xffffffffu, mask, 2);
  best = low;
  hits = mask;
}

// Word of lane `src`'s array chosen by this lane's t: w[t] (offset 0) or
// w[t + 4] (offset 4); words from 3 ("default") or 7 ("high3") on are zero.
template <int kTier>
__device__ __forceinline__ unsigned word_from(const unsigned (&w)[7], int offset, int src, int t) {
  constexpr int kUsed = kTier == kHigh3 ? 7 : 3;
  unsigned mine = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (offset + c < kUsed) {
      const unsigned v = __shfl_sync(0xffffffffu, w[offset + c], src);
      mine = (t == c) ? v : mine;
    }
  }
  return mine;
}

template <int kTier>
__global__ void __launch_bounds__(kThreads)
lcp_segside_mma_kernel(LCP_KERNEL_ARGS, float* __restrict__ partial /* [H, n_mtiles] */,
                       int n_mtiles, int items_per_warp, unsigned long long* scan_points) {
  static_assert(kTier != kFp32, "the float32 tier stays on the CUDA cores");
  constexpr int kRegs = kWordsOf<kTier> / 4;  // registers of a B fragment; an A fragment has 2x
  extern __shared__ float4 smem[];
  const int Nsp = (Ns + kMmaChunk - 1) / kMmaChunk * kMmaChunk;
  float4* s_pos = smem;
  float4* s_lo = smem + Nsp;
  unsigned* s_frag = reinterpret_cast<unsigned*>(smem + (kTier == kHigh3 ? 2 : 1) * Nsp);
  // The filter scans the padded segment whole.
  if (scan_points != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(scan_points, static_cast<unsigned long long>(Nsp));
  }

  stage_segment_mma<kTier>(seg, s_pos, s_lo, s_frag, Ns, Nsp);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp = static_cast<int>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int items = H * n_mtiles;
  const int it_end = min(items, (warp + 1) * items_per_warp);
  for (int it = warp * items_per_warp; it < it_end; ++it) {
    const int h = it / n_mtiles;
    const int base = (it - h * n_mtiles) * kMmaRows;

    // A fragments: lane (g, t) makes the words of its own four model points
    // (row tiles t and t + 4, rows g and g + 8); the lanes of its quad hand
    // each other the word each needs of every row tile.
    unsigned afrag[kRowTiles][2 * kRegs];
    float uq_max = 0.f;
    {
      float rr[12];
      load_pose(tr, h, rr);
      unsigned w[4][7];
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        Slot q;
        float mx, my, mz;
        load_point(model_pts, base + (t + 4 * (o >> 1)) * 16 + g + 8 * (o & 1), Nv, mx, my, mz);
        make_slot<kTier>(q, rr, mx, my, mz);
        model_words<kTier>(q, w[o]);
        uq_max = fmaxf(uq_max, q.uq);
      }
#pragma unroll
      for (int m = 0; m < kRowTiles; ++m) {
        const int src = (lane & ~3) | (m & 3);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const unsigned (&ws)[7] = w[(m >> 2) * 2 + half];
          afrag[m][half] = word_from<kTier>(ws, 0, src, t);
          if constexpr (kRegs == 2) afrag[m][2 + half] = word_from<kTier>(ws, 4, src, t);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      uq_max = fmaxf(uq_max, __shfl_xor_sync(0xffffffffu, uq_max, off));
    }
    const float eps = filter_eps<kTier>(uq_max, delta2);

    // The filter: per row the smallest d2 this lane saw and the chunks near it.
    float best[2 * kRowTiles];
    unsigned hits[2 * kRowTiles];
#pragma unroll
    for (int k = 0; k < 2 * kRowTiles; ++k) {
      best[k] = INFINITY;
      hits[k] = 0u;
    }
    for (int c = 0; c < Nsp; c += kMmaChunk) {
      float cm[2 * kRowTiles];
#pragma unroll
      for (int k = 0; k < 2 * kRowTiles; ++k) cm[k] = INFINITY;
#pragma unroll 2
      for (int n = 0; n < kMmaChunk / 8; ++n) {
        unsigned b[kRegs];
        const unsigned* src = s_frag + ((c >> 3) + n) * (32 * kRegs) + lane * kRegs;
        if constexpr (kRegs == 2) {
          const uint2 v = *reinterpret_cast<const uint2*>(src);
          b[0] = v.x;
          b[1] = v.y;
        } else {
          b[0] = *src;
        }
#pragma unroll
        for (int m = 0; m < kRowTiles; ++m) {
          float d[4];
          mma_d2<kTier>(d, afrag[m], b);
          cm[2 * m] = fminf(cm[2 * m], fminf(d[0], d[1]));
          cm[2 * m + 1] = fminf(cm[2 * m + 1], fminf(d[2], d[3]));
        }
      }
      const unsigned bit = 1u << (c / kMmaChunk);
#pragma unroll
      for (int k = 0; k < 2 * kRowTiles; ++k) filter_chunk(cm[k], best[k], hits[k], bit, eps);
    }
#pragma unroll
    for (int k = 0; k < 2 * kRowTiles; ++k) filter_merge_quad(best[k], hits[k], eps);

    // The exact pass, on this lane's own four model points.
    float acc = 0.f;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      float low = INFINITY;
      unsigned mask = 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // row 2 * (t + 4 * (o / 2)) + o % 2, by this lane's t
        const int k = 2 * (c + 4 * (o >> 1)) + (o & 1);
        low = (t == c) ? best[k] : low;
        mask = (t == c) ? hits[k] : mask;
      }
      const int i = base + (t + 4 * (o >> 1)) * 16 + g + 8 * (o & 1);
      if (i >= Nv || !(low <= delta2 + eps)) continue;
      if (low < delta2 - eps) {
        acc += 1.f;
        continue;
      }
      Slot q;
      {
        float rr[12];
        load_pose(tr, h, rr);
        float mx, my, mz;
        load_point(model_pts, i, Nv, mx, my, mz);
        make_slot<kTier>(q, rr, mx, my, mz);
      }
      for (; mask != 0u; mask &= mask - 1u) {
        const int c = (__ffs(mask) - 1) * kMmaChunk;
        for (int jj = 0; jj < kMmaChunk; ++jj) {
          const int j = c + ((jj + lane) & (kMmaChunk - 1));
          if (j >= Ns) continue;
          const float4 s = s_pos[j];
          float4 l = make_float4(0.f, 0.f, 0.f, 0.f);
          if constexpr (kTier == kHigh3) l = s_lo[j];
          q.best = fminf(q.best, pair_d2<kTier>(s, l, q));
        }
      }
      if (q.best <= delta2) acc += 1.f;
    }

    acc = warp_sum(acc);
    if (lane == 0) {
      if (n_mtiles == 1) {
        out[h] = acc / static_cast<float>(Nv);
      } else {
        partial[it] = acc;
      }
    }
  }
}

// out[h] = (sum of the model tiles' partial sums, in tile order) / Nv.
__global__ void lcp_segside_finish_kernel(const float* __restrict__ partial,
                                          float* __restrict__ out, int H, int n_mtiles, int Nv) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float total = 0.f;
  for (int t = 0; t < n_mtiles; ++t) total += partial[h * n_mtiles + t];
  out[h] = total / static_cast<float>(Nv);
}

// Does nothing: what a launch costs on this card (timed beside the kernels).
__global__ void lcp_empty_kernel() {}

// The hypothesis group's poses in shared memory; a ragged last group scores
// the last hypothesis again in its idle slots and writes nothing for them.
__device__ __forceinline__ void stage_group_poses(const float* __restrict__ tr, float* s_tr,
                                                  int h0, int H) {
  for (int c = threadIdx.x; c < kHypGroup * 12; c += blockDim.x) {
    s_tr[c] = tr[12 * min(h0 + c / 12, H - 1) + c % 12];
  }
}

// ---- lcp_segside_hb_kernel: kHypGroup hypotheses a block on the CUDA cores.
// A thread holds one model point under kHbSlots of them (kHypGroup / kHbSlots
// groups of threads) and scans the whole staged segment with
// lcp_segside_kernel's scans, walking the model in tiles (the TPU kernel's
// whole-model and model-tiled modes are this one loop).
template <int kTier, bool kWeighted>
__global__ void __launch_bounds__(kThreads) lcp_segside_hb_kernel(LCP_KERNEL_ARGS) {
  static_assert(kTier != kHigh3, "the hypothesis-block kernels have no high3 tier");
  constexpr int kS = kHbSlots;
  constexpr int kGroups = kHypGroup / kS;
  constexpr int kPts = kThreads / kGroups;  // model points of a tile
  constexpr int kGroupWarps = kPts / 32;
  extern __shared__ float4 smem[];
  const int Nsp = (Ns + kChunk - 1) / kChunk * kChunk;
  float4* s_pos = smem;        // [Nsp]
  float4* s_nrm = smem + Nsp;  // [Nsp] normal + prob (weighted)
  __shared__ float s_tr[kHypGroup * 12];
  __shared__ float s_warp[kHypGroup][kGroupWarps];

  const int tid = threadIdx.x, lane = tid & 31;
  const int h0 = static_cast<int>(blockIdx.x) * kHypGroup;
  stage_segment_chunks<kTier, kWeighted>(seg, s_pos, nullptr, s_nrm, Ns, Nsp);
  stage_group_poses(tr, s_tr, h0, H);
  __syncthreads();

  const int grp = tid / kPts;
  const float* r = s_tr + 12 * kS * grp;
  float acc[kS];
#pragma unroll
  for (int k = 0; k < kS; ++k) acc[k] = 0.f;

  for (int base = 0; base < Nv; base += kPts) {
    const int i = base + tid % kPts;
    float mx, my, mz;
    load_point(model_pts, i, Nv, mx, my, mz);
    Slot slot[kS];
#pragma unroll
    for (int k = 0; k < kS; ++k) make_slot<kTier>(slot[k], r + 12 * k, mx, my, mz);
    if constexpr (kWeighted) {
      unsigned hit[kS];
#pragma unroll
      for (int k = 0; k < kS; ++k) hit[k] = 0u;
      scan_nearest_chunks<kTier, kS>(slot, hit, s_pos, nullptr, Nsp);
      if (i < Nv) {
        float mnx, mny, mnz;
        load_point(model_nrm, i, Nv, mnx, mny, mnz);
#pragma unroll
        for (int k = 0; k < kS; ++k) {
          if (slot[k].best <= delta2) {
            rotate_normal<kTier>(slot[k], r + 12 * k, mnx, mny, mnz);
            acc[k] += nearest_attributes<kTier>(slot[k], hit[k], lane, s_pos, nullptr, s_nrm, Ns,
                                                Nsp, cos_gate);
          }
        }
      }
    } else {
      scan_nearest<kTier, kS>(slot, s_pos, nullptr, Nsp);
      if (i < Nv) {
#pragma unroll
        for (int k = 0; k < kS; ++k) acc[k] += slot[k].best <= delta2 ? 1.f : 0.f;
      }
    }
  }

  // Per hypothesis: warp shuffle tree, then the group's warp partials in order.
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) s_warp[kS * grp + k][(tid % kPts) >> 5] = v;
  }
  __syncthreads();
  if (tid < kHypGroup && h0 + tid < H) {
    float total = 0.f;
    for (int w = 0; w < kGroupWarps; ++w) total += s_warp[tid][w];
    out[h0 + tid] = total / static_cast<float>(Nv);
  }
}

// ---- lcp_segside_hb_mma_kernel: the unweighted "default" tier of a
// hypothesis group with d2 on the tensor cores.
//
// lcp_segside_mma_kernel's filter (its note above: the same K = 5 words of
// model_words and stage_segment_mma, the same margin filter_eps, taken here
// per model point from its own |u|^2), laid out for a group: the rows are
// (hypothesis, model point), kHypGroup x kHbPts of them per model tile, in
// row tiles of 16 points of one hypothesis; warp w takes the kHbPts / 16 row
// tiles of hypothesis w, kHbStep at a time, so each B word read from shared
// memory feeds kHbStep mma.sync. Per model tile every thread makes the slots
// of one model point under the group's hypotheses with make_slot's
// instructions, hence the chain's bf16 words, and stores them in A-fragment
// order (hb_slot keeps those stores on 32 banks): a row tile is then one
// 8-byte read a lane, with no shuffles (kernel 1 builds its fragments per
// item with quad shuffles, the set-up that made its filter lose at small
// segments). The segment's B fragments are staged once a block. Per column
// tile of 8 segment points: one mma.sync.m16n8k8 a row tile and four integer
// mins a lane on the d2 bits into the rows' running minima (two chains a row;
// hb_min); a segment of one chunk (Ns <= 256, the coarse call) keeps no chunk
// mask.
// Afterwards, per row: a filtered minimum under delta^2 - eps is an inlier,
// one over delta^2 + eps an outlier; a row in between (the band) walks the
// chunks of kHbChunk points whose minimum came within eps of it with the
// exact chain pair_d2, the row's four lanes a quarter of each chunk, and
// takes the exact minimum: the scores are those of the CUDA-core kernels and
// the plain version, bit for bit (the terms are 0 or 1, so the count is exact
// in any order). band_rows, when given, counts the rows that walked.
// What bounds it: one min a pair on the CUDA cores, beside the tensor cores'
// K = 8 products (PERF.md counts both). Tuning builds that held the first
// chunk's B fragments in 32 registers, took one or four row tiles a step, or
// ran 1, 2 or 4 blocks an SM were no faster at the coarse call;
// ptxas gives this one 79 registers (launch bound: 3 blocks an SM).

constexpr int kHbPts = kThreads;      // model points of a tile: 16 row tiles a warp
constexpr int kHbChunk = 256;         // segment points a chunk of the mask
constexpr int kHbStep = 2;            // row tiles a warp takes at a time

// Where lane L's A fragment lies in row tile rt: a permutation of the lanes
// that puts the set-up's stores (a thread writes the four words of one row)
// on 32 different banks; a lane's 8-byte read stays one of 32 distinct slots.
__device__ __forceinline__ int hb_slot(int rt, int lane) {
  return lane ^ (((lane >> 4) & 1) | ((rt & 1) << 1));
}

// The filter's minimum of a chunk from the integer minimum of its d2 bits:
// max(float minimum, 0). For d2 >= 0 the signed-integer order of the bits is
// the float order, and every negative d2 (-0 included) sorts below every
// positive one, so clamping the integer minimum at 0 gives max(min, 0)
// exactly. (The integer min measured faster than fminf here, PERF.md.) The
// filter works on these clamped minima unchanged: max(x, 0) is monotone and
// moves no value by more than it moves the smallest, so a chunk within eps of
// the row's minimum stays within eps, and a clamped minimum under
// delta^2 - eps or over delta^2 + eps decides the row as the unclamped one
// would (a row whose minimum is negative is an inlier or walks the band).
__device__ __forceinline__ float hb_min(int bits) { return __int_as_float(max(bits, 0)); }

__global__ void __launch_bounds__(kThreads, 3)
lcp_segside_hb_mma_kernel(LCP_KERNEL_ARGS, unsigned* __restrict__ band_rows) {
  static_assert(kHbPts == kThreads && kHypGroup == kWarps, "a thread per model point, a warp per hypothesis");
  constexpr int kTiles = kHbPts / 16;  // row tiles of one hypothesis in a model tile
  static_assert(kTiles % kHbStep == 0, "a warp takes its row tiles kHbStep at a time");
  extern __shared__ float4 smem[];
  const int Nsp = (Ns + kHbChunk - 1) / kHbChunk * kHbChunk;
  float4* s_pos = smem;                                                      // [Nsp]
  unsigned* s_b = reinterpret_cast<unsigned*>(smem + Nsp);                   // [Nsp / 8][32]
  uint2* s_a = reinterpret_cast<uint2*>(s_b + 4 * Nsp);                      // [kHypGroup * kTiles][32]
  float* s_eps = reinterpret_cast<float*>(s_a + kHypGroup * kTiles * 32);    // [kHypGroup * kHbPts]
  __shared__ float s_tr[kHypGroup * 12];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h0 = static_cast<int>(blockIdx.x) * kHypGroup;
  stage_segment_mma<kBf16>(seg, s_pos, nullptr, s_b, Ns, Nsp);
  stage_group_poses(tr, s_tr, h0, H);
  __syncthreads();

  const float* r = s_tr + 12 * warp;  // this warp's hypothesis
  const bool one_chunk = Nsp == kHbChunk;
  float count = 0.f;
  unsigned walked = 0u;
  for (int base = 0; base < Nv; base += kHbPts) {
    if (base > 0) __syncthreads();  // the previous tile's fragments are read
    {
      // Thread tid makes row (k, tid) of every hypothesis k: row tile
      // k * kTiles + tid / 16, row tid % 16 = g' + 8 * half, whose word w goes
      // to lane 4 g' + w, half `half` of the lane's pair.
      float mx, my, mz;
      load_point(model_pts, base + tid, Nv, mx, my, mz);
      const int rr = tid & 15, rt0 = tid >> 4;
#pragma unroll
      for (int k = 0; k < kHypGroup; ++k) {
        Slot q;
        make_slot<kBf16>(q, s_tr + 12 * k, mx, my, mz);
        unsigned w[7];
        model_words<kBf16>(q, w);
        const int rt = k * kTiles + rt0;
        unsigned* d = reinterpret_cast<unsigned*>(s_a + rt * 32) + (rr >> 3);
#pragma unroll
        for (int c = 0; c < 4; ++c) d[2 * hb_slot(rt, 4 * (rr & 7) + c)] = c < 3 ? w[c] : 0u;
        s_eps[k * kHbPts + tid] = filter_eps<kBf16>(q.uq, delta2);
      }
    }
    __syncthreads();

    for (int tile = 0; tile < kTiles; tile += kHbStep) {
      // Rows k = 2 q + h: (tile + q, g + 8 h).
      unsigned a[kHbStep][2];
      float eps[2 * kHbStep], best[2 * kHbStep];
      unsigned hits[2 * kHbStep];
#pragma unroll
      for (int q = 0; q < kHbStep; ++q) {
        const int rt = warp * kTiles + tile + q;
        const uint2 av = s_a[rt * 32 + hb_slot(rt, lane)];
        a[q][0] = av.x;
        a[q][1] = av.y;
        eps[2 * q] = s_eps[warp * kHbPts + (tile + q) * 16 + g];
        eps[2 * q + 1] = s_eps[warp * kHbPts + (tile + q) * 16 + g + 8];
      }
#pragma unroll
      for (int k = 0; k < 2 * kHbStep; ++k) {
        best[k] = INFINITY;
        hits[k] = 0u;
      }
      for (int c = 0; c < Nsp; c += kHbChunk) {
        // Two running minima a row (even and odd column tiles), for
        // independent chains, taken on the float bits as signed integers (see
        // hb_min): +inf to start.
        int cm[2][2 * kHbStep];
#pragma unroll
        for (int k = 0; k < 2 * kHbStep; ++k) cm[0][k] = cm[1][k] = 0x7f800000;
        auto column = [&](unsigned b, int p) {
#pragma unroll
          for (int q = 0; q < kHbStep; ++q) {
            float d[4];
            mma_d2<kBf16>(d, a[q], &b);
            cm[p][2 * q] = min(cm[p][2 * q], min(__float_as_int(d[0]), __float_as_int(d[1])));
            cm[p][2 * q + 1] = min(cm[p][2 * q + 1], min(__float_as_int(d[2]), __float_as_int(d[3])));
          }
        };
        // Column tiles past the segment hold only padding: a short segment
        // skips them.
        const int n_end = min(kHbChunk / 8, (Ns - c + 7) >> 3);
        const unsigned* b_chunk = s_b + (c >> 3) * 32 + lane;
        if (n_end == kHbChunk / 8) {
#pragma unroll
          for (int n = 0; n < kHbChunk / 8; ++n) column(b_chunk[n * 32], n & 1);
        } else {
#pragma unroll 4
          for (int n = 0; n < n_end; ++n) column(b_chunk[n * 32], 0);
        }
        float chunk_min[2 * kHbStep];
#pragma unroll
        for (int k = 0; k < 2 * kHbStep; ++k) chunk_min[k] = hb_min(min(cm[0][k], cm[1][k]));
        if (one_chunk) {
#pragma unroll
          for (int k = 0; k < 2 * kHbStep; ++k) {
            best[k] = chunk_min[k];
            hits[k] = 1u;
          }
        } else {
          const unsigned bit = 1u << ((c / kHbChunk) & 31);
#pragma unroll
          for (int k = 0; k < 2 * kHbStep; ++k) filter_chunk(chunk_min[k], best[k], hits[k], bit, eps[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 2 * kHbStep; ++k) {
        if (one_chunk) {
          best[k] = fminf(best[k], __shfl_xor_sync(0xffffffffu, best[k], 1));
          best[k] = fminf(best[k], __shfl_xor_sync(0xffffffffu, best[k], 2));
        } else {
          filter_merge_quad(best[k], hits[k], eps[k]);
        }
      }

      bool in[2 * kHbStep], band[2 * kHbStep], any_band = false;
#pragma unroll
      for (int k = 0; k < 2 * kHbStep; ++k) {
        in[k] = best[k] < delta2 - eps[k];
        band[k] = !in[k] && best[k] <= delta2 + eps[k];
        any_band |= band[k];
      }
      if (__any_sync(0xffffffffu, any_band)) {
#pragma unroll
        for (int k = 0; k < 2 * kHbStep; ++k) {
          float low = INFINITY;
          if (band[k]) {
            float mx, my, mz;
            load_point(model_pts, base + (tile + (k >> 1)) * 16 + g + 8 * (k & 1), Nv, mx, my, mz);
            Slot q;
            make_slot<kBf16>(q, r, mx, my, mz);
            for (unsigned mask = hits[k]; mask != 0u; mask &= mask - 1u) {
              const int c = (__ffs(mask) - 1) * kHbChunk;
              for (int jj = t; jj < kHbChunk; jj += 4) {
                low = fminf(low, pair_d2<kBf16>(s_pos[c + jj], make_float4(0.f, 0.f, 0.f, 0.f), q));
              }
            }
          }
          low = fminf(low, __shfl_xor_sync(0xffffffffu, low, 1));
          low = fminf(low, __shfl_xor_sync(0xffffffffu, low, 2));
          in[k] = in[k] || (band[k] && low <= delta2);
        }
      }
      // Lane t = 0 of each row counts it.
      if (t == 0) {
#pragma unroll
        for (int k = 0; k < 2 * kHbStep; ++k) {
          const bool real = base + (tile + (k >> 1)) * 16 + g + 8 * (k & 1) < Nv;
          count += real && in[k] ? 1.f : 0.f;
          walked += real && band[k] ? 1u : 0u;
        }
      }
    }
  }

  count = warp_sum(count);
  if (band_rows != nullptr) {
    for (int off = 16; off > 0; off >>= 1) walked += __shfl_down_sync(0xffffffffu, walked, off);
    if (lane == 0 && h0 + warp < H) atomicAdd(band_rows, walked);
  }
  if (lane == 0 && h0 + warp < H) out[h0 + warp] = count / static_cast<float>(Nv);
}

// Model points per thread of lcp_segside_kernel: the largest of 8, 4, 2 that
// leaves at most a quarter of a hypothesis's slots on padding; 4 in place of
// 8 when the call has too few (hypothesis, model tile) items to give every SM
// a full block of warps (the exact tier: 32 hypotheses).
int slots_for(int H, int Nv) {
  for (int s = 8; s > 2; s /= 2) {
    const int tiles = (Nv + 32 * s - 1) / (32 * s);
    const int padded = tiles * 32 * s;
    if ((padded - Nv) * 4 > padded) continue;
    if (s == 8 && static_cast<long long>(H) * tiles < kWarps * kSMs) continue;
    return s;
  }
  return 2;
}

template <int kTier, bool kWeighted>
int segment_smem(int Ns) {
  const int n = (Ns + kChunk - 1) / kChunk * kChunk;
  const int arrays = 1 + (kTier == kHigh3 ? 1 : 0) + (kWeighted ? 1 : 0);
  return n * arrays * static_cast<int>(sizeof(float4));
}

// Grid of the two kernels whose unit of work is a warp on one item: enough
// warps to fill the card come first; a call with more items than that gives
// a warp several, and small calls take smaller blocks.
struct ItemGrid {
  int per_warp, block_threads, blocks;
};

ItemGrid item_grid(long long items) {
  ItemGrid g;
  g.per_warp = items >= 4LL * kItemsPerWarp * kWarps * kSMs ? kItemsPerWarp : 1;
  const int warps = static_cast<int>((items + g.per_warp - 1) / g.per_warp);
  const int block_warps = warps >= kWarps * kSMs ? kWarps : (warps >= 2 * kSMs ? 4 : 2);
  g.block_threads = 32 * block_warps;
  g.blocks = (warps + block_warps - 1) / block_warps;
  return g;
}

int finish(const float* partial, float* out, int H, int n_mtiles, int Nv, cudaStream_t st) {
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_mtiles == 1) return err;
  lcp_segside_finish_kernel<<<(H + 255) / 256, 256, 0, st>>>(partial, out, H, n_mtiles, Nv);
  return static_cast<int>(cudaGetLastError());
}

#define LCP_LAUNCH_ARGS                                                                    \
  const float *tr, const float *model_pts, const float *model_nrm, const float4 *seg4,    \
      float *partial, float *out, unsigned long long *scan_points, int H, int Nv, int Ns,  \
      float delta2, float cos_gate, cudaStream_t st

template <int kTier, bool kWeighted, int kS>
int launch_warp_items(LCP_LAUNCH_ARGS) {
  const int n_mtiles = (Nv + 32 * kS - 1) / (32 * kS);
  const ItemGrid g = item_grid(static_cast<long long>(H) * n_mtiles);
  const int smem = segment_smem<kTier, kWeighted>(Ns);
  auto kern = lcp_segside_kernel<kTier, kWeighted, kS>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kern<<<g.blocks, g.block_threads, smem, st>>>(tr, model_pts, model_nrm, seg4, out, H, Nv, Ns,
                                                delta2, cos_gate, partial, n_mtiles, g.per_warp,
                                                scan_points);
  return finish(partial, out, H, n_mtiles, Nv, st);
}

template <int kTier>
int launch_mma(LCP_LAUNCH_ARGS) {
  const int n_mtiles = (Nv + kMmaRows - 1) / kMmaRows;
  const ItemGrid g = item_grid(static_cast<long long>(H) * n_mtiles);
  const int Nsp = (Ns + kMmaChunk - 1) / kMmaChunk * kMmaChunk;
  const int arrays = kTier == kHigh3 ? 2 : 1;
  const int smem = Nsp * (arrays * static_cast<int>(sizeof(float4)) + 4 * kWordsOf<kTier>);
  auto kern = lcp_segside_mma_kernel<kTier>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kern<<<g.blocks, g.block_threads, smem, st>>>(tr, model_pts, model_nrm, seg4, out, H, Nv, Ns,
                                                delta2, cos_gate, partial, n_mtiles, g.per_warp,
                                                scan_points);
  return finish(partial, out, H, n_mtiles, Nv, st);
}

// Which of lcp_segside's kernels a call takes.
constexpr int kUnitRule = 0;    // the measured rule below
constexpr int kUnitCores = 1;   // the CUDA cores, whatever the shape
constexpr int kUnitTensor = 2;  // the tensor-core filter (lowered tiers only)

// Where the tensor-core filter measured faster than the CUDA cores (PERF.md):
// the unweighted variants of the lowered tiers from 512 segment points and
// about 2^18 (hypothesis, model point) pairs on, 1.3-2.3x. A weighted filter
// measured slower at every shape (its exact pass over whole chunks costs more
// than the scan saves) and is not built.
bool rule_takes_tensor(int tier, bool weighted, int H, int Nv, int Ns) {
  const int padded = (Nv + kMmaRows - 1) / kMmaRows * kMmaRows;
  return tier != kFp32 && !weighted && Ns >= 512 &&
         static_cast<long long>(H) * Nv >= (1 << 18) && (padded - Nv) * 4 <= padded;
}

template <int kTier, bool kWeighted>
int launch(int unit, LCP_LAUNCH_ARGS) {
  if constexpr (kTier != kFp32 && !kWeighted) {
    if (unit == kUnitTensor ||
        (unit == kUnitRule && rule_takes_tensor(kTier, kWeighted, H, Nv, Ns))) {
      return launch_mma<kTier>(tr, model_pts, model_nrm, seg4, partial, out, scan_points, H, Nv,
                               Ns, delta2, cos_gate, st);
    }
  }
  if (unit == kUnitTensor) return static_cast<int>(cudaErrorInvalidValue);
#define LCP_ITEMS(S)                                                                          \
  return launch_warp_items<kTier, kWeighted, S>(tr, model_pts, model_nrm, seg4, partial, out, \
                                                scan_points, H, Nv, Ns, delta2, cos_gate, st)
  switch (slots_for(H, Nv)) {
    case 8: LCP_ITEMS(8);
    case 4: LCP_ITEMS(4);
    default: LCP_ITEMS(2);
  }
#undef LCP_ITEMS
}

// Which of the hypothesis-block kernels a call takes.
constexpr int kHbUnitRule = 0;    // hb_rule_takes_tensor below
constexpr int kHbUnitCores = 1;   // lcp_segside_hb_kernel
constexpr int kHbUnitTensor = 2;  // lcp_segside_hb_mma_kernel (unweighted "default" only)

// The tensor-core filter takes the unweighted "default" tier, the coarse
// ranking call (PERF.md: faster than either CUDA-core variant there); weighted
// and float32 calls stay on the CUDA cores.
bool hb_rule_takes_tensor(int tier, bool weighted) { return tier == kBf16 && !weighted; }

template <int kTier, bool kWeighted>
int launch_hb(int unit, const float* tr, const float* model_pts, const float* model_nrm,
              const float4* seg4, float* out, unsigned* band_rows, int H, int Nv, int Ns,
              float delta2, float cos_gate, cudaStream_t st) {
  if constexpr (kTier == kHigh3) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (unit == kHbUnitRule) unit = hb_rule_takes_tensor(kTier, kWeighted) ? kHbUnitTensor : kHbUnitCores;
    if (unit == kHbUnitTensor) {
      if constexpr (kTier == kBf16 && !kWeighted) {
        const int Nsp = (Ns + kHbChunk - 1) / kHbChunk * kHbChunk;
        const int smem = Nsp * 2 * static_cast<int>(sizeof(float4)) +
                         kHypGroup * kHbPts * static_cast<int>(4 * sizeof(unsigned) + sizeof(float));
        auto kern = lcp_segside_hb_mma_kernel;
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        kern<<<(H + kHypGroup - 1) / kHypGroup, kThreads, smem, st>>>(
            tr, model_pts, model_nrm, seg4, out, H, Nv, Ns, delta2, cos_gate, band_rows);
        return static_cast<int>(cudaGetLastError());
      }
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (unit != kHbUnitCores) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = segment_smem<kTier, kWeighted>(Ns);
    auto kern = lcp_segside_hb_kernel<kTier, kWeighted>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kern<<<(H + kHypGroup - 1) / kHypGroup, kThreads, smem, st>>>(
        tr, model_pts, model_nrm, seg4, out, H, Nv, Ns, delta2, cos_gate);
    return static_cast<int>(cudaGetLastError());
  }
}

int dispatch(bool hb, int unit, const float* tr, const float* model_pts, const float* model_nrm,
             const float* seg, float* partial, float* out, unsigned* band_rows,
             long long* scan_points, int H, int Nv, int Ns, float delta2, float cos_gate,
             int weighted, int tier, void* stream) {
  if (H <= 0) return 0;
  if (Nv <= 0 || Ns <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(H) * ((Nv + 63) / 64) > 0x3fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* seg4 = reinterpret_cast<const float4*>(seg);
  auto* scanned = reinterpret_cast<unsigned long long*>(scan_points);
#define LCP_LAUNCH(T, W)                                                                        \
  return hb ? launch_hb<T, W>(unit, tr, model_pts, model_nrm, seg4, out, band_rows, H, Nv, Ns, \
                              delta2, cos_gate, st)                                             \
            : launch<T, W>(unit, tr, model_pts, model_nrm, seg4, partial, out, scanned, H, Nv, \
                           Ns, delta2, cos_gate, st)
  if (tier == kFp32) {
    if (weighted) LCP_LAUNCH(kFp32, true);
    LCP_LAUNCH(kFp32, false);
  }
  if (tier == kBf16) {
    if (weighted) LCP_LAUNCH(kBf16, true);
    LCP_LAUNCH(kBf16, false);
  }
  if (tier == kHigh3) {
    if (weighted) LCP_LAUNCH(kHigh3, true);
    LCP_LAUNCH(kHigh3, false);
  }
#undef LCP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// All launch on `stream` and allocate nothing; tier is 0 (fp32), 1 ("default")
// or 2 ("high3", lcp_segside only). They return cudaGetLastError().
// lcp_segside_launch takes the caller's workspace `partial` of
// H * lcp_segside_workspace_tiles(Nv) floats: room for one partial sum per
// (hypothesis, model tile) at the smallest tile any of its kernels uses.
extern "C" int lcp_segside_workspace_tiles(int Nv) { return Nv > 0 ? (Nv + 63) / 64 : 1; }

// The step of lcp_segside's scan counter: a launch on the CUDA cores adds its
// segment's valid count rounded up to it (the tensor-core filter adds Ns
// rounded up to its own chunk of 128).
extern "C" int lcp_segside_scan_step() { return kChunk; }

// scan_points (or null): a device counter to which the launch adds the segment
// points its scan walked a (hypothesis, model point) pair.
extern "C" int lcp_segside_launch(const float* tr, const float* model_pts,
                                  const float* model_nrm, const float* seg, float* partial,
                                  float* out, long long* scan_points, int H, int Nv, int Ns,
                                  float delta2, float cos_gate, int weighted, int tier,
                                  void* stream) {
  return dispatch(false, kUnitRule, tr, model_pts, model_nrm, seg, partial, out, nullptr,
                  scan_points, H, Nv, Ns, delta2, cos_gate, weighted, tier, stream);
}

// The same call on a named unit, for measurements: 1 the CUDA cores, 2 the
// tensor-core filter (an error for the fp32 tier and for a weighted call). The
// scores are the same.
extern "C" int lcp_segside_launch_on(int unit, const float* tr, const float* model_pts,
                                     const float* model_nrm, const float* seg, float* partial,
                                     float* out, long long* scan_points, int H, int Nv, int Ns,
                                     float delta2, float cos_gate, int weighted, int tier,
                                     void* stream) {
  if (unit != kUnitCores && unit != kUnitTensor) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(false, unit, tr, model_pts, model_nrm, seg, partial, out, nullptr, scan_points,
                  H, Nv, Ns, delta2, cos_gate, weighted, tier, stream);
}

// The unit lcp_segside_launch takes for such a call: 1 the CUDA cores, 2 the
// tensor-core filter.
extern "C" int lcp_segside_unit_for(int H, int Nv, int Ns, int weighted, int tier) {
  return rule_takes_tensor(tier, weighted != 0, H, Nv, Ns) ? kUnitTensor : kUnitCores;
}

extern "C" int lcp_segside_hb_launch(const float* tr, const float* model_pts,
                                     const float* model_nrm, const float* seg, float* out,
                                     int H, int Nv, int Ns, float delta2, float cos_gate,
                                     int weighted, int tier, void* stream) {
  return dispatch(true, kHbUnitRule, tr, model_pts, model_nrm, seg, nullptr, out, nullptr,
                  nullptr, H, Nv, Ns, delta2, cos_gate, weighted, tier, stream);
}

// The same call on a named unit, for measurements and checks: 1 the CUDA
// cores, 2 the tensor-core filter (an error but for an unweighted "default"
// call). The scores are the same. band_rows (or null): the tensor-core filter adds
// the number of rows that walked the band.
extern "C" int lcp_segside_hb_launch_on(int unit, const float* tr, const float* model_pts,
                                        const float* model_nrm, const float* seg, float* out,
                                        unsigned* band_rows, int H, int Nv, int Ns, float delta2,
                                        float cos_gate, int weighted, int tier, void* stream) {
  if (unit != kHbUnitCores && unit != kHbUnitTensor) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(true, unit, tr, model_pts, model_nrm, seg, nullptr, out, band_rows, nullptr, H,
                  Nv, Ns, delta2, cos_gate, weighted, tier, stream);
}

// The unit lcp_segside_hb_launch takes for such a call: 1 or 2, as above.
extern "C" int lcp_segside_hb_unit_for(int weighted, int tier) {
  return hb_rule_takes_tensor(tier, weighted != 0) ? kHbUnitTensor : kHbUnitCores;
}

extern "C" int lcp_empty_launch(void* stream) {
  lcp_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
