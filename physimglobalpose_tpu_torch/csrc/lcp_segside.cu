// Weighted / unweighted LCP scores of H rigid hypotheses, segment-stationary:
// two kernels that compute one function.
//
//   lcp_segside_kernel     replaces the TPU kernel
//       physimglobalpose_tpu/ops/lcp.py::_lcp_kernel_segside
//     (one hypothesis at a time per block, tiers fp32 / "default" / "high3");
//   lcp_segside_hb_kernel  replaces
//       physimglobalpose_tpu/ops/lcp.py::_lcp_kernel_segside_hb
//     (a group of hypotheses per block, tiers fp32 / "default"; whole-model and
//     model-tiled modes of the TPU kernel are one loop over model tiles here).
//
// For each hypothesis (R, t) and each model point m_i, u_i = R m_i + t; the
// nearest segment point j* minimises
//   d2 = |s_j|^2 + |u_i|^2 - 2 s_j . u_i
// (the same expansion as the TPU kernels, so both round alike). Masked or padded
// segment points carry |s|^2 = 1e9 and never match. The point contributes
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
// What bounds them: fp32 arithmetic on the CUDA cores. Per (hypothesis, model
// point, segment point) pair the fp32 and "default" tiers execute 3 FMA + 1 add +
// the running min (about 8 FLOP), "high3" 9 FMA + 1 add (about 20 FLOP); the
// normal dot runs only on a new nearest or a tie. Against the 67 TFLOP/s fp32
// peak of an H100 SXM the inputs (a few hundred KB) make memory traffic
// negligible. "default" therefore costs what fp32 costs here and "high3" costs
// more: the lowered tiers buy nothing on the CUDA cores, they only keep the
// scores the TPU path reports.
// What the design does about it:
//  - a block loads the packed segment into shared memory once ([Ns] float4
//    positions, [Ns] float4 lo parts for "high3", [Ns] float4 normals/prob when
//    weighted; above 48 KB through the dynamic shared memory opt-in);
//  - every thread keeps kSlots (hypothesis, model point) pairs in registers, so
//    each broadcast shared-memory read of a segment point feeds kSlots
//    independent FMA chains;
//  - lcp_segside_kernel gives a thread kSlots model points of one hypothesis:
//    right for Nv >= kThreads * kSlots (the fine and exact tiers, Nv = 4096);
//  - lcp_segside_hb_kernel gives a thread one model point under kSlots
//    hypotheses: at the coarse shape (Nv = 256) every slot then holds a real
//    point, where the other mapping would leave 7 of 8 slots on padding; the
//    model point is loaded once for the group;
//  - the normal dot is evaluated only when a segment point ties or beats the
//    running nearest distance, which is rare after the first few points;
//  - per-hypothesis sums are a warp-shuffle tree and a fixed-order sum over
//    warps: no atomics, so scores are deterministic.
// Tensor cores (mma on the padded K = 5 / K = 3 products), TMA and wgmma are
// not used here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 8;         // (hypothesis, model point) pairs per thread
constexpr int kHypsPerBlock = 4;  // lcp_segside_kernel: hypotheses a block takes in turn
constexpr int kHypGroup = kSlots; // lcp_segside_hb_kernel: hypotheses a block takes together
constexpr int kWarps = kThreads / 32;

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
// product per tier, the rotated normal, and the running nearest state.
struct Slot {
  float ax, ay, az;  // -2u: fp32 | bf16(-2u) | hi part
  float lx, ly, lz;  // "high3" only: lo part of -2u
  float uq;          // |u|^2: fp32 | bf16 | hi + lo
  float nx, ny, nz;  // R n: fp32 | bf16 | fp32 (split where it is used)
  float best, pb, ab;
};

template <int kTier, bool kWeighted>
__device__ __forceinline__ void make_slot(Slot& s, const float* r, float mx, float my,
                                          float mz, float mnx, float mny, float mnz) {
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
    s.uq = __fadd_rn(uh, bf(usq - uh));
  }
  s.best = INFINITY;
  if constexpr (kWeighted) {
    s.nx = dot3_rn(r[0], mnx, r[1], mny, r[2], mnz);
    s.ny = dot3_rn(r[4], mnx, r[5], mny, r[6], mnz);
    s.nz = dot3_rn(r[8], mnx, r[9], mny, r[10], mnz);
    if constexpr (kTier == kBf16) {
      s.nx = bf(s.nx); s.ny = bf(s.ny); s.nz = bf(s.nz);
    }
    s.pb = 0.f;
    s.ab = 0.f;
  }
}

// Shared memory: [Ns] positions, then [Ns] lo parts ("high3"), then [Ns]
// normals + prob (weighted).
template <int kTier, bool kWeighted>
__device__ __forceinline__ void stage_segment(const float4* __restrict__ seg, float4* s_pos,
                                              float4* s_lo, float4* s_nrm, int Ns) {
  for (int j = threadIdx.x; j < Ns; j += kThreads) {
    float4 p = seg[2 * j];
    if constexpr (kTier == kBf16) {
      p = make_float4(bf(p.x), bf(p.y), bf(p.z), bf(p.w));
    } else if constexpr (kTier == kHigh3) {
      const float4 hi = make_float4(bf(p.x), bf(p.y), bf(p.z), bf(p.w));
      s_lo[j] = make_float4(bf(p.x - hi.x), bf(p.y - hi.y), bf(p.z - hi.z), 0.f);
      p = make_float4(hi.x, hi.y, hi.z, __fadd_rn(hi.w, bf(p.w - hi.w)));
    }
    s_pos[j] = p;
    if constexpr (kWeighted) {
      float4 n = seg[2 * j + 1];
      if constexpr (kTier == kBf16) n = make_float4(bf(n.x), bf(n.y), bf(n.z), n.w);
      s_nrm[j] = n;
    }
  }
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

// Every slot against every segment point: running nearest d2 and, when
// weighted, the prob and |ndot| of the nearest (max over exact ties).
template <int kTier, bool kWeighted>
__device__ __forceinline__ void scan_segment(Slot (&slot)[kSlots], const float4* s_pos,
                                             const float4* s_lo, const float4* s_nrm, int Ns) {
  for (int j = 0; j < Ns; ++j) {
    const float4 s = s_pos[j];
    float4 l = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kTier == kHigh3) l = s_lo[j];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      Slot& q = slot[k];
      float d = s.w + q.uq;
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
      if constexpr (kWeighted) {
        if (d <= q.best) {
          const float4 n = s_nrm[j];
          const float nd = normal_dot<kTier>(n, q);
          if (d < q.best) {
            q.best = d;
            q.pb = n.w;
            q.ab = nd;
          } else {
            q.pb = fmaxf(q.pb, n.w);
            q.ab = fmaxf(q.ab, nd);
          }
        }
      } else {
        q.best = fminf(q.best, d);
      }
    }
  }
}

template <bool kWeighted>
__device__ __forceinline__ float contribution(const Slot& s, float delta2, float cos_gate) {
  if (!(s.best <= delta2)) return 0.f;
  if constexpr (kWeighted) {
    return (s.ab >= cos_gate) ? s.pb : 0.f;
  } else {
    return 1.f;
  }
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

#define LCP_KERNEL_ARGS                                                                    \
  const float* __restrict__ tr,          /* [H, 12] row-major (R | t) */                   \
  const float* __restrict__ model_pts,   /* [Nv, 3] */                                     \
  const float* __restrict__ model_nrm,   /* [Nv, 3] */                                     \
  const float4* __restrict__ seg,        /* [Ns, 2]: (x, y, z, |s|^2), (nx, ny, nz, prob) */ \
  float* __restrict__ out,               /* [H] */                                         \
  int H, int Nv, int Ns, float delta2, float cos_gate

// One hypothesis at a time; a thread holds kSlots model points of it.
template <int kTier, bool kWeighted>
__global__ void __launch_bounds__(kThreads) lcp_segside_kernel(LCP_KERNEL_ARGS) {
  extern __shared__ float4 smem[];
  float4* s_pos = smem;
  float4* s_lo = smem + Ns;
  float4* s_nrm = smem + (kTier == kHigh3 ? 2 : 1) * Ns;
  __shared__ float s_warp[kWarps];

  const int tid = threadIdx.x;
  stage_segment<kTier, kWeighted>(seg, s_pos, s_lo, s_nrm, Ns);
  __syncthreads();

  const int block = static_cast<int>(blockIdx.x);
  const int h_end = min(H, (block + 1) * kHypsPerBlock);
  for (int h = block * kHypsPerBlock; h < h_end; ++h) {
    float r[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) r[c] = tr[12 * h + c];

    float acc = 0.f;
    for (int base = 0; base < Nv; base += kThreads * kSlots) {
      Slot slot[kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int i = base + k * kThreads + tid;
        float mx, my, mz, mnx = 0.f, mny = 0.f, mnz = 0.f;
        load_point(model_pts, i, Nv, mx, my, mz);
        if constexpr (kWeighted) load_point(model_nrm, i, Nv, mnx, mny, mnz);
        make_slot<kTier, kWeighted>(slot[k], r, mx, my, mz, mnx, mny, mnz);
      }
      scan_segment<kTier, kWeighted>(slot, s_pos, s_lo, s_nrm, Ns);
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (base + k * kThreads + tid < Nv) {
          acc += contribution<kWeighted>(slot[k], delta2, cos_gate);
        }
      }
    }

    // Fixed-order block sum: warp shuffle tree, then warp partials in order.
    acc = warp_sum(acc);
    if ((tid & 31) == 0) s_warp[tid >> 5] = acc;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int w = 0; w < kWarps; ++w) total += s_warp[w];
      out[h] = total / static_cast<float>(Nv);
    }
    __syncthreads();
  }
}

// kHypGroup hypotheses together; a thread holds one model point under each of
// them and walks the model in tiles of kThreads points.
template <int kTier, bool kWeighted>
__global__ void __launch_bounds__(kThreads) lcp_segside_hb_kernel(LCP_KERNEL_ARGS) {
  static_assert(kTier != kHigh3, "the hypothesis-block kernel has no high3 tier");
  extern __shared__ float4 smem[];
  float4* s_pos = smem;
  float4* s_lo = smem + Ns;  // unused: no high3 tier
  float4* s_nrm = smem + Ns;
  __shared__ float s_tr[kHypGroup * 12];
  __shared__ float s_warp[kHypGroup][kWarps];

  const int tid = threadIdx.x;
  const int h0 = static_cast<int>(blockIdx.x) * kHypGroup;
  stage_segment<kTier, kWeighted>(seg, s_pos, s_lo, s_nrm, Ns);
  if (tid < kHypGroup * 12) {
    // A ragged last group scores the last hypothesis again in its idle slots.
    const int h = min(h0 + tid / 12, H - 1);
    s_tr[tid] = tr[12 * h + tid % 12];
  }
  __syncthreads();

  float acc[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) acc[k] = 0.f;

  for (int base = 0; base < Nv; base += kThreads) {
    const int i = base + tid;
    float mx, my, mz, mnx = 0.f, mny = 0.f, mnz = 0.f;
    load_point(model_pts, i, Nv, mx, my, mz);
    if constexpr (kWeighted) load_point(model_nrm, i, Nv, mnx, mny, mnz);
    Slot slot[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      make_slot<kTier, kWeighted>(slot[k], s_tr + 12 * k, mx, my, mz, mnx, mny, mnz);
    }
    scan_segment<kTier, kWeighted>(slot, s_pos, s_lo, s_nrm, Ns);
    if (i < Nv) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) acc[k] += contribution<kWeighted>(slot[k], delta2, cos_gate);
    }
  }

  // Per hypothesis: warp shuffle tree, then warp partials in order.
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const float v = warp_sum(acc[k]);
    if ((tid & 31) == 0) s_warp[k][tid >> 5] = v;
  }
  __syncthreads();
  if (tid < kHypGroup && h0 + tid < H) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += s_warp[tid][w];
    out[h0 + tid] = total / static_cast<float>(Nv);
  }
}

template <int kTier, bool kWeighted>
int launch(bool hyp_block, const float* tr, const float* model_pts, const float* model_nrm,
           const float* seg, float* out, int H, int Nv, int Ns, float delta2, float cos_gate,
           cudaStream_t st) {
  const int arrays = 1 + (kTier == kHigh3 ? 1 : 0) + (kWeighted ? 1 : 0);
  const int smem = Ns * arrays * static_cast<int>(sizeof(float4));
  const float4* seg4 = reinterpret_cast<const float4*>(seg);
  if (hyp_block) {
    if constexpr (kTier == kHigh3) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      auto kern = lcp_segside_hb_kernel<kTier, kWeighted>;
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      kern<<<(H + kHypGroup - 1) / kHypGroup, kThreads, smem, st>>>(
          tr, model_pts, model_nrm, seg4, out, H, Nv, Ns, delta2, cos_gate);
    }
  } else {
    auto kern = lcp_segside_kernel<kTier, kWeighted>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kern<<<(H + kHypsPerBlock - 1) / kHypsPerBlock, kThreads, smem, st>>>(
        tr, model_pts, model_nrm, seg4, out, H, Nv, Ns, delta2, cos_gate);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(bool hyp_block, const float* tr, const float* model_pts, const float* model_nrm,
             const float* seg, float* out, int H, int Nv, int Ns, float delta2,
             float cos_gate, int weighted, int tier, void* stream) {
  if (H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LCP_LAUNCH(T, W) \
  return launch<T, W>(hyp_block, tr, model_pts, model_nrm, seg, out, H, Nv, Ns, delta2, cos_gate, st)
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

// Both launch on `stream` and allocate nothing; tier is 0 (fp32), 1 ("default")
// or 2 ("high3", lcp_segside_launch only). They return cudaGetLastError().
extern "C" int lcp_segside_launch(const float* tr, const float* model_pts,
                                  const float* model_nrm, const float* seg, float* out,
                                  int H, int Nv, int Ns, float delta2, float cos_gate,
                                  int weighted, int tier, void* stream) {
  return dispatch(false, tr, model_pts, model_nrm, seg, out, H, Nv, Ns, delta2, cos_gate,
                  weighted, tier, stream);
}

extern "C" int lcp_segside_hb_launch(const float* tr, const float* model_pts,
                                     const float* model_nrm, const float* seg, float* out,
                                     int H, int Nv, int Ns, float delta2, float cos_gate,
                                     int weighted, int tier, void* stream) {
  return dispatch(true, tr, model_pts, model_nrm, seg, out, H, Nv, Ns, delta2, cos_gate,
                  weighted, tier, stream);
}
