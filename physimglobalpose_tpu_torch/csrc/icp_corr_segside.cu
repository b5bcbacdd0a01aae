// One point-to-plane ICP correspondence pass for H hypotheses: the 6x6 normal
// equations (A, b) per hypothesis, segment-stationary.
//
// Replaces the TPU kernel
//   physimglobalpose_tpu/ops/icp.py::_icp_corr_kernel_segside
// (reached through _icp_segside_pass / refine_icp_pallas_segside).
//
// For hypothesis (R, t), model point m_i with normal n_i: u_i = R m_i + t,
// un_i = R n_i. For each segment point s_j
//   d2[j, i] = |s_j|^2 + |u_i|^2 - 2 s_j . u_i        (the TPU kernel's expansion)
//   mind2_j  = min_i d2[j, i],   ties_j = #{i : d2[j, i] == mind2_j}
//   w_j      = exp(-mind2_j / (2 sigma^2)) if mind2_j <= max_corr^2 else 0,
//              sigma = max_corr / 2 (Welsch); masked and padded segment points
//              carry |s|^2 = 1e9 and so get w_j = 0.
// Every tied nearest model point shares the weight equally. With the Jacobian
// row col_i = (u_i x un_i, un_i) and the residual r_ji = (u_i - s_j) . un_i:
//   A = sum_j sum_{i in ties(j)} (w_j / ties_j) col_i col_i^T
//   b = -sum_j sum_{i in ties(j)} (w_j / ties_j) col_i r_ji.
// The TPU kernel reaches the same sums through per-model-point accumulators
// (S_i, W_i) built by a one-hot matrix product; here each segment point adds
// its own terms, so nothing is scattered and no atomics are needed. Only the
// order of the sums differs.
//
// Tiers. fp32: everything in float32. "default": the operands of the d2 product
// (s, |s|^2, -2u, |u|^2) are rounded to bf16 exactly where the TPU kernel rounds
// them, so correspondences and weights are the TPU tier's; then w_j / ties_j,
// the segment coordinates in r_ji and the Jacobian row col_i are rounded to
// bf16 (the TPU kernel's roundings at its one-hot and G products), and the
// products and sums are float32. The TPU kernel's further rounding of W_i col_i
// and of g_i has no per-correspondence counterpart and is not applied. The plain
// PyTorch version (ops/icp.py::icp_segside_pass_plain) has the same definition.
// u, un, col and r are computed with separately rounded products and sums in a
// fixed order, and d2 as a fixed chain (unfused in the fp32 tier, where a fused
// multiply-add would round differently from an elementwise product and sum), so
// the plain version finds bit-identical distances, ties and weights.
//
// What bounds it: the instruction rate of the CUDA cores, Ns * Nm pairs per
// hypothesis at 4 (fused) or 7 (unfused) operations plus the running min; the
// inputs are tens of KB and the output 42 floats per hypothesis. At the ICP
// tier's shapes (H = 256, Nm = 512, Ns = 512 or 2,048) that is 6.7e7 or 2.7e8
// pairs: a few microseconds of arithmetic, so a pass is bound by how much of
// the card its warps fill and by how long each warp's dependent chain is.
// What the design does about it:
//  - one block of kWarps = 16 warps per hypothesis, so that a pass is one
//    launch and H = 256 puts 4,096 warps on the card. The warps split the
//    work two ways: kSlices slices of the model (contiguous index ranges) by
//    kGroups groups of the segment tile. A lane holds kSeg segment points in
//    registers and scans its warp's slice: each broadcast read of a model
//    point from shared memory feeds kSeg independent chains;
//  - the scan keeps only the running minimum, taken over chunks of kChunk
//    model points; after a chunk two selects per segment point keep a bit
//    mask of the chunks that reached the minimum (a nearer chunk resets it, an
//    equal one joins), so the loop has no per-pair branch;
//  - per segment point the slices' (minimum, chunk mask) meet in shared
//    memory. One thread per point of the tile takes the minimum over the
//    slices and, only for a point within max_corr (the others weigh 0), walks
//    the chunks of the slices that reached it with the scan's instructions,
//    hence the same bits: the exact tie count and the first index, the triple
//    one scan of the whole model gives. It then adds the Jacobian rows of its
//    matched model points, reading u and R n from shared memory, staged once
//    per hypothesis. (The walk once sat in the scan, per slice and for every
//    point: 43 % of the pass on an H100 80GB HBM3 at 700 W, PERF.md.);
//  - per tile each warp reduces its 27 sums by a shuffle tree into its own
//    row of shared memory; at the end the rows are added in warp order, so
//    the result is deterministic.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): the block shapes of 256,
// 512 and 1,024 threads and chunks of 4, 8 and 16 points came within 10 %
// of each other; this one was the fastest at both ICP shapes. 64 registers.
// Shared memory: 16 bytes per model point for the d2 operands, 24 more for
// u and R n while the model has at most kAccSmemPoints points (above that the
// rows are rebuilt from the model in device memory), and 16 KB for the slices'
// results: 36 KB at Nm = 512, 144 KB at the largest model the wrapper takes
// (8,192 points).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSlices = 4;                   // model slices
constexpr int kGroups = kWarps / kSlices;    // segment groups
constexpr int kSeg = 4;                      // segment points a lane holds
constexpr int kTile = kGroups * 32 * kSeg;   // segment points a tile
constexpr int kChunk = 8;                    // model points a chunk of the scan's mask
constexpr int kSums = 27;                    // upper triangle of A (21), then b (6)
constexpr int kOut = 42;                     // A row-major (36), then b (6)
constexpr int kAccSmemPoints = 4096;         // largest model whose u, R n are staged

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float dot3_rn(float a, float x, float b, float y, float c, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

__device__ __forceinline__ void transform_rn(const float* r, float x, float y, float z,
                                             float& ux, float& uy, float& uz) {
  ux = __fadd_rn(dot3_rn(r[0], x, r[1], y, r[2], z), r[3]);
  uy = __fadd_rn(dot3_rn(r[4], x, r[5], y, r[6], z), r[7]);
  uz = __fadd_rn(dot3_rn(r[8], x, r[9], y, r[10], z), r[11]);
}

__device__ __forceinline__ void rotate_rn(const float* r, float x, float y, float z,
                                          float& vx, float& vy, float& vz) {
  vx = dot3_rn(r[0], x, r[1], y, r[2], z);
  vy = dot3_rn(r[4], x, r[5], y, r[6], z);
  vz = dot3_rn(r[8], x, r[9], y, r[10], z);
}

// d2 of one (segment point, model point) pair; p = (-2u, |u|^2).
template <bool kBf16>
__device__ __forceinline__ float pair_d2(float sx, float sy, float sz, float sw, const float4& p) {
  float d = __fadd_rn(sw, p.w);
  if constexpr (kBf16) {
    // Products of bf16 values are exact in float32: fused and unfused agree.
    d = fmaf(sz, p.z, d);
    d = fmaf(sy, p.y, d);
    d = fmaf(sx, p.x, d);
  } else {
    d = __fadd_rn(__fmul_rn(sz, p.z), d);
    d = __fadd_rn(__fmul_rn(sy, p.y), d);
    d = __fadd_rn(__fmul_rn(sx, p.x), d);
  }
  return d;
}

// Segment point j as the d2 chain takes it: (x, y, z, |s|^2), rounded per tier.
template <bool kBf16>
__device__ __forceinline__ float4 load_segment(const float4* __restrict__ seg, int j, int Ns) {
  float4 s = make_float4(0.f, 0.f, 0.f, 1e9f);
  if (j < Ns) s = seg[j];
  if constexpr (kBf16) s = make_float4(bf(s.x), bf(s.y), bf(s.z), bf(s.w));
  return s;
}

// Adds model point i's share (weight wq) of segment point (sx, sy, sz); u and
// un as staged (or rebuilt the same way from the model).
template <bool kBf16>
__device__ __forceinline__ void accumulate(float (&acc)[kSums], float ux, float uy, float uz,
                                           float unx, float uny, float unz, float wq, float sx,
                                           float sy, float sz) {
  float col[6];
  col[0] = __fsub_rn(__fmul_rn(uy, unz), __fmul_rn(uz, uny));
  col[1] = __fsub_rn(__fmul_rn(uz, unx), __fmul_rn(ux, unz));
  col[2] = __fsub_rn(__fmul_rn(ux, uny), __fmul_rn(uy, unx));
  col[3] = unx;
  col[4] = uny;
  col[5] = unz;
  const float res = dot3_rn(__fsub_rn(ux, sx), unx, __fsub_rn(uy, sy), uny,
                            __fsub_rn(uz, sz), unz);
  if constexpr (kBf16) {
#pragma unroll
    for (int a = 0; a < 6; ++a) col[a] = bf(col[a]);
  }
  int idx = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float wa = wq * col[a];
#pragma unroll
    for (int b = a; b < 6; ++b) acc[idx++] += wa * col[b];
    acc[21 + a] -= wa * res;
  }
}

// The per-slice result of one tile point, as the scan leaves it.
struct SliceResult {
  float best;    // min d2 over the slice (+inf for an empty slice)
  unsigned hit;  // chunks of the slice that reached it (bit c mod 32)
};

template <bool kBf16, bool kAccSmem>
__global__ void __launch_bounds__(kThreads, 2)
icp_corr_segside_kernel(const float* __restrict__ tr,         // [H, 12] row-major (R | t)
                        const float4* __restrict__ seg,       // [Ns]: (x, y, z, |s|^2)
                        const float* __restrict__ model_pts,  // [Nm, 3]
                        const float* __restrict__ model_nrm,  // [Nm, 3]
                        float* __restrict__ out,              // [H, 42]
                        int Ns, int Nm, int slice_len, float max_corr2, float two_sigma2) {
  extern __shared__ float4 smem[];
  const int Nmp = kSlices * slice_len;  // the model padded to whole chunks per slice
  float4* s_model = smem;               // [Nmp]: (-2u, |u|^2), rounded per tier
  SliceResult* s_res = reinterpret_cast<SliceResult*>(smem + Nmp);  // [kSlices][kTile]
  float4* s_u = reinterpret_cast<float4*>(s_res + kSlices * kTile);  // [Nm]: (u, unx)
  float2* s_un = reinterpret_cast<float2*>(s_u + (kAccSmem ? Nm : 0));  // [Nm]: (uny, unz)
  __shared__ float s_wsum[kWarps][kSums];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = static_cast<int>(blockIdx.x);
  float r[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) r[c] = tr[12 * h + c];

  for (int i = tid; i < Nmp; i += kThreads) {
    float4 p = make_float4(0.f, 0.f, 0.f, INFINITY);  // padding: never the nearest
    if (i < Nm) {
      float ux, uy, uz;
      transform_rn(r, model_pts[3 * i], model_pts[3 * i + 1], model_pts[3 * i + 2], ux, uy, uz);
      p = make_float4(-2.f * ux, -2.f * uy, -2.f * uz, dot3_rn(ux, ux, uy, uy, uz, uz));
      if constexpr (kBf16) p = make_float4(bf(p.x), bf(p.y), bf(p.z), bf(p.w));
      if constexpr (kAccSmem) {
        float unx, uny, unz;
        rotate_rn(r, model_nrm[3 * i], model_nrm[3 * i + 1], model_nrm[3 * i + 2], unx, uny, unz);
        s_u[i] = make_float4(ux, uy, uz, unx);
        s_un[i] = make_float2(uny, unz);
      }
    }
    s_model[i] = p;
  }
  if (tid < kSums * kWarps) (&s_wsum[0][0])[tid] = 0.f;
  __syncthreads();

  const int slice = warp % kSlices, group = warp / kSlices;
  const int m0 = slice * slice_len;

  for (int base = 0; base < Ns; base += kTile) {
    // ---- The scan: this warp's slice against this lane's kSeg points.
    {
      float sx[kSeg], sy[kSeg], sz[kSeg], sw[kSeg], best[kSeg];
      unsigned hit[kSeg];
#pragma unroll
      for (int k = 0; k < kSeg; ++k) {
        const float4 s = load_segment<kBf16>(seg, base + group * 32 * kSeg + k * 32 + lane, Ns);
        sx[k] = s.x; sy[k] = s.y; sz[k] = s.z; sw[k] = s.w;
        best[k] = INFINITY;
        hit[k] = 0u;
      }
      for (int c = 0; c < slice_len; c += kChunk) {
        float cm[kSeg];
#pragma unroll
        for (int k = 0; k < kSeg; ++k) cm[k] = INFINITY;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 p = s_model[m0 + c + jj];
#pragma unroll
          for (int k = 0; k < kSeg; ++k) cm[k] = fminf(cm[k], pair_d2<kBf16>(sx[k], sy[k], sz[k], sw[k], p));
        }
        const unsigned bit = 1u << ((c / kChunk) & 31);
#pragma unroll
        for (int k = 0; k < kSeg; ++k) {
          const unsigned joined = (cm[k] == best[k]) ? (hit[k] | bit) : hit[k];
          hit[k] = (cm[k] < best[k]) ? bit : joined;
          best[k] = fminf(best[k], cm[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kSeg; ++k) {
        s_res[slice * kTile + group * 32 * kSeg + k * 32 + lane] = SliceResult{best[k], hit[k]};
      }
    }
    __syncthreads();

    // ---- Per tile point: the minimum over the slices; within max_corr, the
    // exact ties and the first index among them from the chunks of the slices
    // that reached it (the scan's instructions again, hence the same bits);
    // then the Jacobian rows of the matched model points.
    float acc[kSums];
#pragma unroll
    for (int v = 0; v < kSums; ++v) acc[v] = 0.f;
    for (int t = tid; t < kTile; t += kThreads) {
      const int j = base + t;
      float best = INFINITY;
#pragma unroll
      for (int sl = 0; sl < kSlices; ++sl) best = fminf(best, s_res[sl * kTile + t].best);
      if (j >= Ns || !(best <= max_corr2)) continue;
      const float4 s = load_segment<kBf16>(seg, j, Ns);
      // Visits every model point of the chunks that reached the minimum, in
      // slice order; f(i) for each that equals it.
      auto for_each_tie = [&](auto&& f) {
        for (int sl = 0; sl < kSlices; ++sl) {
          const SliceResult q = s_res[sl * kTile + t];
          if (q.best != best) continue;
          const int lo = sl * slice_len, hi = min(lo + slice_len, Nm);
          for (unsigned hm = q.hit; hm != 0u; hm &= hm - 1u) {
            for (int c = lo + (__ffs(hm) - 1) * kChunk; c < hi; c += 32 * kChunk) {
              for (int i = c; i < min(c + kChunk, hi); ++i) {
                if (pair_d2<kBf16>(s.x, s.y, s.z, s.w, s_model[i]) == best) f(i);
              }
            }
          }
        }
      };
      int first = Nm, ties = 0;
      for_each_tie([&](int i) {
        first = min(first, i);
        ++ties;
      });
      float wq = expf(-best / two_sigma2) / static_cast<float>(ties);
      if constexpr (kBf16) wq = bf(wq);
      auto add = [&](int i) {
        float ux, uy, uz, unx, uny, unz;
        if constexpr (kAccSmem) {
          const float4 u4 = s_u[i];
          const float2 n2 = s_un[i];
          ux = u4.x; uy = u4.y; uz = u4.z; unx = u4.w; uny = n2.x; unz = n2.y;
        } else {
          transform_rn(r, model_pts[3 * i], model_pts[3 * i + 1], model_pts[3 * i + 2], ux, uy, uz);
          rotate_rn(r, model_nrm[3 * i], model_nrm[3 * i + 1], model_nrm[3 * i + 2], unx, uny, unz);
        }
        accumulate<kBf16>(acc, ux, uy, uz, unx, uny, unz, wq, s.x, s.y, s.z);
      };
      if (ties == 1) {
        add(first);
      } else {
        for_each_tie(add);
      }
    }
    // Fixed-order sums of the tile: a shuffle tree per warp into its own row.
#pragma unroll
    for (int v = 0; v < kSums; ++v) {
      float x = acc[v];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0) s_wsum[warp][v] += x;
    }
    __syncthreads();  // s_res is rewritten by the next tile's scan
  }

  // The warps' rows in warp order.
  if (tid < kOut) {
    int v = 21 + tid - 36;  // b
    if (tid < 36) {
      const int a = tid / 6, b = tid % 6;
      const int lo = min(a, b), hi = max(a, b);
      v = lo * 6 - lo * (lo - 1) / 2 + hi - lo;
    }
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += s_wsum[w][v];
    out[kOut * h + tid] = total;
  }
}

template <bool kBf16, bool kAccSmem>
int launch(const float* tr, const float4* seg, const float* model_pts, const float* model_nrm,
           float* out, int H, int Ns, int Nm, float max_corr2, float two_sigma2,
           cudaStream_t st) {
  const int per_slice = (Nm + kSlices - 1) / kSlices;
  const int slice_len = (per_slice + kChunk - 1) / kChunk * kChunk;
  const int smem = kSlices * slice_len * static_cast<int>(sizeof(float4)) +
                   kSlices * kTile * static_cast<int>(sizeof(SliceResult)) +
                   (kAccSmem ? Nm * static_cast<int>(sizeof(float4) + sizeof(float2)) : 0);
  auto kern = icp_corr_segside_kernel<kBf16, kAccSmem>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kern<<<H, kThreads, smem, st>>>(tr, seg, model_pts, model_nrm, out, Ns, Nm, slice_len,
                                  max_corr2, two_sigma2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; allocates nothing. tier is 0 (fp32) or 1 ("default").
// Nm at most 8,192. Returns cudaGetLastError().
extern "C" int icp_corr_segside_launch(const float* tr, const float* seg,
                                       const float* model_pts, const float* model_nrm,
                                       float* out, int H, int Ns, int Nm, float max_corr2,
                                       float two_sigma2, int tier, void* stream) {
  if (H <= 0) return 0;
  if ((tier != 0 && tier != 1) || Nm < 1 || Nm > 8192 || Ns < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* seg4 = reinterpret_cast<const float4*>(seg);
#define ICP_LAUNCH(B, S) \
  return launch<B, S>(tr, seg4, model_pts, model_nrm, out, H, Ns, Nm, max_corr2, two_sigma2, st)
  if (Nm <= kAccSmemPoints) {
    if (tier == 1) ICP_LAUNCH(true, true);
    ICP_LAUNCH(false, true);
  }
  if (tier == 1) ICP_LAUNCH(true, false);
  ICP_LAUNCH(false, false);
#undef ICP_LAUNCH
}
