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
// (S_i, W_i) built by a one-hot matrix product; here each thread sums over its
// own segment points, so nothing is scattered and no atomics are needed. Only
// the order of the sums differs.
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
// What bounds it: fp32 arithmetic on the CUDA cores, Ns * Nm pairs per
// hypothesis at 4 (fused) or 7 (unfused) operations plus the running min; the
// inputs are tens of KB and the output 42 floats per hypothesis. At the ICP
// tier's shape (H = 256, Ns = Nm = 512) that is 6.7e7 pairs, microseconds of
// arithmetic, so a pass is bound by its launch and by how many blocks fill the
// card (H blocks on 132 SMs).
// What the design does about it:
//  - one block per hypothesis; the transformed model's d2 operands sit in
//    shared memory once (16 bytes per model point, 128 KB at the largest model
//    the wrapper takes), read as broadcasts;
//  - every thread keeps kSegPerThread segment points in registers, so each
//    shared-memory read feeds that many independent chains;
//  - the running min carries the first nearest index and a tie count; the
//    Jacobian row is rebuilt from the model point only once per segment point,
//    and a second scan runs only for a segment point whose minimum is tied;
//  - 21 + 6 per-thread sums, then a warp-shuffle tree and a fixed-order sum
//    over warps: deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSegPerThread = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;  // upper triangle of A (21), then b (6)
constexpr int kOut = 42;   // A row-major (36), then b (6)

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

// Adds model point i's share (weight wq) of segment point (sx, sy, sz).
template <bool kBf16>
__device__ __forceinline__ void accumulate(float (&acc)[kSums], const float* r,
                                           const float* __restrict__ model_pts,
                                           const float* __restrict__ model_nrm, int i,
                                           float wq, float sx, float sy, float sz) {
  float ux, uy, uz;
  transform_rn(r, model_pts[3 * i], model_pts[3 * i + 1], model_pts[3 * i + 2], ux, uy, uz);
  const float nx = model_nrm[3 * i], ny = model_nrm[3 * i + 1], nz = model_nrm[3 * i + 2];
  const float unx = dot3_rn(r[0], nx, r[1], ny, r[2], nz);
  const float uny = dot3_rn(r[4], nx, r[5], ny, r[6], nz);
  const float unz = dot3_rn(r[8], nx, r[9], ny, r[10], nz);
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

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
icp_corr_segside_kernel(const float* __restrict__ tr,         // [H, 12] row-major (R | t)
                        const float4* __restrict__ seg,       // [Ns]: (x, y, z, |s|^2)
                        const float* __restrict__ model_pts,  // [Nm, 3]
                        const float* __restrict__ model_nrm,  // [Nm, 3]
                        float* __restrict__ out,              // [H, 42]
                        int Ns, int Nm, float max_corr2, float two_sigma2) {
  extern __shared__ float4 s_model[];  // [Nm]: (-2u, |u|^2), rounded per tier
  __shared__ float s_red[kWarps][kSums];
  __shared__ float s_tot[kSums];

  const int tid = threadIdx.x;
  const int h = static_cast<int>(blockIdx.x);
  float r[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) r[c] = tr[12 * h + c];

  for (int i = tid; i < Nm; i += kThreads) {
    float ux, uy, uz;
    transform_rn(r, model_pts[3 * i], model_pts[3 * i + 1], model_pts[3 * i + 2], ux, uy, uz);
    float4 p = make_float4(-2.f * ux, -2.f * uy, -2.f * uz, dot3_rn(ux, ux, uy, uy, uz, uz));
    if constexpr (kBf16) p = make_float4(bf(p.x), bf(p.y), bf(p.z), bf(p.w));
    s_model[i] = p;
  }
  __syncthreads();

  float acc[kSums];
#pragma unroll
  for (int v = 0; v < kSums; ++v) acc[v] = 0.f;

  for (int base = 0; base < Ns; base += kThreads * kSegPerThread) {
    float sx[kSegPerThread], sy[kSegPerThread], sz[kSegPerThread], sw[kSegPerThread];
    float best[kSegPerThread];
    int first[kSegPerThread], ties[kSegPerThread];
#pragma unroll
    for (int k = 0; k < kSegPerThread; ++k) {
      const int j = base + k * kThreads + tid;
      float4 s = make_float4(0.f, 0.f, 0.f, 1e9f);
      if (j < Ns) s = seg[j];
      if constexpr (kBf16) s = make_float4(bf(s.x), bf(s.y), bf(s.z), bf(s.w));
      sx[k] = s.x; sy[k] = s.y; sz[k] = s.z; sw[k] = s.w;
      best[k] = INFINITY;
      first[k] = 0;
      ties[k] = 0;
    }

    for (int i = 0; i < Nm; ++i) {
      const float4 p = s_model[i];
#pragma unroll
      for (int k = 0; k < kSegPerThread; ++k) {
        const float d = pair_d2<kBf16>(sx[k], sy[k], sz[k], sw[k], p);
        if (d < best[k]) {
          best[k] = d;
          first[k] = i;
          ties[k] = 1;
        } else if (d == best[k]) {
          ++ties[k];
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kSegPerThread; ++k) {
      const int j = base + k * kThreads + tid;
      if (j >= Ns || !(best[k] <= max_corr2)) continue;
      float wq = expf(-best[k] / two_sigma2) / static_cast<float>(ties[k]);
      if constexpr (kBf16) wq = bf(wq);
      if (ties[k] == 1) {
        accumulate<kBf16>(acc, r, model_pts, model_nrm, first[k], wq, sx[k], sy[k], sz[k]);
      } else {
        for (int i = first[k]; i < Nm; ++i) {
          if (pair_d2<kBf16>(sx[k], sy[k], sz[k], sw[k], s_model[i]) == best[k]) {
            accumulate<kBf16>(acc, r, model_pts, model_nrm, i, wq, sx[k], sy[k], sz[k]);
          }
        }
      }
    }
  }

  // Fixed-order block sums: warp shuffle tree, then warp partials in order.
#pragma unroll
  for (int v = 0; v < kSums; ++v) {
    float x = acc[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if ((tid & 31) == 0) s_red[tid >> 5][v] = x;
  }
  __syncthreads();
  if (tid < kSums) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += s_red[w][tid];
    s_tot[tid] = total;
  }
  __syncthreads();
  if (tid < kOut) {
    float v;
    if (tid < 36) {
      const int a = tid / 6, b = tid % 6;
      const int lo = min(a, b), hi = max(a, b);
      v = s_tot[lo * 6 - lo * (lo - 1) / 2 + hi - lo];
    } else {
      v = s_tot[21 + tid - 36];
    }
    out[kOut * h + tid] = v;
  }
}

}  // namespace

// Launches on `stream`; allocates nothing. tier is 0 (fp32) or 1 ("default").
// Returns cudaGetLastError().
extern "C" int icp_corr_segside_launch(const float* tr, const float* seg,
                                       const float* model_pts, const float* model_nrm,
                                       float* out, int H, int Ns, int Nm, float max_corr2,
                                       float two_sigma2, int tier, void* stream) {
  if (H <= 0) return 0;
  if (tier != 0 && tier != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Nm * static_cast<int>(sizeof(float4));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* seg4 = reinterpret_cast<const float4*>(seg);
  auto kern = tier == 1 ? icp_corr_segside_kernel<true> : icp_corr_segside_kernel<false>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kern<<<H, kThreads, smem, st>>>(tr, seg4, model_pts, model_nrm, out, Ns, Nm, max_corr2,
                                  two_sigma2);
  return static_cast<int>(cudaGetLastError());
}
