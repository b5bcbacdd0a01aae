// Weighted / unweighted LCP scores of H rigid hypotheses, segment-stationary.
//
// Replaces the TPU kernel physimglobalpose_tpu/ops/lcp.py::_lcp_kernel_segside
// (its fp32 tier: precision None / "highest"). For each hypothesis (R, t) and
// each model point m_i, u_i = R m_i + t; the nearest segment point j* minimises
//   d2 = |s_j|^2 + |u_i|^2 - 2 s_j . u_i
// (the same expansion as the TPU kernel, so both round alike). Masked or padded
// segment points carry |s|^2 = 1e9 and never match. The point contributes
//   unweighted: 1[d2* <= delta^2]
//   weighted:   1[d2* <= delta^2] * 1[|n_j* . R n_i| >= cos_gate] * prob_j*,
// where exact ties in d2 take the max prob and the max |ndot| (the TPU
// kernel's global min followed by max over ties). score = sum / Nv.
// Coordinates arrive centred at the masked segment centroid (the wrapper
// shifts t), which keeps |s|^2 and s.u at segment scale.
//
// What bounds it: fp32 arithmetic on the CUDA cores. The TPU kernel's
// arithmetic is about 16 FLOP per (hypothesis, model point, segment point)
// pair (a 5-term dot for d2, a 3-term dot for the normal); this kernel
// evaluates about 8 per pair (3 FMA + 1 add + the running min) and the
// normal dot only on a new nearest or a tie. At the main-path shape
// (H = 10,000, Nv = 4,096, Ns = 1,024) that is 4.2e10 pairs per object:
// 6.7e11 FLOP at 16/pair, ~10 ms at the 67 TFLOP/s fp32 peak of an H100 SXM
// (700 W); 5 ms at 8/pair. The inputs are a few hundred KB, so memory
// traffic is negligible.
// What the design does about it:
//  - one block per group of kHypsPerBlock hypotheses loads the packed segment
//    into shared memory once ([Ns] float4 positions + [Ns] float4 normals/prob,
//    32 KB at Ns = 1024; above 48 KB through the dynamic shared memory opt-in);
//  - every thread keeps kPointsPerThread model points in registers, so each
//    broadcast shared-memory read of a segment point feeds kPointsPerThread
//    independent FMA chains (3 FMA + 1 add + 1 compare per pair);
//  - the normal dot is evaluated only when a segment point ties or beats the
//    running nearest distance, which is rare after the first few points;
//  - the per-hypothesis sum is a warp-shuffle tree and a fixed-order sum over
//    warps: no atomics, so scores are deterministic.
// Tensor cores (a TF32 / bf16 tier), TMA and wgmma are not used here.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPointsPerThread = 8;
constexpr int kHypsPerBlock = 4;

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
lcp_segside_kernel(const float* __restrict__ tr,         // [H, 12] row-major (R | t)
                   const float* __restrict__ model_pts,  // [Nv, 3]
                   const float* __restrict__ model_nrm,  // [Nv, 3]
                   const float4* __restrict__ seg,       // [Ns, 2]: (x, y, z, |s|^2), (nx, ny, nz, prob)
                   float* __restrict__ out,              // [H]
                   int H, int Nv, int Ns, float delta2, float cos_gate) {
  extern __shared__ float4 smem[];
  float4* s_pos = smem;
  float4* s_nrm = smem + Ns;
  __shared__ float s_warp[kThreads / 32];

  const int tid = threadIdx.x;
  for (int j = tid; j < Ns; j += kThreads) {
    s_pos[j] = seg[2 * j];
    s_nrm[j] = seg[2 * j + 1];
  }
  __syncthreads();

  const int block = static_cast<int>(blockIdx.x);
  const int h_end = min(H, (block + 1) * kHypsPerBlock);
  for (int h = block * kHypsPerBlock; h < h_end; ++h) {
    const float* r = tr + 12 * h;
    const float r00 = r[0], r01 = r[1], r02 = r[2], t0 = r[3];
    const float r10 = r[4], r11 = r[5], r12 = r[6], t1 = r[7];
    const float r20 = r[8], r21 = r[9], r22 = r[10], t2 = r[11];

    float acc = 0.f;
    for (int base = 0; base < Nv; base += kThreads * kPointsPerThread) {
      float ax[kPointsPerThread], ay[kPointsPerThread], az[kPointsPerThread];
      float uq[kPointsPerThread], best[kPointsPerThread];
      float nx[kPointsPerThread], ny[kPointsPerThread], nz[kPointsPerThread];
      float pb[kPointsPerThread], ab[kPointsPerThread];
#pragma unroll
      for (int k = 0; k < kPointsPerThread; ++k) {
        const int i = base + k * kThreads + tid;
        float mx = 0.f, my = 0.f, mz = 0.f, mnx = 0.f, mny = 0.f, mnz = 0.f;
        if (i < Nv) {
          mx = model_pts[3 * i];
          my = model_pts[3 * i + 1];
          mz = model_pts[3 * i + 2];
          mnx = model_nrm[3 * i];
          mny = model_nrm[3 * i + 1];
          mnz = model_nrm[3 * i + 2];
        }
        const float ux = r00 * mx + r01 * my + r02 * mz + t0;
        const float uy = r10 * mx + r11 * my + r12 * mz + t1;
        const float uz = r20 * mx + r21 * my + r22 * mz + t2;
        ax[k] = -2.f * ux;
        ay[k] = -2.f * uy;
        az[k] = -2.f * uz;
        uq[k] = ux * ux + uy * uy + uz * uz;
        best[k] = INFINITY;
        nx[k] = r00 * mnx + r01 * mny + r02 * mnz;
        ny[k] = r10 * mnx + r11 * mny + r12 * mnz;
        nz[k] = r20 * mnx + r21 * mny + r22 * mnz;
        pb[k] = 0.f;
        ab[k] = 0.f;
      }

      for (int j = 0; j < Ns; ++j) {
        const float4 s = s_pos[j];
#pragma unroll
        for (int k = 0; k < kPointsPerThread; ++k) {
          const float d = fmaf(s.x, ax[k], fmaf(s.y, ay[k], fmaf(s.z, az[k], s.w + uq[k])));
          if constexpr (kWeighted) {
            if (d <= best[k]) {
              const float4 n = s_nrm[j];
              const float nd = fabsf(n.x * nx[k] + n.y * ny[k] + n.z * nz[k]);
              if (d < best[k]) {
                best[k] = d;
                pb[k] = n.w;
                ab[k] = nd;
              } else {
                pb[k] = fmaxf(pb[k], n.w);
                ab[k] = fmaxf(ab[k], nd);
              }
            }
          } else {
            best[k] = fminf(best[k], d);
          }
        }
      }

#pragma unroll
      for (int k = 0; k < kPointsPerThread; ++k) {
        const int i = base + k * kThreads + tid;
        if (i < Nv && best[k] <= delta2) {
          if constexpr (kWeighted) {
            acc += (ab[k] >= cos_gate) ? pb[k] : 0.f;
          } else {
            acc += 1.f;
          }
        }
      }
    }

    // Fixed-order block sum: warp shuffle tree, then warp partials in order.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if ((tid & 31) == 0) s_warp[tid >> 5] = acc;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) total += s_warp[w];
      out[h] = total / static_cast<float>(Nv);
    }
    __syncthreads();
  }
}

}  // namespace

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
extern "C" int lcp_segside_launch(const float* tr, const float* model_pts,
                                  const float* model_nrm, const float* seg, float* out,
                                  int H, int Nv, int Ns, float delta2, float cos_gate,
                                  int weighted, void* stream) {
  if (H <= 0) return 0;
  const int smem = Ns * 2 * static_cast<int>(sizeof(float4));
  const int blocks = (H + kHypsPerBlock - 1) / kHypsPerBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* seg4 = reinterpret_cast<const float4*>(seg);
  if (weighted) {
    cudaFuncSetAttribute(lcp_segside_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    lcp_segside_kernel<true><<<blocks, kThreads, smem, st>>>(
        tr, model_pts, model_nrm, seg4, out, H, Nv, Ns, delta2, cos_gate);
  } else {
    cudaFuncSetAttribute(lcp_segside_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    lcp_segside_kernel<false><<<blocks, kThreads, smem, st>>>(
        tr, model_pts, model_nrm, seg4, out, H, Nv, Ns, delta2, cos_gate);
  }
  return static_cast<int>(cudaGetLastError());
}
