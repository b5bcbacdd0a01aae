// One point-to-plane ICP correspondence pass for H hypotheses over a model and
// a segment of any size: the 6x6 normal equations (A, b) per hypothesis,
// model-streaming.
//
// Replaces the TPU kernel
//   physimglobalpose_tpu/ops/icp.py::_icp_corr_kernel
// (reached through _icp_pallas_pass / refine_icp_pallas).
//
// For hypothesis (R, t) every model point is transformed, p_i = R m_i + t,
// n_i = R nrm_i, in the scene frame (no centring). The model passes by in
// tiles of nm_tile points (an argument; the TPU wrapper uses 256). For each
// segment point s
//   d2[i]   = (|s|^2 + |p_i|^2) - 2 s . p_i        (the TPU kernel's expansion)
//   tile    : the least d2 of the tile and the MEAN of (p_i, n_i) over the
//             tile's exactly tied nearest points (so a matched normal can be
//             shorter than 1);
//   running : a later tile replaces the match only when strictly nearer; the
//             running minimum starts at 1e9;
//   w       = exp(-d2* / (2 sigma^2)) if d2* <= max_corr^2 and s is unmasked,
//             else 0; sigma = max_corr / 2 (Welsch);
//   r = (p - s) . n,   c = (p x n, n):   A = sum w c c^T,   b = -sum w c r.
// One running state per segment point does the tile rule: "<" replaces it and
// marks it as set in this tile, "==" joins the mean only while that mark is up,
// and at every tile edge the sum is divided by its count and the mark drops.
// The tile is independent of how many model points the kernel stages at a time.
// float32 only, as the TPU kernel.
//
// p, n, |p|^2 and |s|^2 are computed with separately rounded products and sums
// in a fixed order and d2 is an explicit fmaf chain, which the plain PyTorch
// version (ops/icp.py::icp_stream_pass_plain) reproduces through float64, so
// both find bit-identical distances, ties and weights; only the order of the
// sums over segment points differs.
//
// What bounds it: fp32 arithmetic on the CUDA cores, Ns * Nm pairs per
// hypothesis at 3 FMA + 1 add + the running min (about 8 FLOP) against
// 67 TFLOP/s; the inputs are tens of KB, the output 42 floats a hypothesis.
// What the design does about it:
//  - grid H x segment chunks of kThreads * kPts points: a block transforms the
//    whole model for its hypothesis once more per chunk (about 40 FLOP a model
//    point against 8 * 512 for its pairs), which buys Ns / 512 times as many
//    blocks as one block per hypothesis would give (256 hypotheses x 8 chunks
//    at Ns = 4,096) and keeps a thread's state to kPts segment points;
//  - model tiles are transformed once per block into shared memory, read as
//    broadcasts; each read feeds kPts independent FMA chains;
//  - the matched point and normal are read only on a new nearest or a tie;
//  - 21 + 6 per-thread sums over a thread's own segment points, a warp-shuffle
//    tree, a fixed-order sum over warps, and a second kernel that adds the
//    chunks per hypothesis in index order. No scatter, no atomics:
//    deterministic.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPts = 2;      // segment points per thread
constexpr int kStage = 256;  // model points staged at a time
constexpr int kSums = 27;    // upper triangle of A (21), then b (6)
constexpr int kOut = 42;     // A row-major (36), then b (6)
constexpr float kBig = 1e9f;

__device__ __forceinline__ float dot3_rn(float a, float x, float b, float y, float c, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

// Running match of one segment point: nearest d2, the sum of (p, n) over the
// ties of the tile that set it, and their count.
struct Match {
  float best;
  float v[6];
  float cnt;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads) icp_corr_stream_kernel(
    const float* __restrict__ tr,         // [H, 12] row-major (R | t), scene frame
    const float4* __restrict__ seg,       // [Ns]: x, y, z, mask
    const float* __restrict__ model_pts,  // [Nm, 3]
    const float* __restrict__ model_nrm,  // [Nm, 3]
    float* __restrict__ partial,          // [H, n_chunks, 27]
    int Ns, int Nm, int nm_tile, int n_chunks, float max_corr2, float two_sigma2) {
  __shared__ float4 s_p[kStage];  // p, |p|^2
  __shared__ float4 s_n[kStage];  // n
  __shared__ float s_warp[kSums][kWarps];

  const int tid = threadIdx.x;
  const int h = static_cast<int>(blockIdx.x) / n_chunks;
  const int chunk = static_cast<int>(blockIdx.x) % n_chunks;

  float r[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) r[c] = tr[12 * h + c];

  float sx[kPts], sy[kPts], sz[kPts], ssq[kPts];
  bool valid[kPts];
  Match q[kPts];
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    const int j = (chunk * kPts + k) * kThreads + tid;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < Ns) s = seg[j];
    sx[k] = s.x; sy[k] = s.y; sz[k] = s.z;
    ssq[k] = dot3_rn(s.x, s.x, s.y, s.y, s.z, s.z);
    valid[k] = s.w > 0.5f;  // false beyond Ns
    q[k].best = kBig;
    q[k].cnt = 1.f;
#pragma unroll
    for (int c = 0; c < 6; ++c) q[k].v[c] = 0.f;
  }

  for (int tile0 = 0; tile0 < Nm; tile0 += nm_tile) {
    const int tile_end = min(Nm, tile0 + nm_tile);
    unsigned fresh = 0u;  // bit k: q[k] was set in this tile
    for (int c0 = tile0; c0 < tile_end; c0 += kStage) {
      const int n = min(kStage, tile_end - c0);
      __syncthreads();  // the previous chunk has been scanned
      for (int i = tid; i < n; i += kThreads) {
        const float* m = model_pts + 3 * (c0 + i);
        const float* mn = model_nrm + 3 * (c0 + i);
        const float px = __fadd_rn(dot3_rn(r[0], m[0], r[1], m[1], r[2], m[2]), r[3]);
        const float py = __fadd_rn(dot3_rn(r[4], m[0], r[5], m[1], r[6], m[2]), r[7]);
        const float pz = __fadd_rn(dot3_rn(r[8], m[0], r[9], m[1], r[10], m[2]), r[11]);
        s_p[i] = make_float4(px, py, pz, dot3_rn(px, px, py, py, pz, pz));
        s_n[i] = make_float4(dot3_rn(r[0], mn[0], r[1], mn[1], r[2], mn[2]),
                             dot3_rn(r[4], mn[0], r[5], mn[1], r[6], mn[2]),
                             dot3_rn(r[8], mn[0], r[9], mn[1], r[10], mn[2]), 0.f);
      }
      __syncthreads();
      for (int i = 0; i < n; ++i) {
        const float4 p = s_p[i];
#pragma unroll
        for (int k = 0; k < kPts; ++k) {
          const float d = fmaf(-2.f * sx[k], p.x,
                               fmaf(-2.f * sy[k], p.y,
                                    fmaf(-2.f * sz[k], p.z, __fadd_rn(ssq[k], p.w))));
          if (d <= q[k].best) {
            const bool nearer = d < q[k].best;
            if (nearer || (fresh >> k & 1u)) {
              const float4 nn = s_n[i];
              if (nearer) {
                q[k].best = d;
                q[k].cnt = 1.f;
                q[k].v[0] = p.x; q[k].v[1] = p.y; q[k].v[2] = p.z;
                q[k].v[3] = nn.x; q[k].v[4] = nn.y; q[k].v[5] = nn.z;
                fresh |= 1u << k;
              } else {
                q[k].cnt += 1.f;
                q[k].v[0] += p.x; q[k].v[1] += p.y; q[k].v[2] += p.z;
                q[k].v[3] += nn.x; q[k].v[4] += nn.y; q[k].v[5] += nn.z;
              }
            }
          }
        }
      }
    }
    // Tile edge: a match this tile set becomes the mean over its ties.
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      if ((fresh >> k & 1u) && q[k].cnt > 1.f) {
#pragma unroll
        for (int c = 0; c < 6; ++c) q[k].v[c] = q[k].v[c] / q[k].cnt;
        q[k].cnt = 1.f;
      }
    }
  }

  float acc[kSums];
#pragma unroll
  for (int c = 0; c < kSums; ++c) acc[c] = 0.f;
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    if (!valid[k] || !(q[k].best <= max_corr2)) continue;
    const float w = expf(-q[k].best / two_sigma2);
    const float px = q[k].v[0], py = q[k].v[1], pz = q[k].v[2];
    const float nx = q[k].v[3], ny = q[k].v[4], nz = q[k].v[5];
    const float res = (px - sx[k]) * nx + (py - sy[k]) * ny + (pz - sz[k]) * nz;
    float col[6];
    col[0] = py * nz - pz * ny;
    col[1] = pz * nx - px * nz;
    col[2] = px * ny - py * nx;
    col[3] = nx; col[4] = ny; col[5] = nz;
    int o = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float wa = w * col[a];
#pragma unroll
      for (int b = a; b < 6; ++b) acc[o++] += wa * col[b];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] -= w * col[a] * res;
  }

  // Fixed-order block sums: warp shuffle tree, then warp partials in order.
#pragma unroll
  for (int c = 0; c < kSums; ++c) {
    const float v = warp_sum(acc[c]);
    if ((tid & 31) == 0) s_warp[c][tid >> 5] = v;
  }
  __syncthreads();
  if (tid < kSums) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += s_warp[tid][w];
    partial[(static_cast<size_t>(h) * n_chunks + chunk) * kSums + tid] = total;
  }
}

// out[h] = the chunks' sums added in chunk order, A unfolded to 6x6 row-major.
__global__ void icp_corr_stream_finish_kernel(const float* __restrict__ partial,
                                              float* __restrict__ out, int n_chunks) {
  __shared__ float s_sum[kSums];
  const int h = blockIdx.x, tid = threadIdx.x;
  if (tid < kSums) {
    float total = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      total += partial[(static_cast<size_t>(h) * n_chunks + c) * kSums + tid];
    }
    s_sum[tid] = total;
  }
  __syncthreads();
  if (tid < 36) {
    const int a = min(tid / 6, tid % 6), b = max(tid / 6, tid % 6);
    // Index of (a, b), a <= b, in the row-major upper triangle.
    out[h * kOut + tid] = s_sum[a * 6 - a * (a - 1) / 2 + (b - a)];
  } else if (tid < kOut) {
    out[h * kOut + tid] = s_sum[21 + tid - 36];
  }
}

}  // namespace

// Launches on `stream` and allocates nothing: `partial` is the caller's workspace
// of H * ceil(Ns / 512) * 27 floats. Returns cudaGetLastError().
extern "C" int icp_corr_stream_launch(const float* tr, const float* seg, const float* model_pts,
                                      const float* model_nrm, float* partial, float* out, int H,
                                      int Ns, int Nm, int nm_tile, float max_corr2,
                                      float two_sigma2, void* stream) {
  if (H <= 0) return 0;
  if (Ns <= 0 || Nm <= 0 || nm_tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (Ns + kThreads * kPts - 1) / (kThreads * kPts);
  icp_corr_stream_kernel<<<H * n_chunks, kThreads, 0, st>>>(
      tr, reinterpret_cast<const float4*>(seg), model_pts, model_nrm, partial, Ns, Nm, nm_tile,
      n_chunks, max_corr2, two_sigma2);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  icp_corr_stream_finish_kernel<<<H, 64, 0, st>>>(partial, out, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
