// Weighted / unweighted LCP scores of H rigid hypotheses against a segment of
// any size, streaming: two kernels that compute one function.
//
//   lcp_stream_kernel       replaces the TPU kernel
//       physimglobalpose_tpu/ops/lcp.py::_lcp_kernel (body _score_one)
//     (one hypothesis and one tile of model points per block);
//   lcp_stream_wide_kernel  replaces
//       scripts/lcp_wide_kernel_experiment.py::_lcp_kernel_wide
//     (a group of 8 hypotheses per block share the pass over each segment tile).
//
// A segment above 2,048 points does not fit the shared memory of the
// segment-stationary kernels (lcp_segside.cu), so here the model points stay in
// registers and the segment streams past them. For hypothesis (R, t) a segment
// point s with normal n_s is carried into the model frame once,
//   q = R^T (s - t),  c = |s - t|^2 (1e9 where masked),  bn = R^T n_s,
// and for model point m with normal n_m
//   d2 = (c + |m|^2) - 2 m . q,   ndot = n_m . bn
// (the TPU kernel's two products; no centring: the coordinates are the scene's).
// The model point contributes
//   unweighted: 1[d2* <= delta^2]
//   weighted:   1[d2* <= delta^2] * 1[|ndot*| >= cos_gate] * prob*,
// score = sum / Nv.
//
// Tie rule, the TPU kernels': the segment is cut into tiles of ns_tile points
// (an argument: the TPU wrappers use min(1024, pad128(Ns)) and 128). Within a
// tile exact ties of the nearest distance take the max prob and the max
// |ndot|; across tiles a later tile replaces the running nearest only when it
// is strictly nearer. One running state per model point does it: "<" replaces
// and marks the state as set in this tile, "==" joins only while that mark is
// up, and the marks drop at every tile edge (both kernels carry only which
// chunks of the tile reached the minimum, and look the attributes up after
// the scan). The running minimum starts at 1e9, so a masked point (d2 = 1e9
// in float32) never replaces it. The tile is independent of how many points a kernel stages at a
// time.
//
// Tiers (the rounding places of the TPU kernels' matmul_precision):
//   fp32      every operand and product in float32 (FMA chain);
//   "default" both operands of both products rounded to bf16, (m, |m|^2, n_m)
//             and (-2q, c, bn); products and sums in float32. A product of two
//             bf16 values is exact in float32, so this is the bf16 matrix pass
//             with a float32 sum, up to the order of the sum.
// q, c, bn and |m|^2 are computed with separately rounded products and sums in a
// fixed order (no FMA contraction), so the plain PyTorch version sees the same
// float32 values before they round to bf16; the two products are explicit fmaf
// chains in a fixed order, which the plain version reproduces through float64
// (ops/lcp.py::fma). Both therefore find the same nearest points in each tier.
// There is no "high3" tier: the wrapper runs it in float32, as the TPU wrapper
// does.
//
// What bounds them: fp32 arithmetic on the CUDA cores, 1 add + 3 FMA + the
// running min per (hypothesis, model point, segment point), counted as 8 FLOP,
// against 67 TFLOP/s; the inputs are a few hundred KB. What the design does:
//  - a staged segment point is transformed once per (hypothesis, point), about
//    40 FLOP shared by all model points of the block, not once per pair;
//  - lcp_stream_kernel: grid H x model tiles of kThreads * kSlots points, so a
//    call with few hypotheses (H = 32 in the exact tier) still makes
//    32 * Nv / 1024 blocks; each broadcast shared-memory read feeds kSlots
//    independent FMA chains;
//  - its weighted variant runs the unweighted inner loop: only the running
//    minimum, over chunks of 32 staged points (a chunk never straddles a tile
//    edge). After a chunk two compares per slot keep the tile that set the
//    nearest and a bit mask of its chunks that reached it ("<" replaces, in
//    any tile; "==" joins only while that tile lasts; in the "default" tier
//    equal d2 are common). Neither normals nor probabilities are staged.
//    After the scan a slot within delta^2 transforms the points of those
//    chunks again, with the staging's instructions, hence the same bits, and
//    takes prob and |ndot| of every point whose d2 equals the minimum: the tie
//    rule above. That is about 32 of Ns points a second time, in place of a
//    branch, a second shared-memory read and three state words on every pair
//    (ptxas: 63 registers weighted, 80 / 74 before; 39 unweighted, 48 before);
//  - lcp_stream_wide_kernel: on this card the TPU's "one wide product for 8
//    hypotheses" is slot filling: a block takes 8 hypotheses, one warp each,
//    on a model tile of 32 * kWidePts points, so a small model (Nv = 512)
//    fills every slot where lcp_stream_kernel would leave half on padding. A
//    warp stages its hypothesis's transformed segment, kWideStage points (8
//    chunks) between two __syncwarp, and a lane holds kWidePts model points,
//    so each broadcast shared-memory read feeds kWidePts pairs. It runs
//    lcp_stream_kernel's weighted scan and looks the attributes up after it
//    with the same nearest_attributes; its chunks never straddle a tile edge
//    (a tile of ns_tile points takes ceil(ns_tile / kChunk) of them). The
//    design it replaced held 2 model points under all 8 hypotheses a thread, read 2
//    pairs per shared-memory read, synchronised the block every 128 points
//    and branched per pair to the normal dot when weighted;
//  - one partial sum per (hypothesis, model tile), through a warp-shuffle
//    tree (lcp_stream_kernel then a fixed-order sum over warps); a second kernel adds
//    the tiles per hypothesis in index order. No atomics: scores are
//    deterministic.
// Both kernels evaluate a pair with the same instructions on the same staged
// values, so they agree exactly on every nearest point; only the order of the
// sum over model points differs (tiles of 1,024 against 256).
// Tensor cores, TMA and wgmma are not used here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;      // lcp_stream_kernel: model points per thread
constexpr int kStage = 512;    // lcp_stream_kernel: segment points staged at a time
constexpr int kChunk = 32;     // lcp_stream_kernel: staged points per chunk of the weighted scan
constexpr int kHypGroup = 8;   // lcp_stream_wide_kernel: hypotheses per block (one warp each)
constexpr int kWidePts = 8;    // lcp_stream_wide_kernel: model points per thread
constexpr int kWideStage = 256;  // lcp_stream_wide_kernel: segment points a warp stages at a time
constexpr float kBig = 1e9f;

constexpr int kFp32 = 0;
constexpr int kBf16 = 1;

static_assert(kHypGroup == kWarps, "a warp per hypothesis of the group");
static_assert(kStage % kChunk == 0 && kWideStage % kChunk == 0,
              "a stage is a whole number of chunks");
static_assert(kChunk == 32, "lcp_stream_wide_kernel stages a chunk with one point a lane");

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (a x + b y) + c z with every product and sum rounded on its own.
__device__ __forceinline__ float dot3_rn(float a, float x, float b, float y, float c, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

// Segment point j carried into the model frame of hypothesis r (row-major
// R | t): a = (-2q, c), n = (bn, prob).
template <int kTier>
__device__ __forceinline__ float4 stage_position(const float* r, const float4* __restrict__ seg,
                                                 int j) {
  const float4 p = seg[2 * j];  // x, y, z, mask
  const float dx = __fsub_rn(p.x, r[3]), dy = __fsub_rn(p.y, r[7]), dz = __fsub_rn(p.z, r[11]);
  float ax = -2.f * dot3_rn(r[0], dx, r[4], dy, r[8], dz);
  float ay = -2.f * dot3_rn(r[1], dx, r[5], dy, r[9], dz);
  float az = -2.f * dot3_rn(r[2], dx, r[6], dy, r[10], dz);
  float c = (p.w > 0.5f) ? dot3_rn(dx, dx, dy, dy, dz, dz) : kBig;
  if constexpr (kTier == kBf16) {
    ax = bf(ax); ay = bf(ay); az = bf(az); c = bf(c);
  }
  return make_float4(ax, ay, az, c);
}

template <int kTier>
__device__ __forceinline__ float4 stage_normal(const float* r, const float4* __restrict__ seg,
                                               int j) {
  const float4 q = seg[2 * j + 1];  // nx, ny, nz, prob
  float bx = dot3_rn(r[0], q.x, r[4], q.y, r[8], q.z);
  float by = dot3_rn(r[1], q.x, r[5], q.y, r[9], q.z);
  float bz = dot3_rn(r[2], q.x, r[6], q.y, r[10], q.z);
  if constexpr (kTier == kBf16) {
    bx = bf(bx); by = bf(by); bz = bf(bz);
  }
  return make_float4(bx, by, bz, q.w);
}

// A model point as the d2 and normal products take it.
struct ModelPoint {
  float x, y, z, sq;  // m, |m|^2
  float nx, ny, nz;   // n_m
};

template <int kTier, bool kWeighted>
__device__ __forceinline__ ModelPoint load_model(const float* __restrict__ pts,
                                                 const float* __restrict__ nrm, int i, int n) {
  ModelPoint m = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (i < n) {
    m.x = pts[3 * i]; m.y = pts[3 * i + 1]; m.z = pts[3 * i + 2];
    m.sq = dot3_rn(m.x, m.x, m.y, m.y, m.z, m.z);
    if constexpr (kWeighted) {
      m.nx = nrm[3 * i]; m.ny = nrm[3 * i + 1]; m.nz = nrm[3 * i + 2];
    }
    if constexpr (kTier == kBf16) {
      m.x = bf(m.x); m.y = bf(m.y); m.z = bf(m.z); m.sq = bf(m.sq);
      m.nx = bf(m.nx); m.ny = bf(m.ny); m.nz = bf(m.nz);
    }
  }
  return m;
}

// d2 of model point m against the staged point a, and |ndot| against the staged
// normal n: the two products, each summed in this fixed order.
__device__ __forceinline__ float pair_d2(const ModelPoint& m, const float4& a) {
  return fmaf(m.x, a.x, fmaf(m.y, a.y, fmaf(m.z, a.z, __fadd_rn(a.w, m.sq))));
}

__device__ __forceinline__ float pair_ndot(const ModelPoint& m, const float4& n) {
  return fabsf(fmaf(m.nz, n.z, fmaf(m.ny, n.y, __fmul_rn(m.nx, n.x))));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

#define LCP_STREAM_ARGS                                                                     \
  const float* __restrict__ tr,          /* [H, 12] row-major (R | t), scene frame */       \
  const float* __restrict__ model_pts,   /* [Nv, 3] */                                      \
  const float* __restrict__ model_nrm,   /* [Nv, 3] */                                      \
  const float4* __restrict__ seg,        /* [Ns, 2]: (x, y, z, mask), (nx, ny, nz, prob) */ \
  float* __restrict__ partial,           /* [H, n_mtiles] sums over one model tile */       \
  int H, int Nv, int Ns, int ns_tile, int n_mtiles, float delta2, float cos_gate

// What a slot within delta^2 contributes when weighted. The nearest points lie
// in the tile that starts at tile0, in the chunks named in `hit` (chunk q of
// the tile sets bit q mod 32). Those points are transformed again and every one
// whose d2 equals `best` gives its prob and |ndot| (max over ties).
template <int kTier>
__device__ __forceinline__ float nearest_attributes(const ModelPoint& m, float best, int tile0,
                                                    unsigned hit, const float* r,
                                                    const float4* __restrict__ seg, int Ns,
                                                    int ns_tile, float cos_gate) {
  const int tile_end = min(Ns, tile0 + ns_tile);
  float pb = -INFINITY, ab = -1.f;
  for (; hit != 0u; hit &= hit - 1u) {
    for (int c = tile0 + (__ffs(hit) - 1) * kChunk; c < tile_end; c += 32 * kChunk) {
      const int c_end = min(c + kChunk, tile_end);
      for (int j = c; j < c_end; ++j) {
        if (pair_d2(m, stage_position<kTier>(r, seg, j)) == best) {
          const float4 n = stage_normal<kTier>(r, seg, j);
          pb = fmaxf(pb, n.w);
          ab = fmaxf(ab, pair_ndot(m, n));
        }
      }
    }
  }
  return (ab >= cos_gate) ? pb : 0.f;
}

// What model point i (slot m, nearest d2 best) contributes after the scan;
// when weighted its normal is read here, by the slots within delta^2 only.
template <int kTier, bool kWeighted>
__device__ __forceinline__ float contribution(ModelPoint& m, float best, int tile_of,
                                              unsigned hit, int i, const float* r,
                                              const float* __restrict__ model_nrm,
                                              const float4* __restrict__ seg, int Nv, int Ns,
                                              int ns_tile, float delta2, float cos_gate) {
  if (i >= Nv || !(best <= delta2)) return 0.f;
  if constexpr (kWeighted) {
    m.nx = model_nrm[3 * i]; m.ny = model_nrm[3 * i + 1]; m.nz = model_nrm[3 * i + 2];
    if constexpr (kTier == kBf16) {
      m.nx = bf(m.nx); m.ny = bf(m.ny); m.nz = bf(m.nz);
    }
    return nearest_attributes<kTier>(m, best, tile_of, hit, r, seg, Ns, ns_tile, cos_gate);
  } else {
    return 1.f;
  }
}

// The chunk-mask update of the weighted scan after a chunk of tile `tile0`
// whose minimum is cm: "<" replaces in any tile; "==" joins only in the tile
// that set the nearest.
__device__ __forceinline__ void join_chunk(float cm, float& best, int& tile_of, unsigned& hit,
                                           int tile0, unsigned bit) {
  const bool nearer = cm < best;
  const bool joins = cm == best && tile_of == tile0;
  hit = nearer ? bit : (joins ? (hit | bit) : hit);
  tile_of = nearer ? tile0 : tile_of;
  best = fminf(best, cm);
}

// One hypothesis, one tile of kThreads * kSlots model points.
template <int kTier, bool kWeighted>
__global__ void __launch_bounds__(kThreads) lcp_stream_kernel(LCP_STREAM_ARGS) {
  __shared__ float4 s_a[kStage];
  __shared__ float s_warp[kWarps];

  const int tid = threadIdx.x;
  const int h = static_cast<int>(blockIdx.x) / n_mtiles;
  const int mt = static_cast<int>(blockIdx.x) % n_mtiles;

  float r[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) r[c] = tr[12 * h + c];

  // The model normals are read after the scan, by the slots that need them.
  ModelPoint m[kSlots];
  float best[kSlots];
  int tile_of[kSlots];   // weighted: first point of the tile that set best[k]
  unsigned hit[kSlots];  // weighted: the chunks of that tile that reached best[k]
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    m[k] = load_model<kTier, false>(model_pts, model_nrm, (mt * kSlots + k) * kThreads + tid, Nv);
    best[k] = kBig;
    tile_of[k] = -1;
    hit[k] = 0u;
  }

  for (int tile0 = 0; tile0 < Ns; tile0 += ns_tile) {
    const int tile_end = min(Ns, tile0 + ns_tile);
    for (int c0 = tile0; c0 < tile_end; c0 += kStage) {
      const int n = min(kStage, tile_end - c0);
      // Padded to whole chunks by points at infinity: never nearest, never tied.
      const int n_pad = (n + kChunk - 1) / kChunk * kChunk;
      __syncthreads();  // the previous stage has been scanned
      for (int j = tid; j < n_pad; j += kThreads) {
        s_a[j] = j < n ? stage_position<kTier>(r, seg, c0 + j)
                       : make_float4(0.f, 0.f, 0.f, INFINITY);
      }
      __syncthreads();
      for (int cc = 0; cc < n_pad; cc += kChunk) {
        // The chunk's minimum; unweighted, the running minimum itself.
        float cm[kSlots];
#pragma unroll
        for (int k = 0; k < kSlots; ++k) cm[k] = kWeighted ? INFINITY : best[k];
#pragma unroll 8
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 a = s_a[cc + jj];
#pragma unroll
          for (int k = 0; k < kSlots; ++k) cm[k] = fminf(cm[k], pair_d2(m[k], a));
        }
        const unsigned bit = 1u << (((c0 + cc - tile0) / kChunk) & 31);
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          if constexpr (kWeighted) {
            join_chunk(cm[k], best[k], tile_of[k], hit[k], tile0, bit);
          } else {
            best[k] = cm[k];
          }
        }
      }
    }
  }

  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    acc += contribution<kTier, kWeighted>(m[k], best[k], tile_of[k], hit[k],
                                          (mt * kSlots + k) * kThreads + tid, r, model_nrm, seg,
                                          Nv, Ns, ns_tile, delta2, cos_gate);
  }
  // Fixed-order block sum: warp shuffle tree, then warp partials in order.
  acc = warp_sum(acc);
  if ((tid & 31) == 0) s_warp[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += s_warp[w];
    partial[h * n_mtiles + mt] = total;
  }
}

// kHypGroup hypotheses a block, one warp each, on one tile of 32 * kWidePts
// model points: a lane holds kWidePts of them under its warp's hypothesis.
// The warps share nothing but the block: each stages its own hypothesis's
// segment chunks and meets only its own lanes (__syncwarp), so a warp of a
// ragged last group has no work and leaves.
template <int kTier, bool kWeighted>
__global__ void __launch_bounds__(kThreads) lcp_stream_wide_kernel(LCP_STREAM_ARGS) {
  __shared__ float4 s_a[kHypGroup][kWideStage];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = (static_cast<int>(blockIdx.x) / n_mtiles) * kHypGroup + warp;
  const int mt = static_cast<int>(blockIdx.x) % n_mtiles;
  if (h >= H) return;
  float4* s = s_a[warp];

  float r[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) r[c] = tr[12 * h + c];

  ModelPoint m[kWidePts];
  float best[kWidePts];
  int tile_of[kWidePts];   // weighted: first point of the tile that set best[p]
  unsigned hit[kWidePts];  // weighted: the chunks of that tile that reached best[p]
#pragma unroll
  for (int p = 0; p < kWidePts; ++p) {
    m[p] = load_model<kTier, false>(model_pts, model_nrm, (mt * kWidePts + p) * 32 + lane, Nv);
    best[p] = kBig;
    tile_of[p] = -1;
    hit[p] = 0u;
  }

  // The segment as a run of chunks of kChunk points that never straddle a
  // tile edge: tile q holds the next ceil(ns_tile / kChunk) chunks, the last
  // of them padded by points at infinity (never nearest, never tied).
  const int per_tile = (ns_tile + kChunk - 1) / kChunk;
  const int n_chunks = (Ns + ns_tile - 1) / ns_tile * per_tile;
  for (int q0 = 0; q0 < n_chunks; q0 += kWideStage / kChunk) {
    const int nq = min(kWideStage / kChunk, n_chunks - q0);
    __syncwarp();  // the previous stage has been scanned
    for (int cc = 0; cc < nq; ++cc) {
      const int q = q0 + cc, tile = q / per_tile;
      const int j = tile * ns_tile + (q - tile * per_tile) * kChunk + lane;
      const bool in = j < min(Ns, (tile + 1) * ns_tile);
      s[cc * kChunk + lane] = in ? stage_position<kTier>(r, seg, j)
                                 : make_float4(0.f, 0.f, 0.f, INFINITY);
    }
    __syncwarp();
    for (int cc = 0; cc < nq; ++cc) {
      const int q = q0 + cc, tile = q / per_tile;
      // The chunk's minimum; unweighted, the running minimum itself.
      float cm[kWidePts];
#pragma unroll
      for (int p = 0; p < kWidePts; ++p) cm[p] = kWeighted ? INFINITY : best[p];
#pragma unroll 8
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4 a = s[cc * kChunk + jj];
#pragma unroll
        for (int p = 0; p < kWidePts; ++p) cm[p] = fminf(cm[p], pair_d2(m[p], a));
      }
      const unsigned bit = 1u << ((q - tile * per_tile) & 31);
#pragma unroll
      for (int p = 0; p < kWidePts; ++p) {
        if constexpr (kWeighted) {
          join_chunk(cm[p], best[p], tile_of[p], hit[p], tile * ns_tile, bit);
        } else {
          best[p] = cm[p];
        }
      }
    }
  }

  float acc = 0.f;
#pragma unroll
  for (int p = 0; p < kWidePts; ++p) {
    acc += contribution<kTier, kWeighted>(m[p], best[p], tile_of[p], hit[p],
                                          (mt * kWidePts + p) * 32 + lane, r, model_nrm, seg, Nv,
                                          Ns, ns_tile, delta2, cos_gate);
  }
  acc = warp_sum(acc);
  if (lane == 0) partial[h * n_mtiles + mt] = acc;
}

// out[h] = (sum of the model tiles' partial sums, in tile order) / Nv.
__global__ void lcp_stream_finish_kernel(const float* __restrict__ partial,
                                         float* __restrict__ out, int H, int n_mtiles, int Nv) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float total = 0.f;
  for (int t = 0; t < n_mtiles; ++t) total += partial[h * n_mtiles + t];
  out[h] = total / static_cast<float>(Nv);
}

template <int kTier, bool kWeighted>
int launch(bool wide, const float* tr, const float* model_pts, const float* model_nrm,
           const float* seg, float* partial, float* out, int H, int Nv, int Ns, int ns_tile,
           float delta2, float cos_gate, cudaStream_t st) {
  const float4* seg4 = reinterpret_cast<const float4*>(seg);
  const int model_tile = wide ? 32 * kWidePts : kThreads * kSlots;
  const int n_mtiles = (Nv + model_tile - 1) / model_tile;
  if (wide) {
    const int groups = (H + kHypGroup - 1) / kHypGroup;
    lcp_stream_wide_kernel<kTier, kWeighted><<<groups * n_mtiles, kThreads, 0, st>>>(
        tr, model_pts, model_nrm, seg4, partial, H, Nv, Ns, ns_tile, n_mtiles, delta2, cos_gate);
  } else {
    lcp_stream_kernel<kTier, kWeighted><<<H * n_mtiles, kThreads, 0, st>>>(
        tr, model_pts, model_nrm, seg4, partial, H, Nv, Ns, ns_tile, n_mtiles, delta2, cos_gate);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  lcp_stream_finish_kernel<<<(H + 255) / 256, 256, 0, st>>>(partial, out, H, n_mtiles, Nv);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(bool wide, const float* tr, const float* model_pts, const float* model_nrm,
             const float* seg, float* partial, float* out, int H, int Nv, int Ns, int ns_tile,
             float delta2, float cos_gate, int weighted, int tier, void* stream) {
  if (H <= 0) return 0;
  if (Nv <= 0 || Ns <= 0 || ns_tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LCP_LAUNCH(T, W)                                                                     \
  return launch<T, W>(wide, tr, model_pts, model_nrm, seg, partial, out, H, Nv, Ns, ns_tile, \
                      delta2, cos_gate, st)
  if (tier == kFp32) {
    if (weighted) LCP_LAUNCH(kFp32, true);
    LCP_LAUNCH(kFp32, false);
  }
  if (tier == kBf16) {
    if (weighted) LCP_LAUNCH(kBf16, true);
    LCP_LAUNCH(kBf16, false);
  }
#undef LCP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Both launch on `stream` and allocate nothing: `partial` is the caller's
// workspace of H * ceil(Nv / model tile) floats (model tile 1,024 for
// lcp_stream_launch, 256 for lcp_stream_wide_launch). tier is 0 (fp32) or 1
// ("default"). They return cudaGetLastError().
extern "C" int lcp_stream_launch(const float* tr, const float* model_pts,
                                 const float* model_nrm, const float* seg, float* partial,
                                 float* out, int H, int Nv, int Ns, int ns_tile, float delta2,
                                 float cos_gate, int weighted, int tier, void* stream) {
  return dispatch(false, tr, model_pts, model_nrm, seg, partial, out, H, Nv, Ns, ns_tile,
                  delta2, cos_gate, weighted, tier, stream);
}

extern "C" int lcp_stream_wide_launch(const float* tr, const float* model_pts,
                                      const float* model_nrm, const float* seg, float* partial,
                                      float* out, int H, int Nv, int Ns, int ns_tile,
                                      float delta2, float cos_gate, int weighted, int tier,
                                      void* stream) {
  return dispatch(true, tr, model_pts, model_nrm, seg, partial, out, H, Nv, Ns, ns_tile,
                  delta2, cos_gate, weighted, tier, stream);
}
