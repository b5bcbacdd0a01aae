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
// After the whole model the rule reads: d2* is the global minimum of d2, its
// tile is the FIRST tile whose minimum equals it, and the match is the mean of
// (p, n) over that tile's ties, summed in index order and then divided by
// their count. float32 only, as the TPU kernel.
//
// p, n, |p|^2 and |s|^2 are computed with separately rounded products and sums
// in a fixed order and d2 is an explicit fmaf chain, which the plain PyTorch
// version (ops/icp.py::icp_stream_pass_plain) reproduces through float64, so
// both find bit-identical distances, ties and weights; only the order of the
// sums over segment points differs.
//
// What bounds it: the instruction rate of the CUDA cores, Ns * Nm pairs per
// hypothesis at 1 add + 3 FMA + 1 min (counted as 8 FLOP against 67 TFLOP/s);
// the inputs are tens of KB, the output 42 floats a hypothesis.
// What the design does about it:
//  - min first: the scan keeps only a running minimum per segment point, over
//    chunks of kChunk model points, so a pair costs the four operations of its
//    d2 and one fminf, with no branch. After a chunk a few selects per point
//    keep a match word: the tile that set the minimum and a mask of its chunks
//    that reached it (a nearer chunk resets both, an equal chunk joins only in
//    that tile). Chunks never straddle a tile edge: the model is laid out in
//    slots, ceil(nm_tile / kChunk) chunks a tile, the last padded by points at
//    infinity (never nearest, never tied), so any nm_tile works;
//  - a lane holds kSeg segment points in registers, so each broadcast read of
//    a staged model point feeds kSeg independent chains; a warp takes a group
//    of 32 * kSeg points, and the kWarps warps of a block share the staged
//    model. A block takes one tile of kTile segment points of one hypothesis
//    (grid H x ceil(Ns / kTile)), which fills the card at H = 32 as at H = 256;
//  - the walk after the scan: only a point that is unmasked and within
//    max_corr walks, through the chunks of its mask in index order, with the
//    scan's instructions on the same staged values, hence the same bits; it
//    sums (p, n) over the ties and divides by their count. (The design it
//    replaced kept the whole match in the scan: a branch, a shared-memory read
//    of the normal and seven floats a point on every pair.) The transformed
//    model (p, |p|^2 and n, 32 bytes a slot) stays in shared memory for the
//    walk while it has at most kSmemSlots slots; above that the scan streams it
//    through kStage slots at a time and the walk rebuilds the points it visits
//    from the model in device memory, with the staging's instructions;
//  - deterministic sums in a fixed order: per lane over its points, a
//    warp-shuffle tree per group into a workspace, then a second kernel that
//    adds the groups per hypothesis in index order. No atomics.
// Tensor cores are not used: the pass works uncentred at camera distance
// (about 0.5 m), where a bf16 or TF32 filter's band would be centimetres wide.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;                    // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;                // blocks an SM: 64 registers a thread
constexpr int kSeg = 4;                      // segment points a lane holds
constexpr int kGroup = 32 * kSeg;            // segment points a warp takes (one row of sums)
constexpr int kTile = kWarps * kGroup;       // segment points a block takes
constexpr int kChunk = 32;                   // model slots a chunk of the scan
constexpr int kMaskBits = 8;                 // match word: the tile tag above a chunk mask
constexpr unsigned kMask = (1u << kMaskBits) - 1u;
constexpr int kMaxModelTiles = (1 << (32 - kMaskBits)) - 2;
// Largest slot count kept staged: what leaves kMinBlocks blocks an SM room in
// its 228 KB of shared memory (1 KB of it the runtime's per block): 1,792 slots.
constexpr int kSmemSlots = (228 * 1024 / kMinBlocks - 1024) / (2 * 16);
constexpr int kStage = 1024;                 // slots staged at a time above that
constexpr int kFinishThreads = 256;          // the finishing kernel's block
constexpr int kFinishGroups = 64;            // rows of sums it stages at a time
constexpr int kSums = 27;                    // upper triangle of A (21), then b (6)
constexpr int kOut = 42;                     // A row-major (36), then b (6)
constexpr float kBig = 1e9f;

static_assert(kStage % kChunk == 0, "a stage is a whole number of chunks");

__device__ __forceinline__ float dot3_rn(float a, float x, float b, float y, float c, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

// Model slot -> model point: tile t holds slots [t * per_tile * kChunk, ...);
// slot `local` of the tile is model point t * nm_tile + local if it exists.
__device__ __forceinline__ int slot_point(int slot, int per_tile, int nm_tile, int Nm) {
  const int tile_slots = per_tile * kChunk;
  const int t = slot / tile_slots, local = slot - t * tile_slots;
  const int i = t * nm_tile + local;
  return (local < nm_tile && i < Nm) ? i : -1;
}

// p = R m_i + t and |p|^2 (a padding slot, i < 0: a point at infinity).
__device__ __forceinline__ float4 model_point(const float* r, const float* __restrict__ pts,
                                              int i) {
  if (i < 0) return make_float4(0.f, 0.f, 0.f, INFINITY);
  const float* m = pts + 3 * i;
  const float px = __fadd_rn(dot3_rn(r[0], m[0], r[1], m[1], r[2], m[2]), r[3]);
  const float py = __fadd_rn(dot3_rn(r[4], m[0], r[5], m[1], r[6], m[2]), r[7]);
  const float pz = __fadd_rn(dot3_rn(r[8], m[0], r[9], m[1], r[10], m[2]), r[11]);
  return make_float4(px, py, pz, dot3_rn(px, px, py, py, pz, pz));
}

// n = R nrm_i (0 for a padding slot).
__device__ __forceinline__ float4 model_normal(const float* r, const float* __restrict__ nrm,
                                               int i) {
  if (i < 0) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* mn = nrm + 3 * i;
  return make_float4(dot3_rn(r[0], mn[0], r[1], mn[1], r[2], mn[2]),
                     dot3_rn(r[4], mn[0], r[5], mn[1], r[6], mn[2]),
                     dot3_rn(r[8], mn[0], r[9], mn[1], r[10], mn[2]), 0.f);
}

// A segment point as the d2 chain takes it: (-2s, |s|^2).
__device__ __forceinline__ void segment_point(const float4& s, float& ax, float& ay, float& az,
                                              float& sq) {
  ax = -2.f * s.x; ay = -2.f * s.y; az = -2.f * s.z;
  sq = dot3_rn(s.x, s.x, s.y, s.y, s.z, s.z);
}

// d2 of a segment point, held as (-2s, |s|^2), against a staged point (p, |p|^2).
__device__ __forceinline__ float pair_d2(float ax, float ay, float az, float sq, const float4& p) {
  return fmaf(ax, p.x, fmaf(ay, p.y, fmaf(az, p.z, __fadd_rn(sq, p.w))));
}

// The match word after a chunk whose minimum is cm: `tag` names the chunk's
// tile (its index + 1, above the mask bits), `bit` the chunk within it (mod
// kMaskBits). "<" replaces in any tile; "==" joins only in the tile that set
// the minimum (a word's tag is never above the current one).
__device__ __forceinline__ void join_chunk(float cm, float& best, unsigned& key, unsigned tag,
                                           unsigned bit) {
  const bool nearer = cm < best;
  const bool joins = cm == best && key >= tag;
  key = nearer ? (tag | bit) : (joins ? (key | bit) : key);
  best = fminf(best, cm);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Adds segment point s's terms, matched (p, n) with weight w.
__device__ __forceinline__ void accumulate(float (&acc)[kSums], const float (&v)[6], float w,
                                           float sx, float sy, float sz) {
  const float px = v[0], py = v[1], pz = v[2];
  const float nx = v[3], ny = v[4], nz = v[5];
  const float res = (px - sx) * nx + (py - sy) * ny + (pz - sz) * nz;
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

// Block (h, tile): hypothesis h, segment points [tile * kTile, ...); each of
// its warps writes the 27 sums of its group to partial[h, group].
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kMinBlocks) icp_corr_stream_kernel(
    const float* __restrict__ tr,         // [H, 12] row-major (R | t), scene frame
    const float4* __restrict__ seg,       // [Ns]: x, y, z, mask
    const float* __restrict__ model_pts,  // [Nm, 3]
    const float* __restrict__ model_nrm,  // [Nm, 3]
    float* __restrict__ partial,          // [H, n_groups, 27]
    int Ns, int Nm, int nm_tile, int per_tile, int n_slots, int n_groups, float max_corr2,
    float two_sigma2) {
  extern __shared__ float4 smem[];
  float4* s_p = smem;                            // slots: (p, |p|^2)
  float4* s_n = smem + (kStaged ? n_slots : 0);  // staged: (n, 0)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = static_cast<int>(blockIdx.x);
  float r[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) r[c] = tr[12 * h + c];

  if constexpr (kStaged) {
    for (int s = tid; s < n_slots; s += kThreads) {
      const int i = slot_point(s, per_tile, nm_tile, Nm);
      s_p[s] = model_point(r, model_pts, i);
      s_n[s] = model_normal(r, model_nrm, i);
    }
    __syncthreads();
  }
  const int window = kStaged ? n_slots : kStage;
  const int g = static_cast<int>(blockIdx.y) * kWarps + warp;  // this warp's group
  const int j0 = g * kGroup + lane;     // its lane's first point; then every 32nd
  const bool active = g * kGroup < Ns;  // warp-uniform

  // ---- The scan: the running minimum and the match word of kSeg points.
  float best[kSeg];
  unsigned key[kSeg];
  {
    float ax[kSeg], ay[kSeg], az[kSeg], sq[kSeg];
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      const int j = j0 + 32 * k;
      segment_point(j < Ns ? seg[j] : make_float4(0.f, 0.f, 0.f, 0.f), ax[k], ay[k], az[k],
                    sq[k]);
      best[k] = kBig;
      key[k] = 0u;  // no tile yet
    }
    unsigned tag = 1u << kMaskBits;  // the next chunk's tile, as the match word holds it
    int chunk = 0;                   // and its chunk within that tile
    for (int w0 = 0; w0 < n_slots; w0 += window) {
      const int w_end = min(n_slots, w0 + window);
      if constexpr (!kStaged) {
        __syncthreads();  // the previous window has been scanned
        for (int s = w0 + tid; s < w_end; s += kThreads) {
          s_p[s - w0] = model_point(r, model_pts, slot_point(s, per_tile, nm_tile, Nm));
        }
        __syncthreads();
      }
      if (!active) continue;
      for (int q = w0; q < w_end; q += kChunk) {
        float cm[kSeg];
#pragma unroll
        for (int k = 0; k < kSeg; ++k) cm[k] = INFINITY;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 p = s_p[q - w0 + jj];
#pragma unroll
          for (int k = 0; k < kSeg; ++k) {
            cm[k] = fminf(cm[k], pair_d2(ax[k], ay[k], az[k], sq[k], p));
          }
        }
        const unsigned bit = 1u << (chunk & (kMaskBits - 1));
#pragma unroll
        for (int k = 0; k < kSeg; ++k) join_chunk(cm[k], best[k], key[k], tag, bit);
        if (++chunk == per_tile) {
          chunk = 0;
          tag += 1u << kMaskBits;
        }
      }
    }
  }

  // ---- The walk: a point unmasked and within max_corr sums (p, n) over the
  // ties in the chunks of its mask, in index order; then its terms.
  float acc[kSums];
#pragma unroll
  for (int c = 0; c < kSums; ++c) acc[c] = 0.f;
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    const int j = j0 + 32 * k;
    if (j >= Ns || key[k] == 0u || !(best[k] <= max_corr2)) continue;
    const float4 s = seg[j];
    if (!(s.w > 0.5f)) continue;
    float ax, ay, az, sq;
    segment_point(s, ax, ay, az, sq);
    const int t = static_cast<int>(key[k] >> kMaskBits) - 1;
    const unsigned hm = key[k] & kMask;
    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float cnt = 0.f;
    for (int c = __ffs(hm) - 1; c < per_tile; ++c) {
      if (!((hm >> (c & (kMaskBits - 1))) & 1u)) continue;
      const int q = (t * per_tile + c) * kChunk;
      for (int jj = 0; jj < kChunk; ++jj) {
        float4 p, n;
        int i = -1;
        if constexpr (kStaged) {
          p = s_p[q + jj];
        } else {
          i = slot_point(q + jj, per_tile, nm_tile, Nm);
          if (i < 0) continue;
          p = model_point(r, model_pts, i);
        }
        if (pair_d2(ax, ay, az, sq, p) != best[k]) continue;
        if constexpr (kStaged) {
          n = s_n[q + jj];
        } else {
          n = model_normal(r, model_nrm, i);
        }
        v[0] += p.x; v[1] += p.y; v[2] += p.z;
        v[3] += n.x; v[4] += n.y; v[5] += n.z;
        cnt += 1.f;
      }
    }
    if (cnt > 1.f) {
#pragma unroll
      for (int c = 0; c < 6; ++c) v[c] = v[c] / cnt;
    }
    accumulate(acc, v, expf(-best[k] / two_sigma2), s.x, s.y, s.z);
  }

  // ---- The group's sums: a shuffle tree.
#pragma unroll
  for (int c = 0; c < kSums; ++c) {
    const float x = warp_sum(acc[c]);
    if (lane == 0 && active) partial[(static_cast<size_t>(h) * n_groups + g) * kSums + c] = x;
  }
}

// out[h] = the groups' sums added in group order, A unfolded to 6x6 row-major.
// The block reads kFinishGroups rows of sums at a time into shared memory, all
// its threads together, so the reads are not one dependent chain.
__global__ void __launch_bounds__(kFinishThreads) icp_corr_stream_finish_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int n_groups) {
  __shared__ float s_rows[kFinishGroups * kSums];
  __shared__ float s_sum[kSums];
  const int h = blockIdx.x, tid = threadIdx.x;
  const float* rows = partial + static_cast<size_t>(h) * n_groups * kSums;
  float total = 0.f;  // thread c < 27: sum c
  for (int g0 = 0; g0 < n_groups; g0 += kFinishGroups) {
    const int n = min(kFinishGroups, n_groups - g0);
    __syncthreads();  // the previous rows have been added
    for (int i = tid; i < n * kSums; i += kFinishThreads) s_rows[i] = rows[g0 * kSums + i];
    __syncthreads();
    if (tid < kSums) {
      for (int g = 0; g < n; ++g) total += s_rows[g * kSums + tid];
    }
  }
  if (tid < kSums) s_sum[tid] = total;
  __syncthreads();
  if (tid < 36) {
    const int a = min(tid / 6, tid % 6), b = max(tid / 6, tid % 6);
    // Index of (a, b), a <= b, in the row-major upper triangle.
    out[h * kOut + tid] = s_sum[a * 6 - a * (a - 1) / 2 + (b - a)];
  } else if (tid < kOut) {
    out[h * kOut + tid] = s_sum[21 + tid - 36];
  }
}

// Both variants' launch: kStaged as `staged` asks, if the slots fit.
int launch(const float* tr, const float* seg, const float* model_pts, const float* model_nrm,
           float* partial, float* out, int H, int Ns, int Nm, int nm_tile, float max_corr2,
           float two_sigma2, void* stream, bool staged) {
  if (H <= 0) return 0;
  if (Ns <= 0 || Nm <= 0 || nm_tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  nm_tile = min(nm_tile, Nm);
  const int per_tile = (nm_tile + kChunk - 1) / kChunk;
  const int n_mtiles = (Nm + nm_tile - 1) / nm_tile;
  if (n_mtiles > kMaxModelTiles) return static_cast<int>(cudaErrorInvalidValue);
  const int n_slots = n_mtiles * per_tile * kChunk;
  const int n_groups = (Ns + kGroup - 1) / kGroup;
  const dim3 grid(H, (Ns + kTile - 1) / kTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* seg4 = reinterpret_cast<const float4*>(seg);
  if (staged && n_slots <= kSmemSlots) {
    const int smem = n_slots * 2 * static_cast<int>(sizeof(float4));
    auto kern = icp_corr_stream_kernel<true>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kern<<<grid, kThreads, smem, st>>>(tr, seg4, model_pts, model_nrm, partial, Ns, Nm, nm_tile,
                                       per_tile, n_slots, n_groups, max_corr2, two_sigma2);
  } else {
    icp_corr_stream_kernel<false><<<grid, kThreads, kStage * sizeof(float4), st>>>(
        tr, seg4, model_pts, model_nrm, partial, Ns, Nm, nm_tile, per_tile, n_slots, n_groups,
        max_corr2, two_sigma2);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  icp_corr_stream_finish_kernel<<<H, kFinishThreads, 0, st>>>(partial, out, n_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and allocates nothing: `partial` is the caller's workspace
// of H * ceil(Ns / 128) * 27 floats. Returns cudaGetLastError().
extern "C" int icp_corr_stream_launch(const float* tr, const float* seg, const float* model_pts,
                                      const float* model_nrm, float* partial, float* out, int H,
                                      int Ns, int Nm, int nm_tile, float max_corr2,
                                      float two_sigma2, void* stream) {
  return launch(tr, seg, model_pts, model_nrm, partial, out, H, Ns, Nm, nm_tile, max_corr2,
                two_sigma2, stream, true);
}

// The same with the streamed variant at every size (tools/compare_lcp_kernels.py
// times it against the staged one).
extern "C" int icp_corr_stream_launch_streamed(const float* tr, const float* seg,
                                               const float* model_pts, const float* model_nrm,
                                               float* partial, float* out, int H, int Ns, int Nm,
                                               int nm_tile, float max_corr2, float two_sigma2,
                                               void* stream) {
  return launch(tr, seg, model_pts, model_nrm, partial, out, H, Ns, Nm, nm_tile, max_corr2,
                two_sigma2, stream, false);
}
