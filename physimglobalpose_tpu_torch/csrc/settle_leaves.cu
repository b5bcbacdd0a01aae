// The search's in-order leaf settle in one launch: every row of a leaf batch,
// every placement position and every substep inside the kernel.
//
// Replaces no TPU kernel. The JAX package settles a leaf batch with its
// jitted, vmapped settle_single_dynamic (physimglobalpose_tpu/ops/physics.py),
// which XLA fuses; the port ran the same function as plain PyTorch, about 170
// small launches a substep, 60 substeps a placement position and 3 positions
// a leaf batch, so the search was bound by the host's launches and not by the
// card. This kernel computes ops/physics.py::settle_in_order_plain, the loop
// of settle_single_dynamic over the placement positions. Per row b and
// position d with dynamic body j = dyn[b, d] (a position with j = -1 is a
// no-op):
//   colliders: every body placed at d other than j, at its current pose (the
//   poses the earlier positions settled; statics' planes from quat_to_matrix
//   of their quaternion, which is not renormalised), and the table box;
//   j's state (q, p, v, w) starts from its pose at rest; per substep, h = dt /
//   substeps:
//     v += (0, 0, g h);  p += v h;  q <- normalise(q + (0, w h) * q / 2);
//     world vertex x = R(q) m + p of every valid hull vertex m of j;
//     per collider: sd = n . x + e over its faces, inside = -max sd, pen =
//     max(inside, 0); depth = max over vertices of pen, the deepest vertex's
//     nearest face (first index on ties) gives the normal, the centroid is
//     sum pen x / max(sum pen, 1e-12); active where depth > 0;
//     one Jacobi solve of the active contacts (ops/physics.py::
//     _solve_contacts: positional impulses summed, velocity fixes averaged,
//     the angular fix halved); q <- normalise(q + drot * q / 2), p += dpos,
//     v <- (v + dv) damping, w <- (w + dw) damping.
// The kernel skips what cannot change a result: a face that is the hulls'
// padding row (0, 0, 1, -1e9) never wins the max over a hull with a real face
// (a hull of padding rows alone keeps one of them: the max over equal planes is
// that plane); a masked vertex or a collider that is not placed adds 0 to
// every sum and decides an argmax only where the contact is inactive, and
// then its normal and centroid are never read. Ties keep the plain version's
// first index everywhere else.
//
// Constants may be shared by every row or carry the row (the multi-scene leaf
// batch gathers each row's scene): each is read through its row stride, 0 when
// shared. Nothing depends on the padding of P, F or K, nor on the batch, so a
// row settles to the same bits in a batch of one scene and in a multi-scene
// batch padded to larger shapes.
//
// Precision: IEEE float32 on the CUDA cores, built without fast math (correctly
// rounded division and square root; fused multiply-adds, which round once).
// No TF32, no bf16. The sums run in other orders than PyTorch's, so results
// agree with the plain version to rounding, which a contact settle amplifies
// where a body rocks or a vertex sits near a collider's edge.
//
// What bounds it: not bytes (a few KB a row) nor FLOP (a few thousand a
// substep), but the latency of 60 dependent substeps a position, 180 a leaf of
// three objects, each a contact pass, two barriers and a serial solve. So the
// design keeps one row in one block and everything in shared memory and
// registers:
//  - one block of kThreads a row (grid B); the row's K poses, the dynamic
//    body's valid vertices and the colliders' world planes (valid faces only,
//    rebuilt once a position) live in shared memory;
//  - the contact pass: a thread a (collider, vertex) pair runs over the
//    collider's faces for the max and its first index; then a warp a collider
//    reduces over the vertices with shuffles (depth with its first index, the
//    weights and the weighted centroid);
//  - the solve and the integration run in every thread at once on the same
//    values, so each thread holds the body's state in registers and no third
//    barrier broadcasts it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBodies = 16;
constexpr int kMaxColliders = kMaxBodies + 1;  // the bodies and the table
constexpr int kMaxVerts = 256;
constexpr int kMaxFaces = 256;

struct Contact {
  float depth, nx, ny, nz, cx, cy, cz;
};

__device__ __forceinline__ bool is_padding(const float* e) {
  return e[0] == 0.f && e[1] == 0.f && e[2] == 1.f && e[3] == -1e9f;
}

// ops/physics.py's se3.quat_to_matrix: the quaternion normalised first.
__device__ __forceinline__ void quat_to_matrix(const float* qin, float* r) {
  const float n = sqrtf(qin[0] * qin[0] + qin[1] * qin[1] + qin[2] * qin[2] + qin[3] * qin[3]);
  const float w = qin[0] / n, x = qin[1] / n, y = qin[2] / n, z = qin[3] / n;
  r[0] = 1.f - 2.f * (y * y + z * z);
  r[1] = 2.f * (x * y - w * z);
  r[2] = 2.f * (x * z + w * y);
  r[3] = 2.f * (x * y + w * z);
  r[4] = 1.f - 2.f * (x * x + z * z);
  r[5] = 2.f * (y * z - w * x);
  r[6] = 2.f * (x * z - w * y);
  r[7] = 2.f * (y * z + w * x);
  r[8] = 1.f - 2.f * (x * x + y * y);
}

// ops/physics.py::_integrate_quat with dt = 1: q + (0, o) * q / 2, normalised
// (the norm clamped at 1e-12).
__device__ __forceinline__ void integrate(float* q, float ox, float oy, float oz) {
  const float mw = -ox * q[1] - oy * q[2] - oz * q[3];
  const float mx = ox * q[0] + oy * q[3] - oz * q[2];
  const float my = -ox * q[3] + oy * q[0] + oz * q[1];
  const float mz = ox * q[2] - oy * q[1] + oz * q[0];
  const float a = q[0] + 0.5f * mw, b = q[1] + 0.5f * mx, c = q[2] + 0.5f * my,
              d = q[3] + 0.5f * mz;
  const float n = fmaxf(sqrtf(a * a + b * b + c * c + d * d), 1e-12f);
  q[0] = a / n;
  q[1] = b / n;
  q[2] = c / n;
  q[3] = d / n;
}

__device__ __forceinline__ void cross(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void matvec(const float* m, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = m[3 * i] * v[0] + m[3 * i + 1] * v[1] + m[3 * i + 2] * v[2];
}

// A plane (n, e) in the world frame under the pose (R, t): (R n, e - R n . t).
__device__ __forceinline__ float4 plane_to_world(const float* r, const float* t, float nx,
                                                 float ny, float nz, float e) {
  const float wx = nx * r[0] + ny * r[1] + nz * r[2];
  const float wy = nx * r[3] + ny * r[4] + nz * r[5];
  const float wz = nx * r[6] + ny * r[7] + nz * r[8];
  return make_float4(wx, wy, wz, e - (wx * t[0] + wy * t[1] + wz * t[2]));
}

struct Args {
  const float* quat;                // [B, K, 4]
  const float* pos;                 // [B, K, 3]
  const long long* dyn;             // [B, D]
  const unsigned char* placed;      // [B, D, K]
  const float* hull_pts;            // [(B,) K, P, 3]
  const unsigned char* hull_mask;   // [(B,) K, P]
  const float* hull_eqs;            // [(B,) K, F, 4]
  const float* inv_inertia;         // [(B,) K, 3]
  const float* table_pose;          // [(B,) 4, 4]
  const float* table_half;          // [3]
  long long pts_stride, mask_stride, eqs_stride, inertia_stride, table_stride;  // 0: shared
  float* quat_out;
  float* pos_out;
  int D, K, P, F, substeps_total;
  float h, gh, damping, tan_coeff, normal_fix, inv_mass;
};

__global__ void __launch_bounds__(kThreads) settle_leaves_kernel(const Args a) {
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K, P = a.P, F = a.F, fcap = F > 6 ? F : 6;

  __shared__ float s_q[kMaxBodies * 4], s_p[kMaxBodies * 3];
  __shared__ int s_coll[kMaxColliders], s_nf[kMaxColliders], s_n[2];
  __shared__ Contact s_contact[kMaxColliders];
  extern __shared__ float4 smem[];
  float4* s_planes = smem;                                            // [K+1][fcap]
  float* s_vert = reinterpret_cast<float*>(s_planes + (K + 1) * fcap);  // [P][3]
  float* s_world = s_vert + 3 * P;                                    // [P][3]
  float* s_pen = s_world + 3 * P;                                     // [K+1][P]
  int* s_face = reinterpret_cast<int*>(s_pen + (K + 1) * P);          // [K+1][P]

  for (int i = tid; i < 4 * K; i += kThreads) s_q[i] = a.quat[(long long)b * 4 * K + i];
  for (int i = tid; i < 3 * K; i += kThreads) s_p[i] = a.pos[(long long)b * 3 * K + i];
  const float* pts = a.hull_pts + b * a.pts_stride;
  const unsigned char* mask = a.hull_mask + b * a.mask_stride;
  const float* eqs = a.hull_eqs + b * a.eqs_stride;
  const float* inertia = a.inv_inertia + b * a.inertia_stride;
  const float* tpose = a.table_pose + b * a.table_stride;
  __syncthreads();

  for (int d = 0; d < a.D; ++d) {
    const long long jl = a.dyn[(long long)b * a.D + d];
    // settle_single_dynamic's no-op rows: no dynamic body, or one that cannot
    // move (inv_mass 0; dyn past K reads a body of inv_mass 0 there).
    if (jl < 0 || jl >= K || !(a.inv_mass > 0.f)) continue;
    const int j = static_cast<int>(jl);
    const unsigned char* placed = a.placed + ((long long)b * a.D + d) * K;
    const bool live = placed[j] != 0;  // an unplaced dynamic body falls with no contact

    if (tid == 0) {
      int nc = 0;
      if (live) {
        for (int c = 0; c < K; ++c)
          if (c != j && placed[c]) s_coll[nc++] = c;
        s_coll[nc++] = K;  // the table
      }
      s_n[1] = nc;
    }
    __syncthreads();
    int nc = s_n[1];

    if (warp == 0) {  // the dynamic body's valid vertices, in index order
      int n = 0;
      for (int base = 0; base < P; base += 32) {
        const int v = base + lane;
        const bool ok = live && v < P && mask[j * P + v];
        const unsigned bal = __ballot_sync(0xffffffffu, ok);
        if (ok) {
          const int slot = n + __popc(bal & ((1u << lane) - 1u));
          const float* m = pts + 3 * (j * P + v);
          s_vert[3 * slot] = m[0];
          s_vert[3 * slot + 1] = m[1];
          s_vert[3 * slot + 2] = m[2];
        }
        n += __popc(bal);
      }
      if (lane == 0) s_n[0] = n;
    }
    for (int s = warp; s < nc; s += kWarps) {  // each collider's world planes
      const int c = s_coll[s];
      float4* out = s_planes + s * fcap;
      if (c == K) {  // the table box: +x, -x, +y, -y, +z, -z
        if (lane < 6) {
          const float r[9] = {tpose[0], tpose[1], tpose[2], tpose[4], tpose[5],
                              tpose[6], tpose[8], tpose[9], tpose[10]};
          const float t[3] = {tpose[3], tpose[7], tpose[11]};
          const int ax = lane >> 1;
          const float sg = (lane & 1) ? -1.f : 1.f;
          out[lane] = plane_to_world(r, t, ax == 0 ? sg : 0.f, ax == 1 ? sg : 0.f,
                                     ax == 2 ? sg : 0.f, -a.table_half[ax]);
        }
        if (lane == 0) s_nf[s] = 6;
        continue;
      }
      float r[9];
      quat_to_matrix(s_q + 4 * c, r);
      const float* t = s_p + 3 * c;
      int n = 0;
      for (int base = 0; base < F; base += 32) {
        const int f = base + lane;
        const float* e = eqs + 4 * (c * F + f);
        const bool ok = f < F && !is_padding(e);
        const unsigned bal = __ballot_sync(0xffffffffu, ok);
        if (ok) out[n + __popc(bal & ((1u << lane) - 1u))] = plane_to_world(r, t, e[0], e[1], e[2], e[3]);
        n += __popc(bal);
      }
      if (n == 0 && lane == 0) {  // padding alone: its first row stands for all
        const float* e = eqs + 4 * (c * F);
        out[0] = plane_to_world(r, t, e[0], e[1], e[2], e[3]);
      }
      if (lane == 0) s_nf[s] = n > 0 ? n : 1;
    }
    __syncthreads();
    const int nv = s_n[0];
    if (nv == 0) nc = 0;
    const int pairs = nv * nc;

    // The dynamic body's state, the same in every thread.
    float q[4] = {s_q[4 * j], s_q[4 * j + 1], s_q[4 * j + 2], s_q[4 * j + 3]};
    float p[3] = {s_p[3 * j], s_p[3 * j + 1], s_p[3 * j + 2]};
    float lv[3] = {0.f, 0.f, 0.f}, av[3] = {0.f, 0.f, 0.f};
    const float ii[3] = {inertia[3 * j], inertia[3 * j + 1], inertia[3 * j + 2]};

    for (int step = 0; step < a.substeps_total; ++step) {
      lv[2] += a.gh;
#pragma unroll
      for (int i = 0; i < 3; ++i) p[i] += lv[i] * a.h;
      integrate(q, av[0] * a.h, av[1] * a.h, av[2] * a.h);
      float r[9];
      quat_to_matrix(q, r);

      for (int i = tid; i < pairs; i += kThreads) {
        const int s = i / nv, v = i - s * nv;
        const float* m = s_vert + 3 * v;
        const float x = m[0] * r[0] + m[1] * r[1] + m[2] * r[2] + p[0];
        const float y = m[0] * r[3] + m[1] * r[4] + m[2] * r[5] + p[1];
        const float z = m[0] * r[6] + m[1] * r[7] + m[2] * r[8] + p[2];
        if (s == 0) {
          s_world[3 * v] = x;
          s_world[3 * v + 1] = y;
          s_world[3 * v + 2] = z;
        }
        const float4* pl = s_planes + s * fcap;
        const int nf = s_nf[s];
        float best = pl[0].x * x + pl[0].y * y + pl[0].z * z + pl[0].w;
        int bf = 0;
        for (int f = 1; f < nf; ++f) {
          const float sd = pl[f].x * x + pl[f].y * y + pl[f].z * z + pl[f].w;
          if (sd > best) {
            best = sd;
            bf = f;
          }
        }
        const float inside = -best;
        s_pen[s * P + v] = inside > 0.f ? inside : 0.f;
        s_face[s * P + v] = bf;
      }
      __syncthreads();

      for (int s = warp; s < nc; s += kWarps) {
        float best = -1.f, ws = 0.f, cx = 0.f, cy = 0.f, cz = 0.f;
        int bi = 0x7fffffff;
        for (int v = lane; v < nv; v += 32) {
          const float pe = s_pen[s * P + v];
          if (pe > best) {
            best = pe;
            bi = v;
          }
          ws += pe;
          cx += pe * s_world[3 * v];
          cy += pe * s_world[3 * v + 1];
          cz += pe * s_world[3 * v + 2];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (ob > best || (ob == best && oi < bi)) {
            best = ob;
            bi = oi;
          }
          ws += __shfl_xor_sync(0xffffffffu, ws, off);
          cx += __shfl_xor_sync(0xffffffffu, cx, off);
          cy += __shfl_xor_sync(0xffffffffu, cy, off);
          cz += __shfl_xor_sync(0xffffffffu, cz, off);
        }
        if (lane == 0) {
          const float4 n = s_planes[s * fcap + s_face[s * P + bi]];
          const float wsum = fmaxf(ws, 1e-12f);
          s_contact[s] = Contact{best, n.x, n.y, n.z, cx / wsum, cy / wsum, cz / wsum};
        }
      }
      __syncthreads();

      // _solve_contacts over the active contacts, in collider order.
      float iw[9];  // R diag(inv_inertia) R^T
#pragma unroll
      for (int r0 = 0; r0 < 3; ++r0)
#pragma unroll
        for (int c0 = 0; c0 < 3; ++c0)
          iw[3 * r0 + c0] = r[3 * r0] * ii[0] * r[3 * c0] + r[3 * r0 + 1] * ii[1] * r[3 * c0 + 1] +
                            r[3 * r0 + 2] * ii[2] * r[3 * c0 + 2];
      float sp[3] = {0.f, 0.f, 0.f}, st[3] = {0.f, 0.f, 0.f};
      float sdv[3] = {0.f, 0.f, 0.f}, srdv[3] = {0.f, 0.f, 0.f};
      int n_act = 0;
      for (int s = 0; s < nc; ++s) {
        const Contact ct = s_contact[s];
        if (!(ct.depth > 0.f)) continue;
        const float n[3] = {ct.nx, ct.ny, ct.nz};
        const float rr[3] = {ct.cx - p[0], ct.cy - p[1], ct.cz - p[2]};
        float rxn[3], irxn[3];
        cross(rr, n, rxn);
        matvec(iw, rxn, irxn);
        const float w = a.inv_mass + (rxn[0] * irxn[0] + rxn[1] * irxn[1] + rxn[2] * irxn[2]);
        const float lam = w > 0.f ? ct.depth / fmaxf(w, 1e-9f) : 0.f;
        const float imp[3] = {lam * n[0], lam * n[1], lam * n[2]};
        float rxi[3];
        cross(rr, imp, rxi);
        float wxr[3];
        cross(av, rr, wxr);
        const float vpt[3] = {lv[0] + wxr[0], lv[1] + wxr[1], lv[2] + wxr[2]};
        const float vn = vpt[0] * n[0] + vpt[1] * n[1] + vpt[2] * n[2];
        const float fix = vn < 0.f ? a.normal_fix * vn : 0.f;
        float dv[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) dv[i] = fix * n[i] + (-a.tan_coeff) * (vpt[i] - vn * n[i]);
        float rxdv[3];
        cross(rr, dv, rxdv);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          sp[i] += imp[i];
          st[i] += rxi[i];
          sdv[i] += dv[i];
          srdv[i] += rxdv[i];
        }
        ++n_act;
      }
      const float na = static_cast<float>(n_act > 0 ? n_act : 1);
      float drot[3], dang[3];
      matvec(iw, st, drot);
      matvec(iw, srdv, dang);
      integrate(q, drot[0], drot[1], drot[2]);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        p[i] += sp[i] * a.inv_mass;
        lv[i] = (lv[i] + sdv[i] / na) * a.damping;
        av[i] = (av[i] + dang[i] * 0.5f / na) * a.damping;
      }
    }

    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s_q[4 * j + i] = q[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) s_p[3 * j + i] = p[i];
    }
    __syncthreads();
  }

  for (int i = tid; i < 4 * K; i += kThreads) a.quat_out[(long long)b * 4 * K + i] = s_q[i];
  for (int i = tid; i < 3 * K; i += kThreads) a.pos_out[(long long)b * 3 * K + i] = s_p[i];
}

}  // namespace

// Launches on `stream`; allocates nothing. quat, quat_out [B, K, 4]; pos,
// pos_out [B, K, 3]; dyn [B, D] int64; placed [B, D, K] bytes; hull_pts [(B,)
// K, P, 3], hull_mask [(B,) K, P] bytes, hull_eqs [(B,) K, F, 4], inv_inertia
// [(B,) K, 3], table_pose [(B,) 4, 4], each read at its row stride in elements
// (0: one for every row); table_half [3]. K at most 16, P and F at most 256.
// h: the substep, gh: gravity times h, normal_fix: -(1 + restitution),
// tan_coeff: the share of tangential velocity a solve removes. Returns
// cudaGetLastError().
extern "C" int settle_leaves_launch(
    const float* quat, const float* pos, const long long* dyn, const unsigned char* placed,
    const float* hull_pts, const unsigned char* hull_mask, const float* hull_eqs,
    const float* inv_inertia, const float* table_pose, const float* table_half,
    long long pts_stride, long long mask_stride, long long eqs_stride, long long inertia_stride,
    long long table_stride, float* quat_out, float* pos_out, int B, int D, int K, int P, int F,
    int substeps_total, float h, float gh, float damping, float tan_coeff, float normal_fix,
    float inv_mass, void* stream) {
  if (B <= 0) return 0;
  if (D < 0 || K < 1 || K > kMaxBodies || P < 1 || P > kMaxVerts || F < 1 || F > kMaxFaces ||
      substeps_total < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int fcap = F > 6 ? F : 6;
  const int smem = (K + 1) * fcap * static_cast<int>(sizeof(float4)) +
                   6 * P * static_cast<int>(sizeof(float)) +
                   (K + 1) * P * static_cast<int>(sizeof(float) + sizeof(int));
  cudaFuncSetAttribute(settle_leaves_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const Args a{quat, pos, dyn, placed, hull_pts, hull_mask, hull_eqs, inv_inertia, table_pose,
               table_half, pts_stride, mask_stride, eqs_stride, inertia_stride, table_stride,
               quat_out, pos_out, D, K, P, F, substeps_total, h, gh, damping, tan_coeff,
               normal_fix, inv_mass};
  settle_leaves_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
