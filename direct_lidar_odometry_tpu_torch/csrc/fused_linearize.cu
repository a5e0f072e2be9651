// Fused GICP linearization (kernel K3): 1-NN correspondence search,
// PLANE Mahalanobis and the per-sub-tile H/b partials in one pass. sm_90a.
//
// Replaces the TPU kernel direct_lidar_odometry_tpu/ops/pallas_gicp.py:
// _fused_linearize_kernel, the linearization of the "pallas_fused" backend
// (reference nano_gicp_impl.hpp:173-270).
//
// What it computes, per 32-query sub-tile: for each query p (the
// transformed source point) with weight qw = mask & normals_valid, its
// nearest valid target within r (K2's search, csrc/nn1_pruned.cu: exact
// coordinate-difference distance, ties to the lower target index); the
// correspondence weight w = found & qw & the target's normals_valid; for
// w = 1 the PLANE Mahalanobis matrix M = (2I - (1-eps)(n n^T + m m^T))^-1
// by adjugate (n the target normal, m the rotated source normal) and the
// Gauss-Newton terms of J = [skew(p) | -I]: 21 H entries (S^T M S upper,
// S M, M upper), b (6), the error e^T M e and n_corr, summed over the
// sub-tile into one row of hb [Q / 32, 32] (slots 0-28), plus slot 29 the
// chunks visited and slot 30 the candidate chunks at r^2. Per query it
// writes the frozen payload [mu_b xyz, n_b xyz, w, best d2] and the
// correspondence index (-1 where w = 0). Queries with w = 0 contribute exact
// zeros and a zero payload: their adjugate is never formed, so garbage
// normals cannot poison the sums through a NaN determinant or 0 * inf.
//
// Warm start: seed[q] >= 0 names a target (the previous iteration's
// correspondence). If it is valid and its d2 (the search's rounded
// formula) is strictly inside r^2, it enters the merge as one more packed
// key (d2, seed), so ties still fall to the lower index, and it lowers the
// sub-tile's selection bound B: the largest per-query bound over the
// weighted queries, the seed's d2 where seeded, r^2 otherwise. A chunk is
// visited iff gap^2 <= B. That is exact: every target of a skipped chunk
// has d2 >= gap^2 > B >= its query's bound, so it cannot beat that query's
// seed. The result equals the cold result bit for bit.
//
// What bounds it on the H100: the search's FP32 issue, as in K2 (about 14
// instructions per visited pair); the epilogue is ~150 flops once per
// query. Design: K2's sub-tile search (256 threads own 32 queries, 8 warps
// split every candidate chunk, cp.async double buffering, subtile_search.cuh)
// and its packed-key merge; then warp 0, one query per lane, reads each
// winner's point, normal and valid flag from global memory once, does the
// per-query maths and writes the 29 slots to shared memory, and the 8
// warps reduce them over the 32 queries with __shfl_down_sync in a fixed
// order: no atomics, so a run repeats bit for bit; the wrapper sums the
// sub-tile rows. (Reduced by warp 0 alone from registers, the 29 live
// slots took 48 registers a thread against 40 this way, and the kernel ran
// 1-3 % slower on the H100.) The TPU kernel's centred distance expansion
// and one-hot matrix-unit payload select exist because the TPU gathers
// badly; they are not carried over, which also makes this kernel's
// correspondences identical to the "pallas" path's.
//
// Lanes (the TPU kernel's batched entry _fused_linearize_batched, grid
// (b_total, qc)): the grid is (Q / 32, B), blockIdx.y the lane, each lane
// an independent source/target pair at its stride in [B, ...] arrays (seeds
// and output indices are the lane's own). hb is [B, Q / 32, 32]: the
// wrapper sums each lane's rows as it sums an unbatched launch's, so a
// lane's H and b are those of a launch of that lane alone, bit for bit.

#include "subtile_search.cuh"

namespace {

using namespace dlo;

constexpr int kSlots = 32;       // hb row width
constexpr int kQuerySlots = 29;  // per-query sums (slots 0-28)

__device__ __forceinline__ unsigned long long pack_key(float d2, int idx) {
  return (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) | static_cast<uint32_t>(idx);
}

__global__ void __launch_bounds__(kThreads) fused_linearize_kernel(
    const float* __restrict__ p,          // [B, Q, 3] transformed source points
    const float* __restrict__ m,          // [B, Q, 3] rotated source normals R n_a
    const uint8_t* __restrict__ qw,       // [B, Q] source mask & normals_valid
    const int32_t* __restrict__ seed,     // [B, Q] warm-start target index, -1 = cold
    const float* __restrict__ targets,    // [B, T, 3] Morton-sorted, T = 512 C
    const uint8_t* __restrict__ tmask,    // [B, T]
    const float* __restrict__ tnormals,   // [B, T, 3]
    const uint8_t* __restrict__ tnvalid,  // [B, T]
    const float* __restrict__ chunk_lo,   // [B, 3, C] masked chunk AABBs
    const float* __restrict__ chunk_hi,   // [B, 3, C]
    int n_chunks, float radius2, float plane_a,
    float* __restrict__ hb,               // [B, Q / 32, 32]
    float* __restrict__ pay,              // [B, Q, 8]
    int32_t* __restrict__ out_idx) {      // [B, Q]
  __shared__ float4 s_buf[2][kChunk];
  __shared__ uint32_t s_bits[kBitWords];    // chunks to visit: gap^2 <= B
  __shared__ uint32_t s_listed[kBitWords];  // candidates at r^2 (slot 30)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane_subtile();
  const int q = sub * kSub + lane;                 // among every lane's queries
  const int chunk0 = blockIdx.y * n_chunks;        // the lane's first target chunk
  const float qx = p[3 * q + 0];
  const float qy = p[3 * q + 1];
  const float qz = p[3 * q + 2];
  const bool weighted = qw[q] != 0;
  float* row = hb + static_cast<size_t>(sub) * kSlots;

  float lo[3], hi[3];
  if (!subtile_aabb(qx, qy, qz, weighted, lo, hi)) {  // the same in every warp
    if (warp == 0) {
      float* o = pay + static_cast<size_t>(q) * 8;
#pragma unroll
      for (int s = 0; s < 8; ++s) o[s] = 0.f;
      out_idx[q] = -1;
      row[lane] = 0.f;
    }
    return;
  }

  // the seed: every warp computes the same, so B needs no barrier
  float seed_d2 = radius2;
  int seed_idx = -1;
  const int j = seed[q];  // an index into the lane's targets
  const size_t tj = static_cast<size_t>(chunk0) * kChunk + j;
  if (weighted && j >= 0 && j < n_chunks * kChunk && tmask[tj] != 0) {
    const float d2 = dist2_rn(qx - targets[3 * tj + 0], qy - targets[3 * tj + 1],
                              qz - targets[3 * tj + 2]);
    if (d2 < radius2) {
      seed_d2 = d2;
      seed_idx = j;
    }
  }
  float bound = weighted ? seed_d2 : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bound = fmaxf(bound, __shfl_xor_sync(kFullMask, bound, o));
  select_candidates(lo, hi, chunk_lo + 3 * chunk0, chunk_hi + 3 * chunk0, n_chunks, bound, s_bits);
  select_candidates(lo, hi, chunk_lo + 3 * chunk0, chunk_hi + 3 * chunk0, n_chunks, radius2,
                    s_listed);
  __syncthreads();
  const int n_words = (n_chunks + 31) >> 5;

  // K2's walk and inner loop (csrc/nn1_pruned.cu), in the kernel body for
  // the same reason: built from helpers, K2 ran 25-45 % slower
  float best = weighted ? radius2 : 0.0f;
  int best_idx = -1;
  int c = next_candidate(s_bits, n_words, 0);
  bool ok0 = false, ok1 = false;
  if (c >= 0) stage_issue(s_buf[0], targets, tmask, chunk0 + c, ok0, ok1);
  for (int k = 0; c >= 0; ++k) {
    float4* buf = s_buf[k & 1];
    stage_finish(buf, ok0, ok1);
    __syncthreads();  // chunk c has landed; every warp is done with the other buffer
    const int next = next_candidate(s_bits, n_words, c + 1);
    if (next >= 0) stage_issue(s_buf[(k + 1) & 1], targets, tmask, chunk0 + next, ok0, ok1);
    const float4* sp = buf + warp * kSlice;
    const int base = c * kChunk + warp * kSlice;
#pragma unroll 8
    for (int i = 0; i < kSlice; ++i) {
      const float4 t = sp[i];
      const float d2 = dist2_rn(qx - t.x, qy - t.y, qz - t.z);
      if (d2 < best) {
        best = d2;
        best_idx = base + i;
      }
    }
    c = next;
  }

  __syncthreads();  // every warp is done reading the chunks: reuse the buffer
  auto* s_key = reinterpret_cast<unsigned long long*>(&s_buf[0][0]);  // [kWarps][kSub]
  s_key[threadIdx.x] = pack_key(best, best_idx);
  __syncthreads();
  // warp 0: one query a lane, its 29 slots into shared memory (s_val)
  float* s_val = reinterpret_cast<float*>(&s_buf[1][0]);  // [kQuerySlots][kSub]
  if (warp == 0) {
    unsigned long long key = seed_idx >= 0 ? pack_key(seed_d2, seed_idx) : s_key[lane];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned long long other = s_key[w * kSub + lane];
      key = other < key ? other : key;
    }
    const uint32_t win = static_cast<uint32_t>(key);
    best_idx = win != 0xffffffffu ? static_cast<int>(win) : -1;
    best = best_idx >= 0 ? __uint_as_float(static_cast<uint32_t>(key >> 32)) : best;

    const size_t tb = static_cast<size_t>(chunk0) * kChunk + best_idx;  // among every lane's
    const bool w = best_idx >= 0 && weighted && tnvalid[tb] != 0;
    float* v = s_val + lane;  // this query's slot s at v[s * kSub]
    float bx = 0.f, by = 0.f, bz = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
    if (w) {
      bx = targets[3 * tb + 0];
      by = targets[3 * tb + 1];
      bz = targets[3 * tb + 2];
      nx = tnormals[3 * tb + 0];
      ny = tnormals[3 * tb + 1];
      nz = tnormals[3 * tb + 2];
      const float mx = m[3 * q + 0];
      const float my = m[3 * q + 1];
      const float mz = m[3 * q + 2];

      // A = C_B + R C_A R^T = 2I - a (n n^T + m m^T), a = 1 - eps
      const float a = plane_a;
      const float a00 = 2.f - a * (nx * nx + mx * mx);
      const float a01 = -a * (nx * ny + mx * my);
      const float a02 = -a * (nx * nz + mx * mz);
      const float a11 = 2.f - a * (ny * ny + my * my);
      const float a12 = -a * (ny * nz + my * mz);
      const float a22 = 2.f - a * (nz * nz + mz * mz);

      // M = A^{-1} (analytic adjugate; A is SPD by construction)
      const float co00 = a11 * a22 - a12 * a12;
      const float co01 = a02 * a12 - a01 * a22;
      const float co02 = a01 * a12 - a02 * a11;
      const float det = a00 * co00 + a01 * co01 + a02 * co02;
      const float inv_det = 1.f / (fabsf(det) > 1e-20f ? det : 1.f);
      const float m00 = co00 * inv_det;
      const float m01 = co01 * inv_det;
      const float m02 = co02 * inv_det;
      const float m11 = (a00 * a22 - a02 * a02) * inv_det;
      const float m12 = (a01 * a02 - a00 * a12) * inv_det;
      const float m22 = (a00 * a11 - a01 * a01) * inv_det;

      // e = mu_b - p
      const float ex = bx - qx;
      const float ey = by - qy;
      const float ez = bz - qz;
      const float mex = m00 * ex + m01 * ey + m02 * ez;
      const float mey = m01 * ex + m11 * ey + m12 * ez;
      const float mez = m02 * ex + m12 * ey + m22 * ez;
      const float err = ex * mex + ey * mey + ez * mez;

      // H_tr = S M with S = skew(p): column k of S M is p x M[:,k]
      const float t00 = qy * m02 - qz * m01, t10 = qz * m00 - qx * m02, t20 = qx * m01 - qy * m00;
      const float t01 = qy * m12 - qz * m11, t11 = qz * m01 - qx * m12, t21 = qx * m11 - qy * m01;
      const float t02 = qy * m22 - qz * m12, t12 = qz * m02 - qx * m22, t22 = qx * m12 - qy * m02;

      // H_tl column k = -p x (M s_k), s_k = p x e_k
      const float d0y = m11 * qz - m12 * qy, d0z = m12 * qz - m22 * qy;
      const float d1x = m02 * qx - m00 * qz, d1y = m12 * qx - m01 * qz, d1z = m22 * qx - m02 * qz;
      const float d2x = m00 * qy - m01 * qx, d2y = m01 * qy - m11 * qx, d2z = m02 * qy - m12 * qx;
      const float c0x = qy * d0z - qz * d0y;
      const float c1x = qy * d1z - qz * d1y, c1y = qz * d1x - qx * d1z;
      const float c2x = qy * d2z - qz * d2y, c2y = qz * d2x - qx * d2z;

      // b_top = S^T (M e) = -p x me ; b_bot = -M e
      const float btx = qy * mez - qz * mey;
      const float bty = qz * mex - qx * mez;
      const float btz = qx * mey - qy * mex;

      v[0 * kSub] = -c0x; v[1 * kSub] = -c1x; v[2 * kSub] = -c2x;
      v[3 * kSub] = -c1y; v[4 * kSub] = -c2y;
      v[5 * kSub] = -(qx * d2y - qy * d2x);
      v[6 * kSub] = t00; v[7 * kSub] = t01; v[8 * kSub] = t02;
      v[9 * kSub] = t10; v[10 * kSub] = t11; v[11 * kSub] = t12;
      v[12 * kSub] = t20; v[13 * kSub] = t21; v[14 * kSub] = t22;
      v[15 * kSub] = m00; v[16 * kSub] = m01; v[17 * kSub] = m02;
      v[18 * kSub] = m11; v[19 * kSub] = m12; v[20 * kSub] = m22;
      v[21 * kSub] = -btx; v[22 * kSub] = -bty; v[23 * kSub] = -btz;
      v[24 * kSub] = -mex; v[25 * kSub] = -mey; v[26 * kSub] = -mez;
      v[27 * kSub] = err;
      v[28 * kSub] = 1.f;
    } else {
#pragma unroll
      for (int s = 0; s < kQuerySlots; ++s) v[s * kSub] = 0.f;
    }

    float* o = pay + static_cast<size_t>(q) * 8;
    o[0] = bx; o[1] = by; o[2] = bz;
    o[3] = nx; o[4] = ny; o[5] = nz;
    o[6] = w ? 1.f : 0.f;
    o[7] = best;
    out_idx[q] = w ? best_idx : -1;
  }
  __syncthreads();
  // sub-tile sums: warp w reduces slots w, w + 8, ... over the 32 queries in
  // a fixed shuffle tree
  for (int s = warp; s < kQuerySlots; s += kWarps) {
    float x = s_val[s * kSub + lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFullMask, x, off);
    if (lane == 0) row[s] = x;
  }
  if (threadIdx.x == kThreads - 1) {
    row[kQuerySlots] = static_cast<float>(count_candidates(s_bits, n_words));
    row[kQuerySlots + 1] = static_cast<float>(count_candidates(s_listed, n_words));
    row[kQuerySlots + 2] = 0.f;
  }
}

}  // namespace

extern "C" int dlo_fused_linearize(
    const void* p, const void* m, const void* qw, const void* seed,
    const void* targets, const void* tmask, const void* tnormals, const void* tnvalid,
    const void* chunk_lo, const void* chunk_hi, int n_queries, int n_chunks, int n_lanes,
    float radius2, float plane_a, void* hb, void* pay, void* out_idx, void* stream) {
  if (!lanes_fit(n_queries, n_chunks, n_lanes)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_queries > 0 && n_lanes > 0) {
    fused_linearize_kernel<<<dim3(n_queries / kSub, n_lanes), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(m),
        static_cast<const uint8_t*>(qw), static_cast<const int32_t*>(seed),
        static_cast<const float*>(targets), static_cast<const uint8_t*>(tmask),
        static_cast<const float*>(tnormals), static_cast<const uint8_t*>(tnvalid),
        static_cast<const float*>(chunk_lo), static_cast<const float*>(chunk_hi),
        n_chunks, radius2, plane_a,
        static_cast<float*>(hb), static_cast<float*>(pay), static_cast<int32_t*>(out_idx));
  }
  return static_cast<int>(cudaGetLastError());
}
