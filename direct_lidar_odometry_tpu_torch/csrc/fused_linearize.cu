// Fused GICP linearization (kernel K3): 1-NN correspondence search,
// PLANE Mahalanobis and the per-tile H/b partials in one pass. sm_90a.
//
// Replaces the TPU kernel direct_lidar_odometry_tpu/ops/pallas_gicp.py:
// _fused_linearize_kernel, the linearization of the "pallas_fused" backend
// (reference nano_gicp_impl.hpp:173-270).
//
// What it computes, per 128-query tile: for each query p (the transformed
// source point) with weight qw = mask & normals_valid, its nearest valid
// target within r (K2's search: exact coordinate-difference distance, ties
// to the lower target index, branch-and-bound over the tile's gap-sorted
// candidate chunks); the correspondence weight w = found & qw & the
// target's normals_valid; for w = 1 the PLANE Mahalanobis matrix
// M = (2I - (1-eps)(n n^T + m m^T))^-1 by adjugate (n the target normal,
// m the rotated source normal) and the Gauss-Newton terms of
// J = [skew(p) | -I]: 21 H entries (S^T M S upper, S M, M upper), b (6),
// the error e^T M e and n_corr, summed over the tile into one row of
// hb [Qc, 32] (slots 0-28), plus two branch-and-bound diagnostics (slot 29
// chunks visited, slot 30 candidates listed). Per query it writes the
// frozen payload [mu_b xyz, n_b xyz, w, best d2] and the correspondence
// index (-1 where w = 0). Queries with w = 0 contribute exact zeros and a
// zero payload: their adjugate is never formed, so garbage normals cannot
// poison the sums through a NaN determinant or 0 * inf.
//
// Warm start: seed[q] >= 0 names a target (the previous iteration's
// correspondence). The kernel computes that target's distance with the
// same rounded formula as the search; if the target is valid and strictly
// inside r, it becomes the initial best, which tightens the bound so the
// walk exits after fewer chunks. The result equals the cold result exactly:
// every chunk that could hold a nearer (or equally near, lower-index)
// target is still visited. Lanes with qw = 0 start at bound 0, so they
// never hold the tile open.
//
// What bounds it on the H100: the search's FP32 issue, as in K2 (about 10
// instructions per visited pair); the per-query epilogue is ~150 flops once
// per query. Design: K2's search (the same walk and update rule) with the
// best index in a register; the winner's point, normal and valid
// flag are read from global memory once after the walk. The TPU kernel's centred distance
// expansion and one-hot matrix-unit payload select exist because the TPU
// gathers badly; they are not carried over, which also makes this kernel's
// correspondences identical to the "pallas" path's. The tile's 31 sums are
// reduced with warp shuffles and then across the 4 warps through shared
// memory in a fixed order, with no atomics, so a run repeats bit for bit;
// the wrapper sums the tile rows.

#include "chunk_ops.cuh"

namespace {

using namespace dlo;

constexpr int kSlots = 32;       // hb row width
constexpr int kQuerySlots = 29;  // per-query sums (slots 0-28)
constexpr int kWarps = kTile / 32;

__global__ void __launch_bounds__(kTile) fused_linearize_kernel(
    const float* __restrict__ p,          // [Q, 3] transformed source points
    const float* __restrict__ m,          // [Q, 3] rotated source normals R n_a
    const uint8_t* __restrict__ qw,       // [Q] source mask & normals_valid
    const int32_t* __restrict__ seed,     // [Q] warm-start target index, -1 = cold
    const float* __restrict__ targets,    // [T, 3] Morton-sorted
    const uint8_t* __restrict__ tmask,    // [T]
    const float* __restrict__ tnormals,   // [T, 3]
    const uint8_t* __restrict__ tnvalid,  // [T]
    const int32_t* __restrict__ cand,     // [Qc, n_c]
    const int32_t* __restrict__ counts,   // [Qc]
    int n_c, float radius2, float gap_unit, float plane_a,
    float* __restrict__ hb,               // [Qc, 32]
    float* __restrict__ pay,              // [Q, 8]
    int32_t* __restrict__ out_idx) {      // [Q]
  __shared__ float s_x[kChunk];
  __shared__ float s_y[kChunk];
  __shared__ float s_z[kChunk];
  __shared__ float s_red[kWarps][kQuerySlots];

  const int n_targets = n_c * kChunk;
  const int tile = blockIdx.x;
  const int q = tile * kTile + threadIdx.x;
  const float qx = p[3 * q + 0];
  const float qy = p[3 * q + 1];
  const float qz = p[3 * q + 2];
  const bool weighted = qw[q] != 0;

  float best = weighted ? radius2 : 0.0f;
  int best_idx = -1;
  const int j = seed[q];
  if (weighted && j >= 0 && j < n_targets && tmask[j] != 0) {
    const float d2 = dist2_rn(qx - targets[3 * j + 0], qy - targets[3 * j + 1],
                              qz - targets[3 * j + 2]);
    if (d2 < radius2) {
      best = d2;
      best_idx = j;
    }
  }
  // K2's walk and inner loop (csrc/nn1_pruned.cu), in the kernel body for
  // the same reason
  const int cnt = counts[tile];
  const int32_t* row = cand + static_cast<size_t>(tile) * n_c;
  int visits = 0;
  for (; visits < cnt; ++visits) {
    const int32_t word = row[visits];
    const float gap = static_cast<float>(word >> kIdxBits) * gap_unit;
    if (!__syncthreads_or(gap <= best)) break;
    const int base = (word & ((1 << kIdxBits) - 1)) * kChunk;
    for (int i = threadIdx.x; i < kChunk; i += kTile) {
      const bool ok = tmask[base + i] != 0;
      s_x[i] = ok ? targets[3 * (base + i) + 0] : INFINITY;
      s_y[i] = ok ? targets[3 * (base + i) + 1] : INFINITY;
      s_z[i] = ok ? targets[3 * (base + i) + 2] : INFINITY;
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < kChunk; ++i) {
      const float d2 = dist2_rn(qx - s_x[i], qy - s_y[i], qz - s_z[i]);
      const int gi = base + i;
      if (d2 < best || (d2 == best && best_idx >= 0 && gi < best_idx)) {
        best = d2;
        best_idx = gi;
      }
    }
  }

  const bool w = best_idx >= 0 && weighted && tnvalid[best_idx] != 0;
  float v[kQuerySlots];
#pragma unroll
  for (int s = 0; s < kQuerySlots; ++s) v[s] = 0.f;
  float bx = 0.f, by = 0.f, bz = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  if (w) {
    bx = targets[3 * best_idx + 0];
    by = targets[3 * best_idx + 1];
    bz = targets[3 * best_idx + 2];
    nx = tnormals[3 * best_idx + 0];
    ny = tnormals[3 * best_idx + 1];
    nz = tnormals[3 * best_idx + 2];
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

    v[0] = -c0x; v[1] = -c1x; v[2] = -c2x; v[3] = -c1y; v[4] = -c2y;
    v[5] = -(qx * d2y - qy * d2x);
    v[6] = t00; v[7] = t01; v[8] = t02;
    v[9] = t10; v[10] = t11; v[11] = t12;
    v[12] = t20; v[13] = t21; v[14] = t22;
    v[15] = m00; v[16] = m01; v[17] = m02; v[18] = m11; v[19] = m12; v[20] = m22;
    v[21] = -btx; v[22] = -bty; v[23] = -btz;
    v[24] = -mex; v[25] = -mey; v[26] = -mez;
    v[27] = err;
    v[28] = 1.f;
  }

  float* o = pay + static_cast<size_t>(q) * 8;
  o[0] = bx; o[1] = by; o[2] = bz;
  o[3] = nx; o[4] = ny; o[5] = nz;
  o[6] = w ? 1.f : 0.f;
  o[7] = best;
  out_idx[q] = w ? best_idx : -1;

  // tile sums: warp shuffles, then the 4 warp partials in a fixed order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < kQuerySlots; ++s) {
    float x = v[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) s_red[warp][s] = x;
  }
  __syncthreads();
  if (threadIdx.x < kSlots) {
    const int s = threadIdx.x;
    float x = 0.f;
    if (s < kQuerySlots) {
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) x += s_red[wi][s];
    } else if (s == kQuerySlots) {
      x = static_cast<float>(visits);
    } else if (s == kQuerySlots + 1) {
      x = static_cast<float>(cnt);
    }
    hb[static_cast<size_t>(tile) * kSlots + s] = x;
  }
}

}  // namespace

extern "C" int dlo_fused_linearize(
    const void* p, const void* m, const void* qw, const void* seed,
    const void* targets, const void* tmask, const void* tnormals, const void* tnvalid,
    const void* cand, const void* counts, int n_tiles, int n_c,
    float radius2, float gap_unit, float plane_a,
    void* hb, void* pay, void* out_idx, void* stream) {
  if (n_tiles > 0) {
    fused_linearize_kernel<<<n_tiles, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(m),
        static_cast<const uint8_t*>(qw), static_cast<const int32_t*>(seed),
        static_cast<const float*>(targets), static_cast<const uint8_t*>(tmask),
        static_cast<const float*>(tnormals), static_cast<const uint8_t*>(tnvalid),
        static_cast<const int32_t*>(cand), static_cast<const int32_t*>(counts),
        n_c, radius2, gap_unit, plane_a,
        static_cast<float*>(hb), static_cast<float*>(pay), static_cast<int32_t*>(out_idx));
  }
  return static_cast<int>(cudaGetLastError());
}
