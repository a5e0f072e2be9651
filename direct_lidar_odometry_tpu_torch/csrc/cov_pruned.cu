// Fixed-radius neighbourhood moments over a Morton-sorted cloud, visiting
// only candidate chunks. sm_90a.
//
// Replaces the TPU kernel direct_lidar_odometry_tpu/ops/pallas_cov.py:
// _cov_pruned_kernel, which feeds the normals of every scan and every
// spawned keyframe.
//
// What it computes: for each valid query q of a 128-query tile, the 10
// query-relative moments (n, sum d, sum d d^T with d = t - q, as
// n, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz) over the valid targets with
// |d|^2 <= r^2. The tile visits every chunk of its candidate list (the
// 512-point chunks whose AABB gap to the tile is <= r; ops/cuda_nn.py
// candidate_chunks), with no early exit. Rows of invalid queries are zero.
// Offsets stay query-relative (bounded by r), which keeps the covariance
// well conditioned at map-scale coordinates.
//
// What bounds it on the H100: FP32 issue on the pair loop (about 10
// instructions per pair for the distance and the test, 9 more per pair
// inside the radius). Each visited chunk is a 6 KB read, mostly from L2.
// Design: one thread per query holds its 10 sums in registers; the block
// stages each candidate chunk in shared memory with coalesced loads and
// all threads read the same shared address in lockstep (broadcast). The
// radius test uses __fmul_rn/__fadd_rn in the plain version's order, so
// the neighbour sets agree exactly with it; the sums themselves are taken
// in another order than the plain version's, which moves them by float
// rounding only.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kChunk = 512;
constexpr int kIdxBits = 10;
constexpr int kMoments = 10;

__device__ __forceinline__ float dist2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kTile) cov_pruned_kernel(
    const float* __restrict__ queries,   // [Q, 3]
    const uint8_t* __restrict__ qmask,   // [Q]
    const float* __restrict__ targets,   // [T, 3]
    const uint8_t* __restrict__ tmask,   // [T]
    const int32_t* __restrict__ cand,    // [Qc, n_c]
    const int32_t* __restrict__ counts,  // [Qc]
    int n_c, float radius2,
    float* __restrict__ out) {           // [Q, 10]
  __shared__ float s_x[kChunk];
  __shared__ float s_y[kChunk];
  __shared__ float s_z[kChunk];

  const int tile = blockIdx.x;
  const int q = tile * kTile + threadIdx.x;
  const float qx = queries[3 * q + 0];
  const float qy = queries[3 * q + 1];
  const float qz = queries[3 * q + 2];

  float n = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  float sxx = 0.f, sxy = 0.f, sxz = 0.f, syy = 0.f, syz = 0.f, szz = 0.f;

  const int cnt = counts[tile];
  const int32_t* row = cand + static_cast<size_t>(tile) * n_c;
  for (int k = 0; k < cnt; ++k) {
    const int j = row[k] & ((1 << kIdxBits) - 1);
    const int base = j * kChunk;
    __syncthreads();  // the previous chunk's reads are done
    for (int i = threadIdx.x; i < kChunk; i += kTile) {
      const bool ok = tmask[base + i] != 0;
      // invalid targets at +inf: d2 = +inf fails the radius test
      s_x[i] = ok ? targets[3 * (base + i) + 0] : INFINITY;
      s_y[i] = ok ? targets[3 * (base + i) + 1] : INFINITY;
      s_z[i] = ok ? targets[3 * (base + i) + 2] : INFINITY;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kChunk; ++i) {
      const float dx = s_x[i] - qx;
      const float dy = s_y[i] - qy;
      const float dz = s_z[i] - qz;
      if (dist2_rn(dx, dy, dz) <= radius2) {
        n += 1.f;
        sx += dx; sy += dy; sz += dz;
        sxx += dx * dx; sxy += dx * dy; sxz += dx * dz;
        syy += dy * dy; syz += dy * dz; szz += dz * dz;
      }
    }
  }
  const bool valid = qmask[q] != 0;
  float* o = out + static_cast<size_t>(q) * kMoments;
  o[0] = valid ? n : 0.f;
  o[1] = valid ? sx : 0.f;
  o[2] = valid ? sy : 0.f;
  o[3] = valid ? sz : 0.f;
  o[4] = valid ? sxx : 0.f;
  o[5] = valid ? sxy : 0.f;
  o[6] = valid ? sxz : 0.f;
  o[7] = valid ? syy : 0.f;
  o[8] = valid ? syz : 0.f;
  o[9] = valid ? szz : 0.f;
}

}  // namespace

extern "C" int dlo_cov_pruned(
    const void* queries, const void* qmask, const void* targets, const void* tmask,
    const void* cand, const void* counts, int n_tiles, int n_c, float radius2,
    void* out, void* stream) {
  if (n_tiles > 0) {
    cov_pruned_kernel<<<n_tiles, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(queries), static_cast<const uint8_t*>(qmask),
        static_cast<const float*>(targets), static_cast<const uint8_t*>(tmask),
        static_cast<const int32_t*>(cand), static_cast<const int32_t*>(counts),
        n_c, radius2, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
