// Fixed-radius neighbourhood moments over a Morton-sorted cloud, visiting
// only candidate chunks (kernel K1). sm_90a.
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
// radius test (chunk_ops.cuh moments_chunk) uses the plain version's
// rounding, so the neighbour sets agree exactly with it; the sums
// themselves are taken in another order than the plain version's, which
// moves them by float rounding only.

#include "chunk_ops.cuh"

namespace {

using namespace dlo;

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
  Moments acc = {};

  const int cnt = counts[tile];
  const int32_t* row = cand + static_cast<size_t>(tile) * n_c;
  for (int k = 0; k < cnt; ++k) {
    const int base = (row[k] & ((1 << kIdxBits) - 1)) * kChunk;
    __syncthreads();  // the previous chunk's reads are done
    stage_chunk(s_x, s_y, s_z, targets, tmask, base, n_c * kChunk);
    __syncthreads();
    moments_chunk(qx, qy, qz, s_x, s_y, s_z, radius2, acc);
  }
  store_moments(out + static_cast<size_t>(q) * 10, acc, qmask[q] != 0);
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
