// Exhaustive fixed-radius neighbourhood moments (kernel K6). sm_90a.
//
// Replaces the TPU kernel direct_lidar_odometry_tpu/ops/pallas_cov.py:
// _cov_kernel, behind radius_moments and estimate_normals_radius.
//
// What it computes: for EVERY query q (there is no query mask), the 10
// moments (n, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz) of the offsets
// d = t - q over the valid targets with |d|^2 <= r^2 (inclusive). Invalid
// targets carry the TPU kernel's +inf bias as +inf staged coordinates.
//
// What bounds it on the H100: FP32 issue over all Q x T pairs (about 10
// instructions per pair, 9 more inside the radius). Design: K1's inner loop
// (chunk_ops.cuh moments_chunk) over every 512-point chunk of the cloud
// instead of a candidate list; one thread per query holds its sums in
// registers; each chunk is staged once per block and read as a broadcast.
// The ragged last chunk is padded with +inf.

#include "chunk_ops.cuh"

namespace {

using namespace dlo;

__global__ void __launch_bounds__(kTile) cov_exhaustive_kernel(
    const float* __restrict__ queries,  // [Q, 3]
    const float* __restrict__ targets,  // [T, 3]
    const uint8_t* __restrict__ tmask,  // [T]
    int n_targets, float radius2,
    float* __restrict__ out) {          // [Q, 10]
  __shared__ float s_x[kChunk];
  __shared__ float s_y[kChunk];
  __shared__ float s_z[kChunk];

  const int q = blockIdx.x * kTile + threadIdx.x;
  const float qx = queries[3 * q + 0];
  const float qy = queries[3 * q + 1];
  const float qz = queries[3 * q + 2];
  Moments acc = {};
  for (int base = 0; base < n_targets; base += kChunk) {
    __syncthreads();  // the previous chunk's reads are done
    stage_chunk(s_x, s_y, s_z, targets, tmask, base, n_targets);
    __syncthreads();
    moments_chunk(qx, qy, qz, s_x, s_y, s_z, radius2, acc);
  }
  store_moments(out + static_cast<size_t>(q) * 10, acc, true);
}

}  // namespace

extern "C" int dlo_cov_exhaustive(const void* queries, const void* targets, const void* tmask,
                                  int n_tiles, int n_targets, float radius2, void* out,
                                  void* stream) {
  if (n_tiles > 0) {
    cov_exhaustive_kernel<<<n_tiles, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(queries), static_cast<const float*>(targets),
        static_cast<const uint8_t*>(tmask), n_targets, radius2, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
