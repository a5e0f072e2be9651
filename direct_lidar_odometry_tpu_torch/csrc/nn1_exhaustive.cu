// Exhaustive tiled 1-NN (kernel K5). sm_90a.
//
// Replaces the TPU kernel direct_lidar_odometry_tpu/ops/pallas_nn.py:
// _nn1_kernel, behind the public query_1nn (the package's exact oracle).
//
// What it computes: for each query of a 128-query tile, the raw minimum of
// d2 = ((dx*dx + dy*dy) + dz*dz) over every valid target and its index
// (ties to the lower index), with no radius bound: d2 is reported even
// beyond the radius, and is +inf with index -1 only when every target is
// invalid. Invalid targets carry the TPU kernel's +inf bias, here as +inf
// staged coordinates (d2 = +inf, the same value as d2 + inf). The radius
// test and the query mask are the wrapper's (ops/cuda_nn.py query_1nn).
//
// What bounds it on the H100: FP32 issue, about 10 instructions per pair
// over all Q x T pairs. Design: K2's inner loop (distance and update rule)
// over every 512-point chunk of the cloud instead of a candidate list, one
// thread per query, each chunk staged once per block in shared memory and
// read as a broadcast. The ragged last chunk is padded with +inf.

#include "chunk_ops.cuh"

namespace {

using namespace dlo;

__global__ void __launch_bounds__(kTile) nn1_exhaustive_kernel(
    const float* __restrict__ queries,  // [Q, 3]
    const float* __restrict__ targets,  // [T, 3]
    const uint8_t* __restrict__ tmask,  // [T]
    int n_targets,
    int32_t* __restrict__ out_idx,      // [Q]
    float* __restrict__ out_d2) {       // [Q]
  __shared__ float s_x[kChunk];
  __shared__ float s_y[kChunk];
  __shared__ float s_z[kChunk];

  const int q = blockIdx.x * kTile + threadIdx.x;
  const float qx = queries[3 * q + 0];
  const float qy = queries[3 * q + 1];
  const float qz = queries[3 * q + 2];
  float best = INFINITY;
  int best_idx = -1;
  for (int base = 0; base < n_targets; base += kChunk) {
    __syncthreads();  // the previous chunk's reads are done
    stage_chunk(s_x, s_y, s_z, targets, tmask, base, n_targets);
    __syncthreads();
    // strictly smaller wins: in this ascending scan ties keep the lower index
#pragma unroll 8
    for (int i = 0; i < kChunk; ++i) {
      const float d2 = dist2_rn(qx - s_x[i], qy - s_y[i], qz - s_z[i]);
      if (d2 < best) {
        best = d2;
        best_idx = base + i;
      }
    }
  }
  out_idx[q] = best_idx;
  out_d2[q] = best;
}

}  // namespace

extern "C" int dlo_nn1_exhaustive(const void* queries, const void* targets, const void* tmask,
                                  int n_tiles, int n_targets, void* out_idx, void* out_d2,
                                  void* stream) {
  if (n_tiles > 0) {
    nn1_exhaustive_kernel<<<n_tiles, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(queries), static_cast<const float*>(targets),
        static_cast<const uint8_t*>(tmask), n_targets,
        static_cast<int32_t*>(out_idx), static_cast<float*>(out_d2));
  }
  return static_cast<int>(cudaGetLastError());
}
