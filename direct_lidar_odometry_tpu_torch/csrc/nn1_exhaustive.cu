// Exhaustive 1-NN (kernel K5). sm_90a.
//
// Replaces the TPU kernel direct_lidar_odometry_tpu/ops/pallas_nn.py:
// _nn1_kernel, behind the public query_1nn (the package's exact oracle).
//
// What it computes: for each query, the raw minimum of
// d2 = ((dx*dx + dy*dy) + dz*dz) over every valid target and its index
// (ties to the lower index), with no radius bound: d2 is reported even
// beyond the radius, and is +inf with index -1 only when every target is
// invalid. Targets come in any order (no Morton assumption). The radius
// test and the query mask are the wrapper's (ops/cuda_nn.py query_1nn).
//
// What bounds it on the H100: the FP32 instruction rate. The exact distance
// is three subtractions, three products and two additions, none fused (a
// fused one would round differently from the plain version), then a compare
// and two selects: 11 instruction slots a pair, over Q x (valid targets)
// pairs. Design (dense_targets.cuh): three launches on the caller's
// stream. (1) The pre-pass compacts the valid targets into a dense float4
// array with their indices, so the scan's work follows the valid targets,
// not the slots.
// (2) The scan runs a grid of (query tile, target split) blocks, enough of
// them to fill every SM several times over; a thread holds four queries in
// registers, so one 16-byte shared-memory load serves four pairs, and the
// next chunks' cp.async copies are in flight while a chunk is scanned. A
// warp walks its slices in ascending index order, so "strictly smaller
// wins" keeps the lower index; across warps and splits the results merge
// as packed keys (d2 bits << 32 | index; d2 >= 0, so integer order is
// distance order and the lower index wins ties), an exact and order-free
// minimum: first the block's four warps through shared memory, one key per
// (split, query) written out, then (3) a small kernel takes the minimum
// over the splits and unpacks it. No atomics touch the result, so two
// launches give the same bits.

#include "dense_targets.cuh"

namespace {

using namespace dlo;

constexpr unsigned long long kNoKey = 0x7f800000ffffffffull;  // d2 = +inf, index -1

__global__ void __launch_bounds__(kScanThreads) nn1_exhaustive_kernel(
    const float* __restrict__ queries,        // [Q, 3]
    const float4* __restrict__ dense,         // the valid targets, dense_targets.cuh
    int32_t* __restrict__ stats,              // [2]: valid count, chunks scanned
    int n_queries,
    unsigned long long* __restrict__ part) {  // [n_splits, Q] packed keys
  __shared__ float4 s_buf[kStages][kChunk];
  __shared__ unsigned long long s_key[kScanWarps][kTile];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kTile;
  float qx[kPerLane], qy[kPerLane], qz[kPerLane], best[kPerLane];
  int best_idx[kPerLane];
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int q = q0 + lane + 32 * r;
    qx[r] = queries[3 * q + 0];
    qy[r] = queries[3 * q + 1];
    qz[r] = queries[3 * q + 2];
    best[r] = INFINITY;
    best_idx[r] = -1;
  }

  int begin, end;
  split_range(stats[0], blockIdx.y, gridDim.y, begin, end);
  if (threadIdx.x == 0 && end > begin) atomicAdd(&stats[1], end - begin);
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    ring_start(s_buf[k], dense, begin + k < end ? begin + k : -1);
  }
  for (int c = begin; c < end; ++c) {
    ring_wait();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    const int ahead = c + kStages - 1;
    ring_start(s_buf[(ahead - begin) % kStages], dense, ahead < end ? ahead : -1);
    const float4* sp = s_buf[(c - begin) % kStages] + warp * kScanSlice;
    // strictly smaller wins: in this ascending scan ties keep the lower index
#pragma unroll 8
    for (int i = 0; i < kScanSlice; ++i) {
      const float4 t = sp[i];
      const int ti = __float_as_int(t.w);
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        const float d2 = dist2_rn(qx[r] - t.x, qy[r] - t.y, qz[r] - t.z);
        if (d2 < best[r]) {
          best[r] = d2;
          best_idx[r] = ti;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    s_key[warp][lane + 32 * r] =
        (static_cast<unsigned long long>(__float_as_uint(best[r])) << 32) |
        static_cast<unsigned>(best_idx[r]);
  }
  __syncthreads();
  unsigned long long key = s_key[0][threadIdx.x];
#pragma unroll
  for (int w = 1; w < kScanWarps; ++w) key = min(key, s_key[w][threadIdx.x]);
  part[static_cast<size_t>(blockIdx.y) * n_queries + q0 + threadIdx.x] = key;
}

__global__ void nn1_merge_kernel(const unsigned long long* __restrict__ part, int n_queries,
                                 int n_splits,
                                 int32_t* __restrict__ out_idx,  // [Q]
                                 float* __restrict__ out_d2) {   // [Q]
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_queries) return;
  unsigned long long key = kNoKey;
  for (int s = 0; s < n_splits; ++s) key = min(key, part[static_cast<size_t>(s) * n_queries + q]);
  // a pad slot or a target at d2 = +inf never wins: the index stays -1
  out_idx[q] = static_cast<int32_t>(static_cast<unsigned>(key));
  out_d2[q] = __uint_as_float(static_cast<unsigned>(key >> 32));
}

}  // namespace

extern "C" int dlo_nn1_exhaustive(const void* queries, const void* targets, const void* tmask,
                                  int n_queries, int n_targets, int n_splits, void* dense,
                                  void* stats, void* part, void* out_idx, void* out_d2,
                                  void* stream) {
  if (n_queries % kTile != 0 || n_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      compact_targets(static_cast<const float*>(targets), static_cast<const uint8_t*>(tmask),
                      n_targets, static_cast<float4*>(dense), static_cast<int32_t*>(stats), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_queries > 0) {
    auto* keys = static_cast<unsigned long long*>(part);
    nn1_exhaustive_kernel<<<dim3(n_queries / kTile, n_splits), kScanThreads, 0, st>>>(
        static_cast<const float*>(queries), static_cast<const float4*>(dense),
        static_cast<int32_t*>(stats), n_queries, keys);
    nn1_merge_kernel<<<(n_queries + 255) / 256, 256, 0, st>>>(
        keys, n_queries, n_splits, static_cast<int32_t*>(out_idx), static_cast<float*>(out_d2));
  }
  return static_cast<int>(cudaGetLastError());
}
