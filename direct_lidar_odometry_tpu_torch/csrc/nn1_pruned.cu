// Exact fixed-radius 1-NN over a Morton-sorted target cloud, by
// branch-and-bound over gap-sorted candidate chunks. sm_90a.
//
// Replaces the TPU kernel direct_lidar_odometry_tpu/ops/pallas_nn.py:
// _nn1_pruned_kernel (body _pruned_kernel_body with mxu=False), the
// correspondence search of every GICP iteration.
//
// What it computes: for each query q of a 128-query tile, the index of the
// nearest valid target t with |q - t|^2 < r^2 (ties go to the lower target
// index), or -1. The tile's candidate list (ops/cuda_nn.py
// candidate_chunks) holds the 512-point target chunks whose AABB gap to
// the tile's AABB is <= r, in ascending gap order, each word packing the
// floor-quantized squared gap (high 21 bits) with the chunk index (low 10
// bits). Each query's bound starts at r^2 (0 for invalid queries, so they
// never hold the tile open). Once a chunk's gap exceeds every query's
// bound, no later chunk can improve any query and the tile stops: the
// kd-tree's searchLevel pruning at tile granularity.
//
// What bounds it on the H100: FP32 issue on the distance loop. Each pair
// costs about 10 instructions (3 subtracts, 3 multiplies, 2 adds, a
// compare and a select); memory traffic is one 6 KB chunk read per visited
// (tile, chunk), served mostly from L2 since every tile of a frame reads
// the same target cloud. Design: one thread per query keeps its (d2, idx)
// minimum in registers; the block stages each visited chunk in shared
// memory with coalesced loads and every thread then reads the same
// shared address in lockstep (a broadcast, no bank conflicts). The early
// exit is one __syncthreads_or per chunk, which is also the barrier that
// protects the shared chunk before the next load. Distances use
// __fmul_rn/__fadd_rn in the order ((dx*dx + dy*dy) + dz*dz), the order
// the plain PyTorch version evaluates, so the radius test and the winner
// agree bit for bit with it (nvcc would otherwise contract into FMAs).
// The TPU kernel's packed-mantissa min-reduce is dropped: registers hold
// the index exactly. Known limit of this first version: 128 threads per
// block and one block per tile leave most of each SM's thread slots empty
// at 256 tiles per call.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;   // queries per block, one thread each
constexpr int kChunk = 512;  // targets per Morton chunk (ops/morton.py TARGET_CHUNK)
constexpr int kIdxBits = 10; // packed candidate word: chunk index bits

__device__ __forceinline__ float dist2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kTile) nn1_pruned_kernel(
    const float* __restrict__ queries,   // [Q, 3]
    const uint8_t* __restrict__ qmask,   // [Q]
    const float* __restrict__ targets,   // [T, 3]
    const uint8_t* __restrict__ tmask,   // [T]
    const int32_t* __restrict__ cand,    // [Qc, n_c] packed gap+index words
    const int32_t* __restrict__ counts,  // [Qc]
    int n_c, float radius2, float gap_unit,
    int32_t* __restrict__ out_idx,       // [Q]
    float* __restrict__ out_d2) {        // [Q]
  __shared__ float s_x[kChunk];
  __shared__ float s_y[kChunk];
  __shared__ float s_z[kChunk];

  const int tile = blockIdx.x;
  const int q = tile * kTile + threadIdx.x;
  const float qx = queries[3 * q + 0];
  const float qy = queries[3 * q + 1];
  const float qz = queries[3 * q + 2];
  float best = qmask[q] ? radius2 : 0.0f;
  int best_idx = -1;

  const int cnt = counts[tile];
  const int32_t* row = cand + static_cast<size_t>(tile) * n_c;
  for (int k = 0; k < cnt; ++k) {
    const int32_t word = row[k];
    const float gap = static_cast<float>(word >> kIdxBits) * gap_unit;
    // block-uniform exit: stop once the gap exceeds every query's bound
    if (!__syncthreads_or(gap <= best)) break;
    const int j = word & ((1 << kIdxBits) - 1);
    const int base = j * kChunk;
    for (int i = threadIdx.x; i < kChunk; i += kTile) {
      const bool ok = tmask[base + i] != 0;
      // invalid targets at +inf: their d2 is +inf and never wins
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
  out_idx[q] = best_idx;
  out_d2[q] = best_idx >= 0 ? best : INFINITY;
}

}  // namespace

extern "C" int dlo_nn1_pruned(
    const void* queries, const void* qmask, const void* targets, const void* tmask,
    const void* cand, const void* counts, int n_tiles, int n_c,
    float radius2, float gap_unit, void* out_idx, void* out_d2, void* stream) {
  if (n_tiles > 0) {
    nn1_pruned_kernel<<<n_tiles, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(queries), static_cast<const uint8_t*>(qmask),
        static_cast<const float*>(targets), static_cast<const uint8_t*>(tmask),
        static_cast<const int32_t*>(cand), static_cast<const int32_t*>(counts),
        n_c, radius2, gap_unit,
        static_cast<int32_t*>(out_idx), static_cast<float*>(out_d2));
  }
  return static_cast<int>(cudaGetLastError());
}
