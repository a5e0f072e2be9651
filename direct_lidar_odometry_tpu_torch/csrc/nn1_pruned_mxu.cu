// Fixed-radius 1-NN over a Morton-sorted target cloud on the distance
// expansion, by branch-and-bound over gap-sorted candidate chunks: kernel
// K4. sm_90a.
//
// Replaces the TPU kernel direct_lidar_odometry_tpu/ops/pallas_nn.py:
// _nn1_pruned_kernel_mxu (body _pruned_kernel_body with mxu=True), the
// search of the "pallas_mxu" backend.
//
// What it computes: for each query q of a 128-query tile, the index of the
// nearest target t with d2(q, t) < r^2 (ties go to the lower target index),
// or -1, with d2 = max((|q|^2 + |t|^2) - 2 q.t, 0) over targets whose
// invalid entries the wrapper folded to the finite padding coordinate 1e6
// (an infinite coordinate would give inf - inf = NaN in the expansion), with
// |t|^2 precomputed by the wrapper: its winner may differ from the exact
// search's (K2) among near-ties within the expansion's cancellation error,
// which the public entry tolerates by recomputing the winner's exact d2.
// Each query's bound starts at r^2 (0 for invalid queries, so they never
// hold the tile open). The TPU kernel ran the cross term on its matrix unit
// at HIGHEST precision; here it is three fp32 products on the CUDA cores,
// never TF32 (TF32's error at 30-60 m coordinates is metres^2).
//
// What bounds it on the H100: FP32 issue on the distance loop, about 10
// instructions per pair (3 products, 4 adds, a max, a compare and a
// select); memory traffic is one 6 KB chunk read per visited (tile, chunk),
// served mostly from L2 since every tile of a frame reads the same target
// cloud. Design: one thread per query keeps its (d2, idx) minimum in
// registers; the block stages each visited chunk in shared memory with
// coalesced loads and every thread then reads the same shared address in
// lockstep (a broadcast, no bank conflicts). The early exit is one
// __syncthreads_or per chunk, which is also the barrier that protects the
// shared chunk before the next load. The candidate lists (packed gap+index
// words, ascending gap) come from ops/cuda_nn.py candidate_chunks. Known
// limit: 128 threads per block and one block per tile leave most of each
// SM's thread slots empty at 256 tiles per call (csrc/nn1_pruned.cu, K2,
// splits the work over sub-tiles and chunk slices instead).

#include "chunk_ops.cuh"

namespace {

using namespace dlo;

__global__ void __launch_bounds__(kTile) nn1_pruned_mxu_kernel(
    const float* __restrict__ queries,   // [Q, 3]
    const uint8_t* __restrict__ qmask,   // [Q]
    const float* __restrict__ targets,   // [T, 3], invalid folded to 1e6
    const float* __restrict__ t2,        // [T] |t|^2
    const int32_t* __restrict__ cand,    // [Qc, n_c] packed gap+index words
    const int32_t* __restrict__ counts,  // [Qc]
    int n_c, float radius2, float gap_unit,
    int32_t* __restrict__ out_idx,       // [Q]
    float* __restrict__ out_d2) {        // [Q]
  __shared__ float s_x[kChunk];
  __shared__ float s_y[kChunk];
  __shared__ float s_z[kChunk];
  __shared__ float s_t2[kChunk];

  const int tile = blockIdx.x;
  const int q = tile * kTile + threadIdx.x;
  const float qx = queries[3 * q + 0];
  const float qy = queries[3 * q + 1];
  const float qz = queries[3 * q + 2];
  const float q2 = dist2_rn(qx, qy, qz);
  float best = qmask[q] ? radius2 : 0.0f;
  int best_idx = -1;

  // The walk, the staging and the inner loop are spelled out in the kernel
  // body: built from helper functions instead, K2 ran 25-45 % slower on the
  // H100 at the slice shapes with the same instruction count per pair.
  const int cnt = counts[tile];
  const int32_t* row = cand + static_cast<size_t>(tile) * n_c;
  for (int k = 0; k < cnt; ++k) {
    const int32_t word = row[k];
    const float gap = static_cast<float>(word >> kIdxBits) * gap_unit;
    // block-uniform exit: stop once the gap exceeds every query's bound
    if (!__syncthreads_or(gap <= best)) break;
    const int base = (word & ((1 << kIdxBits) - 1)) * kChunk;
    for (int i = threadIdx.x; i < kChunk; i += kTile) {
      s_x[i] = targets[3 * (base + i) + 0];
      s_y[i] = targets[3 * (base + i) + 1];
      s_z[i] = targets[3 * (base + i) + 2];
      s_t2[i] = t2[base + i];
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < kChunk; ++i) {
      const float g = __fadd_rn(__fadd_rn(__fmul_rn(qx, s_x[i]), __fmul_rn(qy, s_y[i])),
                                __fmul_rn(qz, s_z[i]));
      const float d2 = fmaxf(__fsub_rn(__fadd_rn(q2, s_t2[i]), __fmul_rn(2.0f, g)), 0.0f);
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

extern "C" int dlo_nn1_pruned_mxu(
    const void* queries, const void* qmask, const void* targets, const void* t2,
    const void* cand, const void* counts, int n_tiles, int n_c,
    float radius2, float gap_unit, void* out_idx, void* out_d2, void* stream) {
  if (n_tiles > 0) {
    nn1_pruned_mxu_kernel<<<n_tiles, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(queries), static_cast<const uint8_t*>(qmask),
        static_cast<const float*>(targets), static_cast<const float*>(t2),
        static_cast<const int32_t*>(cand), static_cast<const int32_t*>(counts), n_c, radius2,
        gap_unit, static_cast<int32_t*>(out_idx), static_cast<float*>(out_d2));
  }
  return static_cast<int>(cudaGetLastError());
}
