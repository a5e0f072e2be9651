// What the exhaustive kernels K5 (nn1_exhaustive.cu) and K6
// (cov_exhaustive.cu) share: the dense array of the valid targets
// (dense_targets.cu writes it), the split of the work over a grid of
// (query tile, target split) blocks, and the ring of staged chunks. sm_90a.
//
// The dense array: the valid targets of a [T, 3] cloud in ascending index
// order, one float4 {x, y, z, w} each, w holding the target's original
// index as int bits, so a winner's index needs no second lookup. The slots
// from the count up to the next multiple of kChunk hold +inf coordinates
// (never NaN): their distance to any finite query is +inf, so they never
// win a minimum and always fail a radius test. The count stays on the
// device (stats[0]); the kernels read it there, the host never does.
//
// Work split: a block of kScanThreads = 128 threads owns a tile of
// kTile = 128 queries and one of n_splits contiguous ranges of the dense
// array's chunks (split_range, from the device count, so the work follows
// the valid targets, not the slots). Lane l of every warp holds the
// kPerLane = 4 queries l, l + 32, l + 64, l + 96 of the tile in registers,
// and warp w scans slice w (kScanSlice = 128 targets) of every chunk of the
// range: one 16-byte shared-memory load serves four pairs. The kernels
// merge the kScanWarps partial results of each query through shared memory
// and write one partial per (split, query); a second small kernel merges
// the splits in a fixed order. Every block adds the chunks it scanned to
// stats[1] (an integer atomic: the pairs evaluated are
// kTile * kChunk * stats[1]).
//
// Staging: a ring of kStages chunk buffers filled by 16-byte cp.async
// copies of the dense array, kStages - 1 chunks in flight while the block
// scans the current one, one barrier per chunk.

#pragma once

#include "chunk_ops.cuh"

namespace dlo {

constexpr int kTile = 128;                          // queries per block
constexpr int kScanWarps = 4;                       // warps per block, one chunk slice each
constexpr int kScanThreads = 32 * kScanWarps;       // 128
constexpr int kPerLane = kTile / 32;                // queries per thread
constexpr int kScanSlice = kChunk / kScanWarps;     // targets per warp per chunk
constexpr int kStages = 3;                          // staged chunks per block
constexpr int kCopiesPerThread = kChunk / kScanThreads;
static_assert(kTile % 32 == 0 && kChunk % kScanThreads == 0, "whole warps, whole copies");

// Write the dense array of the valid targets (capacity: T rounded up to
// kChunk float4), stats[0] = their count and stats[1] = 0, on `stream`.
// Defined in dense_targets.cu.
cudaError_t compact_targets(const float* targets, const uint8_t* tmask, int n_targets,
                            float4* dense, int32_t* stats, cudaStream_t stream);

// The chunks [begin, end) of the dense array that split `split` of
// `n_splits` scans, given the valid count.
__device__ __forceinline__ void split_range(int n_valid, int split, int n_splits, int& begin,
                                            int& end) {
  const long long n_chunks = (n_valid + kChunk - 1) / kChunk;
  begin = static_cast<int>(n_chunks * split / n_splits);
  end = static_cast<int>(n_chunks * (split + 1) / n_splits);
}

// Start this thread's copies of dense chunk c into buf, as one group
// (c < 0: an empty group, so the groups in flight stay kStages - 1).
__device__ __forceinline__ void ring_start(float4* buf, const float4* __restrict__ dense, int c) {
  if (c >= 0) {
    const float4* src = dense + static_cast<size_t>(c) * kChunk;
#pragma unroll
    for (int j = 0; j < kCopiesPerThread; ++j) {
      const int i = threadIdx.x + j * kScanThreads;
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(buf + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src + i)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until this thread's oldest group in flight has landed; the
// __syncthreads that follows publishes the chunk and frees the buffer the
// block scanned before it.
__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

}  // namespace dlo
