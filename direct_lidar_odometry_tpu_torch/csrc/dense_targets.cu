// The pre-pass of the exhaustive kernels K5 and K6: compact the valid
// targets of a [T, 3] cloud into the dense float4 array of
// dense_targets.cuh, in ascending index order, with their count on the
// device. sm_90a.
//
// One launch of ceil(T / 1024) blocks of 1024 threads, one target a thread.
// A block needs the number of valid targets before its span to know where
// it writes; it counts them itself from the mask bytes [0, base), 16 at a
// load (at most T bytes, from L2), instead of waiting for the blocks before
// it: no second launch, no spinning on another block. Inside the span the
// position comes from __ballot_sync / __popc per warp and a sum of the
// warps' counts through shared memory, so the order is the index order.
// The last block also writes the count, zeroes the chunk counter and pads
// the tail of the last chunk with +inf.

#include "dense_targets.cuh"

namespace {

using namespace dlo;

constexpr int kCompactThreads = 1024;
constexpr int kCompactWarps = kCompactThreads / 32;

// This thread's share of the non-zero bytes of m[0, n): whole 16-byte words
// where m is aligned, single bytes at the ragged ends.
__device__ __forceinline__ int count_nonzero(const uint8_t* __restrict__ m, int n) {
  const int head = min(n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(m) & 15)) & 15));
  const int n_words = (n - head) / 16;
  const uint4* words = reinterpret_cast<const uint4*>(m + head);
  int cnt = 0;
  for (int i = threadIdx.x; i < head; i += kCompactThreads) cnt += m[i] != 0;
  for (int i = threadIdx.x; i < n_words; i += kCompactThreads) {
    const uint4 w = words[i];
    // __vcmpne4 gives 0xff per non-zero byte
    cnt += (__popc(__vcmpne4(w.x, 0)) + __popc(__vcmpne4(w.y, 0)) +
            __popc(__vcmpne4(w.z, 0)) + __popc(__vcmpne4(w.w, 0))) >> 3;
  }
  for (int i = head + 16 * n_words + threadIdx.x; i < n; i += kCompactThreads) cnt += m[i] != 0;
  return cnt;
}

__global__ void __launch_bounds__(kCompactThreads) compact_targets_kernel(
    const float* __restrict__ targets,  // [T, 3]
    const uint8_t* __restrict__ tmask,  // [T]
    int n_targets,
    float4* __restrict__ dense,         // [T rounded up to kChunk]
    int32_t* __restrict__ stats) {      // [2]: valid count, chunks scanned
  __shared__ int s_before[kCompactWarps];
  __shared__ int s_own[kCompactWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kCompactThreads;
  const int g = base + threadIdx.x;

  int before = count_nonzero(tmask, base);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(0xffffffffu, before, o);
  const bool ok = g < n_targets && tmask[g] != 0;
  const uint32_t word = __ballot_sync(0xffffffffu, ok);
  if (lane == 0) {
    s_before[warp] = before;
    s_own[warp] = __popc(word);
  }
  __syncthreads();
  int pos = 0, block_total = 0;
#pragma unroll
  for (int w = 0; w < kCompactWarps; ++w) {
    pos += s_before[w] + (w < warp ? s_own[w] : 0);
    block_total += s_before[w] + s_own[w];
  }
  if (ok) {
    pos += __popc(word & ((1u << lane) - 1u));
    dense[pos] = make_float4(targets[3 * static_cast<size_t>(g) + 0],
                             targets[3 * static_cast<size_t>(g) + 1],
                             targets[3 * static_cast<size_t>(g) + 2], __int_as_float(g));
  }
  if (blockIdx.x == gridDim.x - 1) {
    const int padded = (block_total + kChunk - 1) / kChunk * kChunk;
    for (int i = block_total + threadIdx.x; i < padded; i += kCompactThreads) {
      dense[i] = make_float4(INFINITY, INFINITY, INFINITY, __int_as_float(-1));
    }
    if (threadIdx.x == 0) {
      stats[0] = block_total;
      stats[1] = 0;
    }
  }
}

}  // namespace

namespace dlo {

cudaError_t compact_targets(const float* targets, const uint8_t* tmask, int n_targets,
                            float4* dense, int32_t* stats, cudaStream_t stream) {
  // T = 0 still runs one block, which writes the zero count
  const int n_blocks = n_targets > 0 ? (n_targets + kCompactThreads - 1) / kCompactThreads : 1;
  compact_targets_kernel<<<n_blocks, kCompactThreads, 0, stream>>>(targets, tmask, n_targets,
                                                                  dense, stats);
  return cudaGetLastError();
}

}  // namespace dlo
