// The sub-tile search shared by the pruned kernels K1 (cov_pruned.cu), K2
// and K4 (nn1_pruned.cu) and K3 (fused_linearize.cu): candidate selection
// inside the kernel and staging of the candidate chunks. sm_90a.
//
// Work split: a block owns one sub-tile of kSub = 32 consecutive queries
// (lane i of every warp holds query i) and runs kWarps = 8 warps. Every
// candidate chunk of 512 targets is cut into kWarps slices of kSlice = 64,
// one per warp, so a heavy sub-tile's work spreads over 256 threads, each
// walking 64 targets per chunk instead of one thread walking all 512. The
// kernels merge the kWarps partial results of each query at the end.
//
// Selection (the plain PyTorch version is ops/cuda_nn.py
// subtile_candidates): every warp reduces the sub-tile's AABB over its
// valid queries with shuffles, so each warp holds the same box without a
// barrier; the warps split the target's chunk AABBs into groups of 32, one
// lane per chunk, and a chunk is a candidate iff its squared gap to the box,
// (gx*gx + gy*gy) + gz*gz with gx = max(clo - qhi, qlo - chi, 0) rounded
// as written, is <= the bound (r^2; K3 passes a lower one where seeds allow
// it). The candidates are kept as a bitmap in shared
// memory (one __ballot_sync word per 32 chunks, C <= kMaxChunks) and walked
// in ascending chunk index. Rounding is monotone, so the gap^2 of a chunk
// is never above the rounded d^2 of any valid query of the sub-tile and any
// valid target of the chunk: no target within r is ever missed.
//
// K4's distance expansion can read a pair up to ~8u (|q|^2 + |t|^2 + r^2)
// below its rounded d^2 (u = 2^-24), so its selection (kExpansion) adds
// (|q|max^2 + |t|max^2 + r^2) * 2^-19 to r^2, with the maxima over the box
// corners (ops/cuda_nn.py expansion_candidates): every target whose
// expansion d2 is < r^2 then lies in a candidate chunk, and K4 finds what
// its exhaustive plain version finds.
//
// Staging: the copy of the next candidate chunk is in flight (cp.async,
// 4-byte pieces into one float4 per target, so the inner loops read one
// 16-byte broadcast per pair) while the block computes on the current one.
// Each thread copies two targets and, once its copies have landed, writes
// +inf over the invalid ones among them; the barrier that follows publishes
// the chunk. An invalid target's distance to any finite query is then +inf:
// it never wins a minimum and always fails a radius test. With kExpansion
// the thread writes |t|^2 into the w lane of its valid targets and
// {0, 0, 0, +inf} over the invalid ones, so the expansion reads +inf there
// (the +inf coordinates of K2 would give inf - inf = NaN).
//
// Lanes: every kernel here runs on a grid of (Q / 32 sub-tiles, B lanes).
// blockIdx.y is the lane, an independent cloud pair whose arrays lie at the
// lane's stride in [B, ...] arrays. K2-K4 number queries and sub-tiles
// over every lane (lane_subtile) and pass the selection the lane's own
// chunk AABBs and the staging the lane's first chunk (lane * C + c),
// leaving their pointer parameters as they are (moved to the lane, the
// pointers took K2 from 32 to 40 registers); K1 moves its pointers, which
// measured faster for it (cov_pruned.cu).

#pragma once

#include "chunk_ops.cuh"

namespace dlo {

constexpr int kSub = 32;                 // queries per block, one per lane
constexpr int kWarps = 8;                // warps per block, one chunk slice each
constexpr int kThreads = kSub * kWarps;  // 256
constexpr int kSlice = kChunk / kWarps;  // targets per warp per chunk
constexpr int kMaxChunks = 1024;         // bitmap capacity: T <= 524288
constexpr int kBitWords = kMaxChunks / 32;
constexpr int kMaxLanes = 65535;         // the grid's second dimension

// This block's sub-tile among every lane's: its queries are
// lane_subtile() * kSub + (0..31).
__device__ __forceinline__ int lane_subtile() { return blockIdx.y * gridDim.x + blockIdx.x; }

// A launch's grid: Q / 32 sub-tiles of n_lanes lanes, within the grid's
// limits and with every query index times 8 inside an int.
inline bool lanes_fit(int n_queries, int n_chunks, int n_lanes) {
  return n_queries % kSub == 0 && n_chunks <= kMaxChunks && n_lanes >= 0 &&
         n_lanes <= kMaxLanes &&
         static_cast<long long>(n_queries) * n_lanes <= 0x7fffffffLL / 8;
}
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kExpansionSlack = 1.0f / (1 << 19);  // K4's selection slack, see above
static_assert(kSub == 32, "a sub-tile is one warp's lanes");
static_assert(kChunk == 2 * kThreads, "each thread stages two targets of a chunk");

// Masked AABB of the warp's 32 queries, the same in every lane; false when
// no query of the sub-tile is valid (then the box is empty: +inf, -inf).
__device__ __forceinline__ bool subtile_aabb(float qx, float qy, float qz, bool valid,
                                             float* lo, float* hi) {
  lo[0] = valid ? qx : INFINITY;
  lo[1] = valid ? qy : INFINITY;
  lo[2] = valid ? qz : INFINITY;
  hi[0] = valid ? qx : -INFINITY;
  hi[1] = valid ? qy : -INFINITY;
  hi[2] = valid ? qz : -INFINITY;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(kFullMask, lo[a], o));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFullMask, hi[a], o));
    }
  }
  return __any_sync(kFullMask, valid);
}

// |p|^2 of the box corner farthest from the origin, (x*x + y*y) + z*z
// rounded as written: no point of the box [lo, hi] has a larger |p|^2.
__device__ __forceinline__ float corner_norm2(float lo0, float lo1, float lo2, float hi0,
                                              float hi1, float hi2) {
  return dist2_rn(fmaxf(fabsf(lo0), fabsf(hi0)), fmaxf(fabsf(lo1), fabsf(hi1)),
                  fmaxf(fabsf(lo2), fabsf(hi2)));
}

// Candidate bitmap of the sub-tile box [lo, hi] against the [3, C] chunk
// AABBs: bit c of bits[c / 32] is set iff gap^2 <= bound2 (with
// kExpansion: iff gap^2 is finite and <= bound2 plus the slack above).
// Writes the words [0, ceil(C / 32)); the caller's barrier publishes them.
template <bool kExpansion = false>
__device__ __forceinline__ void select_candidates(const float* lo, const float* hi,
                                                  const float* __restrict__ chunk_lo,
                                                  const float* __restrict__ chunk_hi,
                                                  int n_chunks, float bound2, uint32_t* bits) {
  const int lane = threadIdx.x & 31;
  const int n_words = (n_chunks + 31) >> 5;
  float q_norm2 = 0.0f;
  if constexpr (kExpansion) q_norm2 = corner_norm2(lo[0], lo[1], lo[2], hi[0], hi[1], hi[2]);
  for (int w = threadIdx.x >> 5; w < n_words; w += kWarps) {
    const int c = (w << 5) + lane;
    bool cand = false;
    if (c < n_chunks) {
      float g[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float below = __fsub_rn(chunk_lo[a * n_chunks + c], hi[a]);
        const float above = __fsub_rn(lo[a], chunk_hi[a * n_chunks + c]);
        g[a] = fmaxf(fmaxf(below, above), 0.0f);
      }
      const float gap2 = dist2_rn(g[0], g[1], g[2]);
      if constexpr (kExpansion) {
        const float t_norm2 = corner_norm2(chunk_lo[c], chunk_lo[n_chunks + c],
                                           chunk_lo[2 * n_chunks + c], chunk_hi[c],
                                           chunk_hi[n_chunks + c], chunk_hi[2 * n_chunks + c]);
        const float slack =
            __fmul_rn(__fadd_rn(__fadd_rn(q_norm2, t_norm2), bound2), kExpansionSlack);
        // an empty chunk's box (+inf, -inf) gives gap^2 = slack = +inf
        cand = gap2 < INFINITY && gap2 <= __fadd_rn(bound2, slack);
      } else {
        cand = gap2 <= bound2;
      }
    }
    const uint32_t word = __ballot_sync(kFullMask, cand);
    if (lane == 0) bits[w] = word;
  }
}

// The smallest candidate chunk index >= from, or -1.
__device__ __forceinline__ int next_candidate(const uint32_t* bits, int n_words, int from) {
  int w = from >> 5;
  if (w >= n_words) return -1;
  uint32_t word = bits[w] & (kFullMask << (from & 31));
  while (word == 0) {
    if (++w >= n_words) return -1;
    word = bits[w];
  }
  return (w << 5) + __ffs(word) - 1;
}

__device__ __forceinline__ int count_candidates(const uint32_t* bits, int n_words) {
  int n = 0;
  for (int w = 0; w < n_words; ++w) n += __popc(bits[w]);
  return n;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// Start copying this thread's two targets (t and t + kThreads) of chunk c
// into buf; their mask bits come back in ok0/ok1 for stage_finish.
__device__ __forceinline__ void stage_issue(float4* buf, const float* __restrict__ targets,
                                            const uint8_t* __restrict__ tmask, int c,
                                            bool& ok0, bool& ok1) {
  const int t = threadIdx.x;
  const size_t g0 = static_cast<size_t>(c) * kChunk + t;
  const size_t g1 = g0 + kThreads;
  cp_async4(&buf[t].x, targets + 3 * g0 + 0);
  cp_async4(&buf[t].y, targets + 3 * g0 + 1);
  cp_async4(&buf[t].z, targets + 3 * g0 + 2);
  cp_async4(&buf[t + kThreads].x, targets + 3 * g1 + 0);
  cp_async4(&buf[t + kThreads].y, targets + 3 * g1 + 1);
  cp_async4(&buf[t + kThreads].z, targets + 3 * g1 + 2);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  ok0 = tmask[g0] != 0;
  ok1 = tmask[g1] != 0;
}

// Wait for this thread's copies and put its invalid targets at +inf (with
// kExpansion: |t|^2 into w, {0, 0, 0, +inf} for invalid targets); a
// __syncthreads after this makes the whole chunk visible.
template <bool kExpansion = false>
__device__ __forceinline__ void stage_finish(float4* buf, bool ok0, bool ok1) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if constexpr (kExpansion) {
    const float4 far = make_float4(0.0f, 0.0f, 0.0f, INFINITY);
    float4& t0 = buf[threadIdx.x];
    float4& t1 = buf[threadIdx.x + kThreads];
    t0.w = dist2_rn(t0.x, t0.y, t0.z);
    t1.w = dist2_rn(t1.x, t1.y, t1.z);
    if (!ok0) t0 = far;
    if (!ok1) t1 = far;
  } else {
    const float4 far = make_float4(INFINITY, INFINITY, INFINITY, 0.0f);
    if (!ok0) buf[threadIdx.x] = far;
    if (!ok1) buf[threadIdx.x + kThreads] = far;
  }
}

}  // namespace dlo
