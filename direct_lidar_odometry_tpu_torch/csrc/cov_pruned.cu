// Fixed-radius neighbourhood moments over a Morton-sorted cloud, by
// sub-tiles that pick their own candidate chunks: kernel K1. sm_90a.
//
// Replaces the TPU kernel direct_lidar_odometry_tpu/ops/pallas_cov.py:
// _cov_pruned_kernel, which feeds the normals of every scan and every
// spawned keyframe.
//
// What it computes: for each valid query q, the 10 query-relative moments
// (n, sum d, sum d d^T with d = t - q, as n, sx, sy, sz, sxx, sxy, sxz,
// syy, syz, szz) over the valid targets with |d|^2 <= r^2, the radius test
// rounded as the plain version rounds it, so the neighbour sets agree
// exactly with it. Rows of invalid queries are zero. Offsets stay
// query-relative (bounded by r), which keeps the covariance well
// conditioned at map-scale coordinates. The wrapper passes the cloud's
// [3, C] chunk AABBs; the kernel selects each sub-tile's candidate chunks
// itself (subtile_search.cuh) and visits all of them.
//
// What bounds it on the H100: FP32 issue on the pair loop (about 14
// instructions per pair for the distance and the test, 16 more per pair
// inside the radius); each visited chunk is a 6 KB read, mostly from L2.
// Design: as K2 (nn1_pruned.cu), a block of 256 threads owns 32 queries
// and each warp scans a 64-target slice of every candidate chunk, with the
// next chunk's copy in flight; each thread holds its query's 10 sums over
// its slices in registers. The block then adds the 8 partial sums of each
// moment in a fixed tree through shared memory, with no atomics, so two
// launches on the same inputs give the same bits. The sums are taken in
// another order than the plain version's, which moves them by float
// rounding only.
//
// Lanes (the TPU kernel's batched entry _pruned_moments_batched, grid
// (b_total, qc)): the grid is (Q / 32, B), blockIdx.y the lane, each lane
// an independent cloud at its stride in [B, ...] arrays; a lane's blocks do
// what a launch of that lane alone does, so they give the same bits. Unlike
// K2-K4 (subtile_search.cuh), this kernel moves its pointers to the lane
// first: indexed over every lane as they are, it ran 14-19 % slower on the
// H100 (kernel_ab.py, with 32 registers against 40), this way as fast as
// before the lanes.

#include "subtile_search.cuh"

namespace {

using namespace dlo;

constexpr int kMoments = 10;
static_assert(kWarps == 8, "the merge below is a fixed tree over 8 warps");
static_assert(kWarps * kMoments * kSub * sizeof(float) <= 2 * kChunk * sizeof(float4),
              "the merge reuses the staging buffers");

__global__ void __launch_bounds__(kThreads) cov_pruned_kernel(
    const float* __restrict__ queries,    // [B, Q, 3]
    const uint8_t* __restrict__ qmask,    // [B, Q]
    const float* __restrict__ targets,    // [B, T, 3], T = 512 C
    const uint8_t* __restrict__ tmask,    // [B, T]
    const float* __restrict__ chunk_lo,   // [B, 3, C] masked chunk AABBs
    const float* __restrict__ chunk_hi,   // [B, 3, C]
    int n_chunks, float radius2,
    float* __restrict__ out,              // [B, Q, 10]
    int32_t* __restrict__ visits) {       // [B, Q / 32] candidate chunks, or null
  __shared__ float4 s_buf[2][kChunk];
  __shared__ uint32_t s_bits[kBitWords];

  // this block's lane: every array at the lane's stride
  const size_t n_queries = static_cast<size_t>(gridDim.x) * kSub;
  const size_t n_targets = static_cast<size_t>(n_chunks) * kChunk;
  queries += blockIdx.y * n_queries * 3;
  qmask += blockIdx.y * n_queries;
  targets += blockIdx.y * n_targets * 3;
  tmask += blockIdx.y * n_targets;
  chunk_lo += blockIdx.y * 3 * static_cast<size_t>(n_chunks);
  chunk_hi += blockIdx.y * 3 * static_cast<size_t>(n_chunks);
  out += blockIdx.y * n_queries * kMoments;
  if (visits != nullptr) visits += blockIdx.y * static_cast<size_t>(gridDim.x);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kSub + lane;
  const float qx = queries[3 * q + 0];
  const float qy = queries[3 * q + 1];
  const float qz = queries[3 * q + 2];
  const bool valid = qmask[q] != 0;
  float* o = out + static_cast<size_t>(blockIdx.x) * kSub * kMoments;

  float lo[3], hi[3];
  if (!subtile_aabb(qx, qy, qz, valid, lo, hi)) {  // the same in every warp
    for (int s = threadIdx.x; s < kSub * kMoments; s += kThreads) o[s] = 0.0f;
    if (visits != nullptr && threadIdx.x == 0) visits[blockIdx.x] = 0;
    return;
  }
  select_candidates(lo, hi, chunk_lo, chunk_hi, n_chunks, radius2, s_bits);
  __syncthreads();
  const int n_words = (n_chunks + 31) >> 5;
  if (visits != nullptr && threadIdx.x == 0) visits[blockIdx.x] = count_candidates(s_bits, n_words);

  Moments acc = {};
  int c = next_candidate(s_bits, n_words, 0);
  bool ok0 = false, ok1 = false;
  if (c >= 0) stage_issue(s_buf[0], targets, tmask, c, ok0, ok1);
  for (int k = 0; c >= 0; ++k) {
    float4* buf = s_buf[k & 1];
    stage_finish(buf, ok0, ok1);
    __syncthreads();  // chunk c has landed; every warp is done with the other buffer
    const int next = next_candidate(s_bits, n_words, c + 1);
    if (next >= 0) stage_issue(s_buf[(k + 1) & 1], targets, tmask, next, ok0, ok1);
    const float4* sp = buf + warp * kSlice;
#pragma unroll 4
    for (int i = 0; i < kSlice; ++i) {
      const float4 t = sp[i];
      const float dx = t.x - qx;
      const float dy = t.y - qy;
      const float dz = t.z - qz;
      // sums are touched only inside the test: 0 * inf would poison them
      if (dist2_rn(dx, dy, dz) <= radius2) {
        acc.v[0] += 1.f;
        acc.v[1] += dx; acc.v[2] += dy; acc.v[3] += dz;
        acc.v[4] += dx * dx; acc.v[5] += dx * dy; acc.v[6] += dx * dz;
        acc.v[7] += dy * dy; acc.v[8] += dy * dz; acc.v[9] += dz * dz;
      }
    }
    c = next;
  }

  __syncthreads();  // every warp is done reading the chunks: reuse the buffer
  float* s_acc = reinterpret_cast<float*>(&s_buf[0][0]);  // [kWarps][kMoments][kSub]
#pragma unroll
  for (int s = 0; s < kMoments; ++s) s_acc[(warp * kMoments + s) * kSub + lane] = acc.v[s];
  __syncthreads();
  constexpr int kStride = kMoments * kSub;  // one warp's block of partial sums
  for (int e = threadIdx.x; e < kSub * kMoments; e += kThreads) {
    const int ql = e / kMoments;
    const float* v = s_acc + (e - ql * kMoments) * kSub + ql;
    const float sum = ((v[0] + v[kStride]) + (v[2 * kStride] + v[3 * kStride])) +
                      ((v[4 * kStride] + v[5 * kStride]) + (v[6 * kStride] + v[7 * kStride]));
    o[e] = qmask[blockIdx.x * kSub + ql] ? sum : 0.0f;
  }
}

}  // namespace

extern "C" int dlo_cov_pruned(
    const void* queries, const void* qmask, const void* targets, const void* tmask,
    const void* chunk_lo, const void* chunk_hi, int n_queries, int n_chunks, int n_lanes,
    float radius2, void* out, void* visits, void* stream) {
  if (!lanes_fit(n_queries, n_chunks, n_lanes)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_queries > 0 && n_lanes > 0) {
    cov_pruned_kernel<<<dim3(n_queries / kSub, n_lanes), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(queries), static_cast<const uint8_t*>(qmask),
        static_cast<const float*>(targets), static_cast<const uint8_t*>(tmask),
        static_cast<const float*>(chunk_lo), static_cast<const float*>(chunk_hi),
        n_chunks, radius2, static_cast<float*>(out), static_cast<int32_t*>(visits));
  }
  return static_cast<int>(cudaGetLastError());
}
