// Fixed-radius 1-NN over a Morton-sorted target cloud, by sub-tiles that
// pick their own candidate chunks: kernels K2 (exact distance) and K4 (the
// distance expansion), one body templated on kExpansion. sm_90a.
//
// Replaces the TPU kernels direct_lidar_odometry_tpu/ops/pallas_nn.py:
// _nn1_pruned_kernel (K2; body _pruned_kernel_body with mxu=False), the
// correspondence search of every GICP iteration on the "pallas" backend and
// of the loop-edge GICP, and _nn1_pruned_kernel_mxu (K4; mxu=True), the
// search of the "pallas_mxu" backend.
//
// What it computes: for each valid query q, the index of the nearest valid
// target t with d2(q, t) < r^2, d2 = (dx*dx + dy*dy) + dz*dz rounded as
// written with dx = qx - tx, ties to the lower target index; -1 and +inf
// where there is none (and for invalid queries). The wrapper passes the
// target's [3, C] chunk AABBs; the kernel selects each sub-tile's candidate
// chunks itself (subtile_search.cuh).
//
// What bounds it on the H100: FP32 issue on the distance loop, about 14
// instructions per pair (a 16-byte shared broadcast, 3 subtractions, 3
// products, 2 additions, a compare and two selects); the bytes are small
// (the clouds once, each chunk a 6 KB read from L2 per visiting sub-tile).
// Only a third of a scan's 32768 slots hold a valid point (invalid ones
// sort last), so one block of 128 threads per 128-query tile, each thread
// walking all 512 targets of every candidate chunk alone, would leave ~85
// live blocks of 4 warps on 132 SMs with up to 15 x 512 dependent
// iterations a thread. Instead a block of 256 threads owns 32 queries and
// each warp scans a 64-target slice of every candidate chunk: ~330 live
// blocks of 8 warps, the longest thread walking 64 targets per candidate,
// and the next chunk's copy overlapping the compute. Each thread
// keeps a strict-< minimum over its slices in ascending target order (so
// the first of equal d2 wins), and the block merges its 8 partial minima of
// each query as packed 64-bit keys (float bits of d2 << 32 | index): d2 >= 0
// orders as unsigned, equal d2 fall to the lower index, so the merge is
// exact and independent of order. The bound starts at r^2 (0 for invalid
// queries), so a d2 equal to r^2 is never found. The TPU kernel's gap-sorted
// branch-and-bound exit is dropped: it skipped ~2 % of the candidate chunks
// at the per-frame shapes and changes no result. No tensor cores: TF32's
// error at 30-60 m coordinates is metres^2, and the neighbours are exact.
//
// K4 (kExpansion) is the same search on d2 = max((|q|^2 + |t|^2) - 2 q.t, 0)
// with q.t = (qx*tx + qy*ty) + qz*tz and |.|^2 in the same order, every
// step rounded as written (nvcc would contract it into FMAs), the order of
// its plain version ops/cuda_nn.py nn1_mxu_plain. The TPU kernel ran the
// cross term on its matrix unit; here it is three fp32 products on the CUDA
// cores. |t|^2 is computed in staging into the w lane of the staged float4;
// invalid targets are staged as {0, 0, 0, +inf}, so their d2 is +inf (the
// plain version folds them to the finite pad 1e6 instead: neither reports
// a winner there, so the outputs are equal). Its selection adds the
// expansion's rounding slack to r^2 (subtile_search.cuh), so K4 finds what
// the exhaustive plain version finds, bit for bit; the winner may differ
// from K2's among near-ties, which the public entry tolerates by
// recomputing the winner's exact d2. About 14 instructions per pair, as K2.

#include "subtile_search.cuh"

namespace {

using namespace dlo;

template <bool kExpansion>
__global__ void __launch_bounds__(kThreads) nn1_pruned_kernel(
    const float* __restrict__ queries,    // [B, Q, 3]
    const uint8_t* __restrict__ qmask,    // [B, Q]
    const float* __restrict__ targets,    // [B, T, 3], T = 512 C
    const uint8_t* __restrict__ tmask,    // [B, T]
    const float* __restrict__ chunk_lo,   // [B, 3, C] masked chunk AABBs
    const float* __restrict__ chunk_hi,   // [B, 3, C]
    int n_chunks, float radius2,
    int32_t* __restrict__ out_idx,        // [B, Q]
    float* __restrict__ out_d2,           // [B, Q]
    int32_t* __restrict__ visits) {       // [B, Q / 32] candidate chunks, or null
  __shared__ float4 s_buf[2][kChunk];
  __shared__ uint32_t s_bits[kBitWords];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane_subtile();
  const int q = sub * kSub + lane;                 // among every lane's queries
  const int chunk0 = blockIdx.y * n_chunks;        // the lane's first target chunk
  const float qx = queries[3 * q + 0];
  const float qy = queries[3 * q + 1];
  const float qz = queries[3 * q + 2];
  const bool valid = qmask[q] != 0;
  const float q2 = kExpansion ? dist2_rn(qx, qy, qz) : 0.0f;

  float lo[3], hi[3];
  if (!subtile_aabb(qx, qy, qz, valid, lo, hi)) {  // the same in every warp
    if (warp == 0) {
      out_idx[q] = -1;
      out_d2[q] = INFINITY;
    }
    if (visits != nullptr && threadIdx.x == 0) visits[sub] = 0;
    return;
  }
  select_candidates<kExpansion>(lo, hi, chunk_lo + 3 * chunk0, chunk_hi + 3 * chunk0, n_chunks,
                                radius2, s_bits);
  __syncthreads();
  const int n_words = (n_chunks + 31) >> 5;
  if (visits != nullptr && threadIdx.x == 0) visits[sub] = count_candidates(s_bits, n_words);

  float best = valid ? radius2 : 0.0f;
  int best_idx = -1;
  int c = next_candidate(s_bits, n_words, 0);
  bool ok0 = false, ok1 = false;
  if (c >= 0) stage_issue(s_buf[0], targets, tmask, chunk0 + c, ok0, ok1);
  // The inner loop is spelled out in the kernel body: built from helper
  // functions, an earlier K2 ran 25-45 % slower with the same instructions.
  for (int k = 0; c >= 0; ++k) {
    float4* buf = s_buf[k & 1];
    stage_finish<kExpansion>(buf, ok0, ok1);
    __syncthreads();  // chunk c has landed; every warp is done with the other buffer
    const int next = next_candidate(s_bits, n_words, c + 1);
    if (next >= 0) stage_issue(s_buf[(k + 1) & 1], targets, tmask, chunk0 + next, ok0, ok1);
    const float4* sp = buf + warp * kSlice;
    const int base = c * kChunk + warp * kSlice;
#pragma unroll 8
    for (int i = 0; i < kSlice; ++i) {
      const float4 t = sp[i];
      float d2;
      if constexpr (kExpansion) {
        const float g = __fadd_rn(__fadd_rn(__fmul_rn(qx, t.x), __fmul_rn(qy, t.y)),
                                  __fmul_rn(qz, t.z));
        d2 = fmaxf(__fsub_rn(__fadd_rn(q2, t.w), __fmul_rn(2.0f, g)), 0.0f);
      } else {
        d2 = dist2_rn(qx - t.x, qy - t.y, qz - t.z);
      }
      if (d2 < best) {
        best = d2;
        best_idx = base + i;
      }
    }
    c = next;
  }

  __syncthreads();  // every warp is done reading the chunks: reuse the buffer
  auto* s_key = reinterpret_cast<unsigned long long*>(&s_buf[0][0]);  // [kWarps][kSub]
  s_key[threadIdx.x] = (static_cast<unsigned long long>(__float_as_uint(best)) << 32) |
                       static_cast<uint32_t>(best_idx);
  __syncthreads();
  if (warp == 0) {
    unsigned long long key = s_key[lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const unsigned long long other = s_key[w * kSub + lane];
      key = other < key ? other : key;
    }
    const uint32_t idx = static_cast<uint32_t>(key);
    const bool found = idx != 0xffffffffu;
    out_idx[q] = found ? static_cast<int32_t>(idx) : -1;
    out_d2[q] = found ? __uint_as_float(static_cast<uint32_t>(key >> 32)) : INFINITY;
  }
}

template <bool kExpansion>
int launch(const void* queries, const void* qmask, const void* targets, const void* tmask,
           const void* chunk_lo, const void* chunk_hi, int n_queries, int n_chunks,
           int n_lanes, float radius2, void* out_idx, void* out_d2, void* visits, void* stream) {
  if (!lanes_fit(n_queries, n_chunks, n_lanes)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_queries > 0 && n_lanes > 0) {
    nn1_pruned_kernel<kExpansion>
        <<<dim3(n_queries / kSub, n_lanes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(queries), static_cast<const uint8_t*>(qmask),
            static_cast<const float*>(targets), static_cast<const uint8_t*>(tmask),
            static_cast<const float*>(chunk_lo), static_cast<const float*>(chunk_hi),
            n_chunks, radius2, static_cast<int32_t*>(out_idx), static_cast<float*>(out_d2),
            static_cast<int32_t*>(visits));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dlo_nn1_pruned(
    const void* queries, const void* qmask, const void* targets, const void* tmask,
    const void* chunk_lo, const void* chunk_hi, int n_queries, int n_chunks, int n_lanes,
    float radius2, void* out_idx, void* out_d2, void* visits, void* stream) {
  return launch<false>(queries, qmask, targets, tmask, chunk_lo, chunk_hi, n_queries, n_chunks,
                       n_lanes, radius2, out_idx, out_d2, visits, stream);
}

extern "C" int dlo_nn1_pruned_mxu(
    const void* queries, const void* qmask, const void* targets, const void* tmask,
    const void* chunk_lo, const void* chunk_hi, int n_queries, int n_chunks, int n_lanes,
    float radius2, void* out_idx, void* out_d2, void* visits, void* stream) {
  return launch<true>(queries, qmask, targets, tmask, chunk_lo, chunk_hi, n_queries, n_chunks,
                      n_lanes, radius2, out_idx, out_d2, visits, stream);
}
