// Exhaustive fixed-radius neighbourhood moments (kernel K6). sm_90a.
//
// Replaces the TPU kernel direct_lidar_odometry_tpu/ops/pallas_cov.py:
// _cov_kernel, behind radius_moments and estimate_normals_radius.
//
// What it computes: for EVERY query q (there is no query mask), the 10
// moments (n, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz) of the offsets
// d = t - q over the valid targets with |d|^2 <= r^2 (inclusive), the
// radius test rounded as the plain version rounds it, so the neighbour
// sets agree exactly with it.
//
// What bounds it on the H100: the FP32 instruction rate. Per pair three
// subtractions, three products and two additions, none fused, and the
// compare (9 instruction slots), 16 more inside the radius, over
// Q x (valid targets) pairs.
// Design (dense_targets.cuh), as K5 (nn1_exhaustive.cu): the pre-pass
// compacts the valid targets into a dense float4 array; the scan runs a
// grid of (query tile, target split) blocks, a thread holding the 10 sums
// of each of its four queries in registers, one 16-byte shared-memory load
// serving four pairs, the next chunks' cp.async copies in flight. A thread
// branches once per target, on whether any of its four pairs is inside the
// radius (few are): one branch per pair cost 15 % more on the card. The
// block adds its four warps' partial sums in a fixed tree through shared
// memory and writes one partial row per (split, query); a small kernel then
// adds the splits in ascending order. No float atomics: two launches on the
// same inputs give the same bits. The sums are taken in another order than
// the plain version's, which moves them by float rounding only.

#include "dense_targets.cuh"

namespace {

using namespace dlo;

constexpr int kMoments = 10;
static_assert(kScanWarps == 4, "the merge below is a fixed tree over 4 warps");
static_assert(kScanWarps * kMoments * kTile * sizeof(float) <= kStages * kChunk * sizeof(float4),
              "the merge reuses the staging buffers");

__global__ void __launch_bounds__(kScanThreads) cov_exhaustive_kernel(
    const float* __restrict__ queries,  // [Q, 3]
    const float4* __restrict__ dense,   // the valid targets, dense_targets.cuh
    int32_t* __restrict__ stats,        // [2]: valid count, chunks scanned
    int n_queries, float radius2,
    float* __restrict__ part) {         // [n_splits, Q, 10]
  __shared__ float4 s_buf[kStages][kChunk];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kTile;
  float qx[kPerLane], qy[kPerLane], qz[kPerLane];
  float acc[kPerLane][kMoments];
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int q = q0 + lane + 32 * r;
    qx[r] = queries[3 * q + 0];
    qy[r] = queries[3 * q + 1];
    qz[r] = queries[3 * q + 2];
#pragma unroll
    for (int s = 0; s < kMoments; ++s) acc[r][s] = 0.0f;
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
#pragma unroll 4
    for (int i = 0; i < kScanSlice; ++i) {
      const float4 t = sp[i];
      float dx[kPerLane], dy[kPerLane], dz[kPerLane];
      bool in[kPerLane];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        dx[r] = t.x - qx[r];
        dy[r] = t.y - qy[r];
        dz[r] = t.z - qz[r];
        in[r] = dist2_rn(dx[r], dy[r], dz[r]) <= radius2;
        any |= in[r];
      }
      // sums are touched only inside the test: 0 * inf would poison them
      if (any) {
#pragma unroll
        for (int r = 0; r < kPerLane; ++r) {
          if (in[r]) {
            acc[r][0] += 1.f;
            acc[r][1] += dx[r]; acc[r][2] += dy[r]; acc[r][3] += dz[r];
            acc[r][4] += dx[r] * dx[r]; acc[r][5] += dx[r] * dy[r]; acc[r][6] += dx[r] * dz[r];
            acc[r][7] += dy[r] * dy[r]; acc[r][8] += dy[r] * dz[r]; acc[r][9] += dz[r] * dz[r];
          }
        }
      }
    }
  }

  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // every warp is done reading the chunks: reuse the buffers
  float* s_acc = reinterpret_cast<float*>(&s_buf[0][0]);  // [kScanWarps][kMoments][kTile]
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
#pragma unroll
    for (int s = 0; s < kMoments; ++s) {
      s_acc[(warp * kMoments + s) * kTile + lane + 32 * r] = acc[r][s];
    }
  }
  __syncthreads();
  constexpr int kStride = kMoments * kTile;  // one warp's block of partial sums
  float* o = part + (static_cast<size_t>(blockIdx.y) * n_queries + q0) * kMoments;
  for (int e = threadIdx.x; e < kTile * kMoments; e += kScanThreads) {
    const int ql = e / kMoments;
    const float* v = s_acc + (e - ql * kMoments) * kTile + ql;
    o[e] = (v[0] + v[kStride]) + (v[2 * kStride] + v[3 * kStride]);
  }
}

// out[e] = the sum over the splits of part[s][e], in ascending s.
__global__ void cov_merge_kernel(const float* __restrict__ part, size_t n_values, int n_splits,
                                 float* __restrict__ out) {  // [Q, 10]
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_values) return;
  float sum = part[e];
  for (int s = 1; s < n_splits; ++s) sum += part[s * n_values + e];
  out[e] = sum;
}

}  // namespace

extern "C" int dlo_cov_exhaustive(const void* queries, const void* targets, const void* tmask,
                                  int n_queries, int n_targets, int n_splits, float radius2,
                                  void* dense, void* stats, void* part, void* out,
                                  void* stream) {
  if (n_queries % kTile != 0 || n_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      compact_targets(static_cast<const float*>(targets), static_cast<const uint8_t*>(tmask),
                      n_targets, static_cast<float4*>(dense), static_cast<int32_t*>(stats), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_queries > 0) {
    const size_t n_values = static_cast<size_t>(n_queries) * kMoments;
    cov_exhaustive_kernel<<<dim3(n_queries / kTile, n_splits), kScanThreads, 0, st>>>(
        static_cast<const float*>(queries), static_cast<const float4*>(dense),
        static_cast<int32_t*>(stats), n_queries, radius2, static_cast<float*>(part));
    cov_merge_kernel<<<static_cast<unsigned>((n_values + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(part), n_values, n_splits, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
