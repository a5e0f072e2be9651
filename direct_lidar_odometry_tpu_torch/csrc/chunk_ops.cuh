// Device functions shared by the port's kernels: the rounded distance (all
// six), staging a 512-point target chunk in shared memory (K5, K6) and the
// radius-moment update (K6). The pruned kernels (K1-K4) spell their inner
// loops out in the kernel body: built from helper functions, an earlier K2
// ran 25-45 % slower on the H100; they share their candidate selection and
// staging (subtile_search.cuh). sm_90a.
//
// Every distance is spelled with __fmul_rn/__fadd_rn in the order
// ((dx*dx + dy*dy) + dz*dz), the order the plain PyTorch versions evaluate,
// so a kernel and its plain version select the same neighbours bit for bit
// (nvcc would otherwise contract the products into FMAs).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dlo {

constexpr int kTile = 128;   // queries per block, one thread each (K5, K6)
constexpr int kChunk = 512;  // targets per Morton chunk (ops/morton.py TARGET_CHUNK)

__device__ __forceinline__ float dist2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Stage targets [base, base + kChunk) of a [n_total, 3] cloud into shared
// memory with coalesced loads (one block of kTile threads). Slots past
// n_total and invalid targets hold +inf: their distance to any finite query
// is +inf, the same value as the TPU kernels' "+inf bias added after the
// sum", so they never win a minimum and always fail a radius test.
__device__ __forceinline__ void stage_chunk(float* s_x, float* s_y, float* s_z,
                                            const float* __restrict__ targets,
                                            const uint8_t* __restrict__ tmask,
                                            int base, int n_total) {
  for (int i = threadIdx.x; i < kChunk; i += kTile) {
    const int g = base + i;
    const bool ok = g < n_total && tmask[g] != 0;
    s_x[i] = ok ? targets[3 * g + 0] : INFINITY;
    s_y[i] = ok ? targets[3 * g + 1] : INFINITY;
    s_z[i] = ok ? targets[3 * g + 2] : INFINITY;
  }
}

// The 10 query-relative moments (n, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz)
// of d = t - q over the targets with |d|^2 <= r^2.
struct Moments {
  float v[10];
};

__device__ __forceinline__ void moments_chunk(float qx, float qy, float qz,
                                              const float* s_x, const float* s_y,
                                              const float* s_z, float radius2, Moments& a) {
#pragma unroll 4
  for (int i = 0; i < kChunk; ++i) {
    const float dx = s_x[i] - qx;
    const float dy = s_y[i] - qy;
    const float dz = s_z[i] - qz;
    // sums are touched only inside the test: 0 * inf would poison them
    if (dist2_rn(dx, dy, dz) <= radius2) {
      a.v[0] += 1.f;
      a.v[1] += dx; a.v[2] += dy; a.v[3] += dz;
      a.v[4] += dx * dx; a.v[5] += dx * dy; a.v[6] += dx * dz;
      a.v[7] += dy * dy; a.v[8] += dy * dz; a.v[9] += dz * dz;
    }
  }
}

__device__ __forceinline__ void store_moments(float* __restrict__ o, const Moments& a,
                                              bool valid) {
#pragma unroll
  for (int s = 0; s < 10; ++s) o[s] = valid ? a.v[s] : 0.f;
}

}  // namespace dlo
