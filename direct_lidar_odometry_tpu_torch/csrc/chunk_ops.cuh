// Device functions shared by the port's kernels: the rounded distance (all
// six) and the radius-moment sums a thread carries (K1). Every kernel
// spells its inner loop out in the kernel body: built from helper
// functions, an earlier K2 ran 25-45 % slower on the H100. K1-K4 share
// their candidate selection and staging (subtile_search.cuh), K5 and K6 the
// dense array of valid targets and its staging (dense_targets.cuh). sm_90a.
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

// targets per staged chunk: a Morton chunk (ops/morton.py TARGET_CHUNK) for
// K1-K4, 512 consecutive valid targets for K5 and K6
constexpr int kChunk = 512;

__device__ __forceinline__ float dist2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// The 10 query-relative moments (n, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz)
// of d = t - q over the targets with |d|^2 <= r^2.
struct Moments {
  float v[10];
};

}  // namespace dlo
