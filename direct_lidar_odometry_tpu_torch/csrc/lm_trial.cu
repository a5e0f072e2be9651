// One Levenberg-Marquardt trial of GICP's align (kernel K7), and the
// re-orthonormalization of one pose. sm_90a.
//
// Replaces no Pallas kernel. The JAX package's registration/gicp.py runs
// the trial (step_lm's inner body, reference lsq_registration_impl.hpp:
// 169-206, with nano_gicp_impl.hpp:272-296's error) inside its
// lax.while_loop, where XLA fuses it into a kernel or two. As PyTorch
// operations the trial was ~240 launches of ~2 us each on the H100, which
// the host waited for at every LM step (ops/cuda_lm.py's lm_trial_plain).
//
// What it computes, from the state (x [4,4], lambda, nu) and the frozen
// linearization (H [6,6], b [6], its error, and per source point s the
// correspondence's target point mu_b, target normal n_b, rotated source
// normal m0 and weight w): the damped step d = -(H + lambda I)^-1 b by LU
// with partial pivoting (torch.linalg.solve_ex's algorithm), delta =
// (so3_exp(d[0:3]), d[3:6]), xi = delta x with its rotation taken through
// a quaternion and back, the error yi = sum e^T M e over the points with
// e = mu_b - xi s and M = w (2I - (1-eps)(n_b n_b^T + m0 m0^T))^-1 by
// adjugate, rho = (error - yi) / d.(lambda d - b) (1e-30 where that is not
// larger than 1e-30 in magnitude), accept = rho >= 0, converged =
// max(|R_delta - I| / rot_eps, |t_delta| / trans_eps) < 1; then, as the
// plain version does, lambda *= max(1 - (2 rho - 1)^3, 1/3) and x = xi on
// acceptance, lambda *= nu and nu *= 2 on rejection, and the flags
// [accept, converged] written. Every point's term is formed in the plain
// version's order without contracted multiply-adds.
//
// What bounds it on the H100: 52 bytes a source point (mu_b, n_b, m0, the
// point, w), 1.7 MB at 32768 points, 0.5 us at 3.35 TB/s; in practice the
// launch and the serial solve and pose on one thread (a few us). Design:
// one launch of at most kMaxBlocks blocks of kThreads threads. Thread 0 of
// every block solves the system and forms delta and xi itself while its
// other threads load their first point, so no block waits for another, and
// every block gets the same bits from the same instructions. Each thread
// sums its points in index order, each block its threads with a fixed
// shuffle tree, and writes its partial; the last block to take a ticket
// sums the partials with the same tree in block order, finishes the trial
// and resets the ticket. No atomic decides a sum, so a run repeats bit for
// bit. The workspace (partials, the trial's error and rho, the ticket) is
// the caller's: the launch allocates nothing and replays from a CUDA graph.
//
// The one-thread entry dlo_reorthonormalize takes a [4,4] pose's rotation
// through the quaternion and back, as align does to its guess.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 128;  // ops/cuda_lm.py's MAX_BLOCKS
constexpr int kErrorSlot = kMaxBlocks;
constexpr int kRhoSlot = kMaxBlocks + 1;
constexpr int kTicketSlot = kMaxBlocks + 2;

// the trial's step, delta and xi (rotations row-major)
struct Trial {
  float d[6];
  float dr[9], dt[3];
  float xr[9], xt[3];
};

__device__ inline float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ inline float add(float a, float b) { return __fadd_rn(a, b); }
__device__ inline float sub(float a, float b) { return __fsub_rn(a, b); }

// se3.so3_exp: Rodrigues, with the Taylor terms below theta^2 = 1e-8
__device__ void so3_exp(const float* w, float* r) {
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-8f;
  const float a = small ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - cosf(theta)) / theta2;
  const float k[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0], -w[1], w[0], 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = k[i * 3] * k[j] + k[i * 3 + 1] * k[3 + j] + k[i * 3 + 2] * k[6 + j];
      r[i * 3 + j] = (i == j ? 1.0f : 0.0f) + a * k[i * 3 + j] + b * kk;
    }
  }
}

// se3.quat_normalize
__device__ void quat_normalize(float* q) {
  const float norm = fmaxf(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), 1e-8f);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / norm;
}

// gicp's re-orthonormalization: se3.rotmat_to_quat (Shepperd, the first
// largest candidate, w >= 0), then se3.quat_to_rotmat
__device__ void reorthonormalize_rotation(const float* m, float* r) {
  const float m00 = m[0], m01 = m[1], m02 = m[2];
  const float m10 = m[3], m11 = m[4], m12 = m[5];
  const float m20 = m[6], m21 = m[7], m22 = m[8];
  const float mags[4] = {1.0f + (m00 + m11 + m22), 1.0f + m00 - m11 - m22,
                         1.0f - m00 + m11 - m22, 1.0f - m00 - m11 + m22};
  int best = 0;
  float top = mags[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (mags[i] > top) {
      top = mags[i];
      best = i;
    }
  }
  float q[4];
  if (best == 0) {
    q[0] = mags[0]; q[1] = m21 - m12; q[2] = m02 - m20; q[3] = m10 - m01;
  } else if (best == 1) {
    q[0] = m21 - m12; q[1] = mags[1]; q[2] = m01 + m10; q[3] = m02 + m20;
  } else if (best == 2) {
    q[0] = m02 - m20; q[1] = m01 + m10; q[2] = mags[2]; q[3] = m12 + m21;
  } else {
    q[0] = m10 - m01; q[1] = m02 + m20; q[2] = m12 + m21; q[3] = mags[3];
  }
  quat_normalize(q);
  if (q[0] < 0.0f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = -q[i];
  }
  quat_normalize(q);
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  r[0] = 1.0f - 2.0f * (yy + zz); r[1] = 2.0f * (xy - wz); r[2] = 2.0f * (xz + wy);
  r[3] = 2.0f * (xy + wz); r[4] = 1.0f - 2.0f * (xx + zz); r[5] = 2.0f * (yz - wx);
  r[6] = 2.0f * (xz - wy); r[7] = 2.0f * (yz + wx); r[8] = 1.0f - 2.0f * (xx + yy);
}

// The damped step, delta and xi, on one thread.
__device__ __noinline__ void solve_trial(const float* h, const float* b, float lam,
                                         const float* x, Trial* out) {
  float a[36], rhs[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) a[i * 6 + j] = h[i * 6 + j] + lam * (i == j ? 1.0f : 0.0f);
    rhs[i] = -b[i];
  }
  // LU with partial pivoting (the first largest |pivot|), the row
  // exchanges applied to the right-hand side as they happen
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float top = fabsf(a[k * 6 + k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(a[i * 6 + k]) > top) {
        top = fabsf(a[i * 6 + k]);
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float t = a[k * 6 + j];
          a[k * 6 + j] = a[i * 6 + j];
          a[i * 6 + j] = t;
        }
        const float t = rhs[k];
        rhs[k] = rhs[i];
        rhs[i] = t;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = a[i * 6 + k] / a[k * 6 + k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) a[i * 6 + j] -= l * a[k * 6 + j];
      rhs[i] -= l * rhs[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = rhs[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= a[i * 6 + j] * out->d[j];
    out->d[i] = s / a[i * 6 + i];
  }
  so3_exp(out->d, out->dr);
#pragma unroll
  for (int i = 0; i < 3; ++i) out->dt[i] = out->d[3 + i];
  // delta x, the rows of delta's rotation and translation
  float m[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = out->dr[i * 3] * x[j] + out->dr[i * 3 + 1] * x[4 + j] +
                      out->dr[i * 3 + 2] * x[8 + j] + out->dt[i] * x[12 + j];
      if (j < 3) {
        m[i * 3 + j] = v;
      } else {
        out->xt[i] = v;
      }
    }
  }
  reorthonormalize_rotation(m, out->xr);
}

struct Point {
  float mx, my, mz, nx, ny, nz, ax, ay, az, sx, sy, sz, w;
};

__device__ inline Point load_point(const float* mu_b, int mu_stride, const float* n_b,
                                   int n_stride, const float* m0, int m0_stride,
                                   const float* weight, int w_stride, const float* points,
                                   int p_stride, int i) {
  const float* mu = mu_b + static_cast<int64_t>(i) * mu_stride;
  const float* nb = n_b + static_cast<int64_t>(i) * n_stride;
  const float* ma = m0 + static_cast<int64_t>(i) * m0_stride;
  const float* s = points + static_cast<int64_t>(i) * p_stride;
  return Point{mu[0], mu[1], mu[2], nb[0], nb[1], nb[2], ma[0], ma[1], ma[2],
               s[0], s[1], s[2], weight[static_cast<int64_t>(i) * w_stride]};
}

// One point's e^T M e at the pose (r, t): ops/cuda_lm.py's
// compute_error_plain, term by term in its order.
__device__ inline float point_error(const Point& p, const float* r, const float* t, float a) {
  const float px = add(add(add(mul(p.sx, r[0]), mul(p.sy, r[1])), mul(p.sz, r[2])), t[0]);
  const float py = add(add(add(mul(p.sx, r[3]), mul(p.sy, r[4])), mul(p.sz, r[5])), t[1]);
  const float pz = add(add(add(mul(p.sx, r[6]), mul(p.sy, r[7])), mul(p.sz, r[8])), t[2]);
  const float ex = sub(p.mx, px), ey = sub(p.my, py), ez = sub(p.mz, pz);
  const float a00 = sub(2.0f, mul(a, add(mul(p.nx, p.nx), mul(p.ax, p.ax))));
  const float a01 = mul(-a, add(mul(p.nx, p.ny), mul(p.ax, p.ay)));
  const float a02 = mul(-a, add(mul(p.nx, p.nz), mul(p.ax, p.az)));
  const float a11 = sub(2.0f, mul(a, add(mul(p.ny, p.ny), mul(p.ay, p.ay))));
  const float a12 = mul(-a, add(mul(p.ny, p.nz), mul(p.ay, p.az)));
  const float a22 = sub(2.0f, mul(a, add(mul(p.nz, p.nz), mul(p.az, p.az))));
  const float co00 = sub(mul(a11, a22), mul(a12, a12));
  const float co01 = sub(mul(a02, a12), mul(a01, a22));
  const float co02 = sub(mul(a01, a12), mul(a02, a11));
  const float det = add(add(mul(a00, co00), mul(a01, co01)), mul(a02, co02));
  const float inv_det = __fdiv_rn(p.w, fabsf(det) > 1e-20f ? det : 1.0f);
  const float m00 = mul(co00, inv_det);
  const float m01 = mul(co01, inv_det);
  const float m02 = mul(co02, inv_det);
  const float m11 = mul(sub(mul(a00, a22), mul(a02, a02)), inv_det);
  const float m12 = mul(sub(mul(a01, a02), mul(a00, a12)), inv_det);
  const float m22 = mul(sub(mul(a00, a11), mul(a01, a01)), inv_det);
  const float mex = add(add(mul(m00, ex), mul(m01, ey)), mul(m02, ez));
  const float mey = add(add(mul(m01, ex), mul(m11, ey)), mul(m12, ez));
  const float mez = add(add(mul(m02, ex), mul(m12, ey)), mul(m22, ez));
  return add(add(mul(ex, mex), mul(ey, mey)), mul(ez, mez));
}

// The block's sum of v: a fixed shuffle tree in each warp, then over the
// warps; valid in thread 0. Every thread of the block calls it.
__device__ float block_sum(float v, float* s_warp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < kThreads / 32 ? s_warp[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// rho, the updates of lambda, nu and x, and the flags (one thread)
__device__ void finish_trial(const Trial& tr, const float* b, float error, float yi, float* x,
                             float* lam, float* nu, float rot_eps, float trans_eps,
                             float* work, bool* flags) {
  const float l = *lam, n = *nu;
  float denom = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) denom += tr.d[k] * (l * tr.d[k] - b[k]);
  denom = fabsf(denom) > 1e-30f ? denom : 1e-30f;
  const float rho = (error - yi) / denom;
  const bool accept = rho >= 0.0f;
  // the largest |R_delta - I| and |t_delta|, NaN if any is
  bool nan = false;
  float r_max = 0.0f, t_max = 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float v = fabsf(tr.dr[k] - (k % 4 == 0 ? 1.0f : 0.0f));
    nan |= v != v;
    r_max = fmaxf(r_max, v);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float v = fabsf(tr.dt[k]);
    nan |= v != v;
    t_max = fmaxf(t_max, v);
  }
  const bool converged = !nan && fmaxf(r_max / rot_eps, t_max / trans_eps) < 1.0f;
  if (accept) {
    const float c = 2.0f * rho - 1.0f;
    *lam = l * fmaxf(1.0f - c * c * c, 1.0f / 3.0f);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) x[i * 4 + j] = tr.xr[i * 3 + j];
      x[i * 4 + 3] = tr.xt[i];
    }
    x[12] = 0.0f; x[13] = 0.0f; x[14] = 0.0f; x[15] = 1.0f;
  } else {
    *lam = n * l;
    *nu = 2.0f * n;
  }
  flags[0] = accept;
  flags[1] = converged;
  work[kErrorSlot] = yi;
  work[kRhoSlot] = rho;
}

__global__ void __launch_bounds__(kThreads) lm_trial_kernel(
    const float* __restrict__ h, const float* __restrict__ b, const float* __restrict__ error,
    float* x, float* lam, float* nu, const float* __restrict__ mu_b, int mu_stride,
    const float* __restrict__ n_b, int n_stride, const float* __restrict__ m0, int m0_stride,
    const float* __restrict__ weight, int w_stride, const float* __restrict__ points,
    int p_stride, int n, float rot_eps, float trans_eps, float plane_a, float* work,
    bool* flags) {
  __shared__ Trial s_trial;
  __shared__ float s_warp[kThreads / 32];
  __shared__ bool s_last;
  const int stride = gridDim.x * kThreads;
  int i = blockIdx.x * kThreads + threadIdx.x;
  Point p{};
  if (i < n) p = load_point(mu_b, mu_stride, n_b, n_stride, m0, m0_stride, weight, w_stride,
                            points, p_stride, i);
  if (threadIdx.x == 0) solve_trial(h, b, *lam, x, &s_trial);
  __syncthreads();
  float r[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = s_trial.xr[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = s_trial.xt[k];
  float acc = 0.0f;
  while (i < n) {
    acc = add(acc, point_error(p, r, t, plane_a));
    i += stride;
    if (i < n) p = load_point(mu_b, mu_stride, n_b, n_stride, m0, m0_stride, weight, w_stride,
                              points, p_stride, i);
  }
  const float part = block_sum(acc, s_warp);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(work + kTicketSlot);
  if (threadIdx.x == 0) {
    work[blockIdx.x] = part;
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float yi = block_sum(threadIdx.x < gridDim.x ? __ldcg(work + threadIdx.x) : 0.0f, s_warp);
  if (threadIdx.x == 0) {
    finish_trial(s_trial, b, *error, yi, x, lam, nu, rot_eps, trans_eps, work, flags);
    *ticket = 0u;
  }
}

__global__ void reorthonormalize_kernel(const float* __restrict__ x, float* __restrict__ out) {
  if (threadIdx.x != 0) return;
  float m[9], r[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) m[i * 3 + j] = x[i * 4 + j];
  }
  reorthonormalize_rotation(m, r);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i * 4 + j] = r[i * 3 + j];
    out[i * 4 + 3] = x[i * 4 + 3];
  }
  out[12] = 0.0f; out[13] = 0.0f; out[14] = 0.0f; out[15] = 1.0f;
}

}  // namespace

extern "C" int dlo_lm_trial(
    const void* h, const void* b, const void* error, void* x, void* lam, void* nu,
    const void* mu_b, int mu_stride, const void* n_b, int n_stride, const void* m0,
    int m0_stride, const void* weight, int w_stride, const void* points, int p_stride, int n,
    float rot_eps, float trans_eps, float plane_a, void* work, void* flags, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = (n + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  lm_trial_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(b),
      static_cast<const float*>(error), static_cast<float*>(x), static_cast<float*>(lam),
      static_cast<float*>(nu), static_cast<const float*>(mu_b), mu_stride,
      static_cast<const float*>(n_b), n_stride, static_cast<const float*>(m0), m0_stride,
      static_cast<const float*>(weight), w_stride, static_cast<const float*>(points), p_stride,
      n, rot_eps, trans_eps, plane_a, static_cast<float*>(work), static_cast<bool*>(flags));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dlo_reorthonormalize(const void* x, void* out, void* stream) {
  reorthonormalize_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
