// K4: complete G1 point addition and doubling over [3, 8, n] projective
// points (X:Y:Z, Fq Montgomery limbs, limb-major).
//
// Replaces zkfl_tpu/ops/point_kernels.py _padd_kernel (:68) and
// _pdbl_kernel (:101), the inner ops of every G1 MSM add and of the Horner
// ladder (zkfl_tpu/ops/msm_pallas.py, whose ladder runs _pdbl_kernel in an
// inner fori_loop: here one launch doubles `times` times).
//
// Bound: integer multiply-adds, against 6 x 32 (or 3 x 32) bytes in and
// 3 x 32 out.  The fewest of a correct design: add 12 Fq products of 136
// 32-bit multiply-adds (b3 = 9 takes additions, not products); double 6
// products and 2 squarings of 108 (36 + 64 + 8), times `times`.  This
// kernel multiplies by b3 with a full product (add 14 products, double 9),
// so it can reach at most 0.86 (add) or 0.84 (double) of that bound.
// Design: one point per thread, the whole RCB15 formula in registers
// (branchless, identity-safe, as the Pallas kernels), the formulas of
// bn254.cuh shared with K6 (rcb_padd / rcb_pdbl over FqPoint), whose
// product on the card is mont_mul_cc: CIOS on PTX carry chains instead of
// 64-bit C arithmetic, for fewer instructions a product.  128-thread blocks
// with a minimum of 4 blocks per SM, the most that ptxas fits without
// spilling (126 / 110 registers; 5 spills).
#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ void load_point(zk::G1& p, const uint32_t* x, long long i, long long n) {
#pragma unroll
  for (int j = 0; j < zk::NL; ++j) {
    p.x.v[j] = x[(0 * zk::NL + j) * n + i];
    p.y.v[j] = x[(1 * zk::NL + j) * n + i];
    p.z.v[j] = x[(2 * zk::NL + j) * n + i];
  }
}

__device__ __forceinline__ void store_point(uint32_t* x, const zk::G1& p, long long i, long long n) {
#pragma unroll
  for (int j = 0; j < zk::NL; ++j) {
    x[(0 * zk::NL + j) * n + i] = p.x.v[j];
    x[(1 * zk::NL + j) * n + i] = p.y.v[j];
    x[(2 * zk::NL + j) * n + i] = p.z.v[j];
  }
}

__global__ void __launch_bounds__(THREADS, 4)
    g1_padd_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                   uint32_t* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
#pragma unroll 1
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    zk::G1 a, b, r;
    load_point(a, p, i, n);
    load_point(b, q, i, n);
    zk::g1_padd(r, a, b);
    store_point(out, r, i, n);
  }
}

// out = 2^times * p.
__global__ void __launch_bounds__(THREADS, 4)
    g1_pdbl_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out, long long n,
                   int times) {
  const long long stride = (long long)gridDim.x * blockDim.x;
#pragma unroll 1
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    zk::G1 a, r;
    load_point(a, p, i, n);
#pragma unroll 1
    for (int k = 0; k < times; ++k) {
      zk::g1_pdbl(r, a);
      a = r;
    }
    store_point(out, a, i, n);
  }
}

int grid_for(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  return (int)(blocks < (1LL << 20) ? blocks : (1LL << 20));
}

}  // namespace

extern "C" int zk_g1_padd(const void* p, const void* q, void* out, long long n, void* stream) {
  if (n > 0) {
    g1_padd_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(p), static_cast<const uint32_t*>(q),
        static_cast<uint32_t*>(out), n);
  }
  return (int)cudaGetLastError();
}

extern "C" int zk_g1_pdbl(const void* p, void* out, long long n, int times, void* stream) {
  if (times < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    g1_pdbl_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(p), static_cast<uint32_t*>(out), n, times);
  }
  return (int)cudaGetLastError();
}
