// K4: complete G1 point addition and doubling over [3, 8, n] projective
// points (X:Y:Z, Fq Montgomery limbs, limb-major).
//
// Replaces zkfl_tpu/ops/point_kernels.py _padd_kernel (:68) and
// _pdbl_kernel (:101), the inner ops of every G1 MSM add and of the Horner
// ladder (zkfl_tpu/ops/msm_pallas.py).
//
// Bound: 14 (add) or 9 (double) Fq mont_muls per point, about 2k IMAD.WIDE,
// against 6 x 32 (or 3 x 32) bytes in and 3 x 32 out: integer throughput and
// registers, not memory.  Design: one point per thread, the whole RCB15
// formula in registers (branchless, identity-safe, as the Pallas kernels);
// 128-thread blocks so the ~200 live registers of a thread still leave
// several blocks resident per SM.  The MSM glue around it stays in torch.
#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ void load_point(zk::G1& p, const uint32_t* x, long long i, long long n) {
#pragma unroll
  for (int j = 0; j < zk::NL; ++j) {
    p.x[j] = x[(0 * zk::NL + j) * n + i];
    p.y[j] = x[(1 * zk::NL + j) * n + i];
    p.z[j] = x[(2 * zk::NL + j) * n + i];
  }
}

__device__ __forceinline__ void store_point(uint32_t* x, const zk::G1& p, long long i, long long n) {
#pragma unroll
  for (int j = 0; j < zk::NL; ++j) {
    x[(0 * zk::NL + j) * n + i] = p.x[j];
    x[(1 * zk::NL + j) * n + i] = p.y[j];
    x[(2 * zk::NL + j) * n + i] = p.z[j];
  }
}

__global__ void __launch_bounds__(THREADS) g1_padd_kernel(const uint32_t* __restrict__ p,
                                                          const uint32_t* __restrict__ q,
                                                          uint32_t* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    zk::G1 a, b, r;
    load_point(a, p, i, n);
    load_point(b, q, i, n);
    zk::g1_padd(r, a, b);
    store_point(out, r, i, n);
  }
}

__global__ void __launch_bounds__(THREADS) g1_pdbl_kernel(const uint32_t* __restrict__ p,
                                                          uint32_t* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    zk::G1 a, r;
    load_point(a, p, i, n);
    zk::g1_pdbl(r, a);
    store_point(out, r, i, n);
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

extern "C" int zk_g1_pdbl(const void* p, void* out, long long n, void* stream) {
  if (n > 0) {
    g1_pdbl_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(p), static_cast<uint32_t*>(out), n);
  }
  return (int)cudaGetLastError();
}
