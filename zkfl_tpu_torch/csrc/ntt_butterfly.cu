// K2: one radix-2 NTT stage over Fr: t = v * tw; (hi, lo) = (u + t, u - t).
//
// Replaces zkfl_tpu/ops/limb_kernels.py PallasField._k_butterfly (:380),
// called once per stage by zkfl_tpu/ops/qap_pallas.py ntt_lm (:84).
//
// Bound: one mont_mul plus an add and a sub per lane (integer multiply-adds);
// 3 x 32 bytes in and 2 x 32 bytes out.  Design: one thread per butterfly,
// all three ops fused in registers.  The stage's reshapes stay in torch; a
// later kernel can run all log2(n) stages of a transform in shared memory.
#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

__global__ void butterfly_kernel(const uint32_t* __restrict__ u, const uint32_t* __restrict__ v,
                                 const uint32_t* __restrict__ tw, uint32_t* __restrict__ hi,
                                 uint32_t* __restrict__ lo, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t a[zk::NL], b[zk::NL], w[zk::NL], t[zk::NL], r[zk::NL];
#pragma unroll
    for (int j = 0; j < zk::NL; ++j) {
      a[j] = u[j * n + i];
      b[j] = v[j * n + i];
      w[j] = tw[j * n + i];
    }
    zk::mont_mul<zk::Fr>(t, b, w);
    zk::add<zk::Fr>(r, a, t);
#pragma unroll
    for (int j = 0; j < zk::NL; ++j) hi[j * n + i] = r[j];
    zk::sub<zk::Fr>(r, a, t);
#pragma unroll
    for (int j = 0; j < zk::NL; ++j) lo[j * n + i] = r[j];
  }
}

}  // namespace

extern "C" int zk_butterfly(const void* u, const void* v, const void* tw, void* hi, void* lo,
                            long long n, void* stream) {
  if (n > 0) {
    const long long blocks = (n + 255) / 256;
    const int grid = (int)(blocks < (1LL << 20) ? blocks : (1LL << 20));
    butterfly_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(u), static_cast<const uint32_t*>(v),
        static_cast<const uint32_t*>(tw), static_cast<uint32_t*>(hi),
        static_cast<uint32_t*>(lo), n);
  }
  return (int)cudaGetLastError();
}
