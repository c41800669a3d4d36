// K3: raw per-limb column sums -> canonical Montgomery Fr.
//
// Replaces zkfl_tpu/ops/limb_kernels.py PallasField._k_normalize_raw (:387),
// which closes the sparse A.s / B.s / C.s evaluation of
// zkfl_tpu/ops/qap_pallas.py matrix_evals_lm (:202).
//
// With 32-bit limbs a column sum no longer fits in 32 bits, so the TPU's
// bound "row sum < nnz_row * 2^16 < 2^31" becomes: the sums arrive as int64,
// each < nnz_row * 2^32, which holds for rows of fewer than 2^31 terms.
//
// Bound: bytes, 64 in and 32 out per lane; the arithmetic is about 20
// 32-bit multiply-adds a lane.  Design: one thread per row: carry the eight
// int64 columns into 8 limbs plus a top word, fold the top word back with
// R mod p, then one quotient step from the top 64 bits and at most one
// conditional subtraction (bn254.cuh normalize_raw, which states the
// estimate's error).
#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

__global__ void normalize_raw_kernel(const int64_t* __restrict__ cols, uint32_t* __restrict__ out,
                                     long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    int64_t c[zk::NL];
    uint32_t r[zk::NL];
#pragma unroll
    for (int j = 0; j < zk::NL; ++j) c[j] = cols[j * n + i];
    zk::normalize_raw<zk::Fr>(r, c);
#pragma unroll
    for (int j = 0; j < zk::NL; ++j) out[j * n + i] = r[j];
  }
}

}  // namespace

extern "C" int zk_normalize_raw(const void* cols, void* out, long long n, void* stream) {
  if (n > 0) {
    const long long blocks = (n + 255) / 256;
    const int grid = (int)(blocks < (1LL << 20) ? blocks : (1LL << 20));
    normalize_raw_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(cols), static_cast<uint32_t*>(out), n);
  }
  return (int)cudaGetLastError();
}
