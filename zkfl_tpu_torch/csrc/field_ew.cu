// K1: elementwise BN254 field ops over limb-major [8, n] uint32 tensors.
//
// Replaces the Pallas field kernels of zkfl_tpu/ops/limb_kernels.py:
//   PallasField._k_mont_mul (:357), _k_add (:364), _k_sub (:367),
//   _k_from_mont (:370), _k_to_mont (:374), _k_mul_sub_mul_const (:396) and
//   the mont_mul_const kernel (:571), for Fr (FRK) and Fq (FQK).
//
// Bound: 32-bit integer multiply-adds.  A mont_mul is 128 IMAD.WIDE plus
// carries per element and moves 3 x 32 bytes, so at main-path lane counts it
// is compute-bound; the tensor cores do not apply to carry chains.  Design:
// one thread per element, the whole op fused in registers (no partial
// products in memory, as the Pallas kernel kept them in VMEM); limb-major
// layout so neighbouring threads read neighbouring words; constants (R^2 for
// to_mont, k for the two const ops) are kernel arguments.
#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

enum Op {
  MONT_MUL = 0,
  ADD = 1,
  SUB = 2,
  TO_MONT = 3,
  FROM_MONT = 4,
  MONT_MUL_CONST = 5,
  MUL_SUB_MUL_CONST = 6,
};

__device__ __forceinline__ void load(uint32_t r[zk::NL], const uint32_t* x, long long i, long long n) {
#pragma unroll
  for (int j = 0; j < zk::NL; ++j) r[j] = x[j * n + i];
}

__device__ __forceinline__ void store(uint32_t* x, const uint32_t r[zk::NL], long long i, long long n) {
#pragma unroll
  for (int j = 0; j < zk::NL; ++j) x[j * n + i] = r[j];
}

template <class F, int OP>
__global__ void field_ew_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                const uint32_t* __restrict__ c, zk::Limbs k,
                                uint32_t* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t x[zk::NL], y[zk::NL], r[zk::NL];
    load(x, a, i, n);
    if constexpr (OP == MONT_MUL) {
      load(y, b, i, n);
      zk::mont_mul<F>(r, x, y);
    } else if constexpr (OP == ADD) {
      load(y, b, i, n);
      zk::add<F>(r, x, y);
    } else if constexpr (OP == SUB) {
      load(y, b, i, n);
      zk::sub<F>(r, x, y);
    } else if constexpr (OP == TO_MONT) {
      zk::to_mont<F>(r, x);
    } else if constexpr (OP == FROM_MONT) {
      zk::from_mont<F>(r, x);
    } else if constexpr (OP == MONT_MUL_CONST) {
      zk::mont_mul<F>(r, x, k.v);
    } else {  // MUL_SUB_MUL_CONST: (a*b - c) * k
      load(y, b, i, n);
      zk::mont_mul<F>(r, x, y);
      load(y, c, i, n);
      zk::sub<F>(r, r, y);
      zk::mont_mul<F>(r, r, k.v);
    }
    store(out, r, i, n);
  }
}

constexpr int THREADS = 256;

template <class F, int OP>
int launch(const uint32_t* a, const uint32_t* b, const uint32_t* c, const zk::Limbs& k,
           uint32_t* out, long long n, cudaStream_t stream) {
  if (n > 0) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    const int grid = (int)(blocks < (1LL << 20) ? blocks : (1LL << 20));
    field_ew_kernel<F, OP><<<grid, THREADS, 0, stream>>>(a, b, c, k, out, n);
  }
  return (int)cudaGetLastError();
}

template <class F>
int dispatch(int op, const uint32_t* a, const uint32_t* b, const uint32_t* c,
             const zk::Limbs& k, uint32_t* out, long long n, cudaStream_t s) {
  switch (op) {
    case MONT_MUL: return launch<F, MONT_MUL>(a, b, c, k, out, n, s);
    case ADD: return launch<F, ADD>(a, b, c, k, out, n, s);
    case SUB: return launch<F, SUB>(a, b, c, k, out, n, s);
    case TO_MONT: return launch<F, TO_MONT>(a, b, c, k, out, n, s);
    case FROM_MONT: return launch<F, FROM_MONT>(a, b, c, k, out, n, s);
    case MONT_MUL_CONST: return launch<F, MONT_MUL_CONST>(a, b, c, k, out, n, s);
    case MUL_SUB_MUL_CONST: return launch<F, MUL_SUB_MUL_CONST>(a, b, c, k, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// field: 0 = Fr, 1 = Fq.  Unused operands may be null; k points to 8 host
// words (the constant of the two const ops, ignored by the others).
extern "C" int zk_field_ew(int field, int op, const void* a, const void* b, const void* c,
                           const void* k, void* out, long long n, void* stream) {
  zk::Limbs kl;
  const uint32_t* kw = static_cast<const uint32_t*>(k);
  for (int j = 0; j < zk::NL; ++j) kl.v[j] = kw ? kw[j] : 0u;
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  const auto* pc = static_cast<const uint32_t*>(c);
  auto* po = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (field == 0) return dispatch<zk::Fr>(op, pa, pb, pc, kl, po, n, s);
  if (field == 1) return dispatch<zk::Fq>(op, pa, pb, pc, kl, po, n, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* zk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
