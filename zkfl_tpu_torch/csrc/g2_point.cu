// K6: complete G2 point addition and doubling over [3, 2, 8, n] projective
// points (X:Y:Z in Fq2 = Fq[u] / (u^2 + 1), c0 then c1, Fq Montgomery limbs,
// limb-major).
//
// Replaces the composition of padd_g2 / pdbl_g2 in
// zkfl_tpu/ops/point_kernels.py (:284, :321), which builds each G2 op out of
// lane-stacked FQK Pallas calls (24-28 field launches and as many
// concatenations per point op); the JAX package has no G2 kernel of its
// own.  Here each op is one launch, the formulas of bn254.cuh (rcb_padd /
// rcb_pdbl, shared with K4) over Fq2Lane.
//
// Design: two threads per point.  In a warp, lanes 0-15 hold c0 of points
// i..i+15 and lanes 16-31 hold c1 of the same points, so each half-warp
// reads and writes 16 consecutive words per limb row.  Each op with a
// product fetches the partner's 8 limbs of its operands with
// __shfl_xor_sync(., 16); add and sub stay in the thread.  The Fq2 policy
// (bn254.cuh Fq2Lane) is lazy: the c0 thread computes a0 b0 + a1 (p - b1),
// the c1 thread a1 b0 + a0 b1, each as a sum of two Fq products with one
// Montgomery reduction (CIOS on the carry chains with both products' rows
// before each reduction row); padd's X3, Y3, Z3 and pdbl's Y3, each a sum
// of two Fq2 products, take a sum of four Fq products and one reduction a
// coefficient; the squarings one product a thread ((a0 + a1)(a0 - a1) and
// 2 a1 a0); b3 = (9/82)(9 - u) additions and one product by 9/82.  A
// first build summed 512-bit products and reduced them with redc_wide (as
// K5 does): the same multiply-adds, but two fresh 16-word values a
// product, which ptxas served with register moves; it ran slower than the
// unlazy kernel before it.  24 words of point state a thread instead of
// 48.  Branchless, one point pair a thread, so every thread of a warp
// reaches every shuffle with the full mask; in the ragged tail the threads
// past n compute on the last point and store nothing: no early return.
//
// Bound: integer multiply-adds, the fewest of a correct design: an Fq2
// product by Karatsuba with lazy reduction, 3 products left unreduced (64
// multiply-adds each) and 2 reductions (72); a sum of two Fq2 products, 6
// unreduced products and 2 reductions; a squaring, 2 Fq products (136); a
// product by b3, 2 Fq products.  padd: 6 products, 3 sums of two and 2 by
// b3 = 4,144 a point against 576 bytes moved; pdbl: 4 products, 2
// squarings, 1 sum of two and 1 by b3 = 2,688 against 384 bytes (times
// doublings).  The split does, per thread, padd 24 unreduced products, 9
// reductions and 2 products (2,456; 4,912 a point), pdbl 12, 5 and 3
// (1,536; 3,072), so it can reach at most 0.84 (padd) or 0.88 (pdbl) of
// that bound.
//
// Launch bounds: 128-thread blocks, a minimum of 3 blocks per SM for both
// entries, chosen by card time (python -m zkfl_tpu_torch.launch_bounds):
// padd fits 2 blocks without spill (220 registers) and 3 with 80 bytes of
// spill (168), and runs faster at 3; pdbl fits 3 (146) and 4 (128) without
// spill, and runs faster at 3.
#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int POINTS_PER_WARP = 16;

using G2Half = zk::Proj<zk::Fq2Lane>;  // this thread's coefficient of X, Y, Z

// Coefficient c of point i.
__device__ __forceinline__ void load_half(G2Half& p, const uint32_t* x, int c, long long i,
                                          long long n) {
#pragma unroll
  for (int j = 0; j < zk::NL; ++j) {
    p.x.v[j] = x[((0 * 2 + c) * zk::NL + j) * n + i];
    p.y.v[j] = x[((1 * 2 + c) * zk::NL + j) * n + i];
    p.z.v[j] = x[((2 * 2 + c) * zk::NL + j) * n + i];
  }
}

__device__ __forceinline__ void store_half(uint32_t* x, const G2Half& p, int c, long long i,
                                           long long n) {
#pragma unroll
  for (int j = 0; j < zk::NL; ++j) {
    x[((0 * 2 + c) * zk::NL + j) * n + i] = p.x.v[j];
    x[((1 * 2 + c) * zk::NL + j) * n + i] = p.y.v[j];
    x[((2 * 2 + c) * zk::NL + j) * n + i] = p.z.v[j];
  }
}

// This thread's point.  One point pair a thread and no loop over points:
// ptxas cannot prove a grid-stride loop uniform across a warp, and around
// each shuffle inside one it emits a second, non-converged copy of the code
// (WARPSYNC.COLLECTIVE), which doubled K6's code.
__device__ __forceinline__ long long point_index(int lane) {
  return ((long long)blockIdx.x * WARPS + threadIdx.x / 32) * POINTS_PER_WARP + (lane & 15);
}

__global__ void __launch_bounds__(THREADS, 3)
    g2_padd_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                   uint32_t* __restrict__ out, long long n) {
  const int lane = threadIdx.x & 31;
  const int c = lane >> 4;
  const zk::Fq2Lane e = zk::Fq2Lane::of_lane(lane);
  const long long i = point_index(lane);
  const long long at = i < n ? i : n - 1;  // the tail's threads compute on the last point
  G2Half a, b, r;
  load_half(a, p, c, at, n);
  load_half(b, q, c, at, n);
  zk::rcb_padd(e, r, a, b);
  if (i < n) store_half(out, r, c, i, n);
}

// out = 2^times * p.
__global__ void __launch_bounds__(THREADS, 3)
    g2_pdbl_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out, long long n,
                   int times) {
  const int lane = threadIdx.x & 31;
  const int c = lane >> 4;
  const zk::Fq2Lane e = zk::Fq2Lane::of_lane(lane);
  const long long i = point_index(lane);
  const long long at = i < n ? i : n - 1;  // the tail's threads compute on the last point
  G2Half a, r;
  load_half(a, p, c, at, n);
#pragma unroll 1
  for (int k = 0; k < times; ++k) {  // times is the same for every thread
    zk::rcb_pdbl(e, r, a);
    a = r;
  }
  if (i < n) store_half(out, a, c, i, n);
}

// Blocks for n points at 2 threads a point, every point its own thread pair.
long long grid_for(long long n) {
  constexpr long long per_block = WARPS * POINTS_PER_WARP;
  return (n + per_block - 1) / per_block;
}

}  // namespace

// Both entries take n < 2^31 * 64 points (the grid's limit).
extern "C" int zk_g2_padd(const void* p, const void* q, void* out, long long n, void* stream) {
  if (grid_for(n) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    g2_padd_kernel<<<(unsigned)grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(p), static_cast<const uint32_t*>(q),
        static_cast<uint32_t*>(out), n);
  }
  return (int)cudaGetLastError();
}

extern "C" int zk_g2_pdbl(const void* p, void* out, long long n, int times, void* stream) {
  if (times < 1 || grid_for(n) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    g2_pdbl_kernel<<<(unsigned)grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(p), static_cast<uint32_t*>(out), n, times);
  }
  return (int)cudaGetLastError();
}
