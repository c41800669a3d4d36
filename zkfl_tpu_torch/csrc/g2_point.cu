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
// reads and writes 16 consecutive words per limb row.  An Fq2 product is
// split over the pair: the c0 thread computes a0 b0 - a1 b1, the c1 thread
// a1 b0 + a0 b1, each after fetching its partner's 8 limbs of both operands
// with __shfl_xor_sync(., 16) (of one operand for the constant b3): 2 Fq
// products a thread on the critical path, against 3 for Karatsuba on one
// thread, and 24 words of point state a thread instead of 48, which keeps
// padd's live Fq2 temporaries in registers.  Add and sub stay in the
// thread.  Branchless, one point pair a thread, so every thread of a warp
// reaches every shuffle with the full mask; in the ragged tail the threads
// past n compute on the last point and store nothing: no early return.
//
// Bound: integer multiply-adds.  The fewest Fq products (136 multiply-adds
// each) of a correct design: 3 per Fq2 product (Karatsuba), 2 per Fq2
// squaring, and 2 per multiply by b3 = 3 b' = (9/82)(9 - u), as
// (9/82)(9 a0 + a1) and (9/82)(9 a1 - a0).  padd: 12 products and 2 by b3
// = 40 Fq products against 576 bytes moved; pdbl: 6 products, 2 squarings
// and 1 by b3 = 24 against 384 bytes (times doublings: 24 x times).  The
// split does 4 Fq products for each of these (56 and 36), so it can reach
// at most 0.71 (padd) or 0.67 (pdbl) of that bound.
//
// Launch bounds: 128-thread blocks, a minimum of 2 (padd) and 3 (pdbl)
// blocks per SM, the most that ptxas fits without spilling (194 and 164
// registers; one block more spills).
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

__global__ void __launch_bounds__(THREADS, 2)
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
