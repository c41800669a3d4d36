// K5: the batched Poseidon permutation over BN254 Fr, widths t = 2..17.
//
// Replaces zkfl_tpu/ops/poseidon_pallas.py _round_body (:85), which
// _round_call (:122-143) wraps in one pallas_call per round and
// _permute_fn (:146-180) replays 65-76 times through a lax.scan.  Here one
// launch runs the whole permutation, in the optimized form of
// poseidon.cuh: at the port's batch sizes the host side of a launch costs
// more than a field kernel, so 65-76 launches per batch would cost more
// than the work.
//
// Bound: 32-bit integer multiply-adds, by far.  The fewest of a correct
// design (chip_smoke.py poseidon_madds): 456,416 a permutation at t = 17,
// 47,360 at t = 2, 65,400 at t = 3, on 2 t 32 bytes of input and output.
// What the card spends is instruction issue: each 32 x 32 -> 64-bit
// multiply-add is one IMAD.WIDE.U32(.X), and the carries, adds and selects
// around it about as many again.  What the design does about it:
//  - the optimized rounds (no t x t mix in a partial round, 2t - 1
//    products there instead of t^2);
//  - one Montgomery reduction per mixed lane, after a sum of t 512-bit
//    products left unreduced (bn254.cuh mul_wide_acc, redc_wide), as
//    _round_body does;
//  - every product on PTX carry chains with even/odd columns (bn254.cuh
//    field_mul): about 297 SASS instructions per product against 600-667
//    for the C form (kernel_stats.py).
// Where the state lives, from ptxas's report (-Xptxas -v) per width: t = 2
// and 3 keep it in registers with their lane loops unrolled (78 and 108
// registers, no stack frame, no spill); wider states stay in the thread's
// local memory with the lane loops rolled (66-68 registers, a stack frame
// of 2 t 32 bytes for the state and the full rounds' scratch, no spill): at
// t = 17 the state alone is 136 words.  One thread per state, 128 a block;
// local memory is cached in L1, and the same state in shared memory (a
// 140-word stride per thread, 3 blocks a SM) was tried and not kept.  The
// constants are one device buffer per t read by broadcast (all threads of a
// warp read the same element): 96.8 KB at t = 17, more than the 64 KB
// __constant__ bank.
//
// Layout: the public int32 [8, n, t] limb-major tensor (limb, hash, lane),
// read and written in place of a transposed copy: the kernel is bound by
// arithmetic, not by these reads.
#include <cuda_runtime.h>

#include "poseidon.cuh"

namespace {

constexpr int THREADS = 128;

template <int T>
__global__ void __launch_bounds__(THREADS)
    poseidon_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                    const uint32_t* __restrict__ c, const uint32_t* __restrict__ m, long long n) {
  constexpr int U = zk::poseidon_lane_unroll<T>();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    alignas(16) uint32_t s[T][zk::NL];
#pragma unroll(U)
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int w = 0; w < zk::NL; ++w) s[j][w] = in[(w * n + i) * T + j];
    zk::poseidon_permute<T>(s, c, m);
#pragma unroll(U)
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int w = 0; w < zk::NL; ++w) out[(w * n + i) * T + j] = s[j][w];
  }
}

template <int T>
int launch(const uint32_t* in, uint32_t* out, const uint32_t* c, const uint32_t* m, long long n,
           cudaStream_t stream) {
  if (n > 0) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    const int grid = (int)(blocks < (1LL << 20) ? blocks : (1LL << 20));
    poseidon_kernel<T><<<grid, THREADS, 0, stream>>>(in, out, c, m, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// in, out: int32 [8, n, t] Montgomery states; c, m: the optimized form's
// constant buffers (poseidon.cuh), Montgomery elements of 8 words each.
extern "C" int zk_poseidon(int t, const void* in, void* out, const void* c, const void* m,
                           long long n, void* stream) {
  const auto* pi = static_cast<const uint32_t*>(in);
  auto* po = static_cast<uint32_t*>(out);
  const auto* pc = static_cast<const uint32_t*>(c);
  const auto* pm = static_cast<const uint32_t*>(m);
  auto s = static_cast<cudaStream_t>(stream);
  switch (t) {
    case 2: return launch<2>(pi, po, pc, pm, n, s);
    case 3: return launch<3>(pi, po, pc, pm, n, s);
    case 4: return launch<4>(pi, po, pc, pm, n, s);
    case 5: return launch<5>(pi, po, pc, pm, n, s);
    case 6: return launch<6>(pi, po, pc, pm, n, s);
    case 7: return launch<7>(pi, po, pc, pm, n, s);
    case 8: return launch<8>(pi, po, pc, pm, n, s);
    case 9: return launch<9>(pi, po, pc, pm, n, s);
    case 10: return launch<10>(pi, po, pc, pm, n, s);
    case 11: return launch<11>(pi, po, pc, pm, n, s);
    case 12: return launch<12>(pi, po, pc, pm, n, s);
    case 13: return launch<13>(pi, po, pc, pm, n, s);
    case 14: return launch<14>(pi, po, pc, pm, n, s);
    case 15: return launch<15>(pi, po, pc, pm, n, s);
    case 16: return launch<16>(pi, po, pc, pm, n, s);
    case 17: return launch<17>(pi, po, pc, pm, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
