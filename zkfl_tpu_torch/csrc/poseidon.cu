// K5: the batched Poseidon permutation over BN254 Fr, widths t = 2..17.
//
// Replaces zkfl_tpu/ops/poseidon_pallas.py _round_body (:85), which
// _round_call (:122-143) wraps in one pallas_call per round and
// _permute_fn (:146-180) replays 65-76 times through a lax.scan.  Here one
// launch runs the whole permutation (poseidon.cuh): at the port's batch
// sizes the host side of a launch costs more than a field kernel, so 65-76
// launches per batch would cost more than the work.
//
// Bound: 32-bit integer multiply-adds.  A width-t permutation is
// R_F * (3t + t^2) + R_P * (3 + t^2) Montgomery products (828 at t = 3,
// 22,576 at t = 17) on 2 * t * 32 bytes of input and output.  Design: one
// thread per hash; its state (t x 8 words, 136 at t = 17) and the mix's
// scratch sit in the thread's local memory, read 8 words per product
// against some 200 integer instructions of the product itself, which
// keeps the code one product long and the registers few (many warps per
// SM to hide the multiply chains' latency).  The template on t fixes the
// trip counts.  Round constants and the MDS matrix are read from a device
// buffer that the wrapper builds once per t (all widths together exceed
// the 64 KB __constant__ bank); all threads of a warp read the same
// constant, one broadcast load.
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
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t s[T][zk::NL];
#pragma unroll 1
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int w = 0; w < zk::NL; ++w) s[j][w] = in[(w * n + i) * T + j];
    zk::poseidon_permute<T>(s, c, m);
#pragma unroll 1
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

// in, out: int32 [8, n, t] Montgomery states; c: (R_F + R_P(t)) * t and
// m: t * t Montgomery elements of 8 words each.
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
