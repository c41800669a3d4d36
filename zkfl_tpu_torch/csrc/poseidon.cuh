// The Poseidon permutation over BN254 Fr (x^5 S-box, R_F = 8 full rounds,
// R_P(t) partial rounds: circomlib's parameters), one state per thread.
//
// Computes what one _round_body call of zkfl_tpu/ops/poseidon_pallas.py:85
// computes -- add the round constants to all t lanes, x^5 on every lane
// (full round) or on lane 0 (partial round), the MDS mix -- and the whole
// R_F/2 full | R_P partial | R_F/2 full sequence of rounds that
// poseidon_pallas.py:146-180 drives with a lax.scan of one pallas_call per
// round.  Here the loop over rounds runs inside the thread.
//
// Constants are Montgomery-form Fr elements of 8 little-endian words each,
// element after element: c holds the (R_F + R_P) * t round constants,
// round-major; m holds the t x t MDS matrix, row-major
// (zkfl_tpu_torch/poseidon/grain.py poseidon_params).  The mix is t^2
// Montgomery products, each reduced and added mod p (no lazy reduction), so
// every value stays canonical.
//
// __host__ __device__, like bn254.cuh, so that tests/test_torch_csrc.py
// checks this exact code with g++.
#pragma once

#include "bn254.cuh"

namespace zk {

constexpr int POSEIDON_RF = 8;

// circomlib's N_ROUNDS_P for t = 2 .. 17.
ZK_FN int poseidon_rp(int t) {
  const int v[16] = {56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68};
  return v[t - 2];
}

// x <- x^5: two squarings and a product.
ZK_FN void poseidon_sbox(uint32_t x[NL]) {
  uint32_t x2[NL], x4[NL];
  mont_sqr<Fr>(x2, x);
  mont_sqr<Fr>(x4, x2);
  mont_mul<Fr>(x, x4, x);
}

ZK_FN void load8(uint32_t r[NL], const uint32_t* x) {
#pragma unroll
  for (int w = 0; w < NL; ++w) r[w] = x[w];
}

// One round: s becomes M . sbox(s + c); o is scratch for the new lanes.
// The loops over lanes stay rolled (one copy of each Montgomery product in
// the code whatever t is), so s and o live in the thread's local memory
// rather than in registers: with every lane unrolled, t = 17 needed all 255
// registers, spilled, and took ptxas minutes per width.
template <int T>
ZK_FN void poseidon_round(uint32_t s[T][NL], uint32_t o[T][NL], const uint32_t* c,
                          const uint32_t* m, bool full) {
  uint32_t x[NL], k[NL];
#pragma unroll 1
  for (int j = 0; j < T; ++j) {
    load8(k, c + j * NL);
    add<Fr>(x, s[j], k);
    if (full || j == 0) poseidon_sbox(x);
    copy(s[j], x);
  }
#pragma unroll 1
  for (int i = 0; i < T; ++i) {
    uint32_t acc[NL];
#pragma unroll
    for (int w = 0; w < NL; ++w) acc[w] = 0;
#pragma unroll 1
    for (int j = 0; j < T; ++j) {
      load8(k, m + (i * T + j) * NL);
      mont_mul<Fr>(x, k, s[j]);
      add<Fr>(acc, acc, x);
    }
    copy(o[i], acc);
  }
#pragma unroll 1
  for (int j = 0; j < T; ++j) copy(s[j], o[j]);
}

// The whole permutation, in place on a canonical Montgomery state.
template <int T>
ZK_FN void poseidon_permute(uint32_t s[T][NL], const uint32_t* c, const uint32_t* m) {
  const int rp = poseidon_rp(T);
  const int half = POSEIDON_RF / 2;
  uint32_t o[T][NL];
#pragma unroll 1
  for (int r = 0; r < POSEIDON_RF + rp; ++r) {
    poseidon_round<T>(s, o, c + r * T * NL, m, r < half || r >= half + rp);
  }
}

}  // namespace zk
