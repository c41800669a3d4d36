// The Poseidon permutation over BN254 Fr (x^5 S-box, R_F = 8 full rounds,
// R_P(t) partial rounds: circomlib's parameters) in its optimized form, one
// state per thread.
//
// Computes what the rounds of zkfl_tpu/ops/poseidon_pallas.py:85
// (_round_body, one pallas_call per round under a lax.scan) compute, in the
// form of zkfl_tpu_torch/poseidon/optimized.py (the Poseidon paper's
// Appendix B, circomlib's poseidon.circom):
//   s += c0
//   R_F/2 full rounds:  x^5 on every lane, += d, mix with M (P last)
//   R_P partial rounds: x^5 on lane 0, += k on lane 0, the sparse mix
//                       s_0 = row . s, s_i += col_{i-1} s_0
//   R_F/2 full rounds:  x^5 on every lane, += d (not in the last), mix with M
// Constants are Montgomery-form Fr elements of 8 little-endian words each,
// element after element, in optimized.py's kernel_buffers order:
//   c = c0 (t), first-half d (R_F/2 x t), k (R_P), second-half d (R_F/2 - 1 x t)
//   m = M (t x t), P (t x t), per partial round its row (t) and column (t - 1).
//
// Every mixed output lane (a full round's t lanes, a partial round's lane 0)
// is a sum of t 512-bit products left unreduced and reduced once, as
// _round_body does with _emit_mul_wide_const and _emit_mont_reduce_multi;
// the partial rounds' lanes 1..t-1 take one product each.
//
// __host__ __device__, like bn254.cuh, so that tests/test_torch_csrc.py
// checks this exact code with g++; on the host the products are CIOS, on
// the card PTX carry chains (bn254.cuh field_mul, mul_wide_acc, redc_wide).
#pragma once

#include "bn254.cuh"

namespace zk {

constexpr int POSEIDON_RF = 8;

// circomlib's N_ROUNDS_P for t = 2 .. 17.
ZK_FN int poseidon_rp(int t) {
  const int v[16] = {56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68};
  return v[t - 2];
}

// Conditional subtractions after one reduction of a t-term sum of products
// of canonical elements: ceil(t p / R) (redc_wide's bound), bounded here by
// p < (p_7 + 1) 2^224 with p_7 = 0x30644e72 Fr's top word: 1 for t <= 5,
// 2 for t = 6..10, 3 for t = 11..15, 4 for t = 16, 17 -- the same counts as
// zkfl_tpu's _n_subs(t) (poseidon_pallas.py:64-68).  The sum itself is below
// t p^2 < 2^512 for t <= 17, so it fits the 16-word accumulator.
ZK_FN constexpr int poseidon_subs(int t) {
  return (int)(((uint64_t)t * 0x30644e73u + 0xffffffffu) >> 32);
}

// Lane loops are unrolled, and the state kept in registers, up to this
// width; above it they stay rolled and the state sits in local memory
// (poseidon.cu's note has ptxas's numbers behind the choice).
constexpr int POSEIDON_REG_MAX_T = 3;

template <int T>
ZK_FN constexpr int poseidon_lane_unroll() {
  return T <= POSEIDON_REG_MAX_T ? T : 1;
}

// An element of a constant buffer; on the card two 16-byte loads.
ZK_FN void load8(uint32_t r[NL], const uint32_t* x) {
#if defined(__CUDA_ARCH__)
  const uint4 lo = __ldg(reinterpret_cast<const uint4*>(x));
  const uint4 hi = __ldg(reinterpret_cast<const uint4*>(x) + 1);
  r[0] = lo.x, r[1] = lo.y, r[2] = lo.z, r[3] = lo.w;
  r[4] = hi.x, r[5] = hi.y, r[6] = hi.z, r[7] = hi.w;
#else
  for (int w = 0; w < NL; ++w) r[w] = x[w];
#endif
}

// x <- x^5: two squarings and a product.
ZK_FN void poseidon_sbox(uint32_t x[NL]) {
  uint32_t x2[NL], x4[NL];
  fr_mul(x2, x, x);
  fr_mul(x4, x2, x2);
  fr_mul(x, x4, x);
}

// r = sum_j k_j s_j mod p with one reduction: k_j is element j of k.
template <int T>
ZK_FN void poseidon_dot(uint32_t r[NL], const uint32_t* k, uint32_t s[][NL]) {
  constexpr int U = poseidon_lane_unroll<T>();
  uint32_t acc[2 * NL], kj[NL];
#pragma unroll
  for (int w = 0; w < 2 * NL; ++w) acc[w] = 0;
#pragma unroll(U)
  for (int j = 0; j < T; ++j) {
    load8(kj, k + j * NL);
    mul_wide_acc(acc, s[j], kj);
  }
  redc_wide<Fr, poseidon_subs(T)>(r, acc);
}

// A full round: x^5 on every lane, += d (if given), s = mat . s; o is
// scratch for the new lanes.
template <int T>
ZK_FN void poseidon_full(uint32_t s[T][NL], uint32_t o[T][NL], const uint32_t* d, const uint32_t* mat) {
  constexpr int U = poseidon_lane_unroll<T>();
  uint32_t k[NL];
#pragma unroll(U)
  for (int j = 0; j < T; ++j) {
    poseidon_sbox(s[j]);
    if (d != nullptr) {
      load8(k, d + j * NL);
      add<Fr>(s[j], s[j], k);
    }
  }
#pragma unroll(U)
  for (int i = 0; i < T; ++i) poseidon_dot<T>(o[i], mat + i * T * NL, s);
#pragma unroll(U)
  for (int j = 0; j < T; ++j) copy(s[j], o[j]);
}

// A partial round: x^5 and += k on lane 0, then the sparse mix; sp holds
// the row (t elements) then the column (t - 1).
template <int T>
ZK_FN void poseidon_partial(uint32_t s[T][NL], const uint32_t* k, const uint32_t* sp) {
  constexpr int U = poseidon_lane_unroll<T>();
  uint32_t x[NL], v[NL], s0[NL];
  poseidon_sbox(s[0]);
  load8(v, k);
  add<Fr>(s[0], s[0], v);
  poseidon_dot<T>(s0, sp, s);
#pragma unroll(U)
  for (int i = 1; i < T; ++i) {
    load8(v, sp + (T + i - 1) * NL);
    fr_mul(x, s[0], v);
    add<Fr>(s[i], s[i], x);
  }
  copy(s[0], s0);
}

// The whole permutation, in place on a canonical Montgomery state.
template <int T>
ZK_FN void poseidon_permute(uint32_t s[T][NL], const uint32_t* c, const uint32_t* m) {
  constexpr int U = poseidon_lane_unroll<T>();
  constexpr int H = POSEIDON_RF / 2;
  const int rp = poseidon_rp(T);
  alignas(16) uint32_t o[T][NL];
  uint32_t k[NL];
#pragma unroll(U)
  for (int j = 0; j < T; ++j) {
    load8(k, c + j * NL);
    add<Fr>(s[j], s[j], k);
  }
  const uint32_t* d = c + T * NL;
#pragma unroll 1
  for (int r = 0; r < H; ++r) poseidon_full<T>(s, o, d + r * T * NL, r < H - 1 ? m : m + T * T * NL);
  const uint32_t* kp = d + H * T * NL;
  const uint32_t* sp = m + 2 * T * T * NL;
#pragma unroll 1
  for (int j = 0; j < rp; ++j) poseidon_partial<T>(s, kp + j * NL, sp + j * (2 * T - 1) * NL);
  d = kp + rp * NL;
#pragma unroll 1
  for (int r = 0; r < H; ++r) poseidon_full<T>(s, o, r < H - 1 ? d + r * T * NL : nullptr, m);
}

}  // namespace zk
