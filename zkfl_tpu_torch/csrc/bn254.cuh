// BN254 field, G1 and G2 arithmetic shared by every kernel of zkfl_tpu_torch.
//
// Stands in for the Pallas emitters of zkfl_tpu/ops/limb_kernels.py:106-309
// (_emit_mul_wide, _emit_carry, _emit_mont_reduce, _emit_add, _emit_sub,
// _emit_cond_sub_const), for the RCB15 formulas of
// zkfl_tpu/ops/point_kernels.py:68-128 and for its Fq2 composition of
// padd_g2 / pdbl_g2 (:237-340).
//
// Layout: an element is 8 x 32-bit little-endian limbs in Montgomery form
// with R = 2^256, so its representative is the same integer as in
// zkfl_tpu's 16 x 16-bit layout.  The TPU emitters worked in 16-bit limbs
// because the TPU's vector unit has no 32x32->64 multiply; Hopper has one
// (IMAD.WIDE), so the multiply here is CIOS Montgomery with 64-bit partial
// products: 64 + 64 wide multiply-adds per product instead of 256 + 256.
//
// Every function is __host__ __device__ so that a host compiler can check the
// arithmetic without a card; tests/test_torch_csrc.py does that.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define ZK_FN __host__ __device__ __forceinline__
// Before a __host__ __device__ template that K6 instantiates with a
// device-only policy (Fq2Lane): no host instance of it exists.
#define ZK_HD_TEMPLATE _Pragma("nv_exec_check_disable")
#else
#define ZK_FN inline
#define ZK_HD_TEMPLATE
#endif

namespace zk {

constexpr int NL = 8;  // 32-bit limbs per element

// Moduli, -p^-1 mod 2^32, R^2 mod p, R mod p and MU = floor(2^288 / p),
// limbs little-endian.
struct Fr {
  static constexpr uint32_t NP0 = 0xefffffffu;
  static constexpr uint64_t MU = 0x54a474626ull;
  static ZK_FN uint32_t p(int i) {
    const uint32_t v[NL] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                            0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  static ZK_FN uint32_t r2(int i) {
    const uint32_t v[NL] = {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
                            0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u};
    return v[i];
  }
  static ZK_FN uint32_t r1(int i) {
    const uint32_t v[NL] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                            0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
};

struct Fq {
  static constexpr uint32_t NP0 = 0xe4866389u;
  static constexpr uint64_t MU = 0x54a474626ull;
  static ZK_FN uint32_t p(int i) {
    const uint32_t v[NL] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                            0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  static ZK_FN uint32_t r2(int i) {
    const uint32_t v[NL] = {0x538afa89u, 0xf32cfc5bu, 0xd44501fbu, 0xb5e71911u,
                            0x0a417ff6u, 0x47ab1effu, 0xcab8351fu, 0x06d89f71u};
    return v[i];
  }
  static ZK_FN uint32_t r1(int i) {
    const uint32_t v[NL] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                            0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
};

// 3*b for G1 (b = 3) in Fq Montgomery form: RCB15's b3.
ZK_FN uint32_t g1_b3(int i) {
  const uint32_t v[NL] = {0x410d7ff7u, 0xf60647ceu, 0xd31bd011u, 0x2f3d6f4du,
                          0x3940c6d1u, 0x2943337eu, 0xa7e39857u, 0x1d9598e8u};
  return v[i];
}

struct Limbs {  // an element by value: a kernel argument, a point coordinate
  uint32_t v[NL];
};

ZK_FN void copy(uint32_t r[NL], const uint32_t a[NL]) {
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = a[j];
}

// r = t - p when (top != 0 or t >= p), else t.  t + top*2^256 < 2p.
template <class F>
ZK_FN void cond_sub(uint32_t r[NL], const uint32_t t[NL], uint32_t top) {
  uint32_t d[NL];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    uint64_t s = (uint64_t)t[j] - F::p(j) - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool use_d = (top != 0) | (borrow == 0);
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = use_d ? d[j] : t[j];
}

// a * b * R^-1 mod p (CIOS).  Canonical output for a < 2^256, b < p.
template <class F>
ZK_FN void mont_mul(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
  uint32_t t[NL + 2];
#pragma unroll
  for (int j = 0; j < NL + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      c += (uint64_t)a[j] * b[i] + t[j];  // <= 2^64 - 1
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NL];
    t[NL] = (uint32_t)c;
    t[NL + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * F::NP0;
    c = ((uint64_t)m * F::p(0) + t[0]) >> 32;  // low word is 0 by choice of m
#pragma unroll
    for (int j = 1; j < NL; ++j) {
      c += (uint64_t)m * F::p(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NL];
    t[NL - 1] = (uint32_t)c;
    t[NL] = t[NL + 1] + (uint32_t)(c >> 32);
  }
  cond_sub<F>(r, t, t[NL]);
}

// sum_k a_k b_k R^-1 mod p over K products reduced once (CIOS with the K
// products' rows added before each reduction row).  For a_k < p and any
// b_k < 2^256 the accumulator stays below (K + 1) p after each row's shift
// and below (K + 1)(2^32 + 1) p within a row, which is below 2^288 while
// (K + 1) p (1 + 2^-32) < R: K <= 4 for Fr and Fq (p < 0.19 R).  For b_k <= p
// the result before the last subtraction is below p (1 + K p / R) < 2p.
// Canonical output.
template <class F, int K>
ZK_FN void mont_sum(uint32_t r[NL], const uint32_t* const a[K], const uint32_t* const b[K]) {
  uint32_t t[NL + 1];
#pragma unroll
  for (int j = 0; j <= NL; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      uint64_t c = 0;
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        c += (uint64_t)a[k][j] * b[k][i] + t[j];
        t[j] = (uint32_t)c;
        c >>= 32;
      }
      t[NL] += (uint32_t)c;  // the accumulator stays below 2^288
    }
    const uint32_t m = t[0] * F::NP0;
    uint64_t c = ((uint64_t)m * F::p(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NL; ++j) {
      c += (uint64_t)m * F::p(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NL];
    t[NL - 1] = (uint32_t)c;
    t[NL] = (uint32_t)(c >> 32);
  }
  cond_sub<F>(r, t, t[NL]);
}

#if defined(__CUDA_ARCH__)
// ---------------------------------------------------------------------------
// The point kernels' Montgomery product on the card: CIOS on PTX carry
// chains with even/odd columns.  The accumulator T is two arrays, X at word
// positions 0..8 and Y at 1..8, plus a pending word P at position 0:
// T = X + Y 2^32 + P.  Per word b[i], the products of a's even limbs go into
// X and those of its odd limbs into Y, so that in each chain the low and the
// high half of one 32 x 32 product land on two neighbouring words
// (mad.lo.cc then madc.hi.cc with the same operands); likewise m * p.  The
// word shift of CIOS is a renaming: the new X is Y, the new Y is X[2..8],
// and X[1] becomes P, which the next Y chain adds in (its carry lands on
// Y[0], the next position).  Each chain is one asm statement: the carry
// flag does not survive between statements.  For a < p and b < 2^256, T
// stays below 2^288 within a step and below 2p after it (the C form's
// bound), so X fits 9 words, Y 8 (Y 2^32 <= T), and no chain carries out
// of its last word.
// ---------------------------------------------------------------------------

// x[0..8] += (e0, e1, e2, e3) * y, e_k's 64-bit product on words 2k, 2k+1;
// the carry goes into x[8].
__device__ __forceinline__ void mac_even(uint32_t x[NL + 1], uint32_t e0, uint32_t e1, uint32_t e2,
                                         uint32_t e3, uint32_t y) {
  asm("mad.lo.cc.u32  %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32       %8, %8, 0;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]), "+r"(x[6]),
        "+r"(x[7]), "+r"(x[8])
      : "r"(e0), "r"(e1), "r"(e2), "r"(e3), "r"(y));
}

// y8[0..7] += (o0, o1, o2, o3) * y on word pairs as above, after
// x0 += pend with its carry into y8[0]; nothing carries out of y8[7].
__device__ __forceinline__ void mac_odd(uint32_t y8[NL], uint32_t& x0, uint32_t pend, uint32_t o0,
                                        uint32_t o1, uint32_t o2, uint32_t o3, uint32_t y) {
  asm("add.cc.u32     %8, %8, %9;\n\t"
      "madc.lo.cc.u32 %0, %10, %14, %0;\n\t"
      "madc.hi.cc.u32 %1, %10, %14, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %14, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %14, %3;\n\t"
      "madc.lo.cc.u32 %4, %12, %14, %4;\n\t"
      "madc.hi.cc.u32 %5, %12, %14, %5;\n\t"
      "madc.lo.cc.u32 %6, %13, %14, %6;\n\t"
      "madc.hi.u32    %7, %13, %14, %7;"
      : "+r"(y8[0]), "+r"(y8[1]), "+r"(y8[2]), "+r"(y8[3]), "+r"(y8[4]), "+r"(y8[5]),
        "+r"(y8[6]), "+r"(y8[7]), "+r"(x0)
      : "r"(pend), "r"(o0), "r"(o1), "r"(o2), "r"(o3), "r"(y));
}

// r = t - p when t >= p, else t, for t < 2p: one borrow chain and selects.
template <class F>
__device__ __forceinline__ void cond_sub_cc(uint32_t r[NL], const uint32_t t[NL]) {
  uint32_t d[NL], under;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %25, %25;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]),
        "=r"(d[7]), "=r"(under)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]), "r"(t[7]),
        "r"(F::p(0)), "r"(F::p(1)), "r"(F::p(2)), "r"(F::p(3)), "r"(F::p(4)), "r"(F::p(5)),
        "r"(F::p(6)), "r"(F::p(7)), "r"(0u));
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = under ? t[j] : d[j];
}

// T /= 2^32 in the even/odd accumulator: X[1] -> P, Y -> X, X[2..8] -> Y.
__device__ __forceinline__ void cc_shift(uint32_t x[NL + 1], uint32_t y[NL], uint32_t& pend) {
  pend = x[1];
  uint32_t nx[NL + 1], ny[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) nx[j] = y[j];
  nx[NL] = 0;
#pragma unroll
  for (int j = 0; j < NL - 1; ++j) ny[j] = x[j + 2];
  ny[NL - 1] = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    x[j] = nx[j];
    y[j] = ny[j];
  }
  x[NL] = nx[NL];
}

// r = X + Y 2^32 + P reduced, for X + Y 2^32 + P < 2p.
template <class F>
__device__ __forceinline__ void cc_finish(uint32_t r[NL], const uint32_t x[NL + 1], const uint32_t y[NL],
                                          uint32_t pend) {
  uint32_t t[NL];
  asm("add.cc.u32  %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"
      : "=r"(t[0]), "=r"(t[1]), "=r"(t[2]), "=r"(t[3]), "=r"(t[4]), "=r"(t[5]), "=r"(t[6]),
        "=r"(t[7])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]), "r"(x[6]), "r"(x[7]),
        "r"(pend), "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]), "r"(y[6]));
  cond_sub_cc<F>(r, t);
}

// a * b * R^-1 mod p for a < p, b < 2^256; canonical output, the same
// integer as mont_mul's.
template <class F>
__device__ __forceinline__ void mont_mul_cc(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
  uint32_t x[NL + 1], y[NL], pend = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) x[j] = y[j] = 0;
  x[NL] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    mac_odd(y, x[0], pend, a[1], a[3], a[5], a[7], b[i]);
    mac_even(x, a[0], a[2], a[4], a[6], b[i]);
    const uint32_t m = x[0] * F::NP0;
    mac_even(x, F::p(0), F::p(2), F::p(4), F::p(6), m);  // x[0] becomes 0
    mac_odd(y, x[0], 0u, F::p(1), F::p(3), F::p(5), F::p(7), m);
    cc_shift(x, y, pend);
  }
  cc_finish<F>(r, x, y, pend);  // T = X + Y 2^32 + P < 2p
}

// T += a * w, one row of a product (P added into word 0 first).
__device__ __forceinline__ void cc_row(uint32_t x[NL + 1], uint32_t y[NL], uint32_t pend,
                                       const uint32_t a[NL], uint32_t w) {
  mac_odd(y, x[0], pend, a[1], a[3], a[5], a[7], w);
  mac_even(x, a[0], a[2], a[4], a[6], w);
}

// T = (T + m p) / 2^32 with m chosen so that word 0 of the sum is 0.
template <class F>
__device__ __forceinline__ void cc_reduce_row(uint32_t x[NL + 1], uint32_t y[NL], uint32_t& pend) {
  const uint32_t m = x[0] * F::NP0;
  mac_even(x, F::p(0), F::p(2), F::p(4), F::p(6), m);  // x[0] becomes 0
  mac_odd(y, x[0], 0u, F::p(1), F::p(3), F::p(5), F::p(7), m);
  cc_shift(x, y, pend);
}

// (a0 b0 + a1 b1) R^-1 and (a0 b0 + ... + a3 b3) R^-1 mod p: mont_mul_cc
// with two or four products added into each row before its one reduction
// row, the sum reduced once (mont_sum's bounds; canonical output).
template <class F>
__device__ __forceinline__ void mont_sum2_cc(uint32_t r[NL], const uint32_t a0[NL],
                                             const uint32_t b0[NL], const uint32_t a1[NL],
                                             const uint32_t b1[NL]) {
  uint32_t x[NL + 1], y[NL], pend = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) x[j] = y[j] = 0;
  x[NL] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    cc_row(x, y, pend, a0, b0[i]);
    cc_row(x, y, 0u, a1, b1[i]);
    cc_reduce_row<F>(x, y, pend);
  }
  cc_finish<F>(r, x, y, pend);
}

template <class F>
__device__ __forceinline__ void mont_sum4_cc(uint32_t r[NL], const uint32_t a0[NL],
                                             const uint32_t b0[NL], const uint32_t a1[NL],
                                             const uint32_t b1[NL], const uint32_t a2[NL],
                                             const uint32_t b2[NL], const uint32_t a3[NL],
                                             const uint32_t b3[NL]) {
  uint32_t x[NL + 1], y[NL], pend = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) x[j] = y[j] = 0;
  x[NL] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    cc_row(x, y, pend, a0, b0[i]);
    cc_row(x, y, 0u, a1, b1[i]);
    cc_row(x, y, 0u, a2, b2[i]);
    cc_row(x, y, 0u, a3, b3[i]);
    cc_reduce_row<F>(x, y, pend);
  }
  cc_finish<F>(r, x, y, pend);
}

// a * R^-1 mod p for any a < 2^256 (Montgomery reduction alone, the
// product by 1 without its multiplies): the loop of mont_mul_cc with T = a
// at the start and no a * b_i rows, the pending word added in the m * p
// chain.  T < 2^256 + 2^32 p < 2^288 within the first step, below
// 2^224 + p after it, and at the end (a + m p) / R < p + 1.
template <class F>
__device__ __forceinline__ void redc_cc(uint32_t r[NL], const uint32_t a[NL]) {
  uint32_t x[NL + 1], y[NL], pend = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    x[j] = a[j];
    y[j] = 0;
  }
  x[NL] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t m = (x[0] + pend) * F::NP0;
    mac_even(x, F::p(0), F::p(2), F::p(4), F::p(6), m);
    mac_odd(y, x[0], pend, F::p(1), F::p(3), F::p(5), F::p(7), m);  // x[0] becomes 0
    cc_shift(x, y, pend);
  }
  cc_finish<F>(r, x, y, pend);
}

// a[0..7] += b[0..7]; returns the carry out.  The carry lands in a tied
// operand that starts at 0, and the asm takes no untied input besides b:
// where a is a compile-time 0 (a sum's first term), the compiler may give
// an untied input of the same value the register of a tied one, which the
// chain overwrites before the last instruction reads it.
__device__ __forceinline__ uint32_t add8_co(uint32_t a[NL], const uint32_t b[NL]) {
  uint32_t c = 0;
  asm("add.cc.u32  %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32    %8, %8, 0;"
      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]), "+r"(a[6]),
        "+r"(a[7]), "+r"(c)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return c;
}

// a[0..7] += b[0..7] + c for c in {0, 1}; the carry out is dropped (the
// callers' bounds make it 0).
__device__ __forceinline__ void add8_ci(uint32_t a[NL], const uint32_t b[NL], uint32_t c) {
  asm("add.cc.u32  %8, %8, 0xffffffff;\n\t"  // sets the carry flag iff c != 0
      "addc.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.u32    %7, %7, %16;"
      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]), "+r"(a[6]),
        "+r"(a[7]), "+r"(c)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// acc[0..15] += a * b (512 bits), for acc + a * b < 2^512.  The product is
// built fresh on even/odd columns (E at word positions 0..15, O at 1..16):
// before row i, E holds a_even * (b_0..b_i-1) < 2^(256 + 32 i), which fits
// words 0..i+7, so row i's carry into word i + 8 never carries further;
// likewise O.  Then two add chains put E and O 2^32 into acc (O[16] is 0:
// O 2^32 <= a * b < 2^512).
__device__ __forceinline__ void mul_wide_acc_cc(uint32_t acc[2 * NL], const uint32_t a[NL],
                                                const uint32_t b[NL]) {
  uint32_t e[2 * NL], o[2 * NL + 1];
#pragma unroll
  for (int j = 0; j < 2 * NL; ++j) e[j] = o[j] = 0;
  o[2 * NL] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    mac_even(e + i, a[0], a[2], a[4], a[6], b[i]);
    mac_even(o + i + 1, a[1], a[3], a[5], a[7], b[i]);
  }
  add8_ci(acc + NL, e + NL, add8_co(acc, e));
  add8_ci(acc + NL, o + NL, add8_co(acc, o));
}
#endif  // __CUDA_ARCH__

// The Fq product of the point formulas (K4, K6): the carry-chain form on
// the card, the CIOS form above on the host, where g++ checks the formulas.
ZK_FN void fq_mul(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
#if defined(__CUDA_ARCH__)
  mont_mul_cc<Fq>(r, a, b);
#else
  mont_mul<Fq>(r, a, b);
#endif
}

// The Fq sums of two and of four products of K6's lazy Fq2, reduced once:
// the carry-chain forms on the card, mont_sum on the host.
ZK_FN void fq_sum2(uint32_t r[NL], const uint32_t a0[NL], const uint32_t b0[NL], const uint32_t a1[NL],
                   const uint32_t b1[NL]) {
#if defined(__CUDA_ARCH__)
  mont_sum2_cc<Fq>(r, a0, b0, a1, b1);
#else
  const uint32_t* a[2] = {a0, a1};
  const uint32_t* b[2] = {b0, b1};
  mont_sum<Fq, 2>(r, a, b);
#endif
}

ZK_FN void fq_sum4(uint32_t r[NL], const uint32_t a0[NL], const uint32_t b0[NL], const uint32_t a1[NL],
                   const uint32_t b1[NL], const uint32_t a2[NL], const uint32_t b2[NL],
                   const uint32_t a3[NL], const uint32_t b3[NL]) {
#if defined(__CUDA_ARCH__)
  mont_sum4_cc<Fq>(r, a0, b0, a1, b1, a2, b2, a3, b3);
#else
  const uint32_t* a[4] = {a0, a1, a2, a3};
  const uint32_t* b[4] = {b0, b1, b2, b3};
  mont_sum<Fq, 4>(r, a, b);
#endif
}

// The product of K1 and K5, for a < 2^256 and b < p: the carry-chain form
// on the card (operands swapped to meet its a < p), CIOS on the host.  K2
// keeps mont_mul on both.
template <class F>
ZK_FN void field_mul(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
#if defined(__CUDA_ARCH__)
  mont_mul_cc<F>(r, b, a);
#else
  mont_mul<F>(r, a, b);
#endif
}

ZK_FN void fr_mul(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) { field_mul<Fr>(r, a, b); }

// a * R^-1 mod p for any a < 2^256, canonical: redc_cc on the card, the
// CIOS product by 1 on the host.
template <class F>
ZK_FN void field_redc(uint32_t r[NL], const uint32_t a[NL]) {
#if defined(__CUDA_ARCH__)
  redc_cc<F>(r, a);
#else
  uint32_t one[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) one[j] = j == 0 ? 1u : 0u;
  mont_mul<F>(r, a, one);
#endif
}

// r = t - p when t >= p, else t, for any t < 2^256 (t >= 2p stays >= p).
template <class F>
ZK_FN void sub_p_if_geq(uint32_t r[NL], const uint32_t t[NL]) {
#if defined(__CUDA_ARCH__)
  cond_sub_cc<F>(r, t);
#else
  cond_sub<F>(r, t, 0u);
#endif
}

// acc[0..15] += a * b, the 512-bit product unreduced, for acc + a * b < 2^512.
ZK_FN void mul_wide_acc(uint32_t acc[2 * NL], const uint32_t a[NL], const uint32_t b[NL]) {
#if defined(__CUDA_ARCH__)
  mul_wide_acc_cc(acc, a, b);
#else
  uint32_t w[2 * NL] = {0};
  for (int i = 0; i < NL; ++i) {
    uint64_t c = 0;
    for (int j = 0; j < NL; ++j) {
      c += (uint64_t)a[j] * b[i] + w[i + j];
      w[i + j] = (uint32_t)c;
      c >>= 32;
    }
    w[i + NL] = (uint32_t)c;
  }
  uint64_t c = 0;
  for (int j = 0; j < 2 * NL; ++j) {
    c += (uint64_t)acc[j] + w[j];
    acc[j] = (uint32_t)c;
    c >>= 32;
  }
#endif
}

// One Montgomery reduction of a sum of products, acc < t p^2 for NSUB =
// ceil(t p / R) (see poseidon_subs): acc R^-1 = lo R^-1 + hi for
// acc = lo + hi R, lo R^-1 < p after field_redc and hi < t p^2 / R, so
// u = lo R^-1 + hi < p (1 + t p / R) < 2^256 and NSUB subtractions of p
// bring it below p.
template <class F, int NSUB>
ZK_FN void redc_wide(uint32_t r[NL], const uint32_t acc[2 * NL]) {
  field_redc<F>(r, acc);
#if defined(__CUDA_ARCH__)
  add8_ci(r, acc + NL, 0u);
#else
  uint64_t c = 0;
  for (int j = 0; j < NL; ++j) {
    c += (uint64_t)r[j] + acc[NL + j];
    r[j] = (uint32_t)c;
    c >>= 32;
  }
#endif
#pragma unroll
  for (int k = 0; k < NSUB; ++k) sub_p_if_geq<F>(r, r);
}

// a^2 * R^-1 mod p: the Montgomery product of a with itself, as
// PallasField._k_mont_sqr (zkfl_tpu/ops/limb_kernels.py:360) reuses the
// multiply's emitter.  Canonical output for canonical a.
template <class F>
ZK_FN void mont_sqr(uint32_t r[NL], const uint32_t a[NL]) {
  mont_mul<F>(r, a, a);
}

// (a + b) mod p for canonical a, b.
template <class F>
ZK_FN void add(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
  uint32_t s[NL];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  cond_sub<F>(r, s, (uint32_t)c);
}

// (a - b) mod p for canonical a, b: subtract with borrow, add p back on borrow.
template <class F>
ZK_FN void sub(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
  uint32_t d[NL];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    c += (uint64_t)d[j] + (F::p(j) & mask);
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

template <class F>
ZK_FN void to_mont(uint32_t r[NL], const uint32_t a[NL]) {
  uint32_t r2[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) r2[j] = F::r2(j);
  mont_mul<F>(r, a, r2);
}

template <class F>
ZK_FN void from_mont(uint32_t r[NL], const uint32_t a[NL]) {
  uint32_t one[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) one[j] = j == 0 ? 1u : 0u;
  mont_mul<F>(r, a, one);
}

// The high 64 bits of a * b.
ZK_FN uint64_t mulhi64(uint64_t a, uint64_t b) {
#if defined(__CUDA_ARCH__)
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// Raw per-limb column sums of Montgomery terms -> canonical Montgomery form:
// T mod p for T = sum_j cols[j] 2^(32 j), each 0 <= cols[j] < 2^63 (sums of
// at most 2^31 32-bit limbs).  A fold and one quotient step, about 20
// multiply-adds:
//  1. Carry the columns into lo (8 words) and top: T = lo + top 2^256 with
//     top <= 2^31, as T < 2^63 (2^256 - 1) / (2^32 - 1) < (2^31 + 1) 2^256.
//  2. Fold: s = lo + top (R mod p) == T mod p, s < 2^256 + 2^31 p < 2^32 p:
//     9 words, 8 multiply-adds.
//  3. Quotient: x = floor(s / 2^224) < 2^61 and q = floor(x MU / 2^64)
//     with MU = floor(2^288 / p) = 2^288 / p - e, 0 <= e < 1.  Then
//     q <= x 2^224 / p <= s / p, and s / p - x MU / 2^64 = (s mod 2^224) / p
//     + x e / 2^64 < 2^-29 + 1/8 < 1, so floor(s / p) - q is 0 or 1:
//     s - q p < 2p, and one conditional subtraction makes it canonical.
//     q < 2^31 + 6 fits a word; q p is 8 multiply-adds.
template <class F>
ZK_FN void normalize_raw(uint32_t r[NL], const int64_t cols[NL]) {
  uint32_t s[NL + 1];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    c += (uint64_t)cols[j];  // < 2^63 + 2^32
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  const uint32_t top = (uint32_t)c;
  c = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    c += (uint64_t)top * F::r1(j) + s[j];  // < 2^64
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  s[NL] = (uint32_t)c;
  const uint32_t q = (uint32_t)mulhi64(((uint64_t)s[NL] << 32) | s[NL - 1], F::MU);
  uint64_t m = 0;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {  // s -= q p; word NL becomes 0 (s - q p < 2p < 2^256)
    m += (uint64_t)q * F::p(j);
    const uint64_t d = (uint64_t)s[j] - (uint32_t)m - borrow;
    m >>= 32;
    s[j] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  sub_p_if_geq<F>(r, s);
}

// ---------------------------------------------------------------------------
// Complete projective formulas of Renes-Costello-Batina 2015 for a = 0
// (algorithms 7 and 9), written once over a field policy E: E::El is an
// element, and E acts on it with
//   mul(r, a, b)            r = a b
//   sqr(r, a)               r = a^2
//   mul_add(r, a, b, c, d)  r = a b + c d
//   mul_sub(r, a, b, c, d)  r = a b - c d
//   mul_b3(r, a)            r = 3b a (b the curve's constant)
//   add(r, a, b), sub(r, a, b).
// The sums of two products are ops of their own so that a policy may reduce
// once per sum (K6's lazy Fq2); FqPoint (K4) reduces each product, then
// adds.  Branchless; the identity is (0:1:0) and P + P, P + (-P) and sums
// with the identity come out right.  The operation order is that of
// zkfl_tpu's _padd_kernel / _pdbl_kernel and padd_g2 / pdbl_g2; every value
// is canonical, so each policy gives the same integers.
// ---------------------------------------------------------------------------

template <class E>
struct Proj {
  typename E::El x, y, z;
};

// RCB15 algorithm 7: o = p + q (o may not alias p or q).
ZK_HD_TEMPLATE
template <class E>
ZK_FN void rcb_padd(const E& e, Proj<E>& o, const Proj<E>& p, const Proj<E>& q) {
  typename E::El t0, t1, t2, t3, t4, y3, u, v;
  e.mul(t0, p.x, q.x);
  e.mul(t1, p.y, q.y);
  e.mul(t2, p.z, q.z);
  e.add(u, p.x, p.y);
  e.add(v, q.x, q.y);
  e.mul(t3, u, v);
  e.add(u, t0, t1);
  e.sub(t3, t3, u);  // X1Y2 + X2Y1
  e.add(u, p.y, p.z);
  e.add(v, q.y, q.z);
  e.mul(t4, u, v);
  e.add(u, t1, t2);
  e.sub(t4, t4, u);  // Y1Z2 + Y2Z1
  e.add(u, p.x, p.z);
  e.add(v, q.x, q.z);
  e.mul(y3, u, v);
  e.add(u, t0, t2);
  e.sub(y3, y3, u);  // X1Z2 + X2Z1
  typename E::El t00, t2b, y3b, z3a, t1b;
  e.add(t00, t0, t0);
  e.add(t00, t00, t0);  // 3 X1X2
  e.mul_b3(t2b, t2);    // b3 Z1Z2
  e.mul_b3(y3b, y3);    // b3 (X1Z2 + X2Z1)
  e.add(z3a, t1, t2b);  // Y1Y2 + b3 Z1Z2
  e.sub(t1b, t1, t2b);  // Y1Y2 - b3 Z1Z2
  e.mul_sub(o.x, t3, t1b, t4, y3b);
  e.mul_add(o.y, t1b, z3a, t00, y3b);
  e.mul_add(o.z, z3a, t4, t00, t3);
}

// RCB15 algorithm 9: o = 2p (o may not alias p).
ZK_HD_TEMPLATE
template <class E>
ZK_FN void rcb_pdbl(const E& e, Proj<E>& o, const Proj<E>& p) {
  typename E::El t0, t1, zz, xy, z3, t2, y3, t2s;
  e.sqr(t0, p.y);
  e.mul(t1, p.y, p.z);
  e.sqr(zz, p.z);
  e.mul(xy, p.x, p.y);
  e.add(z3, t0, t0);
  e.add(z3, z3, z3);
  e.add(z3, z3, z3);  // 8 Y^2
  e.mul_b3(t2, zz);   // b3 Z^2
  e.add(y3, t0, t2);
  e.add(t2s, t2, t2);
  e.add(t2s, t2s, t2);  // 3 b3 Z^2
  e.sub(t0, t0, t2s);
  typename E::El x3h;
  e.mul_add(o.y, t2, z3, t0, y3);
  e.mul(o.z, t1, z3);
  e.mul(x3h, t0, xy);
  e.add(o.x, x3h, x3h);
}

// ---------------------------------------------------------------------------
// G1 over Fq: b3 = 3b = 9.
// ---------------------------------------------------------------------------

struct FqPoint {
  using El = Limbs;
  ZK_FN void mul(El& r, const El& a, const El& b) const { fq_mul(r.v, a.v, b.v); }
  ZK_FN void sqr(El& r, const El& a) const { fq_mul(r.v, a.v, a.v); }
  ZK_FN void add(El& r, const El& a, const El& b) const { zk::add<Fq>(r.v, a.v, b.v); }
  ZK_FN void sub(El& r, const El& a, const El& b) const { zk::sub<Fq>(r.v, a.v, b.v); }
  ZK_FN void mul_add(El& r, const El& a, const El& b, const El& c, const El& d) const {
    El u, v;
    mul(u, a, b);
    mul(v, c, d);
    add(r, u, v);
  }
  ZK_FN void mul_sub(El& r, const El& a, const El& b, const El& c, const El& d) const {
    El u, v;
    mul(u, a, b);
    mul(v, c, d);
    sub(r, u, v);
  }
  ZK_FN void mul_b3(El& r, const El& a) const {
    El k;
#pragma unroll
    for (int j = 0; j < NL; ++j) k.v[j] = g1_b3(j);
    mul(r, a, k);
  }
};

using G1 = Proj<FqPoint>;  // 24 words: X, Y, Z

ZK_FN void g1_padd(G1& o, const G1& p, const G1& q) { rcb_padd(FqPoint{}, o, p, q); }
ZK_FN void g1_pdbl(G1& o, const G1& p) { rcb_pdbl(FqPoint{}, o, p); }

// ---------------------------------------------------------------------------
// G2 over Fq2 = Fq[u] / (u^2 + 1), one coefficient at a time.  K6 splits a
// point over two threads: each computes coefficient c0 (mask c1 = 0) or c1
// (c1 = ~0) of every value, from its own coefficients of the operands (a,
// b, ...) and its partner's (ap, bp, ...).  Operands and results are picked
// with the mask, not a branch, so that both halves of a warp run one path
// (K6 keeps the mask opaque to the compiler, so that it cannot specialise
// the code per half).
//
// Lazy products: a coefficient of a product, or of a sum of two products,
// is a sum of 2 or 4 Fq products reduced once (fq_sum2, fq_sum4: CIOS with
// every product's row added before the one reduction row, 64 multiply-adds
// a product and 72 for the reduction, as for a sum of 512-bit products and
// one redc_wide, without the 16-word sum).  The minus sign of c0 = a0 b0 -
// a1 b1 goes onto an operand, a1 (p - b1), so that every term is a product
// x y with x < p and y <= p, below p^2, and a sum of t terms below t p^2;
// for Fq and t <= 4 the accumulator fits and the result needs one
// conditional subtraction (mont_sum's bounds).
// ---------------------------------------------------------------------------

// r = p - a for a <= p: r <= p, and r = p for a = 0 (an operand of a lazy
// product, not a canonical element).
template <class F>
ZK_FN void p_minus(uint32_t r[NL], const uint32_t a[NL]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const uint64_t s = (uint64_t)F::p(j) - a[j] - borrow;
    r[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
}

// r = x where c1 = 0, y where c1 = ~0 (r may alias x or y).
ZK_FN void pick(uint32_t r[NL], uint32_t c1, const uint32_t x[NL], const uint32_t y[NL]) {
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = x[j] ^ ((x[j] ^ y[j]) & c1);
}

// The second factors of this thread's coefficient of (a0 + a1 u)(b0 + b1 u)
// = a x + ap y:
//   c0: a0 b0 + a1 (p - b1)        c1: a1 b0 + a0 b1
// so x = b0 and y = p - b1 | b1, both <= p.
ZK_FN void fq2_factors_half(uint32_t x[NL], uint32_t y[NL], uint32_t c1, const uint32_t b[NL],
                            const uint32_t bp[NL]) {
  pick(x, c1, b, bp);
  p_minus<Fq>(y, bp);
  pick(y, c1, y, b);
}

// r = this thread's coefficient of a b: a sum of 2 products, 1 reduction.
ZK_FN void fq2_mul_half(uint32_t r[NL], uint32_t c1, const uint32_t a[NL], const uint32_t b[NL],
                        const uint32_t ap[NL], const uint32_t bp[NL]) {
  uint32_t x[NL], y[NL];
  fq2_factors_half(x, y, c1, b, bp);
  fq_sum2(r, a, x, ap, y);  // below 2 p^2 before the reduction
}

// r = this thread's coefficient of a b + c d: a sum of 4 products, 1
// reduction.
ZK_FN void fq2_mul_add_half(uint32_t r[NL], uint32_t c1, const uint32_t a[NL], const uint32_t b[NL],
                            const uint32_t c[NL], const uint32_t d[NL], const uint32_t ap[NL],
                            const uint32_t bp[NL], const uint32_t cp[NL], const uint32_t dp[NL]) {
  uint32_t x[NL], y[NL], z[NL], w[NL];
  fq2_factors_half(x, y, c1, b, bp);
  fq2_factors_half(z, w, c1, d, dp);
  fq_sum4(r, a, x, ap, y, c, z, cp, w);  // below 4 p^2 < p R before the reduction
}

// r = this thread's coefficient of a^2, one product:
//   c0: (a0 + a1)(a0 - a1)        c1: (a1 + a1) a0
ZK_FN void fq2_sqr_half(uint32_t r[NL], uint32_t c1, const uint32_t a[NL], const uint32_t ap[NL]) {
  uint32_t x[NL], y[NL];
  pick(x, c1, ap, a);
  add<Fq>(x, a, x);
  sub<Fq>(y, a, ap);
  pick(y, c1, y, ap);
  fq_mul(r, x, y);
}

// Limb i of 9/82 in Fq Montgomery form (9 * 82^-1 * R mod p).  The twist's
// b' = 3 / (9 + u), so b3 = 3 b' = 9 (9 - u) / ((9 + u)(9 - u)) =
// (9/82)(9 - u).
ZK_FN uint32_t g2_b3_scale(int i) {
  const uint32_t v[NL] = {0x62e5ff12u, 0x9168c5b0u, 0xad07a2d2u, 0x65af5018u,
                          0x197d565eu, 0x3272d31fu, 0x01f7f840u, 0x2c9f2108u};
  return v[i];
}

// r = this thread's coefficient of b3 a = (9/82)((9 a0 + a1) + (9 a1 - a0) u):
// additions, then one product by the constant 9/82.
ZK_FN void fq2_mul_b3_half(uint32_t r[NL], uint32_t c1, const uint32_t a[NL], const uint32_t ap[NL]) {
  uint32_t n[NL], s[NL], d[NL];
  add<Fq>(n, a, a);
  add<Fq>(n, n, n);
  add<Fq>(n, n, n);
  add<Fq>(n, n, a);  // 9 a
  add<Fq>(s, n, ap);
  sub<Fq>(d, n, ap);
  pick(s, c1, s, d);  // 9 a0 + a1 | 9 a1 - a0
#pragma unroll
  for (int j = 0; j < NL; ++j) n[j] = g2_b3_scale(j);
  fq_mul(r, s, n);
}

// Both coefficients in one thread (El = c0, c1): the host's G2 arithmetic,
// which tests/test_torch_csrc.py runs with g++.  It computes each
// coefficient as K6's thread that holds it does, without the exchange.
struct Fq2Pair {
  struct El {
    uint32_t c[2][NL];
  };
  ZK_FN void mul(El& r, const El& a, const El& b) const {
    El t;
    fq2_mul_half(t.c[0], 0u, a.c[0], b.c[0], a.c[1], b.c[1]);
    fq2_mul_half(t.c[1], ~0u, a.c[1], b.c[1], a.c[0], b.c[0]);
    r = t;
  }
  ZK_FN void sqr(El& r, const El& a) const {
    El t;
    fq2_sqr_half(t.c[0], 0u, a.c[0], a.c[1]);
    fq2_sqr_half(t.c[1], ~0u, a.c[1], a.c[0]);
    r = t;
  }
  ZK_FN void mul_add(El& r, const El& a, const El& b, const El& c, const El& d) const {
    El t;
    fq2_mul_add_half(t.c[0], 0u, a.c[0], b.c[0], c.c[0], d.c[0], a.c[1], b.c[1], c.c[1], d.c[1]);
    fq2_mul_add_half(t.c[1], ~0u, a.c[1], b.c[1], c.c[1], d.c[1], a.c[0], b.c[0], c.c[0], d.c[0]);
    r = t;
  }
  ZK_FN void mul_sub(El& r, const El& a, const El& b, const El& c, const El& d) const {
    El n;  // -d, coefficient by coefficient, each <= p
    p_minus<Fq>(n.c[0], d.c[0]);
    p_minus<Fq>(n.c[1], d.c[1]);
    mul_add(r, a, b, c, n);
  }
  ZK_FN void add(El& r, const El& a, const El& b) const {
    zk::add<Fq>(r.c[0], a.c[0], b.c[0]);
    zk::add<Fq>(r.c[1], a.c[1], b.c[1]);
  }
  ZK_FN void sub(El& r, const El& a, const El& b) const {
    zk::sub<Fq>(r.c[0], a.c[0], b.c[0]);
    zk::sub<Fq>(r.c[1], a.c[1], b.c[1]);
  }
  ZK_FN void mul_b3(El& r, const El& a) const {
    El t;
    fq2_mul_b3_half(t.c[0], 0u, a.c[0], a.c[1]);
    fq2_mul_b3_half(t.c[1], ~0u, a.c[1], a.c[0]);
    r = t;
  }
};

using G2 = Proj<Fq2Pair>;  // 48 words: X, Y, Z, each c0 then c1

ZK_FN void g2_padd(G2& o, const G2& p, const G2& q) { rcb_padd(Fq2Pair{}, o, p, q); }
ZK_FN void g2_pdbl(G2& o, const G2& p) { rcb_pdbl(Fq2Pair{}, o, p); }

#if defined(__CUDACC__)
// K6's split of Fq2 over a pair of threads: lanes l and l ^ 16 of a warp
// hold c0 and c1 of one point, El is this thread's coefficient, and each op
// with a product fetches the partner's coefficients of its operands with
// __shfl_xor_sync(., 16).  Every thread of the warp must call those ops
// together (full mask).  add and sub stay in the thread, and so does the
// negation of mul_sub's d (the partner negates its own coefficient).
struct Fq2Lane {
  using El = Limbs;
  uint32_t c1;  // ~0 where this thread holds coefficient c1 (lanes 16-31), else 0

  // The mask of this lane, hidden from the optimiser (see above).
  __device__ __forceinline__ static Fq2Lane of_lane(int lane) {
    uint32_t m = 0u - (uint32_t)(lane >> 4);
    asm("" : "+r"(m));
    return Fq2Lane{m};
  }

  __device__ __forceinline__ static void partner(El& r, const El& a) {
#pragma unroll
    for (int j = 0; j < NL; ++j) r.v[j] = __shfl_xor_sync(0xffffffffu, a.v[j], 16);
  }
  __device__ __forceinline__ void mul(El& r, const El& a, const El& b) const {
    El ap, bp;
    partner(ap, a);
    partner(bp, b);
    fq2_mul_half(r.v, c1, a.v, b.v, ap.v, bp.v);
  }
  __device__ __forceinline__ void sqr(El& r, const El& a) const {
    El ap;
    partner(ap, a);
    fq2_sqr_half(r.v, c1, a.v, ap.v);
  }
  __device__ __forceinline__ void mul_add(El& r, const El& a, const El& b, const El& c,
                                          const El& d) const {
    El ap, bp, cp, dp;
    partner(ap, a);
    partner(bp, b);
    partner(cp, c);
    partner(dp, d);
    fq2_mul_add_half(r.v, c1, a.v, b.v, c.v, d.v, ap.v, bp.v, cp.v, dp.v);
  }
  __device__ __forceinline__ void mul_sub(El& r, const El& a, const El& b, const El& c,
                                          const El& d) const {
    El n;
    p_minus<Fq>(n.v, d.v);
    mul_add(r, a, b, c, n);
  }
  __device__ __forceinline__ void add(El& r, const El& a, const El& b) const {
    zk::add<Fq>(r.v, a.v, b.v);
  }
  __device__ __forceinline__ void sub(El& r, const El& a, const El& b) const {
    zk::sub<Fq>(r.v, a.v, b.v);
  }
  __device__ __forceinline__ void mul_b3(El& r, const El& a) const {
    El ap;
    partner(ap, a);
    fq2_mul_b3_half(r.v, c1, a.v, ap.v);
  }
};
#endif  // __CUDACC__

}  // namespace zk
