// BN254 field and G1 arithmetic shared by every kernel of zkfl_tpu_torch.
//
// Stands in for the Pallas emitters of zkfl_tpu/ops/limb_kernels.py:106-309
// (_emit_mul_wide, _emit_carry, _emit_mont_reduce, _emit_add, _emit_sub,
// _emit_cond_sub_const) and for the RCB15 formulas of
// zkfl_tpu/ops/point_kernels.py:68-128.
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
#else
#define ZK_FN inline
#endif

namespace zk {

constexpr int NL = 8;  // 32-bit limbs per element

// Moduli, -p^-1 mod 2^32 and R^2 mod p, limbs little-endian.
struct Fr {
  static constexpr uint32_t NP0 = 0xefffffffu;
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
};

struct Fq {
  static constexpr uint32_t NP0 = 0xe4866389u;
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
};

// 3*b for G1 (b = 3) in Fq Montgomery form: RCB15's b3.
ZK_FN uint32_t g1_b3(int i) {
  const uint32_t v[NL] = {0x410d7ff7u, 0xf60647ceu, 0xd31bd011u, 0x2f3d6f4du,
                          0x3940c6d1u, 0x2943337eu, 0xa7e39857u, 0x1d9598e8u};
  return v[i];
}

struct Limbs {  // an element passed by value (kernel argument)
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

// Raw per-limb column sums of Montgomery terms -> canonical Montgomery form.
// cols[j] < 2^63 (sums of at most 2^31 32-bit limbs).  With T the carried
// value lo + top * 2^256 (top < 2^32):
//   T mod p = mont_mul(from_mont(lo) + top, R^2)
// because from_mont(lo) + top = T * R^-1 mod p.
template <class F>
ZK_FN void normalize_raw(uint32_t r[NL], const int64_t cols[NL]) {
  uint32_t lo[NL];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    c += (uint64_t)cols[j];  // < 2^63 + 2^32
    lo[j] = (uint32_t)c;
    c >>= 32;
  }
  uint32_t top[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) top[j] = j == 0 ? (uint32_t)c : 0u;
  uint32_t red[NL];
  from_mont<F>(red, lo);
  add<F>(red, red, top);
  to_mont<F>(r, red);
}

// ---------------------------------------------------------------------------
// G1: complete projective formulas of Renes-Costello-Batina 2015 for a = 0,
// b3 = 3b = 9 (Montgomery form).  Branchless; the identity is (0:1:0) and
// P + P, P + (-P) and sums with the identity come out right.
// ---------------------------------------------------------------------------

struct G1 {
  uint32_t x[NL], y[NL], z[NL];
};

ZK_FN void g1_mul_b3(uint32_t r[NL], const uint32_t a[NL]) {
  uint32_t b3[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) b3[j] = g1_b3(j);
  mont_mul<Fq>(r, a, b3);
}

// RCB15 algorithm 7, in the order of point_kernels._padd_kernel.
ZK_FN void g1_padd(G1& o, const G1& p, const G1& q) {
  uint32_t t0[NL], t1[NL], t2[NL], t3[NL], t4[NL], y3[NL], u[NL], v[NL];
  mont_mul<Fq>(t0, p.x, q.x);
  mont_mul<Fq>(t1, p.y, q.y);
  mont_mul<Fq>(t2, p.z, q.z);
  add<Fq>(u, p.x, p.y);
  add<Fq>(v, q.x, q.y);
  mont_mul<Fq>(t3, u, v);
  add<Fq>(u, t0, t1);
  sub<Fq>(t3, t3, u);  // X1Y2 + X2Y1
  add<Fq>(u, p.y, p.z);
  add<Fq>(v, q.y, q.z);
  mont_mul<Fq>(t4, u, v);
  add<Fq>(u, t1, t2);
  sub<Fq>(t4, t4, u);  // Y1Z2 + Y2Z1
  add<Fq>(u, p.x, p.z);
  add<Fq>(v, q.x, q.z);
  mont_mul<Fq>(y3, u, v);
  add<Fq>(u, t0, t2);
  sub<Fq>(y3, y3, u);  // X1Z2 + X2Z1
  uint32_t t00[NL], t2b[NL], y3b[NL], z3a[NL], t1b[NL];
  add<Fq>(t00, t0, t0);
  add<Fq>(t00, t00, t0);  // 3 X1X2
  g1_mul_b3(t2b, t2);     // b3 Z1Z2
  g1_mul_b3(y3b, y3);     // b3 (X1Z2 + X2Z1)
  add<Fq>(z3a, t1, t2b);  // Y1Y2 + b3 Z1Z2
  sub<Fq>(t1b, t1, t2b);  // Y1Y2 - b3 Z1Z2
  mont_mul<Fq>(u, t3, t1b);
  mont_mul<Fq>(v, t4, y3b);
  sub<Fq>(o.x, u, v);
  mont_mul<Fq>(u, t1b, z3a);
  mont_mul<Fq>(v, t00, y3b);
  add<Fq>(o.y, u, v);
  mont_mul<Fq>(u, z3a, t4);
  mont_mul<Fq>(v, t00, t3);
  add<Fq>(o.z, u, v);
}

// RCB15 algorithm 9, in the order of point_kernels._pdbl_kernel.
ZK_FN void g1_pdbl(G1& o, const G1& p) {
  uint32_t t0[NL], t1[NL], zz[NL], xy[NL], z3[NL], t2[NL], y3[NL], t2s[NL];
  mont_mul<Fq>(t0, p.y, p.y);
  mont_mul<Fq>(t1, p.y, p.z);
  mont_mul<Fq>(zz, p.z, p.z);
  mont_mul<Fq>(xy, p.x, p.y);
  add<Fq>(z3, t0, t0);
  add<Fq>(z3, z3, z3);
  add<Fq>(z3, z3, z3);  // 8 Y^2
  g1_mul_b3(t2, zz);    // b3 Z^2
  add<Fq>(y3, t0, t2);
  add<Fq>(t2s, t2, t2);
  add<Fq>(t2s, t2s, t2);  // 3 b3 Z^2
  sub<Fq>(t0, t0, t2s);
  uint32_t x3a[NL], y3a[NL], x3h[NL];
  mont_mul<Fq>(x3a, t2, z3);
  mont_mul<Fq>(o.z, t1, z3);
  mont_mul<Fq>(y3a, t0, y3);
  mont_mul<Fq>(x3h, t0, xy);
  add<Fq>(o.y, x3a, y3a);
  add<Fq>(o.x, x3h, x3h);
}

}  // namespace zk
