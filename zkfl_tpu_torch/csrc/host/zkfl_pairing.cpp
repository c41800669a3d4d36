// BN254 optimal-ate pairing and G1/G2 scalar multiplication — the native
// host side of Groth16 proof assembly and verification.
//
// Replaces the pure-Python pairing (zkfl_tpu/field/pairing.py) for Groth16
// verification: the reference verifies in ~8-9 ms/proof via snarkjs
// (ref:Report.pdf Table 3; subprocess at
// ref:tests/full_system_simulation.mjs:865-868), and the Python Miller loop
// costs ~800 ms/proof.  The scalar multiplications replace the Python
// double-and-add of groth16/prover.py (the blinding terms r delta, s delta,
// s pi_A, r pi_B1, -rs delta, in constant time) and of
// groth16/verifier.py (vk_x = IC_0 + sum s_i IC_i, public scalars).
//
// Layout: 4x64-bit Montgomery Fq; tower Fq2 = Fq[u]/(u^2+1),
// Fq6 = Fq2[v]/(v^3 - (9+u)), Fq12 = Fq6[w]/(w^2 - v).  G2 inputs are
// affine points of the D-twist E': y^2 = x^3 + 3/(9+u).
//
// The pairing check is the optimal-ate product check:
//   - one Miller loop for all pairs: one accumulator f, squared once per
//     digit of the non-adjacent form of 6u+2, each pair's running twist
//     point T_i in homogeneous projective coordinates (no inversion in the
//     loop; Costello-Lange-Naehrig 2010), each step's line a + b w + c w^3
//     multiplied into f by a sparse product (13 Fq2 products, not 27); the
//     two Frobenius addition steps per pair at the end;
//   - one final exponentiation: the easy part f^((p^6 - 1)(p^2 + 1)), then
//     the hard part (p^4 - p^2 + 1)/r exactly as the BN addition chain of
//     Scott et al. 2009: three exponentiations by u with Granger-Scott
//     cyclotomic squarings, Frobenius maps and 13 Fq12 products.
// A line is scaled by an Fq2 factor, and a subtraction step of the signed
// loop drops a vertical line: the easy part removes both.  A point off its
// curve makes the check return 0: such a proof is invalid.  A step whose
// result has Z = 0 (where the affine loop meets yR = 0 or xR = xQ) makes it
// return -1, and the caller asks the Python oracle.  The boolean
// product==1 result is tower-isomorphism invariant, so this agrees with the
// Python oracle's py_ecc-style FQ12 basis.  The pairing and the
// constant-time ladder run on the same Fq operations, none of which
// branches on the values.
//
// Built by zkfl_tpu_torch/native.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <vector>
#if defined(__x86_64__)
#include <x86intrin.h>
#endif

typedef __uint128_t u128;
typedef uint64_t u64;

// ---------------------------------------------------------------------------
// Fq: 4x64 Montgomery
// ---------------------------------------------------------------------------

static const u64 P[4] = {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                         0xb85045b68181585dULL, 0x30644e72e131a029ULL};
static const u64 N0INV = 0x87d20782e4866389ULL;  // -p^-1 mod 2^64
static const u64 R1[4] = {0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL,
                          0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL};
static const u64 R2[4] = {0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
                          0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL};

struct Fq { u64 l[4]; };

static const Fq FQ_ZERO = {{0, 0, 0, 0}};

// The Fq operations run the same instructions for every value: a reduction
// subtracts p and keeps the difference or the operand by a mask, never by
// a branch, so that the constant-time ladder below is constant time in its
// field operations too.  The values are fully reduced (< p).

// One word of a carry chain: a + b + c, the carry out (0 or 1) in c.
static inline u64 adc(u64 a, u64 b, unsigned char &c) {
#if defined(__x86_64__)
  unsigned long long s;
  c = _addcarry_u64(c, a, b, &s);
  return s;
#else
  u128 s = (u128)a + b + c;
  c = (unsigned char)(s >> 64);
  return (u64)s;
#endif
}

// One word of a borrow chain: a - b - bw, the borrow out (0 or 1) in bw.
static inline u64 sbb(u64 a, u64 b, unsigned char &bw) {
#if defined(__x86_64__)
  unsigned long long d;
  bw = _subborrow_u64(bw, a, b, &d);
  return d;
#else
  u128 d = (u128)a - b - bw;
  bw = (unsigned char)(d >> 127);
  return (u64)d;
#endif
}

// r = t - p where t >= p, else t, for t = hi 2^256 + (t3 t2 t1 t0) < 2p.
// Scalar locals, not arrays: they stay in registers.
static inline void reduce_once(Fq &r, u64 t0, u64 t1, u64 t2, u64 t3, u64 hi) {
  unsigned char bw = 0;
  const u64 d0 = sbb(t0, P[0], bw), d1 = sbb(t1, P[1], bw);
  const u64 d2 = sbb(t2, P[2], bw), d3 = sbb(t3, P[3], bw);
  sbb(hi, 0, bw);
  const u64 keep = 0 - (u64)bw;  // t < p: t itself
  r.l[0] = (t0 & keep) | (d0 & ~keep); r.l[1] = (t1 & keep) | (d1 & ~keep);
  r.l[2] = (t2 & keep) | (d2 & ~keep); r.l[3] = (t3 & keep) | (d3 & ~keep);
}

static inline void fq_add(Fq &r, const Fq &a, const Fq &b) {
  unsigned char c = 0;
  const u64 s0 = adc(a.l[0], b.l[0], c), s1 = adc(a.l[1], b.l[1], c);
  const u64 s2 = adc(a.l[2], b.l[2], c), s3 = adc(a.l[3], b.l[3], c);
  reduce_once(r, s0, s1, s2, s3, c);
}

static inline void fq_sub(Fq &r, const Fq &a, const Fq &b) {
  unsigned char bw = 0, c = 0;
  const u64 d0 = sbb(a.l[0], b.l[0], bw), d1 = sbb(a.l[1], b.l[1], bw);
  const u64 d2 = sbb(a.l[2], b.l[2], bw), d3 = sbb(a.l[3], b.l[3], bw);
  const u64 m = 0 - (u64)bw;  // a < b: add p back
  r.l[0] = adc(d0, P[0] & m, c); r.l[1] = adc(d1, P[1] & m, c);
  r.l[2] = adc(d2, P[2] & m, c); r.l[3] = adc(d3, P[3] & m, c);
}

static inline void fq_neg(Fq &r, const Fq &a) { fq_sub(r, FQ_ZERO, a); }

// CIOS Montgomery multiplication.
static inline void fq_mul(Fq &out, const Fq &a, const Fq &b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)t[j] + (u128)a.l[i] * b.l[j] + carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[4] + carry;
    t[4] = (u64)s;
    t[5] = (u64)(s >> 64);

    u64 m = t[0] * N0INV;
    carry = ((u128)t[0] + (u128)m * P[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 s2 = (u128)t[j] + (u128)m * P[j] + carry;
      t[j - 1] = (u64)s2;
      carry = s2 >> 64;
    }
    s = (u128)t[4] + carry;
    t[3] = (u64)s;
    t[4] = t[5] + (u64)(s >> 64);
  }
  reduce_once(out, t[0], t[1], t[2], t[3], t[4]);
}

static inline void fq_sqr(Fq &r, const Fq &a) { fq_mul(r, a, a); }

static const Fq FQ_ONE = {{R1[0], R1[1], R1[2], R1[3]}};

static inline bool fq_is_zero(const Fq &a) {
  return !(a.l[0] | a.l[1] | a.l[2] | a.l[3]);
}
static inline bool fq_eq(const Fq &a, const Fq &b) {
  return !memcmp(a.l, b.l, sizeof a.l);
}

static void fq_to_mont(Fq &r, const Fq &a) {
  Fq r2; memcpy(r2.l, R2, sizeof R2);
  fq_mul(r, a, r2);
}

// a^e for a 4-limb exponent (square-and-multiply, MSB first).
static void fq_pow(Fq &r, const Fq &a, const u64 e[4]) {
  Fq acc = FQ_ONE;
  bool started = false;
  for (int i = 3; i >= 0; --i) {
    for (int b = 63; b >= 0; --b) {
      if (started) fq_sqr(acc, acc);
      if ((e[i] >> b) & 1) {
        if (started) fq_mul(acc, acc, a);
        else { acc = a; started = true; }
      }
    }
  }
  r = started ? acc : FQ_ONE;
}

static void fq_inv(Fq &r, const Fq &a) {
  u64 pm2[4];
  memcpy(pm2, P, sizeof pm2);
  pm2[0] -= 2;  // p is odd, no borrow
  fq_pow(r, a, pm2);
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u^2 + 1)
// ---------------------------------------------------------------------------

struct Fq2 { Fq c0, c1; };

static const Fq2 FQ2_ZERO = {FQ_ZERO, FQ_ZERO};
static const Fq2 FQ2_ONE = {FQ_ONE, FQ_ZERO};

static inline void fq2_add(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  fq_add(r.c0, a.c0, b.c0); fq_add(r.c1, a.c1, b.c1);
}
static inline void fq2_sub(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  fq_sub(r.c0, a.c0, b.c0); fq_sub(r.c1, a.c1, b.c1);
}
static inline void fq2_mul(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  Fq t0, t1, s0, s1, m;
  fq_mul(t0, a.c0, b.c0);
  fq_mul(t1, a.c1, b.c1);
  fq_add(s0, a.c0, a.c1);
  fq_add(s1, b.c0, b.c1);
  fq_mul(m, s0, s1);
  Fq2 out;
  fq_sub(out.c0, t0, t1);
  fq_sub(m, m, t0);
  fq_sub(out.c1, m, t1);
  r = out;
}

static void fq2_inv(Fq2 &r, const Fq2 &a) {
  Fq t0, t1, d, di;
  fq_sqr(t0, a.c0);
  fq_sqr(t1, a.c1);
  fq_add(d, t0, t1);
  fq_inv(di, d);
  Fq2 out;
  fq_mul(out.c0, a.c0, di);
  Fq n1; fq_neg(n1, a.c1);
  fq_mul(out.c1, n1, di);
  r = out;
}

static inline bool fq2_is_zero(const Fq2 &a) {
  return fq_is_zero(a.c0) && fq_is_zero(a.c1);
}
static inline bool fq2_eq(const Fq2 &a, const Fq2 &b) {
  return fq_eq(a.c0, b.c0) && fq_eq(a.c1, b.c1);
}

// ---------------------------------------------------------------------------
// The pairing's arithmetic
// ---------------------------------------------------------------------------
//
// The pairing's code is in namespace pairing: its Fq2, Fq6 and Fq12
// arithmetic (add, sub, neg, mul, sqr, half, ...) over the Fq operations
// above, which the constant-time ladder below runs too.

namespace pairing {

// a / 2: the Montgomery form is linear, so halve the representative mod p.
static inline void half(Fq &r, const Fq &a) {
  u64 t[4];
  memcpy(t, a.l, sizeof t);
  if (t[0] & 1) {  // a + p < 2^255: no carry out
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)t[i] + P[i] + carry;
      t[i] = (u64)s;
      carry = s >> 64;
    }
  }
  for (int i = 0; i < 3; ++i) r.l[i] = (t[i] >> 1) | (t[i + 1] << 63);
  r.l[3] = t[3] >> 1;
}

static inline void add(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  fq_add(r.c0, a.c0, b.c0); fq_add(r.c1, a.c1, b.c1);
}
static inline void sub(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  fq_sub(r.c0, a.c0, b.c0); fq_sub(r.c1, a.c1, b.c1);
}
static inline void neg(Fq2 &r, const Fq2 &a) {
  fq_neg(r.c0, a.c0); fq_neg(r.c1, a.c1);
}
static inline void conj(Fq2 &r, const Fq2 &a) {
  r.c0 = a.c0; fq_neg(r.c1, a.c1);
}

// Karatsuba: 3 Fq products.
static inline void mul(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  Fq t0, t1, s0, s1, m;
  fq_mul(t0, a.c0, b.c0);
  fq_mul(t1, a.c1, b.c1);
  fq_add(s0, a.c0, a.c1);
  fq_add(s1, b.c0, b.c1);
  fq_mul(m, s0, s1);
  Fq2 out;
  fq_sub(out.c0, t0, t1);
  fq_sub(m, m, t0);
  fq_sub(out.c1, m, t1);
  r = out;
}

// (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u: 2 Fq products.
static inline void sqr(Fq2 &r, const Fq2 &a) {
  Fq s, d, m;
  fq_add(s, a.c0, a.c1);
  fq_sub(d, a.c0, a.c1);
  fq_mul(m, a.c0, a.c1);
  fq_mul(r.c0, s, d);
  fq_add(r.c1, m, m);
}

static inline void half(Fq2 &r, const Fq2 &a) {
  half(r.c0, a.c0); half(r.c1, a.c1);
}

static inline void mul(Fq2 &r, const Fq2 &a, const Fq &s) {
  fq_mul(r.c0, a.c0, s); fq_mul(r.c1, a.c1, s);
}

// (9 + u) a = (9 a0 - a1) + (9 a1 + a0) u
static inline void mul_xi(Fq2 &r, const Fq2 &a) {
  Fq2 t;
  add(t, a, a);
  add(t, t, t);
  add(t, t, t);
  add(t, t, a);  // 9a
  fq_sub(t.c0, t.c0, a.c1);
  fq_add(t.c1, t.c1, a.c0);
  r = t;
}

// ---------------------------------------------------------------------------
// Fq6 = Fq2[v]/(v^3 - xi)
// ---------------------------------------------------------------------------

struct Fq6 { Fq2 c0, c1, c2; };

static const Fq6 FQ6_ZERO = {FQ2_ZERO, FQ2_ZERO, FQ2_ZERO};
static const Fq6 FQ6_ONE = {FQ2_ONE, FQ2_ZERO, FQ2_ZERO};

static inline void fq6_add(Fq6 &r, const Fq6 &a, const Fq6 &b) {
  add(r.c0, a.c0, b.c0); add(r.c1, a.c1, b.c1);
  add(r.c2, a.c2, b.c2);
}
static inline void fq6_sub(Fq6 &r, const Fq6 &a, const Fq6 &b) {
  sub(r.c0, a.c0, b.c0); sub(r.c1, a.c1, b.c1);
  sub(r.c2, a.c2, b.c2);
}
static inline void fq6_neg(Fq6 &r, const Fq6 &a) {
  neg(r.c0, a.c0); neg(r.c1, a.c1); neg(r.c2, a.c2);
}

// Karatsuba: 6 Fq2 products.
static void fq6_mul(Fq6 &r, const Fq6 &a, const Fq6 &b) {
  Fq2 t0, t1, t2, s, u, x;
  mul(t0, a.c0, b.c0);
  mul(t1, a.c1, b.c1);
  mul(t2, a.c2, b.c2);
  Fq6 out;
  // c0 = t0 + xi((a1 + a2)(b1 + b2) - t1 - t2)
  add(s, a.c1, a.c2); add(u, b.c1, b.c2); mul(x, s, u);
  sub(x, x, t1); sub(x, x, t2); mul_xi(x, x);
  add(out.c0, x, t0);
  // c1 = (a0 + a1)(b0 + b1) - t0 - t1 + xi t2
  add(s, a.c0, a.c1); add(u, b.c0, b.c1); mul(x, s, u);
  sub(x, x, t0); sub(x, x, t1);
  mul_xi(s, t2); add(out.c1, x, s);
  // c2 = (a0 + a2)(b0 + b2) - t0 - t2 + t1
  add(s, a.c0, a.c2); add(u, b.c0, b.c2); mul(x, s, u);
  sub(x, x, t0); sub(x, x, t2);
  add(out.c2, x, t1);
  r = out;
}

// a (b0 + b1 v): 5 Fq2 products.
static void fq6_mul_by_01(Fq6 &r, const Fq6 &a, const Fq2 &b0, const Fq2 &b1) {
  Fq2 t0, t1, s, u, x;
  mul(t0, a.c0, b0);
  mul(t1, a.c1, b1);
  Fq6 out;
  // c0 = t0 + xi a2 b1 = t0 + xi((a1 + a2) b1 - t1)
  add(s, a.c1, a.c2); mul(x, s, b1); sub(x, x, t1);
  mul_xi(x, x); add(out.c0, x, t0);
  // c1 = a0 b1 + a1 b0 = (a0 + a1)(b0 + b1) - t0 - t1
  add(s, a.c0, a.c1); add(u, b0, b1); mul(x, s, u);
  sub(x, x, t0); sub(out.c1, x, t1);
  // c2 = a1 b1 + a2 b0 = (a0 + a2) b0 - t0 + t1
  add(s, a.c0, a.c2); mul(x, s, b0); sub(x, x, t0);
  add(out.c2, x, t1);
  r = out;
}

static inline void fq6_mul_by_fq2(Fq6 &r, const Fq6 &a, const Fq2 &b) {
  mul(r.c0, a.c0, b); mul(r.c1, a.c1, b); mul(r.c2, a.c2, b);
}

static inline void fq6_mul_v(Fq6 &r, const Fq6 &a) {
  // v * (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2
  Fq2 t; mul_xi(t, a.c2);
  Fq6 out = {t, a.c0, a.c1};
  r = out;
}

static void fq6_inv(Fq6 &r, const Fq6 &a) {
  Fq2 A, B, C, t;
  sqr(A, a.c0);
  mul(t, a.c1, a.c2); mul_xi(t, t);
  sub(A, A, t);                     // a0^2 - xi a1 a2
  sqr(B, a.c2); mul_xi(B, B);
  mul(t, a.c0, a.c1);
  sub(B, B, t);                     // xi a2^2 - a0 a1
  sqr(C, a.c1);
  mul(t, a.c0, a.c2);
  sub(C, C, t);                     // a1^2 - a0 a2
  Fq2 den, d1, d2;
  mul(den, a.c0, A);
  mul(d1, a.c2, B); mul(d2, a.c1, C);
  add(d1, d1, d2); mul_xi(d1, d1);
  add(den, den, d1);                // a0 A + xi(a2 B + a1 C)
  Fq2 di; fq2_inv(di, den);
  mul(r.c0, A, di);
  mul(r.c1, B, di);
  mul(r.c2, C, di);
}

// ---------------------------------------------------------------------------
// Fq12 = Fq6[w]/(w^2 - v)
// ---------------------------------------------------------------------------

struct Fq12 { Fq6 c0, c1; };

static const Fq12 FQ12_ONE = {FQ6_ONE, FQ6_ZERO};

static void fq12_mul(Fq12 &r, const Fq12 &a, const Fq12 &b) {
  Fq6 t0, t1, s0, s1, m, x;
  fq6_mul(t0, a.c0, b.c0);
  fq6_mul(t1, a.c1, b.c1);
  fq6_add(s0, a.c0, a.c1);
  fq6_add(s1, b.c0, b.c1);
  fq6_mul(m, s0, s1);
  Fq12 out;
  fq6_mul_v(x, t1);
  fq6_add(out.c0, t0, x);
  fq6_sub(m, m, t0);
  fq6_sub(out.c1, m, t1);
  r = out;
}

// Complex squaring, 2 Fq6 products: with t = a0 a1,
// (a0 + a1 w)^2 = (a0 + a1)(a0 + v a1) - t - v t + 2t w.
static void fq12_sqr(Fq12 &r, const Fq12 &a) {
  Fq6 t, s, u, vt;
  fq6_mul(t, a.c0, a.c1);
  fq6_add(s, a.c0, a.c1);
  fq6_mul_v(u, a.c1);
  fq6_add(u, u, a.c0);
  fq6_mul(s, s, u);
  fq6_mul_v(vt, t);
  fq6_sub(s, s, t);
  fq6_sub(r.c0, s, vt);
  fq6_add(r.c1, t, t);
}

// f * (a + b w + c w^3), a line's sparse value: 13 Fq2 products.  With
// f = f0 + f1 w and the line L0 + L1 w, L0 = a, L1 = b + c v:
// f0 L0 + v f1 L1 + ((f0 + f1)(L0 + L1) - f0 L0 - f1 L1) w.
static void fq12_mul_by_034(Fq12 &f, const Fq2 &a, const Fq2 &b, const Fq2 &c) {
  Fq6 t0, t1, s;
  Fq2 ab;
  fq6_mul_by_fq2(t0, f.c0, a);
  fq6_mul_by_01(t1, f.c1, b, c);
  fq6_add(s, f.c0, f.c1);
  add(ab, a, b);
  fq6_mul_by_01(s, s, ab, c);
  fq6_sub(s, s, t0);
  fq6_sub(f.c1, s, t1);
  fq6_mul_v(t1, t1);
  fq6_add(f.c0, t0, t1);
}

static inline void fq12_conj(Fq12 &r, const Fq12 &a) {
  r.c0 = a.c0; fq6_neg(r.c1, a.c1);
}

static void fq12_inv(Fq12 &r, const Fq12 &a) {
  Fq6 t0, t1, x;
  fq6_mul(t0, a.c0, a.c0);
  fq6_mul(t1, a.c1, a.c1);
  fq6_mul_v(x, t1);
  fq6_sub(t0, t0, x);          // c0^2 - v c1^2
  Fq6 ti; fq6_inv(ti, t0);
  fq6_mul(r.c0, a.c0, ti);
  Fq6 n1; fq6_neg(n1, a.c1);
  fq6_mul(r.c1, n1, ti);
}

static bool fq12_is_one(const Fq12 &a) {
  return fq2_eq(a.c0.c0, FQ2_ONE) && fq2_is_zero(a.c0.c1) &&
         fq2_is_zero(a.c0.c2) && fq2_is_zero(a.c1.c0) &&
         fq2_is_zero(a.c1.c1) && fq2_is_zero(a.c1.c2);
}

// pow by byte-big-endian exponent
static void fq12_pow(Fq12 &r, const Fq12 &a, const uint8_t *exp, int nbytes) {
  Fq12 acc = FQ12_ONE;
  bool started = false;
  for (int i = 0; i < nbytes; ++i) {
    for (int b = 7; b >= 0; --b) {
      if (started) fq12_sqr(acc, acc);
      if ((exp[i] >> b) & 1) {
        if (started) fq12_mul(acc, acc, a);
        else { acc = a; started = true; }
      }
    }
  }
  r = started ? acc : FQ12_ONE;
}

// Granger-Scott squaring of an element of the cyclotomic subgroup (any
// f^((p^6 - 1)(p^2 + 1))): over Fq4 = Fq2[y]/(y^2 - xi), y = w^3, f is
// a + b w + c w^2 with a = (w^0, w^3), b = (w^1, w^4), c = (w^2, w^5), and
// f^2 = (3a^2 - 2 conj a) + (3 y c^2 + 2 conj b) w + (3b^2 - 2 conj c) w^2:
// three Fq4 squarings, 6 Fq2 products.
static void fq4_sqr(Fq2 &r0, Fq2 &r1, const Fq2 &a0, const Fq2 &a1) {
  // (a0 + a1 y)^2 = (a0 + a1)(a0 + xi a1) - t - xi t + 2t y, t = a0 a1
  Fq2 t, s, u;
  mul(t, a0, a1);
  add(s, a0, a1);
  mul_xi(u, a1); add(u, u, a0);
  mul(s, s, u);
  sub(s, s, t);
  mul_xi(u, t);
  sub(r0, s, u);
  add(r1, t, t);
}

// z = 3t + 2z where plus, else 3t - 2z.
static inline void gs_combine(Fq2 &z, const Fq2 &t, bool plus) {
  if (plus) add(z, t, z); else sub(z, t, z);
  add(z, z, z);
  add(z, z, t);
}

static void cyc_sqr(Fq12 &r, const Fq12 &f) {
  Fq2 t0, t1, t2, t3, t4, t5;
  fq4_sqr(t0, t1, f.c0.c0, f.c1.c1);  // a^2
  fq4_sqr(t2, t3, f.c1.c0, f.c0.c2);  // b^2
  fq4_sqr(t4, t5, f.c0.c1, f.c1.c2);  // c^2
  Fq12 out = f;
  gs_combine(out.c0.c0, t0, false);   // 3 t0 - 2 a0
  gs_combine(out.c1.c1, t1, true);    // 3 t1 + 2 a1
  Fq2 x; mul_xi(x, t5);
  gs_combine(out.c1.c0, x, true);     // 3 xi t5 + 2 b0
  gs_combine(out.c0.c2, t4, false);   // 3 t4 - 2 b1
  gs_combine(out.c0.c1, t2, false);   // 3 t2 - 2 c0
  gs_combine(out.c1.c2, t3, true);    // 3 t3 + 2 c1
  r = out;
}

// ---------------------------------------------------------------------------
// Constants
// ---------------------------------------------------------------------------

// The BN parameter: p = 36u^4 + 36u^3 + 24u^2 + 6u + 1.
static const u64 BN_U = 4965661367192848881ULL;
// (p - 1)/6, little-endian limbs.
static const u64 P_MINUS_1_OVER_6[4] = {
    0x34b017592414d4e1ULL, 0xee9591c2e6bda1c2ULL,
    0xf40d60f3c0403964ULL, 0x0810b7bdd032f006ULL};

// Frobenius coefficients of the w^j coordinate, j = 0..5 (index 0 is 1):
// FROB1[j] = xi^(j(p-1)/6), FROB2[j] = xi^(j(p^2-1)/6) = norm(FROB1[j])
// (in Fq), FROB3[j] = FROB1[j] FROB2[j].  FROB1[2], FROB1[3] also move a
// twist point: pi_p(x, y) = (conj(x) FROB1[2], conj(y) FROB1[3]).
static Fq2 FROB1[6], FROB3[6];
static Fq FROB2[6];
static Fq FQ_THREE;   // E:  y^2 = x^3 + 3
static Fq2 TWIST_B;   // E': y^2 = x^3 + 3/xi
static Fq2 TWIST_B3;  // 3 TWIST_B
// Signed digits (-1, 0, 1), least significant first, of 6u+2 and of u.
static int8_t ATE_NAF[72], U_NAF[72];
static int ATE_NAF_LEN, U_NAF_LEN;

static int naf(int8_t *d, u128 k) {
  int n = 0;
  while (k) {
    int8_t z = 0;
    if (k & 1) {
      z = (k & 3) == 1 ? 1 : -1;
      k = z == 1 ? k - 1 : k + 1;
    }
    d[n++] = z;
    k >>= 1;
  }
  return n;
}

static void fq2_pow(Fq2 &r, const Fq2 &a, const u64 e[4]) {
  Fq2 acc = FQ2_ONE;
  for (int i = 3; i >= 0; --i)
    for (int b = 63; b >= 0; --b) {
      sqr(acc, acc);
      if ((e[i] >> b) & 1) mul(acc, acc, a);
    }
  r = acc;
}

static Fq fq_small(u64 v) {
  Fq x = {{v, 0, 0, 0}}, r;
  fq_to_mont(r, x);
  return r;
}

static void init_constants() {
  // Thread-safe once: a function-local static is initialised exactly once.
  static const bool done = [] {
    Fq2 xi = {fq_small(9), FQ_ONE};
    FROB1[0] = FQ2_ONE;
    fq2_pow(FROB1[1], xi, P_MINUS_1_OVER_6);
    for (int j = 2; j < 6; ++j) mul(FROB1[j], FROB1[j - 1], FROB1[1]);
    for (int j = 0; j < 6; ++j) {
      Fq n0, n1;
      fq_mul(n0, FROB1[j].c0, FROB1[j].c0);
      fq_mul(n1, FROB1[j].c1, FROB1[j].c1);
      fq_add(FROB2[j], n0, n1);
      mul(FROB3[j], FROB1[j], FROB2[j]);
    }
    FQ_THREE = fq_small(3);
    Fq2 xi_inv; fq2_inv(xi_inv, xi);
    mul(TWIST_B, xi_inv, FQ_THREE);
    mul(TWIST_B3, TWIST_B, FQ_THREE);
    ATE_NAF_LEN = naf(ATE_NAF, (u128)BN_U * 6 + 2);
    U_NAF_LEN = naf(U_NAF, BN_U);
    return true;
  }();
  (void)done;
}

// Frobenius maps on Fq12: the coefficient c of w^j goes to conj(c)
// FROB1[j] (p), c FROB2[j] (p^2), conj(c) FROB3[j] (p^3).
static void fq12_frob(Fq12 &r, const Fq12 &a, int power) {
  const Fq2 *in[6] = {&a.c0.c0, &a.c1.c0, &a.c0.c1, &a.c1.c1, &a.c0.c2, &a.c1.c2};
  Fq12 out;
  Fq2 *o[6] = {&out.c0.c0, &out.c1.c0, &out.c0.c1, &out.c1.c1, &out.c0.c2, &out.c1.c2};
  for (int j = 0; j < 6; ++j) {  // coefficient of w^j
    if (power == 2) { mul(*o[j], *in[j], FROB2[j]); continue; }
    Fq2 c; conj(c, *in[j]);
    mul(*o[j], c, power == 1 ? FROB1[j] : FROB3[j]);
  }
  r = out;
}

// ---------------------------------------------------------------------------
// Miller loop: all pairs share f; twist points in homogeneous projective
// coordinates (x = X/Z, y = Y/Z)
// ---------------------------------------------------------------------------

struct G1Aff { Fq x, y; };      // Montgomery form
struct G2Aff { Fq2 x, y; };     // twist coords, Montgomery form
struct G2Proj { Fq2 x, y, z; };

static bool g1_on_curve(const G1Aff &P) {
  Fq l, r;
  fq_sqr(l, P.y);
  fq_sqr(r, P.x); fq_mul(r, r, P.x); fq_add(r, r, FQ_THREE);
  return fq_eq(l, r);
}

static bool g2_on_curve(const G2Aff &Q) {
  Fq2 l, r;
  sqr(l, Q.y);
  sqr(r, Q.x); mul(r, r, Q.x); add(r, r, TWIST_B);
  return fq2_eq(l, r);
}

// One pair of the product: P = (xp, -yp), Q and -Q, the running point T.
struct Pair {
  Fq xp, nyp;
  G2Aff q, nq;
  G2Proj t;
};

static void make_pair(Pair &pr, const G1Aff &P, const G2Aff &Q) {
  pr.xp = P.x;
  fq_neg(pr.nyp, P.y);
  pr.q = Q;
  pr.nq.x = Q.x;
  neg(pr.nq.y, Q.y);
  pr.t = {Q.x, Q.y, FQ2_ONE};
}

// T <- 2T; f *= the tangent at T, evaluated at P and scaled by 2YZ:
// -2YZ yP + 3X^2 xP w + (3b'Z^2 - Y^2) w^3.  False when 2T has Z = 0.
static bool dbl_step(Fq12 &f, Pair &pr) {
  G2Proj &T = pr.t;
  Fq2 a, b, c, e, e3, g, h, i, j, t;
  mul(a, T.x, T.y); half(a, a);   // XY/2
  sqr(b, T.y);                    // Y^2
  sqr(c, T.z);                    // Z^2
  mul(e, c, TWIST_B3);            // 3b'Z^2
  add(e3, e, e); add(e3, e3, e);  // 9b'Z^2
  add(g, b, e3); half(g, g);      // (Y^2 + 9b'Z^2)/2
  add(t, T.y, T.z); sqr(h, t);
  add(t, b, c); sub(h, h, t);     // 2YZ
  sub(i, e, b);                   // 3b'Z^2 - Y^2
  sqr(j, T.x);                    // X^2
  sub(t, b, e3); mul(T.x, a, t);  // X3 = XY/2 (Y^2 - 9b'Z^2)
  sqr(t, g); sqr(e3, e);
  sub(t, t, e3); sub(t, t, e3);
  sub(T.y, t, e3);                // Y3 = g^2 - 3e^2
  mul(T.z, b, h);                 // Z3 = 2Y^3 Z
  Fq2 la, lb;
  mul(la, h, pr.nyp);
  add(lb, j, j); add(lb, lb, j);
  mul(lb, lb, pr.xp);
  fq12_mul_by_034(f, la, lb, i);
  return !fq2_is_zero(T.z);
}

// T <- T + Q (Q affine); f *= the line through T and Q at P, scaled by
// L = X - xQ Z: -L yP + H xP w + (L yQ - H xQ) w^3, H = Y - yQ Z.  False
// when T + Q has Z = 0.
static bool add_step(Fq12 &f, Pair &pr, const G2Aff &Q) {
  G2Proj &T = pr.t;
  Fq2 th, la, c, d, e, ff, g, h, t, ey;
  mul(t, Q.y, T.z); sub(th, T.y, t);
  mul(t, Q.x, T.z); sub(la, T.x, t);
  sqr(c, th);
  sqr(d, la);
  mul(e, la, d);                  // L^3
  mul(ff, T.z, c);                // Z H^2
  mul(g, T.x, d);                 // X L^2
  add(h, e, ff); sub(h, h, g); sub(h, h, g);
  mul(ey, e, T.y);
  mul(T.x, la, h);
  sub(t, g, h); mul(t, th, t);
  sub(T.y, t, ey);
  mul(T.z, T.z, e);
  Fq2 lc, u;
  mul(lc, la, Q.y);
  mul(u, th, Q.x);
  sub(lc, lc, u);
  mul(la, la, pr.nyp);
  mul(th, th, pr.xp);
  fq12_mul_by_034(f, la, th, lc);
  return !fq2_is_zero(T.z);
}

// f = prod_i f_{6u+2, Q_i}(P_i) l_{T_i, pi(Q_i)}(P_i) l_{T_i', -pi^2(Q_i)}(P_i),
// up to factors the final exponentiation removes.  False when a step meets
// Z = 0 (f is then not the Miller value).
static bool miller(Fq12 &f, Pair *ps, long m) {
  f = FQ12_ONE;
  for (int i = ATE_NAF_LEN - 2; i >= 0; --i) {  // the top digit is T = Q
    if (i != ATE_NAF_LEN - 2) fq12_sqr(f, f);
    for (long k = 0; k < m; ++k)
      if (!dbl_step(f, ps[k])) return false;
    if (ATE_NAF[i]) {
      for (long k = 0; k < m; ++k)
        if (!add_step(f, ps[k], ATE_NAF[i] > 0 ? ps[k].q : ps[k].nq)) return false;
    }
  }
  for (long k = 0; k < m; ++k) {
    // Q1 = pi_p(Q); Q2 = -pi_p^2(Q) = (x FROB2[2], y)
    const G2Aff &Q = ps[k].q;
    G2Aff q1, q2;
    conj(q1.x, Q.x); mul(q1.x, q1.x, FROB1[2]);
    conj(q1.y, Q.y); mul(q1.y, q1.y, FROB1[3]);
    mul(q2.x, Q.x, FROB2[2]);
    q2.y = Q.y;
    if (!add_step(f, ps[k], q1) || !add_step(f, ps[k], q2)) return false;
  }
  return true;
}

// f^u for f in the cyclotomic subgroup, where conj(f) = 1/f.
static void cyc_exp_u(Fq12 &r, const Fq12 &f) {
  Fq12 fc, acc = f;
  fq12_conj(fc, f);
  for (int i = U_NAF_LEN - 2; i >= 0; --i) {
    cyc_sqr(acc, acc);
    if (U_NAF[i] > 0) fq12_mul(acc, acc, f);
    else if (U_NAF[i] < 0) fq12_mul(acc, acc, fc);
  }
  r = acc;
}

// Easy part: f^((p^6 - 1)(p^2 + 1)) = (conj(f) / f)^(p^2 + 1).
static void final_exp_easy(Fq12 &r, const Fq12 &f) {
  Fq12 fc, fi, f1, f2;
  fq12_conj(fc, f);
  fq12_inv(fi, f);
  fq12_mul(f1, fc, fi);
  fq12_frob(f2, f1, 2);
  fq12_mul(r, f2, f1);
}

// f^((p^12 - 1)/r).  The hard part f^((p^4 - p^2 + 1)/r) is
//   y0 = f^(p + p^2 + p^3), y1 = 1/f, y2 = (f^(u^2))^(p^2),
//   y3 = 1/(f^u)^p, y4 = 1/(f^u (f^(u^2))^p), y5 = 1/f^(u^2),
//   y6 = 1/(f^(u^3) (f^(u^3))^p),
//   T0 = y6^2 y4 y5, T1 = y3 y5 T0, T0 = T0 y2, T1 = (T1^2 T0)^2,
//   result (T1 y1)^2 (T1 y0):
// the exponent is exactly (p^4 - p^2 + 1)/r as an integer.
static void final_exp(Fq12 &r, const Fq12 &in) {
  Fq12 f, fu, fu2, fu3, a, b, y0, y1, y2, y3, y4, y5, y6, t0, t1;
  final_exp_easy(f, in);
  cyc_exp_u(fu, f);
  cyc_exp_u(fu2, fu);
  cyc_exp_u(fu3, fu2);
  fq12_frob(a, f, 1);
  fq12_frob(b, f, 2);
  fq12_mul(y0, a, b);
  fq12_frob(a, f, 3);
  fq12_mul(y0, y0, a);
  fq12_conj(y1, f);
  fq12_frob(y2, fu2, 2);
  fq12_frob(a, fu, 1);
  fq12_conj(y3, a);
  fq12_frob(a, fu2, 1);
  fq12_mul(a, a, fu);
  fq12_conj(y4, a);
  fq12_conj(y5, fu2);
  fq12_frob(a, fu3, 1);
  fq12_mul(a, a, fu3);
  fq12_conj(y6, a);
  cyc_sqr(t0, y6);
  fq12_mul(t0, t0, y4);
  fq12_mul(t0, t0, y5);
  fq12_mul(t1, y3, y5);
  fq12_mul(t1, t1, t0);
  fq12_mul(t0, t0, y2);
  cyc_sqr(t1, t1);
  fq12_mul(t1, t1, t0);
  cyc_sqr(t1, t1);
  fq12_mul(t0, t1, y1);
  fq12_mul(t1, t1, y0);
  cyc_sqr(t0, t0);
  fq12_mul(r, t0, t1);
}

// Hard-part exponent (p^4 - p^2 + 1)/r, big-endian bytes (761 bits), for
// the generic power that bn254_final_exp_plain keeps as the tests' twin.
static const uint8_t HARD_EXP[96] = {
    0x01, 0xba, 0xaa, 0x71, 0x0b, 0x07, 0x59, 0xad, 0x33, 0x1e, 0xc1, 0x51,
    0x83, 0x17, 0x7f, 0xaf, 0x6c, 0x0e, 0xb5, 0x22, 0xd5, 0xb1, 0x22, 0x78,
    0x4e, 0x52, 0x9a, 0x58, 0x61, 0x87, 0x6f, 0x6b, 0x3b, 0x1b, 0x13, 0x55,
    0xd1, 0x89, 0x22, 0x7d, 0x79, 0x58, 0x1e, 0x16, 0xf3, 0xfd, 0x90, 0xc6,
    0x6b, 0x88, 0x7d, 0x56, 0xd5, 0x09, 0x5f, 0x23, 0xaa, 0xa4, 0x41, 0xe3,
    0x95, 0x4b, 0xcf, 0x8a, 0xdc, 0xc7, 0xb4, 0x4c, 0x87, 0xcd, 0xba, 0xcf,
    0xf1, 0x15, 0x4e, 0x7e, 0x1d, 0xa0, 0x14, 0xfd, 0x5a, 0xbf, 0x5c, 0xc4,
    0xf4, 0x9c, 0x36, 0xd4, 0xe8, 0x1b, 0xb4, 0x82, 0xcc, 0xdf, 0x42, 0xb1,
};

static void final_exp_plain(Fq12 &r, const Fq12 &in) {
  Fq12 f;
  final_exp_easy(f, in);
  fq12_pow(r, f, HARD_EXP, 96);
}

}  // namespace pairing

// ---------------------------------------------------------------------------
// G1 (over Fq) and G2 (over Fq2, the twist) in Jacobian coordinates, a = 0
// ---------------------------------------------------------------------------
//
// One template serves both groups through the overloads below.  The point
// formulas are those of field/curve.py (dbl-2009-l, add-2007-bl); the
// identity is Z = 0.  The addition is complete: the doubling case and an
// identity operand are chosen by masks, not by branches, so that the
// constant-time multiplication below runs the same instructions for every
// scalar, the Fq operations' reductions included.

static inline void f_add(Fq &r, const Fq &a, const Fq &b) { fq_add(r, a, b); }
static inline void f_add(Fq2 &r, const Fq2 &a, const Fq2 &b) { fq2_add(r, a, b); }
static inline void f_sub(Fq &r, const Fq &a, const Fq &b) { fq_sub(r, a, b); }
static inline void f_sub(Fq2 &r, const Fq2 &a, const Fq2 &b) { fq2_sub(r, a, b); }
static inline void f_mul(Fq &r, const Fq &a, const Fq &b) { fq_mul(r, a, b); }
static inline void f_mul(Fq2 &r, const Fq2 &a, const Fq2 &b) { fq2_mul(r, a, b); }
static inline void f_inv(Fq &r, const Fq &a) { fq_inv(r, a); }
static inline void f_inv(Fq2 &r, const Fq2 &a) { fq2_inv(r, a); }
static inline void f_one(Fq &r) { r = FQ_ONE; }
static inline void f_one(Fq2 &r) { r = FQ2_ONE; }
static inline void f_zero(Fq &r) { r = FQ_ZERO; }
static inline void f_zero(Fq2 &r) { r = FQ2_ZERO; }

// All ones where a == b, else 0.
static inline u64 eq_mask(u64 a, u64 b) {
  u64 t = a ^ b;
  return ((t | (0 - t)) >> 63) - 1;
}
// All ones where a == 0 (the values are fully reduced), else 0.
static inline u64 zero_mask(const Fq &a) {
  return eq_mask(a.l[0] | a.l[1] | a.l[2] | a.l[3], 0);
}
static inline u64 zero_mask(const Fq2 &a) {
  return zero_mask(a.c0) & zero_mask(a.c1);
}

// r = a where mask is all ones, r unchanged where it is 0.
static inline void cmov(Fq &r, const Fq &a, u64 mask) {
  for (int i = 0; i < 4; ++i) r.l[i] ^= mask & (r.l[i] ^ a.l[i]);
}
static inline void cmov(Fq2 &r, const Fq2 &a, u64 mask) {
  cmov(r.c0, a.c0, mask);
  cmov(r.c1, a.c1, mask);
}

template <class F> struct Jac { F X, Y, Z; };

template <class F> static inline void jac_cmov(Jac<F> &r, const Jac<F> &a, u64 mask) {
  cmov(r.X, a.X, mask); cmov(r.Y, a.Y, mask); cmov(r.Z, a.Z, mask);
}

template <class F> static inline Jac<F> jac_identity() {
  Jac<F> r;
  f_one(r.X); f_one(r.Y); f_zero(r.Z);
  return r;
}

// Group operations of this thread since the last bn254_group_op_counts:
// doublings, additions, table entries read.  The tests compare them across
// scalars of different weight.
static thread_local u64 OPS[3];

template <class F> static void jac_dbl(Jac<F> &r, const Jac<F> &p) {
  ++OPS[0];
  F A, B, C, D, E, t, x3, y3, z3;
  f_mul(A, p.X, p.X);
  f_mul(B, p.Y, p.Y);
  f_mul(C, B, B);
  f_add(t, p.X, B); f_mul(t, t, t); f_sub(t, t, A); f_sub(t, t, C);
  f_add(D, t, t);                               // 2((X + B)^2 - A - C)
  f_add(E, A, A); f_add(E, E, A);               // 3A
  f_mul(x3, E, E); f_sub(x3, x3, D); f_sub(x3, x3, D);
  f_sub(t, D, x3); f_mul(y3, E, t);
  f_add(t, C, C); f_add(t, t, t); f_add(t, t, t);
  f_sub(y3, y3, t);                             // E(D - X3) - 8C
  f_mul(z3, p.Y, p.Z); f_add(z3, z3, z3);       // 2YZ: 0 for the identity
  r.X = x3; r.Y = y3; r.Z = z3;
}

template <class F> static void jac_add(Jac<F> &r, const Jac<F> &p, const Jac<F> &q) {
  ++OPS[1];
  F z1z1, z2z2, u1, u2, s1, s2, h, i, j, rr, v, t;
  Jac<F> s;
  f_mul(z1z1, p.Z, p.Z);
  f_mul(z2z2, q.Z, q.Z);
  f_mul(u1, p.X, z2z2);
  f_mul(u2, q.X, z1z1);
  f_mul(t, q.Z, z2z2); f_mul(s1, p.Y, t);
  f_mul(t, p.Z, z1z1); f_mul(s2, q.Y, t);
  f_sub(h, u2, u1);
  f_add(i, h, h); f_mul(i, i, i);               // 4H^2
  f_mul(j, h, i);
  f_sub(rr, s2, s1); f_add(rr, rr, rr);
  f_mul(v, u1, i);
  f_mul(s.X, rr, rr); f_sub(s.X, s.X, j); f_sub(s.X, s.X, v); f_sub(s.X, s.X, v);
  f_sub(t, v, s.X); f_mul(s.Y, rr, t);
  f_mul(t, s1, j); f_add(t, t, t); f_sub(s.Y, s.Y, t);
  f_add(t, p.Z, q.Z); f_mul(t, t, t); f_sub(t, t, z1z1); f_sub(t, t, z2z2);
  f_mul(s.Z, t, h);                             // p = -q: H = 0, the identity
  Jac<F> d;
  jac_dbl(d, p);
  jac_cmov(s, d, zero_mask(h) & zero_mask(rr));  // p = q
  jac_cmov(s, q, zero_mask(p.Z));
  jac_cmov(s, p, zero_mask(q.Z));
  r = s;
}

// k P for a secret k (4 limbs, k < 2^256): 64 fixed 4-bit windows from the
// top, each four doublings and one addition of the table entry k's digit
// picks, found by reading all 16 entries.  No branch and no address
// depends on k.
template <class F> static void ct_mul(Jac<F> &r, const Jac<F> &p, const u64 k[4]) {
  Jac<F> table[16];
  table[0] = jac_identity<F>();
  table[1] = p;
  for (int i = 2; i < 16; ++i) jac_add(table[i], table[i - 1], p);
  Jac<F> acc = jac_identity<F>();
  for (int w = 63; w >= 0; --w) {
    for (int i = 0; i < 4; ++i) jac_dbl(acc, acc);
    u64 digit = (k[w >> 4] >> ((w & 15) * 4)) & 15;
    Jac<F> e = table[0];
    for (u64 i = 1; i < 16; ++i) jac_cmov(e, table[i], eq_mask(i, digit));
    OPS[2] += 16;
    jac_add(acc, acc, e);
  }
  r = acc;
}

// Standard-form limbs in and out; the identity travels as a flag.
static void load(Fq &r, const u64 *a) {
  Fq x = {{a[0], a[1], a[2], a[3]}};
  fq_to_mont(r, x);
}
static void load(Fq2 &r, const u64 *a) { load(r.c0, a); load(r.c1, a + 4); }
static void store(u64 *out, const Fq &a) {
  Fq one = {{1, 0, 0, 0}}, r;
  fq_mul(r, a, one);
  memcpy(out, r.l, sizeof r.l);
}
static void store(u64 *out, const Fq2 &a) { store(out, a.c0); store(out + 4, a.c1); }

template <class F> static Jac<F> load_point(const u64 *xy, int inf) {
  const int n = sizeof(F) / sizeof(u64);
  Jac<F> r = jac_identity<F>();
  if (!inf) { load(r.X, xy); load(r.Y, xy + n); f_one(r.Z); }
  return r;
}

// The affine coordinates into out; 1 (out zeroed) for the identity, else 0.
template <class F> static int store_point(u64 *out, const Jac<F> &p) {
  const int n = sizeof(F) / sizeof(u64);
  if (zero_mask(p.Z)) {
    memset(out, 0, 2 * n * sizeof(u64));
    return 1;
  }
  F zi, z2, z3, x, y;
  f_inv(zi, p.Z);
  f_mul(z2, zi, zi);
  f_mul(z3, z2, zi);
  f_mul(x, p.X, z2);
  f_mul(y, p.Y, z3);
  store(out, x);
  store(out + n, y);
  return 0;
}

// ---------------------------------------------------------------------------
// Entry point
// ---------------------------------------------------------------------------

namespace pairing {

// The pairs of a product, their identity factors (encoded as all-zero
// coordinates) left out, into ps; false when a point is off its curve.
static bool load_pairs(long n, const u64 *g1, const u64 *g2, std::vector<Pair> &ps) {
  for (long i = 0; i < n; ++i) {
    G1Aff P;
    G2Aff Q;
    load(P.x, g1 + 8 * i); load(P.y, g1 + 8 * i + 4);
    load(Q.x, g2 + 16 * i); load(Q.y, g2 + 16 * i + 8);
    if ((fq_is_zero(P.x) && fq_is_zero(P.y)) ||
        (fq2_is_zero(Q.x) && fq2_is_zero(Q.y)))
      continue;  // identity factor contributes 1
    if (!g1_on_curve(P) || !g2_on_curve(Q)) return false;
    ps.emplace_back();
    make_pair(ps.back(), P, Q);
  }
  return true;
}

// Fq12 as 12 Fq coefficients in tower order c0.(c0,c1,c2) then c1.(c0,c1,c2),
// each Fq2 as (c0, c1): 12 x 4 u64 standard form.
static void fq12_from_std(Fq12 &r, const u64 *a) {
  Fq2 *cs[6] = {&r.c0.c0, &r.c0.c1, &r.c0.c2, &r.c1.c0, &r.c1.c1, &r.c1.c2};
  for (int i = 0; i < 6; ++i) load(*cs[i], a + 8 * i);
}

static void fq12_to_std(const Fq12 &a, u64 *out) {
  const Fq2 *cs[6] = {&a.c0.c0, &a.c0.c1, &a.c0.c2,
                      &a.c1.c0, &a.c1.c1, &a.c1.c2};
  for (int i = 0; i < 6; ++i) store(out + 8 * i, *cs[i]);
}

}  // namespace pairing

extern "C" {

// g1: n x 8 u64 limbs (x, y little-endian standard form)
// g2: n x 16 u64 limbs (x.c0, x.c1, y.c0, y.c1) — twist coords
// returns 1 if prod e(P_i, Q_i) == 1, 0 if != 1 or a point is off its
// curve, -1 on a degenerate step (caller falls back to the Python oracle).
int bn254_pairing_check(long n, const u64 *g1, const u64 *g2) {
  using namespace pairing;
  init_constants();
  std::vector<Pair> ps;
  Fq12 f, out;
  if (!load_pairs(n, g1, g2, ps)) return 0;
  if (!miller(f, ps.data(), ps.size())) return -1;
  final_exp(out, f);
  return fq12_is_one(out) ? 1 : 0;
}

// k P in constant time for a secret scalar (the proof's blinding terms).
// point: x, y (G1: 2 x 4 limbs; G2: x.c0, x.c1, y.c0, y.c1, 4 x 4 limbs),
// standard form, read only when inf is 0; scalar: 4 limbs.  out: the
// product's affine coordinates in the same layout; returns 1 when the
// product is the identity (out zeroed), else 0.
int bn254_g1_mul(const u64 *point, int inf, const u64 *scalar, u64 *out) {
  Jac<Fq> r;
  ct_mul(r, load_point<Fq>(point, inf), scalar);
  return store_point(out, r);
}

int bn254_g2_mul(const u64 *point, int inf, const u64 *scalar, u64 *out) {
  Jac<Fq2> r;
  ct_mul(r, load_point<Fq2>(point, inf), scalar);
  return store_point(out, r);
}

// One Groth16 proof from its MSM results (groth16/prover.py
// _assemble_proof):
//   pi_A  = alpha1 + A + r delta1
//   pi_B  = beta2 + B2 + s delta2                          (G2)
//   pi_B1 = beta1 + B1 + s delta1
//   pi_C  = C + H + s pi_A + r pi_B1 + (-rs) delta1
// every product by ct_mul.  g1: alpha1, beta1, delta1, A, B1, C, H and g2:
// beta2, delta2, B2, laid out and flagged as in bn254_g1_mul / bn254_g2_mul;
// scalars: r, s, -rs mod the group order, 4 limbs each.  out: pi_A (8
// limbs), pi_B (16), pi_C (8); returns the identity flags of pi_A, pi_B,
// pi_C as bits 0, 1, 2 (an identity's limbs zeroed).
int bn254_groth16_assemble(const u64 *g1, const uint8_t *g1_inf, const u64 *g2,
                           const uint8_t *g2_inf, const u64 *scalars, u64 *out) {
  Jac<Fq> p[7];
  for (int i = 0; i < 7; ++i) p[i] = load_point<Fq>(g1 + 8 * i, g1_inf[i]);
  Jac<Fq2> q[3];
  for (int i = 0; i < 3; ++i) q[i] = load_point<Fq2>(g2 + 16 * i, g2_inf[i]);
  const u64 *r = scalars, *s = scalars + 4, *rs = scalars + 8;
  const Jac<Fq> &alpha1 = p[0], &beta1 = p[1], &delta1 = p[2];
  Jac<Fq> pi_a, pi_b1, pi_c, t;
  Jac<Fq2> pi_b, t2;
  jac_add(pi_a, alpha1, p[3]);
  ct_mul(t, delta1, r);
  jac_add(pi_a, pi_a, t);
  jac_add(pi_b, q[0], q[2]);
  ct_mul(t2, q[1], s);
  jac_add(pi_b, pi_b, t2);
  jac_add(pi_b1, beta1, p[4]);
  ct_mul(t, delta1, s);
  jac_add(pi_b1, pi_b1, t);
  jac_add(pi_c, p[5], p[6]);
  ct_mul(t, pi_a, s);
  jac_add(pi_c, pi_c, t);
  ct_mul(t, pi_b1, r);
  jac_add(pi_c, pi_c, t);
  ct_mul(t, delta1, rs);
  jac_add(pi_c, pi_c, t);
  return store_point(out, pi_a) | store_point(out + 8, pi_b) << 1 |
         store_point(out + 24, pi_c) << 2;
}

// IC_0 + sum_{i=1..n} s_i IC_i over G1 for public scalars (vk_x): Straus,
// the 4-bit windows' doublings shared by all terms, zero digits skipped, each
// term's table built only as far as its largest digit.  points: n + 1
// affine points as in bn254_g1_mul, inf their n + 1 identity flags; scalars:
// n x 4 limbs.  out and the result as in bn254_g1_mul.
int bn254_g1_lincomb(long n, const u64 *points, const uint8_t *inf,
                     const u64 *scalars, u64 *out) {
  auto digit = [scalars](long i, int w) {
    return (scalars[4 * i + (w >> 4)] >> ((w & 15) * 4)) & 15;
  };
  std::vector<Jac<Fq>> table(16 * n);
  for (long i = 0; i < n; ++i) {
    u64 top = 0;
    for (int w = 0; w < 64; ++w) top = digit(i, w) > top ? digit(i, w) : top;
    Jac<Fq> *t = &table[16 * i];
    t[1] = load_point<Fq>(points + 8 * (i + 1), inf[i + 1]);
    for (u64 d = 2; d <= top; ++d) jac_add(t[d], t[d - 1], t[1]);
  }
  Jac<Fq> acc = jac_identity<Fq>();
  bool started = false;
  for (int w = 63; w >= 0; --w) {
    if (started)
      for (int j = 0; j < 4; ++j) jac_dbl(acc, acc);
    for (long i = 0; i < n; ++i) {
      u64 d = digit(i, w);
      if (d) {
        jac_add(acc, acc, table[16 * i + d]);
        started = true;
      }
    }
  }
  jac_add(acc, acc, load_point<Fq>(points, inf[0]));
  return store_point(out, acc);
}

// This thread's doublings, additions and table entries read since the last
// call, into out[0..2]; the counts restart at 0.
void bn254_group_op_counts(u64 *out) {
  memcpy(out, OPS, sizeof OPS);
  memset(OPS, 0, sizeof OPS);
}

// --- test exports (tests/test_torch_native_pairing.py) ---------------------

// The shared Miller loop over n pairs laid out as in bn254_pairing_check,
// no final exponentiation (tower-order Fq12 out); -1 on a point off its
// curve or a degenerate step, else 0.
int bn254_miller(long n, const u64 *g1, const u64 *g2, u64 *out) {
  using namespace pairing;
  init_constants();
  std::vector<Pair> ps;
  Fq12 f;
  if (!load_pairs(n, g1, g2, ps) || !miller(f, ps.data(), ps.size())) return -1;
  fq12_to_std(f, out);
  return 0;
}

void bn254_final_exp(const u64 *a, u64 *out) {
  using namespace pairing;
  init_constants();
  Fq12 x, r;
  fq12_from_std(x, a);
  final_exp(r, x);
  fq12_to_std(r, out);
}

// The same value by the generic power: the easy part, then
// fq12_pow(., (p^4 - p^2 + 1)/r).  The tests' twin of bn254_final_exp.
void bn254_final_exp_plain(const u64 *a, u64 *out) {
  using namespace pairing;
  init_constants();
  Fq12 x, r;
  fq12_from_std(x, a);
  final_exp_plain(r, x);
  fq12_to_std(r, out);
}

}  // extern "C"
