// BN254 optimal-ate pairing — native host verifier hot path.
//
// Replaces the pure-Python pairing (zkfl_tpu/field/pairing.py) for Groth16
// verification: the reference verifies in ~8-9 ms/proof via snarkjs
// (ref:Report.pdf Table 3; subprocess at
// ref:tests/full_system_simulation.mjs:865-868), and the Python Miller loop
// costs ~800 ms/proof — this library brings the 4-term pairing-product
// check to single-digit milliseconds.
//
// Layout: 4x64-bit Montgomery Fq; tower Fq2 = Fq[u]/(u^2+1),
// Fq6 = Fq2[v]/(v^3 - (9+u)), Fq12 = Fq6[w]/(w^2 - v).  G2 inputs are
// affine points of the D-twist E': y^2 = x^3 + 3/(9+u); the Miller loop
// runs in twist coordinates with sparse line values (w^0, w^1, w^3).
// The boolean product==1 result is tower-isomorphism invariant, so this
// agrees with the Python oracle's py_ecc-style FQ12 basis.
//
// Build: g++ -O2 -shared -fPIC -o ../zkfl_tpu/libzkfl_pairing.so zkfl_pairing.cpp

#include <cstdint>
#include <cstring>

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

static inline bool geq(const u64 a[4], const u64 b[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] != b[i]) return a[i] > b[i];
  }
  return true;
}

static inline void sub_nocarry(u64 r[4], const u64 a[4], const u64 b[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - b[i] - borrow;
    r[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

static inline void fq_add(Fq &r, const Fq &a, const Fq &b) {
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.l[i] + b.l[i] + carry;
    r.l[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || geq(r.l, P)) sub_nocarry(r.l, r.l, P);
}

static inline void fq_sub(Fq &r, const Fq &a, const Fq &b) {
  u128 borrow = 0;
  u64 t[4];
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.l[i] - b.l[i] - borrow;
    t[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)t[i] + P[i] + carry;
      t[i] = (u64)s;
      carry = s >> 64;
    }
  }
  memcpy(r.l, t, sizeof t);
}

static inline void fq_neg(Fq &r, const Fq &a) {
  bool zero = !(a.l[0] | a.l[1] | a.l[2] | a.l[3]);
  if (zero) { memset(r.l, 0, sizeof r.l); return; }
  sub_nocarry(r.l, P, a.l);
}

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
  if (t[4] || geq(t, P)) sub_nocarry(out.l, t, P);
  else memcpy(out.l, t, 4 * sizeof(u64));
}

static inline void fq_sqr(Fq &r, const Fq &a) { fq_mul(r, a, a); }

static const Fq FQ_ZERO = {{0, 0, 0, 0}};
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
static inline void fq2_neg(Fq2 &r, const Fq2 &a) {
  fq_neg(r.c0, a.c0); fq_neg(r.c1, a.c1);
}
static inline void fq2_conj(Fq2 &r, const Fq2 &a) {
  r.c0 = a.c0; fq_neg(r.c1, a.c1);
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

static inline void fq2_sqr(Fq2 &r, const Fq2 &a) { fq2_mul(r, a, a); }

static inline void fq2_mul_fq(Fq2 &r, const Fq2 &a, const Fq &s) {
  fq_mul(r.c0, a.c0, s); fq_mul(r.c1, a.c1, s);
}

// (9 + u) * a
static inline void fq2_mul_xi(Fq2 &r, const Fq2 &a) {
  Fq t0 = a.c0, t1 = a.c1, nine0, nine1;
  Fq2 out;
  fq_add(nine0, t0, t0); fq_add(nine0, nine0, nine0);  // 4a0
  fq_add(nine0, nine0, nine0);                          // 8a0
  fq_add(nine0, nine0, t0);                             // 9a0
  fq_add(nine1, t1, t1); fq_add(nine1, nine1, nine1);
  fq_add(nine1, nine1, nine1);
  fq_add(nine1, nine1, t1);                             // 9a1
  fq_sub(out.c0, nine0, t1);   // 9a0 - a1
  fq_add(out.c1, nine1, t0);   // 9a1 + a0
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
// Fq6 = Fq2[v]/(v^3 - xi)
// ---------------------------------------------------------------------------

struct Fq6 { Fq2 c0, c1, c2; };

static const Fq6 FQ6_ZERO = {FQ2_ZERO, FQ2_ZERO, FQ2_ZERO};
static const Fq6 FQ6_ONE = {FQ2_ONE, FQ2_ZERO, FQ2_ZERO};

static inline void fq6_add(Fq6 &r, const Fq6 &a, const Fq6 &b) {
  fq2_add(r.c0, a.c0, b.c0); fq2_add(r.c1, a.c1, b.c1);
  fq2_add(r.c2, a.c2, b.c2);
}
static inline void fq6_sub(Fq6 &r, const Fq6 &a, const Fq6 &b) {
  fq2_sub(r.c0, a.c0, b.c0); fq2_sub(r.c1, a.c1, b.c1);
  fq2_sub(r.c2, a.c2, b.c2);
}
static inline void fq6_neg(Fq6 &r, const Fq6 &a) {
  fq2_neg(r.c0, a.c0); fq2_neg(r.c1, a.c1); fq2_neg(r.c2, a.c2);
}

static void fq6_mul(Fq6 &r, const Fq6 &a, const Fq6 &b) {
  Fq2 t00, t11, t22, t12, t21, t01, t10, t02, t20, x;
  fq2_mul(t00, a.c0, b.c0);
  fq2_mul(t11, a.c1, b.c1);
  fq2_mul(t22, a.c2, b.c2);
  fq2_mul(t12, a.c1, b.c2);
  fq2_mul(t21, a.c2, b.c1);
  fq2_mul(t01, a.c0, b.c1);
  fq2_mul(t10, a.c1, b.c0);
  fq2_mul(t02, a.c0, b.c2);
  fq2_mul(t20, a.c2, b.c0);
  Fq6 out;
  fq2_add(x, t12, t21); fq2_mul_xi(x, x); fq2_add(out.c0, t00, x);
  fq2_add(x, t01, t10);
  Fq2 y; fq2_mul_xi(y, t22); fq2_add(out.c1, x, y);
  fq2_add(x, t02, t20); fq2_add(out.c2, x, t11);
  r = out;
}

static inline void fq6_mul_v(Fq6 &r, const Fq6 &a) {
  // v * (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2
  Fq2 t; fq2_mul_xi(t, a.c2);
  Fq6 out = {t, a.c0, a.c1};
  r = out;
}

static void fq6_inv(Fq6 &r, const Fq6 &a) {
  Fq2 A, B, C, t, x;
  fq2_sqr(A, a.c0);
  fq2_mul(t, a.c1, a.c2); fq2_mul_xi(t, t);
  fq2_sub(A, A, t);                       // a0^2 - xi a1 a2
  fq2_sqr(B, a.c2); fq2_mul_xi(B, B);
  fq2_mul(t, a.c0, a.c1);
  fq2_sub(B, B, t);                       // xi a2^2 - a0 a1
  fq2_sqr(C, a.c1);
  fq2_mul(t, a.c0, a.c2);
  fq2_sub(C, C, t);                       // a1^2 - a0 a2
  Fq2 den, d1, d2;
  fq2_mul(den, a.c0, A);
  fq2_mul(d1, a.c2, B); fq2_mul(d2, a.c1, C);
  fq2_add(d1, d1, d2); fq2_mul_xi(d1, d1);
  fq2_add(den, den, d1);                  // a0 A + xi(a2 B + a1 C)
  Fq2 di; fq2_inv(di, den);
  fq2_mul(r.c0, A, di);
  fq2_mul(r.c1, B, di);
  fq2_mul(r.c2, C, di);
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

static inline void fq12_sqr(Fq12 &r, const Fq12 &a) { fq12_mul(r, a, a); }

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

// ---------------------------------------------------------------------------
// Frobenius constants
// ---------------------------------------------------------------------------

static Fq2 make_fq2(u64 a0, u64 a1, u64 a2, u64 a3, u64 b0, u64 b1, u64 b2,
                    u64 b3) {
  Fq2 r;
  Fq x = {{a0, a1, a2, a3}}, y = {{b0, b1, b2, b3}};
  fq_to_mont(r.c0, x);
  fq_to_mont(r.c1, y);
  return r;
}

// gamma1_j = xi^(j(p-1)/6), j = 2 (twist x), 3 (twist y) — G2 Frobenius.
static Fq2 FROB_X, FROB_Y;
// gamma2_j = xi^(j(p^2-1)/6) are REAL (Fq); j = 1..5 for the Fq12
// Frobenius^2, j = 2 for -pi_p^2 on twist x.
static Fq G2C[6];  // G2C[j] for j=1..5 (index 0 unused = 1)

static void init_constants() {
  static bool done = false;
  if (done) return;
  done = true;
  FROB_X = make_fq2(0x99e39557176f553dULL, 0xb78cc310c2c3330cULL,
                    0x4c0bec3cf559b143ULL, 0x2fb347984f7911f7ULL,
                    0x1665d51c640fcba2ULL, 0x32ae2a1d0b7c9dceULL,
                    0x4ba4cc8bd75a0794ULL, 0x16c9e55061ebae20ULL);
  FROB_Y = make_fq2(0xdc54014671a0135aULL, 0xdbaae0eda9c95998ULL,
                    0xdc5ec698b6e2f9b9ULL, 0x063cf305489af5dcULL,
                    0x82d37f632623b0e3ULL, 0x21807dc98fa25bd2ULL,
                    0x0704b5a7ec796f2bULL, 0x07c03cbcac41049aULL);
  struct { u64 l[4]; } g2raw[6] = {
      {{0, 0, 0, 0}},
      {{0xe4bd44e5607cfd49ULL, 0xc28f069fbb966e3dULL, 0x5e6dd9e7e0acccb0ULL,
        0x30644e72e131a029ULL}},
      {{0xe4bd44e5607cfd48ULL, 0xc28f069fbb966e3dULL, 0x5e6dd9e7e0acccb0ULL,
        0x30644e72e131a029ULL}},
      {{0x3c208c16d87cfd46ULL, 0x97816a916871ca8dULL, 0xb85045b68181585dULL,
        0x30644e72e131a029ULL}},
      {{0x5763473177fffffeULL, 0xd4f263f1acdb5c4fULL, 0x59e26bcea0d48bacULL,
        0x0ULL}},
      {{0x5763473177ffffffULL, 0xd4f263f1acdb5c4fULL, 0x59e26bcea0d48bacULL,
        0x0ULL}},
  };
  for (int j = 1; j <= 5; ++j) {
    Fq x; memcpy(x.l, g2raw[j].l, sizeof x.l);
    fq_to_mont(G2C[j], x);
  }
}

// Frobenius^2 on Fq12: coefficient at w^j scales by real gamma2_j.
static void fq12_frob2(Fq12 &r, const Fq12 &a) {
  // coefficients: c0 = (A, B, C) at w^0, w^2, w^4; c1 = (D, E, F) at
  // w^1, w^3, w^5
  r.c0.c0 = a.c0.c0;
  fq2_mul_fq(r.c0.c1, a.c0.c1, G2C[2]);
  fq2_mul_fq(r.c0.c2, a.c0.c2, G2C[4]);
  fq2_mul_fq(r.c1.c0, a.c1.c0, G2C[1]);
  fq2_mul_fq(r.c1.c1, a.c1.c1, G2C[3]);
  fq2_mul_fq(r.c1.c2, a.c1.c2, G2C[5]);
}

// ---------------------------------------------------------------------------
// Miller loop (twist affine coordinates)
// ---------------------------------------------------------------------------

// 6x+2 = 29793968203157093288 is a 65-bit value; the loop starts at R = Q
// (the implicit bit 64) and scans bits 63..0, so only the low 64 bits are
// stored: 29793968203157093288 - 2^64.
static const u64 ATE = 11347224129447541672ULL;
static const int ATE_LOG = 63;                   // loop from bit 63 down

struct G1Aff { Fq x, y; };      // Montgomery form
struct G2Aff { Fq2 x, y; };     // twist coords, Montgomery form

// Sparse line value: l = a + b w + c w^3 (a = scalar Fq embedded in Fq2).
static void line_to_fq12(Fq12 &r, const Fq2 &a, const Fq2 &b, const Fq2 &c) {
  r.c0.c0 = a; r.c0.c1 = FQ2_ZERO; r.c0.c2 = FQ2_ZERO;
  r.c1.c0 = b; r.c1.c1 = c; r.c1.c2 = FQ2_ZERO;
}

// f *= line(lambda through R, evaluated at P); helper shared by dbl/add.
static void apply_line(Fq12 &f, const Fq2 &lam, const G2Aff &R,
                       const G1Aff &P) {
  // l = (-yp) + (lam * xp) w + (yR - lam xR) w^3
  Fq2 a = FQ2_ZERO, b, c, t;
  fq_neg(a.c0, P.y);
  fq2_mul_fq(b, lam, P.x);
  fq2_mul(t, lam, R.x);
  fq2_sub(c, R.y, t);
  Fq12 l; line_to_fq12(l, a, b, c);
  fq12_mul(f, f, l);
}

// R <- 2R, f *= f * line.  Returns false on degenerate (yR = 0).
static bool dbl_step(Fq12 &f, G2Aff &R, const G1Aff &P) {
  if (fq2_is_zero(R.y)) return false;
  Fq2 xx, three_xx, two_y, inv, lam, t, x3, y3;
  fq2_sqr(xx, R.x);
  fq2_add(three_xx, xx, xx); fq2_add(three_xx, three_xx, xx);
  fq2_add(two_y, R.y, R.y);
  fq2_inv(inv, two_y);
  fq2_mul(lam, three_xx, inv);
  fq12_sqr(f, f);
  apply_line(f, lam, R, P);
  fq2_sqr(t, lam);
  fq2_sub(t, t, R.x); fq2_sub(x3, t, R.x);
  fq2_sub(t, R.x, x3); fq2_mul(t, lam, t); fq2_sub(y3, t, R.y);
  R.x = x3; R.y = y3;
  return true;
}

// R <- R + Q, f *= line.  Returns false on degenerate (xR == xQ).
static bool add_step(Fq12 &f, G2Aff &R, const G2Aff &Q, const G1Aff &P) {
  if (fq2_eq(R.x, Q.x)) return false;
  Fq2 dy, dx, inv, lam, t, x3, y3;
  fq2_sub(dy, Q.y, R.y);
  fq2_sub(dx, Q.x, R.x);
  fq2_inv(inv, dx);
  fq2_mul(lam, dy, inv);
  apply_line(f, lam, R, P);
  fq2_sqr(t, lam);
  fq2_sub(t, t, R.x); fq2_sub(x3, t, Q.x);
  fq2_sub(t, R.x, x3); fq2_mul(t, lam, t); fq2_sub(y3, t, R.y);
  R.x = x3; R.y = y3;
  return true;
}

// Miller loop; multiplies this pair's loop value into `acc` (each pair
// needs its OWN running f — the f^2 doubling steps must not square the
// previously accumulated product).
static bool miller(Fq12 &acc, const G1Aff &P, const G2Aff &Q) {
  Fq12 f = FQ12_ONE;
  G2Aff R = Q;
  for (int i = ATE_LOG; i >= 0; --i) {
    if (!dbl_step(f, R, P)) return false;
    if ((ATE >> i) & 1) {
      if (!add_step(f, R, Q, P)) return false;
    }
  }
  // Frobenius steps: Q1 = pi_p(Q), add; then -pi_p^2(Q), add.
  G2Aff Q1, Q2n;
  Fq2 cx, cy;
  fq2_conj(cx, Q.x); fq2_mul(Q1.x, cx, FROB_X);
  fq2_conj(cy, Q.y); fq2_mul(Q1.y, cy, FROB_Y);
  fq2_mul_fq(Q2n.x, Q.x, G2C[2]);   // xi^((p^2-1)/3) real
  Q2n.y = Q.y;                      // -(y * -1) = y
  if (!add_step(f, R, Q1, P)) return false;
  if (!add_step(f, R, Q2n, P)) return false;
  fq12_mul(acc, acc, f);
  return true;
}

// Hard-part exponent (p^4 - p^2 + 1)/r, big-endian bytes (761 bits).
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

static void final_exp(Fq12 &r, const Fq12 &f) {
  Fq12 fc, fi, f1, f2;
  fq12_conj(fc, f);
  fq12_inv(fi, f);
  fq12_mul(f1, fc, fi);        // f^(p^6 - 1)
  fq12_frob2(f2, f1);
  fq12_mul(f1, f2, f1);        // ^(p^2 + 1)
  fq12_pow(r, f1, HARD_EXP, 96);
}

// ---------------------------------------------------------------------------
// Entry point
// ---------------------------------------------------------------------------

extern "C" {

// g1: n x 8 u64 limbs (x, y little-endian standard form)
// g2: n x 16 u64 limbs (x.c0, x.c1, y.c0, y.c1) — twist coords
// returns 1 if prod e(P_i, Q_i) == 1, 0 if != 1, -1 on degenerate input
// (caller falls back to the Python oracle).
int bn254_pairing_check(long n, const u64 *g1, const u64 *g2) {
  init_constants();
  Fq12 f = FQ12_ONE;
  for (long i = 0; i < n; ++i) {
    G1Aff P;
    Fq x = {{g1[i * 8 + 0], g1[i * 8 + 1], g1[i * 8 + 2], g1[i * 8 + 3]}};
    Fq y = {{g1[i * 8 + 4], g1[i * 8 + 5], g1[i * 8 + 6], g1[i * 8 + 7]}};
    fq_to_mont(P.x, x);
    fq_to_mont(P.y, y);
    G2Aff Q;
    Fq a = {{g2[i * 16 + 0], g2[i * 16 + 1], g2[i * 16 + 2], g2[i * 16 + 3]}};
    Fq b = {{g2[i * 16 + 4], g2[i * 16 + 5], g2[i * 16 + 6], g2[i * 16 + 7]}};
    Fq c = {{g2[i * 16 + 8], g2[i * 16 + 9], g2[i * 16 + 10], g2[i * 16 + 11]}};
    Fq d = {{g2[i * 16 + 12], g2[i * 16 + 13], g2[i * 16 + 14], g2[i * 16 + 15]}};
    fq_to_mont(Q.x.c0, a); fq_to_mont(Q.x.c1, b);
    fq_to_mont(Q.y.c0, c); fq_to_mont(Q.y.c1, d);
    if ((fq_is_zero(P.x) && fq_is_zero(P.y)) ||
        (fq2_is_zero(Q.x) && fq2_is_zero(Q.y)))
      continue;  // identity factor contributes 1
    if (!miller(f, P, Q)) return -1;
  }
  Fq12 out;
  final_exp(out, f);
  return fq12_is_one(out) ? 1 : 0;
}

// --- debug/test exports (used by tests/test_native.py) --------------------

// in/out: 4 u64 limbs standard form
void bn254_fq_mul(const u64 *a, const u64 *b, u64 *out) {
  init_constants();
  Fq am, bm, r, one = {{1, 0, 0, 0}};
  Fq x = {{a[0], a[1], a[2], a[3]}}, y = {{b[0], b[1], b[2], b[3]}};
  fq_to_mont(am, x); fq_to_mont(bm, y);
  fq_mul(r, am, bm);
  fq_mul(r, r, one);  // from Montgomery
  memcpy(out, r.l, 4 * sizeof(u64));
}

// Fq12 as 12 Fq coefficients in tower order c0.(c0,c1,c2) then c1.(c0,c1,c2),
// each Fq2 as (c0, c1): 12 x 4 u64 standard form.
static void fq12_from_std(Fq12 &r, const u64 *a) {
  Fq2 *cs[6] = {&r.c0.c0, &r.c0.c1, &r.c0.c2, &r.c1.c0, &r.c1.c1, &r.c1.c2};
  for (int i = 0; i < 6; ++i) {
    Fq x = {{a[i * 8 + 0], a[i * 8 + 1], a[i * 8 + 2], a[i * 8 + 3]}};
    Fq y = {{a[i * 8 + 4], a[i * 8 + 5], a[i * 8 + 6], a[i * 8 + 7]}};
    fq_to_mont(cs[i]->c0, x);
    fq_to_mont(cs[i]->c1, y);
  }
}

static void fq12_to_std(const Fq12 &a, u64 *out) {
  const Fq2 *cs[6] = {&a.c0.c0, &a.c0.c1, &a.c0.c2,
                      &a.c1.c0, &a.c1.c1, &a.c1.c2};
  Fq one = {{1, 0, 0, 0}};
  for (int i = 0; i < 6; ++i) {
    Fq r0, r1;
    fq_mul(r0, cs[i]->c0, one);
    fq_mul(r1, cs[i]->c1, one);
    memcpy(out + i * 8, r0.l, 4 * sizeof(u64));
    memcpy(out + i * 8 + 4, r1.l, 4 * sizeof(u64));
  }
}

void bn254_fq12_mul(const u64 *a, const u64 *b, u64 *out) {
  init_constants();
  Fq12 x, y, r;
  fq12_from_std(x, a); fq12_from_std(y, b);
  fq12_mul(r, x, y);
  fq12_to_std(r, out);
}

void bn254_fq12_inv(const u64 *a, u64 *out) {
  init_constants();
  Fq12 x, r;
  fq12_from_std(x, a);
  fq12_inv(r, x);
  fq12_to_std(r, out);
}

void bn254_fq12_frob2(const u64 *a, u64 *out) {
  init_constants();
  Fq12 x, r;
  fq12_from_std(x, a);
  fq12_frob2(r, x);
  fq12_to_std(r, out);
}

// Miller loop of one pair, NO final exp (tower-order Fq12 out).
int bn254_miller(const u64 *g1, const u64 *g2, u64 *out) {
  init_constants();
  Fq12 f = FQ12_ONE;
  G1Aff P;
  Fq x = {{g1[0], g1[1], g1[2], g1[3]}};
  Fq y = {{g1[4], g1[5], g1[6], g1[7]}};
  fq_to_mont(P.x, x); fq_to_mont(P.y, y);
  G2Aff Q;
  Fq a = {{g2[0], g2[1], g2[2], g2[3]}}, b = {{g2[4], g2[5], g2[6], g2[7]}};
  Fq c = {{g2[8], g2[9], g2[10], g2[11]}},
     d = {{g2[12], g2[13], g2[14], g2[15]}};
  fq_to_mont(Q.x.c0, a); fq_to_mont(Q.x.c1, b);
  fq_to_mont(Q.y.c0, c); fq_to_mont(Q.y.c1, d);
  if (!miller(f, P, Q)) return -1;
  fq12_to_std(f, out);
  return 0;
}

void bn254_final_exp(const u64 *a, u64 *out) {
  init_constants();
  Fq12 x, r;
  fq12_from_std(x, a);
  final_exp(r, x);
  fq12_to_std(r, out);
}

}  // extern "C"
