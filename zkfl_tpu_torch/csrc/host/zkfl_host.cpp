// Native host-side crypto for the ZK-FL stack.
//
// Plays the role circomlibjs/WASM plays for the reference host code
// (buildPoseidon at full_system_simulation.mjs:134-137 and every
// commitment/Merkle/PRF helper built on it): batched Poseidon over
// BN254-Fr with 4x64-bit Montgomery limbs and __uint128_t MACs.
// Exposed via a C ABI consumed through ctypes (zkfl_tpu/native.py).
//
// Layout: field elements are 4 little-endian u64 limbs, Montgomery form
// internally, standard form at the ABI boundary.

#include <cstdint>
#include <cstring>

#include "poseidon_constants.h"

typedef unsigned __int128 u128;

// BN254-Fr modulus and Montgomery constants (R = 2^256).
static const uint64_t P[4] = {
    0x43e1f593f0000001ull, 0x2833e84879b97091ull,
    0xb85045b68181585dull, 0x30644e72e131a029ull};
// -p^-1 mod 2^64
static const uint64_t NINV = 0xc2e1f593efffffffull;
// R^2 mod p (for to-Montgomery conversion)
static const uint64_t R2[4] = {
    0x1bb8e645ae216da7ull, 0x53fe3ab1e35c59e3ull,
    0x8c49833d53bb8085ull, 0x0216d0b17f4e44a5ull};

struct Fr {
  uint64_t v[4];
};

static inline bool geq_p(const uint64_t a[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] > P[i]) return true;
    if (a[i] < P[i]) return false;
  }
  return true;  // equal
}

static inline void sub_p(uint64_t a[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - P[i] - borrow;
    a[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

static inline void fr_add(Fr &out, const Fr &a, const Fr &b) {
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    out.v[i] = (uint64_t)s;
    carry = s >> 64;
  }
  if (carry || geq_p(out.v)) sub_p(out.v);
}

// CIOS Montgomery multiplication: out = a*b*R^-1 mod p.
static inline void fr_mul(Fr &out, const Fr &a, const Fr &b) {
  uint64_t t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 cur = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
      t[j] = (uint64_t)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[4] + carry;
    t[4] = (uint64_t)cur;
    t[5] = (uint64_t)(cur >> 64);

    uint64_t m = t[0] * NINV;
    carry = ((u128)t[0] + (u128)m * P[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 c2 = (u128)t[j] + (u128)m * P[j] + carry;
      t[j - 1] = (uint64_t)c2;
      carry = c2 >> 64;
    }
    cur = (u128)t[4] + carry;
    t[3] = (uint64_t)cur;
    t[4] = t[5] + (uint64_t)(cur >> 64);
  }
  std::memcpy(out.v, t, 32);
  if (t[4] || geq_p(out.v)) sub_p(out.v);
}

static inline void fr_sqr(Fr &out, const Fr &a) { fr_mul(out, a, a); }

static inline void to_mont(Fr &out, const Fr &a) {
  Fr r2;
  std::memcpy(r2.v, R2, 32);
  fr_mul(out, a, r2);
}

static inline void from_mont(Fr &out, const Fr &a) {
  Fr one = {{1, 0, 0, 0}};
  fr_mul(out, a, one);
}

static inline void sbox5(Fr &x) {
  Fr x2, x4;
  fr_sqr(x2, x);
  fr_sqr(x4, x2);
  fr_mul(x, x4, x);
}

// One Poseidon permutation, state width t (2..17), Montgomery in/out.
static void poseidon_permute(Fr *state, int t) {
  const uint64_t *Cc = POSEIDON_C[t];
  const uint64_t *Mm = POSEIDON_M[t];
  const int rp = POSEIDON_RP[t];
  const int rf_half = POSEIDON_RF / 2;
  const int n_rounds = POSEIDON_RF + rp;
  Fr tmp[17];
  int cidx = 0;
  for (int r = 0; r < n_rounds; ++r) {
    for (int i = 0; i < t; ++i) {
      Fr c;
      std::memcpy(c.v, Cc + (cidx + i) * 4, 32);
      fr_add(state[i], state[i], c);
    }
    cidx += t;
    if (r < rf_half || r >= rf_half + rp) {
      for (int i = 0; i < t; ++i) sbox5(state[i]);
    } else {
      sbox5(state[0]);
    }
    // MDS: tmp[i] = sum_j M[i][j] * state[j]
    for (int i = 0; i < t; ++i) {
      Fr acc = {{0, 0, 0, 0}};
      for (int j = 0; j < t; ++j) {
        Fr m, prod;
        std::memcpy(m.v, Mm + (i * t + j) * 4, 32);
        fr_mul(prod, m, state[j]);
        fr_add(acc, acc, prod);
      }
      tmp[i] = acc;
    }
    std::memcpy(state, tmp, t * sizeof(Fr));
  }
}

extern "C" {

// Batched Poseidon hash: n rows of `arity` field elements (std form,
// 4x64 LE limbs) -> n hashes.  arity in 1..16.
void poseidon_hash_batch(int arity, long n, const uint64_t *in, uint64_t *out) {
  int t = arity + 1;
  for (long row = 0; row < n; ++row) {
    Fr state[17];
    std::memset(state[0].v, 0, 32);
    for (int i = 0; i < arity; ++i) {
      Fr x;
      std::memcpy(x.v, in + (row * arity + i) * 4, 32);
      to_mont(state[i + 1], x);
    }
    poseidon_permute(state, t);
    Fr res;
    from_mont(res, state[0]);
    std::memcpy(out + row * 4, res.v, 32);
  }
}

// Chunked VectorHash (vector_hash.circom:46-89): dim <= 16 -> direct
// Poseidon; else 16-ary chunks then hash-of-hashes (last chunk unpadded).
void vector_hash_batch(int dim, long n, const uint64_t *in, uint64_t *out) {
  if (dim <= 16) {
    poseidon_hash_batch(dim, n, in, out);
    return;
  }
  int n_chunks = (dim + 15) / 16;
  for (long row = 0; row < n; ++row) {
    uint64_t chunk_hashes[17 * 4];
    for (int c = 0; c < n_chunks; ++c) {
      int start = c * 16;
      int len = dim - start < 16 ? dim - start : 16;
      poseidon_hash_batch(len, 1, in + (row * dim + start) * 4,
                          chunk_hashes + c * 4);
    }
    poseidon_hash_batch(n_chunks, 1, chunk_hashes, out + row * 4);
  }
}

// Merkle tree build over pre-hashed leaves: n = 2^depth leaves in, writes
// all levels consecutively (leaves first) into `nodes` (2n-1 elements).
void merkle_build(long n, const uint64_t *leaves, uint64_t *nodes) {
  std::memcpy(nodes, leaves, n * 32);
  long off = 0;
  long width = n;
  while (width > 1) {
    const uint64_t *src = nodes + off * 4;
    uint64_t *dst = nodes + (off + width) * 4;
    poseidon_hash_batch(2, width / 2, src, dst);
    off += width;
    width /= 2;
  }
}

}  // extern "C"
