"""The CUDA kernels' arithmetic (zkfl_tpu_torch/csrc/bn254.cuh and
poseidon.cuh), compiled for the host with g++ and held against Python
integers.

The kernels themselves run only on a card (chip_smoke.py compares them with
their plain torch versions there); their per-element functions are
__host__ __device__, so the exact code they inline is checked here.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from zkfl_tpu.field.bn254 import FQ, FR
from zkfl_tpu.field.curve import G1_GEN, g1_add, g1_mul, g1_neg
from zkfl_tpu_torch.field.limbs import FQ_CONSTS, FR_CONSTS, R, ints_to_limbs, limbs_to_ints

CSRC = Path(__file__).resolve().parent.parent / "zkfl_tpu_torch" / "csrc"

HARNESS = r"""
#include "bn254.cuh"
#include "poseidon.cuh"
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
using namespace zk;

template <class F>
void field_op(const char* op, const uint32_t* in, uint32_t* out) {
  const uint32_t* a = in; const uint32_t* b = in + NL; const uint32_t* c = in + 2 * NL;
  if (!strcmp(op, "mont_mul")) mont_mul<F>(out, a, b);
  else if (!strcmp(op, "mont_sqr")) mont_sqr<F>(out, a);
  else if (!strcmp(op, "add")) add<F>(out, a, b);
  else if (!strcmp(op, "sub")) sub<F>(out, a, b);
  else if (!strcmp(op, "to_mont")) to_mont<F>(out, a);
  else if (!strcmp(op, "from_mont")) from_mont<F>(out, a);
  else if (!strcmp(op, "mul_sub_mul_const")) {  // a, b, c, k
    uint32_t t[NL]; mont_mul<F>(t, a, b); sub<F>(t, t, c); mont_mul<F>(out, t, in + 3 * NL);
  } else if (!strcmp(op, "butterfly")) {  // u, v, tw -> hi, lo
    uint32_t t[NL]; mont_mul<F>(t, b, c); add<F>(out, a, t); sub<F>(out + NL, a, t);
  } else if (!strcmp(op, "normalize_raw")) {
    int64_t cols[NL]; memcpy(cols, in, sizeof cols); normalize_raw<F>(out, cols);
  } else { fprintf(stderr, "bad op %s\n", op); exit(2); }
}

void g1_op(const char* op, const uint32_t* in, uint32_t* out) {
  G1 p, q, r;
  memcpy(&p, in, sizeof p);
  if (!strcmp(op, "padd")) { memcpy(&q, in + 3 * NL, sizeof q); g1_padd(r, p, q); }
  else g1_pdbl(r, p);
  memcpy(out, &r, sizeof r);
}

// consts: the round constants, then the MDS matrix (Montgomery elements).
template <int T>
void poseidon_op(const uint32_t* consts, const uint32_t* in, uint32_t* out) {
  uint32_t s[T][NL];
  memcpy(s, in, sizeof s);
  poseidon_permute<T>(s, consts, consts + (POSEIDON_RF + poseidon_rp(T)) * T * NL);
  memcpy(out, s, sizeof s);
}

void poseidon_t(int t, const uint32_t* consts, const uint32_t* in, uint32_t* out) {
  if (t == 2) poseidon_op<2>(consts, in, out);
  else if (t == 3) poseidon_op<3>(consts, in, out);
  else if (t == 17) poseidon_op<17>(consts, in, out);
  else { fprintf(stderr, "bad width %d\n", t); exit(2); }
}

int main(int argc, char** argv) {
  const char* field = argv[1]; const char* op = argv[2];
  int in_words = atoi(argv[3]), out_words = atoi(argv[4]);
  std::vector<uint32_t> in(in_words), out(out_words), consts;
  if (argc > 5) {  // a file of extra words: the Poseidon constants
    FILE* f = fopen(argv[5], "rb");
    uint32_t w;
    while (fread(&w, 4, 1, f) == 1) consts.push_back(w);
    fclose(f);
  }
  while (fread(in.data(), 4, in_words, stdin) == (size_t)in_words) {
    if (!strcmp(field, "fr")) field_op<Fr>(op, in.data(), out.data());
    else if (!strcmp(field, "fq")) field_op<Fq>(op, in.data(), out.data());
    else if (!strcmp(field, "poseidon")) poseidon_t(atoi(op), consts.data(), in.data(), out.data());
    else g1_op(op, in.data(), out.data());
    fwrite(out.data(), 4, out_words, stdout);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' arithmetic for the host")
    d = tmp_path_factory.mktemp("csrc")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = d / "harness"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", f"-I{CSRC}", "-o", str(exe), str(src)],
        check=True, capture_output=True,
    )

    def run(field, op, records, out_words, consts=None):
        """records: uint32 [n, in_words] -> uint32 [n, out_words]; consts:
        a file of extra words for the op (the Poseidon constants)."""
        records = np.ascontiguousarray(records, dtype=np.uint32)
        extra = [str(consts)] if consts is not None else []
        res = subprocess.run(
            [str(exe), field, op, str(records.shape[1]), str(out_words), *extra],
            input=records.tobytes(), capture_output=True, check=True,
        )
        return np.frombuffer(res.stdout, dtype=np.uint32).reshape(-1, out_words)

    return run


rng = np.random.RandomState(11)


def _rand(p, n):
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)] + [0, 1, p - 1]


def _words(xs):
    """ints -> uint32 [n, 8] (one element per row)."""
    return ints_to_limbs(xs).view(np.uint32).T


def _ints(words):
    return limbs_to_ints(np.ascontiguousarray(words.T).view(np.int32))


@pytest.mark.parametrize("name,p", [("fr", FR), ("fq", FQ)])
def test_field_ops_match_integers(harness, name, p):
    c = FR_CONSTS if name == "fr" else FQ_CONSTS
    rinv = pow(c.mont_r, -1, p)
    a = _rand(p, 40)
    b = list(reversed(_rand(p, 40)))
    cc = _rand(p, 40)
    k = 987654321 * c.mont_r % p
    ab = np.concatenate([_words(a), _words(b)], axis=1)
    assert _ints(harness(name, "mont_mul", ab, 8)) == [x * y * rinv % p for x, y in zip(a, b)]
    assert _ints(harness(name, "mont_sqr", _words(a), 8)) == [x * x * rinv % p for x in a]
    assert _ints(harness(name, "add", ab, 8)) == [(x + y) % p for x, y in zip(a, b)]
    assert _ints(harness(name, "sub", ab, 8)) == [(x - y) % p for x, y in zip(a, b)]
    assert _ints(harness(name, "to_mont", _words(a), 8)) == [x * c.mont_r % p for x in a]
    assert _ints(harness(name, "from_mont", _words(a), 8)) == [x * rinv % p for x in a]
    # from_mont takes any 256-bit input (normalize_raw relies on it)
    big = [R - 1, R - 2, p, 2 * p + 5]
    assert _ints(harness(name, "from_mont", _words(big), 8)) == [x * rinv % p for x in big]
    abck = np.concatenate([ab, _words(cc), _words([k] * len(a))], axis=1)
    got = _ints(harness(name, "mul_sub_mul_const", abck, 8))
    assert got == [(x * y * rinv - z) * k * rinv % p for x, y, z in zip(a, b, cc)]


def test_butterfly_and_normalize_raw(harness):
    p = FR
    rinv = pow(FR_CONSTS.mont_r, -1, p)
    u, v, tw = _rand(p, 30), _rand(p, 30)[::-1], _rand(p, 30)
    rec = np.concatenate([_words(u), _words(v), _words(tw)], axis=1)
    out = harness("fr", "butterfly", rec, 16)
    t = [y * w * rinv % p for y, w in zip(v, tw)]
    assert _ints(out[:, :8]) == [(x + s) % p for x, s in zip(u, t)]
    assert _ints(out[:, 8:]) == [(x - s) % p for x, s in zip(u, t)]
    # int64 column sums of up to 2^31 32-bit limbs
    cols = rng.randint(0, 2**62, size=(50, 8), dtype=np.int64)
    cols[0] = 0
    cols[1] = 2**63 - 1
    cols[2, :] = [0] * 7 + [2**63 - 1]
    out = _ints(harness("fr", "normalize_raw", cols.view(np.uint32), 8))
    want = [sum(int(v) << (32 * j) for j, v in enumerate(row)) % p for row in cols]
    assert out == want


def _g1_words(pts):
    """Affine points (None = identity) -> uint32 [n, 24] Montgomery X, Y, Z."""
    rq = FQ_CONSTS.mont_r
    xs = [0 if q is None else q[0] * rq % FQ for q in pts]
    ys = [rq if q is None else q[1] * rq % FQ for q in pts]
    zs = [0 if q is None else rq for q in pts]
    return np.concatenate([_words(xs), _words(ys), _words(zs)], axis=1)


def _g1_affine(words):
    out = []
    rinv = pow(FQ_CONSTS.mont_r, -1, FQ)
    xs, ys, zs = (_ints(words[:, 8 * i : 8 * i + 8]) for i in range(3))
    for x, y, z in zip(xs, ys, zs):
        x, y, z = (v * rinv % FQ for v in (x, y, z))
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, FQ)
            out.append((x * zi % FQ, y * zi % FQ))
    return out


def test_g1_padd_pdbl(harness):
    pts = [g1_mul(G1_GEN, 3 + 7 * i) for i in range(5)]
    ps = [pts[0], None, pts[1], pts[2], pts[3], None]
    qs = [pts[1], pts[2], None, pts[2], g1_neg(pts[3]), None]
    out = harness("g1", "padd", np.concatenate([_g1_words(ps), _g1_words(qs)], axis=1), 24)
    assert _g1_affine(out) == [g1_add(a, b) for a, b in zip(ps, qs)]
    out = harness("g1", "pdbl", _g1_words(pts + [None]), 24)
    assert _g1_affine(out) == [g1_add(a, a) for a in pts + [None]]


@pytest.mark.parametrize("t", [2, 3, 17])
def test_poseidon_permutation(harness, tmp_path, t):
    """poseidon.cuh's permutation (K5's per-thread body) against the
    reference, on an all-(p-1) state, the zero state and random states."""
    from zkfl_tpu.poseidon.grain import poseidon_params
    from zkfl_tpu.poseidon.reference import poseidon_permutation

    rr = FR_CONSTS.mont_r
    rinv = pow(rr, -1, FR)
    C, M = poseidon_params(t)
    consts = tmp_path / "consts.bin"
    consts.write_bytes(_words([v * rr % FR for v in C + [x for row in M for x in row]]).tobytes())
    states = [[FR - 1] * t, [0] * t] + [_rand(FR, t)[:t] for _ in range(3)]
    flat = [v * rr % FR for st in states for v in st]
    out = harness("poseidon", str(t), _words(flat).reshape(len(states), 8 * t), 8 * t, consts)
    got = [v * rinv % FR for v in _ints(out.reshape(-1, 8))]
    want = [v for st in states for v in poseidon_permutation(st)]
    assert got == want
