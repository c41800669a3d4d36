"""The CUDA kernels' arithmetic (zkfl_tpu_torch/csrc/bn254.cuh and
poseidon.cuh), compiled for the host with g++ and held against Python
integers.

The kernels themselves run only on a card (chip_smoke.py compares them with
their plain torch versions there); their per-element functions are
__host__ __device__, so the exact code they inline is checked here.  The
point formulas (rcb_padd / rcb_pdbl) run here over the host policies: Fq
for G1, Fq2Pair for G2, which computes each coefficient with K6's per-thread
ops (fq2_mul_half, fq2_mul_add_half, fq2_sqr_half, fq2_mul_b3_half); only
K6's exchange between the two threads of a point (__shfl_xor_sync) and the
card's carry-chain forms (mont_mul_cc, mont_sum2_cc, mont_sum4_cc, redc_cc,
mul_wide_acc_cc) are left to the card.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from zkfl_tpu.field.bn254 import FQ, FR
from zkfl_tpu.field.curve import G1_GEN, TWIST_B, g1_add, g1_mul, g1_neg, g2_add, g2_generator, g2_mul_jac, g2_neg
from zkfl_tpu.field.tower import FQ2
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

// Operands a, b, c, d of 16 words each, as many as the op takes.
void fq2_op(const char* op, const uint32_t* in, uint32_t* out) {
  Fq2Pair::El a, b, c, d, r;
  memcpy(&a, in, sizeof a);
  if (!strcmp(op, "b3_scale")) {
    for (int j = 0; j < NL; ++j) out[j] = g2_b3_scale(j);
    return;
  }
  if (!strcmp(op, "mul")) { memcpy(&b, in + 2 * NL, sizeof b); Fq2Pair{}.mul(r, a, b); }
  else if (!strcmp(op, "sqr")) Fq2Pair{}.sqr(r, a);
  else if (!strcmp(op, "mul_b3")) Fq2Pair{}.mul_b3(r, a);
  else {
    memcpy(&b, in + 2 * NL, sizeof b); memcpy(&c, in + 4 * NL, sizeof c); memcpy(&d, in + 6 * NL, sizeof d);
    if (!strcmp(op, "mul_add")) Fq2Pair{}.mul_add(r, a, b, c, d);
    else if (!strcmp(op, "mul_sub")) Fq2Pair{}.mul_sub(r, a, b, c, d);
    else { fprintf(stderr, "bad op %s\n", op); exit(2); }
  }
  memcpy(out, &r, sizeof r);
}

void g2_op(const char* op, const uint32_t* in, uint32_t* out) {
  G2 p, q, r;
  memcpy(&p, in, sizeof p);
  if (!strcmp(op, "padd")) { memcpy(&q, in + 6 * NL, sizeof q); g2_padd(r, p, q); }
  else g2_pdbl(r, p);
  memcpy(out, &r, sizeof r);
}

// consts: K5's two buffers, c then m (Montgomery elements); "dot" takes
// t lanes then t constants from the record and reduces their sum once.
template <int T>
void poseidon_op(const char* op, const uint32_t* consts, const uint32_t* in, uint32_t* out) {
  uint32_t s[T][NL];
  memcpy(s, in, sizeof s);
  if (!strcmp(op, "dot")) {
    poseidon_dot<T>(out, in + T * NL, s);
    return;
  }
  poseidon_permute<T>(s, consts, consts + (POSEIDON_RF * T + poseidon_rp(T)) * NL);
  memcpy(out, s, sizeof s);
}

void poseidon_t(const char* op, int t, const uint32_t* consts, const uint32_t* in, uint32_t* out) {
  if (t == 2) poseidon_op<2>(op, consts, in, out);
  else if (t == 3) poseidon_op<3>(op, consts, in, out);
  else if (t == 5) poseidon_op<5>(op, consts, in, out);
  else if (t == 9) poseidon_op<9>(op, consts, in, out);
  else if (t == 17) poseidon_op<17>(op, consts, in, out);
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
    else if (!strcmp(field, "poseidon")) poseidon_t("permute", atoi(op), consts.data(), in.data(), out.data());
    else if (!strcmp(field, "poseidon_dot")) poseidon_t("dot", atoi(op), consts.data(), in.data(), out.data());
    else if (!strcmp(field, "fq2")) fq2_op(op, in.data(), out.data());
    else if (!strcmp(field, "g2")) g2_op(op, in.data(), out.data());
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


def test_normalize_raw_quotient_edges(harness):
    """normalize_raw's fold and quotient step at the edges of its estimate:
    T = k p - 1, k p and k p + 1 for k from 1 to the largest that the
    columns can carry, all-zero and all-(2^63 - 1) columns, and random
    columns over the whole int64 range."""
    from chip_smoke import T_MAX, carried_cols, normalize_edge_cols

    p = FR
    k_max = (T_MAX - 1) // p
    ts = [0, T_MAX]
    for k in (1, 2, 5, 6, 7, 2**20 + 3, 2**31, 2**31 + 5, k_max - 1, k_max):
        ts += [k * p - 1, k * p, k * p + 1]
    rows = [carried_cols(t) for t in ts]
    assert [sum(c << (32 * j) for j, c in enumerate(r)) for r in rows] == ts
    assert all(0 <= c < 2**63 for r in rows for c in r)
    cols = np.concatenate([np.array(rows, dtype=np.int64),
                           rng.randint(0, 2**63 - 1, size=(40, 8), dtype=np.int64)])
    out = _ints(harness("fr", "normalize_raw", cols.view(np.uint32), 8))
    want = [sum(int(v) << (32 * j) for j, v in enumerate(row)) % p for row in cols]
    assert out == want
    assert out[2:32:3] == [p - 1] * 10 and out[3:32:3] == [0] * 10
    edge = normalize_edge_cols(p)  # the rows chip_smoke.py adds to K3's check
    assert [sum(int(v) << (32 * j) for j, v in enumerate(c)) % p for c in edge.T] == [0, p - 1] * 7


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


def test_g1_extreme_representatives(harness):
    """Projective representatives whose X, Y or Z has the Montgomery limbs
    of p - 1 (the multiply's extreme inputs)."""
    rq = FQ_CONSTS.mont_r
    ext = (-pow(rq, -1, FQ)) % FQ  # Montgomery representative p - 1
    pts = [g1_mul(G1_GEN, 5 + 13 * i) for i in range(6)]
    projs = []
    for i, (x, y) in enumerate(pts):
        lam = ext * pow((x, y, 1)[i % 3], -1, FQ) % FQ
        projs.append(tuple(v * lam % FQ for v in (x, y, 1)))
    words = np.concatenate([_words([pr[c] * rq % FQ for pr in projs]) for c in range(3)], axis=1)
    assert all(_ints(words[i : i + 1, 8 * (i % 3) : 8 * (i % 3) + 8]) == [FQ - 1] for i in range(6))
    q = np.roll(words, 1, axis=0)
    out = harness("g1", "padd", np.concatenate([words, q], axis=1), 24)
    assert _g1_affine(out) == [g1_add(a, b) for a, b in zip(pts, pts[-1:] + pts[:-1])]
    assert _g1_affine(harness("g1", "pdbl", words, 24)) == [g1_add(a, a) for a in pts]


# ---------------------------------------------------------------------------
# Fq2 and G2 (Fq2Pair over K6's per-thread ops)
# ---------------------------------------------------------------------------


def _fq2_words(vals):
    """(c0, c1) pairs of Montgomery ints -> uint32 [n, 16]."""
    return np.concatenate([_words([v[0] for v in vals]), _words([v[1] for v in vals])], axis=1)


def _fq2_ints(words):
    return list(zip(_ints(words[:, :8]), _ints(words[:, 8:16])))


def test_fq2_products_match_integers(harness):
    p, rinv = FQ, pow(FQ_CONSTS.mont_r, -1, FQ)
    a = list(zip(_rand(p, 30), reversed(_rand(p, 30))))
    b = list(zip(reversed(_rand(p, 30)), _rand(p, 30)))
    a += [(0, 0), (p - 1, p - 1), (1, p - 1)]
    b += [(p - 1, p - 1), (p - 1, p - 1), (p - 1, 1)]

    def mul(x, y):
        return ((x[0] * y[0] - x[1] * y[1]) * rinv % p, (x[0] * y[1] + x[1] * y[0]) * rinv % p)

    out = harness("fq2", "mul", np.concatenate([_fq2_words(a), _fq2_words(b)], axis=1), 16)
    assert _fq2_ints(out) == [mul(x, y) for x, y in zip(a, b)]
    b3 = tuple(3 * c % p * FQ_CONSTS.mont_r % p for c in TWIST_B.coeffs)
    assert _fq2_ints(harness("fq2", "mul_b3", _fq2_words(a), 16)) == [mul(x, b3) for x in a]


def test_fq2_lazy_ops_match_integers(harness):
    """K6's Fq2 ops as Fq2Pair computes each coefficient: the lazy product
    (2 wide products, 1 reduction), the sum and the difference of two
    products (4 wide products, 1 reduction), the squaring (1 product) and b3
    by additions and a product by 9/82.  Operands: every combination of the
    coefficients 0, 1 and p - 1 (3^4 products, 3^8 sums and differences;
    all p - 1 is the largest lazy sum, and a difference with d = 0 negates
    it to the operand p), then random ones."""
    p, rr = FQ, FQ_CONSTS.mont_r
    rinv = pow(rr, -1, p)
    edge = [(x, y) for x in (0, 1, p - 1) for y in (0, 1, p - 1)]
    rand = list(zip(_rand(p, 37), reversed(_rand(p, 37))))

    def mul(x, y):
        return ((x[0] * y[0] - x[1] * y[1]) * rinv % p, (x[0] * y[1] + x[1] * y[0]) * rinv % p)

    def lin(x, y, sign):
        return tuple((u + sign * v) % p for u, v in zip(x, y))

    def run(op, operands, n_out=16):
        return _fq2_ints(harness("fq2", op, np.concatenate([_fq2_words(o) for o in operands], axis=1),
                                 n_out))

    pairs = [(x, y) for x in edge for y in edge] + list(zip(rand, reversed(rand)))
    a, b = map(list, zip(*pairs))
    assert run("mul", [a, b]) == [mul(x, y) for x, y in zip(a, b)]
    quads = [(w, x, y, z) for w in edge for x in edge for y in edge for z in edge]
    quads += [(rand[i], rand[i - 1], rand[i - 2], rand[i - 3]) for i in range(len(rand))]
    quads += [(x, x, x, (0, 0)) for x in rand]
    cols = list(map(list, zip(*quads)))
    for op, sign in (("mul_add", 1), ("mul_sub", -1)):
        got = run(op, cols)
        assert got == [lin(mul(w, x), mul(y, z), sign) for w, x, y, z in quads], op
    one = edge + rand
    assert run("sqr", [one]) == [mul(x, x) for x in one]
    b3 = tuple(3 * c % p * rr % p for c in TWIST_B.coeffs)
    assert run("mul_b3", [one]) == [mul(x, b3) for x in one]
    k = _ints(harness("fq2", "b3_scale", np.zeros((1, 16), np.uint32), 8))[0]
    assert k == 9 * pow(82, -1, p) * rr % p
    assert tuple(c * rinv % p for c in b3) == (9 * k * rinv % p, -k * rinv % p)


def _g2_words(projs):
    """Standard-form projective ((x0, x1), (y0, y1), (z0, z1)) -> uint32
    [n, 48] Montgomery X, Y, Z, each c0 then c1."""
    rq, projs = FQ_CONSTS.mont_r, list(projs)
    return np.concatenate([_fq2_words([tuple(c * rq % FQ for c in pr[k]) for pr in projs])
                           for k in range(3)], axis=1)


def _g2_proj(pt):
    if pt is None:
        return ((0, 0), (1, 0), (0, 0))
    return (tuple(pt[0].coeffs), tuple(pt[1].coeffs), (1, 0))


def _g2_affine(words):
    rinv = pow(FQ_CONSTS.mont_r, -1, FQ)
    out = []
    for row in words:
        c = [v * rinv % FQ for v in _ints(row.reshape(6, 8))]
        x, y, z = (FQ2(c[2 * k : 2 * k + 2]) for k in range(3))
        out.append(None if z.is_zero() else (x / z, y / z))
    return out


def _g2_key(pts):
    return [None if q is None else tuple(tuple(c.coeffs) for c in q) for q in pts]


def test_g2_padd_pdbl(harness):
    """RCB15 over Fq2Pair: random points, O+Q, P+O, P+P, P+(-P), O+O, and
    representatives scaled (by a real lambda, or lambda u where the target
    coefficient is 0) so that each coefficient of X, Y and Z in turn has the
    Montgomery representative p - 1."""
    g = g2_generator()
    pts = [g2_mul_jac(g, 7 + 19 * i) for i in range(8)]
    ps = pts[:2] + [None, pts[2], pts[3], pts[4], None]
    qs = pts[5:7] + [pts[7], None, pts[3], g2_neg(pts[4]), None]
    out = harness("g2", "padd", np.concatenate([_g2_words(map(_g2_proj, ps)),
                                                _g2_words(map(_g2_proj, qs))], axis=1), 48)
    assert _g2_key(_g2_affine(out)) == _g2_key(g2_add(a, b) for a, b in zip(ps, qs))
    out = harness("g2", "pdbl", _g2_words(map(_g2_proj, ps)), 48)
    assert _g2_key(_g2_affine(out)) == _g2_key(g2_add(a, a) for a in ps)

    ext = (-pow(FQ_CONSTS.mont_r, -1, FQ)) % FQ
    projs = []
    for i, pt in enumerate(pts[:6]):
        xyz = _g2_proj(pt)
        c, comp = xyz[i // 2], i % 2
        uc = c if c[comp] else ((-c[1]) % FQ, c[0])
        mu = ext * pow(uc[comp], -1, FQ) % FQ
        lam = (mu, 0) if c[comp] else (0, mu)
        projs.append(tuple(((lam[0] * v[0] - lam[1] * v[1]) % FQ, (lam[0] * v[1] + lam[1] * v[0]) % FQ)
                           for v in xyz))
    words = _g2_words(projs)
    assert [_ints(words[i : i + 1, 8 * i : 8 * i + 8]) for i in range(6)] == [[FQ - 1]] * 6
    q = np.roll(words, 1, axis=0)
    out = harness("g2", "padd", np.concatenate([words, q], axis=1), 48)
    base = pts[:6]
    assert _g2_key(_g2_affine(out)) == _g2_key(g2_add(a, b) for a, b in zip(base, base[-1:] + base[:-1]))
    assert _g2_key(_g2_affine(harness("g2", "pdbl", words, 48))) == _g2_key(g2_add(a, a) for a in base)


@pytest.mark.parametrize("t", [2, 3, 5, 9, 17])
def test_poseidon_permutation(harness, tmp_path, t):
    """poseidon.cuh's optimized permutation (K5's per-thread body) on the
    optimized constants against the JAX package's reference, on an
    all-(p-1) state, the zero state and random states."""
    from zkfl_tpu.poseidon.reference import poseidon_permutation
    from zkfl_tpu_torch.poseidon.optimized import optimized_params

    rr = FR_CONSTS.mont_r
    rinv = pow(rr, -1, FR)
    c, m = optimized_params(t).kernel_buffers()
    consts = tmp_path / "consts.bin"
    consts.write_bytes(_words([v * rr % FR for v in c + m]).tobytes())
    states = [[FR - 1] * t, [0] * t] + [_rand(FR, t)[:t] for _ in range(3)]
    flat = [v * rr % FR for st in states for v in st]
    out = harness("poseidon", str(t), _words(flat).reshape(len(states), 8 * t), 8 * t, consts)
    got = [v * rinv % FR for v in _ints(out.reshape(-1, 8))]
    want = [v for st in states for v in poseidon_permutation(st)]
    assert got == want


@pytest.mark.parametrize("t", [2, 3, 5, 9, 17])
def test_poseidon_lazy_dot(harness, t):
    """One reduction of a t-term sum of products (the mix's lanes): the
    worst case, every lane and constant p - 1, comes out canonical, and so do
    random sums."""
    rinv = pow(FR_CONSTS.mont_r, -1, FR)
    rows = [[FR - 1] * 2 * t, [0] * 2 * t, [1] * 2 * t] + [_rand(FR, 2 * t)[:2 * t] for _ in range(6)]
    recs = np.stack([_words(row).reshape(-1) for row in rows])
    got = _ints(harness("poseidon_dot", str(t), recs, 8))
    want = [sum(x * y for x, y in zip(row[:t], row[t:])) * rinv % FR for row in rows]
    assert got == want
    assert got[0] == t * (FR - 1) ** 2 * rinv % FR


def test_point_and_normalize_counts():
    """The yardsticks costs.py (chip_smoke.py's cost model) and
    kernel_stats.py count for K6 and K3: G2 add 4,144 and double 2,688
    multiply-adds a point (lazy Karatsuba, squarings of 2 products, b3 by
    additions and 2 products), normalize_raw 20 a lane (a byte bound); K6's
    code per thread in products."""
    from zkfl_tpu_torch import costs
    from zkfl_tpu_torch import kernel_stats as ks

    assert costs.POINT_COST["g2.padd"] == (4144, 576)
    assert costs.POINT_COST["g2.pdbl"] == (2688, 384)
    assert costs.op_cost("g2.pdbl times=8") == (8 * 2688, 384)
    assert costs.op_cost("fr.normalize_raw") == (20, 96)
    assert costs.bound("fr.normalize_raw", 1 << 18, 1980.0)[1] == "bytes"
    got = {name: ks.products_of(name, 3)[0] * 136 for name in ("g2_padd", "g2_pdbl")}
    assert got == {"g2_padd": pytest.approx(2456), "g2_pdbl": pytest.approx(1536)}


def test_launch_bounds_sweep_rewrites_both_hints():
    """launch_bounds.py sets the minimum-blocks literal of each K6 entry and
    nothing else."""
    import re

    from zkfl_tpu_torch import launch_bounds

    src = (CSRC / "g2_point.cu").read_text()
    out = launch_bounds.with_hints(src, (5, 7))
    assert re.findall(r"__launch_bounds__\(THREADS, (\d+)\)\s+(g2_\w+)_kernel", out) == [
        ("5", "g2_padd"), ("7", "g2_pdbl")]
    assert len(out) == len(src)
