"""snarkjs/iden3 binary artifact formats: .zkey / .ptau / .wtns
(counterpart of zkfl_tpu/groth16/binformat.py; only write_ptau differs: it
takes a torch device, as groth16_setup does).

The reference's toolchain exchanges binary artifacts produced by snarkjs
(`groth16 setup` -> circuit.zkey, Hermez ceremony -> pot17_final.ptau,
witness calculator -> witness.wtns; full_system_simulation.mjs:713-780).
This module implements the iden3 "binfile" container and the three payload
layouts so our keys/witnesses are interchangeable with snarkjs at the BYTE
level (SURVEY §7 hard-part 4; VERDICT r1 item 10).

Container (iden3 binfile, snarkjs src/binfileutils.js):
    magic[4]  ascii type tag ("zkey", "ptau", "wtns")
    u32 LE    container version
    u32 LE    number of sections
    sections: u32 LE sectionType, u64 LE byteLength, payload

Field elements are fixed-width little-endian; **curve points inside zkey /
ptau are affine coordinates in MONTGOMERY form** (R = 2^256 for bn128) with
the point at infinity encoded as (0, 0) — snarkjs reads them straight into
ffjavascript's internal representation (src/zkey_utils.js readG1/writeG1).
Witness values in .wtns are plain (non-Montgomery) integers.

zkey sections (groth16, snarkjs src/zkey_utils.js writeHeader/write):
    1 header        u32 protocolId (1 = groth16)
    2 groth16 hdr   u32 n8q, q, u32 n8r, r, u32 nVars, u32 nPublic,
                    u32 domainSize, alpha1 G1, beta1 G1, beta2 G2,
                    gamma2 G2, delta1 G1, delta2 G2
    3 IC            (nPublic+1) x G1
    4 coeffs        u32 nCoeffs; per coeff: u32 matrix (0=A,1=B),
                    u32 constraint, u32 signal, n8r-byte Montgomery value
    5 pointsA       nVars x G1         [A_i(tau)]1
    6 pointsB1      nVars x G1         [B_i(tau)]1
    7 pointsB2      nVars x G2         [B_i(tau)]2
    8 pointsC       (nVars-nPublic-1) x G1
    9 pointsH       domainSize x G1 **
    10 contributions csHash + contribution records (empty on dev export)

** snarkjs's section 9 holds H_k = [L^{2n}_{2k+1}(tau)/delta]1 — the
   odd-indexed Lagrange basis of the DOUBLED domain (zkey_new.js builds it
   from ptau section 12's 2^(power+1) Lagrange block); its prover MSMs them
   against (A.B-C) evaluated at the odd 2n-th roots (the algebra is derived
   in setup.odd_lagrange_h_scalars).  Our dev setup emits EITHER basis
   (groth16_setup(h_basis=...)); read_zkey infers the basis from the
   contributions section (snarkjs files always carry contributions; our
   deterministic monomial dev exports have an empty section 10) and
   prover.groth16_prove consumes both (qap.compute_podd for the odd basis).

wtns sections: 1 header (u32 n8, r, u32 nWitness), 2 values.
ptau sections: 1 header (u32 n8, q, u32 power, u32 ceremonyPower),
    2 tauG1 (2*2^power-1 pts), 3 tauG2 (2^power), 4 alphaTauG1 (2^power),
    5 betaTauG1 (2^power), 6 betaG2 (1).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from .. import backend
from ..field.bn254 import FQ, FR
from ..field.curve import FixedBaseG2
from ..field.tower import FQ2
from ..r1cs.builder import ConstraintSystem
from .setup import Device, FixedBaseG1, ProvingKey, VerifyingKey

_R = 1 << 256
_Q_MONT = lambda x: x * _R % FQ
_Q_UNMONT = lambda x: x * pow(_R, -1, FQ) % FQ
_R_MONT = lambda x: x * _R % FR
_R_UNMONT = lambda x: x * pow(_R, -1, FR) % FR

N8Q = 32
N8R = 32


# ---------------------------------------------------------------------------
# binfile container
# ---------------------------------------------------------------------------


class BinWriter:
    def __init__(self, magic: str, version: int = 1):
        assert len(magic) == 4
        self.magic = magic.encode()
        self.version = version
        self.sections: List[Tuple[int, bytes]] = []

    def section(self, stype: int, payload: bytes):
        self.sections.append((stype, payload))

    def tobytes(self) -> bytes:
        out = [self.magic, struct.pack("<II", self.version, len(self.sections))]
        for stype, payload in self.sections:
            out.append(struct.pack("<IQ", stype, len(payload)))
            out.append(payload)
        return b"".join(out)

    def write(self, path: str):
        with open(path, "wb") as f:
            f.write(self.tobytes())


def read_binfile(data: bytes, expect_magic: str) -> Dict[int, bytes]:
    if data[:4] != expect_magic.encode():
        raise ValueError(f"bad magic {data[:4]!r}, expected {expect_magic!r}")
    _, n_sections = struct.unpack_from("<II", data, 4)
    sections: Dict[int, bytes] = {}
    off = 12
    for _ in range(n_sections):
        stype, size = struct.unpack_from("<IQ", data, off)
        off += 12
        sections[stype] = data[off : off + size]
        off += size
    return sections


# ---------------------------------------------------------------------------
# point / field codecs (Montgomery LE — the snarkjs on-disk form)
# ---------------------------------------------------------------------------


def _fq_bytes(x: int) -> bytes:
    return _Q_MONT(x % FQ).to_bytes(N8Q, "little")


def _fq_parse(b: bytes) -> int:
    return _Q_UNMONT(int.from_bytes(b, "little"))


def g1_bytes(p: Optional[tuple]) -> bytes:
    if p is None:
        return b"\x00" * (2 * N8Q)  # snarkjs zero-point encoding
    return _fq_bytes(p[0]) + _fq_bytes(p[1])


def g1_parse(b: bytes) -> Optional[tuple]:
    x = _fq_parse(b[:N8Q])
    y = _fq_parse(b[N8Q:])
    if x == 0 and y == 0:
        return None
    return (x, y)


def g2_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * (4 * N8Q)
    x, y = p
    return (
        _fq_bytes(x.coeffs[0]) + _fq_bytes(x.coeffs[1])
        + _fq_bytes(y.coeffs[0]) + _fq_bytes(y.coeffs[1])
    )


def g2_parse(b: bytes):
    c = [_fq_parse(b[i * N8Q : (i + 1) * N8Q]) for i in range(4)]
    if all(v == 0 for v in c):
        return None
    return (FQ2([c[0], c[1]]), FQ2([c[2], c[3]]))


# ---------------------------------------------------------------------------
# .zkey
# ---------------------------------------------------------------------------


def write_zkey(path: str, pk: ProvingKey, vk: VerifyingKey,
               cs: ConstraintSystem) -> None:
    """Serialise our proving key in the snarkjs groth16 zkey layout."""
    w = BinWriter("zkey")
    w.section(1, struct.pack("<I", 1))  # protocol: groth16

    n_vars = len(pk.a_query)
    hdr = [struct.pack("<I", N8Q), FQ.to_bytes(N8Q, "little"),
           struct.pack("<I", N8R), FR.to_bytes(N8R, "little"),
           struct.pack("<III", n_vars, pk.n_pub, pk.domain),
           g1_bytes(pk.alpha1), g1_bytes(pk.beta1), g2_bytes(pk.beta2),
           g2_bytes(vk.gamma2), g1_bytes(pk.delta1), g2_bytes(pk.delta2)]
    w.section(2, b"".join(hdr))

    w.section(3, b"".join(g1_bytes(p) for p in vk.ic))

    coeffs = []
    n_coeffs = 0
    for j, (A, B, _) in enumerate(cs.constraints):
        for matrix, row in ((0, A), (1, B)):
            for signal, value in row.items():
                coeffs.append(
                    struct.pack("<III", matrix, j, signal)
                    + _R_MONT(value).to_bytes(N8R, "little")
                )
                n_coeffs += 1
    w.section(4, struct.pack("<I", n_coeffs) + b"".join(coeffs))

    w.section(5, b"".join(g1_bytes(p) for p in pk.a_query))
    w.section(6, b"".join(g1_bytes(p) for p in pk.b1_query))
    w.section(7, b"".join(g2_bytes(p) for p in pk.b2_query))
    w.section(8, b"".join(g1_bytes(p) for p in pk.c_query))
    w.section(9, b"".join(g1_bytes(p) for p in pk.h_query))
    if getattr(pk, "h_basis", "monomial") == "odd_evals":
        # snarkjs-layout contributions (zkey_utils.js writeMPCParams):
        # csHash[64] + u32 count + per-contribution record.  A snarkjs zkey
        # always has >= 1 contribution; this dev-grade record is shaped like
        # one (deltaAfter G1, g1_s, g1_sx, g2_spx, transcript hash, type,
        # empty name) so readers that only length-check the section accept
        # it, and read_zkey uses its presence to infer the H basis.
        import hashlib as _hl

        cs_hash = _hl.sha512(b"zkfl-dev-zkey|" + cs.name.encode()).digest()
        record = (
            g1_bytes(pk.delta1)
            + g1_bytes((1, 2))            # g1_s (generator placeholder)
            + g1_bytes(pk.delta1)         # g1_sx
            + g2_bytes(pk.delta2)         # g2_spx
            + _hl.sha512(b"zkfl-dev-contrib").digest()  # transcript hash
            + struct.pack("<II", 0, 0)    # type, name length (no name)
        )
        w.section(10, cs_hash + struct.pack("<I", 1) + record)
    else:
        w.section(10, b"")  # contributions: none (deterministic dev setup)
    w.write(path)


def read_zkey(path: str) -> Tuple[ProvingKey, VerifyingKey, dict]:
    """Parse a groth16 zkey.  Returns (pk, vk, meta) where meta carries the
    raw coefficient table (matrix, constraint, signal, value).

    The H basis is inferred from the contributions section: snarkjs files
    (and our odd-basis exports) carry contributions and store section 9 in
    the odd-Lagrange basis of the doubled domain; a monomial dev export has
    an empty section 10.  The returned pk.h_basis routes the prover to the
    matching scalar computation (qap.compute_podd vs compute_h_coeffs), so
    read_zkey -> groth16_prove -> groth16_verify works for both layouts
    (use structure_from_zkey for the constraint system)."""
    with open(path, "rb") as f:
        data = f.read()
    sec = read_binfile(data, "zkey")
    (protocol,) = struct.unpack_from("<I", sec[1], 0)
    if protocol != 1:
        raise ValueError(f"not a groth16 zkey (protocol {protocol})")

    h = sec[2]
    off = 0
    (n8q,) = struct.unpack_from("<I", h, off); off += 4
    q = int.from_bytes(h[off : off + n8q], "little"); off += n8q
    (n8r,) = struct.unpack_from("<I", h, off); off += 4
    r = int.from_bytes(h[off : off + n8r], "little"); off += n8r
    if (q, r) != (FQ, FR):
        raise ValueError("zkey is not over bn128")
    n_vars, n_pub, domain = struct.unpack_from("<III", h, off); off += 12
    alpha1 = g1_parse(h[off : off + 2 * N8Q]); off += 2 * N8Q
    beta1 = g1_parse(h[off : off + 2 * N8Q]); off += 2 * N8Q
    beta2 = g2_parse(h[off : off + 4 * N8Q]); off += 4 * N8Q
    gamma2 = g2_parse(h[off : off + 4 * N8Q]); off += 4 * N8Q
    delta1 = g1_parse(h[off : off + 2 * N8Q]); off += 2 * N8Q
    delta2 = g2_parse(h[off : off + 4 * N8Q]); off += 4 * N8Q

    def g1_list(b):
        return [g1_parse(b[i : i + 2 * N8Q]) for i in range(0, len(b), 2 * N8Q)]

    def g2_list(b):
        return [g2_parse(b[i : i + 4 * N8Q]) for i in range(0, len(b), 4 * N8Q)]

    ic = g1_list(sec[3])
    (n_coeffs,) = struct.unpack_from("<I", sec[4], 0)
    coeffs = []
    off = 4
    stride = 12 + N8R
    for _ in range(n_coeffs):
        matrix, constraint, signal = struct.unpack_from("<III", sec[4], off)
        value = _R_UNMONT(
            int.from_bytes(sec[4][off + 12 : off + stride], "little")
        )
        coeffs.append((matrix, constraint, signal, value))
        off += stride

    h_basis = "monomial" if not sec.get(10) else "odd_evals"
    pk = ProvingKey(
        n_pub=n_pub, domain=domain,
        alpha1=alpha1, beta1=beta1, delta1=delta1,
        beta2=beta2, delta2=delta2,
        a_query=g1_list(sec[5]), b1_query=g1_list(sec[6]),
        b2_query=g2_list(sec[7]), c_query=g1_list(sec[8]),
        h_query=g1_list(sec[9]),
        h_basis=h_basis,
    )
    vk = VerifyingKey(alpha1=alpha1, beta2=beta2, gamma2=gamma2,
                      delta2=delta2, ic=ic)
    meta = {
        "n_vars": n_vars,
        "coeffs": coeffs,
        "h_basis": h_basis,
    }
    return pk, vk, meta


def structure_from_zkey(pk: ProvingKey, meta: dict) -> ConstraintSystem:
    """Provable ConstraintSystem from a parsed zkey's coefficient table.

    zkey section 4 stores only the A and B matrices — snarkjs recovers C's
    domain evaluations as A.B pointwise (valid for satisfying witnesses,
    which is all a prover can use).  The shim marks that with c_from_ab so
    groth16_prove's odd-basis path does the same; matrix evaluation and
    MSMs otherwise treat it as any structure-mode circuit."""
    n_vars = meta["n_vars"]
    n_cons = 1 + max((c for _, c, _, _ in meta["coeffs"]), default=0)
    constraints = [({}, {}, {}) for _ in range(n_cons)]
    for matrix, constraint, signal, value in meta["coeffs"]:
        constraints[constraint][matrix][signal] = value
    # Wire 0 is the constant-one wire: a caller that forgets to pass an
    # explicit witness must not silently prove the all-zeros assignment
    # (ADVICE r4 #4).  values[0] = 1 keeps the placeholder well-formed; the
    # remaining zeros still fail constraint satisfaction for any real
    # circuit, surfacing as a non-verifying proof rather than garbage in.
    cs = ConstraintSystem(
        name="zkey-import",
        values=[1] + [0] * (n_vars - 1),
        constraints=constraints,
        pub_names=[f"pub{i}" for i in range(pk.n_pub)],
    )
    cs.c_from_ab = True
    return cs


# ---------------------------------------------------------------------------
# .wtns
# ---------------------------------------------------------------------------


def write_wtns(path: str, witness: List[int]) -> None:
    w = BinWriter("wtns", version=2)
    w.section(1, struct.pack("<I", N8R) + FR.to_bytes(N8R, "little")
              + struct.pack("<I", len(witness)))
    w.section(2, b"".join((v % FR).to_bytes(N8R, "little") for v in witness))
    w.write(path)


def read_wtns(path: str) -> List[int]:
    with open(path, "rb") as f:
        sec = read_binfile(f.read(), "wtns")
    (n8,) = struct.unpack_from("<I", sec[1], 0)
    r = int.from_bytes(sec[1][4 : 4 + n8], "little")
    if r != FR:
        raise ValueError("wtns is not over bn128 Fr")
    (n,) = struct.unpack_from("<I", sec[1], 4 + n8)
    vals = sec[2]
    return [
        int.from_bytes(vals[i * n8 : (i + 1) * n8], "little") for i in range(n)
    ]


# ---------------------------------------------------------------------------
# .ptau (powers of tau; enough to feed a phase-2 setup)
# ---------------------------------------------------------------------------


def write_ptau(path: str, power: int, tau: int, alpha: int, beta: int,
               device: Device = "cuda") -> None:
    """Deterministic dev-grade powers-of-tau file in the snarkjs layout
    (replaces downloading pot17_final.ptau, README.md:225-231; NOT a real
    MPC ceremony — same caveat as groth16_setup).

    ``device`` as in groth16_setup: the five fixed-base batches run on a
    torch device (default the first CUDA card, which must exist; K4/K6 on a
    card, their plain torch versions on the CPU), or with None on the
    pure-Python ladder.  All give the same bytes."""
    n = 1 << power
    taus = [1] * (2 * n - 1)
    for i in range(1, 2 * n - 1):
        taus[i] = taus[i - 1] * tau % FR
    if device is not None:
        from .device_setup import batch_fixed_mul_g1, batch_fixed_mul_g2

        dev = backend.device(str(device))

        def g1(scalars):
            return batch_fixed_mul_g1(scalars, dev)

        def g2(scalars):
            return batch_fixed_mul_g2(scalars, dev)
    else:
        fb1, fb2 = FixedBaseG1(), FixedBaseG2()

        def g1(scalars):
            return [fb1.mul(s) if s % FR else None for s in scalars]

        def g2(scalars):
            return [fb2.mul(s) if s % FR else None for s in scalars]

    tau_g1 = g1(taus)
    tau_g2 = g2(taus[:n])
    alpha_tau_g1 = g1([alpha * t % FR for t in taus[:n]])
    beta_tau_g1 = g1([beta * t % FR for t in taus[:n]])
    beta_g2 = g2([beta])[0]

    w = BinWriter("ptau")
    w.section(1, struct.pack("<I", N8Q) + FQ.to_bytes(N8Q, "little")
              + struct.pack("<II", power, power))
    w.section(2, b"".join(g1_bytes(p) for p in tau_g1))
    w.section(3, b"".join(g2_bytes(p) for p in tau_g2))
    w.section(4, b"".join(g1_bytes(p) for p in alpha_tau_g1))
    w.section(5, b"".join(g1_bytes(p) for p in beta_tau_g1))
    w.section(6, g2_bytes(beta_g2))
    w.write(path)


def read_ptau(path: str) -> dict:
    with open(path, "rb") as f:
        sec = read_binfile(f.read(), "ptau")
    (n8,) = struct.unpack_from("<I", sec[1], 0)
    q = int.from_bytes(sec[1][4 : 4 + n8], "little")
    if q != FQ:
        raise ValueError("ptau is not over bn128")
    power, ceremony_power = struct.unpack_from("<II", sec[1], 4 + n8)

    def g1_list(b):
        return [g1_parse(b[i : i + 2 * N8Q]) for i in range(0, len(b), 2 * N8Q)]

    def g2_list(b):
        return [g2_parse(b[i : i + 4 * N8Q]) for i in range(0, len(b), 4 * N8Q)]

    return {
        "power": power,
        "ceremony_power": ceremony_power,
        "tau_g1": g1_list(sec[2]),
        "tau_g2": g2_list(sec[3]),
        "alpha_tau_g1": g1_list(sec[4]),
        "beta_tau_g1": g1_list(sec[5]),
        "beta_g2": g2_parse(sec[6]),
    }
