"""Groth16 trusted setup (deterministic, test-grade).

Replaces the reference's `snarkjs groth16 setup` + ptau ceremony
(full_system_simulation.mjs:713-736, README.md:225-231).  The environment has
no network access to Hermez ptau files, so we run our own phase-1+2 with
toxic waste derived deterministically from a seed.  THIS IS FOR
DEVELOPMENT/BENCHMARKING: anyone knowing the seed can forge proofs; a
production deployment would substitute a real MPC ceremony (the key formats
are identical).

Key equations (Groth16, asymmetric pairing):
  pk: [alpha]1, [beta]1, [delta]1, [beta]2, [delta]2,
      A_i = [A_i(tau)]1,  B1_i = [B_i(tau)]1,  B2_i = [B_i(tau)]2,
      C_i = [(beta A_i(tau) + alpha B_i(tau) + C_i(tau)) / delta]1  (private i),
      H_k = [tau^k Z(tau) / delta]1  for k = 0..n-2.
  vk: [alpha]1, [beta]2, [gamma]2, [delta]2,
      IC_i = [(beta A_i + alpha B_i + C_i) / gamma]1  (public i, incl. wire 0).
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import pickle
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import torch

from .. import backend
from ..field.bn254 import FR, domain_size_for, fr_batch_inv, fr_inv, fr_nth_root
from ..field.curve import (
    FixedBaseG2,
    g1_add_jac,
    g1_double_jac,
    g1_from_jacobian,
    g1_generator,
    g1_to_jacobian,
)
from ..r1cs.builder import ConstraintSystem
from ..r1cs.compiled import n_constraints

# Where the fixed-base batches run: a torch device (or its name), or None
# for the pure-Python ladder.
Device = Union[torch.device, str, None]


class FixedBaseG1:
    """Windowed fixed-base multiplier for many scalars times one G1 base."""

    WINDOW = 8

    def __init__(self, base=None):
        base = base or g1_generator()
        self.tables = []
        cur = g1_to_jacobian(base)
        n_windows = (256 + self.WINDOW - 1) // self.WINDOW
        for _ in range(n_windows):
            row = [(1, 1, 0)]
            acc = (1, 1, 0)
            for _ in range((1 << self.WINDOW) - 1):
                acc = g1_add_jac(acc, cur)
                row.append(acc)
            self.tables.append(row)
            for _ in range(self.WINDOW):
                cur = g1_double_jac(cur)

    def mul(self, k: int):
        k %= FR
        acc = (1, 1, 0)
        w = 0
        mask = (1 << self.WINDOW) - 1
        while k:
            d = k & mask
            if d:
                acc = g1_add_jac(acc, self.tables[w][d])
            k >>= self.WINDOW
            w += 1
        return g1_from_jacobian(acc)

    def mul_many(self, scalars):
        return [self.mul(s) for s in scalars]


@dataclass
class ProvingKey:
    n_pub: int
    domain: int
    alpha1: tuple
    beta1: tuple
    delta1: tuple
    beta2: tuple
    delta2: tuple
    a_query: List[Optional[tuple]]       # [A_i(tau)]1, all wires
    b1_query: List[Optional[tuple]]      # [B_i(tau)]1, all wires
    b2_query: List[Optional[tuple]]      # [B_i(tau)]2, all wires
    c_query: List[Optional[tuple]]       # private wires only (index i - n_pub - 1)
    h_query: List[Optional[tuple]]       # see h_basis
    # "monomial":  H_k = [tau^k Z(tau)/delta]1, k = 0..domain-2; the prover
    #              MSMs them with h(X)'s coefficients.
    # "odd_evals": H_k = [L^{2n}_{2k+1}(tau)/delta]1, k = 0..domain-1 — the
    #              odd-indexed Lagrange basis of the DOUBLED domain, which is
    #              what snarkjs stores in zkey section 9 (built from ptau
    #              section 12's 2^(power+1) Lagrange block; the prover MSMs
    #              them with (A.B-C) evaluated at the odd 2n-th roots,
    #              full_system_simulation.mjs:770-780's `groth16 prove`).
    # Old pickled keys predate the field: always read via
    # getattr(pk, "h_basis", "monomial").
    h_basis: str = "monomial"


@dataclass
class VerifyingKey:
    alpha1: tuple
    beta2: tuple
    gamma2: tuple
    delta2: tuple
    ic: List[Optional[tuple]]            # public wires incl. constant-1 wire


def _toxic_waste(seed: str) -> Tuple[int, int, int, int, int]:
    out = []
    for tag in ("tau", "alpha", "beta", "gamma", "delta"):
        h = hashlib.sha256(f"zkfl-setup|{seed}|{tag}".encode()).digest()
        out.append(int.from_bytes(h + hashlib.sha256(h).digest(), "big") % FR or 1)
    return tuple(out)


def lagrange_evals_at(tau: int, n: int) -> List[int]:
    """L_j(tau) for the size-n roots-of-unity domain, via batch inversion:
    L_j(tau) = (tau^n - 1) * w^j / (n * (tau - w^j))."""
    w = fr_nth_root(n)
    z_tau = (pow(tau, n, FR) - 1) % FR
    if z_tau == 0:
        raise ValueError("tau landed inside the domain; pick another seed")
    powers = [1] * n
    for j in range(1, n):
        powers[j] = powers[j - 1] * w % FR
    denoms = [(tau - powers[j]) % FR for j in range(n)]
    inv_denoms = fr_batch_inv(denoms)
    n_inv = fr_inv(n)
    scale = z_tau * n_inv % FR
    return [scale * powers[j] % FR * inv_denoms[j] % FR for j in range(n)]


def wire_evals(cs: ConstraintSystem, tau: int, domain: int):
    """A_i(tau), B_i(tau), C_i(tau) per wire via one pass over constraints."""
    lag = lagrange_evals_at(tau, domain)
    m = cs.n_wires
    a = [0] * m
    b = [0] * m
    c = [0] * m
    for j, (A, B, C) in enumerate(cs.constraints):
        lj = lag[j]
        for wdx, coef in A.items():
            a[wdx] = (a[wdx] + coef * lj) % FR
        for wdx, coef in B.items():
            b[wdx] = (b[wdx] + coef * lj) % FR
        for wdx, coef in C.items():
            c[wdx] = (c[wdx] + coef * lj) % FR
    return a, b, c


def odd_lagrange_h_scalars(tau: int, delta_inv: int, domain: int) -> List[int]:
    """L^{2n}_{2k+1}(tau)/delta for k = 0..domain-1 (snarkjs H basis).

    L_j^{2n}(tau) = (tau^{2n}-1) w^j / (2n (tau - w^j)), w = 2n-th root.
    Correctness: for a satisfying witness P = A.B - C vanishes on the even
    points (the domain), so sum_k P(odd_k) L^{2n}_{2k+1}(tau) = P(tau)
    = h(tau) Z(tau) — the same group element the monomial basis yields."""
    n2 = 2 * domain
    w = fr_nth_root(n2)
    z2 = (pow(tau, n2, FR) - 1) % FR
    if z2 == 0:
        raise ValueError("tau landed inside the doubled domain")
    n2_inv = fr_inv(n2)
    scale = z2 * n2_inv % FR * delta_inv % FR
    wj = [pow(w, 2 * k + 1, FR) for k in range(domain)]
    inv_denoms = fr_batch_inv([(tau - x) % FR for x in wj])
    return [scale * x % FR * d % FR for x, d in zip(wj, inv_denoms)]


def groth16_setup(
    cs: ConstraintSystem,
    seed: str = "zkfl-dev",
    domain: Optional[int] = None,
    h_basis: str = "monomial",
    device: Device = "cuda",
) -> Tuple[ProvingKey, VerifyingKey]:
    """Phase-1+2 setup.  With a ``device`` (default the first CUDA card,
    which must exist) every fixed-base encryption batch runs as one table
    gather and five levels of point additions on that device
    (groth16/device_setup.py: K4/K6 on a card, their plain torch versions
    on the CPU); ``device=None`` keeps the pure-Python ladder, the oracle.
    Both give the same keys.

    `domain` overrides the evaluation-domain size (must be a power of two
    >= the natural size).  A Groth16 QAP over a larger domain is equally
    valid (the extra interpolation points carry zero rows); sharing one
    domain across circuits lets the device prover reuse ONE compiled
    pipeline for all of them (groth16/device_prover.PipelineProfile)."""
    tau, alpha, beta, gamma, delta = _toxic_waste(seed)
    natural = domain_size_for(len(cs.constraints) + 1)
    domain = domain or natural
    if domain < natural or domain & (domain - 1):
        raise ValueError(f"domain {domain} invalid (natural {natural})")
    m = cs.n_wires
    n_pub = cs.n_pub

    a_t, b_t, c_t = wire_evals(cs, tau, domain)

    gamma_inv = fr_inv(gamma)
    delta_inv = fr_inv(delta)

    def kterm(i):
        return (beta * a_t[i] + alpha * b_t[i] + c_t[i]) % FR

    ic_scalars = [kterm(i) * gamma_inv % FR for i in range(n_pub + 1)]
    c_scalars = [kterm(i) * delta_inv % FR for i in range(n_pub + 1, m)]

    if h_basis == "odd_evals":
        h_scalars = odd_lagrange_h_scalars(tau, delta_inv, domain)
    elif h_basis == "monomial":
        z_tau = (pow(tau, domain, FR) - 1) % FR
        h_scalars = []
        t_pow = 1
        for _ in range(domain - 1):
            h_scalars.append(t_pow * z_tau % FR * delta_inv % FR)
            t_pow = t_pow * tau % FR
    else:
        raise ValueError(f"unknown h_basis {h_basis!r}")

    if device is not None:
        from .device_setup import batch_fixed_mul_g1, batch_fixed_mul_g2

        dev = backend.device(str(device))
        n_a, n_ic, n_c = m, len(ic_scalars), len(c_scalars)
        all_g1 = batch_fixed_mul_g1(
            a_t + b_t + ic_scalars + c_scalars + h_scalars + [alpha, beta, delta], dev
        )
        a_query = all_g1[:n_a]
        b1_query = all_g1[n_a : 2 * n_a]
        ic = all_g1[2 * n_a : 2 * n_a + n_ic]
        c_query = all_g1[2 * n_a + n_ic : 2 * n_a + n_ic + n_c]
        h_query = all_g1[2 * n_a + n_ic + n_c : -3]
        alpha1, beta1, delta1 = all_g1[-3:]
        all_g2 = batch_fixed_mul_g2(b_t + [beta, delta, gamma], dev)
        b2_query = all_g2[:-3]
        beta2, delta2, gamma2 = all_g2[-3:]
    else:
        fb1 = FixedBaseG1()
        fb2 = FixedBaseG2()

        def e1(scalar):
            return fb1.mul(scalar) if scalar % FR else None

        def e2(scalar):
            return fb2.mul(scalar) if scalar % FR else None

        a_query = [e1(a_t[i]) for i in range(m)]
        b1_query = [e1(b_t[i]) for i in range(m)]
        b2_query = [e2(b_t[i]) for i in range(m)]
        ic = [e1(s) for s in ic_scalars]
        c_query = [e1(s) for s in c_scalars]
        h_query = [e1(s) for s in h_scalars]

        alpha1, beta1, delta1 = fb1.mul(alpha), fb1.mul(beta), fb1.mul(delta)
        beta2, delta2, gamma2 = fb2.mul(beta), fb2.mul(delta), fb2.mul(gamma)

    pk = ProvingKey(
        n_pub=n_pub,
        domain=domain,
        alpha1=alpha1,
        beta1=beta1,
        delta1=delta1,
        beta2=beta2,
        delta2=delta2,
        a_query=a_query,
        b1_query=b1_query,
        b2_query=b2_query,
        c_query=c_query,
        h_query=h_query,
        h_basis=h_basis,
    )
    vk = VerifyingKey(
        alpha1=pk.alpha1,
        beta2=pk.beta2,
        gamma2=gamma2,
        delta2=pk.delta2,
        ic=ic,
    )
    return pk, vk


# ---------------------------------------------------------------------------
# Disk cache, mirroring the reference's artifact reuse
# (full_system_simulation.mjs:698-739: compile/setup skipped when cached).
# The fingerprint is zkfl_tpu's; the file name has a suffix of its own, so
# a key pickled by the port only ever unpickles into the port's classes.
# The keys do not depend on the device that computed them, so neither does
# the file name.  ``setup_cached_many`` runs several cold ladder setups in
# parallel processes.
# ---------------------------------------------------------------------------


def cache_path(cs, cache_dir: str, seed: str = "zkfl-dev",
               domain: Optional[int] = None) -> Path:
    """The cache file of ``cs`` (a structure-mode ConstraintSystem or a
    CompiledCircuit: both fingerprint alike)."""
    fingerprint = hashlib.sha256(
        f"{cs.name}|{n_constraints(cs)}|{cs.n_wires}|{cs.n_pub}|{seed}"
        f"|{domain or 0}".encode()
    ).hexdigest()[:16]
    return Path(cache_dir) / f"{cs.name}_{fingerprint}.torch.zkey.pkl"


def setup_cached(cs, cache_dir: str, seed: str = "zkfl-dev",
                 domain: Optional[int] = None, device: Device = "cuda"):
    """(pk, vk) for ``cs``: loaded from the cache, else set up on ``device``
    (see groth16_setup) and stored.  A cache miss for a CompiledCircuit
    raises ValueError: the setup needs the structure-mode constraints."""
    path = cache_path(cs, cache_dir, seed, domain)
    if path.exists():
        with open(path, "rb") as f:
            return pickle.load(f)
    if getattr(cs, "is_compiled", False):
        raise ValueError(
            f"zkey cache miss for {cs.name} and only the compiled COO form "
            "is available — rebuild the full structure to run the setup"
        )
    path.parent.mkdir(parents=True, exist_ok=True)
    keys = groth16_setup(cs, seed, domain=domain, device=device)
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        pickle.dump(keys, f)
    tmp.replace(path)
    return keys


def _setup_into_cache(cs, cache_dir, seed, domain) -> None:
    setup_cached(cs, cache_dir, seed, domain, device=None)  # the keys stay in the worker


def setup_cached_many(structures: Sequence[ConstraintSystem], cache_dir: str,
                      seed: str = "zkfl-dev", domain: Optional[int] = None,
                      device: Device = "cuda") -> list:
    """``setup_cached`` for several circuits.  Cold setups on a device run
    here, one after another; cold ladder setups (``device=None``) run in
    parallel spawned processes, one per circuit up to the CPU count (each
    is single-threaded Python)."""
    if device is None:
        cold = [cs for cs in structures if not cache_path(cs, cache_dir, seed, domain).exists()]
        workers = min(len(cold), os.cpu_count() or 1)
        if workers > 1:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
                list(pool.map(_setup_into_cache, cold, [cache_dir] * len(cold),
                              [seed] * len(cold), [domain] * len(cold)))
    return [setup_cached(cs, cache_dir, seed, domain, device) for cs in structures]
