"""The program's proofs and verifying keys as plain ints, the form that
the judge (``zkbench/plain``) reads."""

from __future__ import annotations


def g1(p):
    return None if p is None else (int(p[0]), int(p[1]))


def fq2(x):
    c = x.coeffs if hasattr(x, "coeffs") else x
    return (int(c[0]), int(c[1]))


def g2(p):
    return None if p is None else (fq2(p[0]), fq2(p[1]))


def proof(p) -> dict:
    return {"a": g1(p.pi_a), "b": g2(p.pi_b), "c": g1(p.pi_c),
            "publics": [int(s) for s in p.public_signals]}


def vk(v) -> dict:
    return {"alpha1": g1(v.alpha1), "beta2": g2(v.beta2), "gamma2": g2(v.gamma2),
            "delta2": g2(v.delta2), "ic": [g1(p) for p in v.ic]}
