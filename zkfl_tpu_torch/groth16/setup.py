"""Cached trusted setups for the port (counterpart of
zkfl_tpu/groth16/setup.py setup_cached).

Same fingerprint and pickle format as zkfl_tpu's cache, so either package
reads the other's keys; a cold setup runs the shared pure-Python
``groth16_setup(..., device=False)`` (the JAX fixed-base batches are not
ported yet).  ``setup_cached_many`` runs several cold setups in parallel
processes.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import pickle
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

from zkfl_tpu.groth16.setup import groth16_setup
from zkfl_tpu.r1cs.builder import ConstraintSystem


def cache_path(cs: ConstraintSystem, cache_dir: str, seed: str = "zkfl-dev",
               domain: Optional[int] = None) -> Path:
    fingerprint = hashlib.sha256(
        f"{cs.name}|{len(cs.constraints)}|{cs.n_wires}|{cs.n_pub}|{seed}"
        f"|{domain or 0}".encode()
    ).hexdigest()[:16]
    return Path(cache_dir) / f"{cs.name}_{fingerprint}.zkey.pkl"


def setup_cached(cs: ConstraintSystem, cache_dir: str, seed: str = "zkfl-dev",
                 domain: Optional[int] = None):
    """(pk, vk) for ``cs``: loaded from the cache, else set up and stored."""
    path = cache_path(cs, cache_dir, seed, domain)
    if path.exists():
        with open(path, "rb") as f:
            return pickle.load(f)
    path.parent.mkdir(parents=True, exist_ok=True)
    keys = groth16_setup(cs, seed, device=False, domain=domain)
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        pickle.dump(keys, f)
    tmp.replace(path)
    return keys


def _setup_into_cache(cs, cache_dir, seed, domain) -> None:
    setup_cached(cs, cache_dir, seed, domain)  # the keys stay in the worker


def setup_cached_many(structures: Sequence[ConstraintSystem], cache_dir: str,
                      seed: str = "zkfl-dev", domain: Optional[int] = None) -> list:
    """``setup_cached`` for several circuits; cold ones run in parallel
    spawned processes, one per circuit up to the CPU count (each setup is
    single-threaded Python)."""
    cold = [cs for cs in structures if not cache_path(cs, cache_dir, seed, domain).exists()]
    workers = min(len(cold), os.cpu_count() or 1)
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            list(pool.map(_setup_into_cache, cold, [cache_dir] * len(cold),
                          [seed] * len(cold), [domain] * len(cold)))
    return [setup_cached(cs, cache_dir, seed, domain) for cs in structures]
