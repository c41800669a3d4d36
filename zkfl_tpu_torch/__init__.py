"""PyTorch + CUDA port of zkfl_tpu's Groth16 device prover for NVIDIA Hopper.

Imports torch and never jax.  The framework-free host code of zkfl_tpu
(fields, curves, circuits, proof assembly, verifier, FL protocol) is shared.
Submodules are imported explicitly; this package imports nothing itself.
"""
