"""PyTorch + CUDA port of zkfl_tpu for NVIDIA Hopper: the Groth16 device
prover, the FL round on top of it, and batched Poseidon commitments.

Imports torch and never jax, and nothing of zkfl_tpu: the framework-free host
code it needs (fields, curves, Poseidon, commitments, circuits, setup, proof
assembly, verifier, FL protocol, the native C++) is its own copy.
Submodules are imported explicitly; this package imports nothing itself.
"""
