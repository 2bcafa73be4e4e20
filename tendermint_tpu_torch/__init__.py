"""tendermint_tpu_torch: the PyTorch and CUDA port of tendermint_tpu.

The second package of the repository. It computes what the JAX package
computes, on an NVIDIA H100: commit verification (types/validation.py)
through the ed25519 and sr25519 batch verifiers (crypto/ed25519.py,
crypto/sr25519.py), and batch verification sharded over a mesh of devices
(parallel/), to hand-written Hopper kernels (csrc/, built with nvcc at
first use and bound with ctypes by ops/_build.py), each beside a plain
PyTorch version (ops/verify.py, ops/verify_sr.py, ops/msm.py,
parallel/sharded_verify.py). Above that seam: the light client's stateless
header verification (light/), the block and validator-set hashes it checks
(types/, crypto/merkle.py on the native SHA-256 / merkle plane of
native/prep.c) and the host-only secp256k1 key type (crypto/secp256k1.py).

The package imports torch, never jax, and nothing of tendermint_tpu. Its
entry points run on the card unless the caller passes device="cpu", which
runs the plain PyTorch versions on the host.
"""
