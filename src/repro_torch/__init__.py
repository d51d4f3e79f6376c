"""PyTorch/CUDA port of the heterogeneous decentralized diffusion system.

A second package beside the JAX reference ``repro``: the same module and
function names under
``repro_torch/{models,core,kernels,training,launch,configs}``, with plain
PyTorch on tensors for the model code and a hand-written CUDA kernel
(``kernels/csrc``) for each of the reference's Pallas kernels.  It serves
the heterogeneous DiT ensemble (``launch/serve.py``) and the Mamba2
LM-expert ensemble (``core/lm_ensemble.py``).

Entry points run on the GPU unless the caller asks for the CPU with
``device="cpu"``; kernel wrappers take their plain PyTorch version only
for tensors that lie on the CPU.  Importing this package imports neither
``jax`` nor ``repro``.
"""
