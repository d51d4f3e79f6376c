"""PyTorch/CUDA port of the heterogeneous decentralized diffusion system.

A second package beside the JAX reference ``repro``: the same module and
function names under ``repro_torch/{models,core,kernels,training,launch}``,
with plain PyTorch on tensors for the model code and hand-written CUDA
kernels (``kernels/csrc``) for the two hot-path kernels of the serving
main path (``ragged_gemm`` and ``hetero_fuse_step``).

Entry points run on the GPU unless the caller asks for the CPU with
``device="cpu"``; kernel wrappers take their plain PyTorch version only
for tensors that lie on the CPU.  Importing this package imports neither
``jax`` nor ``repro``.
"""
