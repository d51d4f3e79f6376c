"""Hopper kernels of the port and their plain PyTorch versions.

Layout mirrors ``repro.kernels``: one module per kernel
(``ragged_gemm.py``, ``hetero_fuse.py``, ``adaln_fuse.py``,
``flash_attention.py``, ``ssd_scan.py``) holding the launcher of a
hand-written CUDA kernel (``csrc/*.cu``, built by ``_build.py``),
``ref.py`` with a plain PyTorch version of each kernel under the
reference oracle's name and signature, and ``ops.py`` with the wrappers
the model code calls.  A wrapper takes the plain version only for CPU
tensors; on CUDA tensors it launches the kernel or raises.
"""
