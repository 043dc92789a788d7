"""PyTorch/CUDA port of gddim_tpu for NVIDIA Hopper (H100).

CLD deis sampling of the NCSN++ score network, with the JAX package's five
fused inference kernels (K1-K5) written by hand: K1 in Triton, K2-K5 in CUDA
C++ (``csrc/``), built at first use by ``_build.py``. Imports torch, numpy
and scipy only.
"""
