"""PyTorch/CUDA port of gddim_tpu for NVIDIA Hopper (H100).

CLD deis sampling and CLD training of the NCSN++ score network, with the
JAX package's fused kernels written by hand: the inference kernels K1-K5 and
the training kernels K6 (block forward), K7 (block backward) and K8
(attention), all in CUDA C++ (``csrc/``), built at first use by
``_build.py``. Imports torch, numpy and scipy only.
"""
