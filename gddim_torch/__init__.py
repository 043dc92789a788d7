"""PyTorch/CUDA port of gddim_tpu for NVIDIA Hopper (H100).

Everything the JAX package does on one card: CLD and blurring diffusion,
the gDDIM/DEIS sampler family, training and sampling of the NCSN++ / DDPM++
networks of every JAX config (the point-set MLP and the noise-conditional
WideResNet classifier too), checkpoints (the published flax format both
ways), the input pipelines (local CIFAR-10 and ``.npz`` corpora with the
reference's crops and resizes, FFHQ / CelebA-HQ TFRecords), FID / IS / KID,
the reference-API shims (``compat.py``) and the NCSNv1/v2 layer zoo
(``models/legacy_blocks.py``, ``models/normalization.py``). Every Pallas
kernel of the JAX package is a hand-written CUDA C++ kernel for sm_90a
(``csrc/``), built by nvcc at first use (``_build.py``); each has a plain
PyTorch version, which CPU tensors take. ``run_lib.py`` and ``cli.py`` are
the run harness; ``parallel/`` runs it over several processes (data
parallel, FSDP2, channel TP, round-sharded sampling over
``torch.distributed``); ``scripts/`` holds the NFE x order sweep and the
int8 fidelity check. The reference-style plain path (f32,
``model.attention_impl='einsum5d'``, ``models.resample.FIR_IMPL=
'channel_batch'``, ``math.dct.DCT_IMPL='fft'``) is there to measure
against. Imports torch, numpy and scipy only; ``import gddim_torch`` is
light: the names below load on first use.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """The lazy top-level API (``gddim_tpu/__init__.py:13-31``)."""
    if name in ("CLD", "CLDParams", "HostCLD"):
        from gddim_torch.math import cld, cld_host

        return {"CLD": cld.CLD, "CLDParams": cld_host.CLDParams,
                "HostCLD": cld_host.HostCLD}[name]
    if name == "BlurSDE":
        from gddim_torch.math.blur import BlurSDE

        return BlurSDE
    if name in ("run_lib", "parallel"):
        import importlib

        return importlib.import_module(f"gddim_torch.{name}")
    if name == "get_config":
        from gddim_torch.configs import get_config

        return get_config
    raise AttributeError(name)
