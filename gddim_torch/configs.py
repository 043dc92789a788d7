"""Configs as plain dataclasses.

Holds the fields of ``gddim_tpu/configs/cld/default_cifar10.py``,
``cld/accr_dcifar10.py``, ``blur/default_cifar10.py`` and
``blur/ddpm_deep_cifar10.py`` that the sampling and training paths read, with
the same values. ``cld/accr_dcifar10`` is the 107.6M-parameter NCSN++ (nf=128,
ch_mult (1,2,2,2), 8 BigGAN blocks per level, FIR resampling, attention at
16x16, progressive_input='residual', dropout 0.1), set up for bf16 sampling
through the fused kernels with the deis order-2, NFE=50 sampler of the repo's
benchmark. ``blur/ddpm_deep_cifar10`` is the same network on 3 channels for
blurring diffusion, set up the same way with the order-0 NFE=50 sampler in
DCT space. ``train_config`` gives a model for training: f32 activations
(``default_cifar10.py:95``), as the JAX package trains it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SamplingConfig:
    """The fields both families read (``samplers/factory.py``,
    ``samplers/blur.py``)."""

    method: str = "deis"
    nfe: int = 50
    deis_order: int = 2
    ts_order: float = 2
    noise_removal: bool = True
    # reproduce the reference's numerics bit for bit: CLD's non-monotone
    # hybdeis grid and untransposed sdeis Lyapunov equation, blur's G-based
    # eps integrand (``default_cifar10.py:46-48`` of both families)
    reference_exact: bool = False


@dataclasses.dataclass
class CLDSamplingConfig(SamplingConfig):
    """The CLD samplers' fields (``gddim_tpu/configs/cld/default_cifar10.py:
    30-49``): method is one of ``samplers/factory.py:CLD_SAMPLERS``."""

    is_em: bool = False  # order0: the Euler-discretized coefficients
    noise_nfe_ratio: float = 0.3  # hybdeis: the share of steps in the noise region
    img_t_ratio: float = 0.3  # hybdeis: where the image region starts, a share of T
    atol: float = 1e-5  # ode: solve_ivp's tolerances and method
    rtol: float = 1e-5
    ode_method: str = "RK45"
    lambda_coef: float = 1.0  # sdeis and em: the noise scale lambda
    sdeis_use_order0: bool = True  # sdeis at deis_order 0: the exact order-0 update


@dataclasses.dataclass
class BlurSamplingConfig(SamplingConfig):
    method: str = "order0"  # or 'deis': frequency-space DEIS of deis_order
    noise_removal: bool = False  # no final denoising step
    t0: float = 1e-5  # the last time of the reverse grid (BlurSDE.sampling_eps)


@dataclasses.dataclass
class TrainingConfig:
    batch_size: int = 128
    n_jitted_steps: int = 5  # steps per train_step call (its batches' leading axis)
    reduce_mean: bool = True
    # the attention blocks of a training step through K10 (K5's forward on
    # the f32 activations, the plain composition's VJP; the JAX package's
    # GDDIM_FUSED_ATTN_TRAIN=1) instead of K1, the NIN projections and K8
    fused_attn: bool = False


@dataclasses.dataclass
class OptimConfig:
    optimizer: str = "Adam"
    lr: float = 2e-4
    beta1: float = 0.9
    eps: float = 1e-8
    warmup: int = 5000
    grad_clip: float = 1.0
    weight_decay: float = 0.0


@dataclasses.dataclass
class DataConfig:
    dataset: str = "CIFAR10"
    image_size: int = 32
    centered: bool = True
    num_channels: int = 3
    random_flip: bool = True


@dataclasses.dataclass
class ModelConfig:
    """The network and its execution (both families); the SDE's fields are
    the family's subclass's."""

    name: str = "ncsnpp"
    scale_by_sigma: bool = False
    nonlinearity: str = "swish"
    nf: int = 128
    ch_mult: tuple = (1, 2, 2, 2)
    num_res_blocks: int = 8
    attn_resolutions: tuple = (16,)
    conditional: bool = True
    fir: bool = True
    fir_kernel: tuple = (1, 3, 3, 1)
    skip_rescale: bool = True
    resblock_type: str = "biggan"
    progressive: str = "none"
    progressive_input: str = "residual"
    init_scale: float = 0.0
    embedding_type: str = "fourier"
    fourier_scale: float = 16
    dropout: float = 0.1
    ema_rate: float = 0.9999
    # execution
    dtype: str = "bfloat16"  # activations; parameters stay float32
    # 'fused' (the whole-block kernels) | 'fused_int8' (their int8 modes, as
    # bench.py ships the JAX package) | 'pallas' (layer-wise: GroupNorm and
    # 3x3 conv kernels, bf16) | 'int8' (layer-wise, int8 convs fed by
    # GroupNorm+SiLU+quantize) | 'plain' (torch composition; the JAX 'xla')
    conv_impl: str = "fused"
    # the up/down transition blocks under 'fused' and 'fused_int8': 'full'
    # (the whole block in one C call, K9; the JAX package's
    # GDDIM_TRANSITION_IMPL=full, off there) or 'tail' (K1, the FIR resample
    # of h and of x in PyTorch, then K4). 'full' by the H100 A/B of
    # chip_smoke.py --phases ab: faster at B=16 and 64, bf16 and int8 (PERF.md)
    transition_impl: str = "full"
    # training: the stride-1 residual blocks through K6/K7 where
    # ``train_supported`` takes them (False: their plain composition), the
    # JAX package's switch of the same name; the family's value
    fused_train: bool = True


@dataclasses.dataclass
class CLDModelConfig(ModelConfig):
    m_inv: float = 4.0
    beta_0: float = 4.0
    beta_1: float = 0.0
    vv_gamma: float = 0.04
    mixed_score: bool = False


@dataclasses.dataclass
class BlurModelConfig(ModelConfig):
    sigma_blur_max: float = 10.0
    min_scale: float = 0.001
    fused_train: bool = False  # ``gddim_tpu/configs/blur/default_cifar10.py:76``


@dataclasses.dataclass
class Config:
    sde: str = "cld"
    seed: int = 42
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=CLDModelConfig)
    sampling: SamplingConfig = dataclasses.field(default_factory=CLDSamplingConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)


def blur_config() -> Config:
    """``blur/ddpm_deep_cifar10``: the accr trunk on 3 channels, blur SDE,
    order-0 sampling at NFE=50."""
    return Config(sde="blur", model=BlurModelConfig(), sampling=BlurSamplingConfig())


_CONFIGS = {"cld/accr_dcifar10": Config, "blur/ddpm_deep_cifar10": blur_config}

CONV_IMPLS = ("fused", "fused_int8", "pallas", "int8", "plain")
TRANSITION_IMPLS = ("tail", "full")


def get_config(name: str) -> Config:
    """A fresh config by name ('cld/accr_dcifar10', 'blur/ddpm_deep_cifar10')."""
    try:
        return _CONFIGS[name]()
    except KeyError:
        raise ValueError(f"unknown config {name!r}; known: {sorted(_CONFIGS)}") from None


def train_config(name: str) -> Config:
    """The named config set up for training: f32 activations."""
    config = get_config(name)
    config.model.dtype = "float32"
    return config
