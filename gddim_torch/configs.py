"""Configs as plain dataclasses.

Holds the fields of the JAX package's configs (``gddim_tpu/configs/``) that
the sampling and training paths read, with the same values, for every
config that builds a network: ``cld/accr_dcifar10`` (the 107.6M-parameter
NCSN++: nf=128, ch_mult (1,2,2,2), 8 BigGAN blocks per level, FIR
resampling, attention at 16x16, progressive_input='residual', dropout 0.1),
``cld/deep_cifar10`` (uncentered data), ``cld/ndeep_cifar10`` (its mixed
score), ``cld/ddpmpp_cifar10`` and ``cld/ddpmpp_celeba`` (4 blocks a level,
positional time embedding, naive resampling, no input pyramid; CelebA at
64x64), ``cld/simple_cifar10`` (nf=32), ``cld/calib_cifar10`` (nf=128, 3
levels), and for blurring diffusion ``blur/ddpm_deep_cifar10`` (the accr
trunk on 3 channels), ``blur/ddpmpp_cifar10``, ``blur/simple_cifar10`` and
``blur/debug_cifar10`` (nf=64, naive resampling), and ``cld/points`` (the
point-set MLP ``ps_fmlp`` on the Olympic rings, in f32; it keeps its file's
sampling, deis order 2 at NFE=20). ``cld/default_cifar10`` and
``blur/default_cifar10`` set no network (no ``model.name`` or ``nf``) and
are not registered.

Every model, data, training and EMA field takes the JAX file's value. The
port's own sampling and execution defaults stand apart
(``EXECUTION_DEFAULTS``): bf16 activations through the whole-block kernels
('fused'), and CLD sampling by deis order 2 at NFE=50, the repo's
benchmark's sampler. ``train_config`` gives a model for training: f32
activations (``default_cifar10.py:95``), as the JAX package trains it.
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
    # the run loop (``run_lib.train``): a step acts when cur % freq < n_jitted_steps
    n_iters: int = 1000001
    log_freq: int = 100
    eval_freq: int = 2000
    snapshot_freq: int = 50000  # numbered snapshots, kept all
    snapshot_freq_for_preemption: int = 50000  # the meta checkpoint, kept 1
    snapshot_sampling: bool = True
    snapshot_sampling_batch: int = 100
    snapshot_freq_for_sampling: int = 10000
    ema_update_freq: int = 10**9  # params <- EMA with a fresh optimizer
    # a torch.profiler trace of profile_steps steps from profile_start (-1: off)
    profile_start: int = -1
    profile_steps: int = 5
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
    data_dir: str = ""  # the local corpus; none (or synthetic): the synthetic corpus
    synthetic: bool = False
    uniform_dequantization: bool = False
    is_partial: bool = False  # train on the first 1/1000 of the corpus
    tfrecords_path: str = ""  # FFHQ / CelebA-HQ: the TFRecord file of the corpus


@dataclasses.dataclass
class EvalConfig:
    """``run_lib.evaluate``, ``sample_data`` and ``check_fid``."""

    begin_ckpt: int = 9
    end_ckpt: int = 26
    batch_size: int = 1024
    enable_loss: bool = True
    enable_sampling: bool = False
    num_samples: int = 50000
    inception_weights: str = ""  # a local .npz of InceptionV3; none: the proxy extractor
    stats_path: str = ""  # the dataset's activation statistics (.npz)
    max_eval_batches: int = 0  # > 0: cut the eval loss's pass over the split


@dataclasses.dataclass
class MeshConfig:
    """The JAX package's sharding axes over a process group's ranks (one
    card a rank): ``fsdp_axis`` ranks shard the state (FSDP2), ``tp_axis``
    ranks the output channels (channel TP), the rest are data parallel
    (``run_lib._place_train_state``)."""

    data_axis: int = -1
    fsdp_axis: int = 1
    tp_axis: int = 1


@dataclasses.dataclass
class ModelConfig:
    """The network and its execution (both families); the SDE's fields are
    the family's subclass's."""

    name: str = "ncsnpp"
    scale_by_sigma: bool = False
    # the SMLD noise levels scale_by_sigma divides by (positional embedding:
    # sigmas[int(label)], ``gddim_tpu/models/unet.py:38-46``)
    sigma_min: float = 0.01
    sigma_max: float = 50.0
    num_scales: int = 1000
    nonlinearity: str = "swish"
    nf: int = 128
    ch_mult: tuple = (1, 2, 2, 2)
    num_res_blocks: int = 8
    attn_resolutions: tuple = (16,)
    conditional: bool = True
    fir: bool = True
    fir_kernel: tuple = (1, 3, 3, 1)
    skip_rescale: bool = True
    resamp_with_conv: bool = True
    resblock_type: str = "biggan"
    progressive: str = "none"
    progressive_input: str = "residual"
    progressive_combine: str = "sum"
    attention_type: str = "ddpm"
    normalization: str = "GroupNorm"  # models/normalization.py:get_normalization
    conv_size: int = 3
    init_scale: float = 0.0
    embedding_type: str = "fourier"
    fourier_scale: float = 16
    dropout: float = 0.1
    ema_rate: float = 0.9999
    # execution
    dtype: str = "bfloat16"  # activations; parameters stay float32
    # 'fused' (the whole-block kernels) | 'fused_int8' (their int8 modes, as
    # bench.py ships the JAX package) | 'pallas' (layer-wise: GroupNorm and
    # 3x3 conv kernels on the activation dtype, bf16 or f32; in training K11
    # with its backward) | 'int8' (layer-wise, int8 convs fed by
    # GroupNorm+SiLU+quantize, out in the activation dtype; trained plain)
    # | 'plain' (torch composition; the JAX 'xla')
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
    # training: recompute the residual blocks' unfused layers in the
    # backward (``gddim_tpu/models/unet.py:160-209``): False | True (the
    # whole block) | 'convs' (keep the 3x3 conv outputs and the post-dropout
    # activation) | 'convs_lean' (keep the conv outputs only)
    remat: bool | str = False
    # the attention core wherever an attention block runs its layers (the
    # plain path, the layer-wise paths, training; never K5 or K10):
    # ATTENTION_IMPLS, the JAX package's values (``unet.py:92``)
    attention_impl: str = "auto"
    # the original DDPM schedule's ends (``compat.get_ddpm_params``;
    # ``gddim_tpu/configs/cld/default_cifar10.py:77-78``)
    beta_min: float = 0.1
    beta_max: float = 20.0


@dataclasses.dataclass
class CLDModelConfig(ModelConfig):
    m_inv: float = 4.0
    beta_0: float = 4.0
    beta_1: float = 0.0
    vv_gamma: float = 0.04
    mixed_score: bool = False


@dataclasses.dataclass
class PointsModelConfig(CLDModelConfig):
    """``cld/points``: the point-set MLP's fields beside the CLD ones."""

    num_layers: int = 4  # ps_fmlp's Dense + swish layers


@dataclasses.dataclass
class PointsDataConfig(DataConfig):
    dim: int = 2  # the points' dimension


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
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    log_wandb: bool = False


def blur_config() -> Config:
    """``blur/ddpm_deep_cifar10``: the accr trunk on 3 channels, blur SDE,
    order-0 sampling at NFE=50."""
    return Config(sde="blur", model=BlurModelConfig(), sampling=BlurSamplingConfig())


def _set(config: Config, **fields) -> Config:
    """Set ``section__field=value`` overrides on config, as the JAX config
    files do; returns config."""
    for key, value in fields.items():
        section, field = key.split("__")
        node = getattr(config, section)
        if not hasattr(node, field):
            raise AttributeError(f"no config field {section}.{field}")
        setattr(node, field, value)
    return config


def _deep() -> Config:  # cld/deep_cifar10.py
    return _set(Config(), data__centered=False)


def _ndeep() -> Config:  # cld/ndeep_cifar10.py
    return _set(_deep(), model__mixed_score=True)


# the DDPM++ variant of the trunk (cld/ddpmpp_cifar10.py, the network fields
# of cld/ddpmpp_celeba.py)
_DDPMPP = dict(model__num_res_blocks=4, model__embedding_type="positional", model__fir=False,
               model__progressive_input="none")


def _ddpmpp_celeba() -> Config:
    """cld/ddpmpp_celeba.py: on cld/default_cifar10, not accr."""
    return _set(Config(), **_DDPMPP, training__n_iters=1300001, training__log_freq=100,
                training__eval_freq=2000, training__snapshot_freq=50000,
                training__snapshot_freq_for_preemption=10000,
                training__snapshot_sampling_batch=100, training__snapshot_freq_for_sampling=5000,
                training__ema_update_freq=5000, data__dataset="CELEBA", data__image_size=64,
                data__centered=True, model__ema_rate=0.999)


# the smoke-test sizes of cld/simple_cifar10.py and blur/simple_cifar10.py
_SIMPLE = dict(model__nf=32, model__num_res_blocks=1, model__ch_mult=(1, 2),
               model__attn_resolutions=(16,), training__batch_size=16,
               training__n_jitted_steps=1, data__synthetic=True)


def _calib() -> Config:  # cld/calib_cifar10.py
    return _set(Config(), model__nf=128, model__num_res_blocks=2, model__ch_mult=(1, 2, 2),
                model__attn_resolutions=(16,), training__batch_size=64,
                training__n_jitted_steps=4, training__n_iters=2001, training__log_freq=100,
                training__eval_freq=1000, training__snapshot_freq=1000,
                training__snapshot_freq_for_preemption=1000,
                training__snapshot_freq_for_sampling=10**9, data__synthetic=True)


def _points() -> Config:
    """cld/points.py: the point-set MLP on the Olympic rings (on
    cld/default_cifar10, whose training and sampling fields this sets where
    they differ from accr's). ps_fmlp computes in f32 whatever model.dtype
    says (the JAX module sets no dtype); its sampling is the file's own,
    deis order 2 at NFE=20."""
    config = Config(data=PointsDataConfig(), model=PointsModelConfig())
    return _set(config, training__batch_size=512, training__n_iters=20001,
                training__n_jitted_steps=10, training__snapshot_freq_for_sampling=5000,
                training__eval_freq=1000, training__log_freq=500, data__dataset="ps_olympic",
                data__dim=2, data__centered=True, model__name="ps_fmlp", model__nf=128,
                model__num_layers=4, model__fourier_scale=16, model__ema_rate=0.999,
                model__nonlinearity="swish", model__scale_by_sigma=False,
                sampling__method="deis", sampling__nfe=20, sampling__deis_order=2)


def _blur_debug() -> Config:  # blur/debug_cifar10.py
    return _set(blur_config(), training__eval_freq=500, training__n_jitted_steps=100,
                training__snapshot_freq_for_sampling=1000, training__batch_size=32,
                training__snapshot_freq=10000, training__snapshot_freq_for_preemption=5000,
                data__is_partial=True, data__random_flip=False, model__ema_rate=0.5,
                model__nf=64, model__num_res_blocks=4, model__fir=False,
                model__progressive_input="none")


_CONFIGS = {
    "cld/accr_dcifar10": Config,
    "cld/deep_cifar10": _deep,
    "cld/ndeep_cifar10": _ndeep,
    "cld/ddpmpp_cifar10": lambda: _set(Config(), **_DDPMPP),
    "cld/ddpmpp_celeba": _ddpmpp_celeba,
    "cld/simple_cifar10": lambda: _set(Config(), **_SIMPLE),
    "cld/calib_cifar10": _calib,
    "cld/points": _points,
    "blur/ddpm_deep_cifar10": blur_config,
    "blur/ddpmpp_cifar10": lambda: _set(blur_config(), model__num_res_blocks=4),
    "blur/simple_cifar10": lambda: _set(blur_config(), **_SIMPLE),
    "blur/debug_cifar10": _blur_debug,
}
# the port's own defaults where they differ from the JAX files': bf16
# activations through the whole-block kernels, and CLD deis order 2 at NFE=50
EXECUTION_DEFAULTS = ("model.dtype", "model.conv_impl", "sampling.nfe", "sampling.deis_order")

CONV_IMPLS = ("fused", "fused_int8", "pallas", "int8", "plain")
REMATS = (False, True, "convs", "convs_lean")
TRANSITION_IMPLS = ("tail", "full")
# model.attention_impl: 'auto' (K8 on the kernel paths, else the plain
# version), 'xla' (the plain version), 'pallas' (K8), 'einsum5d' (the
# reference-shaped attention: the x1 baseline's)
ATTENTION_IMPLS = ("auto", "xla", "pallas", "einsum5d")


def get_config(name: str) -> Config:
    """A fresh config by name ('cld/accr_dcifar10', ...: ``available_configs``)."""
    try:
        return _CONFIGS[name]()
    except KeyError:
        raise ValueError(f"unknown config {name!r}; known: {sorted(_CONFIGS)}") from None


def available_configs() -> tuple:
    return tuple(sorted(_CONFIGS))


def train_config(name: str) -> Config:
    """The named config set up for training: f32 activations."""
    config = get_config(name)
    config.model.dtype = "float32"
    return config
