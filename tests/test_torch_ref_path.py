"""The reference-style plain path (``bench.py``'s ``ref`` mode: f32,
``model.attention_impl='einsum5d'``, ``resample.FIR_IMPL='channel_batch'``,
``dct.DCT_IMPL='fft'``) against the JAX package on the CPU: the FFT DCT and
its inverse, the 5-D einsum attention, the four FIR resample functions
under 'channel_batch' and unfused, the attention block under every
attention_impl, and the small network's eps (CLD) and DCT-space eps (blur)
with every switch at its reference value, on the same numpy inputs and
converted weights.

The JAX package's module switches are set by a fixture and restored after
each test: state, not an edit to the package."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft
import torch

from gddim_torch import convert
from gddim_torch.configs import get_config
from gddim_torch.math import blur as t_blur
from gddim_torch.math import dct as t_dct
from gddim_torch.math.cld import CLD
from gddim_torch.models import blocks as t_blocks
from gddim_torch.models import resample as t_res
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.models.wrappers import make_blur_yeps_fn, make_cld_eps_fn
from gddim_torch.ops import attention as t_att
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.math import blur as j_blur
from gddim_tpu.math import dct as j_dct
from gddim_tpu.math.cld import CLD as JaxCLD
from gddim_tpu.models import blocks as j_blocks
from gddim_tpu.models import get_model
from gddim_tpu.models import resample as j_res
from gddim_tpu.models.wrappers import make_blur_yeps_fn as jax_make_blur_yeps_fn
from gddim_tpu.models.wrappers import make_cld_eps_fn as jax_make_cld_eps_fn
from gddim_tpu.ops import attention as j_att

F32_REL = 1e-5  # the DCT, attention and FIR ops in f32
F64_REL = 1e-12  # the DCT in f64
MODEL_REL = 1e-4  # the network, as tests/test_torch_model.py holds the f32 plain path
FIR = (1, 3, 3, 1)
DCT_SIZES = (8, 16, 32, 7)


def rel_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture
def switches():
    """set(fir=, fuse=, dct=) sets both packages' module switches alike;
    every switch is restored after the test."""
    saved = [(m, name, getattr(m, name)) for m, name in (
        (t_res, "FIR_IMPL"), (t_res, "FUSE_FIR_CONV"), (t_dct, "DCT_IMPL"),
        (j_res, "FIR_IMPL"), (j_res, "FUSE_FIR_CONV"), (j_dct, "DCT_IMPL"))]

    def set_(fir=None, fuse=None, dct=None):
        for name, value in (("FIR_IMPL", fir), ("FUSE_FIR_CONV", fuse), ("DCT_IMPL", dct)):
            if value is not None:
                for m in ((t_res, j_res) if name != "DCT_IMPL" else (t_dct, j_dct)):
                    setattr(m, name, value)

    yield set_
    for m, name, value in saved:
        setattr(m, name, value)


# --- the FFT DCT ------------------------------------------------------------


@pytest.mark.parametrize("n", DCT_SIZES)
def test_fft_dct_f32_matches_jax(switches, n):
    """DCT_IMPL='fft' forward and inverse against JAX's fft form and against
    the port's matrix form, f32, on (B, n, n + 1, C) (both axes' sizes)."""
    x = np.random.default_rng(n).standard_normal((2, n, n + 1, 3)).astype(np.float32)
    matmul = (t_dct.batch_img_dct(torch.from_numpy(x)), t_dct.batch_img_idct(torch.from_numpy(x)))
    switches(dct="fft")
    fwd, inv = t_dct.batch_img_dct(torch.from_numpy(x)), t_dct.batch_img_idct(torch.from_numpy(x))
    assert fwd.dtype == inv.dtype == torch.float32 and fwd.shape == x.shape
    assert rel_err(fwd, j_dct.batch_img_dct(jnp.asarray(x))) <= F32_REL
    assert rel_err(inv, j_dct.batch_img_idct(jnp.asarray(x))) <= F32_REL
    assert rel_err(fwd, matmul[0]) <= F32_REL and rel_err(inv, matmul[1]) <= F32_REL
    assert rel_err(t_dct.batch_img_idct(fwd), x) <= F32_REL


@pytest.mark.parametrize("n", DCT_SIZES)
def test_fft_dct_f64_stays_f64(switches, n):
    """In f64 the FFT form runs in complex128: within 1e-12 of scipy's
    orthonormal DCT-II / DCT-III, of the port's matrix form and of JAX's
    fft form under x64."""
    x = np.random.default_rng(n + 1).standard_normal((2, n, n, 2))
    want_fwd = scipy.fft.dctn(x, axes=(1, 2), norm="ortho")
    want_inv = scipy.fft.idctn(x, axes=(1, 2), norm="ortho")
    matmul = t_dct.batch_img_dct(torch.from_numpy(x))
    switches(dct="fft")
    fwd, inv = t_dct.batch_img_dct(torch.from_numpy(x)), t_dct.batch_img_idct(torch.from_numpy(x))
    assert fwd.dtype == inv.dtype == torch.float64
    assert rel_err(fwd, want_fwd) <= F64_REL and rel_err(inv, want_inv) <= F64_REL
    assert rel_err(fwd, matmul) <= F64_REL
    with jax.enable_x64(True):
        j_fwd = np.asarray(j_dct.batch_img_dct(jnp.asarray(x)))
        j_inv = np.asarray(j_dct.batch_img_idct(jnp.asarray(x)))
    assert j_fwd.dtype == np.float64
    assert rel_err(fwd, j_fwd) <= F64_REL and rel_err(inv, j_inv) <= F64_REL


def test_dct_switch_is_read_at_call_time(switches):
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 8, 8, 1)))
    y = t_dct.dct2(x)
    switches(dct="fft")
    assert not torch.equal(t_dct.dct2(x), y)  # another computation, the same transform
    assert rel_err(t_dct.dct2(x), y) <= F64_REL
    switches(dct="fftw")
    with pytest.raises(ValueError):
        t_dct.dct2(x)


# --- the 5-D einsum attention -------------------------------------------------


def test_attention_einsum5d_matches_jax():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 4, 8, 16)).astype(np.float32) for _ in range(3))
    got = t_att.attention_einsum5d(*map(torch.from_numpy, (q, k, v)))
    want = j_att.attention_einsum5d(*map(jnp.asarray, (q, k, v)))
    assert got.shape == q.shape and got.dtype == torch.float32
    assert rel_err(got, want) <= F32_REL


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas", "einsum5d"])
def test_self_attention_2d_impls(impl):
    """Every impl on CPU tensors against JAX's 'xla' (the 'pallas' and
    'auto' ones are K8's plain version here); an unknown impl raises."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 4, 4, 16)).astype(np.float32) for _ in range(3))
    want = j_att.self_attention_2d(*map(jnp.asarray, (q, k, v)), impl="xla")
    got = t_att.self_attention_2d(*map(torch.from_numpy, (q, k, v)), impl=impl)
    assert rel_err(got, want) <= F32_REL
    with pytest.raises(ValueError):
        t_att.self_attention_2d(*map(torch.from_numpy, (q, k, v)), impl="flash")


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(max(np.prod(a.shape[:-1]), 1))
                   ).astype(np.float32), tree)


@pytest.mark.parametrize("impl", ["einsum5d", "xla"])
@pytest.mark.parametrize("train", [False, True])
def test_attn_block_attention_impl_matches_jax(impl, train):
    """The attention block's plain path (and its training path) with
    attention_impl against the flax block with the same impl."""
    x = np.random.default_rng(6).standard_normal((2, 8, 8, 32)).astype(np.float32)
    jblk = j_blocks.AttnBlockpp(skip_rescale=True, init_scale=0.0, attention_impl=impl)
    params = _random_like(flax.core.unfreeze(
        jblk.init(jax.random.PRNGKey(0), jnp.asarray(x), False)["params"]), 7)
    want = jblk.apply({"params": params}, jnp.asarray(x), False)
    tblk = t_blocks.AttnBlockpp(32, skip_rescale=True)
    tblk.load_state_dict(convert.flax_to_state_dict(tblk, params))
    got = tblk(torch.from_numpy(x), fused=False, train=train, attention_impl=impl)
    assert rel_err(got, want) <= F32_REL


# --- the FIR resample functions --------------------------------------------------


def _resample_case(kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 6, 10)) / 7).astype(np.float32)
    fns = {"up": ("upsample_2d", ()), "down": ("downsample_2d", ()),
           "upconv": ("upsample_conv_2d", (w,)), "convdown": ("conv_downsample_2d", (w,))}
    name, extra = fns[kind]
    return x, extra, getattr(t_res, name), getattr(j_res, name)


@pytest.mark.parametrize("kind", ["up", "down", "upconv", "convdown"])
@pytest.mark.parametrize("mode", ["channel_batch", "unfused"])
def test_fir_resample_switches_match_jax(switches, kind, mode):
    """Each resample function under FIR_IMPL='channel_batch' (which also
    unfuses the resample convs) and under FUSE_FIR_CONV=False with the
    separable FIR, against JAX's under the same switches, and against the
    port's default path on the same inputs."""
    x, extra, fn_t, fn_j = _resample_case(kind, 8)
    default = fn_t(torch.from_numpy(x), *map(torch.from_numpy, extra), FIR)
    switches(fir="channel_batch") if mode == "channel_batch" else switches(fuse=False)
    got = fn_t(torch.from_numpy(x), *map(torch.from_numpy, extra), FIR)
    want = fn_j(jnp.asarray(x), *map(jnp.asarray, extra), FIR)
    assert got.shape == want.shape == default.shape
    assert rel_err(got, want) <= F32_REL
    assert rel_err(got, default) <= F32_REL


def test_fir_switch_rejects_unknown_values(switches):
    switches(fir="polyphase")
    with pytest.raises(ValueError):
        t_res.upsample_2d(torch.zeros((1, 4, 4, 2)), FIR)


# --- the reference-style network ---------------------------------------------


def _small(cfg, jax_side: bool):
    cfg.model.nf = 32
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (8,)
    cfg.data.image_size = 16
    cfg.model.dtype = "float32"
    cfg.model.attention_impl = "einsum5d"
    # off the TPU the JAX 'fused' is its unfused composition; the port's is 'plain'
    cfg.model.conv_impl = "fused" if jax_side else "plain"
    return cfg


def _jax_model(cfg):
    return get_model(cfg.model.name)(config=cfg)


@pytest.mark.parametrize("family", ["cld", "blur"])
def test_reference_style_network_matches_jax(switches, family):
    """The small accr-shaped network (nf=32, one block a level, FIR,
    attention at 8x8) with every switch at its reference value: CLD's eps,
    and blur's DCT-space eps (iDCT, the network, DCT: the FFT DCT), against
    the JAX network run the same way on the converted weights."""
    switches(fir="channel_batch", dct="fft")
    name = "cld/accr_dcifar10" if family == "cld" else "blur/ddpm_deep_cifar10"
    cfg, jcfg = _small(get_config(name), False), _small(jax_get_config(name), True)
    tree = seeded_params(cfg, 0)
    model = seeded_model(cfg, 0)
    assert model.attention_impl == "einsum5d" and not model.fused
    variables = {"params": jax.tree.map(jnp.asarray, tree)}
    rng = np.random.default_rng(9)
    t = np.array([0.5, 0.02], np.float32)
    if family == "cld":
        u = rng.standard_normal((2, 16, 16, 3, 2)).astype(np.float32)
        want = jax_make_cld_eps_fn(JaxCLD.from_config(jcfg), _jax_model(jcfg))(
            variables, jnp.asarray(u), jnp.asarray(t))
        got = make_cld_eps_fn(CLD.from_config(cfg))(model, torch.from_numpy(u),
                                                    torch.from_numpy(t))
    else:
        y = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
        want = jax_make_blur_yeps_fn(j_blur.from_config(jcfg), _jax_model(jcfg))(
            variables, jnp.asarray(y), jnp.asarray(t))
        got = make_blur_yeps_fn(t_blur.BlurSDE.from_config(cfg))(model, torch.from_numpy(y),
                                                                 torch.from_numpy(t))
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    assert rel_err(got, want) <= MODEL_REL


def test_attention_impl_is_checked():
    cfg = _small(get_config("cld/accr_dcifar10"), False)
    cfg.model.attention_impl = "flash"
    with pytest.raises(ValueError):
        seeded_model(cfg, 0)
