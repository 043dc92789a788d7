"""NCSN++ score U-Net (counterpart of ``gddim_tpu/models/unet.py``).

Covers the JAX package's option space (reference ncsnpp.py): Fourier or
positional time embedding (``scale_by_sigma`` dividing by the label or by
sigmas[int(label)]), conditional or not, BigGAN or DDPM blocks (the latter
with Up/Down modules), FIR or naive resampling (``fir``),
progressive_input 'none' / 'input_skip' (Combine) / 'residual',
progressive 'none' / 'output_skip' / 'residual', skip rescaling on or off,
and any of the JAX package's activations; the input and output have
``data.num_channels`` channels, doubled for CLD's (x, v)
(``gddim_tpu/models/wrappers.py:33``). NHWC throughout; parameters float32,
activations in ``config.model.dtype``; ``config.model.conv_impl`` picks, for
every block, the whole-block kernels ('fused'), their int8 modes
('fused_int8'), the layer-wise kernels ('pallas': GroupNorm and 3x3 conv
kernels in bf16; 'int8': int8 3x3 convs fed by GroupNorm+SiLU+quantize) or
the plain torch composition ('plain'); ``config.model.transition_impl='full'``
runs the whole-block paths' up/down blocks through K9 (FIR or naive
coefficients), ``config.training.fused_attn`` the training path's attention
through K10, and ``config.model.fused_train`` its stride-1 BigGAN blocks
through K6/K7 (off: their unfused layers, K1 for the GroupNorms).
``config.model.attention_impl`` ('auto', 'xla', 'pallas', 'einsum5d'; the
JAX package's ``unet.py:92,127``) picks the attention core wherever an
attention block runs its layers (never K5 or K10). A block
takes a kernel only with the swish activation and a temb, as the JAX
package gates them. The stem, head, pyramid and Up/Down convs stay plain in
every mode, apart from what the JAX package sends through its 3x3 conv
kernel there (the DDPM Upsample's conv and the residual output pyramid's
conv, layer-wise). With ``train=True`` the blocks take their
training paths (dropout, K1/K6/K7/K8, and K11's autograd.Function under
'pallas' for every 3x3 conv its gate takes outside K6/K7: the blocks' convs,
a DDPM block's conv shortcut, the DDPM Upsample's conv and the residual
output pyramid's conv; 'int8' trains its convs plain, as the JAX package
does), and the dropout masks are drawn in the order the blocks run from the
caller's generator. ``config.model.remat`` (False, True, 'convs',
'convs_lean'; ``gddim_tpu/models/unet.py:160-209``) recomputes the residual
blocks' unfused layers in the backward (``models/blocks.py``); the
parameters, and so the ``state_dict`` keys, are the same in every mode.

On the whole-block paths ('fused', 'fused_int8') every residual block's temb
row, silu(temb) @ W_dense + b_dense, comes from one f32 product an eval
(``temb_rows``: the blocks' Dense weights concatenated in module order), as
the JAX package computes each row outside its Pallas kernels
(``gddim_tpu/models/blocks.py:252-255``); each block gets its column slice.
The layer-wise paths, calibration and training keep each block's Dense.

``qscales`` holds the int8 calibration, in the layout of the JAX package's
'qscales' collection: {scope name: {site: amax}} (``models/calibrate.py``,
``convert.qscales_from_flax``). It is a plain attribute, outside
``state_dict``, so weight files load as they are.

Modules are created in the order ``gddim_tpu`` creates its flax scopes
(``unet.py:106-312``), and ``scopes`` records each one's flax scope name, so
converted weights map one to one (``gddim_torch/convert.py``); a scope with
no parameters (an Upsample or Downsample without a conv) still takes its
number.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gddim_torch.configs import ATTENTION_IMPLS, CONV_IMPLS, REMATS, TRANSITION_IMPLS
from gddim_torch.models.blocks import (
    AttnBlockpp,
    Downsample,
    ResnetBlockBigGANpp,
    ResnetBlockDDPMpp,
    Upsample,
)
from gddim_torch.models.layers import (
    Combine,
    Conv,
    Dense,
    GaussianFourierProjection,
    GroupNorm,
    _KernelWeights,
    get_act,
    get_timestep_embedding,
    norm_act,
)
from gddim_torch.models.registry import register_model

_INV_SQRT2 = 0.7071067811865476
_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16, "float32": torch.float32}


def get_sigmas(config) -> np.ndarray:
    """The SMLD noise levels, f32 (reference models/utils.py:69-81)."""
    m = config.model
    return np.exp(np.linspace(np.log(m.sigma_max), np.log(m.sigma_min),
                              int(m.num_scales))).astype(np.float32)


def _amax_sow(sites: dict):
    """sow(site, tensor) folding max|tensor| (f32, on its device) into sites."""

    def sow(name, t):
        a = t.detach().float().abs().amax()
        sites[name] = torch.maximum(sites[name], a) if name in sites else a

    return sow


@register_model(name="ncsnpp")
class NCSNpp(nn.Module):
    def __init__(self, config, generator: torch.Generator | None = None):
        super().__init__()
        m = config.model
        resblock_type = m.resblock_type.lower()
        progressive, progressive_input = m.progressive.lower(), m.progressive_input.lower()
        embedding = m.embedding_type.lower()
        assert progressive in ("none", "output_skip", "residual")
        assert progressive_input in ("none", "input_skip", "residual")
        assert embedding in ("fourier", "positional")
        if resblock_type not in ("ddpm", "biggan"):
            raise ValueError(f"resblock type {resblock_type} unrecognized")
        if m.conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {m.conv_impl!r}")
        if m.transition_impl not in TRANSITION_IMPLS:
            raise ValueError(f"transition_impl must be one of {TRANSITION_IMPLS}, "
                             f"got {m.transition_impl!r}")
        if not isinstance(m.remat, (bool, str)) or m.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {m.remat!r}")
        self.fused = m.conv_impl != "plain"  # kernels (False: the plain composition)
        self.int8 = m.conv_impl == "fused_int8"  # the whole-block kernels' int8 modes
        self.layer = m.conv_impl if m.conv_impl in ("pallas", "int8") else None  # layer-wise
        self.transition = m.transition_impl  # 'full': K9 for the whole-block paths' transitions
        self.fused_attn = bool(config.training.fused_attn)  # training attention through K10
        if m.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, "
                             f"got {m.attention_impl!r}")
        self.attention_impl = m.attention_impl  # the attention core where a block runs its layers
        self.fused_train = bool(m.fused_train)  # training stride-1 blocks through K6/K7
        self.remat = m.remat  # the residual blocks' recompute in training
        self.qscales: dict = {}
        self.dtype = _DTYPES[str(m.dtype).lower()]
        self.centered = bool(config.data.centered)
        self.num_res_blocks = m.num_res_blocks
        self.num_resolutions = len(m.ch_mult)
        self.attn_resolutions = tuple(m.attn_resolutions)
        self.act = get_act(m.nonlinearity)
        self.nf, self.embedding = m.nf, embedding
        self.conditional = bool(m.conditional)
        self.skip_rescale = bool(m.skip_rescale)
        self.ddpm = resblock_type == "ddpm"
        self.progressive, self.progressive_input = progressive, progressive_input
        self.sigmas = get_sigmas(config) if m.scale_by_sigma else None
        self._sigmas_dev = None  # self.sigmas on the last device it was read on
        nf, g, act = m.nf, generator, self.act
        fir, fir_kernel = bool(m.fir), tuple(m.fir_kernel)
        temb_dim = 4 * nf if self.conditional else None
        channels = config.data.num_channels * (2 if config.sde == "cld" else 1)  # CLD: (x, v)
        # (flax scope name, module) in the JAX package's creation order
        self.scopes: list[tuple[str, nn.Module]] = []
        counts = collections.Counter()

        def add(cls_name, module):
            module.scope = f"{cls_name}_{counts[cls_name]}"
            self.scopes.append((module.scope, module))
            counts[cls_name] += 1
            return module

        def resblock(cin, out=None, **kw):
            common = dict(skip_rescale=m.skip_rescale, init_scale=m.init_scale,
                          dropout=m.dropout, generator=g, act=act)
            if self.ddpm:
                return add("ResnetBlockDDPMpp", ResnetBlockDDPMpp(cin, out, temb_dim, **common))
            return add("ResnetBlockBigGANpp", ResnetBlockBigGANpp(
                cin, out, temb_dim, fir=fir, fir_kernel=fir_kernel, **common, **kw))

        def attn(c):
            return add("AttnBlockpp", AttnBlockpp(c, skip_rescale=m.skip_rescale,
                                                  init_scale=m.init_scale, generator=g))

        def head(cin, cout, init_scale=1.0):  # norm_act, then a 3x3 conv
            return [add("GroupNorm", GroupNorm(cin)),
                    add("Conv", Conv(cin, cout, 3, init_scale=init_scale, generator=g))]

        if embedding == "fourier":
            self.fourier = add("GaussianFourierProjection",
                               GaussianFourierProjection(nf, m.fourier_scale, generator=g))
        if self.conditional:
            self.temb0 = add("Dense", Dense(2 * nf if embedding == "fourier" else nf, 4 * nf,
                                            generator=g))
            self.temb1 = add("Dense", Dense(4 * nf, 4 * nf, generator=g))
        self.conv_in = add("Conv", Conv(channels, nf, 3, generator=g))
        # down_blocks / up_blocks: the residual blocks and, with DDPM blocks,
        # the Downsample / Upsample modules, in the order they run; pyramid:
        # the input pyramid's Downsample (and Combine) modules; pyramid_up:
        # the output pyramid's modules
        self.down_blocks, self.down_attn = nn.ModuleList(), nn.ModuleList()
        self.pyramid, self.pyramid_up = nn.ModuleList(), nn.ModuleList()
        res, c, pyr_c = config.data.image_size, nf, channels
        hs_c = [c]
        for i_level, mult in enumerate(m.ch_mult):
            for _ in range(m.num_res_blocks):
                self.down_blocks.append(resblock(c, nf * mult))
                c = nf * mult
                if res in self.attn_resolutions:
                    self.down_attn.append(attn(c))
                hs_c.append(c)
            if i_level != self.num_resolutions - 1:
                if self.ddpm:
                    self.down_blocks.append(add("Downsample", Downsample(
                        c, None, fir_kernel, g, with_conv=m.resamp_with_conv, fir=fir)))
                else:
                    self.down_blocks.append(resblock(c, down=True))
                if progressive_input == "input_skip":
                    self.pyramid.append(add("Downsample", Downsample(
                        pyr_c, None, fir_kernel, g, with_conv=False, fir=fir)))
                    combine = add("Combine", Combine(pyr_c, c, m.progressive_combine.lower(),
                                                     generator=g))
                    self.pyramid.append(combine)
                    if combine.method == "cat":
                        c *= 2
                elif progressive_input == "residual":
                    self.pyramid.append(add("Downsample", Downsample(pyr_c, c, fir_kernel, g,
                                                                     fir=fir)))
                    pyr_c = c
                res //= 2
                hs_c.append(c)
        self.mid = nn.ModuleList([resblock(c), attn(c), resblock(c)])
        self.up_blocks, self.up_attn = nn.ModuleList(), nn.ModuleList()
        pyr_out = None  # the output pyramid's channels
        for i_level in reversed(range(self.num_resolutions)):
            for _ in range(m.num_res_blocks + 1):
                self.up_blocks.append(resblock(c + hs_c.pop(), nf * m.ch_mult[i_level]))
                c = nf * m.ch_mult[i_level]
            if res in self.attn_resolutions:
                self.up_attn.append(attn(c))
            if progressive != "none":
                if i_level != self.num_resolutions - 1:
                    self.pyramid_up.append(add("Upsample", Upsample(
                        pyr_out, c if progressive == "residual" else None,
                        progressive == "residual", fir, fir_kernel, g)))
                if progressive == "output_skip":
                    self.pyramid_up.extend(head(c, channels, m.init_scale))
                    pyr_out = channels
                elif i_level == self.num_resolutions - 1:
                    self.pyramid_up.extend(head(c, c))
                    pyr_out = c
                else:
                    pyr_out = c
            if i_level != 0:
                if self.ddpm:
                    self.up_blocks.append(add("Upsample", Upsample(
                        c, None, m.resamp_with_conv, fir, fir_kernel, g)))
                else:
                    self.up_blocks.append(resblock(c, up=True))
                res *= 2
        assert not hs_c
        if progressive != "output_skip":
            self.norm_out, self.conv_out = head(c, channels, m.init_scale)
        # each residual block's columns of the per-eval temb product, in module order
        self.res_blocks = [mod for _, mod in self.scopes
                           if isinstance(mod, ResnetBlockBigGANpp) and mod.temb_dense is not None]
        off = 0
        for blk in self.res_blocks:
            n = blk.temb_dense.weight.shape[1]
            blk.temb_cols = slice(off, off + n)
            off += n
        self._temb_cat = _KernelWeights()

    def temb_rows(self, temb):
        """Every residual block's temb row in one f32 product:
        silu(temb) @ W_cat + b_cat, (B, sum of Cout), with W_cat (4 nf, sum of
        Cout) and b_cat the blocks' Dense weights and biases concatenated in
        module order (block ``blk``'s row is the column slice
        ``blk.temb_cols``). W_cat and b_cat are made once and remade when a
        Dense parameter changes."""
        dense = [blk.temb_dense for blk in self.res_blocks]

        def make():
            return (torch.cat([d.weight.detach() for d in dense], 1).float().contiguous(),
                    torch.cat([d.bias.detach() for d in dense]).float())

        w_cat, b_cat = self._temb_cat.get([t for d in dense for t in (d.weight, d.bias)], make)
        return torch.addmm(b_cat, F.silu(temb.float()), w_cat)

    def _used_sigmas(self, time_cond):
        """scale_by_sigma's divisor (unet.py:102-110, 315-317): the label
        itself (Fourier), or sigmas[int(label)] (positional; the label
        truncated)."""
        if self.embedding == "fourier":
            return time_cond.float()
        if self._sigmas_dev is None or self._sigmas_dev.device != time_cond.device:
            self._sigmas_dev = torch.from_numpy(self.sigmas).to(time_cond.device)
        return self._sigmas_dev[time_cond.to(torch.int32).long()]

    def forward(self, x, time_cond, train: bool = False,
                generator: torch.Generator | None = None, calib: dict | None = None):
        """x: (B, H, W, C) f32 (CLD: 2*C, the stacked (x, v)); time_cond: (B,)
        noise labels. Returns f32.
        train: the training paths, dropout masks drawn from ``generator``.
        calib: a dict that collects the int8 calibration (the JAX package's
        apply with mutable 'qscales'): every block runs its plain composition
        and folds each site's max|activation| into calib[scope][site]."""
        fused = self.fused and calib is None
        rows = None  # the per-eval temb rows of the whole-block paths
        impl = self.layer if fused and self.layer is not None else "plain"

        def extra(block):
            if calib is not None:
                return {"sow": _amax_sow(calib.setdefault(block.scope, {}))}
            if self.layer is not None:
                return {"layer": impl}
            return {"int8": True, "qscales": self.qscales.get(block.scope)} if self.int8 else {}

        def res(block, h):
            if isinstance(block, (Downsample, Upsample)):  # DDPM blocks' resampling
                return block(h) if isinstance(block, Downsample) else block(h, impl)
            row = None if rows is None else rows[:, block.temb_cols]
            return block(h, temb, fused, train, generator, transition=self.transition,
                         temb_row=row, fused_train=self.fused_train, remat=self.remat,
                         **extra(block))

        def att(block, h):
            return block(h, fused, train, fused_attn=self.fused_attn,
                         attention_impl=self.attention_impl, **extra(block))

        def head(modules, h, conv_impl="plain"):  # norm_act, then a 3x3 conv
            norm, conv = next(modules), next(modules)
            return conv(norm_act(norm, h, fused, act=self.act), conv_impl)

        if self.embedding == "fourier":
            temb = self.fourier(torch.log(time_cond.float()))
        else:
            temb = get_timestep_embedding(time_cond.float(), self.nf)
        if self.conditional:
            temb = self.temb0(temb.to(self.dtype))
            temb = self.temb1(self.act(temb))
        else:
            temb = None
        if fused and not train and self.layer is None and self.res_blocks and self.act is F.silu:
            rows = self.temb_rows(temb)
        if not self.centered:
            x = 2 * x - 1.0
        x = x.to(self.dtype)

        blocks, attns, pyramid = iter(self.down_blocks), iter(self.down_attn), iter(self.pyramid)
        input_pyramid = x
        hs = [self.conv_in(x)]
        for i_level in range(self.num_resolutions):
            for _ in range(self.num_res_blocks):
                h = res(next(blocks), hs[-1])
                if h.shape[1] in self.attn_resolutions:
                    h = att(next(attns), h)
                hs.append(h)
            if i_level != self.num_resolutions - 1:
                h = res(next(blocks), hs[-1])
                if self.progressive_input == "input_skip":
                    input_pyramid = next(pyramid)(input_pyramid)
                    h = next(pyramid)(input_pyramid, h)
                elif self.progressive_input == "residual":
                    input_pyramid = next(pyramid)(input_pyramid) + h
                    if self.skip_rescale:
                        input_pyramid = input_pyramid * _INV_SQRT2
                    h = input_pyramid
                hs.append(h)

        res1, attn, res2 = self.mid
        h = res(res2, att(attn, res(res1, hs[-1])))

        blocks, attns, up = iter(self.up_blocks), iter(self.up_attn), iter(self.pyramid_up)
        # the residual output pyramid's conv goes through K11 on the 'pallas'
        # path (the JAX package's conv3x3 there is not allowed int8)
        pyr_impl = "pallas" if impl == "pallas" else "plain"
        pyr = None
        for i_level in reversed(range(self.num_resolutions)):
            for _ in range(self.num_res_blocks + 1):
                h = res(next(blocks), (h, hs.pop()))
            if h.shape[1] in self.attn_resolutions:
                h = att(next(attns), h)
            if self.progressive != "none":
                last = i_level == self.num_resolutions - 1
                if self.progressive == "output_skip":
                    pyr = head(up, h) if last else next(up)(pyr) + head(up, h)
                elif last:
                    pyr = head(up, h, pyr_impl)
                else:
                    pyr = next(up)(pyr) + h
                    if self.skip_rescale:
                        pyr = pyr * _INV_SQRT2
                    h = pyr
            if i_level != 0:
                h = res(next(blocks), h)
        assert not hs

        if self.progressive == "output_skip":
            h = pyr
        else:
            h = self.conv_out(norm_act(self.norm_out, h, fused, act=self.act))
        h = h.float()
        if self.sigmas is not None:
            h = h / self._used_sigmas(time_cond).reshape((-1,) + (1,) * (h.dim() - 1))
        return h
