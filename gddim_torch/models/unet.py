"""NCSN++ score U-Net (counterpart of ``gddim_tpu/models/unet.py``).

Covers the options ``cld/accr_dcifar10`` and ``blur/ddpm_deep_cifar10`` set:
Fourier time embedding, BigGAN blocks with FIR resampling,
progressive_input='residual', progressive='none', skip rescaling; the input
and output have ``data.num_channels`` channels, doubled for CLD's (x, v)
(``gddim_tpu/models/wrappers.py:33``). NHWC throughout; parameters float32,
activations in ``config.model.dtype``; ``config.model.conv_impl`` picks, for
every block, the whole-block kernels ('fused'), their int8 modes
('fused_int8'), the layer-wise kernels ('pallas': GroupNorm and 3x3 conv
kernels in bf16; 'int8': int8 3x3 convs fed by GroupNorm+SiLU+quantize) or
the plain torch composition ('plain'); ``config.model.transition_impl='full'``
runs the whole-block paths' six up/down blocks through K9,
``config.training.fused_attn`` the training path's attention through K10,
and ``config.model.fused_train`` its stride-1 residual blocks through K6/K7
(off: their unfused layers, K1 for the GroupNorms).
The stem, head and pyramid convs stay plain in every mode: their channel
counts are outside what the 3x3 conv kernel takes, as in the JAX package. With ``train=True`` the blocks take their
training paths (dropout, K1/K6/K7/K8), and the dropout masks are drawn in
the order the blocks run from the caller's generator.

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
(``unet.py:221-312``), and ``scopes`` records each one's flax scope name, so
converted weights map one to one (``gddim_torch/convert.py``).
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F
from torch import nn

from gddim_torch.configs import CONV_IMPLS, TRANSITION_IMPLS
from gddim_torch.models.blocks import AttnBlockpp, Downsample, ResnetBlockBigGANpp
from gddim_torch.models.layers import (
    Conv,
    Dense,
    GaussianFourierProjection,
    GroupNorm,
    _KernelWeights,
)

_INV_SQRT2 = 0.7071067811865476
_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16, "float32": torch.float32}


def _require(cond: bool, what: str):
    if not cond:
        raise NotImplementedError(f"NCSNpp port: unsupported option {what}")


def _amax_sow(sites: dict):
    """sow(site, tensor) folding max|tensor| (f32, on its device) into sites."""

    def sow(name, t):
        a = t.detach().float().abs().amax()
        sites[name] = torch.maximum(sites[name], a) if name in sites else a

    return sow


class NCSNpp(nn.Module):
    def __init__(self, config, generator: torch.Generator | None = None):
        super().__init__()
        m = config.model
        _require(m.resblock_type.lower() == "biggan", f"resblock_type={m.resblock_type}")
        _require(bool(m.fir), "fir=False")
        _require(m.progressive.lower() == "none", f"progressive={m.progressive}")
        _require(m.progressive_input.lower() == "residual",
                 f"progressive_input={m.progressive_input}")
        _require(m.embedding_type.lower() == "fourier", f"embedding_type={m.embedding_type}")
        _require(bool(m.conditional), "conditional=False")
        _require(m.nonlinearity.lower() == "swish", f"nonlinearity={m.nonlinearity}")
        _require(not m.scale_by_sigma, "scale_by_sigma=True")
        _require(bool(m.skip_rescale), "skip_rescale=False")
        if m.conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {m.conv_impl!r}")
        if m.transition_impl not in TRANSITION_IMPLS:
            raise ValueError(f"transition_impl must be one of {TRANSITION_IMPLS}, "
                             f"got {m.transition_impl!r}")
        self.fused = m.conv_impl != "plain"  # kernels (False: the plain composition)
        self.int8 = m.conv_impl == "fused_int8"  # the whole-block kernels' int8 modes
        self.layer = m.conv_impl if m.conv_impl in ("pallas", "int8") else None  # layer-wise
        self.transition = m.transition_impl  # 'full': K9 for the whole-block paths' transitions
        self.fused_attn = bool(config.training.fused_attn)  # training attention through K10
        self.fused_train = bool(m.fused_train)  # training stride-1 blocks through K6/K7
        self.qscales: dict = {}
        self.dtype = _DTYPES[str(m.dtype).lower()]
        self.centered = bool(config.data.centered)
        self.num_res_blocks = m.num_res_blocks
        self.num_resolutions = len(m.ch_mult)
        self.attn_resolutions = tuple(m.attn_resolutions)
        nf, g = m.nf, generator
        fir_kernel = tuple(m.fir_kernel)
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
            return add("ResnetBlockBigGANpp", ResnetBlockBigGANpp(
                cin, out, 4 * nf, fir_kernel=fir_kernel, skip_rescale=m.skip_rescale,
                init_scale=m.init_scale, dropout=m.dropout, generator=g, **kw))

        def attn(c):
            return add("AttnBlockpp", AttnBlockpp(c, skip_rescale=m.skip_rescale,
                                                  init_scale=m.init_scale, generator=g))

        self.fourier = add("GaussianFourierProjection",
                           GaussianFourierProjection(nf, m.fourier_scale, generator=g))
        self.temb0 = add("Dense", Dense(2 * nf, 4 * nf, generator=g))
        self.temb1 = add("Dense", Dense(4 * nf, 4 * nf, generator=g))
        self.conv_in = add("Conv", Conv(channels, nf, 3, generator=g))
        self.down_blocks, self.down_attn = nn.ModuleList(), nn.ModuleList()
        self.pyramid = nn.ModuleList()
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
                self.down_blocks.append(resblock(c, down=True))
                self.pyramid.append(add("Downsample", Downsample(pyr_c, c, fir_kernel, g)))
                pyr_c = c
                res //= 2
                hs_c.append(c)
        self.mid = nn.ModuleList([resblock(c), attn(c), resblock(c)])
        self.up_blocks, self.up_attn = nn.ModuleList(), nn.ModuleList()
        for i_level in reversed(range(self.num_resolutions)):
            for _ in range(m.num_res_blocks + 1):
                self.up_blocks.append(resblock(c + hs_c.pop(), nf * m.ch_mult[i_level]))
                c = nf * m.ch_mult[i_level]
            if res in self.attn_resolutions:
                self.up_attn.append(attn(c))
            if i_level != 0:
                self.up_blocks.append(resblock(c, up=True))
                res *= 2
        assert not hs_c
        self.norm_out = add("GroupNorm", GroupNorm(c))
        self.conv_out = add("Conv", Conv(c, channels, 3, init_scale=m.init_scale, generator=g))
        # each residual block's columns of the per-eval temb product, in module order
        self.res_blocks = [mod for _, mod in self.scopes if isinstance(mod, ResnetBlockBigGANpp)]
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

        def extra(block):
            if calib is not None:
                return {"sow": _amax_sow(calib.setdefault(block.scope, {}))}
            if self.layer is not None:
                return {"layer": self.layer}
            return {"int8": True, "qscales": self.qscales.get(block.scope)} if self.int8 else {}

        def res(block, h):
            row = None if rows is None else rows[:, block.temb_cols]
            return block(h, temb, fused, train, generator, transition=self.transition,
                         temb_row=row, fused_train=self.fused_train, **extra(block))

        def att(block, h):
            return block(h, fused, train, fused_attn=self.fused_attn, **extra(block))

        temb = self.fourier(torch.log(time_cond.float()))
        temb = self.temb0(temb.to(self.dtype))
        temb = self.temb1(F.silu(temb))
        if fused and not train and self.layer is None:
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
                input_pyramid = (next(pyramid)(input_pyramid) + h) * _INV_SQRT2
                h = input_pyramid
                hs.append(h)

        res1, attn, res2 = self.mid
        h = res(res2, att(attn, res(res1, hs[-1])))

        blocks, attns = iter(self.up_blocks), iter(self.up_attn)
        for i_level in reversed(range(self.num_resolutions)):
            for _ in range(self.num_res_blocks + 1):
                h = res(next(blocks), (h, hs.pop()))
            if h.shape[1] in self.attn_resolutions:
                h = att(next(attns), h)
            if i_level != 0:
                h = res(next(blocks), h)
        assert not hs

        h = self.norm_out(h, act=True, fused=fused)
        return self.conv_out(h).float()
