"""NCSN++ building blocks (counterpart of ``gddim_tpu/models/blocks.py``).

Each block takes its kernel choice explicitly: ``fused=True`` runs the
block through its kernel wrappers, which on a CPU tensor are the plain
composition and on a CUDA tensor the hand-written kernels; ``fused=False``
runs the plain composition on any device.

- layer-wise inference (``layer='pallas'`` or ``'int8'`` with fused, the
  JAX package's path when ``CONV3X3_IMPL`` is neither fused mode,
  gddim_tpu/models/blocks.py:135-147,405-406,539-584): the residual block
  layer by layer, the (h, skip) pair concatenated first; GN+SiLU through K1
  ('pallas', and a transition's GN1 either way) or K12 ('int8': the int8
  tensor and per-sample scale the conv takes), FIR resampling, each 3x3 conv
  through K11 in bf16 or int8 (a transition's conv1 on
  ``quantize_per_sample`` of the resampled h), the temb Dense, the plain
  1x1 skip; attention as K1 GroupNorm (no SiLU), the NIN projections and K8;

- inference (``train=False``): K2-K4 for the residual blocks (with K1 for a
  transition's GN1) and K5 for attention; no gradients. With
  ``transition='full'`` an up/down block is one K9 call instead of K1, two
  FIR passes and K4 (gddim_tpu/models/blocks.py:461-502, behind
  GDDIM_TRANSITION_IMPL=full there). Each kernel call is gated as the JAX
  package gates it (``resblock_ops.supported``, blocks.py:242-249, 351-358,
  505; ``attnblock_ops.supported``, blocks.py:83-87) by the port's own
  ``ops.resblock`` / ``ops.attnblock`` ``*_supported``, which say where the
  card's tile plans exist; any other block runs the plain composition in
  the activation dtype. The model may hand a block its temb row (``temb_row``,
  a column slice of one per-eval product, ``models/unet.py``) in place of
  its Dense. ``int8=True`` takes
  their int8 modes (``conv_impl='fused_int8'``, gddim_tpu/models/blocks.py:
  75-105,341-403,467-537): weights quantized once per block from their
  values rounded to the activation dtype (bench.py's bf16 pre-cast), and
  static activation scales when the block's ``qscales`` hold every site it
  needs ("a1", "a2"; "h", "a"), else per-sample scales (``_static_scales``,
  blocks.py:46-62). The skip site "x" is calibrated but never used;
- calibration (``sow``): the plain composition, with sow(site, tensor)
  seeing each int8 quantization site (blocks.py:27-43,135-143,562-580);
- training (``train=True``, gddim_tpu/models/blocks.py:107-147,405-459,
  545-584): stride-1 residual blocks (up-path pairs concatenated) through
  K6/K7 where ``train_supported`` takes them and ``fused_train`` is on (the
  JAX package's ``model.fused_train``), elsewhere, as the transitions, the
  unfused layers with K1 for GN1 and GN2, and
  attention as K1 GroupNorm, the NIN projections and K8, or with
  ``fused_attn`` as K10 (blocks.py:107-133, GDDIM_FUSED_ATTN_TRAIN=1 there).
  Dropout masks are drawn in the block, outside any kernel, from the
  caller's generator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gddim_torch.models import resample
from gddim_torch.models.layers import (
    NIN,
    Conv,
    Dense,
    GroupNorm,
    _KernelWeights,
    int8_conv_fusion_ok,
    norm_act,
    num_groups_for,
)
from gddim_torch.ops import attnblock as attn_ops
from gddim_torch.ops import resblock as rb
from gddim_torch.ops.attention import self_attention_2d


def _bf16(params):
    return [p.detach().to(torch.bfloat16).contiguous() for p in params]


def _site_amaxes(qscales, sites):
    """The calibrated amaxes of ``sites``, or [] (per-sample scales) unless
    ``qscales`` holds every one of them."""
    if not qscales or not all(k in qscales for k in sites):
        return []
    return [qscales[k] for k in sites]


def _static_scales(amaxes):
    """The static scales of the sites' amaxes as one f32 row, or None."""
    return torch.stack(rb.act_scales_from_amax(amaxes)) if amaxes else None


def _quantized(w, dtype):
    """quantize_weight of w rounded to the activation dtype first."""
    return rb.quantize_weight(w.detach().to(dtype))


def _kmajor(w) -> bool:
    """Whether the int8 weights are packed K-major, as the int8 block GEMM
    reads them (the residual blocks' convs by ``pack_int8_weight``, the
    attention projections by ``pack_projection``): on the card; the plain
    versions take the JAX layout too."""
    return w.is_cuda


# (int8 kernel, bf16 kernel, plain composition) of each residual block kind
_RES_OPS = {
    "tail": (rb.fused_resblock_tail_int8, rb.fused_resblock_tail, rb.resblock_tail_reference),
    "pair": (rb.fused_resblock_pair_int8, rb.fused_resblock_pair, rb.resblock_pair_reference),
    "stride1": (rb.fused_resblock_int8, rb.fused_resblock, rb.resblock_reference),
}


def _route(kernel: bool, int8: bool) -> int:
    """The index into _RES_OPS: the int8 or bf16 kernel, else the plain
    composition."""
    return (0 if int8 else 1) if kernel else 2


class ResnetBlockBigGANpp(nn.Module):
    """BigGAN residual block with in-block FIR resampling
    (reference layerspp.py:180-227)."""

    def __init__(self, cin: int, out_ch: int | None, temb_dim: int, up: bool = False,
                 down: bool = False, fir_kernel=(1, 3, 3, 1), skip_rescale: bool = True,
                 init_scale: float = 0.0, dropout: float = 0.0, generator=None):
        super().__init__()
        out_ch = out_ch or cin
        self.up, self.down = up, down
        self.dropout = dropout
        self.fir_kernel = tuple(fir_kernel)
        self.skip_rescale = skip_rescale
        self.norm1 = GroupNorm(cin)
        self.conv1 = Conv(cin, out_ch, 3, generator=generator)
        self.temb_dense = Dense(temb_dim, out_ch, generator=generator)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = Conv(out_ch, out_ch, 3, init_scale=init_scale, generator=generator)
        self.skip = (Conv(cin, out_ch, 1, generator=generator)
                     if cin != out_ch or up or down else None)
        self._kw = _KernelWeights()
        self._kw8 = _KernelWeights()

    def forward(self, x, temb, fused: bool = False, train: bool = False,
                generator: torch.Generator | None = None, int8: bool = False,
                qscales: dict | None = None, sow=None, layer: str | None = None,
                transition: str = "tail", temb_row=None, fused_train: bool = True):
        """x: (B, H, W, C), or the up path's (h, skip) pair. train: dropout
        masks from ``generator``, and the differentiable kernels. int8 (with
        fused): the int8 kernels, static scales from this block's ``qscales``
        amaxes. layer (with fused): the layer-wise path, 'pallas' or 'int8'.
        transition='full' (with fused, an up/down block): the whole block
        through K9 where ``transition_supported`` takes it, else K1, the FIR
        resample and K4. With fused, each kernel runs where its gate takes
        the block (``rb.stride1_supported``, ``pair_supported``,
        ``tail_supported``), the plain composition elsewhere. temb_row: this
        block's (B, Cout) f32 temb projection, made by the caller, in place
        of silu(temb) through the Dense. sow: calibration (the plain
        composition). fused_train=False (with train): the stride-1 block's
        unfused layers (K1 for its GroupNorms with fused) in place of K6/K7
        (``model.fused_train``)."""
        if train:
            return self._forward_train(x, temb, fused, generator, fused_train)
        if fused and layer is not None:
            return self._forward_layerwise(x, temb, layer)
        pair = isinstance(x, (tuple, list))
        first = x[0] if pair else x
        int8 = fused and int8
        dense = ((temb, self.temb_dense.weight, self.temb_dense.bias) if temb_row is None
                 else (temb_row, None, None))
        kw = dict(num_groups2=self.norm2.num_groups, eps=self.norm2.eps,
                  skip_rescale=self.skip_rescale)
        if not fused and sow is not None:
            kw["sow"] = sow
        out_ch = self.conv1.weight.shape[-1]
        if (fused and transition == "full" and (self.up or self.down)
                and rb.transition_supported(x.shape, out_ch, self.up, True, self.fir_kernel,
                                            int8)):
            op = rb.fused_resblock_transition_int8 if int8 else rb.fused_resblock_transition
            return op(x, *dense, self.norm1.weight, self.norm1.bias,
                      *self._mid(True, int8, first, qscales), up=self.up,
                      fir_kernel=self.fir_kernel, num_groups1=self.norm1.num_groups, **kw)
        if self.up or self.down:
            h = self.norm1(x, act=True, fused=fused)
            res = resample.upsample_2d if self.up else resample.downsample_2d
            h, xr = res(h, self.fir_kernel), res(x, self.fir_kernel)
            ok = fused and rb.tail_supported(h.shape, out_ch, int8)
            return _RES_OPS["tail"][_route(ok, int8)](
                h, xr, *dense, *self._mid(ok, int8, first, qscales), **kw)
        gn1 = (self.norm1.weight, self.norm1.bias)
        kw["num_groups1"] = self.norm1.num_groups
        if pair:
            ok = fused and rb.pair_supported(x[0].shape, x[1].shape[-1], out_ch, int8)
            return _RES_OPS["pair"][_route(ok, int8)](
                x[0], x[1], *dense, *gn1, *self._mid(ok, int8, first, qscales), **kw)
        ok = fused and rb.stride1_supported(x.shape, out_ch, int8)
        return _RES_OPS["stride1"][_route(ok, int8)](
            x, *dense, *gn1, *self._mid(ok, int8, first, qscales), **kw)

    def _mid(self, kernel: bool, int8: bool, first, qscales):
        """(conv1 weight, b1, GN2 scale, GN2 bias, conv2 weight, b2, skip
        weight, skip bias[, static scales]) as the route takes them: the
        kernels' (int8: quantized, K-major on the card, and the static scales;
        bf16 on the card: cast once), or the plain composition's parameters."""
        w1, w2 = self.conv1.weight, self.conv2.weight
        w_skip = b_skip = None
        if self.skip is not None:
            w_skip, b_skip = self.skip.weight[0, 0], self.skip.bias
        params = [w1, w2] + ([w_skip] if w_skip is not None else [])
        scales = ()
        if kernel and int8:
            w1, w2, w_skip, s = self._int8_weights(params, first.dtype, qscales)
            scales = (s,)
        elif kernel and first.is_cuda:
            kw = self._kw.get(params, lambda: _bf16(params))
            w1, w2 = kw[0], kw[1]
            w_skip = kw[2] if w_skip is not None else None
        return (w1, self.conv1.bias, self.norm2.weight, self.norm2.bias, w2, self.conv2.bias,
                w_skip, b_skip) + scales

    def _int8_weights(self, params, dtype, qscales):
        """(conv1 and conv2 quantized, K-major on the card, the bf16 skip or
        None, the static [s1, s2] or None), made once and remade when a
        weight or amax changes."""
        amaxes = _site_amaxes(qscales, ("a1", "a2"))

        def make():
            w1, w2, *skip = params
            convs = [_quantized(w, dtype) for w in (w1, w2)]
            if _kmajor(w1):
                convs = [rb.pack_int8_weight(c) for c in convs]
            return (*convs, _bf16(skip)[0] if skip else None, _static_scales(amaxes))

        return self._kw8.get(params + amaxes, make, tag=(dtype,))

    def _forward_layerwise(self, x, temb, impl):
        """The block layer by layer (inference), the 3x3 convs through K11
        ('pallas': bf16; 'int8': int8, fed by K12 where GN+SiLU feeds them)."""
        if isinstance(x, (tuple, list)):
            x = torch.cat(x, -1)
        out_ch = self.conv1.weight.shape[-1]
        resampled = self.up or self.down
        fuse1 = not resampled and int8_conv_fusion_ok(x.shape, out_ch, impl)
        h = norm_act(self.norm1, x, quantize_out=fuse1)
        if resampled:
            res = resample.upsample_2d if self.up else resample.downsample_2d
            h, x = res(h, self.fir_kernel), res(x, self.fir_kernel)
        h = self.conv1(h, impl)
        h = h + self.temb_dense(F.silu(temb))[:, None, None, :].to(h.dtype)
        h = norm_act(self.norm2, h, quantize_out=int8_conv_fusion_ok(h.shape, out_ch, impl))
        h = self.conv2(h, impl)
        out = (x if self.skip is None else self.skip(x)) + h
        return out * rb._INV_SQRT2 if self.skip_rescale else out

    def _forward_train(self, x, temb, fused, generator, fused_train=True):
        if isinstance(x, (tuple, list)):
            x = torch.cat(x, -1)
        b, h, w, _ = x.shape
        if self.up:
            h, w = 2 * h, 2 * w
        elif self.down:
            h, w = h // 2, w // 2
        out_ch = self.conv1.weight.shape[-1]
        keep = 1.0 - self.dropout
        mask = None
        if keep < 1.0:
            probs = torch.full((b, h, w, out_ch), keep, device=x.device)
            mask = torch.bernoulli(probs, generator=generator).to(torch.int8)
        temb_proj = rb.temb_projection(temb, self.temb_dense.weight, self.temb_dense.bias)
        w_skip = b_skip = None
        if self.skip is not None:
            w_skip, b_skip = self.skip.weight[0, 0], self.skip.bias
        resampled = self.up or self.down
        if not resampled and fused and fused_train and rb.train_supported(x.shape, out_ch):
            return rb.fused_resblock_train(
                x, temb_proj, self.norm1.weight, self.norm1.bias, self.conv1.weight,
                self.conv1.bias, self.norm2.weight, self.norm2.bias, self.conv2.weight,
                self.conv2.bias, w_skip, b_skip, mask, keep_prob=keep,
                num_groups1=self.norm1.num_groups, num_groups2=self.norm2.num_groups,
                eps=self.norm2.eps, skip_rescale=self.skip_rescale)
        # the unfused layers (gddim_tpu/models/blocks.py:545-584): K1 for GN1
        # and GN2 with fused, the FIR resample in a transition
        hh = self.norm1(x, act=True, fused=fused)
        if resampled:
            res = resample.upsample_2d if self.up else resample.downsample_2d
            hh, x = res(hh, self.fir_kernel), res(x, self.fir_kernel)
        hh = self.conv1(hh) + temb_proj.to(hh.dtype)[:, None, None, :]
        hh = self.norm2(hh, act=True, fused=fused)
        if mask is not None:
            hh = hh * (mask.to(hh.dtype) * (1.0 / keep))
        hh = self.conv2(hh)
        out = (x if self.skip is None else self.skip(x)) + hh
        return out * rb._INV_SQRT2 if self.skip_rescale else out


class AttnBlockpp(nn.Module):
    """Spatial self-attention block (reference layerspp.py:61-83)."""

    def __init__(self, c: int, skip_rescale: bool = False, init_scale: float = 0.0,
                 generator=None):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.norm = GroupNorm(c)
        self.q = NIN(c, c, generator=generator)
        self.k = NIN(c, c, generator=generator)
        self.v = NIN(c, c, generator=generator)
        self.out = NIN(c, c, init_scale=init_scale, generator=generator)
        self._kw = _KernelWeights()
        self._kw8 = _KernelWeights()

    def forward(self, x, fused: bool = False, train: bool = False, int8: bool = False,
                qscales: dict | None = None, sow=None, layer: str | None = None,
                fused_attn: bool = False):
        """int8 (with fused): K5's int8 mode, static scales from this block's
        ``qscales`` amaxes. layer (with fused): the layer-wise path, K1, the
        NIN projections and K8, as in training. fused_attn (with train and
        fused): K10 where the kernels take the shape. With fused, K5 runs
        where ``attn_ops.supported`` takes the block, the plain composition
        elsewhere. sow: calibration (the plain composition)."""
        kw = dict(num_groups=num_groups_for(x.shape[-1]), eps=self.norm.eps,
                  skip_rescale=self.skip_rescale)
        if train and fused and fused_attn and attn_ops.supported(x.shape):
            return attn_ops.fused_attnblock_train(
                x, self.norm.weight, self.norm.bias, self.q.weight, self.q.bias, self.k.weight,
                self.k.bias, self.v.weight, self.v.bias, self.out.weight, self.out.bias, **kw)
        if train or (fused and layer is not None):
            h = self.norm(x, act=False, fused=fused)
            h = self_attention_2d(self.q(h), self.k(h), self.v(h), fused=fused)
            out = x + self.out(h)
            return out * attn_ops._INV_SQRT2 if self.skip_rescale else out
        int8 = fused and int8
        kernel = fused and attn_ops.supported(x.shape, int8)
        if kernel and int8:
            wqkv, bqkv, wo, scales = self._int8_weights(x.dtype, qscales)
            return attn_ops.fused_attnblock_int8(x, self.norm.weight, self.norm.bias, wqkv, bqkv,
                                                 wo, self.out.bias, scales, **kw)
        if kernel and x.is_cuda:
            return attn_ops.fused_attnblock_packed(x, self.norm.weight, self.norm.bias,
                                                   self._weights(), **kw)
        if not fused and sow is not None:
            kw["sow"] = sow
        op = attn_ops.fused_attnblock if kernel else attn_ops.attnblock_reference
        return op(x, self.norm.weight, self.norm.bias,
                  self.q.weight, self.q.bias, self.k.weight, self.k.bias,
                  self.v.weight, self.v.bias, self.out.weight, self.out.bias, **kw)

    def _weights(self):
        """The block's NIN weights as K5 takes them on the card
        (``pack_attn_weights``: bf16 [Wq|Wk|Wv] and Wo, f32 biases), made
        once and remade when a parameter changes."""
        params = [self.q.weight, self.q.bias, self.k.weight, self.k.bias, self.v.weight,
                  self.v.bias, self.out.weight, self.out.bias]
        return self._kw.get(params,
                            lambda: attn_ops.pack_attn_weights(*(p.detach() for p in params)))

    def _int8_weights(self, dtype, qscales):
        """([Wq|Wk|Wv] quantized, [bq|bk|bv], Wo quantized, the static
        [s_h, s_a] or None), made once and remade when a parameter or amax
        changes; the projections packed K-major on the card
        (``pack_projection``), as the int8 block GEMM reads them."""
        amaxes = _site_amaxes(qscales, ("h", "a"))
        params = [self.q.weight, self.k.weight, self.v.weight, self.q.bias, self.k.bias,
                  self.v.bias, self.out.weight]

        def make():
            wqkv = torch.cat([self.q.weight, self.k.weight, self.v.weight], 1)
            bqkv = torch.cat([self.q.bias, self.k.bias, self.v.bias]).detach()
            projs = [_quantized(wqkv, dtype), _quantized(self.out.weight, dtype)]
            if _kmajor(wqkv):
                projs = [attn_ops.pack_projection(w) for w in projs]
            return projs[0], bqkv, projs[1], _static_scales(amaxes)

        return self._kw8.get(params + amaxes, make, tag=(dtype,))


class Downsample(nn.Module):
    """FIR downsample with conv (the progressive_input='residual' pyramid;
    reference layerspp.py:115-143)."""

    def __init__(self, cin: int, out_ch: int, fir_kernel=(1, 3, 3, 1), generator=None):
        super().__init__()
        self.conv = resample.Conv2d(cin, out_ch, 3, fir_kernel, generator=generator)

    def forward(self, x):
        return self.conv(x)
