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
  tensor and per-sample scale the conv takes), the resample, each 3x3 conv
  through K11 in bf16 or int8 (a transition's conv1 on
  ``quantize_per_sample`` of the resampled h), the temb Dense, the plain
  1x1 skip; attention as K1 GroupNorm (no SiLU), the NIN projections and K8;

- inference (``train=False``): K2-K4 for the residual blocks (with K1 for a
  transition's GN1) and K5 for attention; no gradients. With
  ``transition='full'`` an up/down block is one K9 call (FIR or naive
  coefficients) instead of K1, two resample passes and K4
  (gddim_tpu/models/blocks.py:461-502, behind
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
  unfused layers with K1 for GN1 and GN2 and, with ``layer='pallas'``, the
  3x3 convs through K11's autograd.Function where its gate takes them
  (conv1 and conv2 of those BigGAN blocks and of every DDPM block, and a
  DDPM block's 3x3 conv shortcut: the JAX package's ``conv3x3`` calls,
  which its ``CONV3X3_IMPL`` sends to ``conv3x3_pallas`` in training too;
  'int8' trains them plain, the JAX "training-safe fallback"), and
  attention as K1 GroupNorm, the NIN projections and K8, or with
  ``fused_attn`` as K10 (blocks.py:107-133, GDDIM_FUSED_ATTN_TRAIN=1 there;
  its projections are NINs, never K11). Dropout masks are drawn in the
  block, outside any kernel, from the caller's generator. ``remat``
  (``model.remat``, gddim_tpu/models/unet.py:160-209) recomputes the unfused
  layers' activations in the backward: True the whole block
  (``torch.utils.checkpoint``), 'convs' / 'convs_lean' all but the 3x3
  conv outputs (``_RematConv``); the K6/K7 blocks save only x and the mask
  already and take no remat, as the JAX config notes (the fused block
  replaces remat, default_cifar10.py:99-105).

A block with another activation than swish, or without a temb, runs its
unfused layers on every path (K1 for its GroupNorms with fused), as the
JAX package gates its kernels. ``ResnetBlockDDPMpp`` (no resampling; a NIN
or 3x3 conv skip) takes K2 at inference, its unfused layers elsewhere;
``Upsample`` / ``Downsample`` are the DDPM trunk's and the pyramids'
resamplers, plain.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
from gddim_torch.ops.attention import resolve_impl, self_attention_2d
from gddim_torch.ops.conv3x3 import conv3x3_vjp
from gddim_torch.parallel.draws import draw_rows


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


class _RematConv(torch.autograd.Function):
    """y = conv(chain(*acts)) + b for the selective remat modes: the forward
    keeps the chain's inputs and the conv output y (the caller holds it), not
    the chain's activations; ``keep`` also keeps the conv's input (the
    post-dropout activation of 'convs'), which the weight gradient then
    reads in place of the recomputed one. The backward recomputes the chain
    from its inputs, takes the conv's VJP (``conv3x3_vjp``, the conv not run
    again) and the chain's by autograd. ``params``: the parameters the chain
    reads, passed as inputs so that their gradients come back here."""

    @staticmethod
    def forward(ctx, chain, conv_fn, keep, n_acts, *tensors):
        acts = tensors[:n_acts]
        a = chain(*acts)
        y = conv_fn(a)
        ctx.chain, ctx.n_acts, ctx.keep = chain, n_acts, keep
        ctx.save_for_backward(*tensors, *((a,) if keep else ()))
        return y

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        n, tensors = ctx.n_acts, saved[:len(saved) - int(ctx.keep)]
        acts, rest = tensors[:n], tensors[n:]
        params, w, b = rest[:-2], rest[-2], rest[-1]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(t.requires_grad) for t in acts]
            a = ctx.chain(*ins)
        da, dw = conv3x3_vjp(saved[-1] if ctx.keep else a.detach(), w, gy)
        wrt = [t for t in ins + list(params) if t.requires_grad]
        got = iter(torch.autograd.grad(a, wrt, da.to(a.dtype), allow_unused=True) if wrt else ())
        grads = [next(got) if t.requires_grad else None for t in ins + list(params)]
        db = gy.sum_to_size(b.shape)
        return (None, None, None, None, *grads, dw.to(w.dtype), db.to(b.dtype))


def remat_conv(conv: Conv, impl: str, chain, acts, params, keep: bool = False):
    """conv(chain(*acts), impl) through ``_RematConv`` (a 3x3 conv of
    stride 1): the chain recomputed in the backward, the conv output kept."""

    def conv_fn(a):
        return conv(a, impl)

    return _RematConv.apply(chain, conv_fn, keep, len(acts), *acts, *params, conv.weight,
                            conv.bias)


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
    """BigGAN residual block with in-block resampling, FIR or (``fir=False``)
    naive (reference layerspp.py:180-227). ``temb_dim`` None: an
    unconditional block (no Dense); ``act``: the nonlinearity (``F.silu``,
    swish, is the one the kernels fuse: with another, or without a temb,
    every route runs the unfused layers, as the JAX package gates its
    kernels on ``act is nn.swish`` and a temb, blocks.py:355-356, 473)."""

    # flax sub-scope -> attribute (convert.py); a block kind may differ
    subscopes = {"GroupNorm_0": "norm1", "Conv_0": "conv1", "Dense_0": "temb_dense",
                 "GroupNorm_1": "norm2", "Conv_1": "conv2", "Conv_2": "skip"}

    def __init__(self, cin: int, out_ch: int | None, temb_dim: int | None, up: bool = False,
                 down: bool = False, fir_kernel=(1, 3, 3, 1), skip_rescale: bool = True,
                 init_scale: float = 0.0, dropout: float = 0.0, generator=None,
                 fir: bool = True, act=F.silu):
        super().__init__()
        out_ch = out_ch or cin
        self.up, self.down = up, down
        self.dropout = dropout
        self.fir = fir
        self.fir_kernel = tuple(fir_kernel)
        self.skip_rescale = skip_rescale
        self.act = act
        self.norm1 = GroupNorm(cin)
        self.conv1 = Conv(cin, out_ch, 3, generator=generator)
        self.temb_dense = Dense(temb_dim, out_ch, generator=generator) if temb_dim else None
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = Conv(out_ch, out_ch, 3, init_scale=init_scale, generator=generator)
        self.skip = self._make_skip(cin, out_ch, generator)
        self._kw = _KernelWeights()
        self._kw8 = _KernelWeights()

    def _make_skip(self, cin, out_ch, generator):
        """The skip projection: a 1x1 conv where the width or the resolution
        changes."""
        if cin != out_ch or self.up or self.down:
            return Conv(cin, out_ch, 1, generator=generator)
        return None

    def _skip_params(self):
        """(the skip's (Cin, Cout) weight, its bias), or (None, None)."""
        if self.skip is None:
            return None, None
        return self.skip.weight[0, 0], self.skip.bias

    def _kernels_ok(self, temb) -> bool:
        """Whether the block may take the whole-block kernels at all."""
        return self.act is F.silu and temb is not None and self.temb_dense is not None

    def _resample(self, t):
        """The block's factor-2 resample: FIR, or nearest up / the 2x2 mean down."""
        if self.fir:
            return (resample.upsample_2d if self.up else resample.downsample_2d)(t, self.fir_kernel)
        return (resample.naive_upsample_2d if self.up else resample.naive_downsample_2d)(t)

    def forward(self, x, temb, fused: bool = False, train: bool = False,
                generator: torch.Generator | None = None, int8: bool = False,
                qscales: dict | None = None, sow=None, layer: str | None = None,
                transition: str = "tail", temb_row=None, fused_train: bool = True,
                remat: bool | str = False):
        """x: (B, H, W, C), or the up path's (h, skip) pair. train: dropout
        masks from ``generator``, and the differentiable kernels. int8 (with
        fused): the int8 kernels, static scales from this block's ``qscales``
        amaxes. layer (with fused): the layer-wise path, 'pallas' or 'int8'
        (in training: K11's autograd.Function for 'pallas', the plain convs
        for 'int8'). remat (with train): the unfused layers' remat mode.
        transition='full' (with fused, an up/down block): the whole block
        through K9 where ``transition_supported`` takes it, else K1, the
        resample and K4. With fused, each kernel runs where its gate takes
        the block (``rb.stride1_supported``, ``pair_supported``,
        ``tail_supported``), the plain composition elsewhere. temb_row: this
        block's (B, Cout) f32 temb projection, made by the caller, in place
        of act(temb) through the Dense. sow: calibration (the plain
        composition). fused_train=False (with train): the stride-1 block's
        unfused layers (K1 for its GroupNorms with fused) in place of K6/K7
        (``model.fused_train``)."""
        if train:
            return self._forward_train(x, temb, fused, generator, fused_train, layer, remat)
        if fused and layer is not None:
            return self._forward_layers(x, temb, impl=layer)
        if not self._kernels_ok(temb):
            return self._forward_layers(x, temb, fused=fused, sow=sow)
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
                and rb.transition_supported(x.shape, out_ch, self.up, self.fir, self.fir_kernel,
                                            int8)):
            op = rb.fused_resblock_transition_int8 if int8 else rb.fused_resblock_transition
            return op(x, *dense, self.norm1.weight, self.norm1.bias,
                      *self._mid(True, int8, first, qscales), up=self.up, fir=self.fir,
                      fir_kernel=self.fir_kernel, num_groups1=self.norm1.num_groups, **kw)
        if self.up or self.down:
            h = self.norm1(x, act=True, fused=fused)
            h, xr = self._resample(h), self._resample(x)
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
        w_skip, b_skip = self._skip_params()
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

    def _skip(self, x, impl: str, sow=None):
        """The 1x1 skip projection; sow sees its input (the int8 site "x")."""
        if sow is not None:
            sow("x", x)
        return self.skip(x)

    def _forward_layers(self, x, temb, fused: bool = True, impl: str = "plain", mask=None,
                        keep: float = 1.0, sow=None, remat=None):
        """The block layer by layer (gddim_tpu/models/blocks.py:539-584): the
        pair concatenated; GN1 and GN2 with the activation (K1 with fused,
        else plain; ``impl`` 'int8' with swish: K12 where an int8 3x3 conv
        follows directly), the resample, the 3x3 convs through K11 where
        ``impl`` ('pallas' bf16 or f32, 'int8') takes them, the temb Dense,
        the dropout ``mask`` (training), the skip projection. sow(site, t)
        sees the int8 quantization sites as the plain composition's.
        remat ('convs' or 'convs_lean', training): each 3x3 conv with the
        chain before it through ``_RematConv``, which keeps the conv outputs
        and ('convs') the post-dropout activation."""
        if isinstance(x, (tuple, list)):
            x = torch.cat(x, -1)
        out_ch = self.conv1.weight.shape[-1]
        resampled = self.up or self.down
        swish = self.act is F.silu
        fuse1 = swish and not resampled and int8_conv_fusion_ok(x.shape, out_ch, impl)

        def chain1(x_):  # x -> conv1's input
            h_ = norm_act(self.norm1, x_, fused, fuse1, self.act)
            h_ = self._resample(h_) if resampled else h_
            if sow is not None:
                sow("a1", h_)
            return h_

        def chain2(h_, *temb_):  # conv1's output -> conv2's input
            if self.temb_dense is not None:
                h_ = h_ + self.temb_dense(self.act(temb_[0]))[:, None, None, :].to(h_.dtype)
            fuse2 = swish and int8_conv_fusion_ok(h_.shape, out_ch, impl)
            h_ = norm_act(self.norm2, h_, fused, fuse2, self.act)
            if sow is not None:
                sow("a2", h_)
            if mask is not None:
                h_ = h_ * (mask.to(h_.dtype) * (1.0 / keep))
            return h_

        temb_in = () if self.temb_dense is None else (temb,)
        if remat is None:
            h = self.conv1(chain1(x), impl)
            h = self.conv2(chain2(h, *temb_in), impl)
        else:
            p2 = [*self.norm2.parameters()] + (
                [*self.temb_dense.parameters()] if self.temb_dense is not None else [])
            h = remat_conv(self.conv1, impl, chain1, [x], [*self.norm1.parameters()])
            h = remat_conv(self.conv2, impl, chain2, [h, *temb_in], p2, keep=remat == "convs")
        if resampled:
            x = self._resample(x)
        if self.skip is not None:
            x = self._skip(x, impl, sow)
        out = x + h
        return out * rb._INV_SQRT2 if self.skip_rescale else out

    def _train_layers(self, x, temb, fused, layer, mask, keep, remat):
        """The unfused layers in training: ``layer`` 'pallas' sends the 3x3
        convs through K11's autograd.Function; any other setting, 'int8'
        included, trains them plain (JAX's ``allow_quantized=not train``).
        ``Conv.forward`` alone cannot decide that here: with 'int8' the
        K12 fusion would quantize GN's output, and under the selective
        remat the conv runs inside ``_RematConv.forward``, where autograd
        does not record. ``remat`` True recomputes the whole
        block in the backward (non-reentrant ``checkpoint``: the mask is an
        input, drawn before, so the recompute applies the same one), 'convs'
        and 'convs_lean' all but the conv outputs."""
        impl = "pallas" if fused and layer == "pallas" else "plain"
        if remat is True:
            def run(x_, temb_, mask_):
                return self._forward_layers(x_, temb_, fused, impl, mask=mask_, keep=keep)

            return checkpoint(run, x, temb, mask, use_reentrant=False)
        return self._forward_layers(x, temb, fused, impl, mask=mask, keep=keep,
                                    remat=remat or None)

    def _dropout_mask(self, shape, generator):
        """(the (B, H, W, Cout) int8 keep mask drawn from ``generator``, or
        None without dropout; the keep probability)."""
        keep = 1.0 - self.dropout
        if keep >= 1.0:
            return None, keep
        device = self.conv1.bias.device

        def bernoulli(rows, generator):
            return torch.bernoulli(torch.full(rows, keep, device=device), generator=generator)

        return draw_rows(bernoulli, shape, generator).to(torch.int8), keep

    def _forward_train(self, x, temb, fused, generator, fused_train=True, layer=None,
                       remat=False):
        if isinstance(x, (tuple, list)):
            x = torch.cat(x, -1)
        b, h, w, _ = x.shape
        if self.up:
            h, w = 2 * h, 2 * w
        elif self.down:
            h, w = h // 2, w // 2
        out_ch = self.conv1.weight.shape[-1]
        mask, keep = self._dropout_mask((b, h, w, out_ch), generator)
        resampled = self.up or self.down
        if (not resampled and fused and fused_train and self._kernels_ok(temb)
                and rb.train_supported(x.shape, out_ch)):
            temb_proj = rb.temb_projection(temb, self.temb_dense.weight, self.temb_dense.bias)
            w_skip, b_skip = self._skip_params()
            return rb.fused_resblock_train(
                x, temb_proj, self.norm1.weight, self.norm1.bias, self.conv1.weight,
                self.conv1.bias, self.norm2.weight, self.norm2.bias, self.conv2.weight,
                self.conv2.bias, w_skip, b_skip, mask, keep_prob=keep,
                num_groups1=self.norm1.num_groups, num_groups2=self.norm2.num_groups,
                eps=self.norm2.eps, skip_rescale=self.skip_rescale)
        # the unfused layers (gddim_tpu/models/blocks.py:545-584): K1 for GN1
        # and GN2 with fused, the resample in a transition, K11 with 'pallas'
        return self._train_layers(x, temb, fused, layer, mask, keep, remat)


class ResnetBlockDDPMpp(ResnetBlockBigGANpp):
    """DDPM residual block (reference layerspp.py:146-177,
    gddim_tpu/models/blocks.py:219-309): no resampling; where the width
    changes the skip is a NIN (``NIN_0``) or, with ``conv_shortcut``, a 3x3
    conv (``Conv_2``); the up path's pair is concatenated first (this block
    has no pair kernel). Inference takes K2 (its int8 mode with
    'fused_int8') with the NIN as the 1x1 skip where ``stride1_supported``
    takes the block, as the JAX package runs ``fused_resblock``; a 3x3
    conv shortcut keeps the unfused layers. Training runs the unfused
    layers (K1 for the GroupNorms with fused): the JAX block has no
    training kernel."""

    def __init__(self, cin: int, out_ch: int | None, temb_dim: int | None,
                 conv_shortcut: bool = False, skip_rescale: bool = False,
                 init_scale: float = 0.0, dropout: float = 0.1, generator=None, act=F.silu):
        self.conv_shortcut = conv_shortcut
        super().__init__(cin, out_ch, temb_dim, skip_rescale=skip_rescale,
                         init_scale=init_scale, dropout=dropout, generator=generator, act=act)
        self.subscopes = {"GroupNorm_0": "norm1", "Conv_0": "conv1", "Dense_0": "temb_dense",
                          "GroupNorm_1": "norm2", "Conv_1": "conv2",
                          "Conv_2" if conv_shortcut else "NIN_0": "skip"}

    def _make_skip(self, cin, out_ch, generator):
        if cin == out_ch:
            return None
        if self.conv_shortcut:
            return Conv(cin, out_ch, 3, generator=generator)
        return NIN(cin, out_ch, generator=generator)

    def _skip_params(self):
        if self.skip is None:
            return None, None
        return self.skip.weight, self.skip.bias

    def _kernels_ok(self, temb) -> bool:
        return super()._kernels_ok(temb) and not (self.skip is not None and self.conv_shortcut)

    def _skip(self, x, impl: str, sow=None):
        if self.conv_shortcut:  # a 3x3 conv: its input is no int8 site
            return self.skip(x, impl)
        return super()._skip(x, impl, sow)

    def forward(self, x, temb, fused: bool = False, train: bool = False,
                generator: torch.Generator | None = None, int8: bool = False,
                qscales: dict | None = None, sow=None, layer: str | None = None,
                transition: str = "tail", temb_row=None, fused_train: bool = True,
                remat: bool | str = False):
        """As ``ResnetBlockBigGANpp.forward``; ``transition`` and
        ``fused_train`` have no block to act on."""
        if isinstance(x, (tuple, list)):
            x = torch.cat(x, -1)
        if train:
            b, h, w, _ = x.shape
            mask, keep = self._dropout_mask((b, h, w, self.conv1.weight.shape[-1]), generator)
            return self._train_layers(x, temb, fused, layer, mask, keep, remat)
        return super().forward(x, temb, fused, False, generator, int8, qscales, sow, layer,
                               transition, temb_row, fused_train)


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
                fused_attn: bool = False, attention_impl: str = "auto"):
        """int8 (with fused): K5's int8 mode, static scales from this block's
        ``qscales`` amaxes. layer (with fused): the layer-wise path, K1, the
        NIN projections and K8, as in training. fused_attn (with train and
        fused): K10 where the kernels take the shape. With fused, K5 runs
        where ``attn_ops.supported`` takes the block, the composition
        elsewhere, its attention core K8 where K8 takes the shape (as the JAX
        block's fallback takes its kernel, gddim_tpu/models/blocks.py:141:
        S = 4096 at 64x64 runs K8's online-softmax kernel). sow: calibration
        (the plain composition). attention_impl (``model.attention_impl``):
        the attention core wherever the block runs its layers, not K5 or K10
        (``self_attention_2d``: 'auto' is K8 on the kernel paths where it
        takes the shape, the plain version on the plain one)."""
        kw = dict(num_groups=num_groups_for(x.shape[-1]), eps=self.norm.eps,
                  skip_rescale=self.skip_rescale)
        if train and fused and fused_attn and attn_ops.supported(x.shape):
            return attn_ops.fused_attnblock_train(
                x, self.norm.weight, self.norm.bias, self.q.weight, self.q.bias, self.k.weight,
                self.k.bias, self.v.weight, self.v.bias, self.out.weight, self.out.bias, **kw)
        if train or (fused and layer is not None):
            h = self.norm(x, act=False, fused=fused)
            h = self_attention_2d(self.q(h), self.k(h), self.v(h), impl=attention_impl,
                                  fused=fused)
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
        if not kernel:  # the composition, its attention core K8 where it takes it
            kw["attention_impl"] = resolve_impl(attention_impl, fused, x.shape[1] * x.shape[2],
                                                x.shape[3])
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


class Upsample(nn.Module):
    """Factor-2 upsample (reference layerspp.py:86-112): nearest (``fir``
    False) then, ``with_conv``, a 3x3 conv (``Conv_0``); or FIR, with the
    conv fused (``Conv2d_0``, ``upsample_conv_2d``)."""

    def __init__(self, cin: int, out_ch: int | None = None, with_conv: bool = False,
                 fir: bool = False, fir_kernel=(1, 3, 3, 1), generator=None):
        super().__init__()
        out_ch = out_ch or cin
        self.fir, self.fir_kernel = fir, tuple(fir_kernel)
        self.conv = None
        self.subscopes = {}
        if with_conv:
            self.conv = (resample.Conv2d(cin, out_ch, 3, fir_kernel, generator, up=True) if fir
                         else Conv(cin, out_ch, 3, generator=generator))
            self.subscopes = {"Conv2d_0" if fir else "Conv_0": "conv"}

    def forward(self, x, impl: str = "plain"):
        """impl: the nearest path's conv through K11 ('pallas', 'int8') where
        it takes the shape (in training 'pallas' only: ``Conv``)."""
        if self.fir:
            return resample.upsample_2d(x, self.fir_kernel) if self.conv is None else self.conv(x)
        y = resample.naive_upsample_2d(x)
        return y if self.conv is None else self.conv(y, impl)


class Downsample(nn.Module):
    """Factor-2 downsample (reference layerspp.py:115-143): without ``fir``,
    a stride-2 3x3 conv (``Conv_0``, XLA's SAME padding) or the SAME 2x2
    average pool; with it, the FIR-composed strided conv (``Conv2d_0``)
    or the FIR downsample."""

    def __init__(self, cin: int, out_ch: int | None = None, fir_kernel=(1, 3, 3, 1),
                 generator=None, with_conv: bool = True, fir: bool = True):
        super().__init__()
        out_ch = out_ch or cin
        self.fir, self.fir_kernel = fir, tuple(fir_kernel)
        self.conv = None
        self.subscopes = {}
        if with_conv:
            self.conv = (resample.Conv2d(cin, out_ch, 3, fir_kernel, generator) if fir
                         else Conv(cin, out_ch, 3, generator=generator, stride=2))
            self.subscopes = {"Conv2d_0" if fir else "Conv_0": "conv"}

    def forward(self, x):
        if self.conv is not None:
            return self.conv(x)
        return (resample.downsample_2d(x, self.fir_kernel) if self.fir
                else resample.avg_pool_same(x))
