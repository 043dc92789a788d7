"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` file to an object, one process per
source, all started together, and links the objects into one shared library
with a plain C interface, which ``ctypes`` loads. The build happens at first use,
into ``build/gddim_torch_kernels/`` in the checkout, keyed by a hash of the
sources, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_ROOT = Path(__file__).resolve().parent
_CSRC = _ROOT / "csrc"
BUILD_DIR = _ROOT.parent / "build" / "gddim_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argtypes. The *_workspace, *_smem and *_offset
# entries return a byte count (long long); every other entry returns
# cudaError_t as int.
_SIGNATURES = {
    # gddim_resblock_workspace(B, H, W, Cin, N, splits, parts, xs): the bf16 block
    #   (and K6), parts the tile plan's tiles_h (GN2's partial rows a sample), xs
    #   the skip's channels on f32 activations (their bf16 copy), else 0
    "gddim_resblock_workspace": [_I, _I, _I, _I, _I, _I, _I, _I],
    # gddim_resblock(x0, x1, c0, c1, act_f32, temb_row, temb_ld, gn1_g, gn1_b,
    #   groups1, w1, b1, gn2_g, gn2_b, groups2, w2, b2, s0, s1, cs0, cs1, ws, bs,
    #   B, H, W, N, eps, out_scale, work, mw, box_h, box_b, tiles_h, m_tiles,
    #   splits1, kper1, splits2, kper2, gn_ctas, out, stream)
    "gddim_resblock": [
        _P, _P, _I, _I, _I, _P, _I, _P, _P,
        _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P,
        _I, _I, _I, _I, _F, _F, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
    ],
    # gddim_resblock_transition_workspace(B, H_out, W_out, C, N, splits, parts)
    "gddim_resblock_transition_workspace": [_I, _I, _I, _I, _I, _I, _I],
    # gddim_resblock_transition(x, c, act_f32, temb_row, temb_ld, gn1_g, gn1_b, groups1,
    #   w1, b1, gn2_g, gn2_b, groups2, w2, b2, ws, bs, B, H_in, W_in, up, kh0..kh3, kw0..kw3,
    #   N, eps, out_scale, work, mw, box_h, box_b, tiles_h, m_tiles, splits1, kper1, splits2,
    #   kper2, gn_ctas, out, stream)
    "gddim_resblock_transition": [
        _P, _I, _I, _P, _I, _P, _P, _I,
        _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F,
        _I, _F, _F, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
    ],
    # gddim_resblock_transition_int8_workspace(B, H_out, W_out, C, N, splits, parts)
    "gddim_resblock_transition_int8_workspace": [_I, _I, _I, _I, _I, _I, _I],
    # gddim_resblock_transition_int8_xq_offset(B, H_out, W_out, C, N, splits, parts): the
    #   static skip's q(xr) in the workspace (a byte offset)
    "gddim_resblock_transition_int8_xq_offset": [_I, _I, _I, _I, _I, _I, _I],
    # gddim_resblock_transition_int8(x, c, temb_row, temb_ld, gn1_g, gn1_b, groups1,
    #   w1q, w1s, b1, gn2_g, gn2_b, groups2, w2q, w2s, b2, ws, bs, wss, act_scales,
    #   B, H_in, W_in, up, kh0..kh3, kw0..kw3, N, eps, out_scale, work, mw, box_h, box_b,
    #   tiles_h, m_tiles, splits1, kper1, splits2, kper2, gn_ctas, out, stream); wss
    #   non-null: the static int8 skip
    "gddim_resblock_transition_int8": [
        _P, _I, _P, _I, _P, _P, _I,
        _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
        _F, _F, _F, _F, _F, _F, _F, _F, _I, _F, _F, _P, _I, _I, _I, _I, _I,
        _I, _I, _I, _I, _I, _P, _P,
    ],
    # gddim_resblock_int8_workspace(B, H, W, Cin, N, splits, parts, sx)
    "gddim_resblock_int8_workspace": [_I, _I, _I, _I, _I, _I, _I, _I],
    # gddim_resblock_int8_xq_offset(B, H, W, Cin, N, splits, parts, sx): the static
    #   skip's q(x) in the workspace (a byte offset)
    "gddim_resblock_int8_xq_offset": [_I, _I, _I, _I, _I, _I, _I, _I],
    # gddim_resblock_int8(x0, x1, c0, c1, temb_row, temb_ld, gn1_g, gn1_b,
    #   groups1, w1q, w1s, b1, gn2_g, gn2_b, groups2, w2q, w2s, b2, s0, s1, cs0, cs1, ws, bs,
    #   wss, act_scales, B, H, W, N, eps, out_scale, work, mw, box_h, box_b,
    #   tiles_h, m_tiles, splits1, kper1, splits2, kper2, gn_ctas, out, stream); wss
    #   non-null: the static int8 skip
    "gddim_resblock_int8": [
        _P, _P, _I, _I, _P, _I, _P, _P,
        _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P,
        _P, _P, _I, _I, _I, _I, _F, _F, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
    ],
    # gddim_s8_prepass(xa, xb, ca, cb, act_f32, B, HW, scale, shift, silu, qs, amax, inv_mul,
    #   out, stream)
    "gddim_s8_prepass": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P],
    # gddim_conv_s8(a8, wk, wsc, qs, B, H, W, Cin, N, taps, mw, box_h, box_b, tiles_h,
    #   m_tiles, splits, kper, work, gn_part, out, stream)
    "gddim_conv_s8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                      _P, _P],
    # gddim_bf16_prepass(xa, xb, ca, cb, act_f32, B, HW, scale, shift, silu, out, stream)
    "gddim_bf16_prepass": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P],
    # gddim_conv_bf16(a, w, B, H, W, Cin, N, taps, mw, box_h, box_b, tiles_h, m_tiles,
    #   splits, kper, work, gn_part, out, stream)
    "gddim_conv_bf16": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                        _P],
    # gddim_dgrad_bf16(g, w, B, H, W, Cin, N, taps, mw, box_h, box_b, tiles_h, m_tiles,
    #   splits, kper, work, out, stream)
    "gddim_dgrad_bf16": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # gddim_gn_stats(xa, xb, ca, cb, act_f32, B, HW, groups, gamma, beta, eps, scale, shift,
    #   mean, rstd, stream)
    "gddim_gn_stats": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _F, _P, _P, _P, _P, _P],
    # gddim_gn_apply(xa, xb, ca, cb, B, HW, groups, gamma, beta, eps, silu, int8, qs, amax,
    #   inv_mul, ctas, out, scale, shift, mean, rstd, stream)
    "gddim_gn_apply": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _F, _I, _I, _P, _P, _I, _I, _P, _P,
                       _P, _P, _P, _P],
    # gddim_gn_apply_smem(C, H, W, resample, up): shared memory bytes of one
    #   gn_apply_kernel CTA (no stream; -1 for a width it does not take)
    "gddim_gn_apply_smem": [_I, _I, _I, _I, _I],
    # gddim_gn_resample(x, C, B, H_in, W_in, up, kh0..kh3, kw0..kw3, groups, gamma, beta, eps,
    #   out_type, qs, amax, ctas, h, xr, scale, shift, stream)
    "gddim_gn_resample": [_P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _I, _P, _P, _F,
                          _I, _P, _P, _I, _P, _P, _P, _P, _P],
    # gddim_block_launches(out, reset): launches of the kernels counted in C (no stream)
    "gddim_block_launches": [_P, _I],
    # gddim_resblock_train(x, c, temb_row, gn1_g, gn1_b, groups1, w1, b1, gn2_g, gn2_b,
    #   groups2, w2, b2, ws, bs, mask, inv_keep, B, H, W, N, eps, out_scale, work,
    #   mw, box_h, box_b, tiles_h, m_tiles, splits1, kper1, splits2, kper2, out, stream);
    #   scratch: gddim_resblock_workspace with xs = c where it has a 1x1 skip
    "gddim_resblock_train": [
        _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _F,
        _I, _I, _I, _I, _F, _F, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
    ],
    # gddim_resblock_bwd_workspace(B, H, W, Cin, N, groups1, groups2, skip, plan): plan the
    #   host address of train_bwd_plan's ints
    "gddim_resblock_bwd_workspace": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    # gddim_resblock_bwd(x, temb_row, gn1_g, gn1_b, groups1, w1, b1, gn2_g, gn2_b, groups2,
    #   w2, ws, mask, inv_keep, g, B, H, W, Cin, N, eps, out_scale, plan, work,
    #   dx, dtemb, dgn1s, dgn1b, dw1, db1, dgn2s, dgn2b, dw2, db2, dws, dbs, stream)
    "gddim_resblock_bwd": [
        _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _F, _P,
        _I, _I, _I, _I, _I, _F, _F, _P, _P,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    ],
    # gddim_gn_bwd(dpre, mask, inv_keep, v, sc, sh, mean, rstd, gamma, add, add_scale, extra,
    #   out, out_bf16, part_s, part_b, part_extra, chan_out, B, HW, C, groups, ctas, share,
    #   held, smem, stream)
    "gddim_gn_bwd": [_P, _P, _F, _P, _P, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # gddim_gn2_prepass(h1, part, parts, groups, gamma, beta, eps, mode, qs, mask, inv_keep,
    #   B, HW, N, fold_only, out, scale, shift, mean, rstd, stream)
    "gddim_gn2_prepass": [_P, _P, _I, _I, _P, _P, _F, _I, _P, _P, _F, _I, _I, _I, _I, _P, _P, _P,
                          _P, _P, _P],
    # gddim_wgrad(a, g, B, H, W, C, N, taps, mw, box_h, box_b, splits, per, work, dw, stream)
    "gddim_wgrad": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # gddim_flash_attention(q, k, v, o, B, S, C, qt, bf16, scale, stream)
    "gddim_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # gddim_flash_online(q, k, v, o, B, S, C, qt, bf16, scale, work, stream): K8 for
    #   S > 1024, qt the queries a CTA (ops/attention.py:flash_plan), work the f32 form's
    #   scratch (ops/attention.py:online_workspace; NULL for bf16)
    "gddim_flash_online": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P],
    # gddim_flash_online_split(q, k, v, work, B, S, C, stream): the f32 form's pre-pass alone
    "gddim_flash_online_split": [_P, _P, _P, _P, _I, _I, _I, _P],
    # gddim_attention_core(qkv, B, S, C, stages, mode, qs, amax, out, stream)
    "gddim_attention_core": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # gddim_attnblock(x, act_f32, gn_g, gn_b, groups, wqkv, bqkv, wo, bo, B, H, W, C, eps,
    #   out_scale, work, work_bytes, mw1, box_h1, box_b1, tiles_h1, m_tiles1, splits1, kper1,
    #   mw2, box_h2, box_b2, tiles_h2, m_tiles2, splits2, kper2, stages, gn_ctas, out, stream)
    "gddim_attnblock": [
        _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _L,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
    ],
    # gddim_attnblock_int8(x, gn_g, gn_b, groups, wqkv_k, wqkv_s, bqkv, wo_k, wo_s, bo,
    #   act_scales, B, H, W, C, eps, out_scale, work, work_bytes, mw1 .. kper1, mw2 .. kper2,
    #   stages, gn_ctas, out, stream)
    "gddim_attnblock_int8": [
        _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _L,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
    ],
    # gddim_conv3x3(x, w, B, H, W, Cin, N, mw, box_h, box_b, tiles_h, m_tiles, splits, kper,
    #   out_f32, work, out, stream)
    "gddim_conv3x3": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # gddim_conv3x3_int8(x8, wk, w_scale, act_scale, bias, B, H, W, Cin, N, mw, box_h, box_b,
    #   tiles_h, m_tiles, splits, kper, out_f32, work, out, stream): K11 int8 on the int8
    #   block GEMM
    "gddim_conv3x3_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P, _P, _P],
    # gddim_gn_silu_quant(x, act_f32, B, HW, C, groups, gamma, beta, eps, silu, ctas, work, q,
    #   qs, stream): K12
    "gddim_gn_silu_quant": [_P, _I, _I, _I, _I, _I, _P, _P, _F, _I, _I, _P, _P, _P, _P],
    # gddim_gn_silu(x, dtype, B, HW, C, groups, gamma, beta, eps, silu, ctas, hold, out,
    #   stream): K1, dtype 0 bf16, 1 f16, 2 f32
    "gddim_gn_silu": [_P, _I, _I, _I, _I, _I, _P, _P, _F, _I, _I, _I, _P, _P],
    # gddim_gn_silu_smem(C, bytes, HW, ctas, hold): shared memory bytes of one
    #   gn_silu_kernel CTA (no stream)
    "gddim_gn_silu_smem": [_I, _I, _I, _I, _I],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the last build in this process, or 0.0 on a cache hit


def _source_hash(sources) -> str:
    h = hashlib.sha1()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run(procs) -> None:
    """Wait for every (label, Popen); raise with the output of the first failure."""
    failed = None
    for label, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"{label} failed ({proc.returncode}):\n{out}\n{err}"
    if failed:
        raise RuntimeError(failed)


def _compile(sources, so: Path) -> None:
    """One nvcc per source, all at once, then one link into ``so``."""
    tag = f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{so.stem}.{src.stem}.{tag}.o") for src in sources]
    nvcc = _nvcc()
    procs = [
        (f"nvcc {src.name}", subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for src, obj in zip(sources, objs)
    ]
    try:
        _run(procs)
        tmp = so.with_suffix(f".{tag}.so")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        _run([("nvcc link", subprocess.Popen(link, stdout=subprocess.PIPE,
                                              stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(_CSRC.glob("*.cu"))
        headers = sorted(_CSRC.glob("*.cuh"))
        so = BUILD_DIR / f"libgddim_torch_{_source_hash(sources + headers)}.so"
        t0 = time.perf_counter()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _compile(sources, so)
        build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = (ctypes.c_longlong if name.endswith(("_workspace", "_smem", "_offset"))
                          else ctypes.c_int)
        _lib = lib
        return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call a C entry point on the current stream of ``device``; raise on a
    CUDA error."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def workspace_bytes(name: str, *args) -> int:
    """Scratch bytes a block entry needs (``<name>_workspace``)."""
    return int(getattr(library(), f"{name}_workspace")(*args))


def xq_offset(name: str, *args) -> int:
    """The byte offset of the static skip's int8 input q(x) in an int8 block
    entry's workspace (``<name>_xq_offset``)."""
    off = int(getattr(library(), f"{name}_xq_offset")(*args))
    if off < 0:
        raise RuntimeError(f"{name}_xq_offset: no static skip in {args}")
    return off


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for a missing operand."""
    return None if t is None else t.data_ptr()
