#!/usr/bin/env python3
"""Drive the torch port of simpletuner-tpu once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero with no result line):

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compile every hand-written kernel of the render path from csrc/;
3. kernels: the forward kernel against its plain PyTorch version on the
   card, bf16, at the Flux shape masked and unmasked, Flux padding at a ragged
   S = 4173, a ragged S = 1000, packed samples (mixed tiles), narrow heads
   (D = 64, 32) and a (B, S, H, D) strided view; rows that see no key exactly
   0 with lse -1e30; kernel, plain and SDPA times (CUDA events, after warm-up;
   SDPA with the T5 mask as a boolean attn_mask is the masked yardstick), the
   bound, and the skip/full/mixed tile counts of the Flux masked call;
4. render: the port's inference runtime renders one 1024x1024 image with
   full-width Flux.1-dev (19 double + 38 single blocks, hidden 3072, 24x128
   heads, guidance embedding; depth not cut) and the Flux VAE decoder, from
   seeded random weights and seeded prompt embeds in the text-embed cache,
   4 Euler steps; counts the flash-kernel launches of that run;
5. parity: one full-width denoise call through the kernel against the same
   call through mha_reference, on the same (AdaLN-perturbed) weights;
6. profile: one full-width denoise call under torch.profiler, device time by
   kernel bucket and the device's idle share of the call;
7. backward kernels: dq, dk and dv from the dq/dkv kernels against the plain
   backward on the card, bf16, at the cases of phase 3 and a cross-attention
   case (200 queries against 512 keys with two 128-key blocks of pad: the dq
   kernel's skip tiles); dk and dv of pad keys and dq of pad queries exactly
   0; gradients of strided inputs in their layout; dq bitwise equal over two
   launches at the Flux masked shape; kernel, plain and SDPA-backward times,
   the bounds and each kernel's share of its bound;
8. train step: the flagship LoRA step (simpletuner_tpu_torch.bench.flagship:
   full-width, full-depth Flux.1-dev, rank-16 LoRA, AdamW, 1024 px, T5 padding
   masked): first the JAX flagship's configuration, an int8 frozen base with
   quantized_matmul=full and remat policy attn, then an int4 base (attn), then
   a bf16 base with remat attn and full; the eager step, 2 warm-up and 2 timed
   steps each (phase 12 times the int8 step over 20);
   counts the kernel launches of each run; the first run's device time by
   kernel bucket from one more step under torch.profiler;
9. gradient parity: one step's LoRA gradients through the kernels against the
   same step through mha_reference under autograd, full width, depth cut to
   2 double + 4 single blocks;
10. int8 products: torch._int_mm at the Flux linears' (k, n) with m = 4608
   rows and with one (padded) row, in the forward's and the dx backward's
   operand layouts, each int32 result equal to the float64 product of the same
   int8 operands; int8_dynamic_dot's output and dx against a plain version
   that contracts in float64; times beside bf16 products of the same shapes;
11. gradient parity on an int8 base (quantized_matmul=full): phase 9 again;
12. graphed train step: the int8 flagship of phase 8 (attn) through
   jit_train_step, the step captured as one CUDA graph: two runs of 5 eager
   steps from one snapshot of the adapters, the optimizer state and the
   generator (bitwise equal, or the difference printed and the graph held to
   it), then 5 graph replays from the same snapshot, whose losses, grad norms
   and LoRA tensors must equal the eager ones bitwise; then 20 eager steps and
   20 replays timed, one of each profiled (device time by bucket, idle share);
   the launches of the profiled replay as the profiler recorded them on the
   card (76 / 57 / 57 flash, 1,069 torch._int_mm), which must equal what the
   capture recorded (a replay runs no wrapper, so the counters count the
   warm-up steps and the capture, and not the replays);
13. full-depth gradient parity: phase 9 at 19 + 38 blocks on a bf16 base.

Phases 3 and 7 also run head dims 72, 96 and 112 (pixart, lumina2, sana),
which the wrappers zero-pad to 128, masked and unmasked.  Then a JSON line
with the kernels (launches: the profiler's count in phase 12's profiled
replay), and last the device line.  Needs one CUDA
device; builds into build/kernels/ inside the checkout.  Phase 2 lists ptxas's
register, spill and warning lines per kernel (a C7514 warning means ptxas
serialized a wgmma pipeline).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

STEPS = 4
RESOLUTION = 1024
TXT_LEN, TXT_VALID = 512, 77  # T5-XXL max length; a short prompt's real tokens
# kernel vs plain, bf16 (reasons in tests/test_torch_kernels_cuda.py): out
# within two bf16 ulps of the largest reference output and 8e-3 in relative
# L2 (its P-in-bf16 rounding gives about 2.5e-3); lse is f32 on both sides
OUT_REL_MAX, OUT_REL_L2, LSE_ATOL = 2.0 ** -6, 8e-3, 1e-3
# full-width velocity, kernel vs mha_reference path: every attention output
# differs by about one bf16 rounding (P in bf16), and 57 blocks re-round the
# residual stream to bf16 after each op, so the two paths agree to a few
# bf16 ulps in relative L2 (bf16 ulp = 2^-8 = 3.9e-3)
PARITY_REL_L2 = 5e-2
# backward kernels vs mha_backward_reference on the same out/lse/dO (reasons in
# tests/test_torch_kernels_cuda.py): each gradient within two bf16 ulps of its
# largest plain value and 1e-2 in relative L2
GRAD_REL_MAX, GRAD_REL_L2 = 2.0 ** -6, 1e-2
# one train step's LoRA gradients, kernel path vs mha_reference path, 6 blocks
# (phases 9, 11) or the full 57 (phase 13) at full width: each attention
# output and gradient differs by about one bf16 rounding (P and dS in bf16),
# compounded through the blocks' backward
TRAIN_GRAD_REL_L2 = 5e-2
PARITY_DOUBLE, PARITY_SINGLE = 2, 4
# phase 12: steps held bitwise against the eager step, and steps timed
GRAPH_CHECK_STEPS, GRAPH_TIMED_STEPS = 5, 20
# H100 SXM: dense bf16 tensor-core peak and device-memory rate (bounds only)
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
# phase 10: the Flux linears' (in, out): attention q/k/v and proj, single-block
# linear1 (q, k, v, mlp) and linear2, the MLP in and out, double-block AdaLN
INT8_SHAPES = ((3072, 3072), (3072, 21504), (15360, 3072), (3072, 12288), (12288, 3072), (3072, 18432))
INT8_ROWS = 4608  # 4096 image + 512 text tokens
# int8_dynamic_dot against a plain version written out here (f32 per-row
# quantize, float64 contraction and scaling, one rounding to bf16): the codes
# and the products are exact on both sides and the scaled values differ by f32
# roundings, so every element is within one bf16 ulp (at most 2^-7 of its value)
DOT_REL = 2.0 ** -7


def phase(name: str, **fields) -> None:
    print(f"phase {name}: " + json.dumps(fields, sort_keys=True), flush=True)


def nvidia_smi() -> str:
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return result.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def check_png(path: str, width: int, height: int) -> None:
    """Parse the PNG by hand: signature, IHDR, and IDAT inflating to the pixel rows."""
    with open(path, "rb") as handle:
        data = handle.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise RuntimeError(f"{path} is not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if zlib.crc32(tag + body) != struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]:
            raise RuntimeError(f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    if header is None or header[:4] != (width, height, 8, 2):
        raise RuntimeError(f"{path}: IHDR {header} is not {width}x{height} 8-bit RGB")
    if len(zlib.decompress(idat)) != height * (1 + 3 * width):
        raise RuntimeError(f"{path}: pixel data has the wrong size")


def _qkv(seed, b, h, s, d, n=3):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, s, d), dtype=np.float32)).to("cuda", torch.bfloat16)
            for _ in range(n)]


def _segments(batch, length, txt_valid=None, packed_at=None, pad_from=None):
    """int32 segment ids on the card: Flux T5 padding (text first, tokens
    txt_valid..TXT_LEN pad), or packed samples (1 from packed_at, pad from
    pad_from in the last batch row)."""
    import torch

    from simpletuner_tpu_torch.ops import SEGMENT_PAD_ID

    seg = torch.zeros((batch, length), dtype=torch.int32, device="cuda")
    if txt_valid is not None:
        seg[:, txt_valid:TXT_LEN] = SEGMENT_PAD_ID
    if packed_at is not None:
        seg[:, packed_at:] = 1
        seg[-1, pad_from:] = SEGMENT_PAD_ID
    return seg


# (name, (batch, heads, seq, head_dim), segment ids, (B, S, H, D) strided view):
# the Flux shape masked and not, Flux padding at a ragged S, a ragged S
# without ids, packed samples with mixed tiles, narrow heads through the
# dispatcher's strided layout
FLUX_S = TXT_LEN + (RESOLUTION // 16) ** 2
KERNEL_CASES = (
    ("flux_unmasked", (1, 24, FLUX_S, 128), None, False),
    ("flux_t5_padded", (1, 24, FLUX_S, 128), {"txt_valid": TXT_VALID}, False),
    ("flux_t5_padded_s4173", (1, 24, 4173, 128), {"txt_valid": TXT_VALID}, False),
    ("ragged_s1000_d64", (1, 8, 1000, 64), None, False),
    ("segments_s300_d32", (2, 4, 300, 32), {"packed_at": 130, "pad_from": 280}, False),
    ("strided_bshd_s640_d64", (1, 8, 640, 64), {"txt_valid": 40}, True),
    # head dims the wrappers zero-pad to 128 (pixart 72, lumina2 96, sana 112)
    ("ragged_s1000_d72", (1, 8, 1000, 72), None, False),
    ("t5_padded_s1000_d72", (1, 8, 1000, 72), {"txt_valid": TXT_VALID}, False),
    ("s640_d96", (1, 8, 640, 96), None, False),
    ("strided_bshd_t5_padded_s640_d96", (1, 8, 640, 96), {"txt_valid": 40}, True),
    ("s384_d112", (2, 4, 384, 112), None, False),
    ("segments_s300_d112", (2, 4, 300, 112), {"packed_at": 130, "pad_from": 280}, False),
)
# head dims timed at the Flux sequence (T5 padding masked) beside 128
PADDED_HEAD_DIMS = (72, 96, 112)


def _case_inputs(seed, shape, ids, strided, n):
    tensors = _qkv(seed, *shape, n=n)
    if strided:  # (B, S, H, D) memory, viewed as (B, H, S, D)
        tensors = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in tensors]
    seg = None if ids is None else _segments(shape[0], shape[2], **ids)
    return tensors, seg


def _sdpa_backend(fn):
    """(name, ms) of the fastest SDPA backend that runs ``fn`` (of flash,
    cuDNN, memory-efficient, math), each timed with CUDA events."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                fn()
                times[backend.name.lower()] = cuda_ms(fn, 20)
        except RuntimeError:
            continue
    if not times:
        raise RuntimeError("no SDPA backend ran")
    return min(times.items(), key=lambda item: item[1])


def _attention_bound_ms(products, pairs, heads, dim, nbytes):
    """The larger of the tensor-core time of ``products`` S x S x D products
    over ``pairs`` attended (query, key) pairs per head (989 TFLOP/s dense
    bf16) and the time to move ``nbytes`` once (3.35 TB/s); and which bounds."""
    flop_ms = products * 2.0 * heads * pairs * dim / PEAK_BF16_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(flop_ms, byte_ms), "operations" if flop_ms >= byte_ms else "bytes"


def kernel_cases():
    """Phase 3: the forward kernel against its plain version; returns the
    kernels-line entry of flash_fwd (without launches)."""
    import torch
    import torch.nn.functional as F

    from simpletuner_tpu_torch.ops import SEGMENT_PAD_ID, flash_attention, mha_reference_lse
    from simpletuner_tpu_torch.ops.flash_attention import FWD_BLOCKS, TILE_FULL, TILE_MIXED, TILE_SKIP, tile_schedule

    worst = 0.0
    errors = {}
    for seed, (name, shape, ids, strided) in enumerate(KERNEL_CASES):
        (q, k, v), seg = _case_inputs(seed, shape, ids, strided, 3)
        out, lse = flash_attention(q, k, v, seg, seg, return_lse=True)
        ref, ref_lse = mha_reference_lse(q, k, v, seg, seg)
        torch.cuda.synchronize()
        out_err = (out.float() - ref.float()).abs().max().item()
        out_bound = OUT_REL_MAX * ref.float().abs().max().item()
        out_rel_l2 = rel_l2(out, ref)
        lse_err = (lse - ref_lse).abs().max().item()
        if not (torch.isfinite(out.float()).all() and out_err <= out_bound and out_rel_l2 <= OUT_REL_L2
                and lse_err <= LSE_ATOL):
            raise RuntimeError(f"kernel case {name}: out err {out_err} (<= {out_bound}), out rel L2 "
                               f"{out_rel_l2} (<= {OUT_REL_L2}), lse err {lse_err} (<= {LSE_ATOL})")
        errors[name] = {"out": out_err, "out_bound": out_bound, "out_rel_l2": out_rel_l2, "lse": lse_err}
        if seg is not None:
            dead = seg == SEGMENT_PAD_ID  # rows that see no key: exactly 0 and lse -1e30
            rows, dead_lse = out.permute(0, 2, 1, 3)[dead], lse.permute(0, 2, 1)[dead]
            if rows.numel() and not ((rows == 0).all() and (dead_lse == -1e30).all()):
                raise RuntimeError(f"kernel case {name}: fully masked rows are not exactly 0 with lse -1e30")
            errors[name]["masked_rows"] = int(rows.shape[0])
        worst = max(worst, out_err)

    q, k, v = _qkv(9, 1, 24, FLUX_S, 128)
    flux_seg = _segments(1, FLUX_S, txt_valid=TXT_VALID)
    classes = tile_schedule(flux_seg, flux_seg, FLUX_S, FLUX_S, *FWD_BLOCKS)
    tiles = {name: int((classes == cls).sum()) for name, cls in
             (("skip", TILE_SKIP), ("full", TILE_FULL), ("mixed", TILE_MIXED))}
    allowed = (flux_seg[0][:, None] == flux_seg[0][None, :]) & (flux_seg[0] != SEGMENT_PAD_ID)[None, :]
    sdpa_mask = allowed[None, None]
    unmasked_backend, sdpa_ms = _sdpa_backend(lambda: F.scaled_dot_product_attention(q, k, v))
    masked_backend, sdpa_masked_ms = _sdpa_backend(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask))
    with torch.no_grad():
        sdpa_out = F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)
    dead = sdpa_out[0, :, TXT_VALID:TXT_LEN].float()
    times = {
        "kernel_unmasked_ms": cuda_ms(lambda: flash_attention(q, k, v), 20),
        "kernel_masked_ms": cuda_ms(lambda: flash_attention(q, k, v, flux_seg, flux_seg), 20),
        "plain_unmasked_ms": cuda_ms(lambda: mha_reference_lse(q, k, v), 5),
        "plain_masked_ms": cuda_ms(lambda: mha_reference_lse(q, k, v, flux_seg, flux_seg), 5),
        "sdpa_unmasked_ms": sdpa_ms, "sdpa_unmasked_backend": unmasked_backend,
        "sdpa_masked_ms": sdpa_masked_ms, "sdpa_masked_backend": masked_backend,
        # SDPA gives rows that see no key the mean of V (or NaN), not 0
        "sdpa_masked_rows": {"nan": int(dead.isnan().sum()), "max_abs": float(dead.nan_to_num().abs().max())},
    }
    for dim in PADDED_HEAD_DIMS:
        qd, kd, vd = _qkv(10 + dim, 1, 24, FLUX_S, dim)
        times[f"kernel_masked_d{dim}_ms"] = cuda_ms(lambda: flash_attention(qd, kd, vd, flux_seg, flux_seg), 20)
    pairs = int(allowed.sum())
    nbytes = 4 * 24 * FLUX_S * 128 * 2 + 24 * FLUX_S * 4 + 2 * FLUX_S * 4  # q, k, v, out; lse; ids
    bound_ms, bound_by = _attention_bound_ms(2, pairs, 24, 128, nbytes)
    times["bound_unmasked_ms"] = _attention_bound_ms(2, FLUX_S ** 2, 24, 128, nbytes - 2 * FLUX_S * 4)[0]
    times["bound_masked_ms"] = bound_ms
    times["kernel_unmasked_tflops"] = 4 * 24 * FLUX_S * FLUX_S * 128 / times["kernel_unmasked_ms"] / 1e9
    phase("3 kernels", shape=[1, 24, FLUX_S, 128], tol={"out_rel_max": OUT_REL_MAX, "out_rel_l2": OUT_REL_L2,
          "lse": LSE_ATOL}, errors=errors, flux_masked_tiles=tiles, attended_pairs=pairs, **times)
    return {"max_abs_err": worst, "ms": times["kernel_masked_ms"], "plain_ms": times["plain_masked_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": sdpa_masked_ms,
            "library_call": f"scaled_dot_product_attention, boolean attn_mask ({masked_backend})"}


def backward_cases():
    """Phase 7: the dq/dkv kernels against the plain backward; returns the
    kernels-line entries of flash_bwd_dq and flash_bwd_dkv (without launches)."""
    import torch
    import torch.nn.functional as F

    from simpletuner_tpu_torch.ops import (
        SEGMENT_PAD_ID, flash_attention, flash_backward, flash_bwd_dkv_kernel, flash_bwd_dq_kernel,
        mha_backward_reference,
    )

    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    errors = {}

    def check(name, q, k, v, do, q_seg, kv_seg, strided):
        scale = q.shape[-1] ** -0.5
        out, lse = flash_attention(q, k, v, q_seg, kv_seg, return_lse=True)
        grads = flash_backward(q, k, v, q_seg, kv_seg, out, lse, do, scale)
        refs = mha_backward_reference(q, k, v, q_seg, kv_seg, out, lse, do, scale)
        torch.cuda.synchronize()
        errors[name] = {}
        sides = zip(("dq", "dk", "dv"), grads, refs, (q_seg, kv_seg, kv_seg), (q, k, v))
        for grad_name, grad, ref, ids, like in sides:
            g, r = grad.float(), ref.float()
            err, bound, l2 = (g - r).abs().max().item(), GRAD_REL_MAX * r.abs().max().item(), rel_l2(g, r)
            if not (torch.isfinite(g).all() and r.norm() > 0 and err <= bound and l2 <= GRAD_REL_L2):
                raise RuntimeError(f"backward case {name} {grad_name}: err {err} (<= {bound}), rel L2 {l2} "
                                   f"(<= {GRAD_REL_L2})")
            # pad queries see no key and pad keys are seen by no query: exact zeros
            if ids is not None and not (grad.permute(0, 2, 1, 3)[ids == SEGMENT_PAD_ID] == 0).all():
                raise RuntimeError(f"backward case {name}: {grad_name} of padded tokens is not exactly 0")
            if strided and grad.stride() != like.stride():
                raise RuntimeError(f"backward case {name}: {grad_name} not in its input's layout")
            errors[name][grad_name] = {"err": err, "bound": bound, "rel_l2": l2}
            kernel = "flash_bwd_dq" if grad_name == "dq" else "flash_bwd_dkv"
            worst[kernel] = max(worst[kernel], err)

    for seed, (name, shape, ids, strided) in enumerate(KERNEL_CASES):
        (q, k, v, do), seg = _case_inputs(100 + seed, shape, ids, strided, 4)
        check(name, q, k, v, do, seg, seg, strided)
    # cross attention: queries of one segment against keys whose second and
    # fourth 128-key blocks are pad, so the dq kernel skips whole key tiles
    q, do = _qkv(120, 2, 3, 200, 64, n=2)
    k, v = _qkv(121, 2, 3, 512, 64, n=2)
    q_seg = torch.zeros((2, 200), dtype=torch.int32, device="cuda")
    kv_seg = torch.zeros((2, 512), dtype=torch.int32, device="cuda")
    kv_seg[:, 128:256] = SEGMENT_PAD_ID
    kv_seg[:, 384:] = SEGMENT_PAD_ID
    check("cross_q200_k512_pad_key_tiles_d64", q, k, v, do, q_seg, kv_seg, False)

    times = {}
    flux_seg = _segments(1, FLUX_S, txt_valid=TXT_VALID)
    allowed = (flux_seg[0][:, None] == flux_seg[0][None, :]) & (flux_seg[0] != SEGMENT_PAD_ID)[None, :]
    pairs = {"unmasked": FLUX_S ** 2, "masked": int(allowed.sum())}
    act = 24 * FLUX_S * 128 * 2
    # dq reads q, k, v, dO, lse, delta and writes dq; dkv the same inputs, writes dk and dv
    bounds = {(kernel, mode): _attention_bound_ms(products, pairs[mode], 24, 128, nbytes)
              for kernel, products, nbytes in (("dq", 3, 5 * act + 2 * 24 * FLUX_S * 4),
                                               ("dkv", 4, 6 * act + 2 * 24 * FLUX_S * 4))
              for mode in pairs}
    for mode, seg in (("unmasked", None), ("masked", flux_seg)):
        q, k, v, do = _qkv(9, 1, 24, FLUX_S, 128, n=4)
        scale = 128 ** -0.5
        out, lse = flash_attention(q, k, v, seg, seg, return_lse=True)
        delta = (out.float() * do.float()).sum(dim=-1)

        def dq():
            return flash_bwd_dq_kernel(q, k, v, seg, seg, lse, delta, do, scale)

        times[f"dq_dkv_{mode}_ms"] = cuda_ms(lambda: flash_backward(q, k, v, seg, seg, out, lse, do, scale), 10)
        times[f"dq_{mode}_ms"] = cuda_ms(dq, 10)
        times[f"dkv_{mode}_ms"] = cuda_ms(
            lambda: flash_bwd_dkv_kernel(q, k, v, seg, seg, lse, delta, do, scale), 10)
        for kernel in ("dq", "dkv"):
            times[f"bound_{kernel}_{mode}_ms"] = bounds[(kernel, mode)][0]
            times[f"{kernel}_{mode}_share_of_bound"] = bounds[(kernel, mode)][0] / times[f"{kernel}_{mode}_ms"]
        times[f"plain_{mode}_ms"] = cuda_ms(
            lambda: mha_backward_reference(q, k, v, seg, seg, out, lse, do, scale), 3)
        if seg is not None:
            if not torch.equal(dq(), dq()):
                raise RuntimeError("flash_bwd_dq is not bitwise equal over two launches at the Flux masked shape")
            times["dq_masked_bitwise_equal_over_two_launches"] = True
        # SDPA's backward: autograd.grad of its output minus its forward
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        mask = None if seg is None else allowed[None, None]

        def forward():
            return F.scaled_dot_product_attention(*leaves, attn_mask=mask)

        def forward_backward():
            return torch.autograd.grad(forward(), leaves, do)

        backend, fwd_bwd_ms = _sdpa_backend(forward_backward)
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel([getattr(SDPBackend, backend.upper())]):
            times[f"sdpa_backward_{mode}_ms"] = fwd_bwd_ms - cuda_ms(forward, 20)
        times[f"sdpa_backward_{mode}_backend"] = backend
    for dim in PADDED_HEAD_DIMS:
        q, k, v, do = _qkv(20 + dim, 1, 24, FLUX_S, dim, n=4)
        out, lse = flash_attention(q, k, v, flux_seg, flux_seg, return_lse=True)
        times[f"dq_dkv_masked_d{dim}_ms"] = cuda_ms(
            lambda: flash_backward(q, k, v, flux_seg, flux_seg, out, lse, do, dim ** -0.5), 10)
    phase("7 backward kernels", shape=[1, 24, FLUX_S, 128], tol={"grad_rel_max": GRAD_REL_MAX,
          "grad_rel_l2": GRAD_REL_L2}, errors=errors, **times)
    library = {"library_ms": times["sdpa_backward_masked_ms"],
               "library_call": "scaled_dot_product_attention backward, dq + dk + dv together, boolean attn_mask "
                               f"({times['sdpa_backward_masked_backend']})"}
    return {
        f"flash_bwd_{kernel}": {"max_abs_err": worst[f"flash_bwd_{kernel}"], "ms": times[f"{kernel}_masked_ms"],
                                "plain_ms": times["plain_masked_ms"], "bound_ms": bounds[(kernel, "masked")][0],
                                "bound_by": bounds[(kernel, "masked")][1], **library}
        for kernel in ("dq", "dkv")
    }


@contextlib.contextmanager
def record_backward_norms(norms, calls: int):
    """Append the norms of dO and of dq/dk/dv at the first ``calls`` flash
    backward calls (the warm-up steps; the timed steps run unprobed)."""
    import torch

    flash = sys.modules["simpletuner_tpu_torch.ops.flash_attention"]
    plain = flash.flash_backward

    def recording(*args):
        grads = plain(*args)
        if len(norms) < calls:
            norms.append(torch.stack([args[7].float().norm()] + [g.float().norm() for g in grads]))
        return grads

    flash.flash_backward = recording
    try:
        yield
    finally:
        flash.flash_backward = plain


# phase 8 runs: (label, flagship keyword arguments); the first is the JAX flagship
TRAIN_RUNS = (
    ("int8 attn", dict(quant="int8", quantized_matmul="full", remat_policy="attn")),
    ("int4 attn", dict(quant="int4", quantized_matmul="full", remat_policy="attn")),
    ("bf16 attn", dict(quant="none", quantized_matmul="off", remat_policy="attn")),
    ("bf16 full", dict(quant="none", quantized_matmul="off", remat_policy="full")),
)


def train_steps(kernels) -> None:
    """Phase 8: the eager flagship LoRA step in each of TRAIN_RUNS."""
    import torch

    from simpletuner_tpu_torch.bench import flagship

    blocks = 19 + 38
    # attn saves the single blocks' flash outputs; full recomputes every block's
    expected_fwd = {"attn": blocks + 19, "full": 2 * blocks}
    counts = {}
    for label, kwargs in TRAIN_RUNS:
        policy = kwargs["remat_policy"]
        norms = []
        for kernel in kernels:
            kernel.launches = 0
        with record_backward_norms(norms, calls=2 * blocks):
            result = flagship(steps=2, warmup=2, profile=label == TRAIN_RUNS[0][0], graph=False, **kwargs)
        counts[label] = {kernel.name: kernel.launches for kernel in kernels}
        per_step = result["launches_per_step"]
        norms = torch.stack(norms).cpu()
        losses = result["losses"]
        problems = []
        if not all(map(math.isfinite, losses)) or result["skipped_nonfinite"]:
            problems.append(f"non-finite losses {losses}")
        if not result["lora_delta"] > 0:
            problems.append("the LoRA weights did not move")
        if per_step != {"flash_fwd": expected_fwd[policy], "flash_bwd_dq": blocks, "flash_bwd_dkv": blocks}:
            problems.append(f"launches per step {per_step}")
        if len(norms) != 2 * blocks or not (norms > 0).all():
            problems.append(f"zero dO/dq/dk/dv reaching the kernels: {norms.min(dim=0).values.tolist()}")
        if result["quant"] != kwargs["quant"] or result["quantized_matmul"] != kwargs["quantized_matmul"]:
            problems.append(f"the run used quant={result['quant']}, quantized_matmul={result['quantized_matmul']}")
        if (kwargs["quant"] != "none") != (result["int_mm_per_step"] > 0):
            problems.append(f"{result['int_mm_per_step']} int8 products per step")
        if problems:
            raise RuntimeError(f"train step ({label}): " + "; ".join(problems))
        result["backward_norms_min"] = dict(zip(("do", "dq", "dk", "dv"), norms.min(dim=0).values.tolist()))
        phase(f"8 train step ({label})", **result, launches_run=counts[label])


def gradient_parity(name: str, quant: str = "none", depth=(PARITY_DOUBLE, PARITY_SINGLE)) -> None:
    """Phases 9, 11 and 13: a step's LoRA gradients, kernel path against
    mha_reference path, on a bf16 base or a quantized one (int8 products),
    at ``depth`` (double, single) blocks."""
    import dataclasses

    import torch

    from simpletuner_tpu_torch.bench import flagship_batch, flagship_config, perturb_adaln
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.flux import Flux, FluxConfig
    from simpletuner_tpu_torch.models.layers import freeze_base, init_parameters, quantize_module
    from simpletuner_tpu_torch.ops import set_attention_backend

    dev = torch.device("cuda")
    start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    arch = dataclasses.replace(FluxConfig(), depth_double=depth[0], depth_single=depth[1])
    model = Flux(config_namespace(flagship_config("full", quant, "full")), arch=arch)
    gen = torch.Generator(device=dev).manual_seed(9)
    with torch.device(dev):
        module = init_parameters(model.create_module(), gen)
    perturb_adaln(module, gen)
    params = freeze_base(module)
    with torch.no_grad():
        for path, param in params.items():
            if path.endswith("lora_B"):
                param.normal_(0.0, 0.01, generator=gen)
    if model.base_precision:
        quantize_module(module, model.base_precision)
    batch = flagship_batch(arch, gen)
    batch["override_noise"] = torch.randn(batch["latents"].shape, generator=gen, device=dev)
    batch["override_sigmas"] = torch.full((1,), 0.6, device=dev)

    def grads(batch):
        loss, _ = model.loss_fn(module, gen, batch)
        return loss.detach(), torch.cat([g.flatten() for g in torch.autograd.grad(loss, list(params.values()))])

    loss_kernel, kernel = grads(batch)
    _, unmasked = grads({k: v for k, v in batch.items() if k != "t5_masks"})
    set_attention_backend("xla")
    try:
        loss_plain, plain = grads(batch)
    finally:
        set_attention_backend("auto")
    peak = torch.cuda.max_memory_allocated() / 2**30
    err, mask_effect = rel_l2(kernel, plain), rel_l2(unmasked, plain)
    if not (torch.isfinite(kernel).all() and plain.norm() > 0 and err <= TRAIN_GRAD_REL_L2
            and mask_effect > 5 * err):
        raise RuntimeError(f"{name}: rel L2 {err} (<= {TRAIN_GRAD_REL_L2}), mask effect {mask_effect}")
    phase(name, blocks=list(depth), base=model.base_precision or "bf16",
          quantized_matmul=model.quantized_matmul, lora_tensors=len(params),
          loss_kernel=float(loss_kernel), loss_plain=float(loss_plain), rel_l2=err, bound=TRAIN_GRAD_REL_L2,
          unmasked_rel_l2=mask_effect, peak_gib=peak, seconds=time.perf_counter() - start)
    del module, params
    torch.cuda.empty_cache()


def graph_step(kernels):
    """Phase 12: the int8 flagship step captured as one CUDA graph against
    the eager step (bitwise), then both timed; returns each kernel's launches
    in the profiled replay, as the profiler recorded them on the card."""
    import torch

    from simpletuner_tpu_torch.bench import build_run, flagship_config, time_steps
    from simpletuner_tpu_torch.models.flux import FluxConfig
    from simpletuner_tpu_torch.training.quantization import int8_matmul
    from simpletuner_tpu_torch.training.train_state import jit_train_step, state_tensors

    run = build_run(flagship_config("attn", "int8", "full"), FluxConfig())
    state, batch, gen = run.state, run.batch, run.generator
    with torch.no_grad():
        saved = [t.clone() for t in state_tensors(state)]
    rng = gen.get_state()

    def restore():
        with torch.no_grad():
            for tensor, value in zip(state_tensors(state), saved):
                tensor.copy_(value)
        gen.set_state(rng)

    def trajectory(step):
        current, losses, norms = state, [], []
        for _ in range(GRAPH_CHECK_STEPS):
            current, metrics = step(current, batch, gen)
            losses.append(metrics["loss"])
            norms.append(metrics["grad_norm"])
        lora = torch.cat([p.detach().flatten() for p in current.trainable.values()])
        return torch.stack(losses), torch.stack(norms), lora.clone()

    def max_diff(a, b):
        return [float((x.float() - y.float()).abs().max()) for x, y in zip(a, b)]

    first = trajectory(run.step_fn)
    restore()
    second = trajectory(run.step_fn)
    restore()
    eager_diff = max_diff(first, second)  # losses, grad norms, LoRA tensors
    eager = time_steps(run.step_fn, state, batch, gen, GRAPH_TIMED_STEPS, 0, profile=True)
    eager.pop("state")
    restore()

    counters = (*kernels, int8_matmul)
    for counter in counters:
        counter.launches = 0
    start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    graphed = jit_train_step(run.step_fn, state, batch, gen)
    torch.cuda.synchronize()
    capture_s, capture_peak = time.perf_counter() - start, torch.cuda.max_memory_allocated() / 2**30
    captured = {counter.name: count for counter, count in graphed.captured_launches.items()}
    replayed = trajectory(graphed)
    graph_diff = max_diff(replayed, first)
    timed = time_steps(graphed, state, batch, gen, GRAPH_TIMED_STEPS, 0, profile=True)
    timed.pop("state")
    # the wrappers count where they launch: the warm-up steps and the capture
    wrapper_counts = {counter.name: counter.launches for counter in counters}
    recorded = timed["profile"]["bucket_launches"]
    device = {**{kernel.name: recorded[kernel.name] for kernel in kernels}, "int_mm": recorded["int8_gemm"]}
    problems = []
    if any(d > e for d, e in zip(graph_diff, eager_diff)):
        problems.append(f"graph replays differ from the eager steps by {graph_diff} (two eager runs: {eager_diff})")
    if captured != {"flash_fwd": 19 + 38 + 19, "flash_bwd_dq": 57, "flash_bwd_dkv": 57, "int_mm": 1069}:
        problems.append(f"the capture recorded {captured}")
    if device != captured:
        problems.append(f"the profiled replay launched {device} on the card, the capture recorded {captured}")
    if not all(wrapper_counts.values()):
        problems.append(f"a wrapper counted no launch on the main path: {wrapper_counts}")
    if not torch.isfinite(replayed[0]).all():
        problems.append(f"non-finite losses {replayed[0].tolist()}")
    if problems:
        raise RuntimeError("graphed train step: " + "; ".join(problems))
    summary = lambda r: {k: r[k] for k in ("s_per_step_median", "s_per_step", "step_s", "peak_gib")}  # noqa: E731
    phase("12 graphed train step", quant=run.model.base_precision, quantized_matmul=run.model.quantized_matmul,
          remat_policy="attn", check_steps=GRAPH_CHECK_STEPS, losses=replayed[0].tolist(),
          grad_norms=replayed[1].tolist(), bitwise_equal_to_eager=graph_diff == [0.0, 0.0, 0.0],
          eager_runs_bitwise_equal=eager_diff == [0.0, 0.0, 0.0], graph_vs_eager_max_diff=graph_diff,
          eager_vs_eager_max_diff=eager_diff, capture_s=capture_s, capture_peak_gib=capture_peak,
          launches_captured=captured, launches_profiled_replay=device, wrapper_counts_warmup_and_capture=wrapper_counts,
          eager={**summary(eager), "profile": eager["profile"]}, graph={**summary(timed), "profile": timed["profile"]},
          speedup_median=eager["s_per_step_median"] / timed["s_per_step_median"])
    del graphed, run, state, saved
    torch.cuda.empty_cache()
    return device


def int8_cases() -> None:
    """Phase 10: torch._int_mm exact at the Flux shapes, int8_dynamic_dot
    against its float64-contraction plain version, and times."""
    import torch
    import torch.nn.functional as F

    from simpletuner_tpu_torch.training.quantization import (
        _dynamic_quantize, int8_dynamic_dot, int8_matmul, quantize_weight,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)

    def codes(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=gen)

    # the plain version shares nothing with the port's but the stored weight
    def plain_quantize(v):
        v = v.float()
        scales = torch.clamp_min(v.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
        return torch.round(v / scales).to(torch.int8), scales

    def plain_dot(x, w_q, w_scale):
        x_q, x_scales = plain_quantize(x)
        acc = x_q.double() @ w_q.double().t()
        return (acc * x_scales.double() * w_scale.double()).to(x.dtype)

    def plain_dx(dy, w_q, w_scale):
        dy_q, dy_scales = plain_quantize(dy.float() * w_scale.float())
        return ((dy_q.double() @ w_q.double()) * dy_scales.double()).to(dy.dtype)

    def rel_max(a, b):
        a, b = a.detach().float(), b.detach().float()
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    shapes = {}
    for k, n in INT8_SHAPES:
        a, w, dy_q = codes(INT8_ROWS, k), codes(n, k), codes(INT8_ROWS, n)  # w: the stored (out, in)
        forward = int8_matmul(a, w.t())
        exact = torch.equal(forward.double(), a.double() @ w.double().t())
        exact &= torch.equal(int8_matmul(a[:1], w.t()).double(), a[:1].double() @ w.double().t())
        exact &= torch.equal(int8_matmul(dy_q, w.t().contiguous().t()).double(), dy_q.double() @ w.double())
        exact &= torch.equal(int8_matmul(dy_q[:1], w.t().contiguous().t()).double(), dy_q[:1].double() @ w.double())
        if not exact:
            raise RuntimeError(f"int8 product at (m, k, n) = ({INT8_ROWS}, {k}, {n}) is not exact")
        del forward

        stored = quantize_weight(torch.randn(n, k, device=dev, generator=gen) * k ** -0.5, "int8")
        w_q, w_scale = stored["weight"], stored["weight_scale"]
        x = torch.randn(INT8_ROWS, k, device=dev, generator=gen).bfloat16().requires_grad_(True)
        dy = torch.randn(INT8_ROWS, n, device=dev, generator=gen).bfloat16()
        errors = {}
        for rows in (INT8_ROWS, 1):
            xr = x[:rows].detach().requires_grad_(True)
            y = int8_dynamic_dot(xr, w_q, w_scale, True)
            (dx,) = torch.autograd.grad(y, xr, dy[:rows])
            errors[rows] = {"y": rel_max(y, plain_dot(xr.detach(), w_q, w_scale)),
                            "dx": rel_max(dx, plain_dx(dy[:rows], w_q, w_scale))}
            if max(errors[rows].values()) > DOT_REL:
                raise RuntimeError(f"int8_dynamic_dot at ({rows}, {k}, {n}): {errors[rows]} (<= {DOT_REL})")

        w_bf16 = (w_q.float() * w_scale[:, None]).bfloat16()
        y = int8_dynamic_dot(x, w_q, w_scale, True)
        y_bf16 = F.linear(x, w_bf16)
        w_t = w.t()
        shapes[f"{k}x{n}"] = {
            "exact": exact, "rel_err": errors,
            "int_mm_ms": cuda_ms(lambda: int8_matmul(a, w_t), 10),
            "int_mm_dx_ms": cuda_ms(lambda: int8_matmul(dy_q, w.t().contiguous().t()), 10),
            "int_mm_dx_row_major_ms": cuda_ms(lambda: torch._int_mm(dy_q, w), 3),
            "weight_transpose_ms": cuda_ms(lambda: w.t().contiguous(), 10),
            "bf16_mm_ms": cuda_ms(lambda: F.linear(x.detach(), w_bf16), 10),
            "bf16_mm_dx_ms": cuda_ms(lambda: dy @ w_bf16, 10),
            "quantize_ms": cuda_ms(lambda: _dynamic_quantize(x.detach()), 10),
            "dot_fwd_ms": cuda_ms(lambda: int8_dynamic_dot(x.detach(), w_q, w_scale, True), 10),
            "dot_dx_ms": cuda_ms(lambda: torch.autograd.grad(y, x, dy, retain_graph=True), 10),
            "linear_fwd_ms": cuda_ms(lambda: F.linear(x.detach(), w_bf16), 10),
            "linear_dx_ms": cuda_ms(lambda: torch.autograd.grad(y_bf16, x, dy, retain_graph=True), 10),
        }
        del a, w, w_t, dy_q, x, dy, y, y_bf16, w_bf16
        torch.cuda.empty_cache()
    phase("10 int8 products", rows=INT8_ROWS, tol={"int_mm": "exact", "dot_rel": DOT_REL}, shapes=shapes)


def profile_denoise(denoise, noise, sigma) -> None:
    """Phase 6: one denoise call under torch.profiler, device time by bucket."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        for _ in range(2):
            denoise(noise, sigma)
        torch.cuda.synchronize()
        start = time.perf_counter()
        denoise(noise, sigma)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            denoise(noise, sigma)
            torch.cuda.synchronize()
    # device-side events only: the CPU ops that launched them carry their time too
    kernels = [(e.key, e.count, e.device_time_total / 1e3) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    buckets = {"flash_fwd": 0.0, "gemm": 0.0, "other": 0.0}
    for key, _, ms in kernels:
        if "flash_fwd_kernel" in key:
            buckets["flash_fwd"] += ms
        elif any(tag in key.lower() for tag in ("gemm", "nvjet", "cutlass", "xmma")):
            buckets["gemm"] += ms
        else:
            buckets["other"] += ms
    device_ms = sum(buckets.values())
    if not buckets["flash_fwd"]:
        raise RuntimeError("profile: no flash_fwd kernel time in the traced denoise call")
    top = sorted(kernels, key=lambda k: -k[2])[:8]
    phase("6 profile", wall_ms=wall_ms, device_ms=device_ms, idle_share=1 - device_ms / wall_ms,
          bucket_ms=buckets, top=[{"kernel": key[:100], "calls": n, "ms": ms} for key, n, ms in top])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    phase("1 environment", torch=torch.__version__, cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    print(smi, flush=True)

    from simpletuner_tpu_torch import csrc
    from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime
    from simpletuner_tpu_torch.ops import (
        flash_bwd_dkv_kernel, flash_bwd_dq_kernel, flash_fwd_kernel, set_attention_backend,
    )
    from simpletuner_tpu_torch.bench import perturb_adaln

    kernels = [flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel]
    libraries = sorted({kernel.library for kernel in kernels})
    start = time.perf_counter()
    csrc.build(libraries)  # one nvcc per source, all at once
    for library in libraries:
        csrc.load(library)
    ptxas = {library: [line.strip() for line in csrc.build_log_path(library).read_text().splitlines()
                       if any(key in line for key in ("entry function", "registers", "spill", "warning"))]
             for library in libraries}
    phase("2 build", seconds=time.perf_counter() - start, nvcc_seconds=csrc.BUILD_SECONDS, ptxas=ptxas)

    fwd_entry = kernel_cases()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        import numpy as np

        rng = np.random.default_rng(0)
        prompt = "a lighthouse on a basalt cliff at dusk, volumetric light"
        embeds = {
            "t5_embeds": rng.standard_normal((TXT_LEN, 4096), dtype=np.float32),
            "pooled_embeds": rng.standard_normal(768, dtype=np.float32),
            "attention_mask": (np.arange(TXT_LEN) < TXT_VALID).astype(np.int64),
        }
        text_dir = os.path.join(work, "text")
        config_path = os.path.join(work, "config.json")
        with open(config_path, "w") as handle:
            json.dump({
                "model_family": "flux", "model_flavour": "dev", "model_type": "full",
                "allow_untrained_init": True, "mixed_precision": "bf16", "vae_dtype": "bf16",
                "validation_resolution": RESOLUTION, "validation_seed": 42, "seed": 42,
                "validation_guidance_real": 3.5, "flow_schedule_auto_shift": True,
                "flux_attention_masked_training": True,
                "data_backend_config": [{"id": "embeds", "dataset_type": "text_embeds", "type": "local",
                                         "default": True, "cache_dir": text_dir}],
            }, handle)

        start = time.perf_counter()
        runtime = CheckpointInferenceRuntime(config_path=config_path, output=os.path.join(work, "out"))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - start
        runtime.text_cache.save(prompt, embeds)  # the cache the runtime renders from
        module, model = runtime.module, runtime.model
        params = sum(p.numel() for p in module.parameters())
        cfg = model.arch
        if (cfg.hidden_size, cfg.depth_double, cfg.depth_single, cfg.num_heads, cfg.head_dim) != (3072, 19, 38, 24, 128):
            raise RuntimeError(f"not the full-width Flux.1-dev config: {cfg}")

        step_times, step_start, finite, vae_s = [], [], [], []

        def before_step(mod, args):
            torch.cuda.synchronize()
            step_start.append(time.perf_counter())

        def after_step(mod, args, out):
            torch.cuda.synchronize()
            step_times.append(time.perf_counter() - step_start[-1])

        def decode_checked(z):
            finite.append(bool(torch.isfinite(z).all()))
            start = time.perf_counter()
            image = decode(z)
            torch.cuda.synchronize()
            vae_s.append(time.perf_counter() - start)
            return image

        hooks = [module.register_forward_pre_hook(before_step), module.register_forward_hook(after_step)]
        decode = runtime.vae.decode
        runtime.vae.decode = decode_checked

        torch.cuda.reset_peak_memory_stats()
        for kernel in kernels:
            kernel.launches = 0
        start = time.perf_counter()
        paths = runtime.render(prompt, steps=STEPS)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - start
        launches = {kernel.name: kernel.launches for kernel in kernels}
        if launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]:
            raise RuntimeError(f"the render launched backward kernels: {launches}")
        peak = torch.cuda.max_memory_allocated()
        runtime.vae.decode = decode
        for hook in hooks:
            hook.remove()

        expected = (cfg.depth_double + cfg.depth_single) * STEPS
        if launches["flash_fwd"] != expected:
            raise RuntimeError(f"flash_fwd launched {launches['flash_fwd']} times in the render, expected {expected}")
        if len(paths) != 1 or finite != [True]:
            raise RuntimeError(f"render produced {paths}, finite latents {finite}")
        check_png(paths[0], RESOLUTION, RESOLUTION)
        phase("4 render", params=params, resolution=RESOLUTION, steps=STEPS, init_s=init_s, render_s=render_s,
              s_per_step=sum(step_times[1:]) / (len(step_times) - 1), step_s=step_times,
              vae_decode_s=vae_s[0], peak_gib=peak / 2**30, launches=launches,
              png=os.path.basename(paths[0]), png_bytes=os.path.getsize(paths[0]), device=smi)

        # phase 5: AdaLN lin weights start at zero, so every gate is 0 and
        # attention would not reach the output; give them the lecun-normal
        # draw every other kernel gets
        gen = torch.Generator(device="cuda").manual_seed(5)
        perturb_adaln(module, gen)
        dev = torch.device("cuda")
        latent = RESOLUTION // 8
        batch = {"latents": torch.zeros((1, latent, latent, model.latent_channels), device=dev)}
        for key, value in model.collate_text_embeds([embeds]).items():
            batch[key] = torch.as_tensor(value, device=dev)
        cond = model.inference_conditioning(batch)
        noise = torch.randn((1, latent, latent, model.latent_channels), generator=gen, device=dev)
        sigma = torch.tensor(0.7)
        with torch.no_grad():
            kernel_v = model.denoise_fn(module, cond)(noise, sigma)
            unmasked_v = model.denoise_fn(module, {k: v for k, v in cond.items() if k != "t5_masks"})(noise, sigma)
            set_attention_backend("xla")
            try:
                plain_v = model.denoise_fn(module, cond)(noise, sigma)
            finally:
                set_attention_backend("auto")
        err, mask_effect = rel_l2(kernel_v, plain_v), rel_l2(unmasked_v, plain_v)
        if not (torch.isfinite(kernel_v).all() and err <= PARITY_REL_L2 and mask_effect > 5 * err):
            raise RuntimeError(f"full-width parity: rel L2 {err} (<= {PARITY_REL_L2}), mask effect {mask_effect}")
        phase("5 parity", rel_l2=err, bound=PARITY_REL_L2, unmasked_rel_l2=mask_effect)
        profile_denoise(model.denoise_fn(module, cond), noise, sigma)
        del runtime, module, model
    torch.cuda.empty_cache()

    bwd_entries = backward_cases()
    train_steps(kernels)
    gradient_parity("9 gradient parity")
    int8_cases()
    gradient_parity("11 gradient parity (int8 base)", quant="int8")
    launches_main = graph_step(kernels)
    gradient_parity("13 gradient parity (full depth)", depth=(19, 38))

    sources = {"flash_fwd": ("csrc/flash_fwd.cu", 68), "flash_bwd_dq": ("csrc/flash_bwd.cu", 197),
               "flash_bwd_dkv": ("csrc/flash_bwd.cu", 239)}
    entries = {"flash_fwd": fwd_entry, **bwd_entries}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"simpletuner_tpu_torch/{source}",
         "replaces": f"simpletuner_tpu/ops/flash_attention.py:{line}", "launches": launches_main[name],
         **entries[name]}
        for name, (source, line) in sources.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
