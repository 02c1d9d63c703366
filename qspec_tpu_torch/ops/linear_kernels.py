"""The quantized GEMMs: plain PyTorch versions and the wrappers of their
CUDA kernels.

Port of ``qspec_tpu/ops/linear_kernels.py``. One packed-int4 weight buffer
(see packing.py) serves the two GEMMs of QSpec:

* ``matmul_w4a16``: the verify GEMM and the int4 head, bf16 activations x
  int4 weights with f32 accumulation (kernel ``csrc/w4.cu``). At prefill
  widths it takes
  the dequantize-once branch of ``_w4a16_bigm`` (``linear_kernels.py:294``
  in the JAX package, threshold ``:349``): the weight planes are unpacked
  once with torch ops and multiplied with ``torch.mm`` (bf16 operands, f32
  result), as the JAX package leaves that case to XLA.
* ``matmul_w4a4``: the draft GEMM, int8 activations (int4 range for w4a4,
  full for w4a8) x int4 weights with exact int32 accumulation and a
  per-token x per-channel scale epilogue (the same kernel template,
  ``csrc/w4.cu``). It has no prefill branch: the draft prefill (M = 1024)
  runs the kernel too.

Both cut the weight's (128-column stripe, 256-k stage) units into
``w4_workers`` equal runs, one a block, and add a stripe's pieces in a fixed
order (``matmul_w4_split_ref`` is that order in plain PyTorch).

A group-quantized packed-int4 weight (AWQ / GPTQ checkpoints, quant="w4g",
model_loader/grouped.py) serves

* ``matmul_w4a16_g``: bf16 activations x int4 weights dequantized per
  (group, column) to ``bf16(q * s_g - o_g)``, f32 accumulation (kernel
  ``csrc/w4a16_g.cu``); the verify GEMM and the w4a16 draft's. Its
  prefill-width branch is ``_w4a16_g_bigm`` (the JAX package's, at the same
  threshold): dequantize once with torch ops, then ``torch.mm``.

and a byte-wide [K, N] weight, int8 or float8_e4m3fn, with per-channel
scales serves

* ``matmul_w8a16``: bf16 activations x byte weights widened exactly to bf16,
  f32 accumulation (kernel ``csrc/w8a16.cu``, one instantiation per weight
  type): the int8 lm_head of the quantized checkpoints and the W8A16 trunk
  of compressed-tensors checkpoints (quant="w8", model_loader/ct.py), int8
  (``int-quantized``) or fp8 (``float-quantized``). It cuts the weight's
  (128-column stripe, 128-k stage) units into ``w8_workers`` equal runs and
  adds a stripe's pieces in a fixed order, as ``csrc/w4.cu`` does
  (``matmul_w8_split_ref`` is that order in plain PyTorch). Past the same
  prefill threshold it is one ``torch.mm`` over the weights widened to bf16,
  with an f32 result, as the JAX package leaves that case to XLA.

A wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; each launch adds one to the
wrapper's ``launches`` count (``matmul_w8a16``'s fp8 instantiation counts
in ``matmul_w8a16_fp8.launches`` instead). With ``layer_idx`` the weights are the
layer-stacked ``[L, K//8, N]`` / ``[L, N]`` arrays and the kernel reads layer
``layer_idx`` in place (a pointer offset, no copy).
"""

from __future__ import annotations

import functools
import types
from typing import Optional

import torch

from qspec_tpu_torch import _build
from qspec_tpu_torch.ops.packing import (unpack_int4, unpack_int4_high,
                                         unpack_int4_low)

# activation bytes above which matmul_w4a16 takes the dequantize-once branch
# (the JAX package's single-VMEM-tile limit, kept so both take it at the
# same widths)
BIGM_BYTES = 5 * 1024 * 1024


def matmul_w4a16_ref(x: torch.Tensor, w_packed: torch.Tensor,
                     w_scales: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version: x [M, K] bf16, w_packed int32 [K//8, N], scales [N]."""
    w = unpack_int4(w_packed).to(torch.float32)
    out = x.to(torch.bfloat16).to(torch.float32) @ w
    out = out * w_scales.to(torch.float32)[None, :]
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :]
    return out.to(out_dtype)


def matmul_w4a4_ref(x_q: torch.Tensor, x_scales: torch.Tensor,
                    w_packed: torch.Tensor, w_scales: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: x_q int8 [M, K], x_scales [M] or [M, 1],
    w_packed int32 [K//8, N], w_scales [N] -> bf16 [M, N]. The integer sums
    are exact in float64 (|sum| < 2^53)."""
    w = unpack_int4(w_packed).to(torch.float64)
    acc = x_q.to(torch.float64) @ w
    out = acc.to(torch.float32) * x_scales.reshape(-1, 1).to(torch.float32)
    out = out * w_scales.to(torch.float32)[None, :]
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :]
    return out.to(torch.bfloat16)


def matmul_w8a16_ref(x: torch.Tensor, w_q: torch.Tensor, w_scales: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version: x [M, K] bf16, w_q int8 or float8_e4m3fn [K, N] (every
    value of either is a bf16 value: the widening is exact, an fp8 NaN code
    stays NaN), scales [N]. The sums of the bf16 x byte products are taken
    in float64, where they are exact at these widths, then rounded to f32: a
    row's result does not depend on the batch (the CPU path keeps greedy
    QSpec equal to greedy AR)."""
    acc = x.to(torch.bfloat16).to(torch.float64) @ w_q.to(torch.float64)
    out = acc.to(torch.float32) * w_scales.to(torch.float32)[None, :]
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :]
    return out.to(out_dtype)


def _dequant_g(q: torch.Tensor, w_scales_g: torch.Tensor,
               w_offs_g: torch.Tensor) -> torch.Tensor:
    """Unsigned nibbles q [k, N] dequantized to ``bf16(q * s - o)`` with
    their group's scale and offset ([k // g, N]), rounded as the JAX package
    rounds it (an f32 product, then an f32 difference)."""
    g = q.shape[0] // w_scales_g.shape[0]
    s = torch.repeat_interleave(w_scales_g.to(torch.float32), g, dim=0)
    o = torch.repeat_interleave(w_offs_g.to(torch.float32), g, dim=0)
    return (q.to(torch.float32) * s - o).to(torch.bfloat16)


def matmul_w4a16_g_ref(x: torch.Tensor, w_packed: torch.Tensor,
                       w_scales_g: torch.Tensor, w_offs_g: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version: x [M, K] bf16, w_packed int32 [K//8, N] holding the
    unsigned q (model_loader/grouped.py), scales and offsets (zp * s) f32
    [K//g, N]. The weights are dequantized to bf16 per (group, column); the
    sums of bf16 products are taken in float64, where they do not depend on
    their order at these widths, then rounded to f32: a row's result does
    not depend on the batch (the CPU path keeps greedy QSpec equal to
    greedy AR)."""
    w = _dequant_g(unpack_int4(w_packed) + 8, w_scales_g, w_offs_g)
    out = (x.to(torch.bfloat16).to(torch.float64) @ w.to(torch.float64)).to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :]
    return out.to(out_dtype)


def _layer(layer_idx, *weights):
    """The weight-side arrays of layer ``layer_idx`` (views: no copy)."""
    return weights if layer_idx is None else tuple(a[layer_idx] for a in weights)


def _bigm(m: int, k: int) -> bool:
    """The JAX package's prefill threshold: the bf16 activation tile,
    rounded up to 16 rows, exceeds BIGM_BYTES."""
    return max(-(-m // 16) * 16, 16) * 2 * k > BIGM_BYTES


def _check_w4_call(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor, act_dtype,
                   name: str) -> tuple:
    """(M, K, N) of a call csrc/w4.cu takes; raises otherwise."""
    _build.require(x.dtype == act_dtype and x.dim() == 2,
                   f"{name}: activations {act_dtype} [M, K]")
    m, k = x.shape
    _build.require(w.dtype == torch.int32 and w.dim() == 2 and w.shape[0] * 8 == k,
                   f"{name}: packed weights int32 [K//8, N] with K={k}")
    n = w.shape[1]
    _build.require(s.dtype == torch.float32 and tuple(s.shape) == (n,),
                   f"{name}: weight scales f32 [N]")
    _build.require(k % 32 == 0, f"{name}: K must be a multiple of 32, got {k}")
    _build.require(k < 2 ** 17, f"{name}: K < 131072, got K={k}")
    return m, k, n


def _w4a16_bigm(x, w_packed, w_scales, out_dtype):
    """Prefill-width branch (mirrors the JAX package's _w4a16_bigm): decode
    the two nibble planes once to bf16 integers, two bf16 GEMMs with f32
    results (the halves pairing maps onto two contiguous products), then the
    per-channel scale."""
    lo = unpack_int4_low(w_packed).to(torch.bfloat16)
    hi = unpack_int4_high(w_packed).to(torch.bfloat16)
    kh = lo.shape[0]
    xb = x.to(torch.bfloat16)
    acc = (torch.mm(xb[:, :kh], lo, out_dtype=torch.float32)
           + torch.mm(xb[:, kh:], hi, out_dtype=torch.float32))
    return (acc * w_scales.to(torch.float32)[None, :]).to(out_dtype)


def matmul_w4a16(x: torch.Tensor, w_packed: torch.Tensor, w_scales: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, out_dtype=torch.bfloat16,
                 layer_idx: Optional[int] = None) -> torch.Tensor:
    """x [M, K] bf16 @ packed-int4 w [K//8, N] -> [M, N] out_dtype."""
    w, s = _layer(layer_idx, w_packed, w_scales)
    if not x.is_cuda:
        return matmul_w4a16_ref(x, w, s, bias, out_dtype=out_dtype)
    m, k = x.shape
    if _bigm(m, k):
        out = _w4a16_bigm(x, w, s, out_dtype)
    else:
        m, k, n = _check_w4_call(x, w, s, torch.bfloat16, "matmul_w4a16")
        _build.require(out_dtype in (torch.bfloat16, torch.float32),
                       "matmul_w4a16: out_dtype bf16 or f32")
        out = torch.empty((m, n), dtype=out_dtype, device=x.device)
        if m:
            workers, ws, counters = _w4_scratch(x, m, k, n, torch.float32, out)
            _build.cuda_args_ok(x, w, s, out, ws)
            _build.check("matmul_w4a16", _build.lib().qspec_w4a16(
                x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), ws.data_ptr(),
                counters.data_ptr(), m, k, n, workers, int(out_dtype == torch.float32),
                _build.stream_of(x)))
            matmul_w4a16.launches += 1
    if bias is not None:
        out = out + bias[None, :].to(out.dtype)
    return out


matmul_w4a16.launches = 0


def _w4a16_g_bigm(x, w_packed, w_scales_g, w_offs_g, out_dtype):
    """Prefill-width branch (the JAX package's _w4a16_g_bigm): dequantize
    each nibble plane once to bf16 (the low plane holds groups [0, G/2), the
    high plane the rest), two bf16 GEMMs (the halves pairing maps onto two
    contiguous products) with f32 results."""
    G2 = w_scales_g.shape[0] // 2
    lo = _dequant_g(unpack_int4_low(w_packed) + 8, w_scales_g[:G2], w_offs_g[:G2])
    hi = _dequant_g(unpack_int4_high(w_packed) + 8, w_scales_g[G2:], w_offs_g[G2:])
    kh = lo.shape[0]
    xb = x.to(torch.bfloat16)
    acc = (torch.mm(xb[:, :kh], lo, out_dtype=torch.float32)
           + torch.mm(xb[:, kh:], hi, out_dtype=torch.float32))
    return acc.to(out_dtype)


# csrc/w4a16_g.cu's tiling: output columns per block, k per pipeline stage
# (64 of each nibble plane); the most K-slices the planner gives a stripe
W4G_COLS = 128
W4G_STAGE_K = 128
W4G_MAX_SPLITS = 16
# k-stages a K-slice keeps where it can (the depth of the kernel's ring)
W4G_MIN_STAGES = 4
# the verify width at which the planner prices the slices' partial sums
W4G_PLAN_ROWS = 16


@functools.lru_cache(maxsize=None)
def w4g_splits(k: int, n: int, n_sm: int) -> int:
    """K-slices per 128-column stripe of csrc/w4a16_g.cu for a [K/8, N]
    weight on a card of ``n_sm`` SMs: slice i of S takes the k-stages
    [i T / S, (i + 1) T / S) of the T = K / 128. A function of the weight's
    shape and the card only, never of M, so a row's sum has the same order
    at every batch size.

    Among the S that give at least one (stripe, slice) unit per SM, and
    keep ``W4G_MIN_STAGES`` stages a slice where any does, it takes the one
    of least estimated traffic: the weight bytes of the busiest SM's stages
    (its units, one wave of n_sm after another, of the longest slice) times
    the SM count, plus the partial sums written and read back at M = 16."""
    stages = k // W4G_STAGE_K
    stripes = -(-n // W4G_COLS)
    fits = [s for s in range(1, min(stages, W4G_MAX_SPLITS) + 1) if stripes * s >= n_sm]
    if not fits:
        return min(stages, W4G_MAX_SPLITS)
    deep = [s for s in fits if stages // s >= W4G_MIN_STAGES] or fits[:1]

    def cost(s):
        busiest = -(-stripes * s // n_sm) * -(-stages // s)
        partials = 8 * W4G_PLAN_ROWS * n * s if s > 1 else 0
        return busiest * W4G_STAGE_K * W4G_COLS // 2 * n_sm + partials
    return min(deep, key=cost)


@functools.lru_cache(maxsize=None)
def w4g_scale_slots(k: int, G: int) -> int:
    """The most groups that one stage's 64 k of a nibble plane touch: the
    (scale, offset) rows a stage of csrc/w4a16_g.cu copies (1 for g >= 64
    dividing or divided by 64, at most 4 for g >= 16)."""
    g = k // G
    span = W4G_STAGE_K // 2
    return max((a + span - 1) // g - a // g + 1 for a in range(0, k // 2, span))


def w4g_plan(m: int, k: int, n: int, G: int, n_sm: int) -> tuple:
    """(splits, scale slots, counter tiles) of one csrc/w4a16_g.cu launch
    at M = ``m``: the split and the slots do not depend on ``m``; the
    counters are one per (64-row block, 128-column stripe)."""
    return (w4g_splits(k, n, n_sm), w4g_scale_slots(k, G),
            -(-n // W4G_COLS) * -(-m // 64))


# per device: the split counters of csrc/w4a16_g.cu, csrc/w4.cu and
# csrc/w8a16.cu, int32
# zeros that each launch leaves at zero (so launches on one device must not
# overlap in time on two streams), at least SPLIT_COUNTERS of them
_SPLIT_COUNTERS: dict = {}
SPLIT_COUNTERS = 4096


def _split_counters(x: torch.Tensor, tiles: int) -> torch.Tensor:
    buf = _SPLIT_COUNTERS.get(x.device)
    if buf is None or buf.numel() < tiles:
        _build.require(not torch.cuda.is_current_stream_capturing(),
                       "the split GEMMs' counters are allocated at their first "
                       "call on a device: make one before a CUDA graph capture")
        buf = torch.zeros(max(tiles, SPLIT_COUNTERS), dtype=torch.int32, device=x.device)
        _SPLIT_COUNTERS[x.device] = buf
    return buf


# csrc/w4.cu's tiling: output columns per stripe, k per pipeline stage (128
# of each nibble plane), the rows a block carries (past them, a block owns
# one 64-row block of one stripe over all of K: no workspace)
W4_COLS = 128
W4_STAGE_K = 256
W4_BLOCK_ROWS = 64


def _stream_k_runs(units: int, p: int) -> list:
    """[(first, end)] of ``p`` runs cutting ``units`` units in order: run i
    takes [i U / P, (i + 1) U / P)."""
    return [(i * units // p, (i + 1) * units // p) for i in range(p)]


def _stream_k_segments(runs: list, stripes: int, T: int, unit_k: int, end_k: int) -> list:
    """Per stripe of ``T`` units of ``unit_k`` k each, the k range [a, b) of
    each run's piece of it (clipped at ``end_k``), in run order."""
    segs = [[] for _ in range(stripes)]
    for u0, u1 in runs:
        u = u0
        while u < u1:
            s, end = u // T, min(u1, (u // T + 1) * T)
            segs[s].append(((u - s * T) * unit_k, min((end - s * T) * unit_k, end_k)))
            u = end
    return segs


@functools.lru_cache(maxsize=None)
def w4_workers(k: int, n: int, n_sm: int) -> int:
    """The number of runs P that csrc/w4.cu cuts a [K/8, N] weight into on a
    card of ``n_sm`` SMs. A unit is a (128-column stripe, 256-k stage) pair;
    the U = ceil(N / 128) ceil(K / 256) units, stripe after stripe, are cut
    into P = min(n_sm, U) runs, run p taking [p U / P, (p + 1) U / P): one a
    block, every SM a run, no run more than one unit longer than another. A
    function of the weight's shape and the card only, never of M, so a
    row's sum has the same order at every batch size."""
    return min(n_sm, -(-n // W4_COLS) * -(-k // W4_STAGE_K))


def w4_runs(k: int, n: int, n_sm: int) -> list:
    """[(first, end)] units of each run of csrc/w4.cu, in block order."""
    units = -(-n // W4_COLS) * -(-k // W4_STAGE_K)
    return _stream_k_runs(units, w4_workers(k, n, n_sm))


def w4_segments(k: int, n: int, n_sm: int) -> list:
    """Per 128-column stripe, its segments in the order csrc/w4.cu adds
    them: the k range [a, b) of each nibble plane that one run covers (of
    the low plane; the high plane's are K/2 + a .. K/2 + b)."""
    return _stream_k_segments(w4_runs(k, n, n_sm), -(-n // W4_COLS), -(-k // W4_STAGE_K),
                              W4_STAGE_K // 2, k // 2)


def w4_plan(m: int, k: int, n: int, n_sm: int) -> tuple:
    """(runs, whole mode, workspace slots) of one csrc/w4.cu launch at M =
    ``m``: the runs do not depend on ``m``; past 64 rows the kernel takes
    its whole mode (a block per 64-row block and stripe, the same segments
    added in the same order inside it), which needs no workspace."""
    workers = w4_workers(k, n, n_sm)
    whole = m > W4_BLOCK_ROWS
    return workers, whole, 0 if whole else 2 * workers


def _w4_scratch(x: torch.Tensor, m: int, k: int, n: int, ws_dtype,
                out: torch.Tensor) -> tuple:
    """(runs, workspace, counters) of one csrc/w4.cu launch: the segments'
    sums [2 runs, M, 128] (in whole mode none: ``out`` stands in, unread)
    and the per-device split counters, one per stripe."""
    workers, _, slots = w4_plan(m, k, n, _build.sm_count(x.device))
    ws = torch.empty((slots, m, W4_COLS), dtype=ws_dtype, device=x.device) if slots else out
    return workers, ws, _split_counters(x, -(-n // W4_COLS))


def matmul_w4_split_ref(x: torch.Tensor, w_packed: torch.Tensor, w_scales: torch.Tensor,
                        x_scales: Optional[torch.Tensor] = None, *, n_sm: int,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """csrc/w4.cu's order of sums in plain PyTorch: per stripe, each
    segment's sum over both nibble planes (exact in float64), rounded to
    f32 (w4a16) or kept exact (w4a4), the segments added in block order
    (in f32, or exactly), then the plain version's epilogue. w4a16 when
    ``x_scales`` is None (x bf16 [M, K]); otherwise w4a4 (x int8, out bf16)."""
    int8 = x_scales is not None
    m, k = x.shape
    n = w_packed.shape[1]
    w = unpack_int4(w_packed).to(torch.float64)
    xd = (x if int8 else x.to(torch.bfloat16)).to(torch.float64)
    kh = k // 2
    acc = torch.empty((m, n), dtype=torch.float64 if int8 else torch.float32)
    for s, segs in enumerate(w4_segments(k, n, n_sm)):
        cols = slice(s * W4_COLS, min((s + 1) * W4_COLS, n))
        total = None
        for a, b in segs:
            part = xd[:, a:b] @ w[a:b, cols] + xd[:, kh + a:kh + b] @ w[kh + a:kh + b, cols]
            part = part if int8 else part.to(torch.float32)
            total = part if total is None else total + part
        acc[:, cols] = total
    if int8:
        out = acc.to(torch.float32) * x_scales.reshape(-1, 1).to(torch.float32)
        return (out * w_scales.to(torch.float32)[None, :]).to(torch.bfloat16)
    return (acc * w_scales.to(torch.float32)[None, :]).to(out_dtype)


def _check_w4g(k: int, w: torch.Tensor, s: torch.Tensor, o: torch.Tensor) -> tuple:
    """(N, G) of a grouped weight csrc/w4a16_g.cu takes; raises otherwise."""
    _build.require(w.dtype == torch.int32 and w.dim() == 2 and w.shape[0] * 8 == k,
                   f"matmul_w4a16_g: packed weights int32 [K//8, N] with K={k}")
    n = w.shape[1]
    G = s.shape[0]
    _build.require(s.dtype == torch.float32 and o.dtype == torch.float32
                   and tuple(s.shape) == (G, n) and tuple(o.shape) == (G, n),
                   "matmul_w4a16_g: scales and offsets f32 [K//g, N]")
    _build.require(k % 256 == 0, f"matmul_w4a16_g: K % 256 == 0, got K={k}")
    _build.require(G % 2 == 0 and k % G == 0 and (k // 2) % (k // G) == 0
                   and (k // G) % 16 == 0,
                   f"matmul_w4a16_g: an even group count whose group size is a "
                   f"multiple of 16 dividing K/2, got K={k}, G={G}")
    return n, G


def matmul_w4a16_g(x: torch.Tensor, w_packed: torch.Tensor,
                   w_scales_g: torch.Tensor, w_offs_g: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, *, out_dtype=torch.bfloat16,
                   layer_idx: Optional[int] = None) -> torch.Tensor:
    """x [M, K] bf16 @ group-quantized int4 w -> [M, N] out_dtype (AWQ /
    GPTQ weights). w_packed [K//8, N] int32 (nibbles = unsigned q),
    w_scales_g and w_offs_g = zp * s f32 [K//g, N]. With ``layer_idx`` the
    weight-side arrays carry a leading stacked-layer dim and the kernel
    reads layer ``layer_idx`` in place. The kernel takes K % 256 == 0, an
    even group count and a group size that is a multiple of 16 dividing
    K/2. It splits K into ``w4g_splits`` slices per 128-column stripe; their
    partial sums go to an f32 workspace and are added in a fixed order by
    the kernel (one launch per call)."""
    w, s, o = _layer(layer_idx, w_packed, w_scales_g, w_offs_g)
    if not x.is_cuda:
        return matmul_w4a16_g_ref(x, w, s, o, bias, out_dtype=out_dtype)
    m, k = x.shape
    n, G = _check_w4g(k, w, s, o)
    if _bigm(m, k):
        out = _w4a16_g_bigm(x, w, s, o, out_dtype)
    else:
        _build.require(x.dtype == torch.bfloat16, "matmul_w4a16_g: x bf16")
        _build.require(out_dtype in (torch.bfloat16, torch.float32),
                       "matmul_w4a16_g: out_dtype bf16 or f32")
        _build.require(k < 2 ** 17, f"matmul_w4a16_g: K < 131072, got K={k}")
        out = torch.empty((m, n), dtype=out_dtype, device=x.device)
        if m:
            splits, slots, tiles = w4g_plan(m, k, n, G, _build.sm_count(x.device))
            ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
                  if splits > 1 else out)
            counters = _split_counters(x, tiles)
            _build.cuda_args_ok(x, w, s, o, out, ws)
            _build.check("matmul_w4a16_g", _build.lib().qspec_w4a16_g(
                x.data_ptr(), w.data_ptr(), s.data_ptr(), o.data_ptr(),
                out.data_ptr(), ws.data_ptr(), counters.data_ptr(), m, k, n, G,
                splits, slots, int(out_dtype == torch.float32),
                _build.stream_of(x)))
            matmul_w4a16_g.launches += 1
    if bias is not None:
        out = out + bias[None, :].to(out.dtype)
    return out


matmul_w4a16_g.launches = 0


def matmul_w4a4(x_q: torch.Tensor, x_scales: torch.Tensor, w_packed: torch.Tensor,
                w_scales: torch.Tensor, bias: Optional[torch.Tensor] = None,
                *, layer_idx: Optional[int] = None) -> torch.Tensor:
    """Quantized activations x_q int8 [M, K] (scales [M] or [M, 1]) @
    packed-int4 w [K//8, N] -> bf16 [M, N]."""
    w, s = _layer(layer_idx, w_packed, w_scales)
    if not x_q.is_cuda:
        return matmul_w4a4_ref(x_q, x_scales, w, s, bias)
    m, k, n = _check_w4_call(x_q, w, s, torch.int8, "matmul_w4a4")
    sx = x_scales.reshape(-1)
    _build.require(sx.dtype == torch.float32 and sx.shape[0] == m,
                   "matmul_w4a4: x_scales f32 [M] or [M, 1]")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x_q.device)
    if m:
        workers, ws, counters = _w4_scratch(x_q, m, k, n, torch.int32, out)
        _build.cuda_args_ok(x_q, sx, w, s, out, ws)
        _build.check("matmul_w4a4", _build.lib().qspec_w4a4(
            x_q.data_ptr(), sx.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
            ws.data_ptr(), counters.data_ptr(), m, k, n, workers, _build.stream_of(x_q)))
        matmul_w4a4.launches += 1
    if bias is not None:
        out = out + bias[None, :].to(out.dtype)
    return out


matmul_w4a4.launches = 0


# the weight types of matmul_w8a16 -> the exported kernel of each
W8_KERNELS = {torch.int8: "qspec_w8a16", torch.float8_e4m3fn: "qspec_w8a16_fp8"}

# csrc/w8a16.cu's tiling: output columns (weight bytes a row) per stripe, k
# per pipeline stage (a 16 KB unit), the rows a block carries (past them, a
# block owns one 64-row block of one stripe over all of K: no workspace)
W8_COLS = 128
W8_STAGE_K = 128
W8_BLOCK_ROWS = 64


@functools.lru_cache(maxsize=None)
def w8_workers(k: int, n: int, n_sm: int) -> int:
    """The number of runs P that csrc/w8a16.cu cuts a [K, N] byte weight
    into on a card of ``n_sm`` SMs: the U = ceil(N / 128) ceil(K / 128)
    (128-column stripe, 128-k stage) units, stripe after stripe, cut into P =
    min(n_sm, U) runs of equal length, one a block (w4_workers' plan at
    other units). A function of the weight's shape and the card only, never
    of M."""
    return min(n_sm, -(-n // W8_COLS) * -(-k // W8_STAGE_K))


def w8_runs(k: int, n: int, n_sm: int) -> list:
    """[(first, end)] units of each run of csrc/w8a16.cu, in block order."""
    units = -(-n // W8_COLS) * -(-k // W8_STAGE_K)
    return _stream_k_runs(units, w8_workers(k, n, n_sm))


def w8_segments(k: int, n: int, n_sm: int) -> list:
    """Per 128-column stripe, its segments in the order csrc/w8a16.cu adds
    them: the k range [a, b) that one run covers."""
    return _stream_k_segments(w8_runs(k, n, n_sm), -(-n // W8_COLS), -(-k // W8_STAGE_K),
                              W8_STAGE_K, k)


def w8_plan(m: int, k: int, n: int, n_sm: int) -> tuple:
    """(runs, whole mode, workspace slots) of one csrc/w8a16.cu launch at M
    = ``m``: the runs do not depend on ``m``; past 64 rows the kernel takes
    its whole mode (a block per 64-row block and stripe, the same segments
    added in the same order inside it), which needs no workspace."""
    workers = w8_workers(k, n, n_sm)
    whole = m > W8_BLOCK_ROWS
    return workers, whole, 0 if whole else 2 * workers


def _check_w8_call(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor, out_dtype) -> tuple:
    """(M, K, N) of a call matmul_w8a16 takes on the card; raises otherwise.
    Past the prefill threshold (the torch.mm branch) only the weight type and
    the shapes are checked."""
    _build.require(w.dtype in W8_KERNELS,
                   f"matmul_w8a16: int8 or float8_e4m3fn weights, got {w.dtype}")
    m, k = x.shape
    _build.require(w.dim() == 2 and w.shape[0] == k,
                   f"matmul_w8a16: weights [K, N] with K={k}")
    n = w.shape[1]
    _build.require(s.dtype == torch.float32 and tuple(s.shape) == (n,),
                   "matmul_w8a16: weight scales f32 [N]")
    if not _bigm(m, k):
        _build.require(k % 16 == 0 and n % 8 == 0,
                       f"matmul_w8a16: K % 16 == 0 and N % 8 == 0, got K={k} N={n}")
        _build.require(x.dtype == torch.bfloat16, "matmul_w8a16: x bf16")
        _build.require(out_dtype in (torch.bfloat16, torch.float32),
                       "matmul_w8a16: out_dtype bf16 or f32")
    return m, k, n


def matmul_w8_split_ref(x: torch.Tensor, w_q: torch.Tensor, w_scales: torch.Tensor, *,
                        n_sm: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """csrc/w8a16.cu's order of sums in plain PyTorch: per stripe, each
    segment's sum (exact in float64) rounded to f32, the segments added in
    block order in f32, then the plain version's epilogue."""
    m, k = x.shape
    n = w_q.shape[1]
    w = w_q.to(torch.float64)
    xd = x.to(torch.bfloat16).to(torch.float64)
    acc = torch.empty((m, n), dtype=torch.float32)
    for s, segs in enumerate(w8_segments(k, n, n_sm)):
        cols = slice(s * W8_COLS, min((s + 1) * W8_COLS, n))
        total = None
        for a, b in segs:
            part = (xd[:, a:b] @ w[a:b, cols]).to(torch.float32)
            total = part if total is None else total + part
        acc[:, cols] = total
    return (acc * w_scales.to(torch.float32)[None, :]).to(out_dtype)


def matmul_w8a16(x: torch.Tensor, w_q: torch.Tensor, w_scales: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, out_dtype=torch.bfloat16,
                 layer_idx: Optional[int] = None) -> torch.Tensor:
    """x [M, K] bf16 @ byte weights w [K, N], int8 or float8_e4m3fn
    (per-channel scales [N]) -> [M, N] out_dtype. With ``layer_idx`` the
    weights are the stacked [L, K, N] / [L, N] arrays and the kernel reads
    layer ``layer_idx`` in place. The kernel cuts the weight into
    ``w8_workers`` equal runs, one a block; a stripe's pieces go to an f32
    workspace and are added in a fixed order inside the launch (one launch
    a call)."""
    w, s = _layer(layer_idx, w_q, w_scales)
    _build.require(w.dtype in W8_KERNELS,
                   f"matmul_w8a16: int8 or float8_e4m3fn weights, got {w.dtype}")
    if not x.is_cuda:
        return matmul_w8a16_ref(x, w, s, bias, out_dtype=out_dtype)
    m, k, n = _check_w8_call(x, w, s, out_dtype)
    if _bigm(m, k):
        # prefill width: widen the weights once, one bf16 GEMM, f32 result
        acc = torch.mm(x.to(torch.bfloat16), w.to(torch.bfloat16),
                       out_dtype=torch.float32)
        out = (acc * s[None, :]).to(out_dtype)
    else:
        out = torch.empty((m, n), dtype=out_dtype, device=x.device)
        if m:
            workers, _, slots = w8_plan(m, k, n, _build.sm_count(x.device))
            ws = (torch.empty((slots, m, W8_COLS), dtype=torch.float32, device=x.device)
                  if slots else out)
            counters = _split_counters(x, -(-n // W8_COLS))
            _build.cuda_args_ok(x, w, s, out, ws)
            kernel = W8_KERNELS[w.dtype]
            _build.check(f"matmul_w8a16 ({w.dtype})", getattr(_build.lib(), kernel)(
                x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), ws.data_ptr(),
                counters.data_ptr(), m, k, n, workers, int(out_dtype == torch.float32),
                _build.stream_of(x)))
            W8_COUNTERS[w.dtype].launches += 1
    if bias is not None:
        out = out + bias[None, :].to(out.dtype)
    return out


matmul_w8a16.launches = 0
# the fp8-weight instantiation's launch counter
matmul_w8a16_fp8 = types.SimpleNamespace(launches=0)
W8_COUNTERS = {torch.int8: matmul_w8a16, torch.float8_e4m3fn: matmul_w8a16_fp8}
