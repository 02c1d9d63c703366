"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure raises and the script exits non-zero, printing no result):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the CUDA kernels of qspec_tpu_torch (one nvcc call) and
   print the build seconds and the `-Xptxas -v` summary;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes of the main path, max error beside the stated tolerance;
4. timing: each kernel, its plain version and (where one exists) the one
   PyTorch call that computes the same function, timed with CUDA events over
   CUDA-graph replays; the least time the card could take (bound_ms);
5. small-input reference: the tiny model's logits on the card (kernels) vs on
   the CPU (plain versions), same weights; then the tiny model through the
   engine on the card, QSpec against its oracle (drafts are accepted there);
6. end to end: LLM(model="llama3-8b", lm_head_quant="bf16",
   num_speculative_tokens=3) with random weights made on the card, 4 prompts
   of 64-192 random token ids, 32 greedy tokens each, through QSpec and then
   through the qspec_null oracle (the same rounds with proposals nulled);
   tokens must be identical and every kernel's launch count must have risen
   during the QSpec run; then the same with the W4A8 draft, whose drafts are
   accepted at this width.

It prints the kernel summary as one JSON line and, last, the device JSON line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
L2_BYTES = 50 * 1024 * 1024


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- timing

def graph_ms(fn, reps: int = 20) -> float:
    """Milliseconds per call of ``fn``: ``reps`` calls captured in one CUDA
    graph (no host launch cost), replayed after a warm-up, timed with CUDA
    events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n_replay = 5
    start.record()
    for _ in range(n_replay):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n_replay * reps)


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Rotating:
    """Copies of one input set whose total exceeds L2, taken in turn, so a
    timed call finds its weights in device memory as the model's layer loop
    does, not in L2."""

    def __init__(self, make, nbytes: int):
        self.sets = [make() for _ in range(max(2, math.ceil(2 * L2_BYTES / max(nbytes, 1))))]
        self.i = 0

    def next(self):
        s = self.sets[self.i % len(self.sets)]
        self.i += 1
        return s


# ---------------------------------------------------------------- phases

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return smi


def phase_build():
    from qspec_tpu_torch import _build
    t0 = time.perf_counter()
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_info['seconds']:.2f} s)")
    log("ptxas: " + json.dumps(_build.build_info.get("ptxas", {})))


def _w4(gen, k, n):
    from qspec_tpu_torch.ops.packing import quantize_weight_int4_torch
    return quantize_weight_int4_torch(torch.randn(k, n, generator=gen, device="cuda") * 0.02)


GEMM_SHAPES = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))


def check_gemms(gen, report):
    from qspec_tpu_torch.ops import linear_kernels as lk
    from qspec_tpu_torch.ops.quant import sym_quant_int4, sym_quant_int8
    err16 = err4 = 0.0
    for k, n in GEMM_SHAPES:
        qw, qs = _w4(gen, k, n)
        for m in (4, 16):
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            out = lk.matmul_w4a16(x, qw, qs)
            ref = lk.matmul_w4a16_ref(x, qw, qs)
            torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
            err16 = max(err16, (out.float() - ref.float()).abs().max().item())
            for xq in (sym_quant_int4(x), sym_quant_int8(x)):
                out = lk.matmul_w4a4(xq.values, xq.scales, qw, qs)
                ref = lk.matmul_w4a4_ref(xq.values, xq.scales, qw, qs)
                torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)
                err4 = max(err4, (out.float() - ref.float()).abs().max().item())
    report["matmul_w4a16"].update(max_err=err16, tol="rtol=atol=2e-2")
    report["matmul_w4a4"].update(max_err=err4, tol="rtol=atol=1e-2")
    log(f"check matmul_w4a16: max_abs_err {err16:.3g} (tol rtol=atol=2e-2)")
    log(f"check matmul_w4a4: max_abs_err {err4:.3g} (tol rtol=atol=1e-2; int4 and int8 activations)")


def check_norms(gen, report):
    from qspec_tpu_torch.ops import rmsnorm_quant as rq
    e_n = e_s = 0.0
    e_q = 0
    worst_exact = 1.0
    for m in (16, 512):
        x = (torch.randn(m, 4096, generator=gen, device="cuda") * 3).to(torch.bfloat16)
        out, ref = rq.rmsnorm(x), rq.rmsnorm_ref(x)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
        e_n = max(e_n, (out.float() - ref.float()).abs().max().item())
        for bits in (4, 8):
            a, b = rq.rmsnorm_quant(x, bits=bits), rq.rmsnorm_quant_ref(x, bits=bits)
            torch.testing.assert_close(a.scales, b.scales, rtol=1e-3, atol=0)
            d = (a.values.int() - b.values.int()).abs()
            exact = (d == 0).float().mean().item()
            if d.max().item() > 1 or exact <= 0.99:
                raise AssertionError(f"rmsnorm_quant values: max diff {d.max().item()}, "
                                     f"exact share {exact}")
            worst_exact = min(worst_exact, exact)
            e_q = max(e_q, int(d.max().item()))
            e_s = max(e_s, ((a.scales - b.scales).abs() / b.scales).max().item())
    report["rmsnorm"].update(max_err=e_n, tol="rtol=atol=2e-2")
    report["rmsnorm_quant"].update(
        max_err=float(e_q), tol="int values within 1, >99% exact; scales rtol 1e-3")
    log(f"check rmsnorm: max_abs_err {e_n:.3g} (tol rtol=atol=2e-2)")
    log(f"check rmsnorm_quant: int values max diff {e_q} (tol 1), exact share "
        f">= {worst_exact:.5f} (tol > 0.99); scale max rel err {e_s:.3g} (tol 1e-3)")


def _attn_inputs(gen, q_len, B=4, Hq=32, Hkv=8, D=128, S=128):
    from qspec_tpu_torch.ops.kv_cache import PagedKVCache
    ctx = [max(c, q_len) for c in (3 * S - 5, 2 * S + 7, 4 * S, 40)]
    pages = [-(-c // S) for c in ctx]
    P = 1 + sum(pages)
    kv = (torch.randn(2, P, 2, Hkv, S, D, generator=gen, device="cuda")).to(torch.bfloat16)
    ids = torch.randperm(P - 1, generator=torch.Generator().manual_seed(q_len)) + 1
    tables = torch.zeros(B, max(pages), dtype=torch.int32)
    o = 0
    for b, n in enumerate(pages):
        tables[b, :n] = ids[o:o + n]
        o += n
    q = torch.randn(B, q_len, Hq, D, generator=gen, device="cuda").to(torch.bfloat16)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    return q, PagedKVCache(kv), tables.cuda(), ctx_t


def check_attention(gen, report):
    from qspec_tpu_torch.ops.attention import paged_attention_ref
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    err = 0.0
    for q_len in (1, 2, 4, 128):
        q, cache, tables, ctx = _attn_inputs(gen, q_len)
        out = paged_attention_cuda(q, cache.kv_pages, tables, ctx, 128 ** -0.5, layer=1)
        ref = paged_attention_ref(q, cache, 1, tables, ctx, 128 ** -0.5)
        torch.testing.assert_close(out.float(), ref.float(), rtol=3e-2, atol=3e-2)
        err = max(err, (out.float() - ref.float()).abs().max().item())
    report["paged_attention"].update(max_err=err, tol="rtol=atol=3e-2")
    log(f"check paged_attention: max_abs_err {err:.3g} (tol rtol=atol=3e-2; Q in 1,2,4,128)")


def time_kernels(gen, report, detail):
    """Per kernel, at the main path's shape: kernel, plain version, library
    call; bound from the bytes and operations of this call's inputs."""
    from qspec_tpu_torch.ops import linear_kernels as lk
    from qspec_tpu_torch.ops import rmsnorm_quant as rq
    from qspec_tpu_torch.ops.attention import paged_attention_ref
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    from qspec_tpu_torch.ops.quant import sym_quant_int4

    # GEMMs: one decoder layer's four projections at the verify width (M=16:
    # 4 sequences x (k+1) positions) and the draft width (M=4)
    for name, m in (("matmul_w4a16", 16), ("matmul_w4a4", 4)):
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        kinds = set()
        for k, n in GEMM_SHAPES:
            wbytes = k * n // 2 + 4 * n
            rot = Rotating(lambda k=k, n=n: _w4(gen, k, n), wbytes)
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            xq = sym_quant_int4(x)
            if name == "matmul_w4a16":
                def kern():
                    qw, qs = rot.next()
                    lk.matmul_w4a16(x, qw, qs)

                def plain():
                    qw, qs = rot.next()
                    lk.matmul_w4a16_ref(x, qw, qs)
                nbytes = m * k * 2 + wbytes + m * n * 2
                b, kind = bound_ms(nbytes, 2 * m * k * n, "bf16")
            else:
                def kern():
                    qw, qs = rot.next()
                    lk.matmul_w4a4(xq.values, xq.scales, qw, qs)

                def plain():
                    qw, qs = rot.next()
                    lk.matmul_w4a4_ref(xq.values, xq.scales, qw, qs)
                nbytes = m * k + 4 * m + wbytes + m * n * 2
                b, kind = bound_ms(nbytes, 2 * m * k * n, "int8")
            t_k, t_p = graph_ms(kern), graph_ms(plain, reps=3)
            detail.append({"kernel": name, "M": m, "K": k, "N": n, "ms": t_k,
                           "plain_ms": t_p, "bound_ms": b, "bound_by": kind,
                           "gbytes_per_s": nbytes / (t_k * 1e-3) / 1e9})
            log(f"time {name} M={m} K={k} N={n}: {t_k:.4f} ms, plain {t_p:.4f} ms, "
                f"bound {b:.4f} ms ({kind}), {nbytes / (t_k * 1e-3) / 1e9:.0f} GB/s")
            tot["ms"] += t_k
            tot["plain_ms"] += t_p
            tot["bound_ms"] += b
            kinds.add(kind)
        report[name].update(tot, bound_by="/".join(sorted(kinds)), library_ms=None,
                            shape=f"one layer's qkv+o+gate_up+down at M={m}")

    # norms: verify side M=16 (rmsnorm), draft side M=4 (rmsnorm_quant), H=4096
    H = 4096
    x16 = torch.randn(16, H, generator=gen, device="cuda").to(torch.bfloat16)
    t_k = graph_ms(lambda: rq.rmsnorm(x16))
    t_p = graph_ms(lambda: rq.rmsnorm_ref(x16))
    t_l = graph_ms(lambda: torch.nn.functional.rms_norm(x16, (H,), eps=1e-5))
    b, kind = bound_ms(16 * H * 4, 4 * 16 * H, "f32")
    report["rmsnorm"].update(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b,
                             bound_by=kind, shape="M=16, H=4096")
    log(f"time rmsnorm M=16 H=4096: {t_k:.4f} ms, plain {t_p:.4f}, "
        f"F.rms_norm {t_l:.4f}, bound {b:.5f} ({kind})")
    x4 = torch.randn(4, H, generator=gen, device="cuda").to(torch.bfloat16)
    t_k = graph_ms(lambda: rq.rmsnorm_quant(x4))
    t_p = graph_ms(lambda: rq.rmsnorm_quant_ref(x4))
    b, kind = bound_ms(4 * H * 3 + 16, 6 * 4 * H, "f32")
    report["rmsnorm_quant"].update(ms=t_k, plain_ms=t_p, library_ms=None,
                                   bound_ms=b, bound_by=kind, shape="M=4, H=4096")
    log(f"time rmsnorm_quant M=4 H=4096: {t_k:.4f} ms, plain {t_p:.4f}, "
        f"bound {b:.5f} ({kind})")

    # attention at the verify width: B=4, Q=4, contexts of 1-4 pages
    for q_len in (1, 4, 128):
        q, cache, tables, ctx = _attn_inputs(gen, q_len)
        t_k = graph_ms(lambda: paged_attention_cuda(q, cache.kv_pages, tables, ctx,
                                                    128 ** -0.5, layer=1))
        t_p = graph_ms(lambda: paged_attention_ref(q, cache, 1, tables, ctx, 128 ** -0.5),
                       reps=3)
        live = ctx.cpu().tolist()
        B, _, Hq, D = q.shape
        Hkv = cache.kv_pages.shape[3]
        kv_bytes = sum(live) * Hkv * D * 2 * 2
        nbytes = 2 * q.numel() * 2 + kv_bytes + tables.numel() * 4 + 8 * B
        # causal work: query i of a row sees ctx - Q + i + 1 positions
        seen = sum(sum(c - q_len + i + 1 for i in range(q_len)) for c in live)
        b, kind = bound_ms(nbytes, 4 * Hq * D * seen, "bf16")
        detail.append({"kernel": "paged_attention", "B": B, "Q": q_len, "ctx": live,
                       "ms": t_k, "plain_ms": t_p, "bound_ms": b, "bound_by": kind})
        log(f"time paged_attention B=4 Q={q_len} ctx={live}: {t_k:.4f} ms, "
            f"plain {t_p:.4f}, bound {b:.5f} ({kind})")
        if q_len == 4:
            report["paged_attention"].update(ms=t_k, plain_ms=t_p, library_ms=None,
                                             bound_ms=b, bound_by=kind,
                                             shape=f"B=4, Q=4, ctx={live}")


def phase_small_reference():
    """The tiny model on the card (kernels) against the same weights on the
    CPU (plain versions)."""
    from qspec_tpu_torch.config import ModelConfig
    from qspec_tpu_torch.models.llama import AttentionBatch, init_params, model_forward
    from qspec_tpu_torch.ops import kv_cache as kvc
    cfg = ModelConfig.tiny(lm_head_quant="bf16")
    cpu = init_params(cfg, seed=3, device="cpu")

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    gpu = to(cpu, "cuda")
    rng = np.random.default_rng(3)
    B, Q, S = 2, 24, 16
    toks = rng.integers(1, cfg.vocab_size, size=(B, Q))
    # relative L2 error of the logits; the quantized-activation schemes are
    # looser because rsqrt and sums round differently on the card and on the
    # CPU, which flips activations that sit on a quantizer rounding tie (see
    # tests/test_torch_model.py, which holds the port to the JAX package alike)
    for scheme, tol in (("w4a16", 2e-2), ("w4a8", 5e-2), ("w4a4", 0.3)):
        outs = []
        for dev, params in (("cpu", cpu), ("cuda", gpu)):
            cache = kvc.allocate(kvc.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                                   cfg.cache_head_dim, 8, S), dev)
            pos = torch.arange(Q, device=dev).repeat(B, 1)
            tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=dev)
            slot = tables.to(torch.int64).gather(1, pos // S) * S + pos % S
            batch = AttentionBatch(pos, slot, tables,
                                   torch.full((B,), Q, dtype=torch.int32, device=dev))
            logits, _ = model_forward(params, cfg, torch.tensor(toks, device=dev),
                                      cache, batch, scheme=scheme)
            outs.append(logits.float().cpu())
        ref, out = outs
        if out.shape != (B, Q, cfg.vocab_size) or not torch.isfinite(out).all():
            raise AssertionError(f"tiny {scheme}: bad logits {tuple(out.shape)}")
        rel = ((out - ref).norm() / ref.norm()).item()
        log(f"check tiny model_forward {scheme}: relative L2 error {rel:.3g} vs the "
            f"CPU plain versions (tol {tol}), max abs {(out - ref).abs().max().item():.3g}")
        if rel > tol:
            raise AssertionError(f"tiny {scheme} logits differ: relative L2 {rel} > {tol}")


def spec_vs_oracle(kw: dict, prompts, max_tokens: int):
    """Greedy generation through QSpec, then through the qspec_null oracle on
    the same weights; the launch counts are those of the QSpec run only."""
    from qspec_tpu_torch import LLM, SamplingParams
    from qspec_tpu_torch.ops import kernel_wrappers
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True)
    t0 = time.perf_counter()
    llm = LLM(**kw)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    spec = [o.output_token_ids for o in llm.generate(prompts, sp)]
    torch.cuda.synchronize()
    t_spec = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    m = llm.spec_metrics

    params = llm.llm_engine.runner.params
    del llm
    torch.cuda.empty_cache()
    oracle = LLM(params=params, speculative_method="qspec_null", **kw)
    t0 = time.perf_counter()
    ar = [o.output_token_ids for o in oracle.generate(prompts, sp)]
    torch.cuda.synchronize()
    t_ar = time.perf_counter() - t0

    log(f"e2e {kw['model']}: prompt lengths {[len(p) for p in prompts]}, "
        f"{max_tokens} greedy tokens each")
    log(f"e2e {kw['model']} qspec tokens: {spec}")
    log(f"e2e {kw['model']} oracle tokens: {ar}")
    if any(len(t) != max_tokens for t in spec) or spec != ar:
        raise AssertionError(f"{kw['model']}: greedy QSpec tokens differ from the "
                             "qspec_null oracle")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    n_tok = sum(len(t) for t in spec)
    return launches, {
        "acceptance_rate": m.draft_acceptance_rate,
        "emitted_per_round_per_seq": m.num_emitted_tokens / max(
            m.num_emitted_tokens - m.num_draft_accepted, 1),
        "qspec_tokens_per_s": n_tok / t_spec, "qspec_wall_s": t_spec,
        "oracle_tokens_per_s": n_tok / t_ar, "oracle_wall_s": t_ar,
        "init_s": t_init, "launches": launches}


def phase_tiny_end_to_end():
    """The tiny model through the engine on the card: drafts are accepted
    here, so bit-exactness is exercised on accepted positions too."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 500, size=int(rng.integers(5, 40))).tolist()
               for _ in range(4)]
    kw = dict(model="tiny", device="cuda", lm_head_quant="bf16",
              num_speculative_tokens=3, block_size=16, max_model_len=256,
              max_num_seqs=4, prefill_chunk_size=64, seed=0)
    _, summary = spec_vs_oracle(kw, prompts, 20)
    log("e2e tiny: greedy QSpec == oracle: " + json.dumps(summary))
    if summary["acceptance_rate"] <= 0:
        raise AssertionError("tiny model: no draft token was accepted")


def phase_end_to_end(smi: str):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 128000, size=int(n)).tolist()
               for n in rng.integers(64, 193, size=4)]
    kw = dict(model="llama3-8b", device="cuda", quantization="qspec",
              lm_head_quant="bf16", num_speculative_tokens=3, max_model_len=512,
              max_num_seqs=4, seed=0)
    torch.cuda.reset_peak_memory_stats()
    launches, summary = spec_vs_oracle(kw, prompts, 32)
    summary.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, card=smi)
    log("e2e llama3-8b: greedy QSpec == oracle, all kernels launched: "
        + json.dumps(summary))
    # random weights leave the W4A4 draft no agreement with the target at
    # this width; the W4A8 draft (same kernels, 8-bit activations) does
    # agree, which holds the invariant on accepted positions at full width
    _, w4a8 = spec_vs_oracle({**kw, "speculative_draft_scheme": "w4a8"}, prompts, 32)
    log("e2e llama3-8b, w4a8 draft: greedy QSpec == oracle: " + json.dumps(w4a8))
    if w4a8["acceptance_rate"] <= 0:
        raise AssertionError("llama3-8b w4a8 draft: no draft token was accepted")
    return launches, summary


KERNEL_META = {
    "matmul_w4a16": ("qspec_tpu_torch/csrc/w4a16.cu",
                     "qspec_tpu/ops/linear_kernels.py:139 (_w4a16_kernel)"),
    "matmul_w4a4": ("qspec_tpu_torch/csrc/w4a4.cu",
                    "qspec_tpu/ops/linear_kernels.py:160 (_w4a4_kernel)"),
    "rmsnorm": ("qspec_tpu_torch/csrc/rmsnorm.cu",
                "qspec_tpu/ops/rmsnorm_quant.py:78 (_rmsnorm_kernel)"),
    "rmsnorm_quant": ("qspec_tpu_torch/csrc/rmsnorm.cu",
                      "qspec_tpu/ops/rmsnorm_quant.py:68 (_rmsnorm_quant_kernel)"),
    "paged_attention": ("qspec_tpu_torch/csrc/paged_attention.cu",
                        "qspec_tpu/ops/attention_pallas.py:52 (_paged_attn_kernel)"),
}


def main():
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {name: {} for name in KERNEL_META}
    check_gemms(gen, report)
    check_norms(gen, report)
    check_attention(gen, report)
    detail = []
    time_kernels(gen, report, detail)
    phase_small_reference()
    phase_tiny_end_to_end()
    launches, _ = phase_end_to_end(smi)

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "tpu_kernel": replaces, "launches": launches[name],
            "max_abs_err": r["max_err"], "max_err": r["max_err"], "tol": r["tol"],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"], "card": smi})
    log("detail: " + json.dumps(detail))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
