"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --ab PARENT_DIR . . PARENT_DIR

The second form times, for each checkout named (a repository root), in
turns on one card, each in a process of its own with that checkout's
qspec_tpu_torch (its kernels built there): the paged-attention kernel at
AB_SHAPES (the verify shapes of the timing phase over bf16 and int8 caches,
D=256 with and without the softcap 50, context 8192 over bf16 and int8,
the window-128 decode at context 2048 and the same decode without it, the
tree verify at Q=15, BLOOM-7B1's ALiBi verify, the MLA kernel at MiniCPM3-4B's,
DeepSeek-V2-Lite's and DeepSeek-V3's verify over bf16 and int8, at
DeepSeek-V2-Lite's decode and at 4096 tokens a sequence over bf16) and at each of its 44
instantiations, then the grouped GEMM matmul_w4a16_g per layer of
Llama-3-8B and of Gemma-2-9B (its four projections, g = 128, weights made
by that checkout's model_loader.grouped) at M = 4, 16 and 60, then
matmul_w4a16 and matmul_w4a4 at W4_TIMED (per Llama-3-8B layer: w4a16 at
M = 16 and 60 and the int4 head at M = 16; w4a4 at M = 4, 8 and 1024),
then the norms at NORM_TIMED alone and after the residual add (for a
checkout whose norm takes no residual, the torch add and the norm in one
graph), then matmul_w8a16 at W8_AB (one Llama-3-8B trunk layer over int8
and fp8 weights at M = 4 and 16, its down projection alone, the int8 head
at M = 4, 16 and 60, Qwen1.5-MoE's and Qwen2-7B's heads at M = 4 and 16).
It prints, per AB_SHAPES entry, the times in the order given and the ratio of the
first checkout's mean to the second's, and a summary of the 44; every
checkout's JSON line (with its ptxas registers and spills) and the
per-instantiation times go to chiprun_out/chip_smoke.log. No result line.

Phases (any failure raises and the script exits non-zero, printing no result):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the CUDA kernels of qspec_tpu_torch (one nvcc process per
   source, all at once, then a link) and print the build seconds and the
   `-Xptxas -v` summary;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes of the main path, max error beside the stated tolerance (the
   attention kernel also over int8, fp8_e4m3 and fp8_e5m2 caches filled
   through update_layer, under a sliding window, and at head dim 256 with
   Gemma-2's logit softcap on every entry type, and under the Medusa tree
   mask on every entry type at head dims 128 and 256 (with and without the
   softcap and a window, the windowed tree rows also against AR, and the JAX
   kernel test's structural check), and ALiBi on every entry type at
   BLOOM-7B1's shapes and the JAX kernel test's GQA shape, and the tree rows
   at the main paths' rectangles also against the plain version that rounds
   where the Pallas body does; the norm with and without a gamma, and with
   and without the residual add at every NORM_TIMED shape (h bit for bit the
   torch add, a row's bits across M, place, a second call and graph
   replay); matmul_w4a16 and matmul_w4a4 (csrc/w4.cu) at the four
   Llama-3-8B projections, M = 4, 8, 16, 60, 64 and, w4a4 only, the draft
   prefill's 1024, w4a4 bit for bit equal to its plain version on int4 and
   int8 activations, and the int4 head (w4a16, f32 out, N = 128256); the
   int8 head (matmul_w8a16, csrc/w8a16.cu) at M = 16, the tree verify's 60
   and one block's 64, and a stacked trunk shape; the
   grouped GEMM at the Llama-3-8B and Gemma-2-9B AWQ
   shapes, M up to the prefill threshold, stacked and not, a row's bits
   across batch sizes and places, on a second call and on graph replay);
4. timing: each kernel, its plain version and (where one exists) the one
   PyTorch call that computes the same function, timed with CUDA events over
   CUDA-graph replays; the least time the card could take (bound_ms); the
   windowed attention at context 2048 beside the unwindowed kernel; the
   attention at Gemma-2-9B's verify shape (D=256) with and without softcap;
   the attention at context 8192 over bf16 and int8 caches and a prefill
   chunk (Q=512 on one row of context 512), where bytes set its bound;
   the tree-masked attention at the Llama-3-8B tree-verify rectangle (Q=15)
   beside the kernel without the tree; ALiBi at BLOOM-7B1's n-gram verify
   (Q=4, Hq=Hkv=32) beside the same inputs without it; matmul_w4a16 per
   Llama-3-8B layer at M = 16 and the tree verify's 60 and the int4 head,
   with torch._weight_int4pack_mm as its yardstick; matmul_w4a4 per layer at
   M = 4, 8 and the draft prefill's 1024, with torch._int_mm on the weights
   widened to int8 once, plus the scale epilogue (at M = 17 where it refuses
   smaller M);
   the int8 head at M = 4, 16 and 60 beside torch._weight_int8pack_mm;
   the grouped GEMM per Llama-3-8B and Gemma-2-9B layer at M = 4, 16 and 60
   beside the same yardstick; the norms at NORM_TIMED alone, with the
   residual add and as the torch add plus the norm, beside an empty kernel
   launched the same way (the launch floor) and F.rms_norm;
5. small-input reference: the tiny model's logits on the card (kernels) vs on
   the CPU (plain versions), same weights, with the bf16 head over a bf16
   cache, at the defaults (int8 head) over an int8 cache, and as an AWQ
   checkpoint (w4g, W4A16, int8 head) over a bf16 cache, and a tiny AWQ
   Gemma-2 (head dim 256, softcaps, post norms); then the tiny
   model through the engine on the card, QSpec against its oracle (drafts
   are accepted there), with the bf16 head and, at the defaults, once per
   8-bit KV cache, and once with a windowed W4A8 draft on its ring pool;
6. end to end: LLM(model="llama3-8b", num_speculative_tokens=3) with random
   weights made on the card, 4 prompts of 64-192 random token ids, 32 greedy
   tokens each, through QSpec and then through the qspec_null oracle (the
   same rounds with proposals nulled); tokens must be identical, and every
   kernel of the path, and no other, must have launched during the QSpec run
   (counts set to 0 just before it and read just after; the attention kernel
   is counted per instantiation; each norm kernel must have launched both
   with the residual add and, for each forward's first input norm, without
   it); then the same with the W4A8 draft,
   whose drafts are accepted at this width. Two paths: the first slice's
   (lm_head_quant="bf16", bf16 cache) and the JAX package's defaults (the
   int8 head by matmul_w8a16) with kv_cache_dtype="int8";
7. the AWQ slice: Llama-3-8B widths, 32 layers, an AWQ checkpoint (g = 128)
   made on the card from normal(0.02) weights (model_loader.grouped: the
   torch make_awq_tensors, then load_awq) with the int8 head, through
   LLMEngine with the same prompts, QSpec with the W4A16 draft (a) under
   draft_kv_window=64 on its ring pool and (b) with no window, each against
   its qspec_null oracle, and (a) again on a full draft pool, which must give
   the ring's tokens and draft counts; each QSpec run launches exactly the grouped GEMM,
   the gamma norm, the bf16-cache attention and the int8 head, and (b), whose
   draft is arithmetically the target but for the last prompt position,
   accepts more than half of its drafts;
8. the Gemma-2 slice: the same two runs on Gemma-2-9B's published widths
   (42 layers, hidden 3584, head dim 256, vocab 256000, softcaps 50 / 30,
   the alternating window of 4096, tied int8 head), every attention launch
   the D=256 instantiation with the softcap; then, on the same checkpoint,
   Medusa's candidate tree (4 lm_head-seeded heads, DEFAULT_TREE) against
   its medusa_null oracle, which must accept more than half its proposals;
9. the Medusa slice: LLM(model="llama3-8b", num_speculative_tokens=4,
   speculative_model="[medusa]") at the JAX package's defaults (int8 head,
   bf16 KV) with 4 lm_head-seeded heads made on the card, (c) the chain and
   (d) the tree (spec_medusa_tree="default"), each against its medusa_null
   oracle; each launches exactly matmul_w4a16, rmsnorm, the bf16 attention
   and the int8 head (no draft: no w4a4, no rmsnorm_quant), (d) the tree
   mask on layers x rounds attention launches and (c) on none;
10. the float slice: BLOOM-7B1 at its published widths, bf16 weights made
   on the card as a Hugging Face state dict and converted by convert_bloom,
   n-gram lookup (k = 3) through LLMEngine against its "null" oracle:
   tokens equal, only the bf16 attention launched, every launch ALiBi, 30
   per forward (phase_bloom_7b1);
11. an MPT-7B-width checkpoint directory (2 layers) written by the script
   and served by LLM(model=<dir>, quantization=None), n-gram against AR
   (phase_mpt_dir);
12. real-weights loaders, (A): a Hugging Face Llama float state dict at
   meta-llama/Meta-Llama-3-8B's widths (random bf16 made on the card, norm
   gammas 1 + 0.1 N(0, 1)) rotated and quantized on the card by
   quantize_float (seconds and peak GiB printed), then QSpec (k = 3) at W4A4
   and W4A8 through LLMEngine against qspec_null, exactly the QuaRot
   kernels launched (phase_quarot_float_8b);
13. (B) that model verifying a separate draft at bench.py's "1b" widths
   (16 layers, hidden 2048), made and quantized the same way, drafting at
   W4A4 on its own KV pool: tokens == the oracle's, the kernel set exact,
   the draft's forwards counted on its own layers (phase_draft_1b);
14. (C) forced acceptance (force_accept_len=3, k = 3) on (A)'s model: every
   round of every sequence emits 4 tokens short of the budget; tok/s beside
   qspec_null's, no token claim (phase_forced_8b);
15. (D) LLM(model=<dir>) on directories written by the script at
   Meta-Llama-3-8B's widths cut to 2 layers: a float directory in bf16
   (quantization=None), n-gram == AR; the same directory quantized at load,
   QSpec == oracle; a reference-format QSpec directory written from (A)'s
   layers 0-1, which loads to (A)'s packed tensors bit for bit, QSpec ==
   oracle (phase_llama_dirs);
16. the proposers (phase_proposers_8b): (E1) EAGLE at Llama-3-8B width
   through LLM(speculative_model="[eagle]") at the defaults (int8 head,
   bf16 KV, k = 3) with a random EAGLE net made on the card, greedy tokens
   == the same target's AR tokens; (E2) MLPSpeculator
   (speculative_model="[mlp_speculator]", a random net made on the card) ==
   its medusa_null oracle; each launches exactly matmul_w4a16, the int8
   head, rmsnorm (EAGLE's layer with a gamma too) and the bf16 attention,
   in the counts its target forwards and EAGLE's layer passes give (the
   kernel line's ``proposer_launches``: [E1, E2]);
17. the sparse MoE (G), the 8B phases' parameters released first:
   matmul_w4a16 / matmul_w4a4 at Qwen1.5-MoE-A2.7B's expert, shared-expert
   and qkv shapes (K = 1408 among them) and the int8 head at its vocab,
   M = 4 and 16, against their plain versions (w4a4 bit for bit), through
   an expert-stacked weight read in place, and timed beside their
   yardsticks (check_moe_shapes, time_moe_shapes); (G1) Mixtral-8x7B at
   full width and MIXTRAL_LAYERS of its 32 layers (random int4 weights
   made on the card) and (G2)
   Qwen1.5-MoE-A2.7B's widths at QWEN15_LAYERS layers through LLMEngine,
   QSpec (k = 3) at W4A4 and W4A8 / W4A8 == qspec_null, exactly the six
   QuaRot kernels in the counts check_moe_counts gives; (G3) Mixtral,
   Qwen2-MoE and Qwen3-MoE directories (2 layers) quantized at load, W4A4
   QSpec == qspec_null, and a DeepSeek-MoE directory in bf16, n-gram ==
   null (the kernel line's ``moe_launches``; the MoE shapes' times in the
   log);
18. the dense families (H), the MoE phases' parameters released first:
   every kernel at the shapes they bring (the attention at Qwen2-7B's GQA
   group 7, Q = 1, 2, 4, to context 8192; matmul_w4a16 / matmul_w4a4 (bit
   for bit) / the grouped GEMM at one Qwen2-7B layer's projections, K up to
   18944 and N up to 37888; both norms at H = 3584 and 3072; the int8 head
   at DENSE_HEADS, Granite's 49155 columns padded at load) against its
   plain version, and timed at Qwen2-7B's shapes beside its library call
   and bound (check_dense_shapes, time_dense_shapes); (H1)
   LLM(model=<Qwen2-7B's config.json dir>, params=...) at full width and
   H1_LAYERS of its 28 layers, random int4 weights made on the card, QSpec
   (k = 3) at W4A4 and W4A8 == qspec_null in
   check_moe_counts' exact counts (phase_qwen2_7b); (H2) Qwen2.5-7B,
   Qwen3-8B, Mistral-7B-v0.1, Gemma-7B, Phi-3-mini-128k-instruct and
   Granite-3.0-8B directories (their published config.json fields at 2
   layers, random bf16 written here) quantized at load, W4A4 QSpec ==
   qspec_null (phase_dense_dirs); (H3) a qwen2_quarot QSpec-format
   directory with its q/k/v biases and a QuarotLlamaForCausalLM one,
   written from (H2)'s parameters and loading to them bit for bit, and an
   AWQ directory at Qwen2-7B's widths routed by its quant_method, each ==
   its oracle (phase_quarot_dirs; the kernel line's ``dense_launches``);
19. the llama graph under other key names and the float families (J): the
   attention at Qwen-7B's MHA, Falcon-7B's 71 query heads over one KV head
   and Falcon-40B's group 16 at D=64 (stored 128-padded), ALiBi at 40 heads
   and at falcon-rw's D=64; matmul_w4a16 / matmul_w4a4 at one Qwen-7B
   layer (K = 11008); the int8 head at J_HEADS, against their plain
   versions, and timed (check_remap_shapes, time_remap_shapes; the kernel
   line's ``j_times``); (J1) InternLM2.5-7B at full width, J1_LAYERS of its
   32 layers, random
   bf16 made on the card in InternLM2's keys, remapped and quantized by
   quantize_float there, LLM(model=<config.json dir>, params=...), QSpec
   (k = 3) at W4A4 and W4A8 == qspec_null in check_moe_counts' counts
   (phase_internlm2_7b); (J2) Baichuan-7B, Baichuan2-7B, Qwen-7B,
   EXAONE-3.0-7.8B and TeleChat2-7B directories (published widths, 2
   layers, their own keys) remapped and quantized at load, W4A4 QSpec ==
   qspec_null (phase_remap_dirs); (J3) Baichuan2-13B, JAIS-13B,
   falcon-rw-7b, Falcon-7B and Falcon-40B directories in bf16, n-gram ==
   null, Baichuan2-13B refused under QuaRot by its width
   (phase_float_dirs; the kernel line's ``remap_launches``);
20. the gptj rope and partial rotary (K): the attention at K_ATTN (GPT-J's
   16 heads of 256, GPT-NeoX-20B's 64 of 96 and Phi-2's 32 of 80, both
   stored 128-padded, Command-R's 64 of 128, GLM-4's group 16) and the
   gamma rmsnorm at Helium's H = 2560 and GLM-4's 4096, alone and with the
   residual add, against their plain versions, and timed at GPT-J-6B's and
   GPT-NeoX-20B's verify and Helium's (check_k_shapes, time_k_shapes; the
   kernel line's ``k_max_err`` and ``k_times``); (K1)
   GPT-J-6B at full width and depth, random bf16 made on the card in GPT-J's
   keys, converted by load_family_float there, n-gram (k = 3) == null, only
   the D=256 attention launched, 28 a forward (phase_gptj_6b); (K2)
   Pythia-6.9B, GPT-NeoX-20B, Phi-2, StableLM-2-1.6B, Command-R v01,
   GLM-4-9B and Helium directories (published widths, 2 layers, their own
   keys) through LLM(model=<dir>, quantization=None), n-gram == null, and
   the refused layouts raising before a weight is read (phase_k_dirs; the
   kernel line's ``k_launches``);
21. the engine surface (L), run after (I) on (A)'s parameters (int8 head,
   bf16 KV, QSpec k = 3, W4A8 draft), against (A)'s W4A8 tokens
   (phase_engine_surface_8b): (L1) a LoRA bank of 3 slots at rank 16, two
   PEFT adapters made on the card (q/k/v/o/gate/up/down, rotated into (A)'s
   recorded QuaRot basis), one loaded by ``engine.lora.load``, one by
   ``load_path`` from a directory written here; prompts on slots 0, a, b, a
   == qspec_null, slot 0 == (A), each adapter row unlike (A)'s, exactly
   qspec_launches' counts (the kernel line's ``lora_launches``); (L2) swap
   preemption in an 8-page pool over bf16 and int8 KV, on (A)'s first
   L_SWAP_LAYERS layers, == the same engine with pages to spare,
   sequences swapped out and in; recompute mode and a 0 GiB swap pool ==
   each other and == the unconstrained run up to the preemption; (L3) a soft prompt of 8 rows == the same rows given as
   ``prompt_embeds``, == qspec_null; (L4) ``LLM.beam_search`` (width 4, 8
   tokens, 2 prompts): distinct sorted beams, each cumulative logprob within
   L_BEAM_TOL of a teacher-forced re-scoring; (L5) the LoRA routes over HTTP
   (load, a completion whose ``model`` names the adapter, unload) ==
   ``LLM.generate(lora_name=)``;
22. compressed-tensors and GGUF (M): matmul_w8a16 over int8 and fp8
   weights at Llama-3-8B's four trunk shapes (a 2-layer stack, M = 4, 16,
   60 and 64) and the fp8 head shape against the plain version, all 256
   e4m3 codes, a row's bits across M (to the prefill threshold) and place,
   the torch.mm branch past BIGM_BYTES (M = 1024 at K = 4096, 256 at
   14336), and the trunk timed per layer and its down projection alone
   beside torch._weight_int8pack_mm (int8; fp8 has no library call)
   (check_w8a16_trunk, time_w8a16_trunk); (M1) Llama-3-8B at full width and
   depth as a compressed-tensors int8 checkpoint made on the card
   (make_ct_state_dict, load_compressed_tensors), QSpec with the W4A16
   draft (a) under a window of 64 on its ring pool and (b) without, each
   == qspec_null, exactly CT_KERNELS, (b) accepting more than half; (M2)
   the same checkpoint as fp8, (a): every trunk launch the fp8
   instantiation, the int8 counter the head's alone; (M3) induction_lm_v2
   through M3_LOADERS (ct int8, fp8, pack-quantized g = 128, a GGUF Q4_0
   file) with the trained induction_eagle_v1 net: QSpec (windowed W4A16,
   k = 3) == qspec_null and EAGLE (k = 4) == AR, the counts printed beside
   the CPU's (M3_CPU); (M4) at 8B widths, 2 layers, a GGUF Q4_0 file (g =
   32) and a compressed-tensors fp8 directory through LLM(model=<dir>),
   each == qspec_null, the directory's replies == the state-dict route's
   (phase_ct_8b, phase_ct_induction, phase_ct_dirs; the kernel line's
   ``ct_launches``);
23. multi-head latent attention (N): the attention kernel's MLA
   instantiations (head dims 384 and 640, each KV entry type) at
   MiniCPM3-4B's 40, DeepSeek-V2-Lite's 16 and DeepSeek-V3's 128 query
   heads over one latent row, Q = 1, 4 and 64, and the gamma rmsnorm at
   the MLA widths (hidden 2560 / 2048 / 7168, latents 768 / 1536 / 256 /
   512) against their plain versions, and the attention timed at the
   verify over every KV type (check_mla_shapes, time_mla_shapes; the
   kernel line's ``mla_max_err`` and ``mla_times``); (N1) MiniCPM3-4B at
   full width and depth (62 layers, q-LoRA, the muP scales, the tied head),
   random bf16 made on the card in its own keys, converted by
   load_family_float there, greedy n-gram (k = 3) == greedy AR over a bf16
   and an int8 latent cache; (N2) DeepSeek-V2-Lite at full width, N2_LAYERS
   of its 27 layers (the dense first, 3 MoE layers of 64 experts), the
   same; (N3) LLM(model=<dir>, quantization=None) on 2-layer
   DeepSeek-V2-Lite and MiniCPM3-4B directories, the same, the default
   quantization refused before a weight is read; each run launches exactly
   the gamma rmsnorm and the attention instantiation of its cache, every
   attention launch at the latent head dim (mla_run; the kernel line's
   ``mla_launches``).

It prints the kernel summary as one JSON line (each kernel's summary
fields, its times at Qwen2-7B's shapes, ``qwen2_7b``, at (J)'s, ``j_times``,
at (K)'s, ``k_times``, and at (N)'s, ``mla_times``: ms, plain ms, bound
ms, library ms) and, last,
the device JSON line. Every line also
goes to chiprun_out/chip_smoke.log, which alone has the per-case detail the
standard output gives in short (the kernels line with every field and its
launches in the paths of phases 12-23, the kernels' full `-Xptxas -v`
summary, each tiny forward check, each long attention check, each
grouped-GEMM shape's time).
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
L2_BYTES = 50 * 1024 * 1024


# every line also goes to chiprun_out/chip_smoke.log beside the script, for
# a runner that keeps only the end of the standard output
_LOG = []


def log(*a, stdout: bool = True):
    if stdout:
        print(*a, flush=True)
    for f in _LOG:
        print(*a, file=f, flush=True)


# the seconds each step of main took, in order (the log's "steps (s)" line)
_STEPS = {}
_STEP_T = [time.perf_counter()]


def step(name: str) -> None:
    """Close the step ``name``: the seconds since the previous one."""
    now = time.perf_counter()
    _STEPS[name] = round(now - _STEP_T[0], 1)
    _STEP_T[0] = now


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


def _kernel_name(mangled: str) -> str:
    """A kernel's name unmangled as far as a reader needs:
    name<template args>, e.g. paged_attention_kernel<bfloat16,0,256,1> (entry
    type, scaled, head dim, softcap)."""
    m = re.search(r"_cu_[0-9a-f]{8}\d+?([a-z]\w*?_kernel)(?:I(\w+?)EE)?", mangled)
    if not m:
        return mangled
    args = re.sub(r"^a(?=L)", "int8", re.sub(r"^\d+__nv_", "", m.group(2) or ""))
    args = re.sub(r"E?L[bi](\d+)", r",\1", args).lstrip(",")
    return m.group(1) + (f"<{args}>" if args else "")


def attention_smem(entry: int, scaled: bool, D: int) -> int:
    """Bytes of dynamic shared memory a block of csrc/paged_attention.cu
    takes (its Smem<T, kD, kScaled>::kBytes): a ring of 16-token K and V
    slices per warp (2 stages at D=128, 3 at 256), the widened bf16 V slice
    of 8-bit entries, the scales, the warps' P.V dump (aliasing them), the
    query tile and, at D=256, the fold."""
    stages = 2 if D == 128 else 3
    ring = 4 * stages * 2 * 16 * D * entry
    pipe = (ring + (4 * 16 * D * 2 if entry == 1 else 0)
            + (4 * stages * 2 * 16 * 4 if scaled else 0))
    dump = 4 * 16 * (D + 8) * 4 + 2 * 4 * 16 * 4
    return max(pipe, dump) + 16 * D * 2 + (0 if D == 128 else 16 * D * 4)


def phase_build():
    from qspec_tpu_torch import _build
    t0 = time.perf_counter()
    _build.lib()
    per = _build.build_info.get("compile_seconds", {})
    log(f"build: per object {json.dumps(per)}", stdout=False)
    slowest = max(per, key=per.get) if per else None
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_info['seconds']:.2f} s, "
        f"{len(per)} objects, the slowest {slowest} {per.get(slowest, 0):.2f} s)")
    # registers (r), spilled bytes (s) and static shared memory per kernel;
    # attn<entry, scaled, head dim, softcap, tree, alibi> is
    # paged_attention_kernel; in full to the log file, in short to stdout
    short = {}
    for fn, v in _build.build_info.get("ptxas", {}).items():
        name = _kernel_name(fn).replace("paged_attention_kernel", "attn").replace(
            "bfloat16", "bf16")
        short[name] = f"{v.get('regs')}r" + (
            f" {v['spill_stores']}s" if v.get("spill_stores") else "") + (
            f" smem {v['smem']}" if v.get("smem") else "")
    log("ptxas: " + json.dumps(short, separators=(",", ":")), stdout=False)
    attn = {k: v for k, v in short.items() if k.startswith("attn")}
    # the attention instantiations one a line, with the dynamic shared
    # memory a block takes (csrc/paged_attention.cu: Smem<T, kD, kScaled>)
    for name, v in sorted(attn.items()):
        entry, scaled, D = name[5:-1].split(",")[:3]
        log(f"ptxas {name}: {v}, dynamic smem "
            f"{attention_smem(1 if entry != 'bf16' else 2, scaled == '1', int(D))} bytes",
            stdout=False)
    regs = sorted(int(v.split("r")[0]) for v in attn.values())

    def spills(v: str) -> bool:      # "<regs>r <bytes>s ...": a spill entry
        return re.search(r" \d+s\b", v) is not None
    # the instantiations of the grouped GEMM <m16 tiles, N % 4 == 0>, of
    # csrc/w4.cu <int8, m16 tiles, N % 4 == 0, whole mode>, of csrc/w8a16.cu
    # <fp8, m16 tiles, N % 16 == 0, whole mode>, of the norm <quant, gamma,
    # residual, vectors a thread>, of the MLA attention <entry type, scaled,
    # head dim> and of the split merge <head dim> in one entry each
    groups = ("w4a16_g", "w4_kernel", "w8a16_kernel", "rmsnorm_kernel",
              "paged_attention_mla_kernel", "paged_attention_merge_kernel")
    rest = {k: v for k, v in short.items() if not k.startswith(("attn", "w4_", *groups))}
    for prefix in groups:
        group = {k: v for k, v in short.items() if k.startswith(prefix)}
        if group:
            g_regs = sorted(int(v.split("r")[0]) for v in group.values())
            rest[f"{prefix} x{len(group)}"] = f"{g_regs[0]}-{g_regs[-1]}r" + (
                " spills" if any(spills(v) for v in group.values()) else "")
    log(f"ptxas: {len(short)} kernels ({len(attn)} attention, {regs[0]}-{regs[-1]} registers; "
        f"spills {json.dumps({k: v for k, v in attn.items() if spills(v)})}); "
        + json.dumps(rest, separators=(",", ":")))


def _w4(gen, k, n):
    from qspec_tpu_torch.ops.packing import quantize_weight_int4_torch
    return quantize_weight_int4_torch(torch.randn(k, n, generator=gen, device="cuda") * 0.02)


GEMM_SHAPES = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))


def check_gemms(gen, gen_w4, report):
    """matmul_w4a16 and matmul_w4a4 (csrc/w4.cu) at the four Llama-3-8B
    projections: w4a16 at M = 4, 8, 16, 60, 64 within the JAX tests'
    tolerance, w4a4 bit for bit equal to its plain version at the same M and
    the draft prefill's 1024, on int4 and int8 activations; then the int4
    head (w4a16, f32 out, N = 128256) at M = 4 and 16. The inputs at M = 4,
    16 and 60 come from ``gen`` as in the checks before M = 8, 64 and 1024
    were added; those and the head's from ``gen_w4``, so the later phases'
    inputs do not change with them."""
    from qspec_tpu_torch.ops import linear_kernels as lk
    from qspec_tpu_torch.ops.quant import sym_quant_int4, sym_quant_int8
    err16 = err4 = 0.0
    for k, n in GEMM_SHAPES:
        qw, qs = _w4(gen, k, n)
        xs = {m: torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
              for m in (4, 16, 60)}
        x = torch.randn(1024, k, generator=gen_w4, device="cuda").to(torch.bfloat16)
        xs.update({m: x[:m] for m in (8, 64, 1024)})
        for m in (4, 8, 16, 60, 64, 1024):
            x = xs[m]
            if m <= 64:
                out = lk.matmul_w4a16(x, qw, qs)
                ref = lk.matmul_w4a16_ref(x, qw, qs)
                torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
                err16 = max(err16, (out.float() - ref.float()).abs().max().item())
            for xq in (sym_quant_int4(x), sym_quant_int8(x)):
                out = lk.matmul_w4a4(xq.values, xq.scales, qw, qs)
                ref = lk.matmul_w4a4_ref(xq.values, xq.scales, qw, qs)
                if not torch.equal(out, ref):
                    raise AssertionError(f"matmul_w4a4 K={k} N={n} M={m}: not bit-equal to "
                                         f"its plain version (max abs err "
                                         f"{(out.float() - ref.float()).abs().max().item():.3g})")
                err4 = max(err4, (out.float() - ref.float()).abs().max().item())
        del qw, qs, x
    _, k, n = HEAD_SHAPE
    qw, qs = _w4(gen_w4, k, n)
    x = torch.randn(16, k, generator=gen_w4, device="cuda").to(torch.bfloat16)
    err_h = 0.0
    for m in (4, 16):
        out = lk.matmul_w4a16(x[:m], qw, qs, out_dtype=torch.float32)
        ref = lk.matmul_w4a16_ref(x[:m], qw, qs, out_dtype=torch.float32)
        torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
        err_h = max(err_h, (out - ref).abs().max().item())
    del qw, qs, out, ref
    torch.cuda.empty_cache()
    report["matmul_w4a16"].update(max_err=max(err16, err_h), head_max_err=err_h,
                                  tol="rtol=atol=2e-2")
    report["matmul_w4a4"].update(max_err=err4, tol="bit-equal (torch.equal)")
    log(f"check matmul_w4a16: max_abs_err {err16:.3g} (tol rtol=atol=2e-2; M in 4,8,16,60,64); "
        f"int4 head M=4,16 K,N={HEAD_SHAPE[1:]} f32 out {err_h:.3g}")
    log(f"check matmul_w4a4: bit-equal to its plain version (M in 4,8,16,60,64,1024; int4 and "
        "int8 activations)")


HEAD_SHAPE = (16, 4096, 128256)     # verify width M x hidden x vocab
TRUNK_STACK = (2, 4096, 14336)      # L x K x N of a stacked W8A16 trunk


def _w8(gen, k, n, layers=None):
    from qspec_tpu_torch.ops.packing import quantize_weight_int8_torch
    if layers is None:
        return quantize_weight_int8_torch(torch.randn(k, n, generator=gen, device="cuda") * 0.02)
    qw = torch.empty(layers, k, n, dtype=torch.int8, device="cuda")
    qs = torch.empty(layers, n, device="cuda")
    for li in range(layers):
        qw[li], qs[li] = quantize_weight_int8_torch(
            torch.randn(k, n, generator=gen, device="cuda") * 0.02)
    return qw, qs


def check_w8a16(gen, report):
    """The int8 head at its shape (f32 out) at the verify's M = 16 and,
    from a generator of their own (``gen`` draws what it drew before they
    were added), the tree verify's 60 and one block's 64 rows; a stacked
    trunk shape (bf16 out); at the JAX test's tolerance."""
    from qspec_tpu_torch.ops import linear_kernels as lk
    m, k, n = HEAD_SHAPE
    qw, qs = _w8(gen, k, n)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    x64 = torch.randn(64, k, generator=torch.Generator(device="cuda").manual_seed(11),
                      device="cuda").to(torch.bfloat16)
    err = 0.0
    for xm in (x, x64[:60], x64):
        out = lk.matmul_w8a16(xm, qw, qs, out_dtype=torch.float32)
        ref = lk.matmul_w8a16_ref(xm, qw, qs, out_dtype=torch.float32)
        torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
        err = max(err, (out - ref).abs().max().item())
    del qw, qs, out, ref
    L, k, n = TRUNK_STACK
    qw, qs = _w8(gen, k, n, layers=L)
    for li in range(L):
        out = lk.matmul_w8a16(x, qw, qs, layer_idx=li)
        ref = lk.matmul_w8a16_ref(x, qw[li], qs[li])
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
        err = max(err, (out.float() - ref.float()).abs().max().item())
    report["matmul_w8a16"].update(max_err=err, tol="rtol=atol=2e-2")
    log(f"check matmul_w8a16: max_abs_err {err:.3g} (tol rtol=atol=2e-2; head "
        f"M=16,60,64 K,N={HEAD_SHAPE[1:]} f32 out, stacked L,K,N={TRUNK_STACK} bf16 out)")


GROUP = 128                         # AWQ / GPTQ group size of the 8B checkpoint


def _w4g(gen, k, n, layers=None, group=GROUP):
    """AWQ weights made on the card (model_loader.grouped's torch writer),
    unpacked and repacked by the loader: packed int4, f32 scales and offsets
    per (group, column); layer-stacked when ``layers`` is given."""
    from qspec_tpu_torch.model_loader import grouped as tg

    def one():
        t = tg.make_awq_tensors(torch.randn(k, n, generator=gen, device="cuda") * 0.02, group)
        return tg.pack_grouped_proj(*tg.unpack_awq(t["qweight"], t["qzeros"], t["scales"]))
    ps = [one() for _ in range(layers or 1)]
    return tuple(torch.stack([p[key] for p in ps]) if layers else ps[0][key]
                 for key in ("qw", "qs_g", "qo_g"))


# Gemma-2-9B's projections: qkv, o, gate_up, down
GEMMA_SHAPES = ((3584, 8192), (4096, 3584), (3584, 28672), (14336, 3584))


def _max_kernel_m(k: int) -> int:
    """The largest M the grouped GEMM takes at K before its prefill branch."""
    from qspec_tpu_torch.ops import linear_kernels as lk
    return max(m for m in range(1, 4096) if not lk._bigm(m, k))


def _replay_bits(fn) -> bool:
    """Whether ``fn()``, captured in a CUDA graph, replays (twice) to the
    bits of an eager call."""
    eager = fn()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    same = True
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same = same and torch.equal(out, eager)
    return same


def check_w4a16_g(gen, report):
    """The grouped GEMM at the four Llama-3-8B and the four Gemma-2-9B
    projections, M = 4, 16, 60 and the largest M before the prefill branch
    (640 at K = 4096, 176 at 14336), plain and stacked (2 layers, Llama), at
    the JAX test's tolerance; a row's bits at M = 1, 4, 16, 60, 64, a middle
    slice and the reversed batch equal the prefill-size call's; the same
    bits on a second call and on CUDA-graph replay; the prefill branch once."""
    from qspec_tpu_torch.ops import linear_kernels as lk
    err = 0.0
    for k, n in GEMM_SHAPES + GEMMA_SHAPES:
        llama = (k, n) in GEMM_SHAPES
        qw, qs, qo = _w4g(gen, k, n, layers=2)
        mbig = _max_kernel_m(k)
        x = torch.randn(mbig, k, generator=gen, device="cuda").to(torch.bfloat16)
        for m in (4, 16, 60, mbig):
            for li in ((None, 1) if llama else (1,)):
                w = (qw[1], qs[1], qo[1]) if li is None else (qw, qs, qo)
                out = lk.matmul_w4a16_g(x[:m], *w, layer_idx=li)
                ref = lk.matmul_w4a16_g_ref(x[:m], qw[1], qs[1], qo[1])
                torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
                err = max(err, (out.float() - ref.float()).abs().max().item())
        full = lk.matmul_w4a16_g(x, qw, qs, qo, layer_idx=0, out_dtype=torch.float32)
        if not torch.equal(lk.matmul_w4a16_g(x, qw, qs, qo, layer_idx=0,
                                             out_dtype=torch.float32), full):
            raise AssertionError(f"matmul_w4a16_g K={k} N={n}: two calls differ")
        for rows in (slice(0, 1), slice(0, 4), slice(0, 16), slice(0, 60), slice(0, 64),
                     slice(5, 9), slice(mbig // 2, mbig // 2 + 60)):
            if not torch.equal(lk.matmul_w4a16_g(x[rows].contiguous(), qw, qs, qo, layer_idx=0,
                                                 out_dtype=torch.float32), full[rows]):
                raise AssertionError(f"matmul_w4a16_g K={k} N={n}: a row's bits depend on M")
        if not torch.equal(lk.matmul_w4a16_g(x.flip(0).contiguous(), qw, qs, qo, layer_idx=0,
                                             out_dtype=torch.float32), full.flip(0)):
            raise AssertionError(f"matmul_w4a16_g K={k} N={n}: a row's bits depend on its place")
        for m in (4, 16, 60):
            if not _replay_bits(lambda m=m: lk.matmul_w4a16_g(x[:m], qw, qs, qo, layer_idx=1)):
                raise AssertionError(f"matmul_w4a16_g K={k} N={n} M={m}: graph replay differs")
    # the prefill branch on the last shape's layer 0
    xb = torch.randn(1024, k, generator=gen, device="cuda").to(torch.bfloat16)
    before = lk.matmul_w4a16_g.launches
    out = lk.matmul_w4a16_g(xb, qw[0], qs[0], qo[0])
    if lk.matmul_w4a16_g.launches != before:
        raise AssertionError("matmul_w4a16_g at M=1024 launched the kernel")
    ref = lk.matmul_w4a16_g_ref(xb, qw[0], qs[0], qo[0])
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    report["matmul_w4a16_g"].update(max_err=err, tol="rtol=atol=2e-2")
    log(f"check matmul_w4a16_g: max_abs_err {err:.3g} (tol rtol=atol=2e-2; g={GROUP}, Llama and "
        f"Gemma-2 projections, M 4/16/60/pre-prefill, stacked and not); row bits independent of "
        f"M and place, equal on a 2nd call and graph replay; prefill branch (M=1024, no launch) "
        f"max_abs_err {(out.float() - ref.float()).abs().max().item():.3g}")


def _int4pack(qw, qs, qo):
    """The same grouped weights for torch._weight_int4pack_mm (the
    yardstick): w = (q - 8) * s + (8 s - o), nibbles two to a byte along K
    ([N, K/2] uint8, even k high), scales and zeros bf16 [K/g, N, 2]."""
    from qspec_tpu_torch.ops.packing import unpack_int4
    q = (unpack_int4(qw).to(torch.int32) + 8).t().contiguous()          # [N, K]
    packed = torch._convert_weight_to_int4pack(
        (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8), 8)
    sz = torch.stack([qs, 8 * qs - qo], dim=-1).to(torch.bfloat16).contiguous()
    return packed, sz


def _int4pack_w4(qw, qs):
    """QuaRot weights ((q - 8) * s per column) for torch._weight_int4pack_mm:
    the column scale repeated over groups of 128, zero 0 (o = 8 s)."""
    qs_g = qs[None].expand(qw.shape[0] * 8 // GROUP, -1).contiguous()
    return _int4pack(qw, qs_g, 8 * qs_g)


def check_int4pack(gen):
    """Whether torch._weight_int4pack_mm runs here and computes the grouped
    GEMM (bf16 scales and zeros: a relative L2 within 2e-2 of the plain
    version); the reason when not."""
    from qspec_tpu_torch.ops import linear_kernels as lk
    k, n = GEMM_SHAPES[1]
    try:
        qw, qs, qo = _w4g(gen, k, n)
        x = torch.randn(16, k, generator=gen, device="cuda").to(torch.bfloat16)
        packed, sz = _int4pack(qw, qs, qo)
        out = torch._weight_int4pack_mm(x, packed, GROUP, sz).float()
    except (AttributeError, TypeError, RuntimeError, NotImplementedError) as e:
        return f"torch._weight_int4pack_mm unavailable: {type(e).__name__}: {str(e)[:160]}"
    ref = lk.matmul_w4a16_g_ref(x, qw, qs, qo).float()
    rel = ((out - ref).norm() / ref.norm()).item()
    # the same call on QuaRot weights, the matmul_w4a16 row's yardstick
    qw, qs = _w4(gen, k, n)
    packed, sz = _int4pack_w4(qw, qs)
    out = torch._weight_int4pack_mm(x, packed, GROUP, sz).float()
    ref = lk.matmul_w4a16_ref(x, qw, qs).float()
    rel4 = ((out - ref).norm() / ref.norm()).item()
    log(f"check torch._weight_int4pack_mm (yardstick): relative L2 {rel:.3g} vs the grouped "
        f"plain version, {rel4:.3g} vs matmul_w4a16_ref (tol 2e-2: bf16 scales and zeros)")
    if max(rel, rel4) > 2e-2:
        return f"torch._weight_int4pack_mm disagrees (relative L2 {rel:.3g}, {rel4:.3g})"
    return None


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
    # the gamma form, which the w4g path launches (its input, post and final
    # norms), at the draft's and the verify's M
    e_g = 0.0
    for m in (4, 16):
        x = (torch.randn(m, 4096, generator=gen, device="cuda") * 3).to(torch.bfloat16)
        g = (1 + 0.1 * torch.randn(4096, generator=gen, device="cuda")).to(torch.bfloat16)
        out, ref = rq.rmsnorm(x, g), rq.rmsnorm_ref(x, g)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
        e_g = max(e_g, (out.float() - ref.float()).abs().max().item())
    report["rmsnorm"].update(max_err=max(e_n, e_g), gamma_max_err=e_g, tol="rtol=atol=2e-2")
    report["rmsnorm_quant"].update(
        max_err=float(e_q), tol="int values within 1, >99% exact; scales rtol 1e-3")
    log(f"check rmsnorm: max_abs_err {e_n:.3g}, with a gamma (M=4, 16) {e_g:.3g} "
        "(tol rtol=atol=2e-2)")
    log(f"check rmsnorm_quant: int values max diff {e_q} (tol 1), exact share "
        f">= {worst_exact:.5f} (tol > 0.99); scale max rel err {e_s:.3g} (tol 1e-3)")


# the norms' timed and checked shapes, (wrapper, M, H, bits, gamma):
# rmsnorm_quant at the draft's M = 4, the backfill step's 8 and the draft
# prefill's 1024, bits 4 (W4A4) and 8 (W4A8); the weightless rmsnorm at
# the draft step's final norm (4), the verify's 16, the tree verify's 60
# and a prefill's 512; with a gamma at Gemma-2-9B's H = 3584, its draft's
# and verify's M
NORM_TIMED = (*(("rmsnorm_quant", m, 4096, b, False) for m in (4, 8, 1024) for b in (4, 8)),
              *(("rmsnorm", m, 4096, None, False) for m in (4, 16, 60, 512)),
              ("rmsnorm", 4, 3584, None, True), ("rmsnorm", 16, 3584, None, True))


def norm_label(name, m, h, bits, gamma) -> str:
    kind = f"quant{bits}" if name == "rmsnorm_quant" else ("gamma" if gamma else "rmsnorm")
    return f"{kind}_m{m}_h{h}"


def _norm_set(gen, m, h):
    """x (3 x normal) and a residual (normal), bf16 [m, h]."""
    x = (torch.randn(m, h, generator=gen, device="cuda") * 3).to(torch.bfloat16)
    return x, torch.randn(m, h, generator=gen, device="cuda").to(torch.bfloat16)


def _gamma(gen, h):
    return (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(torch.bfloat16)


def _norm_rot(gen, m, h) -> Rotating:
    """(x, residual) sets, rotated past L2 at M >= 512 (two sets, both in
    L2, below: where a decode-sized norm finds its inputs)."""
    return Rotating(lambda: _norm_set(gen, m, h), 2 * m * h * 2 if m >= 512 else 2 * L2_BYTES)


def _norm_wrapper(name, bits, gamma, ref=False):
    """The checkout's norm wrapper (``ref``: its plain version) of ``name``
    and its keyword arguments."""
    from qspec_tpu_torch.ops import rmsnorm_quant as rq
    if name == "rmsnorm_quant":
        return (rq.rmsnorm_quant_ref if ref else rq.rmsnorm_quant), {"bits": bits}
    return (rq.rmsnorm_ref if ref else rq.rmsnorm), {"gamma": gamma}


def norm_fn(name, bits, gamma, ref=False):
    """(x, residual or None) -> the outputs of the norm wrapper (``ref``: its
    plain version) as a tuple of tensors: (values, scales) or (out,), then h
    when a residual is given."""
    fn, kw = _norm_wrapper(name, bits, gamma, ref)

    def run(x, r=None):
        res = fn(x, residual=r, **kw)
        out, h = res if r is not None else (res, None)
        return (*(out if isinstance(out, tuple) else (out,)), *(() if h is None else (h,)))
    return run


def check_norms_fused(report):
    """The norm kernels with and without the residual add at every shape of
    NORM_TIMED against their plain versions (check_norms' tolerances), h bit
    for bit the torch add; a row's bits (outputs, scale, h) the same across
    M, its place in the batch, a second call and CUDA-graph replay. Inputs
    from a generator of their own, so the other checks' stay as they were."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    e_n, e_q, worst_exact = 0.0, 0, 1.0
    for name, m, h, bits, gamma in NORM_TIMED:
        x, r = _norm_set(gen, m, h)
        g = _gamma(gen, h) if gamma else None
        for res in (None, r):
            got, want = norm_fn(name, bits, g)(x, res), norm_fn(name, bits, g, True)(x, res)
            if res is not None and not (torch.equal(got[-1], x + r)
                                        and torch.equal(want[-1], x + r)):
                raise AssertionError(f"{norm_label(name, m, h, bits, gamma)}: h is not x + r")
            if name == "rmsnorm_quant":
                torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=0)
                d = (got[0].int() - want[0].int()).abs()
                exact = (d == 0).float().mean().item()
                if d.max().item() > 1 or exact <= 0.99:
                    raise AssertionError(f"{norm_label(name, m, h, bits, gamma)}: values "
                                         f"max diff {d.max().item()}, exact share {exact}")
                e_q, worst_exact = max(e_q, int(d.max().item())), min(worst_exact, exact)
            else:
                torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2e-2,
                                           atol=2e-2)
                e_n = max(e_n, (got[0].float() - want[0].float()).abs().max().item())
    for name, h, gamma in (("rmsnorm_quant", 4096, False), ("rmsnorm", 4096, False),
                           ("rmsnorm", 3584, True)):
        x, r = _norm_set(gen, 64, h)
        fn = norm_fn(name, 8, _gamma(gen, h) if gamma else None)
        for res in (None, r):
            full = fn(x, res)
            same = all(torch.equal(a, b) for a, b in zip(fn(x, res), full))
            for lo, hi in ((0, 1), (5, 9), (17, 64), (63, 64)):
                part = fn(x[lo:hi].contiguous(), None if res is None else res[lo:hi].contiguous())
                same = same and all(torch.equal(a, b[lo:hi]) for a, b in zip(part, full))
            flip = fn(x.flip(0).contiguous(), None if res is None else res.flip(0).contiguous())
            same = same and all(torch.equal(a, b.flip(0)) for a, b in zip(flip, full))
            same = same and all(_replay_bits(lambda i=i: fn(x, res)[i]) for i in range(len(full)))
            if not same:
                raise AssertionError(f"{name} H={h} residual={res is not None}: a row's bits "
                                     "depend on M, its place, the call or graph replay")
    report["rmsnorm"]["fused_max_err"] = e_n
    report["rmsnorm_quant"]["fused_max_err"] = e_q
    log(f"check norms with the residual add ({len(NORM_TIMED)} shapes, each also without "
        f"it): rmsnorm max_abs_err {e_n:.3g} (tol 2e-2), rmsnorm_quant values max diff {e_q} "
        f"(tol 1), exact share >= {worst_exact:.5f}; h == x + r bit for bit; row bits the "
        "same across M, place, a second call and graph replay")


def time_norm_shape(gen, name, m, h, bits, gamma) -> dict:
    """One norm shape's times (time_norms' fields), its line to the log."""
    from qspec_tpu_torch import _build
    lib = _build.lib()
    label = norm_label(name, m, h, bits, gamma)
    rot = _norm_rot(gen, m, h)
    g = _gamma(gen, h) if gamma else None
    kern, plain = norm_fn(name, bits, g), norm_fn(name, bits, g, True)
    reps = max(20, len(rot.sets))

    def run(fn, fused):
        x, r = rot.next()
        fn(x, r if fused else None)

    def pair():
        x, r = rot.next()
        kern(x + r)

    def floor():
        _build.check("launch floor", lib.qspec_norm_launch_floor(
            m, h, torch.cuda.current_stream().cuda_stream))
    t = {"ms": graph_ms(lambda: run(kern, False), reps),
         "fused_ms": graph_ms(lambda: run(kern, True), reps),
         "pair_ms": graph_ms(pair, reps), "floor_ms": graph_ms(floor),
         "plain_ms": graph_ms(lambda: run(plain, False), reps),
         "plain_fused_ms": graph_ms(lambda: run(plain, True), reps), "library_ms": None}
    if name == "rmsnorm":
        def library():
            x, _ = rot.next()
            torch.nn.functional.rms_norm(x, (h,), weight=g, eps=1e-5)
        t["library_ms"] = graph_ms(library, reps)
    out_bytes = m * h + 4 * m if name == "rmsnorm_quant" else m * h * 2
    nb = m * h * 2 + (2 * h if gamma else 0) + out_bytes
    ops = (6 if name == "rmsnorm_quant" else 4) * m * h
    t["bound_ms"], t["bound_by"] = bound_ms(nb, ops, "f32")
    t["fused_bound_ms"] = bound_ms(nb + 2 * m * h * 2, ops + m * h, "f32")[0]
    log(f"time {name} {label}: alone {t['ms']:.5f} ms, fused {t['fused_ms']:.5f}, "
        f"add + alone {t['pair_ms']:.5f}, floor {t['floor_ms']:.5f}, plain "
        f"{t['plain_ms']:.5f} / fused {t['plain_fused_ms']:.5f}"
        + (f", F.rms_norm {t['library_ms']:.5f}" if t["library_ms"] else "")
        + f", bound {t['bound_ms']:.6f} / fused {t['fused_bound_ms']:.6f} "
        f"({t['bound_by']})", stdout=False)
    del rot
    torch.cuda.empty_cache()
    return t


def time_norms(report):
    """Each NORM_TIMED shape: the kernel alone and with the residual add
    (fused), the torch add followed by the kernel alone in one graph (the
    pair the fusion replaces), the launch floor (an empty kernel launched
    as the norm is, csrc/rmsnorm.cu's qspec_norm_launch_floor), the plain
    versions, F.rms_norm (the rmsnorm rows), and the byte bounds alone and
    fused (x, the residual and gamma read once; out, h and the scales
    written once). Inputs rotated past L2 at M >= 512. One line a shape to
    the log, a summary to the standard output."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {norm_label(*shape): time_norm_shape(gen, *shape) for shape in NORM_TIMED}
    # the rows of the kernels line: the verify's rmsnorm (M=16) and the
    # W4A4 draft's rmsnorm_quant (M=4), alone and fused
    for name, label in (("rmsnorm", "rmsnorm_m16_h4096"), ("rmsnorm_quant", "quant4_m4_h4096")):
        t = rows[label]
        report[name].update(ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t["library_ms"],
                            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                            floor_ms=t["floor_ms"], shape=label)
        report[name]["fused"] = {"ms": t["fused_ms"], "plain_ms": t["plain_fused_ms"],
                                 "bound_ms": t["fused_bound_ms"], "bound_by": t["bound_by"],
                                 "library_ms": None, "floor_ms": t["floor_ms"],
                                 "add_plus_norm_ms": t["pair_ms"]}
    log("norm timings: " + json.dumps({k: {f: float(f"{v:.6g}") if isinstance(v, float) else v
                                           for f, v in t.items()} for k, t in rows.items()},
                                      separators=(",", ":")), stdout=False)
    for short in (False, True):     # three rows to the standard output, all to the log
        log("time norms, ms alone / fused / add + alone / floor: " + "; ".join(
            f"{k} {t['ms']:.4f}/{t['fused_ms']:.4f}/{t['pair_ms']:.4f}/{t['floor_ms']:.4f}"
            for k, t in rows.items()
            if not short or k in ("quant4_m4_h4096", "rmsnorm_m16_h4096", "quant4_m1024_h4096")),
            stdout=short)


def _ctx_lens(q_len, S=128):
    """Context lengths of the attention inputs' four rows (1-4 pages)."""
    return [max(c, q_len) for c in (3 * S - 5, 2 * S + 7, 4 * S, 40)]


def _attn_inputs(gen, q_len, B=4, Hq=32, Hkv=8, D=128, S=128, ctx=None):
    from qspec_tpu_torch.ops.kv_cache import PagedKVCache
    ctx = ctx or _ctx_lens(q_len, S)
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


KV8 = ("int8", "fp8_e4m3", "fp8_e5m2")
KV8_TOL = {"int8": 4e-2, "fp8_e4m3": 4e-2, "fp8_e5m2": 8e-2}


def _attn_inputs_kv(gen, q_len, kv_dtype, B=4, Hq=32, Hkv=8, D=128, S=128, ctx=None):
    """The shapes of _attn_inputs over a cache of ``kv_dtype``, every page of
    layer 1 filled through update_layer (the production write)."""
    from qspec_tpu_torch.ops import kv_cache as kvc
    q, bf16_cache, tables, ctx = _attn_inputs(gen, q_len, B, Hq, Hkv, D, S, ctx)
    P = bf16_cache.kv_pages.shape[1]
    cache = kvc.allocate(kvc.KVCacheConfig(2, Hkv, D, P, S, kv_dtype), "cuda")
    T = (P - 1) * S
    k_new = torch.randn(T, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
    v_new = torch.randn(T, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
    kvc.update_layer(cache, 1, k_new, v_new, torch.arange(T, device="cuda") + S)
    return q, cache, tables, ctx


def check_attention_kv8(gen, report):
    from qspec_tpu_torch.ops.attention import paged_attention_ref
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    for kv_dtype in KV8:
        err, tol = 0.0, KV8_TOL[kv_dtype]
        for q_len in (1, 4, 128):
            q, cache, tables, ctx = _attn_inputs_kv(gen, q_len, kv_dtype)
            out = paged_attention_cuda(q, cache.kv_pages, tables, ctx, 128 ** -0.5,
                                       layer=1, kv_scales=cache.kv_scales)
            ref = paged_attention_ref(q, cache, 1, tables, ctx, 128 ** -0.5)
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
            err = max(err, (out.float() - ref.float()).abs().max().item())
        report[f"paged_attention_{kv_dtype}"].update(max_err=err, tol=f"rtol=atol={tol}")
        log(f"check paged_attention {kv_dtype} KV: max_abs_err {err:.3g} "
            f"(tol rtol=atol={tol}; Q in 1,4,128; cache filled by update_layer)")


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


WINDOW_CTX = (40, 300, 1100, 2048)     # the windowed attention's rows


def _attn_window_inputs(gen, q_len, kv_dtype, ctx=WINDOW_CTX, Hq=32, Hkv=8, D=128, S=128,
                        live_pages=None):
    """One row per context of ``ctx`` (1-16 pages of 128), pages shuffled;
    layer 1 filled through update_layer for an 8-bit cache. ``live_pages``:
    only each row's last ``live_pages`` logical pages get pages of their
    own, the earlier ones map to the null page (a windowed walk never reads
    them), so many input sets fit in memory."""
    from qspec_tpu_torch.ops import kv_cache as kvc
    from qspec_tpu_torch.ops.kv_cache import PagedKVCache
    B = len(ctx)
    ctx = [max(c, q_len) for c in ctx]
    pages = [-(-c // S) for c in ctx]
    own = [n if live_pages is None else min(n, live_pages) for n in pages]
    P = 1 + sum(own)
    if kv_dtype == "bfloat16":
        cache = PagedKVCache(torch.randn(2, P, 2, Hkv, S, D, generator=gen,
                                         device="cuda").to(torch.bfloat16))
    else:
        cache = kvc.allocate(kvc.KVCacheConfig(2, Hkv, D, P, S, kv_dtype), "cuda")
        T = (P - 1) * S
        kvc.update_layer(cache, 1,
                         torch.randn(T, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16),
                         torch.randn(T, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16),
                         torch.arange(T, device="cuda") + S)
    ids = torch.randperm(P - 1, generator=torch.Generator().manual_seed(q_len)) + 1
    tables = torch.zeros(B, max(pages), dtype=torch.int32)
    o = 0
    for b, (n, m) in enumerate(zip(pages, own)):
        tables[b, n - m:n] = ids[o:o + m]
        o += m
    q = torch.randn(B, q_len, Hq, D, generator=gen, device="cuda").to(torch.bfloat16)
    return q, cache, tables.cuda(), torch.tensor(ctx, dtype=torch.int32, device="cuda")


def check_attention_window(gen, report):
    """The sliding window against the plain version: Q = 1, 4, 128, bf16 and
    int8 caches, windows 64 and 128, contexts 40-2048 (rows skip pages)."""
    from qspec_tpu_torch.ops.attention import paged_attention_ref
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    errs = {}
    for kv_dtype, tol in (("bfloat16", 3e-2), ("int8", 4e-2)):
        err = 0.0
        for q_len in (1, 4, 128):
            q, cache, tables, ctx = _attn_window_inputs(gen, q_len, kv_dtype)
            for window in (64, 128):
                out = paged_attention_cuda(q, cache.kv_pages, tables, ctx, 128 ** -0.5,
                                           layer=1, kv_scales=cache.kv_scales, window=window)
                ref = paged_attention_ref(q, cache, 1, tables, ctx, 128 ** -0.5,
                                          window=window)
                torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
                err = max(err, (out.float() - ref.float()).abs().max().item())
        errs[kv_dtype] = err
    report["paged_attention"]["window"] = {"max_abs_err": errs["bfloat16"],
                                           "max_abs_err_int8": errs["int8"]}
    log(f"check paged_attention window: max_abs_err bf16 {errs['bfloat16']:.3g} (tol 3e-2), "
        f"int8 {errs['int8']:.3g} (tol 4e-2); Q in 1,4,128, window 64 and 128, "
        f"ctx {list(WINDOW_CTX)}")


D256_TOL = {"bfloat16": 3e-2, "int8": 4e-2, "fp8_e4m3": 4e-2, "fp8_e5m2": 8e-2}


def check_attention_d256(gen, report):
    """Gemma-2's attention: the head-dim-256 instantiations, with the logit
    softcap 50 (Gemma-2's), 5 and none, Q = 1, 4, 128, every entry type,
    windows none and 128 over contexts 40-2048 (Hq=16, Hkv=8, page 128); the
    softcap at D=128 too; a row's bits at Q=1 equal its bits at Q=4. The
    queries are 4 x normal: scores of std 4, which the cap of 5 bends
    strongly and the cap of 50 slightly."""
    from qspec_tpu_torch.ops.attention import paged_attention_ref
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    errs, same = {}, True
    for kv_dtype, tol in D256_TOL.items():
        err = 0.0
        for D in (256, 128):
            for q_len in ((1, 4, 128) if D == 256 else (4,)):
                q, cache, tables, ctx = _attn_window_inputs(gen, q_len, kv_dtype, Hq=16, D=D)
                q = q * 4
                for cap in ((50.0, 5.0, None) if D == 256 else (50.0, 5.0)):
                    for window in (None, 128):
                        out = paged_attention_cuda(q, cache.kv_pages, tables, ctx, D ** -0.5,
                                                   layer=1, kv_scales=cache.kv_scales,
                                                   window=window, softcap=cap)
                        ref = paged_attention_ref(q, cache, 1, tables, ctx, D ** -0.5,
                                                  window=window, softcap=cap)
                        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
                        err = max(err, (out.float() - ref.float()).abs().max().item())
                if q_len == 4:
                    full = paged_attention_cuda(q, cache.kv_pages, tables, ctx, D ** -0.5, layer=1,
                                                kv_scales=cache.kv_scales, softcap=50.0)
                    one = paged_attention_cuda(q[:, -1:].contiguous(), cache.kv_pages, tables,
                                               ctx, D ** -0.5, layer=1,
                                               kv_scales=cache.kv_scales, softcap=50.0)
                    same &= torch.equal(one[:, 0], full[:, -1])
        errs[kv_dtype] = err
        name = "paged_attention" if kv_dtype == "bfloat16" else f"paged_attention_{kv_dtype}"
        report[name]["d256_softcap"] = {"max_abs_err": err, "tol": f"rtol=atol={tol}"}
    if not same:
        raise AssertionError("paged_attention D=256 softcap: a row's bits depend on Q")
    log("check paged_attention D=256 (softcap 50, 5, none) and D=128 (softcap 50, 5): "
        "max_abs_err (tol: rtol=atol) "
        + ", ".join(f"{k} {v:.3g} (tol {D256_TOL[k]})" for k, v in errs.items())
        + f"; Q in 1,4,128, window none and 128, ctx {list(WINDOW_CTX)}; "
        "a row's bits equal at Q=1 and Q=4", stdout=False)
    print("check paged_attention D=256 / softcap: max_abs_err " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items()) + " (within tolerance; the log has the cases)",
        flush=True)


TREE_TOL = {"bfloat16": 3e-2, "int8": 4e-2, "fp8_e4m3": 4e-2, "fp8_e5m2": 8e-2}
TREE_ROOTS = (17, 30)          # the JAX kernel test's roots (two rows)


def _tree_inputs(gen, prefix, kv_dtype, D, tspec, Hq=4, Hkv=2, S=16, P=24, scale_q=1.0):
    """The JAX kernel test's tree rectangle (tests/kernels/test_attention.py::
    test_tree_mask_pallas_matches_ref: B=2, Hq=4, Hkv=2, roots 17 and 30,
    shuffled tables of 10 pages; page 16, the kernel's least) at head dim
    ``D`` over a cache of ``kv_dtype`` (8-bit: layer 1 filled through
    update_layer). Returns q, cache, tables, ctx, positions."""
    from qspec_tpu_torch.ops import kv_cache as kvc
    from qspec_tpu_torch.ops.kv_cache import PagedKVCache
    T = tspec.num_nodes
    B, Q = len(TREE_ROOTS), prefix + T
    if kv_dtype == "bfloat16":
        cache = PagedKVCache(torch.randn(2, P, 2, Hkv, S, D, generator=gen,
                                         device="cuda").to(torch.bfloat16))
    else:
        cache = kvc.allocate(kvc.KVCacheConfig(2, Hkv, D, P, S, kv_dtype), "cuda")
        n = (P - 1) * S
        kvc.update_layer(cache, 1,
                         torch.randn(n, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16),
                         torch.randn(n, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16),
                         torch.arange(n, device="cuda") + S)
    tables = (torch.randperm(20, generator=torch.Generator().manual_seed(prefix)) + 1
              ).reshape(2, 10).to(torch.int32).cuda()
    pos = torch.tensor(TREE_ROOTS, device="cuda")
    depth = torch.tensor(tspec.depth, device="cuda")
    positions = torch.cat([pos[:, None] - (prefix - 1) + torch.arange(prefix, device="cuda"),
                           pos[:, None] + depth[None]], 1)
    q = (torch.randn(B, Q, Hq, D, generator=gen, device="cuda") * scale_q).to(torch.bfloat16)
    ctx = (pos + 1 + T).to(torch.int32)
    return q, cache, tables, ctx, positions


def check_attention_tree(gen, report):
    """The tree mask against its plain version: DEFAULT_TREE, prefix 3 and 5,
    head dims 128 and 256, every entry type, softcap none and 50, window
    none and 12 (shorter than every context: it bounds the prefix rows and
    each tree row by its node's own position root + depth); the tree rows
    under the window also against AR (tree_rows_ar); then the JAX test's
    structural check on the kernel: a node's KV slot changed, the rows that
    are not its descendants keep their bits, its child's row changes."""
    from qspec_tpu_torch.ops.attention import paged_attention_ref, tree_mask
    from qspec_tpu_torch.ops.attention_cuda import LAUNCHES, paged_attention_cuda
    from qspec_tpu_torch.spec_decode.medusa_tree import DEFAULT_TREE, build_tree
    tspec = build_tree(DEFAULT_TREE)
    errs = {}
    n_tree = sum(c.tree_launches for c in LAUNCHES.values())
    n_calls, err_ar = 0, 0.0
    for kv_dtype, tol in TREE_TOL.items():
        err = 0.0
        for D in (128, 256):
            for prefix in (3, 5):
                q, cache, tables, ctx, positions = _tree_inputs(gen, prefix, kv_dtype, D, tspec,
                                                                scale_q=4.0)
                tree = tree_mask(prefix, tspec.ancestors, "cuda")
                for cap in (None, 50.0):
                    for window in (None, 12):
                        kw = dict(q_positions=positions, window=window, softcap=cap, tree=tree)
                        out = paged_attention_cuda(q, cache.kv_pages, tables, ctx, D ** -0.5,
                                                   layer=1, kv_scales=cache.kv_scales, **kw)
                        ref = paged_attention_ref(q, cache, 1, tables, ctx, D ** -0.5, **kw)
                        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
                        err = max(err, (out.float() - ref.float()).abs().max().item())
                        n_calls += 1
                        if window and cap is None:
                            ar = tree_rows_ar(q, cache, 1, tables, positions, tspec, prefix,
                                              D ** -0.5, window)
                            torch.testing.assert_close(out[:, prefix:].float(), ar, rtol=tol,
                                                       atol=tol)
                            err_ar = max(err_ar, (out[:, prefix:].float() - ar).abs().max().item())
        errs[kv_dtype] = err
        name = "paged_attention" if kv_dtype == "bfloat16" else f"paged_attention_{kv_dtype}"
        report[name]["tree"] = {"max_abs_err": err, "tol": f"rtol=atol={tol}"}
    if sum(c.tree_launches for c in LAUNCHES.values()) - n_tree != n_calls:
        raise AssertionError("paged_attention tree: tree launches not counted")
    # structural: perturb node (1,)'s slot of row 0 in a bf16 cache
    prefix = 5
    q, cache, tables, ctx, positions = _tree_inputs(gen, prefix, "bfloat16", 128, tspec)
    kw = dict(q_positions=positions, tree=tree_mask(prefix, tspec.ancestors, "cuda"))
    before = paged_attention_cuda(q, cache.kv_pages, tables, ctx, 128 ** -0.5, layer=1, **kw)
    node = tspec.choices.index((1,))
    slot = TREE_ROOTS[0] + 1 + node
    page = int(tables[0, slot // 16])
    cache.kv_pages[1, page, :, :, slot % 16] = 99.0
    after = paged_attention_cuda(q, cache.kv_pages, tables, ctx, 128 ** -0.5, layer=1, **kw)
    desc = [i for i in range(tspec.num_nodes) if tspec.ancestors[i][node]]
    keep = [r for r in range(q.shape[1]) if r - prefix not in desc]
    child = prefix + tspec.choices.index((1, 0))
    if not torch.equal(before[0, keep], after[0, keep]) or torch.equal(
            before[0, child], after[0, child]) or not torch.equal(before[1], after[1]):
        raise AssertionError("paged_attention tree: a node's slot reached a row that is not "
                             "its descendant, or missed its child")
    report["paged_attention"]["tree"]["window_vs_ar_max_abs_err"] = err_ar
    log("check paged_attention tree (DEFAULT_TREE, prefix 3 and 5, D=128 and 256, softcap none "
        "and 50, window none and 12): max_abs_err (tol: rtol=atol) "
        + ", ".join(f"{k} {v:.3g} (tol {TREE_TOL[k]})" for k, v in errs.items())
        + f"; tree rows under window 12 vs AR {err_ar:.3g}; node (1,)'s slot changed: "
        f"{len(keep)} rows keep their bits, its child's row moves", stdout=False)
    print("check paged_attention tree: max_abs_err " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items()) + " (within tolerance; the log has the cases)",
        flush=True)


def tree_rows_ar(q, cache, layer, tables, positions, tspec, prefix, scale, window):
    """AR's rows of a tree rectangle's nodes, f32 [B, T, Hq, D]: node t's
    query at position root + depth(t) over the context 0..root and its path
    (ancestors and itself, by depth) at consecutive positions, under the
    window: what AR computes once the path's tokens are committed."""
    from qspec_tpu_torch.ops.kv_cache import gather_layer
    k, v = (x.double() for x in gather_layer(cache, layer, tables))
    B, _, Hq, D = q.shape
    group = Hq // k.shape[1]
    out = torch.zeros(B, tspec.num_nodes, Hq, D, dtype=torch.float64, device=q.device)
    for b in range(B):
        root = int(positions[b, prefix - 1])
        for t in range(tspec.num_nodes):
            path = sorted((j for j in range(tspec.num_nodes) if tspec.ancestors[t][j]),
                          key=lambda j: tspec.depth[j])
            slots = torch.tensor(list(range(root + 1)) + [root + 1 + j for j in path],
                                 device=q.device)
            slots = slots[torch.arange(len(slots), device=q.device)
                          > root + tspec.depth[t] - window]
            kk, vv = k[b, :, slots].repeat_interleave(group, 0), v[b, :, slots].repeat_interleave(
                group, 0)                                                   # [Hq, n, D]
            w = torch.softmax(torch.einsum("hnd,hd->hn", kk, q[b, prefix + t].double()) * scale,
                              -1)
            out[b, t] = torch.einsum("hn,hnd->hd", w, vv)
    return out.float()


ALIBI_TOL = {"bfloat16": 3e-2, "int8": 4e-2, "fp8_e4m3": 4e-2, "fp8_e5m2": 8e-2}


def _alibi_gqa_inputs(gen, q_len, kv_dtype, S=16):
    """The JAX kernel test's ALiBi shape (tests/kernels/test_attention.py::
    test_alibi_pallas_matches_ref: B=3, Hq=4, Hkv=2, head dim 64, contexts
    Q+3, S+Q, 2S+Q) at page 16, the kernel's least; the head dim padded into
    the 128-wide cache by update_layer and paged_attention."""
    from qspec_tpu_torch.ops import kv_cache as kvc
    cache = kvc.allocate(kvc.KVCacheConfig(2, 2, 128, 13, S, kv_dtype), "cuda")
    n = 12 * S
    kvc.update_layer(cache, 1, torch.randn(n, 2, 64, generator=gen, device="cuda").to(torch.bfloat16),
                     torch.randn(n, 2, 64, generator=gen, device="cuda").to(torch.bfloat16),
                     torch.arange(n, device="cuda") + S)
    tables = (torch.randperm(12, generator=torch.Generator().manual_seed(q_len)) + 1
              ).reshape(3, 4).to(torch.int32).cuda()
    ctx = torch.tensor([q_len + 3, S + q_len, 2 * S + q_len], dtype=torch.int32, device="cuda")
    q = torch.randn(3, q_len, 4, 64, generator=gen, device="cuda").to(torch.bfloat16)
    return q, cache, tables, ctx


def check_attention_alibi(gen, report):
    """ALiBi against its plain version on every entry type: BLOOM-7B1's
    attention (B=4, Hq=Hkv=32, D=128, page 128, contexts of 1-4 pages) at
    the decode's Q=1 (one live row of the block's 8), the n-gram verify's
    Q=4 and a prompt forward's Q=128, and the JAX kernel test's GQA shape at
    Q=1 and 4 (through paged_attention, head dim 64 padded); every launch
    counted as an ALiBi launch, and every output differs from the same
    launch without ALiBi."""
    from qspec_tpu_torch.ops.attention import alibi_slopes, paged_attention, paged_attention_ref
    from qspec_tpu_torch.ops.attention_cuda import LAUNCHES, paged_attention_cuda
    errs = {}
    n_alibi = sum(c.alibi_launches for c in LAUNCHES.values())
    n_calls = 0
    for kv_dtype, tol in ALIBI_TOL.items():
        err = 0.0
        for shape, q_lens in (("bloom", (1, 4, 128)), ("gqa", (1, 4))):
            for q_len in q_lens:
                if shape == "gqa":
                    q, cache, tables, ctx = _alibi_gqa_inputs(gen, q_len, kv_dtype)
                    fn, D = paged_attention, 64
                else:
                    q, cache, tables, ctx = (
                        _attn_inputs(gen, q_len, Hkv=32) if kv_dtype == "bfloat16"
                        else _attn_inputs_kv(gen, q_len, kv_dtype, Hkv=32))
                    D = 128

                    def fn(q, cache, layer, tables, ctx, scale, **kw):
                        return paged_attention_cuda(q, cache.kv_pages, tables, ctx, scale,
                                                    layer=layer, kv_scales=cache.kv_scales, **kw)
                slopes = torch.as_tensor(alibi_slopes(q.shape[2]), device="cuda")
                out = fn(q, cache, 1, tables, ctx, D ** -0.5, alibi=slopes)
                ref = paged_attention_ref(torch.nn.functional.pad(q, (0, 128 - D)), cache, 1,
                                          tables, ctx, D ** -0.5, alibi=slopes)[..., :D]
                torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
                err = max(err, (out.float() - ref.float()).abs().max().item())
                if torch.allclose(out.float(), fn(q, cache, 1, tables, ctx, D ** -0.5).float(),
                                  atol=tol):
                    raise AssertionError(f"paged_attention ALiBi {kv_dtype} {shape} Q={q_len}: "
                                         "the bias does not move the output")
                n_calls += 1
        errs[kv_dtype] = err
        name = "paged_attention" if kv_dtype == "bfloat16" else f"paged_attention_{kv_dtype}"
        report[name]["alibi"] = {"max_abs_err": err, "tol": f"rtol=atol={tol}"}
    if sum(c.alibi_launches for c in LAUNCHES.values()) - n_alibi != n_calls:
        raise AssertionError("paged_attention ALiBi: launches not counted")
    log("check paged_attention ALiBi (BLOOM-7B1: B=4 Hq=Hkv=32 D=128 page 128 Q=1,4,128; GQA: "
        "B=3 Hq=4 Hkv=2 D=64 page 16 Q=1,4): max_abs_err "
        + ", ".join(f"{k} {v:.3g} (tol {ALIBI_TOL[k]})" for k, v in errs.items())
        + "; every output moved by the bias")


def time_attention_alibi(gen, report):
    """BLOOM-7B1's attention at the n-gram verify (B=4, Q=4, Hq=Hkv=32,
    D=128, bf16 cache, contexts of 1-4 pages) with ALiBi, beside the same
    inputs without it and the plain version; inputs rotated past L2."""
    from qspec_tpu_torch.ops.attention import alibi_slopes, paged_attention_ref
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    B, q_len, Hq, Hkv, D = 4, 4, 32, 32, 128
    live = _ctx_lens(q_len)
    kv_bytes = sum(live) * Hkv * D * 2 * 2
    rot = Rotating(lambda: _attn_inputs(gen, q_len, Hkv=Hkv), kv_bytes)
    slopes = torch.as_tensor(alibi_slopes(Hq), device="cuda")
    times = {}
    for with_alibi in (True, False):
        def kern(a=slopes if with_alibi else None):
            q, cache, tables, ctx = rot.next()
            paged_attention_cuda(q, cache.kv_pages, tables, ctx, D ** -0.5, layer=1, alibi=a)
        times[with_alibi] = graph_ms(kern, reps=max(20, len(rot.sets)))

    def plain():
        q, cache, tables, ctx = rot.next()
        paged_attention_ref(q, cache, 1, tables, ctx, D ** -0.5, alibi=slopes)
    t_p = graph_ms(plain, reps=3)
    q, _, tables, _ = rot.sets[0]
    nbytes = 2 * q.numel() * 2 + kv_bytes + tables.numel() * 4 + 8 * B + 4 * Hq
    seen = sum(sum(c - q_len + i + 1 for i in range(q_len)) for c in live)
    b, kind = bound_ms(nbytes, 4 * Hq * D * seen, "bf16")
    log(f"time paged_attention ALiBi B=4 Q=4 Hq=Hkv=32 ctx={live}: {times[True]:.4f} ms "
        f"(no ALiBi {times[False]:.4f}), plain {t_p:.4f}, bound {b:.5f} ({kind})")
    report["paged_attention"]["alibi"].update(
        ms=times[True], no_alibi_ms=times[False], plain_ms=t_p, bound_ms=b, bound_by=kind,
        shape=f"B=4, Q=4, Hq=Hkv=32, D=128, ctx={live}, bf16 KV (BLOOM-7B1's n-gram verify)")
    del rot
    torch.cuda.empty_cache()


BLOOM_PROJ = ((4096, 12288), (4096, 4096), (4096, 16384), (16384, 4096))   # qkv, o, up, down


def time_bloom_projections(gen):
    """What the bf16 scheme's row padding costs: one BLOOM-7B1 layer's four
    projections at the decode's M=4 and the n-gram verify's M=16, as
    ``_f32_matmul`` runs them (rows padded to 128, f32 out) beside the same
    torch.mm on the unpadded rows; 402 MB of weights, past L2 on their own."""
    from qspec_tpu_torch.models.llama import _f32_matmul
    ws = [torch.randn(k, n, generator=gen, device="cuda").to(torch.bfloat16)
          for k, n in BLOOM_PROJ]
    out = {}
    for m in (4, 16):
        xs = [torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
              for k, _ in BLOOM_PROJ]

        def padded():
            for x, w in zip(xs, ws):
                _f32_matmul(x, w)

        def unpadded():
            for x, w in zip(xs, ws):
                torch.mm(x, w, out_dtype=torch.float32)
        t = {fn: [] for fn in (padded, unpadded)}
        for fn in (padded, unpadded, unpadded, padded):
            t[fn].append(graph_ms(fn, reps=10))
        nbytes = sum(k * n * 2 + m * k * 2 + m * n * 4 for k, n in BLOOM_PROJ)
        b, _ = bound_ms(nbytes, sum(2 * m * k * n for k, n in BLOOM_PROJ), "bf16")
        out[m] = (min(t[padded]), min(t[unpadded]), b)
    log("time BLOOM-7B1 layer's bf16 projections (qkv,o,up,down), rows padded to 128 vs "
        "unpadded: " + "; ".join(f"M={m} {p:.4f} vs {u:.4f} ms (bound {b:.5f})"
                                 for m, (p, u, b) in out.items()))
    del ws
    torch.cuda.empty_cache()


TREE_PREFIX = 5       # DEFAULT_TREE's depth 4 + 1: the engine's verify prefix
# the main paths' tree-verify rectangles: (model, Hq, D, softcaps, windows);
# Gemma-2's local layers take its window 4096, 128 bites at these contexts
TREE_MAIN = (("llama3-8b", 32, 128, (None,), (None,)),
             ("gemma2-9b", 16, 256, (50.0,), (None, 4096, 128)))


def _tree_rect(tspec):
    """The engine's tree-verify rectangle: B=4, prefix 5 + the tree's T
    nodes (Q=15 for DEFAULT_TREE), roots at the ends of contexts of 1-4
    pages of 128 (_ctx_lens). Returns the rows' positions [4, Q] and the
    contexts with the tree's slots."""
    T = tspec.num_nodes
    base = _ctx_lens(TREE_PREFIX + T)
    root = torch.tensor(base, device="cuda") - 1
    depth = torch.tensor(tspec.depth, device="cuda")
    positions = torch.cat([root[:, None] - (TREE_PREFIX - 1)
                           + torch.arange(TREE_PREFIX, device="cuda"), root[:, None] + depth[None]], 1)
    return positions, [c + T for c in base]


def check_attention_tree_main(gen, report):
    """The tree mask at the main paths' rectangles (_tree_rect, Hkv=8, bf16
    cache): Llama-3-8B's (Hq=32, D=128) and Gemma-2-9B's (Hq=16, D=256,
    softcap 50, window none, 4096 and 128), queries 4 x normal, against the
    plain version in f32 (rtol = atol = 3e-2) and against the plain version
    that rounds where the Pallas body does (bf16_products: q times the scale
    and the probabilities to bf16), at the tolerance of those roundings
    alone (tests/test_torch_attention_rounding.py): a probability's rounding,
    2^-8 max|v|, and one bf16 ulp of the output, rtol 2^-7."""
    from qspec_tpu_torch.ops.attention import paged_attention_ref, tree_mask
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    from qspec_tpu_torch.spec_decode.medusa_tree import DEFAULT_TREE, build_tree
    tspec = build_tree(DEFAULT_TREE)
    positions, live = _tree_rect(tspec)
    tree = tree_mask(TREE_PREFIX, tspec.ancestors, "cuda")
    tol = TREE_TOL["bfloat16"]
    errs, errs_r = {}, {}
    for model, Hq, D, caps, windows in TREE_MAIN:
        q, cache, tables, ctx = _attn_inputs(gen, positions.shape[1], Hq=Hq, D=D, ctx=live)
        q = q * 4
        atol_r = 2.0 ** -8 * cache.kv_pages[1, :, 1].float().abs().max().item()
        err = err_r = 0.0
        for cap in caps:
            for window in windows:
                kw = dict(q_positions=positions, window=window, softcap=cap, tree=tree)
                out = paged_attention_cuda(q, cache.kv_pages, tables, ctx, D ** -0.5, layer=1,
                                           **kw)
                ref = paged_attention_ref(q, cache, 1, tables, ctx, D ** -0.5, **kw)
                torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
                err = max(err, (out.float() - ref.float()).abs().max().item())
                ref = paged_attention_ref(q, cache, 1, tables, ctx, D ** -0.5,
                                          bf16_products=True, **kw)
                torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7, atol=atol_r)
                err_r = max(err_r, (out.float() - ref.float()).abs().max().item())
        errs[model], errs_r[model] = err, err_r
    report["paged_attention"]["tree"]["main_path_max_abs_err"] = errs
    report["paged_attention"]["tree"]["main_path_max_abs_err_bf16_products"] = errs_r
    log(f"check paged_attention tree at the main paths' rectangles (B=4, Q=15, ctx={live}, bf16 "
        "KV; llama3-8b Hq=32 D=128; gemma2-9b Hq=16 D=256 softcap 50, window none/4096/128): "
        f"max_abs_err " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" (tol {tol}); "
        "against the Pallas body's bf16 rounding " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs_r.items()) + " (tol 2^-8 max|v|, rtol 2^-7)",
        stdout=False)
    print("check paged_attention tree at the main paths' rectangles: within tolerance "
          "(the log has each)", flush=True)


def time_attention_tree(gen, report):
    """The Llama-3-8B tree-verify rectangle (_tree_rect: Hq=32, Hkv=8,
    D=128, bf16 cache); beside it the kernel without the tree at the same Q
    on the same inputs (causal over 15 consecutive rows), and the plain
    version; the kernel's output on the first input set held against the
    plain version's."""
    from qspec_tpu_torch.ops.attention import paged_attention_ref, tree_mask, tree_slot_mask
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    from qspec_tpu_torch.spec_decode.medusa_tree import DEFAULT_TREE, build_tree
    tspec = build_tree(DEFAULT_TREE)
    B, Hq, Hkv, D, prefix = 4, 32, 8, 128, TREE_PREFIX
    Q = prefix + tspec.num_nodes
    positions, live = _tree_rect(tspec)
    tree = tree_mask(prefix, tspec.ancestors, "cuda")
    kv_bytes = sum(live) * Hkv * D * 2 * 2
    rot = Rotating(lambda: _attn_inputs(gen, Q, ctx=live), kv_bytes)
    q, cache, tables, ctx = rot.sets[0]
    out = paged_attention_cuda(q, cache.kv_pages, tables, ctx, D ** -0.5, layer=1,
                               q_positions=positions, tree=tree)
    ref = paged_attention_ref(q, cache, 1, tables, ctx, D ** -0.5, q_positions=positions,
                              tree=tree)
    tol = TREE_TOL["bfloat16"]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    err = (out.float() - ref.float()).abs().max().item()
    times = {}
    for mode in ("tree", "causal"):
        def kern(mode=mode):
            q, cache, tables, ctx = rot.next()
            if mode == "tree":
                paged_attention_cuda(q, cache.kv_pages, tables, ctx, D ** -0.5, layer=1,
                                     q_positions=positions, tree=tree)
            else:
                paged_attention_cuda(q, cache.kv_pages, tables, ctx, D ** -0.5, layer=1)
        times[mode] = graph_ms(kern, reps=max(20, len(rot.sets)))

    def plain():
        q, cache, tables, ctx = rot.next()
        paged_attention_ref(q, cache, 1, tables, ctx, D ** -0.5, q_positions=positions,
                            tree=tree)
    t_p = graph_ms(plain, reps=3)
    nbytes = 2 * q.numel() * 2 + kv_bytes + tables.numel() * 4 + 8 * B
    seen = int(tree_slot_mask(prefix, Q, positions[:, 0], tree.ancestors, max(live)).sum())
    b, kind = bound_ms(nbytes, 4 * Hq * D * seen, "bf16")
    log(f"time paged_attention tree B=4 Q=15 (prefix 5, DEFAULT_TREE) ctx={live}: "
        f"{times['tree']:.4f} ms (no tree, Q=15: {times['causal']:.4f}), plain {t_p:.4f}, "
        f"bound {b:.5f} ({kind}); max_abs_err {err:.3g} (tol {tol})")
    report["paged_attention"]["tree"].update(
        ms=times["tree"], no_tree_ms=times["causal"], plain_ms=t_p, bound_ms=b, bound_by=kind,
        timed_max_abs_err=err,
        shape=f"B=4, Q=15 (prefix 5 + DEFAULT_TREE), Hq=32, Hkv=8, D=128, ctx={live}, bf16 KV")
    del rot
    torch.cuda.empty_cache()


# the GEMM timings of csrc/w4.cu: (wrapper, M, key of the row in the
# kernels line; "" the wrapper's own row). The first three draw their
# inputs from the shared generator as before the others were added
W4_TIMED = (("matmul_w4a16", 16, ""), ("matmul_w4a16", 60, "m60"), ("matmul_w4a4", 4, ""),
            ("matmul_w4a16", HEAD_SHAPE[0], "head"), ("matmul_w4a4", 8, "m8"),
            ("matmul_w4a4", 1024, "m1024"))
W4_KEYS = {"m60": "m60_tree_verify", "head": "int4_head", "m8": "m8_backfill",
           "m1024": "m1024_draft_prefill"}


def _int_mm_rows(x8, w8) -> int:
    """The least M >= len(x8) at which torch._int_mm takes [M, K] x [K, N]
    on this card (it has refused M <= 16); 0 when it takes none."""
    for rows in (x8.shape[0], 17, 32):
        if rows < x8.shape[0]:
            continue
        try:
            torch._int_mm(torch.zeros(rows, x8.shape[1], dtype=torch.int8, device="cuda"), w8)
            return rows
        except RuntimeError:
            continue
    return 0


def time_w4_layer(gen, name: str, m: int, head: bool = False, plain: bool = True,
                  library: bool = True, gen_lib=None, shapes=None) -> dict:
    """One Llama-3-8B layer's four projections (``head``: the int4 head, K=4096,
    N=128256, f32 out; ``shapes``: these (K, N) instead, bf16 out) at M =
    ``m`` through ``name`` (csrc/w4.cu), each input
    set rotated past L2: kernel, plain version, library call
    (torch._weight_int4pack_mm for w4a16; for w4a4 torch._int_mm on the
    weights widened to int8 once, column-major (its fast layout for int8),
    plus the scale epilogue, at the least M it takes;
    its widened weights drawn from ``gen_lib``, default ``gen``)
    and the bound from this call's bytes and operations."""
    from qspec_tpu_torch.ops import linear_kernels as lk
    from qspec_tpu_torch.ops.packing import unpack_int4
    from qspec_tpu_torch.ops.quant import sym_quant_int4
    w4a4 = name == "matmul_w4a4"
    label = (f"K,N={shapes[0]} at M={m}" if shapes else
             f"int4 head M={m}, K,N={HEAD_SHAPE[1:]}, f32 out" if head else
             f"one layer's qkv+o+gate_up+down at M={m}")
    shapes = shapes or ((HEAD_SHAPE[1:],) if head else GEMM_SHAPES)
    out_dtype = torch.float32 if head else torch.bfloat16
    tot = {"ms": 0.0, "plain_ms": 0.0 if plain else None, "bound_ms": 0.0,
           "library_ms": 0.0 if library else None}
    nbytes_tot = ops_tot = 0
    per, lib_rows = [], m
    for k, n in shapes:
        wbytes = k * n // 2 + 4 * n
        rot = Rotating(lambda k=k, n=n: _w4(gen, k, n), wbytes)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        xq = sym_quant_int4(x)
        if w4a4:
            def kern():
                lk.matmul_w4a4(xq.values, xq.scales, *rot.next())

            def plain_fn():
                qw, qs = rot.next()
                lk.matmul_w4a4_ref(xq.values, xq.scales, qw, qs)
            nbytes = m * k + 4 * m + wbytes + m * n * 2
        else:
            def kern():
                lk.matmul_w4a16(x, *rot.next(), out_dtype=out_dtype)

            def plain_fn():
                qw, qs = rot.next()
                lk.matmul_w4a16_ref(x, qw, qs, out_dtype=out_dtype)
            nbytes = m * k * 2 + wbytes + m * n * out_dtype.itemsize
        nbytes_tot += nbytes
        ops_tot += 2 * m * k * n
        tot["bound_ms"] += bound_ms(nbytes, 2 * m * k * n, "int8" if w4a4 else "bf16")[0]
        t_k = graph_ms(kern, reps=max(20, len(rot.sets)))
        tot["ms"] += t_k
        if plain:
            tot["plain_ms"] += graph_ms(plain_fn, reps=3)
        t_l = None
        if library and w4a4:
            def widened(k=k, n=n):   # column-major: _int_mm's fast int8 layout
                qw, qs = _w4(gen_lib or gen, k, n)
                return unpack_int4(qw).to(torch.int8).t().contiguous().t(), qs
            rot_l = Rotating(widened, k * n + 4 * n)
            lib_rows = _int_mm_rows(xq.values, rot_l.sets[0][0])
            if lib_rows:
                xl = torch.zeros(lib_rows, k, dtype=torch.int8, device="cuda")
                xl[:m] = xq.values
                sx = torch.ones(lib_rows, 1, device="cuda")
                sx[:m] = xq.scales.reshape(-1, 1)

                def lib_call():
                    w8, sw = rot_l.next()
                    ((torch._int_mm(xl, w8).float() * sx) * sw[None, :]).to(torch.bfloat16)
                t_l = graph_ms(lib_call, reps=max(20, len(rot_l.sets)))
            del rot_l
        elif library:
            rot_l = Rotating(lambda k=k, n=n: _int4pack_w4(*_w4(gen, k, n)), wbytes)

            def lib_call():
                packed, sz = rot_l.next()
                torch._weight_int4pack_mm(x, packed, GROUP, sz)
            t_l = graph_ms(lib_call, reps=max(20, len(rot_l.sets)))
            del rot_l
        if library:
            tot["library_ms"] = None if t_l is None or tot["library_ms"] is None \
                else tot["library_ms"] + t_l
        per.append(f"{t_k:.4f}" + ("" if t_l is None else f"/{t_l:.4f}"))
        del rot
        torch.cuda.empty_cache()
    lib = (("_int_mm" + (f" at M={lib_rows}" if lib_rows != m else "")) if w4a4
           else "_weight_int4pack_mm") if tot["library_ms"] is not None else None
    return dict(tot, bound_by=bound_ms(nbytes_tot, ops_tot, "int8" if w4a4 else "bf16")[1],
                per=per, library=lib, shape=label)


def time_kernels(gen, gen_w4, report, int4pack_missing):
    """Per kernel, at the main path's shape: kernel, plain version, library
    call; bound from the bytes and operations of this call's inputs."""
    from qspec_tpu_torch.ops import linear_kernels as lk
    from qspec_tpu_torch.ops.attention import paged_attention_ref
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda

    # GEMMs (csrc/w4.cu): one decoder layer's four projections at the
    # verify width (M=16: 4 sequences x (k+1) positions), the Medusa tree
    # verify's (M=60: 4 x (prefix 5 + 10 nodes)), the draft width (M=4), the
    # backfill draft step's (M=8) and the draft prefill's (M=1024: 4 x 256),
    # and the int4 head; the yardsticks torch._weight_int4pack_mm (w4a16)
    # and torch._int_mm on int8 weights plus the scale epilogue (w4a4)
    for i, (name, m, key) in enumerate(W4_TIMED):
        r = time_w4_layer(gen if i < 3 else gen_w4, name, m, head=key == "head", plain=m <= 64,
                          library=name == "matmul_w4a4" or int4pack_missing is None,
                          gen_lib=gen_w4)
        per = r.pop("per")
        log(f"time {name} M={m}{' ' + key if key == 'head' else ''}, "
            + ("" if key == "head" else "one layer ")
            + f"({', '.join(per)} ms): {r['ms']:.4f} ms, plain "
            + (f"{r['plain_ms']:.4f}" if r["plain_ms"] is not None else "not timed")
            + (f", {r['library']} {r['library_ms']:.4f}" if r["library_ms"] is not None else "")
            + f", bound {r['bound_ms']:.4f} ({r['bound_by']})", stdout=key in ("", "m60"))
        if key:
            report[name][W4_KEYS[key]] = r
        else:
            report[name].update(r)
        torch.cuda.empty_cache()

    # the norms, alone and with the residual add, beside their launch floor
    time_norms(report)

    # the int8 head: draft width M=4, verify width M=16 and the tree verify's
    # M=60 (its input from gen_w4, so gen draws what it drew before); the
    # yardstick is torch._weight_int8pack_mm (same function, weights [N, K],
    # bf16 out), at M=60 over 3 calls
    _, k, n = HEAD_SHAPE
    wbytes = k * n + 4 * n
    rot = Rotating(lambda: _w8(gen, k, n), wbytes)

    def transposed():
        qw, qs = _w8(gen, k, n)
        return qw.t().contiguous(), qs.to(torch.bfloat16)
    rot_t = Rotating(transposed, wbytes)
    for m in (4, 16, 60):
        x = torch.randn(m, k, generator=gen_w4 if m == 60 else gen,
                        device="cuda").to(torch.bfloat16)

        def kern():
            qw, qs = rot.next()
            lk.matmul_w8a16(x, qw, qs, out_dtype=torch.float32)

        def plain():
            qw, qs = rot.next()
            lk.matmul_w8a16_ref(x, qw, qs, out_dtype=torch.float32)

        def library():
            qwt, qsb = rot_t.next()
            torch._weight_int8pack_mm(x, qwt, qsb)
        nbytes = m * k * 2 + wbytes + m * n * 4
        b, kind = bound_ms(nbytes, 2 * m * k * n, "bf16")
        t_k, t_p = graph_ms(kern), graph_ms(plain, reps=3)
        t_l = graph_ms(library, reps=3 if m == 60 else 20)
        log(f"time matmul_w8a16 M={m} K={k} N={n}: {t_k:.4f} ms, plain {t_p:.4f} ms, "
            f"_weight_int8pack_mm {t_l:.4f} ms, bound {b:.4f} ms ({kind}), "
            f"{nbytes / (t_k * 1e-3) / 1e9:.0f} GB/s", stdout=m == 16)
        row = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b, bound_by=kind)
        if m == 16:
            report["matmul_w8a16"].update(row, shape=f"lm_head M=16, K={k}, N={n}, f32 out")
        else:
            report["matmul_w8a16"][f"head_m{m}"] = row
    del rot, rot_t
    torch.cuda.empty_cache()

    # attention at the verify width (B=4, contexts of 1-4 pages) over the
    # bf16 cache and the 8-bit ones (1-byte entries, + f32 per-token scales
    # for int8 and e4m3); each input set rotated past L2, as the GEMMs' are
    for q_len in (1, 4, 128):
        parts = []
        for kv_dtype in ("bfloat16", *KV8):
            name = "paged_attention" if kv_dtype == "bfloat16" else f"paged_attention_{kv_dtype}"
            live = _ctx_lens(q_len)
            B, Hq, Hkv, D = 4, 32, 8, 128
            entry = 2 if kv_dtype == "bfloat16" else 1
            kv_bytes = sum(live) * Hkv * D * 2 * entry
            sc_bytes = sum(live) * Hkv * 2 * 4 if kv_dtype in ("int8", "fp8_e4m3") else 0
            rot = Rotating(lambda: (_attn_inputs(gen, q_len) if kv_dtype == "bfloat16"
                                    else _attn_inputs_kv(gen, q_len, kv_dtype)),
                           kv_bytes + sc_bytes)
            q, _, tables, _ = rot.sets[0]

            def kern():
                q, cache, tables, ctx = rot.next()
                paged_attention_cuda(q, cache.kv_pages, tables, ctx, 128 ** -0.5,
                                     layer=1, kv_scales=cache.kv_scales)

            def plain():
                q, cache, tables, ctx = rot.next()
                paged_attention_ref(q, cache, 1, tables, ctx, 128 ** -0.5)
            t_k, t_p = graph_ms(kern), graph_ms(plain, reps=3)
            nbytes = 2 * q.numel() * 2 + kv_bytes + sc_bytes + tables.numel() * 4 + 8 * B
            # causal work: query i of a row sees ctx - Q + i + 1 positions
            seen = sum(sum(c - q_len + i + 1 for i in range(q_len)) for c in live)
            b, kind = bound_ms(nbytes, 4 * Hq * D * seen, "bf16")
            parts.append(f"{kv_dtype} {t_k:.4f} (plain {t_p:.4f}, bound {b:.5f} {kind})")
            if q_len == 4:
                report[name].update(ms=t_k, plain_ms=t_p, library_ms=None, bound_ms=b,
                                    bound_by=kind, shape=f"B=4, Q=4, ctx={live}, "
                                    f"{kv_dtype} KV")
            del rot, q, tables
        log(f"time paged_attention B=4 Q={q_len} ctx={live}, ms by KV entry: "
            + "; ".join(parts), stdout=q_len == 4)   # Q=1 and 128 in the log
        torch.cuda.empty_cache()


def _time_w4g_layer(gen, shapes, m, library: bool, group: int = GROUP) -> dict:
    """One layer's four grouped projections at M = ``m`` and group size
    ``group``: kernel, plain version and torch._weight_int4pack_mm (weights
    converted once, outside the timing), each input set rotated past L2;
    the bound from this call's bytes (x, packed weights, scales and
    offsets, out) and operations."""
    from qspec_tpu_torch.ops import linear_kernels as lk
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0 if library else None}
    nbytes_tot = ops_tot = 0
    per = []
    for k, n in shapes:
        wbytes = k * n // 2 + 2 * (k // group) * n * 4
        rot = Rotating(lambda k=k, n=n: _w4g(gen, k, n, group=group), wbytes)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)

        def kern():
            lk.matmul_w4a16_g(x, *rot.next())

        def plain():
            lk.matmul_w4a16_g_ref(x, *rot.next())
        nbytes = m * k * 2 + wbytes + m * n * 2
        tot["bound_ms"] += bound_ms(nbytes, 2 * m * k * n, "bf16")[0]
        t_k = graph_ms(kern, reps=max(20, len(rot.sets)))
        tot["ms"] += t_k
        tot["plain_ms"] += graph_ms(plain, reps=3)
        t_l = None
        if library:
            rot_l = Rotating(lambda k=k, n=n: _int4pack(*_w4g(gen, k, n, group=group)), wbytes)

            def lib_call():
                packed, sz = rot_l.next()
                torch._weight_int4pack_mm(x, packed, group, sz)
            t_l = graph_ms(lib_call, reps=max(20, len(rot_l.sets)))
            tot["library_ms"] += t_l
            del rot_l
        per.append(f"{t_k:.4f}" + ("" if t_l is None else f"/{t_l:.4f}"))
        nbytes_tot += nbytes
        ops_tot += 2 * m * k * n
        del rot
        torch.cuda.empty_cache()
    return dict(tot, bound_by=bound_ms(nbytes_tot, ops_tot, "bf16")[1], per=per,
                nbytes=nbytes_tot)


def time_w4a16_g(gen, report, int4pack_missing):
    """The grouped GEMM per layer (the four projections) of Llama-3-8B and
    Gemma-2-9B at the draft width M=4, the verify width M=16 and the Medusa
    tree verify's M=60 (4 x (prefix 5 + 10 nodes)), g = 128, beside the
    yardstick torch._weight_int4pack_mm on the same weights."""
    library = int4pack_missing is None
    rows = {}
    for model, shapes in (("llama3-8b", GEMM_SHAPES), ("gemma2-9b", GEMMA_SHAPES)):
        for m in (4, 16, 60):
            r = _time_w4g_layer(gen, shapes, m, library)
            per, nbytes = r.pop("per"), r.pop("nbytes")
            r["shape"] = f"{model}: one layer's qkv+o+gate_up+down at M={m}, g={GROUP}"
            rows[(model, m)] = r
            line = (f"time matmul_w4a16_g {model} M={m} g={GROUP}, one layer: {r['ms']:.4f} ms, "
                    f"plain {r['plain_ms']:.4f}, library "
                    + (f"{r['library_ms']:.4f}" if library else "none")
                    + f", bound {r['bound_ms']:.4f} ms, {r['ms'] / m:.5f} ms/row")
            log(line, stdout=False)
            log(f"  per projection (kernel" + ("/_weight_int4pack_mm" if library else "")
                + f"): {', '.join(per)} ms; {nbytes} bytes", stdout=False)
    report["matmul_w4a16_g"].update(rows[("llama3-8b", 16)])
    # the other rows without their shape string: the key names it
    rest = {key: {k: v for k, v in r.items() if k != "shape"} for key, r in rows.items()}
    report["matmul_w4a16_g"]["m4_draft"] = rest[("llama3-8b", 4)]
    report["matmul_w4a16_g"]["m60_tree_verify"] = rest[("llama3-8b", 60)]
    report["matmul_w4a16_g"]["gemma2_9b"] = {f"m{m}": rest[("gemma2-9b", m)] for m in (4, 16, 60)}
    if int4pack_missing:
        report["matmul_w4a16_g"]["library_note"] = int4pack_missing


def time_attention_window(gen, report):
    """The draft's attention at B=4, context 2048, window 128, Q=1 (a draft
    step) and Q=4, beside the unwindowed kernel on the same inputs; the
    windowed bound counts only the pages the window reaches."""
    from qspec_tpu_torch.ops.attention import paged_attention_ref
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    B, Hq, Hkv, D, S, W, C = 4, 32, 8, 128, 128, 128, 2048
    for q_len in (1, 4):
        ctx = (C,) * B
        q_start = C - q_len
        first = max(q_start - W + 1, 0) // S
        n_pages = -(-C // S) - first              # the pages the window reaches
        kv_bytes = B * n_pages * S * Hkv * D * 2 * 2
        # each timing rotates its inputs past L2: whole caches without the
        # window, only the reachable pages with it
        rots = {None: Rotating(lambda: _attn_window_inputs(gen, q_len, "bfloat16", ctx),
                               B * C * Hkv * D * 2 * 2),
                W: Rotating(lambda: _attn_window_inputs(gen, q_len, "bfloat16", ctx,
                                                        live_pages=n_pages), kv_bytes)}
        times = {}
        for window, rot in rots.items():
            def kern(window=window, rot=rot):
                q, cache, tables, c = rot.next()
                paged_attention_cuda(q, cache.kv_pages, tables, c, 128 ** -0.5, layer=1,
                                     window=window)
            # one graph replays every input set once
            times[window] = graph_ms(kern, reps=max(20, len(rot.sets)))

        def plain():
            q, cache, tables, c = rots[W].next()
            paged_attention_ref(q, cache, 1, tables, c, 128 ** -0.5, window=W)
        t_p = graph_ms(plain, reps=3)
        nbytes = 2 * B * q_len * Hq * D * 2 + kv_bytes + B * (C // S) * 4 + 8 * B
        seen = B * sum(min(W, q_start + i + 1) for i in range(q_len))
        b, kind = bound_ms(nbytes, 4 * Hq * D * seen, "bf16")
        log(f"time paged_attention window={W} B={B} Q={q_len} ctx={C}: {times[W]:.4f} ms "
            f"(no window {times[None]:.4f} ms), plain {t_p:.4f}, bound {b:.5f} ({kind}; "
            f"{n_pages} of {C // S} pages per row)")
        if q_len == 1:
            report["paged_attention"]["window"].update(
                ms=times[W], no_window_ms=times[None], plain_ms=t_p, bound_ms=b,
                bound_by=kind, shape=f"B={B}, Q=1, ctx={C}, window={W}, bf16 KV")
        del rots
        torch.cuda.empty_cache()


def time_attention_d256(gen, report):
    """Gemma-2-9B's attention at the verify width: B=4, Q=4, Hq=16, Hkv=8,
    D=256, page 128, contexts of 1-4 pages, with the softcap 50 and without,
    over bf16 and int8 caches, inputs rotated past L2."""
    from qspec_tpu_torch.ops.attention import paged_attention_ref
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    B, q_len, Hq, Hkv, D = 4, 4, 16, 8, 256
    live = _ctx_lens(q_len)
    for kv_dtype in ("bfloat16", "int8"):
        name = "paged_attention" if kv_dtype == "bfloat16" else "paged_attention_int8"
        entry = 2 if kv_dtype == "bfloat16" else 1
        kv_bytes = sum(live) * Hkv * D * 2 * entry
        sc_bytes = sum(live) * Hkv * 2 * 4 if kv_dtype == "int8" else 0

        def make():
            if kv_dtype == "bfloat16":
                return _attn_inputs(gen, q_len, Hq=Hq, D=D)
            return _attn_inputs_kv(gen, q_len, kv_dtype, Hq=Hq, D=D)
        rot = Rotating(make, kv_bytes + sc_bytes)
        _, _, tables, _ = rot.sets[0]
        times = {}
        for cap in (50.0, None):
            def kern(cap=cap):
                q, cache, tables, ctx = rot.next()
                paged_attention_cuda(q, cache.kv_pages, tables, ctx, D ** -0.5, layer=1,
                                     kv_scales=cache.kv_scales, softcap=cap)
            times[cap] = graph_ms(kern, reps=max(20, len(rot.sets)))

        def plain():
            q, cache, tables, ctx = rot.next()
            paged_attention_ref(q, cache, 1, tables, ctx, D ** -0.5, softcap=50.0)
        t_p = graph_ms(plain, reps=3)
        nbytes = 2 * B * q_len * Hq * D * 2 + kv_bytes + sc_bytes + tables.numel() * 4 + 8 * B
        seen = sum(sum(c - q_len + i + 1 for i in range(q_len)) for c in live)
        b, kind = bound_ms(nbytes, 4 * Hq * D * seen, "bf16")
        log(f"time {name} D=256 softcap 50 B=4 Q=4 Hq=16 ctx={live}: {times[50.0]:.4f} ms "
            f"(no softcap {times[None]:.4f}), plain {t_p:.4f}, bound {b:.5f} ({kind})")
        report[name]["d256_softcap"].update(
            ms=times[50.0], no_softcap_ms=times[None], plain_ms=t_p, bound_ms=b, bound_by=kind,
            shape=f"B=4, Q=4, Hq=16, Hkv=8, D=256, ctx={live}, {kv_dtype} KV, softcap 50")
        del rot
        torch.cuda.empty_cache()


LONG_CTX = 8192      # the long-context rows: 32 splits of 256 tokens


def time_attention_long(gen, report):
    """Where the bytes, not launch latency, set the bound: B=4, Q=4, context
    8192 (Hq=32, Hkv=8, D=128, page 128) over a bf16 and an int8 cache, and a
    prefill chunk of Q=512 on one row of context 512 (bf16); each input set
    rotated past L2."""
    from qspec_tpu_torch.ops.attention import paged_attention_ref
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    Hq, Hkv, D = 32, 8, 128
    rows = {}
    for label, q_len, ctx, kv_dtype in (("ctx8192_bf16", 4, (LONG_CTX,) * 4, "bfloat16"),
                                        ("ctx8192_int8", 4, (LONG_CTX,) * 4, "int8"),
                                        ("prefill_q512_ctx512", 512, (512,), "bfloat16")):
        B = len(ctx)
        entry = 2 if kv_dtype == "bfloat16" else 1
        kv_bytes = sum(ctx) * Hkv * D * 2 * entry
        sc_bytes = sum(ctx) * Hkv * 2 * 4 if kv_dtype == "int8" else 0
        q_bytes = B * q_len * Hq * D * 2
        rot = Rotating(lambda: _attn_window_inputs(gen, q_len, kv_dtype, ctx),
                       kv_bytes + sc_bytes + 2 * q_bytes)

        def kern():
            q, cache, tables, c = rot.next()
            paged_attention_cuda(q, cache.kv_pages, tables, c, D ** -0.5, layer=1,
                                 kv_scales=cache.kv_scales)

        def plain():
            q, cache, tables, c = rot.next()
            paged_attention_ref(q, cache, 1, tables, c, D ** -0.5)
        q, cache, tables, c = rot.sets[0]
        err = (paged_attention_cuda(q, cache.kv_pages, tables, c, D ** -0.5, layer=1,
                                    kv_scales=cache.kv_scales).float()
               - paged_attention_ref(q, cache, 1, tables, c, D ** -0.5).float()).abs().max().item()
        t_k = graph_ms(kern, reps=max(20, len(rot.sets)))
        t_p = graph_ms(plain, reps=2)
        nbytes = 2 * q_bytes + kv_bytes + sc_bytes + tables.numel() * 4 + 8 * B
        seen = sum(sum(n - q_len + i + 1 for i in range(q_len)) for n in ctx)
        b, kind = bound_ms(nbytes, 4 * Hq * D * seen, "bf16")
        rows[label] = dict(ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=kind,
                           share_of_bound=b / t_k, max_abs_err=err,
                           shape=f"B={B}, Q={q_len}, Hq=32, Hkv=8, D=128, ctx={ctx[0]}, "
                           f"{kv_dtype} KV")
        log(f"time paged_attention {label} (B={B} Q={q_len}): {t_k:.4f} ms, plain {t_p:.4f}, "
            f"bound {b:.5f} ({kind}, {100 * b / t_k:.1f}%); max_abs_err {err:.3g}")
        del rot, q, cache, tables, c
        torch.cuda.empty_cache()
    report["paged_attention"]["long"] = rows


TINY_GEMMA2 = dict(model_type="gemma2", vocab_size=512, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
                   head_dim=256, query_pre_attn_scalar=24, sliding_window=16,
                   attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                   rms_norm_eps=1e-6, tie_word_embeddings=True, max_position_embeddings=256)


TINY_BLOOM = dict(model_type="bloom", vocab_size=512, hidden_size=256, n_layer=2, n_head=4)


def phase_small_reference(lm_head_quant: str, kv_dtype: str, quant: str = "w4"):
    """The tiny model on the card (kernels) against the same weights on the
    CPU (plain versions). w4g: an AWQ checkpoint (g = 128, so the MLP is
    widened to 512 for the kernel's K % 256), W4A16 only; "gemma2": a tiny
    AWQ Gemma-2 (head dim 256, softcaps, post norms, the alternating window
    over 24 > 16 positions, tied int8 head); "bloom": a tiny bf16 BLOOM
    (the bf16 scheme, ALiBi at head dim 64 padded, LayerNorm, biases, the
    embedding LayerNorm, tied bf16 head)."""
    from qspec_tpu_torch.config import ModelConfig
    from qspec_tpu_torch.models.llama import AttentionBatch, init_params, model_forward
    from qspec_tpu_torch.ops import kv_cache as kvc
    w4g = quant in ("w4g", "gemma2")
    if quant == "gemma2":
        cfg = dataclasses.replace(ModelConfig.from_hf_config(TINY_GEMMA2), quant="w4g")
    elif quant == "bloom":
        cfg = ModelConfig.from_hf_config(TINY_BLOOM)
    else:
        cfg = ModelConfig.tiny(lm_head_quant=lm_head_quant, quant=quant,
                               **({"intermediate_size": 512} if w4g else {}))
    cpu = init_params(cfg, seed=3, device="cpu", group_size=GROUP)

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
    schemes = ((("bf16", 2e-2),) if quant == "bloom" else
               (("w4a16", 2e-2),) + (() if w4g else (("w4a8", 5e-2), ("w4a4", 0.3))))
    for scheme, tol in schemes:
        outs = []
        for dev, params in (("cpu", cpu), ("cuda", gpu)):
            cache = kvc.allocate(kvc.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                                   cfg.cache_head_dim, 8, S, kv_dtype), dev)
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
        log(f"check tiny {quant} model_forward {scheme} (head {lm_head_quant}, {kv_dtype} KV): "
            f"rel L2 {rel:.3g} vs the CPU (tol {tol}), "
            f"max abs {(out - ref).abs().max().item():.3g}", stdout=False)
        if rel > tol:
            raise AssertionError(f"tiny {scheme} logits differ: relative L2 {rel} > {tol}")


TRUNK_KERNELS = ("matmul_w4a16", "matmul_w4a4", "rmsnorm", "rmsnorm_quant")


def path_kernels(kw: dict) -> set:
    """The kernels (attention: the instantiation) that the engine path of
    ``kw`` launches: the trunk's, the int8 head's unless the head is bf16,
    and the attention instantiation of its KV entry type."""
    kv = kw.get("kv_cache_dtype", "bfloat16")
    return {*TRUNK_KERNELS,
            "paged_attention" if kv == "bfloat16" else f"paged_attention_{kv}",
            *(() if kw.get("lm_head_quant") == "bf16" else ("matmul_w8a16",))}


def generate(engine, prompts, max_tokens: int):
    """Greedy tokens of each prompt through an LLMEngine (LLM.generate's loop)."""
    from qspec_tpu_torch import SamplingParams
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True)
    ids = [engine.add_request(list(p), sp) for p in prompts]
    outs = {}
    while engine.has_unfinished_requests():
        for o in engine.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
    return [outs[i] for i in ids]


ATTN_OPTIONS = ("window", "softcap", "d256", "d384", "d640", "tree", "alibi")
NORMS = ("rmsnorm", "rmsnorm_quant")


def spec_vs_oracle(make, label: str, expect: set, prompts, max_tokens: int,
                   every_launch=(), methods=("qspec", "qspec_null")):
    """Greedy generation through the speculative method ``methods[0]``, then
    through its oracle ``methods[1]`` (the same rounds with the proposals
    nulled) on the same weights. ``make(method, params)`` builds the
    LLMEngine (params None: the factory makes them). The launch counts are
    those of the speculative run only (set to 0 just before it, read just
    after): every kernel of ``expect`` must have launched, and no other (each
    attention instantiation on its own path). The attention's launches under
    a window, with a softcap, at head dims 256, 384 and 640 and under a tree
    mask are counted apart: each option of ``every_launch`` must be on every
    attention launch, the softcap, those head dims and ALiBi on none
    otherwise; the launches
    come back with each norm's fused ones (``<norm>_fused``) and rmsnorm's
    with a gamma (``rmsnorm_gamma``); the tree launches are returned
    (``rounds_run`` beside them: the verify passes of
    the run, and ``forwards``: those and the prompt forwards) for the caller
    to check."""
    from qspec_tpu_torch.ops import kernel_wrappers
    eng = make(methods[0], None)
    torch.cuda.synchronize()

    counters = kernel_wrappers()
    attn = {n: c for n, c in counters.items() if n.startswith("paged_attention")}
    for c in counters.values():
        c.launches = 0
    for c in attn.values():
        for opt in ATTN_OPTIONS:
            setattr(c, f"{opt}_launches", 0)
    for name in NORMS:
        counters[name].fused_launches = 0
    counters["rmsnorm"].gamma_launches = 0
    t0 = time.perf_counter()
    spec = generate(eng, prompts, max_tokens)
    torch.cuda.synchronize()
    t_spec = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    fused = {name: counters[name].fused_launches for name in NORMS}
    gamma = counters["rmsnorm"].gamma_launches
    opts = {name: {opt: getattr(c, f"{opt}_launches") for opt in ATTN_OPTIONS}
            for name, c in attn.items()}
    m = eng.spec_metrics
    rounds_run = eng.runner.spec_rounds_run
    forwards = eng.runner.target_forwards
    draft_forwards = eng.runner.draft_forwards

    params = eng.runner.params
    del eng
    torch.cuda.empty_cache()
    oracle = make(methods[1], params)
    t0 = time.perf_counter()
    ar = generate(oracle, prompts, max_tokens)
    torch.cuda.synchronize()
    t_ar = time.perf_counter() - t0
    del oracle

    if any(len(t) != max_tokens for t in spec) or spec != ar:
        raise AssertionError(f"{label}: greedy {methods[0]} tokens differ from the "
                             f"{methods[1]} oracle: {[t[:8] for t in spec]} vs "
                             f"{[t[:8] for t in ar]}")
    launched = {n for n, c in launches.items() if c > 0}
    if launched != expect:
        raise AssertionError(f"{label}: kernels launched on the path: {sorted(launched)}, "
                             f"expected {sorted(expect)}")
    # every forward's first input norm has no residual, and every norm
    # after an add takes it in (models/llama.py): some of each
    for name, k in fused.items():
        if launches[name] and not 0 < k < launches[name]:
            raise AssertionError(f"{label}: {name} launched {launches[name]} times, {k} of "
                                 "them with the residual add")
        launches[f"{name}_fused"] = k
    launches["rmsnorm_gamma"] = gamma
    for name, o in opts.items():
        for opt in ("softcap", "d256", "d384", "d640", "alibi", *every_launch):
            if o[opt] != (launches[name] if opt in every_launch else 0):
                raise AssertionError(f"{label}: {name} launched {launches[name]} times, "
                                     f"{o[opt]} of them with {opt}")
    n_tok = sum(len(t) for t in spec)
    return spec, launches, opts, {
        "acceptance_rate": m.draft_acceptance_rate,
        "emitted_per_round_per_seq": m.num_emitted_tokens / max(
            m.num_emitted_tokens - m.num_draft_accepted, 1),
        "spec_tokens_per_s": n_tok / t_spec, "oracle_tokens_per_s": n_tok / t_ar,
        "drafted_accepted_emitted": [
            m.num_draft_tokens, m.num_draft_accepted, m.num_emitted_tokens],
        **({"rounds_run": rounds_run, "forwards": forwards} if rounds_run else {}),
        **({"target_forwards": forwards, "draft_forwards": draft_forwards}
           if draft_forwards else {}),
        **({"attn_option_launches": {n: {k: v for k, v in o.items() if v}
                                     for n, o in opts.items() if any(o.values())}}
           if any(any(o.values()) for o in opts.values()) else {})}


# the labels of the end-to-end runs logged (the standard output has their
# count, the log each one's line)
_E2E = []


def e2e_log(label: str, prompts, spec, summary: dict):
    """One line per end-to-end run to the log: its token and prompt counts
    and its summary (floats to 5 significant digits)."""
    short = {k: float(f"{v:.5g}") if isinstance(v, float) else v for k, v in summary.items()}
    head = f"e2e {label}: {len(prompts)}x{len(spec[0])} greedy tokens == oracle's: "
    log(head + json.dumps(short, separators=(",", ":")), stdout=False)
    _E2E.append(label)


def llm_engine(kw: dict):
    """The engine factory of an LLM(**kw) path (random weights from its seed
    on the first call)."""
    from qspec_tpu_torch import LLM
    return lambda method, params: LLM(params=params, speculative_method=method,
                                      **kw).llm_engine


def llm_label(kw: dict) -> str:
    return (f"{kw['model']} (head {kw.get('lm_head_quant', 'auto')}, "
            f"{kw.get('kv_cache_dtype', 'bfloat16')} KV, "
            f"{kw.get('speculative_draft_scheme', 'w4a4')} draft"
            + (f", window {kw['spec_draft_kv_window']}" if kw.get("spec_draft_kv_window")
               else "") + ")")


def phase_tiny_end_to_end():
    """The tiny model through the engine on the card: drafts are accepted
    here, so bit-exactness is exercised on accepted positions too."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 500, size=int(rng.integers(5, 40))).tolist()
               for _ in range(4)]
    kw = dict(model="tiny", device="cuda", lm_head_quant="bf16",
              num_speculative_tokens=3, block_size=16, max_model_len=256,
              max_num_seqs=4, prefill_chunk_size=64, seed=0)
    runs = [(kw, None)]
    # the defaults (int8 head) over each 8-bit cache
    base = {k: v for k, v in kw.items() if k != "lm_head_quant"}
    runs += [({**base, "kv_cache_dtype": dt}, dt) for dt in KV8]
    # the windowed W4A8 draft on its ring pool (window 24: 4 pages of 16)
    runs.append(({**kw, "speculative_draft_scheme": "w4a8", "spec_draft_kv_window": 24},
                 "window"))
    launches = {}
    for run_kw, key in runs:
        spec, launches[key], opts, summary = spec_vs_oracle(
            llm_engine(run_kw), llm_label(run_kw), path_kernels(run_kw), prompts, 20)
        e2e_log(llm_label(run_kw), prompts, spec, summary)
        if summary["acceptance_rate"] <= 0:
            raise AssertionError(f"{llm_label(run_kw)}: no draft token was accepted")
        if (key == "window") != any(o["window"] for o in opts.values()):
            raise AssertionError(f"{llm_label(run_kw)}: windowed attention launches "
                                 f"{opts}")
    return launches


def _e2e_8b(kw: dict, prompts, smi: str):
    """One 8B path: the W4A4 draft (launch counts read from it), then the
    W4A8 draft, whose drafts are accepted at this width."""
    torch.cuda.reset_peak_memory_stats()
    spec, launches, _, summary = spec_vs_oracle(llm_engine(kw), llm_label(kw),
                                                path_kernels(kw), prompts, 32)
    summary.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    e2e_log(llm_label(kw), prompts, spec, summary)
    # random weights leave the W4A4 draft no agreement with the target at
    # this width; the W4A8 draft (same kernels, 8-bit activations) does
    # agree, which holds the invariant on accepted positions at full width
    w4a8_kw = {**kw, "speculative_draft_scheme": "w4a8"}
    spec, _, _, w4a8 = spec_vs_oracle(llm_engine(w4a8_kw), llm_label(w4a8_kw),
                                      path_kernels(w4a8_kw), prompts, 32)
    e2e_log(llm_label(w4a8_kw), prompts, spec, w4a8)
    if w4a8["acceptance_rate"] <= 0:
        raise AssertionError("llama3-8b w4a8 draft: no draft token was accepted")
    torch.cuda.empty_cache()
    return launches


def e2e_prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 128000, size=int(n)).tolist()
            for n in rng.integers(64, 193, size=4)]


def phase_end_to_end(smi: str):
    prompts = e2e_prompts()
    log(f"e2e prompts of the 8B runs: {[len(p) for p in prompts]} random token ids")
    base = dict(model="llama3-8b", device="cuda", quantization="qspec",
                num_speculative_tokens=3, max_model_len=512, max_num_seqs=4, seed=0)
    # the first slice's path: the bf16 head over a bf16 cache
    first = _e2e_8b({**base, "lm_head_quant": "bf16"}, prompts, smi)
    # the second slice's path: LLM(model="llama3-8b") at the JAX package's
    # defaults (no head argument: the int8 head) with an int8 KV cache
    default = _e2e_8b({**base, "kv_cache_dtype": "int8"}, prompts, smi)
    return first, default


# the kernels of the w4g path: no Hadamards and no quantized activations
W4G_KERNELS = {"matmul_w4a16_g", "rmsnorm", "paged_attention", "matmul_w8a16"}


# the least acceptance of run (b), the unwindowed W4A16 draft (arithmetically
# the target but for the last prompt position's draft KV, which its first
# backfill recomputes at draft width), and why
MIN_ACCEPT_B = {"llama3-8b": 0.5, "gemma2-9b": 0.0}


def phase_grouped_8b(model: str, smi: str):
    """An AWQ checkpoint (g = 128, all layers) made on the card
    (model_loader.grouped: the torch make_awq_tensors, then load_awq) with
    the int8 head, through LLMEngine, QSpec with the W4A16 draft (a) under
    draft_kv_window=64 on its ring pool and (b) with no window, each against
    its qspec_null oracle. ``model``: "llama3-8b" (the third slice's path;
    (a) runs again on a full draft pool, QSPEC_RING_DRAFT=0, which must give
    the same tokens and draft counts, or the ring read a stale page) or
    "gemma2-9b" (this slice's: Gemma-2-9B's published widths, resolved
    from its config.json by the registry; every attention launch is the
    D=256 instantiation with the softcap, the target's even layers and the
    windowed draft's every layer run under a window). (b)'s draft is
    arithmetically the target, but for the last prompt position, so it is
    accepted."""
    from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                                 SchedulerConfig, SpeculativeConfig)
    from qspec_tpu_torch.config import GEMMA2_9B_HF
    from qspec_tpu_torch.models.llama import init_params
    from qspec_tpu_torch.models.registry import resolve
    from qspec_tpu_torch.spec_decode.medusa_tree import DEFAULT_TREE
    gemma = model == "gemma2-9b"
    # Gemma-2-9B's published config.json, written out in config.py
    cfg = (dataclasses.replace(resolve(GEMMA2_9B_HF), quant="w4g") if gemma
           else ModelConfig.llama3_8b(quant="w4g"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", group_size=GROUP)
    torch.cuda.synchronize()
    log(f"e2e {model} AWQ g={GROUP}, {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"head dim {cfg.head_dim}, vocab {cfg.vocab_size}: checkpoint made and loaded on "
        f"the card in {time.perf_counter() - t0:.1f} s, head {sorted(params['lm_head'])}")
    prompts = e2e_prompts()
    out = {}

    def make(method, p, window, ring_pages):
        spec = SpeculativeConfig(num_speculative_tokens=3, draft_scheme="w4a16",
                                 draft_kv_window=window, method=method)
        eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=128),
                                     scheduler=SchedulerConfig(max_num_seqs=4,
                                                               max_model_len=512),
                                     speculative=spec), p or params,
                        device="cuda", seed=0)
        if eng.runner._ring_pages != ring_pages:
            raise AssertionError(f"draft pool: {eng.runner._ring_pages} ring pages")
        return eng

    for key, window in (("a", 64), ("b", None)):
        label = f"{model} AWQ g={GROUP} (int8 head, bf16 KV, w4a16 draft, " + \
            (f"window {window}, ring pool)" if window else "no window)")
        spec, launches, opts, summary = spec_vs_oracle(
            lambda m, p, w=window: make(m, p, w, 3 if w else 0), label, W4G_KERNELS,
            prompts, 32, every_launch=("softcap", "d256") if gemma else ())
        summary.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        e2e_log(label, prompts, spec, summary)
        n_win, n_attn = opts["paged_attention"]["window"], launches["paged_attention"]
        # Gemma-2's odd layers are global in the target, its even ones
        # sliding (4096); a Llama has a window only in the windowed draft
        if not ((0 < n_win < n_attn) if gemma else ((n_win > 0) == bool(window))):
            raise AssertionError(f"{label}: {n_win} of {n_attn} attention launches windowed")
        out[key] = (launches, opts, summary)
        if key == "a" and not gemma:
            os.environ["QSPEC_RING_DRAFT"] = "0"
            eng = make("qspec", None, window, 0)
            del os.environ["QSPEC_RING_DRAFT"]
            full = generate(eng, prompts, 32)
            m = eng.spec_metrics
            counts = [m.num_draft_tokens, m.num_draft_accepted, m.num_emitted_tokens]
            del eng
            torch.cuda.empty_cache()
            log(f"e2e {label} on a full draft pool: draft counts {counts}, tokens "
                f"{'==' if full == spec else '!='} the ring's")
            if full != spec or counts != summary["drafted_accepted_emitted"]:
                raise AssertionError(f"{label}: the ring pool and the full pool differ: "
                                     f"counts {summary['drafted_accepted_emitted']} vs "
                                     f"{counts}")
    acc_b = out["b"][2]["acceptance_rate"]
    if acc_b <= MIN_ACCEPT_B[model]:
        raise AssertionError(f"{model} AWQ w4a16 draft, no window: acceptance {acc_b} <= "
                             f"{MIN_ACCEPT_B[model]}")
    if gemma:
        # the Medusa tree on the same checkpoint: every attention launch is the
        # D=256 softcap instantiation, layers x rounds of them tree-masked; the
        # random Gemma-2 repeats its last token, so the lm_head-seeded heads'
        # proposals are accepted (the descending walk and the re-proposal
        # from the last accepted node's hidden state, at full width)
        params["medusa"] = medusa_heads(params, cfg)

        def make_medusa(method, p):
            spec = SpeculativeConfig(num_speculative_tokens=MEDUSA_K, method=method,
                                     medusa_tree=DEFAULT_TREE)
            return LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=128),
                                          scheduler=SchedulerConfig(max_num_seqs=4,
                                                                    max_model_len=512),
                                          speculative=spec), p or params,
                             device="cuda", seed=0)
        out["tree"] = medusa_run(make_medusa, f"{model} AWQ Medusa tree (int8 head, bf16 KV)",
                                 W4G_KERNELS, prompts, cfg.num_layers, True,
                                 every_launch=("softcap", "d256"))
        acc = out["tree"][2]["acceptance_rate"]
        if acc <= 0.5:
            raise AssertionError(f"{model} AWQ Medusa tree: acceptance {acc} <= 0.5")
    log(f"e2e {model} AWQ: card {smi}", stdout=False)
    del params
    torch.cuda.empty_cache()
    return out


# the kernels of the Medusa path on a QuaRot checkpoint: the verify scheme's
# only (no draft forward: no w4a4, no rmsnorm_quant)
MEDUSA_KERNELS = {"matmul_w4a16", "rmsnorm", "paged_attention", "matmul_w8a16"}
MEDUSA_K = 4


def medusa_heads(params, cfg):
    """MEDUSA_K heads seeded from the model's own head (w1 = 0: each
    proposes the t + 1 token), made on the card."""
    from qspec_tpu_torch.spec_decode.medusa import init_medusa_params, lm_head_weight
    lm = lm_head_weight(params["lm_head"])
    heads = init_medusa_params(cfg.hidden_size, cfg.vocab_size, MEDUSA_K, lm_head=lm)
    del lm
    torch.cuda.empty_cache()
    return heads


def medusa_run(make, label, expect, prompts, layers: int, tree: bool, every_launch=()):
    """A Medusa run (chain or tree) against its medusa_null oracle: greedy
    tokens equal, exactly the ``expect`` kernels launched, and the tree mask
    on layers x rounds attention launches in a tree run, on none in a chain
    run."""
    spec, launches, opts, summary = spec_vs_oracle(
        make, label, expect, prompts, 32, every_launch=every_launch,
        methods=("medusa", "medusa_null"))
    n_tree = sum(o["tree"] for o in opts.values())
    want = layers * summary.get("rounds_run", 0) if tree else 0
    if n_tree != want or (tree and not want):
        raise AssertionError(f"{label}: {n_tree} tree launches, expected {want} "
                             f"({layers} layers x {summary.get('rounds_run')} rounds)")
    summary["tree_launches"] = n_tree
    summary["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    e2e_log(label, prompts, spec, summary)
    return launches, opts, summary


def phase_medusa_8b(smi: str):
    """Medusa at Llama-3-8B width through LLM: QuaRot, the JAX package's
    defaults (int8 head, bf16 KV), random weights and 4 lm_head-seeded heads
    made on the card; (c) the chain, k = 4, (d) the candidate tree
    (DEFAULT_TREE: 10 nodes, prefix 5, Q = 15)."""
    from qspec_tpu_torch import LLM
    from qspec_tpu_torch.config import ModelConfig
    from qspec_tpu_torch.models.llama import init_params
    cfg = ModelConfig.llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device="cuda")
    params["medusa"] = medusa_heads(params, cfg)
    prompts = e2e_prompts()
    out = {}
    for key, tree in (("c", None), ("d", "default")):
        kw = dict(model="llama3-8b", device="cuda", num_speculative_tokens=MEDUSA_K,
                  speculative_model="[medusa]", spec_medusa_tree=tree, max_model_len=512,
                  max_num_seqs=4, seed=0)
        label = f"llama3-8b Medusa {'tree' if tree else 'chain'} (int8 head, bf16 KV, k=4)"
        out[key] = medusa_run(
            lambda m, p, kw=kw: LLM(params=p or params, speculative_method=m, **kw).llm_engine,
            label, MEDUSA_KERNELS, prompts, cfg.num_layers, tree is not None)
    log(f"e2e llama3-8b Medusa: card {smi}", stdout=False)
    del params
    torch.cuda.empty_cache()
    return out


# the kernels of the float (bf16) path: its GEMMs, LayerNorm, GELU and head
# are torch ops, as they are XLA in the JAX package
FLOAT_KERNELS = {"paged_attention"}


def random_state_dict(entries, seed: int) -> dict:
    """A Hugging Face state dict of random bf16 tensors made on the card:
    ``entries`` (name, shape, kind): "w" normal(0.02), "b" normal(0.01),
    "gamma" 1 + normal(0.1), "one" / "zero" a LayerNorm's gamma / beta."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = {}
    for name, shape, kind in entries:
        if kind in ("w", "b", "gamma"):
            t = torch.randn(shape, generator=gen, device="cuda") * {"w": 0.02, "b": 0.01,
                                                                    "gamma": 0.1}[kind]
            sd[name] = (t + (kind == "gamma")).to(torch.bfloat16)
            del t
        else:
            sd[name] = (torch.ones if kind == "one" else torch.zeros)(
                shape, dtype=torch.bfloat16, device="cuda")
    return sd


def bloom_entries(cfg):
    """BLOOM's checkpoint names and shapes (transformer.*, the
    head-interleaved query_key_value, biases everywhere, the embedding
    LayerNorm; no lm_head.weight: the head is tied)."""
    H, V = cfg.hidden_size, cfg.vocab_size
    out = [("transformer.word_embeddings.weight", (V, H), "w")]
    norm = [("{}.weight", (H,), "one"), ("{}.bias", (H,), "zero")]
    out += [(n.format("transformer.word_embeddings_layernorm"), s, k) for n, s, k in norm]
    for li in range(cfg.num_layers):
        p = f"transformer.h.{li}."
        for ln in ("input_layernorm", "post_attention_layernorm"):
            out += [(n.format(p + ln), s, k) for n, s, k in norm]
        for name, n_out, n_in in (("self_attention.query_key_value", 3 * H, H),
                                  ("self_attention.dense", H, H),
                                  ("mlp.dense_h_to_4h", 4 * H, H), ("mlp.dense_4h_to_h", H, 4 * H)):
            out += [(p + name + ".weight", (n_out, n_in), "w"), (p + name + ".bias", (n_out,), "b")]
    return out + [(n.format("transformer.ln_f"), s, k) for n, s, k in norm]


def mpt_entries(cfg):
    """MPT's checkpoint names and shapes under no_bias (transformer.blocks.*,
    the fused Wqkv, bias-free LayerNorms, the head tied to wte)."""
    H, V = cfg.hidden_size, cfg.vocab_size
    out = [("transformer.wte.weight", (V, H), "w")]
    for li in range(cfg.num_layers):
        p = f"transformer.blocks.{li}."
        out += [(p + "norm_1.weight", (H,), "one"), (p + "attn.Wqkv.weight", (3 * H, H), "w"),
                (p + "attn.out_proj.weight", (H, H), "w"), (p + "norm_2.weight", (H,), "one"),
                (p + "ffn.up_proj.weight", (cfg.intermediate_size, H), "w"),
                (p + "ffn.down_proj.weight", (H, cfg.intermediate_size), "w")]
    return out + [("transformer.norm_f.weight", (H,), "one")]


@functools.lru_cache(maxsize=1)
def _pinned_chunk() -> torch.Tensor:
    # page-locked where there is a card (the CPU tests write through it too)
    return torch.empty(64 << 20, dtype=torch.uint8, pin_memory=torch.cuda.is_available())


def write_safetensors(path: str, tensors: dict) -> None:
    """A .safetensors file: the 8-byte little-endian header length, the JSON
    header (dtype, shape, byte range of each tensor, padded to 8 bytes) and
    the raw little-endian buffers, each copied to the file through one
    page-locked chunk of 64 MiB (no host tensor of its size)."""
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": {torch.bfloat16: "BF16", torch.float32: "F32",
                                  torch.float16: "F16", torch.uint8: "U8",
                                  torch.int32: "I32", torch.int64: "I64", torch.int8: "I8",
                                  torch.float8_e4m3fn: "F8_E4M3"}[t.dtype],
                        "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        buf = _pinned_chunk()
        for t in tensors.values():
            flat = t.contiguous().reshape(-1).view(torch.uint8)
            for off in range(0, flat.numel(), buf.numel()):
                part = flat[off:off + buf.numel()]
                buf[:part.numel()].copy_(part)
                f.write(buf[:part.numel()].numpy().data)


def float_prompts(vocab: int):
    """e2e_prompts' lengths (98-173 tokens) over ``vocab``; two of them repeat
    a span (40 and 24 tokens), so prompt lookup has proposals from the start."""
    rng = np.random.default_rng(0)
    ps = [rng.integers(1, vocab, size=int(n)).tolist() for n in rng.integers(64, 193, size=4)]
    ps[0] = (ps[0][:40] * 5)[:len(ps[0])]
    ps[2] = (ps[2][:24] * 8)[:len(ps[2])]
    return ps


def phase_bloom_7b1(smi: str):
    """BLOOM-7B1 at bigscience/bloom-7b1's published widths (config.py's
    BLOOM_7B1_HF: hidden 4096, 32 heads, 30 layers, vocab 250880, tied head)
    with random bf16 weights made on the card as a Hugging Face state dict
    (about 14 GB) and converted by model_loader.families.convert_bloom (the
    embedding LayerNorm and the query_key_value de-interleave at full width;
    each source tensor freed as it is converted). Through LLMEngine, n-gram
    lookup (k = 3) against its "null" oracle on float_prompts: greedy tokens
    equal, only the bf16 attention launched, every launch its ALiBi
    instantiation, 30 per forward."""
    from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, SchedulerConfig,
                                 SpeculativeConfig)
    from qspec_tpu_torch.config import BLOOM_7B1_HF
    from qspec_tpu_torch.model_loader.families import load_family_float
    from qspec_tpu_torch.models.registry import resolve
    cfg = resolve(BLOOM_7B1_HF)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = random_state_dict(bloom_entries(cfg), seed=0)
    n_bytes = sum(t.numel() * 2 for t in sd.values())
    params, cfg = load_family_float(sd, cfg)
    torch.cuda.synchronize()
    log(f"e2e bloom-7b1: {cfg.num_layers} layers, hidden {cfg.hidden_size}, vocab "
        f"{cfg.vocab_size}: {n_bytes / 1e9:.2f} GB of bf16 made and converted on the card in "
        f"{time.perf_counter() - t0:.1f} s, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB, tied head {params['lm_head'].data_ptr() == params['embed'].data_ptr()}")
    torch.cuda.reset_peak_memory_stats()         # the serving runs' own peak below
    prompts = float_prompts(cfg.vocab_size)

    def make(method, p):
        spec = SpeculativeConfig(num_speculative_tokens=3, method=method)
        return LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=128),
                                      scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=512),
                                      speculative=spec), p or params, device="cuda", seed=0)
    label = "bloom-7b1 bf16 (tied head, bf16 KV, n-gram k=3)"
    spec, launches, opts, summary = spec_vs_oracle(
        make, label, FLOAT_KERNELS, prompts, 32, every_launch=("alibi",),
        methods=("ngram", "null"))
    if launches["paged_attention"] != cfg.num_layers * summary["forwards"]:
        raise AssertionError(f"{label}: {launches['paged_attention']} attention launches, "
                             f"not {cfg.num_layers} x {summary['forwards']} forwards")
    summary["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    e2e_log(label, prompts, spec, summary)
    log(f"e2e bloom-7b1: card {smi}", stdout=False)
    del params
    torch.cuda.empty_cache()
    return launches, opts, summary


def phase_mpt_dir(smi: str):
    """MPT-7B's widths (config.py's MPT_7B_HF, mosaicml/mpt-7b's
    config.json: d_model 4096, 32 heads, vocab 50432, no_bias, expansion 4)
    cut to 2 layers, as a checkpoint directory written here (config.json and
    model.safetensors of random bf16 weights made on the card), served by
    LLM(model=<dir>, quantization=None): the port's safetensors reader,
    config_from_hf_dir and the family route. Greedy tokens of n-gram lookup
    (k = 3) equal AR's; the n-gram run launches only the ALiBi attention,
    2 per forward."""
    import tempfile
    from qspec_tpu_torch import LLM
    from qspec_tpu_torch.config import MPT_7B_HF, ModelConfig
    from qspec_tpu_torch.ops import kernel_wrappers
    hf = {**MPT_7B_HF, "n_layers": 2}
    cfg = ModelConfig.from_hf_config(hf)
    prompts = float_prompts(cfg.vocab_size)
    with tempfile.TemporaryDirectory() as d:
        sd = random_state_dict(mpt_entries(cfg), seed=1)
        write_safetensors(os.path.join(d, "model.safetensors"), sd)
        del sd
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(hf, f)
        kw = dict(model=d, quantization=None, device="cuda", max_model_len=512,
                  max_num_seqs=4, seed=0)
        out, walls = {}, {}
        for key, extra in (("ar", {}), ("ngram", dict(num_speculative_tokens=3,
                                                      speculative_model="[ngram]"))):
            eng = LLM(**kw, **extra).llm_engine
            counters = kernel_wrappers()
            attn = counters["paged_attention"]
            for c in counters.values():
                c.launches = 0
            attn.alibi_launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[key] = generate(eng, prompts, 32)
            torch.cuda.synchronize()
            walls[key] = time.perf_counter() - t0
            launched = {n for n, c in counters.items() if c.launches > 0}
            forwards = eng.runner.target_forwards
            if not (launched == FLOAT_KERNELS and attn.alibi_launches == attn.launches
                    == cfg.num_layers * forwards):
                raise AssertionError(f"mpt-7b dir {key}: launched {sorted(launched)}, "
                                     f"{attn.alibi_launches} ALiBi of {attn.launches} attention "
                                     f"launches, {forwards} forwards")
            if key == "ngram":
                summary = {"acceptance_rate": eng.spec_metrics.draft_acceptance_rate,
                           "alibi_launches": attn.alibi_launches, "forwards": forwards}
            del eng
            torch.cuda.empty_cache()
    if out["ngram"] != out["ar"]:
        raise AssertionError("mpt-7b dir: greedy n-gram tokens differ from AR's")
    n_tok = sum(len(t) for t in out["ar"])
    summary.update(ngram_tokens_per_s=n_tok / walls["ngram"], ar_tokens_per_s=n_tok / walls["ar"])
    e2e_log(f"mpt-7b widths, 2 layers, LLM(model=<dir>) n-gram vs AR", prompts, out["ngram"],
            summary)
    return summary


# ------------------------------------------------------- real-weights loaders

# the kernels of a QuaRot Llama's QSpec path at the JAX package's defaults
# over a bf16 cache: the trunk's, the bf16 attention, the int8 head
QUAROT_KERNELS = {*TRUNK_KERNELS, "paged_attention", "matmul_w8a16"}
# a Llama float checkpoint in bf16: its GEMMs and head are torch ops (jnp.dot
# in the JAX package); its gamma norms and attention are kernels
FLOAT_LLAMA_KERNELS = {"rmsnorm", "paged_attention"}
# bench.py's "1b" configuration (Llama-3.2-1B-like), the separate draft
DRAFT_1B = dict(hidden_size=2048, intermediate_size=8192, num_layers=16, num_heads=16,
                num_kv_heads=8, head_dim=128)
FORCE = 3            # phase (C)'s forced accepted length, at k = 3


def llama_entries(cfg):
    """A Hugging Face Llama's checkpoint names and shapes (model.*, split
    q / k / v and gate / up, an untied lm_head); each norm's gamma
    "gamma": 1 + 0.1 N(0, 1), so quantize_float's folds are exercised."""
    H, V, I = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    out = [("model.embed_tokens.weight", (V, H), "w")]
    for li in range(cfg.num_layers):
        p = f"model.layers.{li}."
        out += [(p + "input_layernorm.weight", (H,), "gamma"),
                (p + "self_attn.q_proj.weight", (cfg.q_size, H), "w"),
                (p + "self_attn.k_proj.weight", (cfg.kv_size, H), "w"),
                (p + "self_attn.v_proj.weight", (cfg.kv_size, H), "w"),
                (p + "self_attn.o_proj.weight", (H, cfg.q_size), "w"),
                (p + "post_attention_layernorm.weight", (H,), "gamma"),
                (p + "mlp.gate_proj.weight", (I, H), "w"), (p + "mlp.up_proj.weight", (I, H), "w"),
                (p + "mlp.down_proj.weight", (H, I), "w")]
    return out + [("model.norm.weight", (H,), "gamma"), ("lm_head.weight", (V, H), "w")]


def quantize_on_card(cfg, seed: int, label: str):
    """A Llama float state dict of ``cfg``'s widths made on the card, then
    quantize_float(device="cuda") on it (the dict consumed as it goes):
    (params, cfg, seconds, peak GiB of the conversion, the state dict's
    included)."""
    from qspec_tpu_torch.model_loader.loader import quantize_float
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sd = random_state_dict(llama_entries(cfg), seed=seed)
    n_bytes = sum(t.numel() * 2 for t in sd.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, qcfg = quantize_float(sd, cfg, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if sd:
        raise AssertionError(f"{label}: quantize_float left {len(sd)} tensors unconverted")
    log(f"load {label}: {cfg.num_layers} layers, hidden {cfg.hidden_size}, intermediate "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}", stdout=False)
    log(f"load {label}: {n_bytes / 1e9:.2f} GB bf16, quantize_float on the card "
        f"{secs:.2f} s, peak {peak:.2f} GiB")
    return params, qcfg, secs, peak


def qspec_engine(cfg, params, draft=None, engine_kw=None, **spec_kw):
    """The factory of an LLMEngine of ``cfg`` serving QSpec (k = 3) with
    ``spec_kw``; ``draft``: (draft cfg, draft params), a separate draft;
    ``engine_kw``: more LLMEngine arguments."""
    from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, SchedulerConfig,
                                 SpeculativeConfig)

    def make(method, p):
        spec = SpeculativeConfig(num_speculative_tokens=3, method=method,
                                 draft_model=draft and draft[0], **spec_kw)
        return LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=128),
                                      scheduler=SchedulerConfig(max_num_seqs=4,
                                                                max_model_len=512),
                                      speculative=spec), p or params, device="cuda",
                         seed=0, draft_params=draft and draft[1], **(engine_kw or {}))
    return make


def phase_quarot_float_8b(smi: str):
    """(A) A Hugging Face Llama float checkpoint at meta-llama/Meta-Llama-3-8B's
    widths (config.py's LLAMA3_8B_HF), random bf16 made on the card, rotated
    and quantized there by quantize_float, then QSpec (k = 3) at W4A4 and at
    W4A8 through LLMEngine against qspec_null: tokens equal, exactly
    QUAROT_KERNELS launched."""
    from qspec_tpu_torch.config import LLAMA3_8B_HF
    from qspec_tpu_torch.models.registry import resolve
    params, cfg, secs, peak = quantize_on_card(resolve(LLAMA3_8B_HF), 10, "(A) llama3-8b")
    prompts = e2e_prompts()
    out = {"seconds": secs, "peak_gib": peak}
    for scheme in ("w4a4", "w4a8"):
        label = f"(A) llama3-8b quantize_float ({scheme} draft, int8 head, bf16 KV)"
        torch.cuda.reset_peak_memory_stats()
        spec, launches, _, summary = spec_vs_oracle(
            qspec_engine(cfg, params, draft_scheme=scheme), label, QUAROT_KERNELS, prompts, 32)
        summary["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        e2e_log(label, prompts, spec, summary)
        out[scheme] = (launches, summary, spec)
    log(f"e2e (A): card {smi}", stdout=False)
    return params, cfg, out


def phase_draft_1b(params, cfg, smi: str):
    """(B) (A)'s Llama-3-8B verified by a separate draft at bench.py's "1b"
    widths (16 layers, hidden 2048, 16 / 8 heads of 128, intermediate 8192,
    vocab 128256), made and quantized the same way, drafting at W4A4 with
    its own KV pool: tokens equal qspec_null's, exactly QUAROT_KERNELS
    launched, and the draft's forwards counted on the draft's layers only:
    w4a4 (the target never runs it) 4 x 16 a draft forward, rmsnorm_quant
    2 x 16, the int8 head one a forward of either model, the attention 32 a
    target forward and 16 a draft forward."""
    dcfg = dataclasses.replace(cfg, quant="w4", **DRAFT_1B)
    dparams, dcfg, secs, peak = quantize_on_card(dcfg, 11, "(B) 1b draft")
    prompts = e2e_prompts()
    label = "(B) llama3-8b + separate 1b draft (w4a4 draft, int8 heads, bf16 KV)"
    torch.cuda.reset_peak_memory_stats()
    spec, launches, _, summary = spec_vs_oracle(
        qspec_engine(cfg, params, draft=(dcfg, dparams)), label, QUAROT_KERNELS, prompts, 32)
    summary["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    t_fw, d_fw = summary["target_forwards"], summary["draft_forwards"]
    dl, tl = dcfg.num_layers, cfg.num_layers
    want = {"matmul_w4a4": 4 * dl * d_fw, "rmsnorm_quant": 2 * dl * d_fw,
            "matmul_w8a16": t_fw + d_fw, "paged_attention": tl * t_fw + dl * d_fw}
    got = {n: launches[n] for n in want}
    if got != want or not d_fw:
        raise AssertionError(f"{label}: launches {got}, expected {want} "
                             f"({t_fw} target and {d_fw} draft forwards)")
    summary.update(draft_seconds=secs, draft_peak_gib=peak)
    e2e_log(label, prompts, spec, summary)
    del dparams
    torch.cuda.empty_cache()
    log(f"e2e (B): card {smi}", stdout=False)
    return launches, summary


def phase_forced_8b(params, cfg, smi: str):
    """(C) (A)'s model with force_accept_len=FORCE at k = 3 (timing mode): every
    round of every live sequence emits min(FORCE + 1, k + 1) tokens, short
    of the 32-token budget (31 after the prompt's token: 7 rounds of 4 and
    one of 3), exactly QUAROT_KERNELS launched; tok/s beside qspec_null's.
    No token claim: the forced tokens are not the greedy continuation."""
    from qspec_tpu_torch.ops import kernel_wrappers
    prompts = e2e_prompts()
    per_round = min(FORCE + 1, 4)
    full, rest = divmod(31, per_round)
    want = {per_round: full * len(prompts), **({rest: len(prompts)} if rest else {})}
    out = {}
    for method, force in (("qspec", FORCE), ("qspec_null", None)):
        eng = qspec_engine(cfg, params, force_accept_len=force)(method, None)
        counters = kernel_wrappers()
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(eng, prompts, 32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[method] = {"tokens_per_s": sum(map(len, toks)) / wall,
                       "emitted_per_seq_round": dict(eng.spec_metrics.emitted_per_seq_round),
                       "launches": {n: c.launches for n, c in counters.items() if c.launches}}
        del eng
        torch.cuda.empty_cache()
    forced = out["qspec"]
    if forced["emitted_per_seq_round"] != want or set(forced["launches"]) != QUAROT_KERNELS:
        raise AssertionError(f"(C) forced acceptance: tokens a round {forced} , expected "
                             f"{want} and the kernels {sorted(QUAROT_KERNELS)}")
    summary = {"forced_accept": FORCE, "spec_tokens_per_s": forced["tokens_per_s"],
               "oracle_tokens_per_s": out["qspec_null"]["tokens_per_s"],
               "emitted_per_seq_round": forced["emitted_per_seq_round"]}
    log(f"e2e (C) llama3-8b forced acceptance {FORCE}/3 (w4a4 draft; no token claim): "
        + json.dumps({k: float(f"{v:.5g}") if isinstance(v, float) else v
                      for k, v in summary.items()}, separators=(",", ":")))
    log(f"e2e (C): card {smi}", stdout=False)
    return forced["launches"], summary


def write_config(path: str, hf: dict) -> None:
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)


def phase_llama_dirs(params8, cfg8, smi: str):
    """(D) LLM(model=<dir>) on directories written here at Meta-Llama-3-8B's
    widths cut to 2 layers: (D1) a llama-keyed float directory (random bf16,
    gammas 1 + 0.1 N) at quantization=None, served in bf16 (load_hf_float),
    n-gram (k = 3) == AR, only FLOAT_LLAMA_KERNELS launched; (D2) the same
    directory under the default quantization (quantize_float at load),
    QSpec == qspec_null with QUAROT_KERNELS; (D3) a reference-format QSpec
    directory (uint8 [out, in // 2] + weight_scales, the o / down weights
    under the reference's ``o_proj.1.`` / ``down_proj.1.`` keys) written
    from (A)'s layers 0-1, its rotated embedding and its int8 head
    dequantized, which must load (load_qspec) to (A)'s packed tensors bit
    for bit, QSpec == qspec_null."""
    import tempfile
    from qspec_tpu_torch import LLM
    from qspec_tpu_torch.config import LLAMA3_8B_HF
    from qspec_tpu_torch.models.registry import resolve
    from qspec_tpu_torch.ops import kernel_wrappers
    hf = {**LLAMA3_8B_HF, "num_hidden_layers": 2}
    cfg = resolve(hf)
    kw = dict(device="cuda", max_model_len=512, max_num_seqs=4, seed=0)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        sd = random_state_dict(llama_entries(cfg), seed=12)
        write_safetensors(os.path.join(d, "model.safetensors"), sd)
        del sd
        write_config(d, hf)
        prompts = float_prompts(cfg.vocab_size)
        toks, walls = {}, {}
        for key, extra in (("ar", {}), ("ngram", dict(num_speculative_tokens=3,
                                                      speculative_model="[ngram]"))):
            llm = LLM(model=d, quantization=None, **kw, **extra)
            counters = kernel_wrappers()
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks[key] = generate(llm.llm_engine, prompts, 32)
            torch.cuda.synchronize()
            walls[key] = time.perf_counter() - t0
            launched = {n for n, c in counters.items() if c.launches}
            if llm.engine_config.model.quant != "none" or launched != FLOAT_LLAMA_KERNELS:
                raise AssertionError(f"(D1) float dir {key}: quant "
                                     f"{llm.engine_config.model.quant}, launched {sorted(launched)}")
            if key == "ngram":
                n_tok = sum(map(len, toks[key]))
                out["D1"] = ({n: c.launches for n, c in counters.items() if c.launches},
                             {"acceptance_rate": llm.spec_metrics.draft_acceptance_rate,
                              "ngram_tokens_per_s": n_tok / walls["ngram"],
                              "ar_tokens_per_s": n_tok / walls["ar"]})
            del llm
            torch.cuda.empty_cache()
        if toks["ngram"] != toks["ar"]:
            raise AssertionError("(D1) float dir: greedy n-gram tokens differ from AR's")
        e2e_log("(D1) llama3-8b widths, 2 layers, LLM(model=<dir>, quantization=None) "
                "n-gram vs AR", prompts, toks["ngram"], out["D1"][1])
        prompts = e2e_prompts()
        label = "(D2) llama3-8b widths, 2 layers, LLM(model=<float dir>) quantize_float"
        spec, launches, _, summary = spec_vs_oracle(
            lambda m, p: LLM(model=d, num_speculative_tokens=3, speculative_method=m,
                             **kw).llm_engine, label, QUAROT_KERNELS, prompts, 32)
        e2e_log(label, prompts, spec, summary)
        out["D2"] = (launches, summary)
    with tempfile.TemporaryDirectory() as d:
        sd = reference_qspec_sd(params8, cfg)
        write_safetensors(os.path.join(d, "model.safetensors"), sd)
        del sd
        write_config(d, hf)
        label = "(D3) llama3-8b widths, 2 layers, LLM(model=<reference QSpec dir>) load_qspec"
        llm = LLM(model=d, num_speculative_tokens=3, **kw)
        loaded = llm.llm_engine.runner.params
        same = all(torch.equal(loaded["layers"][n][k], params8["layers"][n][k][:2])
                   for n in ("qkv", "o", "gate_up", "down") for k in ("qw", "qs"))
        if not (same and torch.equal(loaded["embed"], params8["embed"])):
            raise AssertionError(f"{label}: the packed tensors differ from (A)'s layers 0-1")
        del llm, loaded
        torch.cuda.empty_cache()
        spec, launches, _, summary = spec_vs_oracle(
            lambda m, p: LLM(model=d, num_speculative_tokens=3, speculative_method=m,
                             **kw).llm_engine, label, QUAROT_KERNELS, prompts, 32)
        e2e_log(label + ", == (A)'s layers 0-1 bit for bit", prompts, spec, summary)
        out["D3"] = (launches, summary)
    log(f"e2e (D): card {smi}", stdout=False)
    return out


# ---------------------------------------------------------------- (F) the server

NEVER = "<-1>"


class SmokeTokenizer:
    """Lossless: id i <-> "<i>", so a reply's text, streamed or not, parses
    back to its token ids (the port ships no tokenizer and the card's machine
    has no transformers). A chat template joins the messages' ids."""

    eos_token_id = None

    def encode(self, text):
        return [int(t) for t in re.findall(r"<(\d+)>", text)]

    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)

    def apply_chat_template(self, messages, tokenize=True, add_generation_prompt=True):
        return [t for m in messages for t in self.encode(m["content"])]


def http_json(port: int, path: str, body: dict):
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    c.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    r = c.getresponse()
    data = json.loads(r.read())
    c.close()
    if r.status != 200:
        raise AssertionError(f"(F) {path}: HTTP {r.status} {data}")
    return data


def http_stream(port: int, path: str, body: dict):
    """An SSE answer read line by line: (chunks, host-clock seconds from the
    send to each chunk); fails without the closing data: [DONE]."""
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    c.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    r = c.getresponse()
    if r.status != 200:
        raise AssertionError(f"(F) {path} stream: HTTP {r.status} {r.read()[:300]}")
    chunks, times = [], []
    while True:
        line = r.readline()
        if not line:
            raise AssertionError(f"(F) {path} stream ended without data: [DONE]")
        line = line.strip()
        if line == b"data: [DONE]":
            break
        if line:
            chunks.append(json.loads(line[len(b"data: "):]))
            times.append(time.perf_counter() - t0)
    c.close()
    return chunks, times


def serve_requests(server, port: int, jobs):
    """``jobs``: (path, body, streamed), one connection each. A job is sent
    once the one before it has queued its add_request on the engine's worker
    thread, and the first add_request waits there until every job has
    queued its own: the engine admits them in job order and all before its
    first step, as LLM.generate admits its prompts. (Which request comes
    fifth, and so waits for a slot, and where a prompt falls in the prefill
    chunks, change the bf16 GEMMs' shapes, and so may flip a near-tie of
    the random weights' logits.) Returns (answer, chunk times) a job: a
    streamed answer is its chunks."""
    import asyncio
    import threading
    aeng = server.engine
    queued, gate = [], threading.Event()
    call, add = aeng._call, aeng.engine.add_request

    def gated(*a, **kw):
        gate.wait(60)
        return add(*a, **kw)

    async def counted(fn, *a, **kw):
        fut = asyncio.get_running_loop().run_in_executor(aeng._worker,
                                                         functools.partial(fn, *a, **kw))
        if fn is gated:  # queued behind the ones before it
            queued.append(1)
        return await fut
    aeng._call, aeng.engine.add_request = counted, gated
    out, errors = [None] * len(jobs), []

    def one(i, path, body, streamed):
        try:
            out[i] = http_stream(port, path, body) if streamed else (http_json(port, path, body),
                                                                     None)
        except BaseException as e:
            errors.append(e)
    threads = [threading.Thread(target=one, args=(i, *job)) for i, job in enumerate(jobs)]
    try:
        for i, t in enumerate(threads):
            t.start()
            deadline = time.time() + 60
            while len(queued) <= i and time.time() < deadline and not errors:
                time.sleep(0.001)
            if len(queued) <= i:
                break
    finally:
        gate.set()
        for t in threads:
            if t.ident is not None:  # started
                t.join()
        aeng._call, aeng.engine.add_request = call, add
    if errors:
        raise errors[0]
    if len(queued) != len(jobs):
        raise AssertionError(f"(F) {len(queued)} of {len(jobs)} requests reached the engine")
    return out


def reply_tokens(tok, answer, streamed: bool):
    """A reply's token ids, its finish reason and completion tokens (None
    for a stream): a stream's text is its chunks' joined, its finish reason
    the last chunk's (every other None)."""
    if streamed:
        chunks = answer
        ch = [c["choices"][0] for c in chunks]
        if any(c["finish_reason"] is not None for c in ch[:-1]):
            raise AssertionError("(F) a finish_reason before the last chunk")
        text = "".join(c.get("text", c.get("delta", {}).get("content", "")) for c in ch)
        return tok.encode(text), ch[-1]["finish_reason"], None, [len(tok.encode(
            c.get("text", ""))) for c in ch]
    c = answer["choices"][0]
    text = c["text"] if "text" in c else c["message"]["content"]
    toks = tok.encode(text)
    if c["logprobs"] is not None and [int(t) for t in c["logprobs"]["tokens"]] != toks:
        raise AssertionError("(F) the reply's text does not parse to its tokens")
    return toks, c["finish_reason"], answer["usage"], None


def serve_and_check(label, args, params, prompts, chat_prompt, streamed, expect, max_tokens,
                    device="cuda"):
    """``build_server(args, params=)`` on the card in a thread; the prompts'
    completions (those in ``streamed`` streamed) and, with ``chat_prompt``,
    a chat completion, sent at once; then the same engine config's
    LLM.generate and its qspec_null oracle on the same prompts. Each reply's
    tokens must equal both, its finish reason be "length" and its usage
    right, and exactly the kernels of ``expect`` launch while the server
    answers. Returns (summary, engine, launches)."""
    from qspec_tpu_torch import LLM, SamplingParams
    from qspec_tpu_torch.entrypoints.openai.api_server import ServerThread, build_server
    from qspec_tpu_torch.ops import kernel_wrappers
    tok = SmokeTokenizer()
    server = build_server(args, model_name=label, params=params, tokenizer=tok, device=device)
    eng = server.engine.engine
    # a stop string (never emitted: ids are not negative) makes the engine
    # read the tokens after every round, as it must for a client's stop
    # strings, so a stream carries one chunk a round
    base = {"max_tokens": max_tokens, "temperature": 0.0, "ignore_eos": True, "logprobs": 1,
            "stop": [NEVER]}
    jobs = [("/v1/completions", {**base, "prompt": p, "stream": i in streamed}, i in streamed)
            for i, p in enumerate(prompts)]
    if chat_prompt is not None:
        jobs.append(("/v1/chat/completions",
                     {**base, "messages": [{"role": "user", "content": tok.decode(chat_prompt)}]},
                     False))
    counters = kernel_wrappers()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with ServerThread(server) as st:
        replies = serve_requests(server, st.port, jobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items() if c.launches}
    m = eng.spec_metrics
    summary = {"acceptance_rate": m.draft_acceptance_rate,
               "drafted_accepted_emitted": [m.num_draft_tokens, m.num_draft_accepted,
                                            m.num_emitted_tokens], "wall_s": wall}
    del server, eng
    torch.cuda.empty_cache()
    all_prompts = list(prompts) + ([chat_prompt] if chat_prompt is not None else [])
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True, stop=[NEVER])
    kw = {**dataclasses.asdict(args), "device": device, "tokenizer": tok}
    llm = [o.output_token_ids for o in LLM(params=params, **kw).generate(all_prompts, sp)]
    torch.cuda.empty_cache()
    oracle = [o.output_token_ids for o in LLM(params=params, **{
        **kw, "speculative_method": "qspec_null"}).generate(all_prompts, sp)]
    torch.cuda.empty_cache()
    ttft, gaps, multi = [], [], 0
    for i, ((path, body, st_), (answer, times), want, orc, p) in enumerate(
            zip(jobs, replies, llm, oracle, all_prompts)):
        toks, finish, usage, per_chunk = reply_tokens(tok, answer, st_)
        if toks != want or toks != orc:
            raise AssertionError(f"{label} job {i} {path}{' (streamed)' if st_ else ''}: tokens "
                                 f"{toks[:8]} vs LLM.generate {want[:8]} vs oracle {orc[:8]}")
        if finish != "length" or len(toks) != max_tokens:
            raise AssertionError(f"{label} {path}: finish {finish}, {len(toks)} tokens")
        if usage is not None and usage != {"prompt_tokens": len(p), "completion_tokens":
                                           max_tokens, "total_tokens": len(p) + max_tokens}:
            raise AssertionError(f"{label} {path}: usage {usage}")
        if times:
            ttft.append(times[0])
            gaps += [b - a for a, b in zip(times, times[1:])]
            multi += sum(n > 1 for n in per_chunk)
            # the stream's text equals the text not streamed
            if SmokeTokenizer().decode(toks) != SmokeTokenizer().decode(want):
                raise AssertionError(f"{label}: streamed text differs")
    if set(launches) != expect:
        raise AssertionError(f"{label}: kernels launched while serving: {sorted(launches)}, "
                             f"expected {sorted(expect)}")
    summary.update(ttft_s=ttft, median_chunk_gap_ms=float(np.median(gaps)) * 1e3,
                   chunks_of_several_tokens=multi, streamed_chunks=len(gaps) + len(ttft))
    return summary, launches


def induction_dir(d: str) -> None:
    """checkpoints/induction_lm_v2 as a Hugging Face Llama directory
    (config.json from its cfg, model.safetensors from its arrays)."""
    with open(INDUCTION + ".json") as f:
        c = json.load(f)["cfg"]
    write_config(d, {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                     "vocab_size": c["vocab_size"], "hidden_size": c["hidden_size"],
                     "intermediate_size": c["intermediate_size"],
                     "num_hidden_layers": c["num_layers"],
                     "num_attention_heads": c["num_heads"],
                     "num_key_value_heads": c["num_kv_heads"], "head_dim": c["head_dim"],
                     "rope_theta": c["rope_theta"], "rms_norm_eps": c["rms_norm_eps"],
                     "max_position_embeddings": c["max_position_embeddings"],
                     "tie_word_embeddings": c["tie_word_embeddings"]})
    with np.load(INDUCTION + ".npz") as z:
        write_safetensors(os.path.join(d, "model.safetensors"),
                          {k: torch.as_tensor(z[k]) for k in z.files})


INDUCTION = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints",
                         "induction_lm_v2")
# greedy W4A4 QSpec (k = 3) on induction_lm_v2, 4 prompts of 128, 32 tokens:
# 92 of 96 drafts, on the CPU (tests/test_torch_quantize_float.py) and on
# the card (tests/test_torch_gpu.py)
INDUCTION_ACCEPT = 23 / 24
INDUCTION_KERNELS = {"matmul_w4a16", "matmul_w4a4", "rmsnorm", "rmsnorm_quant",
                     "paged_attention"}


def induction_prompts(n: int, prompt_len: int, vocab: int, seed: int = 0):
    """bench.py's induction prompts: a random segment of period 16..64 tiled."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        period = int(rng.integers(16, 65))
        seg = rng.integers(2, vocab, size=period)
        out.append([int(x) for x in np.tile(seg, prompt_len // period + 1)[:prompt_len]])
    return out


def phase_server_8b(params8, cfg8, smi: str):
    """(F) The OpenAI-compatible server (build_server, ServerThread, HTTP
    from this thread) over QSpec at Llama-3-8B width: (A)'s parameters, the
    int8 head, the bf16 KV cache, the W4A8 draft, k = 3; four completions of
    e2e_prompts() at once (two streamed) and a chat completion, 32 greedy
    tokens each, == LLM.generate == qspec_null, exactly QUAROT_KERNELS
    launched while it answers. Then induction_lm_v2 served from a directory
    (quantize_float at load, W4A4, bf16 head), four streams of which two are
    streamed: == LLM.generate == oracle, acceptance INDUCTION_ACCEPT, and
    chunks that carry several tokens."""
    import tempfile
    from qspec_tpu_torch.engine.arg_utils import EngineArgs
    t0 = time.perf_counter()
    args = EngineArgs(model="llama3-8b", num_speculative_tokens=3,
                      speculative_draft_scheme="w4a8", max_model_len=512, max_num_seqs=4)
    if args.model_config() != cfg8:
        raise AssertionError(f"(F) the llama3-8b preset differs from (A)'s config: {cfg8}")
    prompts = e2e_prompts()
    label = "(F) llama3-8b server (w4a8 draft, int8 head, bf16 KV, k=3)"
    s8, launches = serve_and_check(label, args, params8, prompts, prompts[0][:96],
                                   streamed=(1, 3), expect=QUAROT_KERNELS, max_tokens=32)
    if s8["acceptance_rate"] <= 0:
        raise AssertionError(f"{label}: no draft token was accepted")
    with tempfile.TemporaryDirectory() as d:
        induction_dir(d)
        args_i = EngineArgs(model=d, num_speculative_tokens=3, lm_head_quant="bf16",
                            block_size=16, prefill_chunk_size=128, max_model_len=512,
                            max_num_seqs=4)
        prompts_i = induction_prompts(4, 128, args_i.model_config().vocab_size)
        label_i = "(F) induction_lm_v2 server (quantize_float, w4a4 draft, bf16 head, k=3)"
        si, _ = serve_and_check(label_i, args_i, None, prompts_i, None, streamed=(0, 2),
                                expect=INDUCTION_KERNELS, max_tokens=32)
    if abs(si["acceptance_rate"] - INDUCTION_ACCEPT) > 1e-9 or not si["chunks_of_several_tokens"]:
        raise AssertionError(f"{label_i}: acceptance {si['acceptance_rate']} (want "
                             f"{INDUCTION_ACCEPT}), {si['chunks_of_several_tokens']} chunks "
                             "of several tokens")
    wall = time.perf_counter() - t0
    full = {"llama3_8b": s8, "induction_lm_v2": si, "phase_wall_s": wall}
    log("server (F) " + json.dumps(full, separators=(",", ":")), stdout=False)
    log(f"server (F) llama3-8b over HTTP, 4 completions (2 streamed) + 1 chat, 32 tokens "
        f"each == LLM.generate == qspec_null: TTFT {max(s8['ttft_s']):.4g} s, median chunk "
        f"gap {s8['median_chunk_gap_ms']:.4g} ms (host clock), acceptance "
        f"{s8['acceptance_rate']:.5g}, serve wall {s8['wall_s']:.4g} s")
    log(f"server (F) induction_lm_v2 from a directory: acceptance {si['acceptance_rate']:.5g} "
        f"(the CPU's), {si['chunks_of_several_tokens']} of {si['streamed_chunks']} streamed "
        f"chunks carry several tokens, median gap {si['median_chunk_gap_ms']:.4g} ms; "
        f"phase {wall:.1f} s; card {smi}")
    return launches, full


# ------------------------------------------------- (I) grammar-guided decoding

# Llama-3's <|eot_id|>: the EOS of the byte-level vocabulary of (I1) / (I3)
GUIDED_EOS = 128009
# tokens of several bytes that cross DFA edges
GUIDED_PIECES = (b'",', b'": ', b'":', b'[1', b'{"', b'"}', b',"', b'1,', b'],', b'red',
                 b'yes', b'no', b'name', b'arguments', b'get_weather', b'":{"', b'}}')
GUIDED_REGEX = r"\[\d(,\d)*\]"
GUIDED_SCHEMA = {"type": "object", "properties": {
    "n": {"type": "integer"}, "color": {"enum": ["red", "green", "blue"]}},
    "required": ["n", "color"]}
GUIDED_CHOICE = ["yes", "no", "maybe"]
# (I3)'s completion: a list of one to four digits
GUIDED_REGEX_SHORT = r"\[\d(,\d){0,3}\]"
GUIDED_TOOLS = [
    {"type": "function", "function": {"name": "get_weather", "parameters": {
        "type": "object", "properties": {"unit": {"enum": ["c", "f"]},
                                         "days": {"enum": [1, 2, 3]}},
        "required": ["unit", "days"]}}},
    {"type": "function", "function": {"name": "get_time"}}]


def guided_pieces(V: int) -> dict:
    """id -> text of the byte-level vocabulary at ``V`` ids: each printable
    ASCII byte on three ids (spread over the table), then GUIDED_PIECES;
    every other id has no text (a grammar bans it), GUIDED_EOS included."""
    out = {}
    for rep in range(3):
        for i, b in enumerate(range(32, 127)):
            out[1000 + 40000 * rep + i] = chr(b)
    for i, p in enumerate(GUIDED_PIECES):
        out[120000 + i] = p.decode()
    assert V > 120000 + len(GUIDED_PIECES) and GUIDED_EOS not in out
    return out


def guided_vocab(V: int) -> list:
    """The grammar vocabulary (token id -> bytes, None: no text)."""
    vocab = [None] * V
    for i, t in guided_pieces(V).items():
        vocab[i] = t.encode()
    return vocab


class GuidedTokenizer:
    """A byte-level tokenizer over guided_pieces() that hf_vocab_bytes
    reads (get_vocab, convert_tokens_to_string, all_special_ids): token i's
    string is "<i>", its text the piece; a character encodes to its first
    id. A chat template joins the messages' contents."""

    eos_token_id = GUIDED_EOS
    all_special_ids = [GUIDED_EOS]

    def __init__(self, V: int):
        self.vocab_size = V
        self.text = guided_pieces(V)
        self.first = {}
        for i, t in sorted(self.text.items()):
            if len(t) == 1:
                self.first.setdefault(t, i)

    def get_vocab(self):
        return {**{f"<{i}>": i for i in self.text}, "<|eot_id|>": GUIDED_EOS}

    def convert_tokens_to_string(self, toks):
        return "".join(self.text[int(t[1:-1])] for t in toks)

    def encode(self, text):
        return [self.first.get(c, self.first["?"]) for c in text]

    def decode(self, ids):
        return "".join(self.text.get(int(i), "") for i in ids)

    def apply_chat_template(self, messages, tokenize=True, add_generation_prompt=True):
        return self.encode("\n".join(m["content"] for m in messages) + "\n")


def fsm_walk(fsm, toks) -> int:
    """The FSM's state after ``toks`` (EOS self-loops where it accepts); -1
    at the first token it does not allow."""
    s = 0
    for t in toks:
        s = int(fsm.next_state[s, t])
        if s < 0:
            return -1
    return s


def guided_requests(gc, max_tokens: int, **sp_kw):
    """(I1)'s four requests: a regex, a JSON schema, a choice, an unguided
    row; returns (SamplingParams, their FSMs (None: unguided))."""
    from qspec_tpu_torch import SamplingParams
    opts = [{"guided_regex": GUIDED_REGEX}, {"guided_json": GUIDED_SCHEMA},
            {"guided_choice": GUIDED_CHOICE}, {}]
    fsms = [gc.from_regex(GUIDED_REGEX), gc.from_json_schema(GUIDED_SCHEMA),
            gc.from_choice(GUIDED_CHOICE), None]
    sps = [SamplingParams(max_tokens=max_tokens, ignore_eos=True, **{"temperature": 0.0,
                                                                       **sp_kw}, **o)
           for o in opts]
    return sps, fsms


class TableProbe:
    """Wraps a runner's stack_grammars: the device, the shape and the bytes
    of every grammar stack the engine's steps read, and the host ms of
    stacking."""

    def __init__(self, eng):
        self.devices, self.shapes, self.ms = set(), set(), []
        self.stack = eng.runner.stack_grammars
        eng.runner.stack_grammars = self

    def __call__(self, fsms):
        t0 = time.perf_counter()
        out = self.stack(fsms)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.devices.add(out.device.type)
        self.shapes.add(tuple(out.shape))
        return out


def guided_run(make, method: str, prompts, sps, count: bool = False, k: int = 3):
    """One engine run of ``prompts`` under per-request ``sps``: (tokens,
    launches (count: set to 0 just before the run, read just after), the
    engine's counts and metrics with the wall ms per verify round (host
    clock: an unguided batch may chain several calls a step, a guided one
    never), each step's wall ms, the table probe)."""
    from qspec_tpu_torch.ops import kernel_wrappers
    eng = make(method)
    probe = TableProbe(eng)
    counters = kernel_wrappers()
    torch.cuda.synchronize()
    if count:
        for c in counters.values():
            c.launches = 0
    ids = [eng.add_request(list(p), sp) for p, sp in zip(prompts, sps)]
    outs, step_ms = {}, []
    t0 = time.perf_counter()
    while eng.has_unfinished_requests():
        ts = time.perf_counter()
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
        step_ms.append((time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items() if c.launches} if count else None
    r, m = eng.runner, eng.spec_metrics
    info = {"target_forwards": r.target_forwards, "draft_forwards": r.draft_forwards,
            "drafted_accepted_emitted": [m.num_draft_tokens, m.num_draft_accepted,
                                         m.num_emitted_tokens],
            "acceptance_rate": m.draft_acceptance_rate if m.num_spec_rounds else None,
            "tokens_per_s": sum(len(outs[i]) for i in ids) / wall,
            "ms_per_round": wall * 1e3 / max((r.draft_forwards - r.target_forwards) // (k - 1),
                                             1)}
    del eng
    torch.cuda.empty_cache()
    return [outs[i] for i in ids], launches, info, step_ms, probe


def check_walks(label, toks, fsms):
    for i, (t, f) in enumerate(zip(toks, fsms)):
        if f is not None and (not t or fsm_walk(f, t) < 0):
            raise AssertionError(f"{label}: request {i}'s tokens leave its grammar: {t[:12]}")


def qspec_launches(L: int, info: dict, k: int) -> dict:
    """The launches a shared-weights QSpec run on a QuaRot Llama must make
    (phase (B)'s rule): per draft forward (prompt chunk or draft step) 4
    w4a4 and 2 rmsnorm_quant a layer, per forward of either scheme the
    attention once a layer and the int8 head once, per verify pass 4 w4a16
    a layer (the prompt rectangles take the dequantize-once branch)."""
    t_fw, d_fw = info["target_forwards"], info["draft_forwards"]
    verify = (d_fw - t_fw) // (k - 1)
    return {"matmul_w4a4": 4 * L * d_fw, "rmsnorm_quant": 2 * L * d_fw,
            "matmul_w8a16": t_fw + d_fw, "paged_attention": L * (t_fw + d_fw),
            "matmul_w4a16": 4 * L * verify}


def phase_guided_8b(params8, cfg8, smi: str):
    """(I1) Grammar-guided decoding inside QSpec's loop at Llama-3-8B width:
    (A)'s parameters (int8 head, bf16 KV), k = 3, the byte-level vocabulary
    of guided_vocab() at V = 128256; one batch of a regex, a JSON schema, a
    choice and an unguided request, 32 greedy tokens each (EOS ignored, so
    a finished grammar emits EOS): at W4A4 and at W4A8 == qspec_null's
    tokens under the same grammars, exactly the launches of
    qspec_launches; typical acceptance (W4A8, greedy) == the same oracle; a
    sampled run (temperature 0.8, top_p 0.95) whose outputs all walk their
    FSMs; the grammar tables on the card. (I2) induction_lm_v2 with a
    grammar its copied continuation satisfies: acceptance == the CPU's.
    (I3) the server at 8B width with GuidedTokenizer: forced tool choices
    ("required", named) and a guided_regex completion == LLM.generate."""
    from qspec_tpu_torch.guided import GrammarCompiler, hf_vocab_bytes
    t_phase = time.perf_counter()
    V, L, k = cfg8.vocab_size, cfg8.num_layers, 3
    vocab = guided_vocab(V)
    compile_ms = {}
    gc = GrammarCompiler(vocab, GUIDED_EOS)
    for name, fn, arg in (("regex", gc.from_regex, GUIDED_REGEX),
                          ("json", gc.from_json_schema, GUIDED_SCHEMA),
                          ("choice", gc.from_choice, GUIDED_CHOICE)):
        t0 = time.perf_counter()
        fsm = fn(arg)
        compile_ms[name] = ((time.perf_counter() - t0) * 1e3, fsm.num_states)
    prompts = e2e_prompts()
    sps, fsms = guided_requests(gc, 32)

    def make(scheme, **spec_kw):
        f = qspec_engine(cfg8, params8, engine_kw={"grammar_vocab": vocab,
                                                    "eos_token_id": GUIDED_EOS},
                         draft_scheme=scheme, **spec_kw)
        return lambda method: f(method, None)

    oracle, _, o_info, _, _ = guided_run(make("w4a8"), "qspec_null", prompts, sps)
    check_walks("(I1) oracle", oracle, fsms)
    runs = {}
    for scheme in ("w4a4", "w4a8"):
        label = f"(I1) llama3-8b guided ({scheme} draft, int8 head, bf16 KV)"
        toks, launches, info, step_ms, probe = guided_run(make(scheme), "qspec", prompts, sps,
                                                          count=True)
        if toks != oracle:
            raise AssertionError(f"{label}: guided tokens differ from qspec_null's: "
                                 f"{[t[:8] for t in toks]} vs {[t[:8] for t in oracle]}")
        want = qspec_launches(L, info, k)
        got = {n: launches.get(n, 0) for n in want}
        if set(launches) != QUAROT_KERNELS or got != want:
            raise AssertionError(f"{label}: launches {launches}, expected {want} and only "
                                 f"{sorted(QUAROT_KERNELS)}")
        if probe.devices != {"cuda"}:
            raise AssertionError(f"{label}: grammar tables on {probe.devices}")
        runs[scheme] = (launches, info, step_ms, probe)
    if runs["w4a8"][1]["drafted_accepted_emitted"][1] <= 0:
        raise AssertionError("(I1) w4a8: no grammar-masked draft was accepted")
    typ, _, t_info, _, _ = guided_run(make("w4a8", acceptance_method="typical_acceptance_sampler"),
                                      "qspec", prompts, sps)
    if typ != oracle:
        raise AssertionError(f"(I1) typical acceptance (w4a8, greedy) differs from qspec_null: "
                             f"{[t[:8] for t in typ]} vs {[t[:8] for t in oracle]}")
    sampled_sps, _ = guided_requests(gc, 32, temperature=0.8, top_p=0.95)
    sampled, _, s_info, _, _ = guided_run(make("w4a8"), "qspec", prompts, sampled_sps)
    check_walks("(I1) sampled w4a8", sampled, fsms)
    if sampled == oracle:
        raise AssertionError("(I1) the sampled run gave the greedy tokens")
    plain_sps = [dataclasses.replace(sp, guided_regex=None, guided_json=None,
                                     guided_choice=None) for sp in sps]
    _, _, u_info, u_step_ms, _ = guided_run(make("w4a8"), "qspec", prompts, plain_sps)
    probe8 = runs["w4a8"][3]
    table_bytes = max(int(np.prod(s)) * 4 for s in probe8.shapes)
    i1 = {"compile_ms_states": compile_ms, "table_shapes": sorted(probe8.shapes),
          "table_bytes": table_bytes, "stack_host_ms_median": float(np.median(probe8.ms)),
          "oracle_tokens_per_s": o_info["tokens_per_s"],
          **{f"{s}_tokens_per_s": runs[s][1]["tokens_per_s"] for s in runs},
          **{f"{s}_acceptance": runs[s][1]["acceptance_rate"] for s in runs},
          **{f"{s}_drafted_accepted_emitted": runs[s][1]["drafted_accepted_emitted"]
             for s in runs},
          "typical_acceptance": t_info["acceptance_rate"],
          "typical_tokens_per_s": t_info["tokens_per_s"],
          "sampled_acceptance": s_info["acceptance_rate"],
          "sampled_tokens_per_s": s_info["tokens_per_s"],
          "step_ms_median_guided_w4a8": float(np.median(runs["w4a8"][2])),
          "step_ms_median_unguided_w4a8": float(np.median(u_step_ms)),
          "round_ms_guided_w4a8": runs["w4a8"][1]["ms_per_round"],
          "round_ms_unguided_w4a8": u_info["ms_per_round"],
          "unguided_w4a8_tokens_per_s": u_info["tokens_per_s"],
          "unguided_w4a8_acceptance": u_info["acceptance_rate"]}
    log("guided (I1) " + json.dumps(i1, separators=(",", ":")), stdout=False)
    log(f"guided (I1) llama3-8b, 4 requests (regex, JSON schema, choice, unguided) x 32 "
        f"greedy tokens == qspec_null at w4a4 and w4a8 and under typical acceptance, exact "
        f"launches; sampled outputs walk their FSMs. Acceptance w4a4 "
        f"{i1['w4a4_acceptance']:.4g}, w4a8 {i1['w4a8_acceptance']:.4g}; tok/s w4a8 "
        f"{i1['w4a8_tokens_per_s']:.4g} vs oracle {i1['oracle_tokens_per_s']:.4g}; FSM "
        f"compile ms at V={V}: " + ", ".join(f"{n} {ms:.1f} ({s} states)"
                                            for n, (ms, s) in compile_ms.items())
        + f"; table {table_bytes / 1e6:.2f} MB on cuda; w4a8 ms a round guided "
        f"{i1['round_ms_guided_w4a8']:.2f} vs unguided {i1['round_ms_unguided_w4a8']:.2f} "
        f"(host clock)", stdout=False)
    i2 = phase_guided_induction()
    i3, i3_launches = phase_guided_server(params8, cfg8)
    wall = time.perf_counter() - t_phase
    log(f"guided (I) took {wall:.1f} s; card {smi}")
    return {"I1_w4a4": runs["w4a4"][0], "I1_w4a8": runs["w4a8"][0], "I3": i3_launches}, \
        {"I1": i1, "I2": i2, "I3": i3, "wall_s": wall}


# (I2): greedy W4A4 QSpec (k = 3) on induction_lm_v2, 4 prompts of 128, 32
# tokens, each under the grammar of its own segment's tokens: drafted /
# accepted / emitted on the CPU (tests/test_torch_guided_engine.py)
GUIDED_INDUCTION_DAE = [96, 92, 124]


def induction_grammar(prompt) -> str:
    """A regex that the copy of an induction prompt's segment satisfies and
    that bans every other token: (<a>|<b>|...)+ over the prompt's tokens,
    token t's text "<t>"."""
    return "(" + "|".join(f"<{t}>" for t in sorted(set(prompt))) + ")+"


def phase_guided_induction() -> dict:
    """(I2) induction_lm_v2 (quantize_float on the card, bf16 head), W4A4,
    k = 3, each prompt under induction_grammar(): tokens == qspec_null's,
    drafted / accepted / emitted == GUIDED_INDUCTION_DAE (the CPU's), some
    accepted."""
    from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                                 SamplingParams, SchedulerConfig, SpeculativeConfig)
    from qspec_tpu_torch.guided import GrammarCompiler
    from qspec_tpu_torch.model_loader.loader import quantize_float
    with open(INDUCTION + ".json") as f:
        meta = json.load(f)["cfg"]
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    with np.load(INDUCTION + ".npz") as z:
        sd = {k: z[k] for k in z.files}
    params, cfg = quantize_float(sd, ModelConfig(**{k: v for k, v in meta.items()
                                                   if k in names}), device="cuda")
    prompts = induction_prompts(4, 128, cfg.vocab_size)
    vocab = [None, None] + [f"<{t}>".encode() for t in range(2, cfg.vocab_size)]
    sched = SchedulerConfig(max_num_seqs=4, max_model_len=512, prefill_chunk_size=128,
                            decode_batch_buckets=(4,), prefill_token_buckets=(128,))
    out = {}
    for method in ("qspec", "qspec_null"):
        eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                     scheduler=sched,
                                     speculative=SpeculativeConfig(num_speculative_tokens=3,
                                                                   method=method)),
                        params, device="cuda", grammar_vocab=vocab)
        ids = [eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=32,
                                                 ignore_eos=True,
                                                 guided_regex=induction_grammar(p)))
               for p in prompts]
        done = {}
        while eng.has_unfinished_requests():
            for o in eng.step():
                if o.finished:
                    done[o.request_id] = o.output_token_ids
        m = eng.spec_metrics
        out[method] = ([done[i] for i in ids], [m.num_draft_tokens, m.num_draft_accepted,
                                                m.num_emitted_tokens])
        del eng
    toks, dae = out["qspec"]
    if toks != out["qspec_null"][0]:
        raise AssertionError("(I2) induction_lm_v2 guided: tokens differ from qspec_null's")
    if dae != GUIDED_INDUCTION_DAE or dae[1] <= 0:
        raise AssertionError(f"(I2) induction_lm_v2 guided: drafted / accepted / emitted "
                             f"{dae}, the CPU's {GUIDED_INDUCTION_DAE}")
    gc = GrammarCompiler(vocab)
    check_walks("(I2)", toks, [gc.from_regex(induction_grammar(p)) for p in prompts])
    log(f"guided (I2) induction_lm_v2, each prompt under its segment's grammar, w4a4: "
        f"drafted / accepted / emitted {dae} (the CPU's), == qspec_null")
    del params
    torch.cuda.empty_cache()
    return {"drafted_accepted_emitted": dae}


def guided_http(port: int, path: str, body: dict):
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    c.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    r = c.getresponse()
    data = json.loads(r.read())
    c.close()
    if r.status != 200:
        raise AssertionError(f"(I3) {path}: HTTP {r.status} {data}")
    return data


def phase_guided_server(params8, cfg8):
    """(I3) build_server over (A)'s 8B parameters (W4A8 draft, k = 3) with
    GuidedTokenizer, whose vocabulary hf_vocab_bytes reads (== guided_vocab):
    chat completions with tool_choice "required" and naming get_weather, and
    a completion under guided_regex, one at a time; each reply's tool_calls
    parse and equal LLM.generate's under forced_call_schema's guided_json,
    the completion's text LLM.generate's; exactly QUAROT_KERNELS launch."""
    from qspec_tpu_torch import LLM, SamplingParams
    from qspec_tpu_torch.engine.arg_utils import EngineArgs
    from qspec_tpu_torch.entrypoints.llm import chat_token_ids
    from qspec_tpu_torch.entrypoints.openai.api_server import ServerThread, build_server
    from qspec_tpu_torch.entrypoints.openai.tool_parser import (forced_call_schema,
                                                                parse_tool_calls,
                                                                tools_system_message)
    from qspec_tpu_torch.guided import hf_vocab_bytes
    from qspec_tpu_torch.ops import kernel_wrappers
    tok = GuidedTokenizer(cfg8.vocab_size)
    if hf_vocab_bytes(tok) != guided_vocab(cfg8.vocab_size):
        raise AssertionError("(I3) hf_vocab_bytes(GuidedTokenizer) != guided_vocab")
    args = EngineArgs(model="llama3-8b", num_speculative_tokens=3,
                      speculative_draft_scheme="w4a8", max_model_len=1024, max_num_seqs=4)
    names = [t["function"]["name"] for t in GUIDED_TOOLS]
    messages = [{"role": "user", "content": "What is the weather?"}]
    jobs = [("/v1/chat/completions", {"messages": messages, "tools": GUIDED_TOOLS,
                                      "tool_choice": "required"}, None),
            ("/v1/chat/completions", {"messages": messages, "tools": GUIDED_TOOLS,
                                      "tool_choice": {"type": "function",
                                                      "function": {"name": "get_weather"}}},
             "get_weather"),
            ("/v1/completions", {"prompt": "Numbers: ", "guided_regex": GUIDED_REGEX_SHORT},
             None)]
    server = build_server(args, model_name="llama3-8b-guided", params=params8, tokenizer=tok,
                          device="cuda")
    counters = kernel_wrappers()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    replies = []
    t0 = time.perf_counter()
    with ServerThread(server) as st:
        for path, body, _ in jobs:
            replies.append(guided_http(st.port, path, {**body, "temperature": 0.0,
                                                       "max_tokens": 96}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items() if c.launches}
    del server
    torch.cuda.empty_cache()
    if set(launches) != QUAROT_KERNELS:
        raise AssertionError(f"(I3) kernels launched while serving: {sorted(launches)}")
    llm = LLM(params=params8, tokenizer=tok, device="cuda", **dataclasses.asdict(args))
    sys_ids = chat_token_ids(tok, [tools_system_message(GUIDED_TOOLS)] + messages)
    out = {}
    for (path, body, name), reply in zip(jobs, replies):
        c = reply["choices"][0]
        if path.endswith("chat/completions"):
            calls = c["message"].get("tool_calls")
            if c["finish_reason"] != "tool_calls" or not calls:
                raise AssertionError(f"(I3) {body['tool_choice']}: no tool call: {c}")
            want = llm.generate([sys_ids], SamplingParams(
                temperature=0.0, max_tokens=96, guided_json=forced_call_schema(
                    GUIDED_TOOLS, name)))[0]
            _, want_calls = parse_tool_calls(want.text, names)
            got = [x["function"] for x in calls]
            if got != [x["function"] for x in want_calls] or (name and got[0]["name"] != name):
                raise AssertionError(f"(I3) {body['tool_choice']}: {got} vs LLM.generate "
                                     f"{want.text!r}")
            json.loads(got[0]["arguments"])
            out[str(name or "required")] = got[0]
        else:
            want = llm.generate([tok.encode(body["prompt"])], SamplingParams(
                temperature=0.0, max_tokens=96, guided_regex=GUIDED_REGEX_SHORT))[0]
            if c["text"] != want.text or not re.fullmatch(GUIDED_REGEX_SHORT, c["text"]):
                raise AssertionError(f"(I3) guided_regex completion {c['text']!r} vs "
                                     f"LLM.generate {want.text!r}")
            out["regex"] = c["text"]
    del llm
    torch.cuda.empty_cache()
    log("guided (I3) " + json.dumps({**out, "serve_wall_s": wall}, separators=(",", ":")),
        stdout=False)
    log(f"guided (I3) llama3-8b server: tool_choice required -> {out['required']['name']}, "
        f"named -> {out['get_weather']['name']}({out['get_weather']['arguments']}), "
        f"guided_regex completion {out['regex']!r}; each == LLM.generate; serve wall "
        f"{wall:.2f} s")
    return out, launches


# ----------------------------------------------------- (L) the engine surface

# (L1)'s bank: 3 slots (the base and two adapters) of rank 16; each adapter
# is rank 4 on q, k, v, o, gate, up and down (q / k / v take 12 of the 16,
# gate / up 8), lora_alpha 8 (alpha / r = 2), normal(L_SCALE) entries
L_SLOTS, L_RANK, L_PART_RANK, L_ALPHA, L_SCALE = 3, 16, 4, 8.0, 0.02
# (L3)'s soft prompt: rows normal(0.02), the embedding table's scale
L_VIRTUAL = 8
# (L4): the beams' cumulative logprob against a teacher-forced prefill's
# re-scoring of the prompt and the beam in one rectangle. The beam steps'
# logprobs come from prefills of the beam's tail over cached prompt pages,
# the re-scoring's from one prefill of the whole: other GEMM shapes, so
# each token's logprob moves by bf16 rounding: 0.05 a token (8 tokens).
# On an H100 80GB HBM3 at 700 W the largest difference was 0.225 (PERF.md
# §6). The same beam scored after the other prompt is the control: a
# misplaced position or token moves a logprob by nats, not hundredths.
L_BEAM_TOL = 0.4


def lora_peft(cfg, seed: int) -> dict:
    """A PEFT LoRA state dict on q/k/v/o/gate/up/down of every layer of
    ``cfg`` (lora_A [r, in], lora_B [out, r]), made on the card from
    ``seed``: bf16 normal(L_SCALE)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    H, I = cfg.hidden_size, cfg.intermediate_size
    mods = (("self_attn.q_proj", H, cfg.q_size), ("self_attn.k_proj", H, cfg.kv_size),
            ("self_attn.v_proj", H, cfg.kv_size), ("self_attn.o_proj", cfg.q_size, H),
            ("mlp.gate_proj", H, I), ("mlp.up_proj", H, I), ("mlp.down_proj", I, H))
    sd = {}
    for li in range(cfg.num_layers):
        for mod, n_in, n_out in mods:
            pre = f"base_model.model.model.layers.{li}.{mod}"
            for ab, shape in (("A", (L_PART_RANK, n_in)), ("B", (n_out, L_PART_RANK))):
                sd[f"{pre}.lora_{ab}.weight"] = (torch.randn(
                    shape, generator=gen, device="cuda") * L_SCALE).to(torch.bfloat16)
    return sd


def l_engine(cfg, params, method: str = "qspec", kv: str = "bfloat16", num_pages=None,
             mode: str = "recompute", swap_gb: float = 4.0):
    """(A)'s engine (qspec_engine: page 128, 4 sequences, W4A8 draft, k = 3)
    with the KV entry type, the page count and the preemption mode given."""
    from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, SchedulerConfig,
                                 SpeculativeConfig)
    return LLMEngine(EngineConfig(
        model=cfg, cache=CacheConfig(page_size=128, num_pages=num_pages, kv_cache_dtype=kv,
                                     swap_space_gb=swap_gb),
        scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=512, preemption_mode=mode),
        speculative=SpeculativeConfig(num_speculative_tokens=3, method=method,
                                      draft_scheme="w4a8")), params, device="cuda", seed=0)


def l_run(eng, reqs, count: bool = False, max_tokens: int = 32):
    """Greedy tokens of ``reqs`` ((prompt, add_request keywords) each)
    through ``eng``: (tokens, launches (count: set to 0 just before the
    run, read just after), the engine's forwards, acceptance and tok/s on
    the host clock)."""
    from qspec_tpu_torch import SamplingParams
    from qspec_tpu_torch.ops import kernel_wrappers
    counters = kernel_wrappers()
    torch.cuda.synchronize()
    if count:
        for c in counters.values():
            c.launches = 0
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True)
    t0 = time.perf_counter()
    ids = [eng.add_request(p, sp, **kw) for p, kw in reqs]
    outs = {}
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items() if c.launches} if count else None
    r, m = eng.runner, eng.spec_metrics
    toks = [outs[i] for i in ids]
    return toks, launches, {
        "target_forwards": r.target_forwards, "draft_forwards": r.draft_forwards,
        "acceptance_rate": m.draft_acceptance_rate if m.num_spec_rounds else None,
        "tokens_per_s": sum(map(len, toks)) / wall, "wall_s": wall}


def write_peft_dir(d: str, sd: dict, alpha: float) -> None:
    """A PEFT adapter directory: adapter_model.safetensors and the
    adapter_config.json that names its lora_alpha."""
    os.makedirs(d, exist_ok=True)
    write_safetensors(os.path.join(d, "adapter_model.safetensors"), sd)
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": L_PART_RANK, "lora_alpha": alpha}, f)


def phase_lora_8b(params8, cfg8, base_toks, d: str):
    """(L1) A bank of L_SLOTS slots at rank L_RANK beside (A)'s parameters:
    adapter a loaded by ``engine.lora.load``, b by ``load_path`` from a PEFT
    directory written here; 4 prompts on slots 0, a, b, a through QSpec ==
    qspec_null's (the same adapters), the slot-0 row == (A)'s W4A8 tokens
    without a bank, each adapter row unlike its prompt's base tokens, the
    launches those of qspec_launches (LoRA launches no counted kernel)."""
    from qspec_tpu_torch.lora import LoRAConfig, init_lora_params
    prompts = e2e_prompts()
    bank = init_lora_params(cfg8, LoRAConfig(L_SLOTS, L_RANK), device="cuda")
    bank_bytes = sum(t.numel() * t.element_size() for ab in bank["layers"].values()
                     for t in ab.values())
    write_peft_dir(d, lora_peft(cfg8, 42), L_ALPHA)
    sd_a = lora_peft(cfg8, 41)
    params = {**params8, "lora": bank}
    reqs = [(prompts[0], {}), (prompts[1], {"lora_name": "a"}), (prompts[2], {"lora_name": "b"}),
            (prompts[3], {"lora_name": "a"})]
    runs, load_s = {}, 0.0
    for method in ("qspec", "qspec_null"):
        eng = l_engine(cfg8, params, method)
        t0 = time.perf_counter()
        slots = (eng.lora.load("a", sd_a, alpha=L_ALPHA), eng.lora.load_path("b", d))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if slots != (1, 2):
            raise AssertionError(f"(L1) adapters in slots {slots}, expected (1, 2)")
        runs[method] = l_run(eng, reqs, count=method == "qspec")
        del eng
    (toks, launches, info), (oracle, _, o_info) = runs["qspec"], runs["qspec_null"]
    if toks != oracle:
        raise AssertionError(f"(L1) QSpec with adapters differs from qspec_null: "
                             f"{[t[:8] for t in toks]} vs {[t[:8] for t in oracle]}")
    if toks[0] != base_toks[0] or any(toks[i] == base_toks[i] for i in (1, 2, 3)):
        raise AssertionError(f"(L1) slot 0 must give (A)'s tokens and each adapter other "
                             f"tokens: {[t[:8] for t in toks]} vs {[t[:8] for t in base_toks]}")
    want = qspec_launches(cfg8.num_layers, info, 3)
    got = {n: launches.get(n, 0) for n in want}
    if set(launches) != QUAROT_KERNELS or got != want:
        raise AssertionError(f"(L1) launches {launches}, expected {want} and only "
                             f"{sorted(QUAROT_KERNELS)}")
    return launches, toks, {
        "bank_bytes": bank_bytes, "load_two_adapters_s": load_s,
        "tokens_per_s": info["tokens_per_s"],
        "oracle_tokens_per_s": o_info["tokens_per_s"], "acceptance": info["acceptance_rate"],
        "target_forwards": info["target_forwards"], "draft_forwards": info["draft_forwards"]}


# (L2)'s pool: 8 pages of 128 (7 usable): the 4 prompts (98-173 tokens)
# take all 7 at admission, so the shortest, crossing 124 tokens with its
# lookahead after 27 of its L_SWAP_TOKENS, preempts itself while the others
# run (at 32 tokens the others can finish first: the page frees then)
L_SWAP_PAGES, L_SWAP_TOKENS = 8, 48
# (L2) runs on the first L_SWAP_LAYERS of (A)'s 32 layers (the script's time
# limit): the pages, and so every preemption, are the full depth's
L_SWAP_LAYERS = 8


def first_layers(params, cfg, n: int):
    """(params, cfg) of a dense model's first ``n`` layers: each
    layer-stacked tensor sliced in place (views, no copy)."""
    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) else t[:n]
    return {**params, "layers": cut(params["layers"])}, dataclasses.replace(cfg, num_layers=n)


def track_preemptions(eng) -> dict:
    """seq id -> its output count when the scheduler first preempted it to
    recompute (the victim goes to the front of the waiting queue)."""
    sch, inner, victims = eng.scheduler, eng.scheduler._preempt_one, {}

    def preempt(*a, **kw):
        ok = inner(*a, **kw)
        if ok and sch.waiting and sch.waiting[0].num_computed_tokens == 0:
            s = sch.waiting[0]
            victims.setdefault(s.seq_id, len(s.output_token_ids))
        return ok
    sch._preempt_one = preempt
    return victims


def phase_swap_8b(params8, cfg8):
    """(L2) QSpec (W4A8) on the first L_SWAP_LAYERS of (A)'s layers,
    L_SWAP_TOKENS tokens, with L_SWAP_PAGES pages under
    preemption_mode="swap": over bf16 and int8 KV, tokens == the same
    engine's with pages to spare, sequences swapped out and in, the parked
    KV returned bit for bit. Over bf16, recompute mode and a swap pool of 0 GiB (which
    falls back to recompute) give the same tokens as each other; against
    the unconstrained run they agree on every sequence not preempted and on
    a preempted one up to its preemption: its re-prefill computes the
    generated tokens' KV through the prompt GEMM branch, where the first
    pass ran the kernels, so its stream may part at a near-tie (logged,
    not required)."""
    prompts = [(p, {}) for p in e2e_prompts()]
    params8, cfg8 = first_layers(params8, cfg8, L_SWAP_LAYERS)
    out = {}
    for kv in ("bfloat16", "int8"):
        ref, _, r_info = l_run(l_engine(cfg8, params8, kv=kv), prompts, max_tokens=L_SWAP_TOKENS)
        eng = l_engine(cfg8, params8, kv=kv, num_pages=L_SWAP_PAGES, mode="swap")
        toks, _, info = l_run(eng, prompts, max_tokens=L_SWAP_TOKENS)
        pool = eng._swap_pool
        if toks != ref or not pool.num_swap_outs or pool.num_swap_ins != pool.num_swap_outs:
            raise AssertionError(f"(L2) {kv}: swapped run {[t[:8] for t in toks]} vs "
                                 f"{[t[:8] for t in ref]}, {pool.num_swap_outs} out, "
                                 f"{pool.num_swap_ins} in")
        out[kv] = {"swap_outs": pool.num_swap_outs, "swap_ins": pool.num_swap_ins,
                   "bytes_parked": eng.swap_bytes_out, "tokens_per_s": info["tokens_per_s"],
                   "unconstrained_tokens_per_s": r_info["tokens_per_s"]}
        del eng
        if kv != "bfloat16":
            continue
        rec = {}
        for mode, gb in (("recompute", 4.0), ("swap", 0.0)):
            eng = l_engine(cfg8, params8, num_pages=L_SWAP_PAGES, mode=mode, swap_gb=gb)
            victims = track_preemptions(eng)
            got, _, info = l_run(eng, prompts, max_tokens=L_SWAP_TOKENS)
            if eng._swap_pool is not None and eng._swap_pool.num_swap_outs:
                raise AssertionError(f"(L2) swap_space_gb={gb} swapped")
            parted = {i: next((j for j, (a, b) in enumerate(zip(got[i], ref[i])) if a != b),
                              None) for i in range(len(ref))}
            bad = [i for i, j in parted.items() if j is not None
                   and (i not in victims or j < victims[i])]
            if not victims or bad:
                raise AssertionError(f"(L2) {mode} (swap_space_gb={gb}): preempted "
                                     f"{victims}, streams parted at {parted}")
            rec[mode] = got
            out[f"{mode}_{gb:g}gb"] = {"tokens_per_s": info["tokens_per_s"],
                                       "preempted_at_output": victims,
                                       "parted_at_output": parted}
            del eng
        if rec["recompute"] != rec["swap"]:
            raise AssertionError("(L2) the 0 GiB swap pool's fallback differs from recompute "
                                 "mode")
    return out


def phase_soft_prompt_8b(params8, cfg8, base_toks):
    """(L3) A soft prompt of L_VIRTUAL rows (float basis, rotated into (A)'s
    by its recorded seed) on prompts 0 and 3, and prompt 0 with the same
    rows given as prompt_embeds: rows 0 and 1 give the same tokens, the
    plain row 2 (A)'s, QSpec == qspec_null."""
    from qspec_tpu_torch.lora.layers import Rotation
    from qspec_tpu_torch.models.llama import embed_rows
    prompts = e2e_prompts()
    gen = torch.Generator(device="cuda").manual_seed(43)
    rows = torch.randn(L_VIRTUAL, cfg8.hidden_size, generator=gen, device="cuda") * 0.02
    virt = Rotation(cfg8, params8["quarot"], "cuda").embeddings(rows).to(torch.bfloat16)
    manual = torch.cat([virt, embed_rows(params8, cfg8, torch.tensor(prompts[0],
                                                                      device="cuda"))])
    reqs = [(prompts[0], {"prompt_adapter": "sp"}),
            ([0] * L_VIRTUAL + prompts[0], {"prompt_embeds": manual.float()}),
            (prompts[2], {}), (prompts[3], {"prompt_adapter": "sp"})]
    runs = {}
    for method in ("qspec", "qspec_null"):
        eng = l_engine(cfg8, params8, method)
        eng.prompt_adapters.load("sp", rows)
        runs[method] = l_run(eng, reqs)
        del eng
    toks, oracle = runs["qspec"][0], runs["qspec_null"][0]
    if toks != oracle or toks[0] != toks[1] or toks[2] != base_toks[2] or \
            toks[0] == base_toks[0]:
        raise AssertionError(f"(L3) soft prompt: {[t[:8] for t in toks]}, oracle "
                             f"{[t[:8] for t in oracle]}, base {[t[:8] for t in base_toks]}")
    return {"tokens_per_s": runs["qspec"][2]["tokens_per_s"],
            "oracle_tokens_per_s": runs["qspec_null"][2]["tokens_per_s"],
            "acceptance": runs["qspec"][2]["acceptance_rate"]}


def rescore(params, cfg, prompt, tokens) -> float:
    """The summed logprobs of ``tokens`` after ``prompt`` from one
    teacher-forced prefill of both (a fresh bf16 cache, W4A16)."""
    from qspec_tpu_torch.models.llama import AttentionBatch, model_forward
    from qspec_tpu_torch.ops import kv_cache as kvc
    ids = torch.tensor(prompt + tokens, device="cuda")
    T, S = len(ids), 128
    P = -(-T // S) + 1
    cache = kvc.allocate(kvc.KVCacheConfig(cfg.num_layers, cfg.cache_kv_heads,
                                           cfg.cache_head_dim, P, S), "cuda")
    pos = torch.arange(T, device="cuda")[None]
    batch = AttentionBatch(pos, pos + S, torch.arange(1, P, dtype=torch.int32,
                                                      device="cuda")[None],
                           torch.tensor([T], dtype=torch.int32, device="cuda"))
    logits, _ = model_forward(params, cfg, ids[None].to(torch.int32), cache, batch,
                              scheme="w4a16")
    lp = torch.log_softmax(logits[0, len(prompt) - 1:T - 1].float(), dim=-1)
    return float(lp.gather(1, ids[len(prompt):, None]).sum())


def phase_beam_8b(params8, cfg8):
    """(L4) LLM.beam_search (width 4, 8 tokens) on 2 prompts over (A)'s
    parameters and engine: 4 distinct beams a prompt, sorted by score, each
    beam's cumulative logprob within L_BEAM_TOL of a teacher-forced
    re-scoring."""
    from qspec_tpu_torch import LLM
    from qspec_tpu_torch.beam_search import BeamSearchParams
    prompts = e2e_prompts()[:2]
    llm = LLM(model="llama3-8b", params=params8, num_speculative_tokens=3,
              speculative_draft_scheme="w4a8", max_model_len=512, max_num_seqs=8, seed=0)
    t0 = time.perf_counter()
    outs = llm.beam_search(prompts, BeamSearchParams(beam_width=4, max_tokens=8,
                                                     ignore_eos=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del llm
    err, control = 0.0, []
    for p, other, o in zip(prompts, prompts[::-1], outs):
        scores = [s.score(1.0) for s in o.sequences]
        if len({tuple(s.tokens) for s in o.sequences}) != 4 or scores != sorted(scores,
                                                                              reverse=True):
            raise AssertionError(f"(L4) beams not distinct and sorted: "
                                 f"{[(s.tokens, s.cum_logprob) for s in o.sequences]}")
        for s in o.sequences:
            err = max(err, abs(rescore(params8, cfg8, p, s.tokens) - s.cum_logprob))
        control.append(abs(rescore(params8, cfg8, other, o.sequences[0].tokens)
                           - o.sequences[0].cum_logprob))
    if err > L_BEAM_TOL or min(control) <= L_BEAM_TOL:
        raise AssertionError(f"(L4) a beam's cumulative logprob is {err} from its re-scoring "
                             f"(tol {L_BEAM_TOL}); after the other prompt {control}")
    return {"wall_s": wall, "steps": 8, "beams": 8, "max_rescore_err": err,
            "control_err": control, "top_cum_logprob": [o.sequences[0].cum_logprob
                                                        for o in outs]}


def phase_lora_server(params8, cfg8, d: str, l1_toks):
    """(L5) build_server over (A)'s parameters with a fresh bank: load b
    from its PEFT directory over HTTP, a completion whose ``model`` names
    it (32 greedy tokens of prompt 2), unload; the tokens == LLM.generate's
    with lora_name="b" (where they part from (L1)'s row of b is logged)."""
    import http.client

    from qspec_tpu_torch import LLM, SamplingParams
    from qspec_tpu_torch.engine.arg_utils import EngineArgs
    from qspec_tpu_torch.entrypoints.openai.api_server import ServerThread, build_server
    from qspec_tpu_torch.lora import LoRAConfig, init_lora_params
    prompt = e2e_prompts()[2]
    args = EngineArgs(model="llama3-8b", num_speculative_tokens=3,
                      speculative_draft_scheme="w4a8", max_model_len=512, max_num_seqs=4)
    params = {**params8, "lora": init_lora_params(cfg8, LoRAConfig(L_SLOTS, L_RANK),
                                                  device="cuda")}
    server = build_server(args, model_name="llama3-8b", params=params,
                          tokenizer=SmokeTokenizer(), device="cuda")
    t0 = time.perf_counter()
    with ServerThread(server) as st:
        loaded = http_json(st.port, "/v1/load_lora_adapter", {"lora_name": "b", "lora_path": d})
        c = http.client.HTTPConnection("127.0.0.1", st.port, timeout=600)
        c.request("GET", "/v1/models")
        models = [m["id"] for m in json.loads(c.getresponse().read())["data"]]
        c.close()
        reply = http_json(st.port, "/v1/completions", {
            "model": "b", "prompt": prompt, "max_tokens": 32, "temperature": 0.0,
            "ignore_eos": True, "logprobs": 1})
        http_json(st.port, "/v1/unload_lora_adapter", {"lora_name": "b"})
    wall = time.perf_counter() - t0
    del server
    got = [int(t) for t in reply["choices"][0]["logprobs"]["tokens"]]
    llm = LLM(params=params, device="cuda", **dataclasses.asdict(args))
    llm.llm_engine.lora.load_path("b", d)
    want = llm.generate([prompt], SamplingParams(temperature=0.0, max_tokens=32,
                                                 ignore_eos=True),
                        lora_name="b")[0].output_token_ids
    del llm, params
    if loaded["slot"] != 1 or models != ["llama3-8b", "b"] or got != want:
        raise AssertionError(f"(L5) slot {loaded['slot']}, models {models}, server "
                             f"{got[:8]}, LLM.generate {want[:8]}")
    # (L1) served b's prompt in a batch of 4, whose prompt rectangle ran the
    # prompt GEMM branch at another M (not row-independent): logged only
    return {"serve_wall_s": wall,
            "parts_from_l1_at": next((j for j, (a, b) in enumerate(zip(got, l1_toks[2]))
                                      if a != b), None)}


def phase_engine_surface_8b(params8, cfg8, base_toks, smi: str):
    """(L) LoRA, swap preemption, soft prompts, beam search and the LoRA
    routes on (A)'s Llama-3-8B (int8 head, bf16 KV, QSpec k = 3 with the
    W4A8 draft), each greedy run against its oracle in this call."""
    import tempfile
    t_phase = time.perf_counter()
    out, times = {}, {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        l1_launches, l1_toks, out["L1"] = phase_lora_8b(params8, cfg8, base_toks, d)
        times["L1"] = time.perf_counter() - t0
        for name, fn in (("L2", lambda: phase_swap_8b(params8, cfg8)),
                         ("L3", lambda: phase_soft_prompt_8b(params8, cfg8, base_toks)),
                         ("L4", lambda: phase_beam_8b(params8, cfg8)),
                         ("L5", lambda: phase_lora_server(params8, cfg8, d, l1_toks))):
            t0 = time.perf_counter()
            out[name] = fn()
            torch.cuda.empty_cache()
            times[name] = time.perf_counter() - t0
    wall = time.perf_counter() - t_phase
    out["seconds"] = times
    log("surface (L) " + json.dumps(out, separators=(",", ":")), stdout=False)
    l1, l2, l3, l4 = out["L1"], out["L2"], out["L3"], out["L4"]
    log(f"surface (L) llama3-8b: (L1) LoRA slots 0/a/b/a == qspec_null, slot 0 == (A), exact "
        f"launches, {l1['tokens_per_s']:.4g} tok/s (oracle {l1['oracle_tokens_per_s']:.4g}); "
        f"(L2, {L_SWAP_LAYERS} layers) swap == unconstrained, bf16 "
        f"{l2['bfloat16']['swap_outs']} out / "
        f"{l2['bfloat16']['bytes_parked'] / 2 ** 20:.1f} MiB, int8 "
        f"{l2['int8']['swap_outs']} out, recompute parted at "
        f"{l2['recompute_4gb']['parted_at_output']}; (L3) soft prompt == prompt_embeds == "
        f"qspec_null; "
        f"(L4) 2 x 4 beams, rescore err {l4['max_rescore_err']:.3g}; (L5) server LoRA "
        f"load/complete/unload == LLM.generate; {wall:.1f} s; card {smi}", stdout=False)
    return l1_launches, out


# the kernels of the EAGLE and MLPSpeculator paths on a QuaRot target:
# the verify scheme's; EAGLE's layer adds the gamma norm and the bf16
# attention over its own cache, and drafts through the int8 head
PROPOSER_KERNELS = MEDUSA_KERNELS
PROPOSER_K = 3


def proposer_launches(cfg, summary: dict, k: int, eagle: bool) -> dict:
    """The launches an EAGLE (``eagle``) or MLPSpeculator run must make:
    per target forward (prompt chunk or verify pass) 1 attention a layer, 2
    norms a layer and the final norm, and the head once, and per verify
    pass 4 w4a16 a layer (the prompt rectangle of e2e_prompts is past
    BIGM_BYTES on every projection: its GEMMs take the dequantize-once
    branch, no kernel); per pass of EAGLE's layer (prompt chunk, span
    re-feed, draft step) the attention once and 3 norms, 2 of them gamma
    norms; per round of EAGLE k more heads."""
    L, t_fw = cfg.num_layers, summary["forwards"]
    d_fw = summary.get("draft_forwards", 0) if eagle else 0
    rounds = summary["rounds_run"]
    return {"matmul_w4a16": 4 * L * rounds, "paged_attention": L * t_fw + d_fw,
            "rmsnorm": (2 * L + 1) * t_fw + 3 * d_fw, "rmsnorm_gamma": 2 * d_fw,
            "matmul_w8a16": t_fw + (k * rounds if eagle else 0)}


def phase_proposers_8b(smi: str):
    """(E1) EAGLE and (E2) MLPSpeculator at Llama-3-8B width through LLM
    (QuaRot, the JAX package's defaults: int8 head, bf16 KV), random target
    weights made on the card, k = 3: (E1) speculative_model="[eagle]" with
    a random EAGLE net of the target's widths (init_eagle_params, about
    0.5 GB bf16), its tokens == AR's (the same LLM without speculation);
    (E2) speculative_model="[mlp_speculator]" with a random net
    (init_mlp_speculator_params, inner width = hidden), == its medusa_null
    oracle. Each launches exactly PROPOSER_KERNELS, in the counts
    proposer_launches gives from its forwards."""
    from qspec_tpu_torch import LLM
    from qspec_tpu_torch.config import ModelConfig
    from qspec_tpu_torch.models.llama import init_params
    from qspec_tpu_torch.spec_decode.eagle import init_eagle_params
    from qspec_tpu_torch.spec_decode.mlp_speculator import init_mlp_speculator_params
    cfg = ModelConfig.llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device="cuda")
    prompts = e2e_prompts()
    kw = dict(model="llama3-8b", device="cuda", max_model_len=512, max_num_seqs=4, seed=0)
    out = {}
    for key, net, method, oracle in (("E1", "eagle", "eagle", "ar"),
                                     ("E2", "mlp_spec", "mlp_speculator", "medusa_null")):
        params.pop("eagle", None)
        params[net] = (init_eagle_params(cfg, seed=5, device="cuda") if net == "eagle" else
                       init_mlp_speculator_params(cfg.hidden_size, cfg.vocab_size, PROPOSER_K,
                                                  seed=6, device="cuda"))

        def make(m, _, method=method):
            spec_kw = {} if m == "ar" else dict(
                num_speculative_tokens=PROPOSER_K, speculative_model=f"[{method}]",
                speculative_method=m)
            return LLM(params=params, **spec_kw, **kw).llm_engine
        label = f"({key}) llama3-8b {method} (int8 head, bf16 KV, k=3)"
        spec, launches, _, summary = spec_vs_oracle(make, label, PROPOSER_KERNELS, prompts, 32,
                                                    methods=(method, oracle))
        want = proposer_launches(cfg, summary, PROPOSER_K, net == "eagle")
        got = {n: launches[n] for n in want}
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want} ({summary})")
        summary["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        e2e_log(label, prompts, spec, summary)
        out[key] = (launches, summary)
        torch.cuda.empty_cache()
    log(f"e2e (E): card {smi}", stdout=False)
    del params
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- (G) the sparse-MoE MLP

# the shapes the MoE presets give csrc/w4.cu that no dense path gives it
# (Mixtral-8x7B's experts are Llama-3-8B's gate_up / down, checked above):
# Qwen1.5-MoE-A2.7B's expert gate_up and down (K = 1408: a half-full last
# 256-k stage), its shared expert's and its qkv (with the bias); and its int8
# head for csrc/w8a16.cu
MOE_SHAPES = {"expert gate_up": (2048, 2816), "expert down": (1408, 2048),
              "shared gate_up": (2048, 11264), "shared down": (5632, 2048),
              "qkv": (2048, 6144)}
MOE_HEAD = (2048, 151936)
MOE_M = (4, 16)           # the draft's rows and the verify's (4 sequences x k + 1)


def check_moe_shapes(gen, report):
    """matmul_w4a16 (within rtol / atol 2e-2) and matmul_w4a4 (bit for bit,
    int4 and int8 activations) against their plain versions at MOE_SHAPES,
    M = 4 and 16; the same through an expert-stacked [2, 3, K//8, N] weight
    read in place at (layer, expert) = (1, 2), bit for bit the unstacked
    call; the int8 head at MOE_HEAD (f32 out, rtol / atol 2e-2)."""
    from qspec_tpu_torch.ops import linear_kernels as lk
    from qspec_tpu_torch.ops.quant import sym_quant_int4, sym_quant_int8
    err16 = err_h = 0.0
    for label, (k, n) in MOE_SHAPES.items():
        qw = torch.empty(2, 3, k // 8, n, dtype=torch.int32, device="cuda")
        qs = torch.empty(2, 3, n, device="cuda")
        for i in range(2):
            for e in range(3):
                qw[i, e], qs[i, e] = _w4(gen, k, n)
        w, s = qw[1, 2], qs[1, 2]
        for m in MOE_M:
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            out = lk.matmul_w4a16(x, w, s)
            ref = lk.matmul_w4a16_ref(x, w, s)
            torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
            err16 = max(err16, (out.float() - ref.float()).abs().max().item())
            same = torch.equal(lk.matmul_w4a16(x, qw, qs, layer_idx=(1, 2)), out)
            for xq in (sym_quant_int4(x), sym_quant_int8(x)):
                out = lk.matmul_w4a4(xq.values, xq.scales, w, s)
                same &= torch.equal(out, lk.matmul_w4a4_ref(xq.values, xq.scales, w, s))
                same &= torch.equal(lk.matmul_w4a4(xq.values, xq.scales, qw, qs,
                                                   layer_idx=(1, 2)), out)
            if not same:
                raise AssertionError(f"MoE shape {label} K={k} N={n} M={m}: matmul_w4a4 not "
                                     "bit-equal to its plain version, or a stacked (layer, "
                                     "expert) call not to the unstacked one")
        del qw, qs, w, s
    k, n = MOE_HEAD
    qw, qs = _w8(gen, k, n)
    for m in MOE_M:
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        out = lk.matmul_w8a16(x, qw, qs, out_dtype=torch.float32)
        ref = lk.matmul_w8a16_ref(x, qw, qs, out_dtype=torch.float32)
        torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
        err_h = max(err_h, (out - ref).abs().max().item())
    del qw, qs
    torch.cuda.empty_cache()
    report["matmul_w4a16"]["moe_max_err"] = err16
    report["matmul_w8a16"]["moe_head_max_err"] = err_h
    log(f"check (G) MoE shapes {sorted(MOE_SHAPES.values())} at M=4,16: matmul_w4a16 max_abs_err "
        f"{err16:.3g} (tol 2e-2), matmul_w4a4 bit-equal (int4, int8 act), stacked "
        f"(layer, expert) reads == unstacked; int8 head K,N={MOE_HEAD} {err_h:.3g}")


def time_moe_shapes(gen, report, int4pack_missing):
    """At MOE_SHAPES and M = 4, 16: matmul_w4a16 and matmul_w4a4 beside
    their plain versions, their yardsticks (torch._weight_int4pack_mm;
    torch._int_mm on int8 weights plus the scale epilogue, at the least M it
    takes) and the bound, each input rotated past L2; the int8 head at
    MOE_HEAD beside torch._weight_int8pack_mm. Per kernel, shape and M:
    [ms, plain_ms, bound_ms, library_ms] in report[kernel]["moe"], and a
    line each in the log."""
    from qspec_tpu_torch.ops import linear_kernels as lk
    for name in ("matmul_w4a16", "matmul_w4a4"):
        rows = {}
        for label, (k, n) in MOE_SHAPES.items():
            for m in MOE_M:
                r = time_w4_layer(gen, name, m, shapes=((k, n),),
                                  library=name == "matmul_w4a4" or int4pack_missing is None)
                rows[f"{label} {k}x{n} M={m}"] = [float(f"{r[f]:.5g}") if r[f] is not None
                                                  else None for f in ("ms", "plain_ms",
                                                                      "bound_ms", "library_ms")]
                log(f"time (G) {name} {label} K={k} N={n} M={m}: {r['ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.4f}, {r['library']} "
                    + (f"{r['library_ms']:.4f}" if r["library_ms"] is not None else "none")
                    + f", bound {r['bound_ms']:.4f} ({r['bound_by']})", stdout=False)
        report[name]["moe"] = rows
        torch.cuda.empty_cache()
    k, n = MOE_HEAD
    wbytes = k * n + 4 * n
    rot = Rotating(lambda: _w8(gen, k, n), wbytes)

    def transposed():
        qw, qs = _w8(gen, k, n)
        return qw.t().contiguous(), qs.to(torch.bfloat16)
    rot_t = Rotating(transposed, wbytes)
    rows = {}
    for m in MOE_M:
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)

        def kern():
            lk.matmul_w8a16(x, *rot.next(), out_dtype=torch.float32)

        def plain():
            lk.matmul_w8a16_ref(x, *rot.next(), out_dtype=torch.float32)

        def library():
            torch._weight_int8pack_mm(x, *rot_t.next())
        b, kind = bound_ms(m * k * 2 + wbytes + m * n * 4, 2 * m * k * n, "bf16")
        t = [graph_ms(kern), graph_ms(plain, reps=3), b, graph_ms(library)]
        rows[f"head {k}x{n} M={m}"] = [float(f"{v:.5g}") for v in t]
        log(f"time (G) matmul_w8a16 head K={k} N={n} M={m}: {t[0]:.4f} ms, plain {t[1]:.4f}, "
            f"_weight_int8pack_mm {t[3]:.4f}, bound {b:.4f} ({kind})", stdout=False)
    report["matmul_w8a16"]["moe"] = rows
    del rot, rot_t
    torch.cuda.empty_cache()
    w16, w4 = report["matmul_w4a16"]["moe"], report["matmul_w4a4"]["moe"]
    down = "expert down 1408x2048 M=16"
    log(f"time (G) MoE shapes ({len(w16) + len(w4) + len(rows)} rows in the log): "
        f"w4a16 {down} {w16[down][0]} ms (bound {w16[down][2]}), w4a4 "
        f"{w4[down][0]} ms (bound {w4[down][2]})")


def moe_prompts(vocab: int):
    """e2e_prompts (98-173 random ids below 128000) folded into ``vocab``."""
    return [[t % vocab for t in p] for p in e2e_prompts()]


def moe_engine(cfg, params, tally=None, **spec_kw):
    """The factory of an LLMEngine of ``cfg`` serving QSpec (k = 3) with
    ``spec_kw`` over a KV pool of 80 pages of 128; with ``tally`` (a list)
    each engine's rounds are wrapped by ``round_tally``, its tally appended."""
    from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, SchedulerConfig,
                                 SpeculativeConfig)

    def make(method, p):
        eng = LLMEngine(EngineConfig(
            model=cfg, cache=CacheConfig(page_size=128, num_pages=80),
            scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=512),
            speculative=SpeculativeConfig(num_speculative_tokens=3, method=method,
                                          **spec_kw)), p or params, device="cuda", seed=0)
        if tally is not None:
            tally.append(round_tally(eng))
        return eng
    return make


def round_tally(eng) -> dict:
    """Wrap ``eng.runner.run_spec_rounds``: the int4 GEMMs' launches inside
    the QSpec rounds, beside the rounds' target (verify) and draft forwards."""
    from qspec_tpu_torch.ops.linear_kernels import matmul_w4a4, matmul_w4a16
    runner, inner = eng.runner, eng.runner.run_spec_rounds
    tally = {"matmul_w4a16": 0, "matmul_w4a4": 0, "verify": 0, "draft": 0}

    def run(*a, **kw):
        before = (matmul_w4a16.launches, matmul_w4a4.launches, runner.target_forwards,
                  runner.draft_forwards)
        out = inner(*a, **kw)
        tally["matmul_w4a16"] += matmul_w4a16.launches - before[0]
        tally["matmul_w4a4"] += matmul_w4a4.launches - before[1]
        tally["verify"] += runner.target_forwards - before[2]
        tally["draft"] += runner.draft_forwards - before[3]
        return out
    runner.run_spec_rounds = run
    return tally


def moe_launches(cfg) -> int:
    """int4 GEMM launches of one forward of ``cfg``'s layers: per layer
    qkv, o, and the MLP's gate_up and down (of each expert, and the shared
    expert's two, in an MoE)."""
    return cfg.num_layers * (2 + 2 * max(cfg.num_experts, 1)
                             + 2 * bool(cfg.shared_expert_intermediate_size))


def check_moe_counts(label: str, cfg, launches: dict, summary: dict, tally: dict) -> None:
    """Exact launch counts of a QSpec run on an MoE ``cfg`` (t target and d
    draft forwards): inside the rounds matmul_w4a16 moe_launches(cfg) a
    verify forward and matmul_w4a4 as many a draft forward; over the run
    matmul_w4a4 that a draft forward (the draft prefill has no torch branch),
    rmsnorm_quant 2 L a draft forward, rmsnorm 2 L + 1 a target forward and
    1 (the final norm) a draft one, the attention L a forward of either, the
    int8 head 1 a forward of either."""
    L, per = cfg.num_layers, moe_launches(cfg)
    t, d = summary["target_forwards"], summary["draft_forwards"]
    want = {"matmul_w4a4": per * d, "rmsnorm_quant": 2 * L * d, "rmsnorm": (2 * L + 1) * t + d,
            "paged_attention": L * (t + d), "matmul_w8a16": t + d}
    got = {n: launches[n] for n in want}
    rounds = {"matmul_w4a16": per * tally["verify"], "matmul_w4a4": per * tally["draft"]}
    if got != want or {n: tally[n] for n in rounds} != rounds or not tally["verify"]:
        raise AssertionError(f"{label}: launches {got}, expected {want}; in the rounds "
                             f"{tally}, expected {rounds}")


def moe_run(label: str, cfg, params, prompts, schemes, max_tokens: int = 32) -> dict:
    """QSpec (k = 3) on ``cfg`` through LLMEngine against qspec_null, per
    draft scheme: tokens equal, exactly QUAROT_KERNELS launched, the counts
    of check_moe_counts; acceptance, tok/s (host clock) and peak GiB."""
    out = {}
    for scheme in schemes:
        name = f"{label} ({scheme} draft, int8 head, bf16 KV)"
        tally = []
        torch.cuda.reset_peak_memory_stats()
        spec, launches, _, summary = spec_vs_oracle(
            moe_engine(cfg, params, tally, draft_scheme=scheme), name, QUAROT_KERNELS,
            prompts, max_tokens)
        summary["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        check_moe_counts(name, cfg, launches, summary, tally[0])
        summary["verify_forwards_in_rounds"] = tally[0]["verify"]
        e2e_log(name, prompts, spec, summary)
        out[scheme] = (launches, summary)
    return out


def moe_line(label: str, runs: dict, extra: str = "") -> None:
    parts = [f"{s} accept {r[1]['acceptance_rate']:.4f}, {r[1]['spec_tokens_per_s']:.1f} tok/s "
             f"(oracle {r[1]['oracle_tokens_per_s']:.1f}), peak "
             f"{r[1]['peak_mem_gib']:.2f} GiB" for s, r in runs.items()]
    log(f"e2e {label}: == qspec_null, exact launch counts; " + "; ".join(parts) + extra)


# (G1)'s depth: Mixtral-8x7B's 32 layers cut to 8, for the script's time
# limit: at 32 (G) took 170.3 s and the script 970.8 s of the chip tool's
# 1200, at 16 (G) 122.0 s and the script 933 s (H100 80GB HBM3, 700 W,
# PERF.md §6); phase (L) adds about 140 s
MIXTRAL_LAYERS = 8


def phase_moe_mixtral(smi: str):
    """(G1) Mixtral-8x7B's widths (ModelConfig.mixtral_8x7b: 8 experts of
    14336, top-2, hidden 4096, vocab 32000) at MIXTRAL_LAYERS of its 32
    layers, quant="w4" with the int8 head, random weights made on the card
    by init_params (the experts one (layer, expert) at a time: int4 that
    never passes through host memory), through LLMEngine over a bf16 cache:
    QSpec (k = 3) with the W4A4 and the W4A8 draft against qspec_null, 4
    prompts x 32 tokens. Only the depth is cut (MIXTRAL_LAYERS)."""
    from qspec_tpu_torch.config import ModelConfig
    from qspec_tpu_torch.models.llama import init_params
    cfg = ModelConfig.mixtral_8x7b(quant="w4", num_layers=MIXTRAL_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=20, device="cuda")
    torch.cuda.synchronize()
    secs, weights = time.perf_counter() - t0, torch.cuda.memory_allocated() / 2 ** 30
    runs = moe_run("(G1) mixtral-8x7b", cfg, params, moe_prompts(cfg.vocab_size),
                   ("w4a4", "w4a8"))
    moe_line(f"(G1) mixtral-8x7b, {cfg.num_layers} of its 32 layers (the script's time "
             "limit) x 8 experts", runs,
             f"; weights {weights:.2f} GiB made in {secs:.1f} s")
    log(f"e2e (G1): card {smi}", stdout=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# (G2)'s depth: Qwen1.5-MoE-A2.7B's 24 layers cut to 6, for the script's
# time limit: at 24 a forward runs 1440 expert iterations on the host, and
# (G2) took 143.4 s of (G)'s ~200 on an H100 80GB HBM3 at 700 W (PERF.md §6)
QWEN15_LAYERS = 6


def phase_moe_qwen15(smi: str):
    """(G2) Qwen1.5-MoE-A2.7B's widths (ModelConfig.qwen15_moe_a2_7b: 60
    experts of 1408, top-4, a gated shared expert of 5632, the qkv bias,
    vocab 151936) at QWEN15_LAYERS layers, quant="w4", random weights made
    on the card, QSpec with the W4A8 draft against qspec_null, the checks of
    (G1). Only the depth is cut (QWEN15_LAYERS)."""
    from qspec_tpu_torch.config import ModelConfig
    from qspec_tpu_torch.models.llama import init_params
    cfg = ModelConfig.qwen15_moe_a2_7b(quant="w4", num_layers=QWEN15_LAYERS)
    params = init_params(cfg, seed=21, device="cuda")
    runs = moe_run(f"(G2) qwen1.5-moe-a2.7b, {cfg.num_layers} layers", cfg, params,
                   moe_prompts(cfg.vocab_size), ("w4a8",))
    moe_line(f"(G2) qwen1.5-moe-a2.7b, {cfg.num_layers} of its 24 layers (the script's time "
             "limit) x 60 experts + shared", runs)
    log(f"e2e (G2): card {smi}", stdout=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# (G3)'s directories: each family's Hugging Face config.json fields at 2
# layers and narrow widths (hidden 1024, 8 heads of 128, 4 KV heads, vocab
# 8192); expert widths the Hadamard takes, Qwen2-MoE's 1408 the shape (G2)
# runs
MOE_DIRS = {
    "mixtral": dict(architectures=["MixtralForCausalLM"], model_type="mixtral",
                    intermediate_size=1536, num_local_experts=4, num_experts_per_tok=2),
    "qwen2_moe": dict(architectures=["Qwen2MoeForCausalLM"], model_type="qwen2_moe",
                      intermediate_size=2816, moe_intermediate_size=1408,
                      shared_expert_intermediate_size=2816, num_experts=8,
                      num_experts_per_tok=4),
    "qwen3_moe": dict(architectures=["Qwen3MoeForCausalLM"], model_type="qwen3_moe",
                      intermediate_size=2816, moe_intermediate_size=768, num_experts=8,
                      num_experts_per_tok=2, norm_topk_prob=True, head_dim=128),
    "deepseek": dict(architectures=["DeepseekForCausalLM"], model_type="deepseek",
                     intermediate_size=2816, moe_intermediate_size=704, n_routed_experts=8,
                     n_shared_experts=2, num_experts_per_tok=2, first_k_dense_replace=1),
}
MOE_DIR_COMMON = dict(hidden_size=1024, num_hidden_layers=2, num_attention_heads=8,
                      num_key_value_heads=4, vocab_size=8192, rms_norm_eps=1e-6,
                      rope_theta=1000000.0, max_position_embeddings=4096,
                      tie_word_embeddings=False)


def moe_entries(cfg, family: str):
    """A Hugging Face MoE checkpoint's names and shapes: Mixtral's
    block_sparse_moe.experts.{e}.w1 / w3 / w2, Qwen-MoE's mlp.experts.{e}.*_proj
    with Qwen2-MoE's shared expert and its gate and qkv biases, Qwen3-MoE's
    q / k norms, DeepSeek's dense first layer and shared_experts."""
    H, V = cfg.hidden_size, cfg.vocab_size
    out = [("model.embed_tokens.weight", (V, H), "w")]
    for li in range(cfg.num_layers):
        p = f"model.layers.{li}."
        out += [(p + "input_layernorm.weight", (H,), "gamma"),
                (p + "post_attention_layernorm.weight", (H,), "gamma"),
                (p + "self_attn.q_proj.weight", (cfg.q_size, H), "w"),
                (p + "self_attn.k_proj.weight", (cfg.kv_size, H), "w"),
                (p + "self_attn.v_proj.weight", (cfg.kv_size, H), "w"),
                (p + "self_attn.o_proj.weight", (H, cfg.q_size), "w")]
        if cfg.qkv_bias:
            out += [(p + f"self_attn.{n}_proj.bias", (w,), "b")
                    for n, w in (("q", cfg.q_size), ("k", cfg.kv_size), ("v", cfg.kv_size))]
        if cfg.qk_norm:
            out += [(p + f"self_attn.{n}_norm.weight", (cfg.head_dim,), "gamma") for n in "qk"]
        mix = family == "mixtral"
        m = p + ("block_sparse_moe." if mix else "mlp.")
        names = ("w1", "w3", "w2") if mix else ("gate_proj", "up_proj", "down_proj")
        if li < cfg.first_k_dense:
            mlps = [(m, cfg.intermediate_size)]
        else:
            out.append((m + "gate.weight", (cfg.num_experts, H), "w"))
            mlps = [(f"{m}experts.{e}.", cfg.expert_intermediate_size)
                    for e in range(cfg.num_experts)]
            if cfg.shared_expert_intermediate_size:
                mlps.append((m + ("shared_expert." if cfg.shared_expert_gated
                                  else "shared_experts."), cfg.shared_expert_intermediate_size))
                if cfg.shared_expert_gated:
                    out.append((m + "shared_expert_gate.weight", (1, H), "w"))
        for q, width in mlps:
            out += [(q + names[0] + ".weight", (width, H), "w"),
                    (q + names[1] + ".weight", (width, H), "w"),
                    (q + names[2] + ".weight", (H, width), "w")]
    return out + [("model.norm.weight", (H,), "gamma"), ("lm_head.weight", (V, H), "w")]


def phase_moe_dirs(smi: str):
    """(G3) LLM(model=<dir>) on a Mixtral, a Qwen2-MoE and a Qwen3-MoE
    directory written here (MOE_DIRS: config.json and model.safetensors of
    random bf16 made on the card, by the script's write_safetensors; the
    card's machine has no transformers), each quantized at load by
    quantize_float on the card, QSpec with the W4A4 draft == qspec_null,
    exactly QUAROT_KERNELS launched; and a DeepSeek-MoE directory (a dense
    first layer, ungated shared experts) in bf16 (quantization=None,
    convert_deepseek), n-gram (k = 3) == its "null" oracle, only the gamma
    norm and the bf16 attention launched."""
    import tempfile
    from qspec_tpu_torch import LLM
    from qspec_tpu_torch.models.registry import resolve
    kw = dict(device="cuda", max_model_len=512, max_num_seqs=4, seed=0, num_pages=80)
    out = {}
    for i, (family, fields) in enumerate(MOE_DIRS.items()):
        hf = {**MOE_DIR_COMMON, **fields}
        cfg = resolve(hf)
        label = f"(G3) {family} dir, 2 layers x {cfg.num_experts} experts"
        with tempfile.TemporaryDirectory() as d:
            sd = random_state_dict(moe_entries(cfg, family), seed=30 + i)
            write_safetensors(os.path.join(d, "model.safetensors"), sd)
            del sd
            write_config(d, hf)
            if family == "deepseek":
                prompts = float_prompts(cfg.vocab_size)
                spec, launches, _, summary = spec_vs_oracle(
                    lambda m, p: LLM(model=d, quantization=None, num_speculative_tokens=3,
                                     speculative_model="[ngram]", speculative_method=m,
                                     **kw).llm_engine,
                    label + " bf16, n-gram", FLOAT_LLAMA_KERNELS, prompts, 32,
                    methods=("ngram", "null"))
            else:
                prompts = moe_prompts(cfg.vocab_size)
                spec, launches, _, summary = spec_vs_oracle(
                    lambda m, p: LLM(model=d, num_speculative_tokens=3, speculative_method=m,
                                     **kw).llm_engine,
                    label + " quantize_float, w4a4 draft", QUAROT_KERNELS, prompts, 32)
            e2e_log(label, prompts, spec, summary)
            out[family] = (launches, summary)
        torch.cuda.empty_cache()
    log("e2e (G3) LLM(model=<dir>): mixtral / qwen2_moe / qwen3_moe quantize_float, w4a4 QSpec "
        "== qspec_null (accept " + ", ".join(f"{out[f][1]['acceptance_rate']:.3f}"
                                             for f in ("mixtral", "qwen2_moe", "qwen3_moe"))
        + f"); deepseek bf16 n-gram == null (accept {out['deepseek'][1]['acceptance_rate']:.3f})")
    log(f"e2e (G3): card {smi}", stdout=False)
    return out


# ------------------------------------------------- (H) the dense families

# one Qwen2-7B layer's projections (K, N): qkv with the bias (3584 + 2 x 512),
# o, gate_up (2 x 18944) and down (K = 18944); 28 query heads over 4 KV heads
QWEN2_7B_PROJ = {"qkv": (3584, 4608), "o": (3584, 3584), "gate_up": (3584, 37888),
                 "down": (18944, 3584)}
QWEN2_7B_HEADS = (28, 4)
# the int8 heads of (H)'s models, (K, N): Qwen2-7B's, Phi-3's (a half last
# tile), Granite-3.0's (49155: padded at load to 49280, sliced back) and
# Gemma-7B's
DENSE_HEADS = {"qwen2-7b": (3584, 152064), "phi-3-mini": (3072, 32064),
               "granite-3.0-8b": (4096, 49155), "gemma-7b": (3072, 256000)}
DENSE_M = (4, 16)         # the draft's rows and the verify's (4 sequences x k + 1)


def check_dense_shapes(gen, report):
    """(H) the kernels at the shapes of the dense families: the attention at
    Qwen2-7B's GQA group 7 (Q = 1, 2, 4: 7, 14, 28 rows a KV head) at the
    verify's contexts and at 8192 (32 splits), against its plain version;
    matmul_w4a16 (2e-2) and matmul_w4a4 (bit for bit, int4 and int8
    activations) at one Qwen2-7B layer's projections, M = 4 and 16, read in
    place from a layer stack; the grouped GEMM there (g = 128, 2e-2); both
    norms with and without the residual add at H = 3584 and 3072; the int8
    head through compute_logits at DENSE_HEADS (2e-2)."""
    from qspec_tpu_torch.models.llama import _make_lm_head, compute_logits
    from qspec_tpu_torch.ops import linear_kernels as lk
    from qspec_tpu_torch.ops.attention import paged_attention_ref
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    from qspec_tpu_torch.ops.quant import sym_quant_int4, sym_quant_int8
    Hq, Hkv = QWEN2_7B_HEADS
    err = {"paged_attention": 0.0, "matmul_w4a16": 0.0, "matmul_w4a16_g": 0.0,
           "matmul_w8a16": 0.0, "rmsnorm": 0.0, "rmsnorm_quant": 0.0}
    for q_len in (1, 2, 4):
        for ctx in (_ctx_lens(q_len), (LONG_CTX, LONG_CTX - 1, 4097, 40)):
            q, cache, tables, c = _attn_inputs(gen, q_len, Hq=Hq, Hkv=Hkv, ctx=list(ctx))
            out = paged_attention_cuda(q, cache.kv_pages, tables, c, 128 ** -0.5, layer=1)
            ref = paged_attention_ref(q, cache, 1, tables, c, 128 ** -0.5)
            torch.testing.assert_close(out.float(), ref.float(), rtol=3e-2, atol=3e-2)
            err["paged_attention"] = max(err["paged_attention"],
                                         (out.float() - ref.float()).abs().max().item())
            del q, cache
    for k, n in QWEN2_7B_PROJ.values():
        qw = torch.empty(2, k // 8, n, dtype=torch.int32, device="cuda")
        qs = torch.empty(2, n, device="cuda")
        for li in range(2):
            qw[li], qs[li] = _w4(gen, k, n)
        gw = _w4g(gen, k, n)
        for m in DENSE_M:
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            out = lk.matmul_w4a16(x, qw, qs, layer_idx=1)
            ref = lk.matmul_w4a16_ref(x, qw[1], qs[1])
            torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
            err["matmul_w4a16"] = max(err["matmul_w4a16"],
                                      (out.float() - ref.float()).abs().max().item())
            for xq in (sym_quant_int4(x), sym_quant_int8(x)):
                if not torch.equal(lk.matmul_w4a4(xq.values, xq.scales, qw, qs, layer_idx=1),
                                   lk.matmul_w4a4_ref(xq.values, xq.scales, qw[1], qs[1])):
                    raise AssertionError(f"(H) matmul_w4a4 K={k} N={n} M={m}: not bit-equal "
                                         "to its plain version")
            out, ref = lk.matmul_w4a16_g(x, *gw), lk.matmul_w4a16_g_ref(x, *gw)
            torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
            err["matmul_w4a16_g"] = max(err["matmul_w4a16_g"],
                                        (out.float() - ref.float()).abs().max().item())
        del qw, qs, gw
    for h in (3584, 3072):
        for m in DENSE_M:
            x, r = _norm_set(gen, m, h)
            for name, bits, gamma in (("rmsnorm_quant", 4, None), ("rmsnorm_quant", 8, None),
                                      ("rmsnorm", None, None), ("rmsnorm", None, _gamma(gen, h))):
                for res in (None, r):
                    got = norm_fn(name, bits, gamma)(x, res)
                    want = norm_fn(name, bits, gamma, True)(x, res)
                    if res is not None and not torch.equal(got[-1], x + r):
                        raise AssertionError(f"(H) {name} H={h}: h is not x + r")
                    if name == "rmsnorm_quant":
                        torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=0)
                        d = (got[0].int() - want[0].int()).abs()
                        if d.max().item() > 1 or (d == 0).float().mean().item() <= 0.99:
                            raise AssertionError(f"(H) rmsnorm_quant H={h} M={m}: values")
                        err[name] = max(err[name], float(d.max().item()))
                    else:
                        torch.testing.assert_close(got[0].float(), want[0].float(),
                                                   rtol=2e-2, atol=2e-2)
                        err[name] = max(err[name],
                                        (got[0].float() - want[0].float()).abs().max().item())
    for label, (k, n) in DENSE_HEADS.items():
        head = _make_lm_head(torch.randn(k, n, generator=gen, device="cuda") * 0.05, "int8")
        for m in DENSE_M:
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            out = compute_logits(x, head, n)
            ref = lk.matmul_w8a16_ref(x, head["qw8"][:, :n], head["qs"][:n],
                                      out_dtype=torch.float32)
            if tuple(out.shape) != (m, n):
                raise AssertionError(f"(H) int8 head {label}: logits {tuple(out.shape)}")
            torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
            err["matmul_w8a16"] = max(err["matmul_w8a16"], (out - ref).abs().max().item())
        del head
    torch.cuda.empty_cache()
    for name, e in err.items():
        report[name]["dense_max_err"] = e
    log("check (H) dense shapes: attention GQA group 7 (Q=1,2,4; ctx to 8192), w4a16 / w4a4 "
        "(bit-equal) / w4a16_g at Qwen2-7B's projections M=4,16, norms H=3584,3072, int8 heads "
        f"{sorted(n for _, n in DENSE_HEADS.values())}: max_abs_err "
        + json.dumps({k: float(f"{v:.3g}") for k, v in err.items()}, separators=(",", ":")),
        stdout=False)


def time_dense_shapes(gen, report, int4pack_missing):
    """Every kernel at Qwen2-7B's shapes, beside its plain version, the
    library call where one computes the same function and the bound, each
    input set rotated past L2: matmul_w4a16 and matmul_w4a4 per layer (the
    four projections) and the grouped GEMM per layer (g = 128) at M = 4 and
    16; the attention at group 7, B = 4, Q = 4 over the verify's contexts;
    the int8 head at N = 152064, M = 4 and 16; rmsnorm (M = 16) and
    rmsnorm_quant (4 bits, M = 4) at H = 3584 with the residual add. Per
    kernel [ms, plain_ms, bound_ms, library_ms] in report[kernel]["qwen2_7b"]
    (the verify's M for w4a16 and its norm, the draft's for w4a4 and its
    norm) and every row in the log."""
    from qspec_tpu_torch.ops import linear_kernels as lk
    from qspec_tpu_torch.ops.attention import paged_attention_ref
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    shapes = tuple(QWEN2_7B_PROJ.values())
    rows = {}
    for name in ("matmul_w4a16", "matmul_w4a4"):
        for m in DENSE_M:
            r = time_w4_layer(gen, name, m, shapes=shapes,
                              library=name == "matmul_w4a4" or int4pack_missing is None)
            rows[(name, m)] = r
            log(f"time (H) {name} Qwen2-7B layer M={m} ({', '.join(r['per'])} ms): "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, {r['library']} "
                + (f"{r['library_ms']:.4f}" if r["library_ms"] is not None else "none")
                + f", bound {r['bound_ms']:.4f} ({r['bound_by']})", stdout=False)
    for m in DENSE_M:
        r = _time_w4g_layer(gen, shapes, m, int4pack_missing is None)
        r["library"] = "_weight_int4pack_mm" if r["library_ms"] is not None else None
        rows[("matmul_w4a16_g", m)] = r
        log(f"time (H) matmul_w4a16_g Qwen2-7B layer M={m} g={GROUP} ({', '.join(r['per'])} "
            f"ms): {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, library "
            + (f"{r['library_ms']:.4f}" if r["library_ms"] is not None else "none")
            + f", bound {r['bound_ms']:.4f} ({r['bound_by']})", stdout=False)
    # the attention at group 7, the verify shape
    Hq, Hkv = QWEN2_7B_HEADS
    live = _ctx_lens(4)
    kv_bytes = sum(live) * Hkv * 128 * 2 * 2
    rot = Rotating(lambda: _attn_inputs(gen, 4, Hq=Hq, Hkv=Hkv), kv_bytes)
    q, _, tables, _ = rot.sets[0]

    def kern():
        q, cache, tables, ctx = rot.next()
        paged_attention_cuda(q, cache.kv_pages, tables, ctx, 128 ** -0.5, layer=1)

    def plain():
        q, cache, tables, ctx = rot.next()
        paged_attention_ref(q, cache, 1, tables, ctx, 128 ** -0.5)
    nbytes = 2 * q.numel() * 2 + kv_bytes + tables.numel() * 4 + 8 * 4
    seen = sum(sum(c - 4 + i + 1 for i in range(4)) for c in live)
    b, kind = bound_ms(nbytes, 4 * Hq * 128 * seen, "bf16")
    rows[("paged_attention", 4)] = dict(ms=graph_ms(kern, reps=max(20, len(rot.sets))),
                                        plain_ms=graph_ms(plain, reps=3), bound_ms=b,
                                        bound_by=kind, library_ms=None)
    del rot, q, tables
    # the int8 head at Qwen2-7B's vocabulary
    k, n = DENSE_HEADS["qwen2-7b"]
    wbytes = k * n + 4 * n
    rot = Rotating(lambda: _w8(gen, k, n), wbytes)

    def transposed():
        qw, qs = _w8(gen, k, n)
        return qw.t().contiguous(), qs.to(torch.bfloat16)
    rot_t = Rotating(transposed, wbytes)
    for m in DENSE_M:
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        b, kind = bound_ms(m * k * 2 + wbytes + m * n * 4, 2 * m * k * n, "bf16")
        rows[("matmul_w8a16", m)] = dict(
            ms=graph_ms(lambda: lk.matmul_w8a16(x, *rot.next(), out_dtype=torch.float32)),
            plain_ms=graph_ms(lambda: lk.matmul_w8a16_ref(x, *rot.next(),
                                                          out_dtype=torch.float32), reps=3),
            bound_ms=b, bound_by=kind,
            library_ms=graph_ms(lambda: torch._weight_int8pack_mm(x, *rot_t.next())))
    del rot, rot_t
    torch.cuda.empty_cache()
    # the norms at H = 3584 with the residual add
    for name, m, bits in (("rmsnorm", 16, None), ("rmsnorm_quant", 4, 4)):
        h = 3584
        rot = _norm_rot(gen, m, h)
        kern_f, plain_f = norm_fn(name, bits, None), norm_fn(name, bits, None, True)
        reps = max(20, len(rot.sets))
        out_bytes = m * h + 4 * m if name == "rmsnorm_quant" else m * h * 2
        b, kind = bound_ms(m * h * 2 * 2 + out_bytes + m * h * 2,
                           (7 if bits else 5) * m * h, "f32")
        rows[(name, m)] = dict(ms=graph_ms(lambda: kern_f(*rot.next()), reps),
                               plain_ms=graph_ms(lambda: plain_f(*rot.next()), reps),
                               bound_ms=b, bound_by=kind, library_ms=None)
        del rot
    fields = ("ms", "plain_ms", "bound_ms", "library_ms")
    for (name, m), r in rows.items():
        log(f"time (H) {name} Qwen2-7B M={m}: " + ", ".join(
            f"{f} {r[f]:.5f}" if r[f] is not None else f"{f} none" for f in fields)
            + f" ({r['bound_by']})", stdout=False)
    pick = {"matmul_w4a16": 16, "matmul_w4a4": 4, "matmul_w4a16_g": 16, "paged_attention": 4,
            "matmul_w8a16": 16, "rmsnorm": 16, "rmsnorm_quant": 4}
    for name, m in pick.items():
        report[name]["qwen2_7b"] = [float(f"{rows[(name, m)][f]:.5g}")
                                    if rows[(name, m)][f] is not None else None for f in fields]
        report[name]["qwen2_7b_shape"] = f"M={m}"
    log("time (H) Qwen2-7B shapes, ms kernel/bound: " + "; ".join(
        f"{name} M={m} {rows[(name, m)]['ms']:.4f}/{rows[(name, m)]['bound_ms']:.4f}"
        for name, m in pick.items()))


# (H1)'s and (J1)'s depth: Qwen2-7B's 28 layers and InternLM2.5-7B's 32 cut
# to 4, to pay for phase (M) inside the script's time limit (at full depth
# (H) took 137 s and (J) 132 s of a 987 s run; (M) took 93 s alone, on an
# H100 80GB HBM3 at 700 W: PERF.md §6)
H1_LAYERS = 4


def phase_qwen2_7b(smi: str):
    """(H1) LLM(model=<a directory holding only Qwen2-7B's config.json>,
    params=...): Qwen2-7B at full width and H1_LAYERS of its 28 layers
    (hidden 3584, intermediate 18944, 28 / 4 heads, vocab 152064, the qkv
    bias; QWEN25_7B_HF's fields, which Qwen2-7B's config.json shares, at
    ModelConfig.qwen2_7b's window of 32768), quant="w4" with the int8 head
    over a bf16 cache, random int4 weights made on the card from the seed
    (init_params), QSpec (k = 3) with the W4A4 and the W4A8 draft, each
    against qspec_null on moe_prompts: tokens equal, exactly QUAROT_KERNELS
    launched, in check_moe_counts' counts (4 x H1_LAYERS matmul_w4a16 a
    verify forward, as many matmul_w4a4 a draft forward, H1_LAYERS
    attention launches a forward of either)."""
    import tempfile
    from qspec_tpu_torch import LLM
    from qspec_tpu_torch.models.llama import init_params
    from qspec_tpu_torch.models.registry import resolve
    hf = {**QWEN25_7B_HF, "num_hidden_layers": H1_LAYERS, "max_position_embeddings": 32768}
    cfg = dataclasses.replace(resolve(hf), quant="w4")
    prompts = moe_prompts(cfg.vocab_size)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=22, device="cuda")
    torch.cuda.synchronize()
    made = {"seconds": time.perf_counter() - t0,
            "gib": torch.cuda.memory_allocated() / 2 ** 30}
    out = {}
    with tempfile.TemporaryDirectory() as d:
        write_config(d, hf)
        for scheme in ("w4a4", "w4a8"):
            tally = []

            def make(method, p, scheme=scheme, tally=tally):
                llm = LLM(model=d, params=p or params, device="cuda", seed=22,
                          num_speculative_tokens=3, speculative_draft_scheme=scheme,
                          speculative_method=method, max_model_len=512, max_num_seqs=4,
                          num_pages=80)
                if llm.engine_config.model != cfg:
                    raise AssertionError("(H1) the directory's config is not Qwen2-7B's: "
                                         f"{llm.engine_config.model} vs {cfg}")
                tally.append(round_tally(llm.llm_engine))
                return llm.llm_engine
            name = f"(H1) qwen2-7b ({scheme} draft, int8 head, bf16 KV)"
            torch.cuda.reset_peak_memory_stats()
            spec, launches, _, summary = spec_vs_oracle(make, name, QUAROT_KERNELS, prompts, 32)
            summary["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            check_moe_counts(name, cfg, launches, summary, tally[0])
            summary["verify_forwards_in_rounds"] = tally[0]["verify"]
            e2e_log(name, prompts, spec, summary)
            out[scheme] = (launches, summary)
            torch.cuda.empty_cache()
    moe_line(f"(H1) qwen2-7b, {H1_LAYERS} of its 28 layers", out,
             f"; weights made in {made['seconds']:.1f} s, {made['gib']:.2f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"e2e (H1): card {smi}", stdout=False)
    return out


# (H2)'s directories: each family's reference checkpoint's published
# config.json fields, only num_hidden_layers cut (to 2). Phi-3's 48 longrope
# factors a list are placeholders (the published values are not in the
# repo): the count and the roles are the published ones, and every prompt
# position lies inside the original window of 4096, where the short factors
# and the attention factor apply
QWEN25_7B_HF = dict(
    architectures=["Qwen2ForCausalLM"], model_type="qwen2", hidden_act="silu",
    hidden_size=3584, intermediate_size=18944, max_position_embeddings=131072,
    max_window_layers=28, num_attention_heads=28, num_hidden_layers=28,
    num_key_value_heads=4, rms_norm_eps=1e-06, rope_theta=1000000.0, sliding_window=131072,
    tie_word_embeddings=False, use_sliding_window=False, vocab_size=152064)
DENSE_DIRS = {
    "qwen2.5-7b": QWEN25_7B_HF,
    "qwen3-8b": dict(
        architectures=["Qwen3ForCausalLM"], model_type="qwen3", attention_bias=False,
        head_dim=128, hidden_act="silu", hidden_size=4096, intermediate_size=12288,
        max_position_embeddings=40960, max_window_layers=36, num_attention_heads=32,
        num_hidden_layers=36, num_key_value_heads=8, rms_norm_eps=1e-06, rope_scaling=None,
        rope_theta=1000000, sliding_window=None, tie_word_embeddings=False,
        use_sliding_window=False, vocab_size=151936),
    "mistral-7b-v0.1": dict(
        architectures=["MistralForCausalLM"], model_type="mistral", hidden_act="silu",
        hidden_size=4096, intermediate_size=14336, max_position_embeddings=32768,
        num_attention_heads=32, num_hidden_layers=32, num_key_value_heads=8,
        rms_norm_eps=1e-05, rope_theta=10000.0, sliding_window=4096,
        tie_word_embeddings=False, vocab_size=32000),
    "gemma-7b": dict(
        architectures=["GemmaForCausalLM"], model_type="gemma", attention_bias=False,
        head_dim=256, hidden_act="gelu", hidden_size=3072, intermediate_size=24576,
        max_position_embeddings=8192, num_attention_heads=16, num_hidden_layers=28,
        num_key_value_heads=16, rms_norm_eps=1e-06, rope_scaling=None, rope_theta=10000.0,
        vocab_size=256000),
    "phi-3-mini-128k": dict(
        architectures=["Phi3ForCausalLM"], model_type="phi3", attention_bias=False,
        hidden_act="silu", hidden_size=3072, intermediate_size=8192,
        max_position_embeddings=131072, original_max_position_embeddings=4096,
        num_attention_heads=32, num_hidden_layers=32, num_key_value_heads=32,
        rms_norm_eps=1e-05, rope_theta=10000.0, sliding_window=262144,
        tie_word_embeddings=False, vocab_size=32064,
        rope_scaling={"type": "longrope",
                      "short_factor": np.linspace(1.0, 2.0, 48).round(4).tolist(),
                      "long_factor": np.geomspace(1.0, 64.0, 48).round(4).tolist()}),
    "granite-3.0-8b": dict(
        architectures=["GraniteForCausalLM"], model_type="granite", attention_bias=False,
        attention_multiplier=0.0078125, embedding_multiplier=12.0, hidden_act="silu",
        hidden_size=4096, intermediate_size=12800, logits_scaling=16.0,
        max_position_embeddings=4096, mlp_bias=False, num_attention_heads=32,
        num_hidden_layers=40, num_key_value_heads=8, residual_multiplier=0.22,
        rms_norm_eps=1e-05, rope_scaling=None, rope_theta=10000.0,
        tie_word_embeddings=True, vocab_size=49155),
}
DENSE_LAYERS = 2


def dense_entries(cfg, fused: bool):
    """A dense family's checkpoint names and shapes: split q / k / v and
    gate / up (``fused``: Phi-3's qkv_proj and gate_up_proj), Qwen2's q/k/v
    biases, Qwen3's q / k norms, the lm_head unless it is tied (Gemma,
    Granite: none, as save_pretrained writes it)."""
    H, V, I = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    out = [("model.embed_tokens.weight", (V, H), "w")]
    for li in range(cfg.num_layers):
        p = f"model.layers.{li}."
        out += [(p + "input_layernorm.weight", (H,), "gamma"),
                (p + "post_attention_layernorm.weight", (H,), "gamma"),
                (p + "self_attn.o_proj.weight", (H, cfg.q_size), "w"),
                (p + "mlp.down_proj.weight", (H, I), "w")]
        if fused:
            out += [(p + "self_attn.qkv_proj.weight", (cfg.qkv_out, H), "w"),
                    (p + "mlp.gate_up_proj.weight", (2 * I, H), "w")]
        else:
            out += [(p + f"self_attn.{n}_proj.weight", (w, H), "w")
                    for n, w in (("q", cfg.q_size), ("k", cfg.kv_size), ("v", cfg.kv_size))]
            out += [(p + f"mlp.{n}_proj.weight", (I, H), "w") for n in ("gate", "up")]
        if cfg.qkv_bias:
            out += [(p + f"self_attn.{n}_proj.bias", (w,), "b")
                    for n, w in (("q", cfg.q_size), ("k", cfg.kv_size), ("v", cfg.kv_size))]
        if cfg.qk_norm:
            out += [(p + f"self_attn.{n}_norm.weight", (cfg.head_dim,), "gamma") for n in "qk"]
    out.append(("model.norm.weight", (H,), "gamma"))
    return out + ([] if cfg.tie_word_embeddings else [("lm_head.weight", (V, H), "w")])


def dense_dir_run(label: str, d: str, cfg, prompts, held: dict, every=(), **extra):
    """QSpec (k = 3, W4A4 draft unless ``extra`` says otherwise) through
    LLM(model=d) against qspec_null on the same parameters (loaded once, by
    the QSpec run: its load seconds and peak GiB into the summary, its
    params into ``held``); exactly the path's kernels launched."""
    from qspec_tpu_torch import LLM
    kw = dict(device="cuda", max_model_len=512, max_num_seqs=4, seed=0, num_pages=80)

    def make(method, p):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        llm = LLM(model=d, params=p, num_speculative_tokens=3, speculative_method=method,
                  **kw, **extra)
        if p is None:
            torch.cuda.synchronize()
            held.update(params=llm.llm_engine.runner.params, cfg=llm.engine_config.model,
                        load_s=time.perf_counter() - t0,
                        load_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        return llm.llm_engine
    expect = W4G_KERNELS if cfg.quant == "w4g" else QUAROT_KERNELS
    spec, launches, _, summary = spec_vs_oracle(make, label, expect, prompts, 32,
                                                every_launch=every)
    summary.update(load_s=held["load_s"], load_peak_gib=held["load_peak_gib"])
    e2e_log(label, prompts, spec, summary)
    return launches, summary


def phase_dense_dirs(smi: str):
    """(H2) LLM(model=<dir>) on a Qwen2.5-7B, Qwen3-8B, Mistral-7B-v0.1,
    Gemma-7B, Phi-3-mini-128k-instruct and Granite-3.0-8B directory written
    here (DENSE_DIRS: the published config.json fields, num_hidden_layers
    cut to DENSE_LAYERS; model.safetensors of random bf16 made on the card),
    each quantized at load by quantize_float on the card, QSpec with the
    W4A4 draft == qspec_null, exactly the QuaRot kernels launched (Gemma's
    attention at head dim 256 on every launch). Returns each run's
    (launches, summary) and the Qwen2.5 and Mistral parameters, which (H3)
    writes back in the reference's QSpec format."""
    import tempfile
    from qspec_tpu_torch.models.registry import resolve
    out, kept = {}, {}
    for i, (name, published) in enumerate(DENSE_DIRS.items()):
        hf = {**published, "num_hidden_layers": DENSE_LAYERS}
        cfg = resolve(hf)
        held = {}
        with tempfile.TemporaryDirectory() as d:
            sd = random_state_dict(dense_entries(cfg, fused=name.startswith("phi")),
                                   seed=50 + i)
            write_safetensors(os.path.join(d, "model.safetensors"), sd)
            del sd
            write_config(d, hf)
            out[name] = dense_dir_run(
                f"(H2) {name} dir, {DENSE_LAYERS} layers, quantize_float, w4a4 draft", d, cfg,
                moe_prompts(cfg.vocab_size), held,
                every=("d256",) if cfg.head_dim == 256 else ())
        if name in ("qwen2.5-7b", "mistral-7b-v0.1"):
            kept[name] = (held["params"], held["cfg"], hf)
        del held
        gc.collect()
        torch.cuda.empty_cache()
    log("e2e (H2) LLM(model=<dir>), published widths at 2 layers, quantize_float, w4a4 QSpec == "
        "qspec_null: " + ", ".join(
            f"{n} {r[1]['acceptance_rate']:.3f} (load {r[1]['load_s']:.1f} s, "
            f"{r[1]['load_peak_gib']:.1f} GiB)" for n, r in out.items()), stdout=False)
    log(f"e2e (H2): card {smi}", stdout=False)
    return out, kept


def reference_qspec_sd(params, cfg) -> dict:
    """A reference-format QSpec state dict from QuaRot params on the card,
    of ``cfg.num_layers`` layers (the params' first ones): each projection's
    int4 values as uint8 [out, in // 2] with its weight_scales, o / down
    under the reference's ``o_proj.1.`` / ``down_proj.1.`` keys, the q/k/v
    biases where the params have them, the rotated embedding and the int8
    head dequantized to bf16."""
    from qspec_tpu_torch.ops.packing import pack_reference, unpack_int4
    head = params["lm_head"]
    sd = {"model.embed_tokens.weight": params["embed"],
          "lm_head.weight": (head["qw8"].float() * head["qs"]).t()[:cfg.vocab_size]
          .to(torch.bfloat16)}
    modules = {"qkv": (("self_attn.q_proj", cfg.q_size), ("self_attn.k_proj", cfg.kv_size),
                       ("self_attn.v_proj", cfg.kv_size)),
               "o": (("self_attn.o_proj.1", cfg.hidden_size),),
               "gate_up": (("mlp.gate_proj", cfg.intermediate_size),
                           ("mlp.up_proj", cfg.intermediate_size)),
               "down": (("mlp.down_proj.1", cfg.hidden_size),)}
    for li in range(cfg.num_layers):
        for name, parts in modules.items():
            layer = params["layers"][name]
            vals, start = unpack_int4(layer["qw"][li]), 0
            for module, width in parts:
                key = f"model.layers.{li}.{module}"
                sd[key + ".weight"] = pack_reference(vals[:, start:start + width])
                sd[key + ".weight_scales"] = layer["qs"][li, start:start + width]
                if "b" in layer:
                    sd[key + ".bias"] = layer["b"][li, start:start + width]
                start += width
            del vals
    return sd


def phase_quarot_dirs(kept: dict, smi: str):
    """(H3) the reference's QuaRot directories and an AWQ one, each through
    LLM(model=<dir>) against its oracle: (a) a qwen2_quarot QSpec-format
    directory (architectures Qwen2QuaRotForCausalLM) written from (H2)'s
    Qwen2.5-7B layers with their q/k/v biases, and (b) a
    QuarotLlamaForCausalLM one (model type llama_quarot) from (H2)'s
    Mistral-7B layers: each loads (load_qspec) to the (H2) parameters' int4
    codes, scales, biases and embedding bit for bit, W4A4 QSpec ==
    qspec_null; (c) an AWQ directory at Qwen2-7B's widths (g = 128, the
    biases, DENSE_LAYERS layers; made on the card by
    model_loader.grouped.make_grouped_state_dict, its config.json naming
    quant_method "awq"), routed to load_awq by that field alone, QSpec with
    the W4A16 draft == qspec_null, exactly the grouped path's kernels."""
    import tempfile
    from qspec_tpu_torch.config import ModelConfig
    from qspec_tpu_torch.model_loader.grouped import make_grouped_state_dict
    out = {}
    for key, (src, arch, mtype) in {"a": ("qwen2.5-7b", "Qwen2QuaRotForCausalLM", "qwen2_quarot"),
                                    "b": ("mistral-7b-v0.1", "QuarotLlamaForCausalLM",
                                          "llama_quarot")}.items():
        params, cfg, hf = kept[src]
        label = f"(H3{key}) {arch} QSpec dir from (H2)'s {src}, load_qspec, w4a4 draft"
        held = {}
        with tempfile.TemporaryDirectory() as d:
            write_safetensors(os.path.join(d, "model.safetensors"), reference_qspec_sd(params, cfg))
            write_config(d, {**hf, "architectures": [arch], "model_type": mtype})
            out[key] = dense_dir_run(label, d, cfg, moe_prompts(cfg.vocab_size), held)
        loaded = held["params"]["layers"]
        same = all(torch.equal(loaded[n][k], params["layers"][n][k])
                   for n in ("qkv", "o", "gate_up", "down") for k in params["layers"][n])
        if not (same and torch.equal(held["params"]["embed"], params["embed"])
                and held["cfg"].qkv_bias == cfg.qkv_bias):
            raise AssertionError(f"{label}: the loaded tensors differ from (H2)'s")
        del held, loaded
        torch.cuda.empty_cache()
    cfg = ModelConfig.qwen2_7b(quant="w4g", num_layers=DENSE_LAYERS)
    hf = {**QWEN25_7B_HF, "num_hidden_layers": DENSE_LAYERS, "max_position_embeddings": 32768,
          "quantization_config": {"quant_method": "awq", "bits": 4, "group_size": GROUP,
                                  "version": "gemm", "zero_point": True}}
    held = {}
    with tempfile.TemporaryDirectory() as d:
        sd = make_grouped_state_dict(cfg, "awq", GROUP, seed=60, device="cuda")
        sd = {k: v.to(torch.bfloat16) if v.is_floating_point() and v.dtype != torch.float16
              else v for k, v in sd.items()}
        write_safetensors(os.path.join(d, "model.safetensors"), sd)
        del sd
        write_config(d, hf)
        out["c"] = dense_dir_run("(H3c) qwen2-7b widths AWQ dir (g=128, qkv bias), load_awq, "
                                 "w4a16 draft", d, cfg, moe_prompts(cfg.vocab_size), held,
                                 speculative_draft_scheme="w4a16")
    if held["cfg"].quant != "w4g" or "b" not in held["params"]["layers"]["qkv"]:
        raise AssertionError("(H3c) the AWQ directory did not load as w4g with its biases")
    del held
    gc.collect()
    torch.cuda.empty_cache()
    log("e2e (H3) LLM(model=<dir>): qwen2_quarot (biases) and QuarotLlama QSpec dirs == (H2)'s "
        "tensors bit for bit, w4a4 == qspec_null (accept "
        f"{out['a'][1]['acceptance_rate']:.3f}, {out['b'][1]['acceptance_rate']:.3f}); AWQ "
        f"qwen2-7b widths by quant_method, w4a16 == qspec_null (accept "
        f"{out['c'][1]['acceptance_rate']:.3f})")
    log(f"e2e (H3): card {smi}", stdout=False)
    return out


# (J) the llama graph under other key names (LLAMA_KEY_REMAPS) and the
# float families: each family's reference checkpoint's published
# config.json fields. Fields marked "recalled" are written from memory of
# the published file, not read from it (no copy is in the repository)
INTERNLM25_7B_HF = dict(
    architectures=["InternLM2ForCausalLM"], model_type="internlm2", bias=False,
    hidden_act="silu", hidden_size=4096, intermediate_size=14336,
    max_position_embeddings=32768, num_attention_heads=32, num_hidden_layers=32,
    num_key_value_heads=8, rms_norm_eps=1e-05, rope_scaling={"type": "dynamic", "factor": 2.0},
    rope_theta=1000000, tie_word_embeddings=False, vocab_size=92544)
REMAP_DIRS = {
    "baichuan-7b": dict(
        architectures=["BaiChuanForCausalLM"], model_type="baichuan", hidden_act="silu",
        hidden_size=4096, intermediate_size=11008, max_position_embeddings=4096,
        num_attention_heads=32, num_hidden_layers=32, rms_norm_eps=1e-06,
        tie_word_embeddings=False, vocab_size=64000),
    # rope (hidden 4096), the NormHead of vocab 125696
    "baichuan2-7b": dict(
        architectures=["BaichuanForCausalLM"], model_type="baichuan", hidden_act="silu",
        hidden_size=4096, intermediate_size=11008, max_position_embeddings=4096,
        model_max_length=4096, num_attention_heads=32, num_hidden_layers=32,
        rms_norm_eps=1e-06, tie_word_embeddings=False, vocab_size=125696),
    # intermediate_size is twice the MLP's (the reader halves it);
    # max_position_embeddings recalled
    "qwen-7b": dict(
        architectures=["QWenLMHeadModel"], model_type="qwen", hidden_size=4096,
        intermediate_size=22016, kv_channels=128, layer_norm_epsilon=1e-06,
        max_position_embeddings=32768, no_bias=True, num_attention_heads=32,
        num_hidden_layers=32, rotary_emb_base=10000, rotary_pct=1.0, seq_length=8192,
        tie_word_embeddings=False, use_dynamic_ntk=True, use_logn_attn=True,
        vocab_size=151936),
    "exaone-3.0-7.8b": dict(
        architectures=["ExaoneForCausalLM"], model_type="exaone", activation_function="silu",
        hidden_size=4096, intermediate_size=14336, layer_norm_epsilon=1e-05,
        max_position_embeddings=4096, num_attention_heads=32, num_key_value_heads=8,
        num_layers=32, rope_theta=500000.0, tie_word_embeddings=False, vocab_size=102400),
    # n_layer, ffn_hidden_size and vocab_size recalled
    "telechat2-7b": dict(
        architectures=["TeleChat2ForCausalLM"], model_type="telechat", hidden_size=4096,
        ffn_hidden_size=12288, layer_norm_epsilon=1e-05, n_head=32, n_layer=30,
        seq_length=8192, tie_word_embeddings=False, vocab_size=131072),
}
FLOAT_DIRS = {
    # ALiBi (hidden 5120), MLP width 13696 = 2^7 x 107: bf16 only
    "baichuan2-13b": dict(
        architectures=["BaichuanForCausalLM"], model_type="baichuan", hidden_act="silu",
        hidden_size=5120, intermediate_size=13696, model_max_length=4096,
        num_attention_heads=40, num_hidden_layers=40, rms_norm_eps=1e-06,
        tie_word_embeddings=False, vocab_size=125696),
    # n_inner, embeddings_scale and width_scale recalled
    "jais-13b": dict(
        architectures=["JAISLMHeadModel"], model_type="jais", activation_function="swiglu",
        embeddings_scale=14.6, layer_norm_epsilon=1e-05, n_embd=5120, n_head=40,
        n_inner=13653, n_layer=40, n_positions=2048, position_embedding_type="alibi",
        scale_qk_dot_by_d=True, vocab_size=84992, width_scale=0.0390625),
    "falcon-rw-7b": dict(
        architectures=["FalconForCausalLM"], model_type="falcon", alibi=True, bias=True,
        hidden_size=4096, layer_norm_epsilon=1e-05, multi_query=False,
        new_decoder_architecture=False, num_attention_heads=64, num_hidden_layers=36,
        parallel_attn=False, vocab_size=65024),
    "falcon-7b": dict(
        architectures=["FalconForCausalLM"], model_type="falcon", alibi=False, bias=False,
        hidden_size=4544, layer_norm_epsilon=1e-05, multi_query=True,
        new_decoder_architecture=False, num_attention_heads=71, num_hidden_layers=32,
        parallel_attn=True, vocab_size=65024),
    "falcon-40b": dict(
        architectures=["FalconForCausalLM"], model_type="falcon", alibi=False, bias=False,
        hidden_size=8192, layer_norm_epsilon=1e-05, new_decoder_architecture=True,
        num_attention_heads=128, num_hidden_layers=60, num_kv_heads=8, parallel_attn=True,
        vocab_size=65024),
}
J_LAYERS = 2
# one Qwen-7B layer's projections (K, N): qkv with the bias (3 x 4096), o,
# gate_up (2 x 11008) and down (K = 11008); 32 heads over 32 KV heads
QWEN_7B_PROJ = {"qkv": (4096, 12288), "o": (4096, 4096), "gate_up": (4096, 22016),
                "down": (11008, 4096)}
# the attention shapes (J) brings, (label, Hq, Hkv, head dim, ALiBi slopes'
# scale or None): Qwen-7B's MHA, Falcon-7B's 71 heads over one KV head and
# Falcon-40B's 16 a group at D=64 (stored 128-padded), Baichuan2-13B's and
# JAIS-13B's ALiBi at 40 heads, falcon-rw's at D=64 with Falcon's 1 / sqrt(d)
J_ATTN = (("mha-32", 32, 32, 128, None), ("group71-d64", 71, 1, 64, None),
          ("group16-d64", 16, 1, 64, None), ("alibi-40", 40, 40, 128, 1.0),
          ("alibi-64-d64", 64, 64, 64, 0.125))
# the int8 heads (K, N) of (J)'s vocabularies
J_HEADS = {"internlm2": (4096, 92544), "qwen": (4096, 151936), "baichuan2": (4096, 125696),
           "exaone": (4096, 102400), "telechat2": (4096, 131072)}


def _model_attn(gen, q_len, Hq, Hkv, D, B=4):
    """(J)'s and (K)'s attention inputs: _attn_inputs' contexts over a cache
    of the model's stored head dim (ModelConfig.cache_head_dim: 256 as is,
    a smaller one 128-padded, the pad lanes zero as update_layer writes
    them), q at the model's head dim."""
    stored = -(-D // 128) * 128
    q, cache, tables, ctx = _attn_inputs(gen, q_len, B=B, Hq=Hq, Hkv=Hkv, D=stored)
    cache.kv_pages[..., D:] = 0
    return q[..., :D].contiguous(), cache, tables, ctx


def _model_slopes(Hq: int, scale_alibi):
    """The ALiBi slopes of a J_ATTN entry on the card (times Falcon's
    1 / sqrt(d) where it has one), or None."""
    from qspec_tpu_torch.ops.attention import alibi_slopes
    if scale_alibi is None:
        return None
    return torch.as_tensor(alibi_slopes(Hq) * np.float32(scale_alibi), device="cuda")


def _model_attn_call(q, cache, tables, ctx, slopes=None, plain=False):
    """The attention as the model calls it (ops.attention.paged_attention:
    q padded to the cache's stored lanes, the output sliced back), or its
    plain version on the same padded inputs."""
    from qspec_tpu_torch.ops.attention import paged_attention, paged_attention_ref
    D = q.shape[-1]
    scale = D ** -0.5
    if plain:
        qp = torch.nn.functional.pad(q, (0, cache.kv_pages.shape[-1] - D))
        return paged_attention_ref(qp, cache, 1, tables, ctx, scale, alibi=slopes)[..., :D]
    return paged_attention(q, cache, 1, tables, ctx, scale, alibi=slopes)


def check_attention_rows(gen, shapes, tag: str) -> float:
    """The attention at ``shapes`` ((label, Hq, Hkv, head dim, ALiBi slopes'
    scale or None); Q = 1 and 4, the verify's contexts) against its plain
    version (3e-2), each ALiBi output moved by its bias; the largest
    error."""
    err = 0.0
    for label, Hq, Hkv, D, alibi in shapes:
        for q_len in (1, 4):
            q, cache, tables, ctx = _model_attn(gen, q_len, Hq, Hkv, D)
            slopes = _model_slopes(Hq, alibi)
            out = _model_attn_call(q, cache, tables, ctx, slopes)
            ref = _model_attn_call(q, cache, tables, ctx, slopes, plain=True)
            torch.testing.assert_close(out.float(), ref.float(), rtol=3e-2, atol=3e-2)
            err = max(err, (out.float() - ref.float()).abs().max().item())
            if alibi is not None and torch.allclose(
                    out.float(), _model_attn_call(q, cache, tables, ctx).float(), atol=3e-2):
                raise AssertionError(f"{tag} attention {label} Q={q_len}: ALiBi moves nothing")
            del q, cache
    return err


def time_attention_rows(gen, shapes) -> dict:
    """label -> the attention's times at the verify (B = 4, Q = 4, the
    verify's contexts, bf16 cache) for each of ``shapes`` (as
    check_attention_rows takes them), beside its plain version and its
    bound, inputs rotated past L2 and made before the graph captures; a
    padded cache's bound counts the D lanes the attention needs (the
    padding is the kernel's excess)."""
    rows = {}
    for label, Hq, Hkv, D, alibi in shapes:
        live = _ctx_lens(4)
        stored = sum(live) * Hkv * -(-D // 128) * 128 * 2 * 2
        rot = Rotating(lambda Hq=Hq, Hkv=Hkv, D=D: _model_attn(gen, 4, Hq, Hkv, D), stored)
        q0, _, tables, _ = rot.sets[0]
        slopes = _model_slopes(Hq, alibi)

        def kern(slopes=slopes):
            _model_attn_call(*rot.next(), slopes)

        def plain(slopes=slopes):
            _model_attn_call(*rot.next(), slopes, plain=True)
        needed = sum(live) * Hkv * D * 2 * 2
        nbytes = 2 * q0.numel() * 2 + needed + tables.numel() * 4 + 8 * 4 + (
            4 * Hq if alibi else 0)
        seen = sum(sum(c - 4 + i + 1 for i in range(4)) for c in live)
        b, kind = bound_ms(nbytes, 4 * Hq * D * seen, "bf16")
        rows[label] = dict(
            ms=graph_ms(kern, reps=max(20, len(rot.sets))), plain_ms=graph_ms(plain, reps=3),
            bound_ms=b, bound_by=kind, library_ms=None)
        del rot, q0, tables
        torch.cuda.empty_cache()
    return rows


def check_remap_shapes(gen, report):
    """(J) the kernels at the shapes its families bring, against their plain
    versions: the attention at J_ATTN (Q = 1 and 4, the verify's contexts),
    each ALiBi output moved by its bias; matmul_w4a16 (2e-2) and matmul_w4a4
    (bit for bit, int4 and int8 activations) at one Qwen-7B layer (K up to
    11008), M = 4 and 16, read in place from a layer stack; the int8 head
    through compute_logits at J_HEADS (2e-2)."""
    from qspec_tpu_torch.models.llama import _make_lm_head, compute_logits
    from qspec_tpu_torch.ops import linear_kernels as lk
    from qspec_tpu_torch.ops.quant import sym_quant_int4, sym_quant_int8
    err = {"paged_attention": check_attention_rows(gen, J_ATTN, "(J)"), "matmul_w4a16": 0.0,
           "matmul_w8a16": 0.0}
    for k, n in QWEN_7B_PROJ.values():
        qw = torch.empty(2, k // 8, n, dtype=torch.int32, device="cuda")
        qs = torch.empty(2, n, device="cuda")
        for li in range(2):
            qw[li], qs[li] = _w4(gen, k, n)
        for m in DENSE_M:
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            out = lk.matmul_w4a16(x, qw, qs, layer_idx=1)
            ref = lk.matmul_w4a16_ref(x, qw[1], qs[1])
            torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
            err["matmul_w4a16"] = max(err["matmul_w4a16"],
                                      (out.float() - ref.float()).abs().max().item())
            for xq in (sym_quant_int4(x), sym_quant_int8(x)):
                if not torch.equal(lk.matmul_w4a4(xq.values, xq.scales, qw, qs, layer_idx=1),
                                   lk.matmul_w4a4_ref(xq.values, xq.scales, qw[1], qs[1])):
                    raise AssertionError(f"(J) matmul_w4a4 K={k} N={n} M={m}: not bit-equal "
                                         "to its plain version")
        del qw, qs
    for label, (k, n) in J_HEADS.items():
        head = _make_lm_head(torch.randn(k, n, generator=gen, device="cuda") * 0.05, "int8")
        for m in DENSE_M:
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            out = compute_logits(x, head, n)
            ref = lk.matmul_w8a16_ref(x, head["qw8"][:, :n], head["qs"][:n],
                                      out_dtype=torch.float32)
            torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
            err["matmul_w8a16"] = max(err["matmul_w8a16"], (out - ref).abs().max().item())
        del head
    torch.cuda.empty_cache()
    for name, e in err.items():
        report[name]["j_max_err"] = e
    log("check (J) shapes: attention " + ", ".join(a[0] for a in J_ATTN) + " (Q=1,4; ALiBi "
        "moves each output), w4a16 / w4a4 (bit-equal) at Qwen-7B's projections M=4,16, int8 "
        f"heads {sorted(n for _, n in J_HEADS.values())}: max_abs_err "
        + json.dumps({k: float(f"{v:.3g}") for k, v in err.items()}, separators=(",", ":")),
        stdout=False)


def time_remap_shapes(gen, report, int4pack_missing):
    """(J)'s kernel times beside their plain versions, library calls and
    bounds, inputs rotated past L2: matmul_w4a16 and matmul_w4a4 per Qwen-7B
    layer at M = 4 and 16; the attention at the verify (B = 4, Q = 4, the
    verify's contexts, bf16 cache) at Qwen-7B's MHA, Falcon-7B's group 71 at
    D=64 (its cache stored 128 wide; the bound counts the D lanes the
    attention needs, the padding is the kernel's excess) and Baichuan2-13B's
    ALiBi at 40 heads. report[kernel]["j_times"]: label ->
    [ms, plain_ms, bound_ms, library_ms]."""
    rows = {}
    for name in ("matmul_w4a16", "matmul_w4a4"):
        for m in DENSE_M:
            r = time_w4_layer(gen, name, m, shapes=tuple(QWEN_7B_PROJ.values()),
                              library=name == "matmul_w4a4" or int4pack_missing is None)
            rows[(name, f"qwen-7b layer M={m}")] = r
    timed = [a for a in J_ATTN if a[0] in ("mha-32", "group71-d64", "alibi-40")]
    rows.update({("paged_attention", label): r
                 for label, r in time_attention_rows(gen, timed).items()})
    fields = ("ms", "plain_ms", "bound_ms", "library_ms")
    for (name, label), r in rows.items():
        log(f"time (J) {name} {label}: " + ", ".join(
            f"{f} {r[f]:.5f}" if r[f] is not None else f"{f} none" for f in fields)
            + f" ({r['bound_by']})", stdout=False)
        report[name].setdefault("j_times", {})[label] = [
            float(f"{r[f]:.5g}") if r[f] is not None else None for f in fields]
    log("time (J), ms kernel/bound: " + "; ".join(
        f"{name} {label} {r['ms']:.4f}/{r['bound_ms']:.4f}" for (name, label), r in rows.items()),
        stdout=False)


def internlm2_entries(cfg):
    """InternLM2's checkpoint names and shapes: model.tok_embeddings, the
    wqkv rows [nkv, q_per_group + 2, dh] (random, so any interleave is one
    draw), attention.wo, feed_forward.w1 / w3 / w2, the untied output."""
    H, V, I = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    out = [("model.tok_embeddings.weight", (V, H), "w")]
    for li in range(cfg.num_layers):
        p = f"model.layers.{li}."
        out += [(p + "attention_norm.weight", (H,), "gamma"),
                (p + "attention.wqkv.weight", (cfg.qkv_out, H), "w"),
                (p + "attention.wo.weight", (H, cfg.q_size), "w"),
                (p + "ffn_norm.weight", (H,), "gamma"),
                (p + "feed_forward.w1.weight", (I, H), "w"),
                (p + "feed_forward.w3.weight", (I, H), "w"),
                (p + "feed_forward.w2.weight", (H, I), "w")]
    return out + [("model.norm.weight", (H,), "gamma"), ("output.weight", (V, H), "w")]


def remap_entries(cfg, family: str):
    """A family's checkpoint names and shapes in its own keys (norm gammas
    1 + 0.1 N(0, 1); Qwen's c_attn bias, TeleChat2's o / down biases; the
    float families' LayerNorm weights 1 + 0.1 N and biases, JAIS's Conv1D
    weights [in, out])."""
    if family == "internlm2":
        return internlm2_entries(cfg)
    H, V, I, L = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size, cfg.num_layers
    q, kv = cfg.q_size, cfg.kv_size
    if family == "baichuan":
        out = [("model.embed_tokens.weight", (V, H), "w")]
        for li in range(L):
            p = f"model.layers.{li}."
            out += [(p + "input_layernorm.weight", (H,), "gamma"),
                    (p + "self_attn.W_pack.weight", (3 * H, H), "w"),
                    (p + "self_attn.o_proj.weight", (H, H), "w"),
                    (p + "post_attention_layernorm.weight", (H,), "gamma"),
                    (p + "mlp.gate_proj.weight", (I, H), "w"),
                    (p + "mlp.up_proj.weight", (I, H), "w"),
                    (p + "mlp.down_proj.weight", (H, I), "w")]
        return out + [("model.norm.weight", (H,), "gamma"), ("lm_head.weight", (V, H), "w")]
    if family in ("qwen", "exaone", "telechat2"):
        emb = {"telechat2": "transformer.word_embeddings.weight"}.get(family,
                                                                      "transformer.wte.weight")
        out = [(emb, (V, H), "w")]
        for li in range(L):
            p = f"transformer.h.{li}."
            if family == "qwen":
                out += [(p + "ln_1.weight", (H,), "gamma"),
                        (p + "attn.c_attn.weight", (3 * H, H), "w"),
                        (p + "attn.c_attn.bias", (3 * H,), "b"),
                        (p + "attn.c_proj.weight", (H, H), "w"), (p + "ln_2.weight", (H,), "gamma"),
                        (p + "mlp.w1.weight", (I, H), "w"), (p + "mlp.w2.weight", (I, H), "w"),
                        (p + "mlp.c_proj.weight", (H, I), "w")]
            elif family == "exaone":
                a = p + "attn.attention."
                out += [(p + "ln_1.weight", (H,), "gamma"), (a + "q_proj.weight", (q, H), "w"),
                        (a + "k_proj.weight", (kv, H), "w"), (a + "v_proj.weight", (kv, H), "w"),
                        (a + "out_proj.weight", (H, q), "w"), (p + "ln_2.weight", (H,), "gamma"),
                        (p + "mlp.c_fc_0.weight", (I, H), "w"),
                        (p + "mlp.c_fc_1.weight", (I, H), "w"),
                        (p + "mlp.c_proj.weight", (H, I), "w")]
            else:
                s = p + "self_attention."
                out += [(p + "input_layernorm.weight", (H,), "gamma"),
                        (s + "query.weight", (q, H), "w"), (s + "key_value.weight", (2 * kv, H), "w"),
                        (s + "dense.weight", (H, q), "w"), (s + "dense.bias", (H,), "b"),
                        (p + "post_attention_layernorm.weight", (H,), "gamma"),
                        (p + "mlp.gate_proj.weight", (I, H), "w"),
                        (p + "mlp.up_proj.weight", (I, H), "w"),
                        (p + "mlp.down_proj.weight", (H, I), "w"),
                        (p + "mlp.down_proj.bias", (H,), "b")]
        return out + [("transformer.ln_f.weight", (H,), "gamma"), ("lm_head.weight", (V, H), "w")]
    ln = [("{}.weight", (H,), "gamma"), ("{}.bias", (H,), "b")]
    if family == "jais":
        out = [("transformer.wte.weight", (V, H), "w")]
        for li in range(L):
            p = f"transformer.h.{li}."
            for n in ("ln_1", "ln_2"):
                out += [(x.format(p + n), s, k) for x, s, k in ln]
            for n, (k_in, n_out) in {"attn.c_attn": (H, 3 * H), "attn.c_proj": (H, H),
                                     "mlp.c_fc": (H, I), "mlp.c_fc2": (H, I),
                                     "mlp.c_proj": (I, H)}.items():
                out += [(p + n + ".weight", (k_in, n_out), "w"), (p + n + ".bias", (n_out,), "b")]
        return out + [(x.format("transformer.ln_f"), s, k) for x, s, k in ln]
    # falcon: the fused rows [nkv, nh / nkv + 2, dh]; biases under
    # linear_bias; ln_attn / ln_mlp under two norms, else input_layernorm
    # (and falcon-rw's post_attention_layernorm)
    out = [("transformer.word_embeddings.weight", (V, H), "w")]
    bias = cfg.linear_bias
    for li in range(L):
        p = f"transformer.h.{li}."
        norms = (("ln_attn", "ln_mlp") if cfg.parallel_norms == 2 else ("input_layernorm",)
                 if cfg.parallel_block else ("input_layernorm", "post_attention_layernorm"))
        for n in norms:
            out += [(x.format(p + n), s, k) for x, s, k in ln]
        for n, (n_out, k_in) in {"self_attention.query_key_value": (cfg.qkv_out, H),
                                 "self_attention.dense": (H, q), "mlp.dense_h_to_4h": (I, H),
                                 "mlp.dense_4h_to_h": (H, I)}.items():
            out.append((p + n + ".weight", (n_out, k_in), "w"))
            if bias:
                out.append((p + n + ".bias", (n_out,), "b"))
    return out + [(x.format("transformer.ln_f"), s, k) for x, s, k in ln]


J1_LAYERS = 4


def phase_internlm2_7b(smi: str):
    """(J1) InternLM2.5-7B at full width and J1_LAYERS of its 32 layers
    (INTERNLM25_7B_HF: hidden 4096, intermediate 14336, 32 / 8 heads, vocab
    92544, the dynamic rope inside its window of 32768): a state dict of
    random bf16 made on the card in InternLM2's own keys, remapped and
    quantized there by quantize_float (seconds and peak GiB printed), then
    LLM(model=<a directory holding only its config.json>, params=...) with
    max_model_len 512, QSpec (k = 3) with the W4A4 and the W4A8 draft, each
    against qspec_null on moe_prompts: tokens equal, exactly QUAROT_KERNELS
    launched, in check_moe_counts' counts (4 x J1_LAYERS matmul_w4a16 a
    verify forward, as many matmul_w4a4 a draft forward, J1_LAYERS attention
    launches a forward of either)."""
    import tempfile
    from qspec_tpu_torch import LLM
    from qspec_tpu_torch.model_loader.loader import quantize_float
    from qspec_tpu_torch.models.registry import resolve
    hf = {**INTERNLM25_7B_HF, "num_hidden_layers": J1_LAYERS}
    cfg = resolve(hf)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sd = random_state_dict(internlm2_entries(cfg), seed=70)
    n_bytes = sum(t.numel() * 2 for t in sd.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, qcfg = quantize_float(sd, cfg, device="cuda")
    torch.cuda.synchronize()
    secs, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2 ** 30
    if sd:
        raise AssertionError(f"(J1) quantize_float left {len(sd)} tensors unconverted")
    log(f"load (J1) internlm2.5-7b: {n_bytes / 1e9:.2f} GB bf16 in InternLM2's keys, remapped "
        f"and quantized by quantize_float on the card in {secs:.2f} s, peak {peak:.2f} GiB")
    prompts = moe_prompts(cfg.vocab_size)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        write_config(d, hf)
        for scheme in ("w4a4", "w4a8"):
            tally = []

            def make(method, p, scheme=scheme, tally=tally):
                llm = LLM(model=d, params=p or params, device="cuda", seed=0,
                          num_speculative_tokens=3, speculative_draft_scheme=scheme,
                          speculative_method=method, max_model_len=512, max_num_seqs=4,
                          num_pages=80)
                if llm.engine_config.model != qcfg:
                    raise AssertionError("(J1) the directory's config is not the quantized "
                                         f"one: {llm.engine_config.model} vs {qcfg}")
                tally.append(round_tally(llm.llm_engine))
                return llm.llm_engine
            name = f"(J1) internlm2.5-7b ({scheme} draft, int8 head, bf16 KV)"
            torch.cuda.reset_peak_memory_stats()
            spec, launches, _, summary = spec_vs_oracle(make, name, QUAROT_KERNELS, prompts, 32)
            summary["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            check_moe_counts(name, qcfg, launches, summary, tally[0])
            summary["verify_forwards_in_rounds"] = tally[0]["verify"]
            e2e_log(name, prompts, spec, summary)
            out[scheme] = (launches, summary)
            torch.cuda.empty_cache()
    moe_line(f"(J1) internlm2.5-7b, {J1_LAYERS} of its 32 layers", out,
             f"; quantize_float {secs:.1f} s, peak {peak:.2f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"e2e (J1): card {smi}", stdout=False)
    return out, {"load_s": secs, "load_peak_gib": peak}


def _family_dir(d: str, hf: dict, cfg, family: str, seed: int) -> None:
    sd = random_state_dict(remap_entries(cfg, family), seed=seed)
    write_safetensors(os.path.join(d, "model.safetensors"), sd)
    del sd
    write_config(d, hf)


def phase_remap_dirs(smi: str):
    """(J2) LLM(model=<dir>) on Baichuan-7B, Baichuan2-7B, Qwen-7B,
    EXAONE-3.0-7.8B and TeleChat2-7B directories (REMAP_DIRS: the published
    config.json fields, num_hidden_layers cut to J_LAYERS; random bf16 in the
    family's own keys written here), each remapped and quantized at load by
    quantize_float on the card, QSpec with the W4A4 draft == qspec_null,
    exactly the QuaRot kernels launched. Baichuan2's head rows, through its
    remap on the card, have norm 1 before quantization; Qwen-7B carries its
    qkv bias and its window of seq_length; TeleChat2 its rotated o / down
    biases."""
    import tempfile
    from qspec_tpu_torch.model_loader.families import baichuan_to_llama_keys
    from qspec_tpu_torch.models.registry import resolve
    out = {}
    for i, (name, published) in enumerate(REMAP_DIRS.items()):
        layers = {"n_layer": J_LAYERS} if "n_layer" in published else (
            {"num_layers": J_LAYERS} if "num_layers" in published
            else {"num_hidden_layers": J_LAYERS})
        hf = {**published, **layers}
        cfg = resolve(hf)
        family = cfg.arch
        held = {}
        with tempfile.TemporaryDirectory() as d:
            _family_dir(d, hf, cfg, family, seed=80 + i)
            if name == "baichuan2-7b":
                from qspec_tpu_torch.model_loader.loader import read_safetensors
                head = {"lm_head.weight": read_safetensors(d)["lm_head.weight"].cuda()}
                norms = baichuan_to_llama_keys(head, cfg)["lm_head.weight"].norm(dim=1)
                if (norms - 1).abs().max().item() > 1e-5:
                    raise AssertionError("(J2) baichuan2-7b: the remapped head's rows are not "
                                         "unit-norm")
                del head, norms
            out[name] = dense_dir_run(
                f"(J2) {name} dir, {J_LAYERS} layers, remap + quantize_float, w4a4 draft", d,
                cfg, moe_prompts(cfg.vocab_size), held)
        loaded, lcfg = held["params"]["layers"], held["cfg"]
        if lcfg.arch != family or (family == "qwen") != ("b" in loaded["qkv"]) or (
                family == "telechat2") != ("b" in loaded["o"] and "b" in loaded["down"]):
            raise AssertionError(f"(J2) {name}: loaded {lcfg.arch}, biases "
                                 f"{[n for n in loaded if 'b' in loaded[n]]}")
        if family == "qwen" and lcfg.scaling_window != 8192:
            raise AssertionError(f"(J2) qwen-7b: window {lcfg.scaling_window}")
        del held, loaded
        gc.collect()
        torch.cuda.empty_cache()
    log("e2e (J2) LLM(model=<dir>), published widths at 2 layers, remap + quantize_float, w4a4 "
        "QSpec == qspec_null: " + ", ".join(
            f"{n} {r[1]['acceptance_rate']:.3f} (load {r[1]['load_s']:.1f} s, "
            f"{r[1]['load_peak_gib']:.1f} GiB)" for n, r in out.items()), stdout=False)
    log(f"e2e (J2): card {smi}", stdout=False)
    return out


def float_run(label: str, make, cfg, prompts, every=()):
    """n-gram (k = 3) against its null oracle through ``make`` (32 tokens):
    the tokens equal, only the attention (and, on an RMSNorm family, the
    gamma norm) launched, the attention cfg.num_layers times a forward, each
    option of ``every`` on every attention launch."""
    expect = FLOAT_LLAMA_KERNELS if cfg.norm_type == "rmsnorm" else FLOAT_KERNELS
    spec, launches, _, summary = spec_vs_oracle(make, label, expect, prompts, 32,
                                                every_launch=every, methods=("ngram", "null"))
    if launches["paged_attention"] != cfg.num_layers * summary["forwards"]:
        raise AssertionError(f"{label}: {launches['paged_attention']} attention launches, "
                             f"not {cfg.num_layers} x {summary['forwards']} forwards")
    return spec, launches, summary


def float_dir_run(label: str, d: str, cfg, held: dict, every=()):
    """LLM(model=d, quantization=None) with n-gram (k = 3) against its null
    oracle on float_prompts (float_run); ``held`` gets the loaded params and
    cfg, the load's seconds and peak GiB. Returns (launches, summary)."""
    from qspec_tpu_torch import LLM

    def make(method, p):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        llm = LLM(model=d, params=p, quantization=None, num_speculative_tokens=3,
                  speculative_model="[ngram]", speculative_method=method,
                  device="cuda", max_model_len=512, max_num_seqs=4, seed=0,
                  num_pages=80)
        if p is None:
            torch.cuda.synchronize()
            held.update(params=llm.llm_engine.runner.params,
                        cfg=llm.engine_config.model,
                        load_s=time.perf_counter() - t0,
                        load_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        return llm.llm_engine
    prompts = float_prompts(cfg.vocab_size)
    spec, launches, summary = float_run(label, make, cfg, prompts, every)
    summary.update(load_s=held["load_s"], load_peak_gib=held["load_peak_gib"])
    e2e_log(label, prompts, spec, summary)
    return launches, summary


def phase_float_dirs(smi: str):
    """(J3) LLM(model=<dir>, quantization=None) on Baichuan2-13B (ALiBi at
    40 heads, gamma RMSNorm), JAIS-13B (ALiBi, the muP scales), falcon-rw-7b
    (ALiBi at D=64, Falcon's scaled slopes), Falcon-7B (parallel, 71 heads
    over one KV head, D=64) and Falcon-40B (new-decoder GQA, 16 a group, two
    parallel norms) directories (FLOAT_DIRS at J_LAYERS layers, random bf16
    in the family's keys): n-gram (k = 3) == its null oracle, only the
    path's kernels launched (the attention, and Baichuan2-13B's gamma
    norm), the attention J_LAYERS a forward, every launch ALiBi where the
    family has it. Under QuaRot (quantization="qspec") Baichuan2-13B's
    directory raises, naming its MLP width 13696, before the directory is
    read."""
    import tempfile
    from qspec_tpu_torch import LLM
    from qspec_tpu_torch.models.registry import resolve
    out = {}
    for i, (name, published) in enumerate(FLOAT_DIRS.items()):
        layers = {"n_layer": J_LAYERS} if "n_layer" in published else {
            "num_hidden_layers": J_LAYERS}
        hf = {**published, **layers}
        cfg = resolve(hf)
        family = cfg.arch
        held = {}
        with tempfile.TemporaryDirectory() as d:
            _family_dir(d, hf, cfg, family, seed=90 + i)
            if name == "baichuan2-13b":
                try:
                    LLM(model=d, quantization="qspec", device="cuda")
                except NotImplementedError as e:
                    if "MLP width 13696" not in str(e):
                        raise
                else:
                    raise AssertionError("(J3) baichuan2-13b under QuaRot did not raise")
            out[name] = float_dir_run(
                f"(J3) {name} dir, {J_LAYERS} layers, bf16, n-gram k=3", d, cfg, held,
                every=("alibi",) if cfg.position_embedding == "alibi" else ())
        lcfg = held["cfg"]
        if (lcfg.parallel_block, lcfg.parallel_norms, lcfg.num_kv_heads) != (
                cfg.parallel_block, cfg.parallel_norms, cfg.num_kv_heads) or lcfg.quant != "none":
            raise AssertionError(f"(J3) {name}: loaded as {lcfg}")
        del held
        gc.collect()
        torch.cuda.empty_cache()
    log("e2e (J3) LLM(model=<dir>, quantization=None), published widths at 2 layers, n-gram == "
        "null: " + ", ".join(
            f"{n} {r[1]['acceptance_rate']:.3f} (load {r[1]['load_s']:.1f} s)"
            for n, r in out.items()) + "; baichuan2-13b under QuaRot raises (MLP width 13696)",
            stdout=False)
    log(f"e2e (J3): card {smi}", stdout=False)
    return out


# ------------------------------------------------- (K) the gptj rope and partial rotary

# EleutherAI/gpt-j-6b's config.json, the fields the port reads (n_inner null:
# 4 x 4096 = 16384)
GPTJ_6B_HF = dict(
    architectures=["GPTJForCausalLM"], model_type="gptj", activation_function="gelu_new",
    n_embd=4096, n_head=16, n_inner=None, n_layer=28, n_positions=2048, rotary_dim=64,
    vocab_size=50400, layer_norm_epsilon=1e-05, tie_word_embeddings=False)
# the published config.json fields of (K2)'s families; fields marked
# recalled are typed from memory of the published file, not copied from it
K_DIRS = {
    "pythia-6.9b": dict(
        architectures=["GPTNeoXForCausalLM"], model_type="gpt_neox", hidden_act="gelu",
        hidden_size=4096, intermediate_size=16384, layer_norm_eps=1e-05,
        max_position_embeddings=2048, num_attention_heads=32, num_hidden_layers=32,
        rotary_emb_base=10000, rotary_pct=0.25, tie_word_embeddings=False,
        use_parallel_residual=True, vocab_size=50432),
    # head dim 96 (stored 128-padded); hidden_act gelu_fast and
    # intermediate_size recalled
    "gpt-neox-20b": dict(
        architectures=["GPTNeoXForCausalLM"], model_type="gpt_neox", hidden_act="gelu_fast",
        hidden_size=6144, intermediate_size=24576, layer_norm_eps=1e-05,
        max_position_embeddings=2048, num_attention_heads=64, num_hidden_layers=44,
        rotary_emb_base=10000, rotary_pct=0.25, tie_word_embeddings=False,
        use_parallel_residual=True, vocab_size=50432),
    "phi-2": dict(
        architectures=["PhiForCausalLM"], model_type="phi", hidden_act="gelu_new",
        hidden_size=2560, intermediate_size=10240, layer_norm_eps=1e-05,
        max_position_embeddings=2048, num_attention_heads=32, num_hidden_layers=32,
        num_key_value_heads=32, partial_rotary_factor=0.4, qk_layernorm=False,
        rope_theta=10000.0, tie_word_embeddings=False, vocab_size=51200),
    # intermediate_size recalled
    "stablelm-2-1.6b": dict(
        architectures=["StableLmForCausalLM"], model_type="stablelm", hidden_act="silu",
        hidden_size=2048, intermediate_size=5632, layer_norm_eps=1e-05,
        max_position_embeddings=4096, num_attention_heads=32, num_hidden_layers=24,
        num_key_value_heads=32, partial_rotary_factor=0.25, qk_layernorm=False,
        rope_theta=10000, tie_word_embeddings=False, use_parallel_residual=False,
        use_qkv_bias=True, vocab_size=100352),
    # intermediate_size and max_position_embeddings recalled (transformers'
    # CohereConfig defaults, which it ties to c4ai-command-r-v01)
    "command-r-v01": dict(
        architectures=["CohereForCausalLM"], model_type="cohere", hidden_act="silu",
        hidden_size=8192, intermediate_size=22528, layer_norm_eps=1e-05, logit_scale=0.0625,
        max_position_embeddings=8192, num_attention_heads=64, num_hidden_layers=40,
        num_key_value_heads=64, rope_theta=8000000.0, tie_word_embeddings=True,
        use_qk_norm=False, vocab_size=256000),
    # max_position_embeddings and rms_norm_eps recalled (transformers'
    # GlmConfig defaults, which it ties to THUDM/glm-4-9b)
    "glm-4-9b-hf": dict(
        architectures=["GlmForCausalLM"], model_type="glm", attention_bias=True, head_dim=128,
        hidden_act="silu", hidden_size=4096, intermediate_size=13696,
        max_position_embeddings=131072, num_attention_heads=32, num_hidden_layers=40,
        num_key_value_heads=2, partial_rotary_factor=0.5, rms_norm_eps=1.5625e-07,
        rope_theta=10000.0, tie_word_embeddings=False, vocab_size=151552),
    # every field recalled (transformers' HeliumConfig defaults, which it
    # ties to kyutai/helium-1-preview-2b)
    "helium-1-preview-2b": dict(
        architectures=["HeliumForCausalLM"], model_type="helium", attention_bias=False,
        head_dim=128, hidden_act="silu", hidden_size=2560, intermediate_size=7040,
        max_position_embeddings=4096, mlp_bias=False, num_attention_heads=20,
        num_hidden_layers=24, num_key_value_heads=20, rms_norm_eps=1e-08,
        rope_theta=100000.0, tie_word_embeddings=False, vocab_size=48000),
}
# (label, published config, its fields changed): the layouts the port
# refuses (ROADMAP queue 1 item 9), each checked to raise before a weight is
# read
K_REFUSALS = (("cohere use_qk_norm", "command-r-v01", dict(use_qk_norm=True)),
              ("Cohere2ForCausalLM", "command-r-v01",
               dict(architectures=["Cohere2ForCausalLM"], model_type="cohere2")),
              ("stablelm qk_layernorm", "stablelm-2-1.6b", dict(qk_layernorm=True)),
              ("stablelm use_parallel_residual", "stablelm-2-1.6b",
               dict(use_parallel_residual=True)),
              ("phi qk_layernorm", "phi-2", dict(qk_layernorm=True)))
K_LAYERS = 2
# the attention shapes (K) brings, as J_ATTN's (no ALiBi): GPT-J's 16 heads
# at D=256, GPT-NeoX-20B's 64 at D=96 and Phi-2's 32 at D=80 (both stored
# 128-padded), Command-R's 64 at D=128, GLM-4's 32 over 2
K_ATTN = (("gptj-mha16-d256", 16, 16, 256, None), ("neox20b-mha64-d96", 64, 64, 96, None),
          ("phi2-mha32-d80", 32, 32, 80, None), ("commandr-mha64", 64, 64, 128, None),
          ("glm4-group16", 32, 2, 128, None))
K_TIMED = ("gptj-mha16-d256", "neox20b-mha64-d96")
# the gamma rmsnorm's widths in (K): Helium's hidden 2560 (no multiple of
# 1024) and GLM-4's 4096, each launched after the residual add
K_NORM_H = (2560, 4096)


def check_k_shapes(gen, report):
    """(K) the attention at K_ATTN against its plain version
    (check_attention_rows: Q = 1 and 4, 3e-2, the JAX tests' bf16
    tolerance); the gamma rmsnorm at K_NORM_H, M = 4 and 16 (Helium's and
    GLM-4's draft and verify), alone and with the residual add, against its
    plain version (2e-2, h bit for bit the torch add)."""
    err = check_attention_rows(gen, K_ATTN, "(K)")
    torch.cuda.empty_cache()
    report["paged_attention"]["k_max_err"] = err
    e_norm = 0.0
    for h in K_NORM_H:
        g = _gamma(gen, h)
        kern, plain = norm_fn("rmsnorm", None, g), norm_fn("rmsnorm", None, g, True)
        for m in DENSE_M:
            x, r = _norm_set(gen, m, h)
            for res in (None, r):
                got, want = kern(x, res), plain(x, res)
                if res is not None and not (torch.equal(got[-1], x + r)
                                            and torch.equal(want[-1], x + r)):
                    raise AssertionError(f"(K) rmsnorm gamma H={h} M={m}: h is not x + r")
                torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2e-2,
                                           atol=2e-2)
                e_norm = max(e_norm, (got[0].float() - want[0].float()).abs().max().item())
    report["rmsnorm"]["k_max_err"] = e_norm
    log("check (K) shapes: attention " + ", ".join(a[0] for a in K_ATTN)
        + f" (Q=1,4): max_abs_err {err:.3g} (tol rtol=atol=3e-2); rmsnorm with a gamma at "
        f"H={','.join(map(str, K_NORM_H))}, M=4,16, alone and with the add: max_abs_err "
        f"{e_norm:.3g} (tol rtol=atol=2e-2), h == x + r bit for bit")


def time_k_shapes(gen, report):
    """(K3) the attention at GPT-J-6B's verify (B = 4, Q = 4, 16 heads of
    256, contexts 379 / 263 / 512 / 40, bf16 cache) and GPT-NeoX-20B's (64
    heads of 96, stored 128 wide; the bound counts the 96 lanes the function
    needs, the padding is the kernel's excess), inputs rotated past L2,
    every input made before the graph captures; the gamma rmsnorm at
    Helium's verify (time_norm_shape). report[kernel]["k_times"]: label ->
    [ms, plain_ms, bound_ms, library_ms]."""
    rows = time_attention_rows(gen, [a for a in K_ATTN if a[0] in K_TIMED])
    fields = ("ms", "plain_ms", "bound_ms", "library_ms")
    for label, r in rows.items():
        log(f"time (K) paged_attention {label}: " + ", ".join(
            f"{f} {r[f]:.5f}" if r[f] is not None else f"{f} none" for f in fields)
            + f" ({r['bound_by']})", stdout=False)
        report["paged_attention"].setdefault("k_times", {})[label] = [
            float(f"{r[f]:.5g}") if r[f] is not None else None for f in fields]
    # Helium's verify norm (M = 16, H = 2560, a gamma): alone (F.rms_norm its
    # library call) and with the residual add (no one library call)
    t = time_norm_shape(gen, "rmsnorm", 16, 2560, None, True)
    report["rmsnorm"]["k_times"] = {
        "gamma_m16_h2560": [float(f"{t[f]:.5g}") for f in fields],
        "gamma_m16_h2560_fused": [float(f"{t[f]:.5g}") for f in (
            "fused_ms", "plain_fused_ms", "fused_bound_ms")] + [None]}
    log("time (K), ms kernel/bound: " + "; ".join(
        f"paged_attention {label} {r['ms']:.4f}/{r['bound_ms']:.5f}" for label, r in rows.items())
        + f"; rmsnorm gamma_m16_h2560 {t['ms']:.5f}/{t['bound_ms']:.6f}, with the add "
        f"{t['fused_ms']:.5f}/{t['fused_bound_ms']:.6f}")


def k_entries(cfg):
    """A (K) family's checkpoint names and shapes in its own keys: weights
    normal(0.02), biases normal(0.01), norm gammas 1 + 0.1 N(0, 1);
    GPT-NeoX's fused query_key_value rows [nh, 3, dh] (random, so any
    interleave is one draw), GLM's fused gate_up_proj, the heads (and Phi's
    and GPT-J's head biases) untied but Command-R's."""
    H, V, I, L = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size, cfg.num_layers
    q, kv = cfg.q_size, cfg.kv_size

    def lin(name, n_out, n_in, bias):
        return [(name + ".weight", (n_out, n_in), "w")] + (
            [(name + ".bias", (n_out,), "b")] if bias else [])

    def norm(name, beta=True):
        return [(name + ".weight", (H,), "gamma")] + ([(name + ".bias", (H,), "b")] if beta
                                                      else [])
    arch = cfg.arch
    if arch == "helium":
        return llama_entries(cfg)
    if arch == "gptj":
        out = [("transformer.wte.weight", (V, H), "w")]
        for li in range(L):
            p = f"transformer.h.{li}."
            out += (norm(p + "ln_1") + lin(p + "attn.q_proj", q, H, False)
                    + lin(p + "attn.k_proj", kv, H, False) + lin(p + "attn.v_proj", kv, H, False)
                    + lin(p + "attn.out_proj", H, q, False) + lin(p + "mlp.fc_in", I, H, True)
                    + lin(p + "mlp.fc_out", H, I, True))
        return out + norm("transformer.ln_f") + lin("lm_head", V, H, True)
    if arch == "gpt_neox":
        out = [("gpt_neox.embed_in.weight", (V, H), "w")]
        for li in range(L):
            p = f"gpt_neox.layers.{li}."
            out += (norm(p + "input_layernorm") + norm(p + "post_attention_layernorm")
                    + lin(p + "attention.query_key_value", 3 * H, H, True)
                    + lin(p + "attention.dense", H, H, True)
                    + lin(p + "mlp.dense_h_to_4h", I, H, True)
                    + lin(p + "mlp.dense_4h_to_h", H, I, True))
        return out + norm("gpt_neox.final_layer_norm") + [("embed_out.weight", (V, H), "w")]
    out = [("model.embed_tokens.weight", (V, H), "w")]
    for li in range(L):
        p = f"model.layers.{li}."
        a = p + "self_attn."
        qkv = (lin(a + "q_proj", q, H, cfg.qkv_bias or cfg.linear_bias)
               + lin(a + "k_proj", kv, H, cfg.qkv_bias or cfg.linear_bias)
               + lin(a + "v_proj", kv, H, cfg.qkv_bias or cfg.linear_bias))
        if arch == "phi":
            out += (norm(p + "input_layernorm") + qkv + lin(a + "dense", H, q, True)
                    + lin(p + "mlp.fc1", I, H, True) + lin(p + "mlp.fc2", H, I, True))
            continue
        layernorm = cfg.norm_type == "layernorm"
        out += norm(p + "input_layernorm", beta=layernorm and arch != "cohere") + qkv
        out += lin(a + "o_proj", H, q, False)
        if arch != "cohere":
            out += norm(p + "post_attention_layernorm", beta=layernorm)
        out += (lin(p + "mlp.gate_up_proj", 2 * I, H, False) if arch == "glm" else
                lin(p + "mlp.gate_proj", I, H, False) + lin(p + "mlp.up_proj", I, H, False))
        out += lin(p + "mlp.down_proj", H, I, False)
    final = "model.final_layernorm" if arch == "phi" else "model.norm"
    out += norm(final, beta=cfg.norm_type == "layernorm" and arch != "cohere")
    if not cfg.tie_word_embeddings:
        out += lin("lm_head", V, H, cfg.lm_head_bias)
    return out


def phase_gptj_6b(smi: str):
    """(K1) GPT-J-6B at full width and depth (GPTJ_6B_HF: 28 layers, hidden
    4096, 16 heads of 256, the interleaved rope over 64 of them, vocab 50400,
    the head's bias): a state dict of random bf16 made on the card in GPT-J's
    own keys (about 12.1 GB), converted there by load_family_float (seconds
    and peak GiB printed), then LLMEngine with n-gram (k = 3) against its
    null oracle on float_prompts: tokens equal, only the attention launched
    (no norm kernel: LayerNorm is torch ops), every launch the D=256
    instantiation, 28 a forward."""
    from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, SchedulerConfig,
                                 SpeculativeConfig)
    from qspec_tpu_torch.model_loader.families import load_family_float
    from qspec_tpu_torch.models.registry import resolve
    cfg = resolve(GPTJ_6B_HF)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sd = random_state_dict(k_entries(cfg), seed=100)
    n_bytes = sum(t.numel() * 2 for t in sd.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, cfg = load_family_float(sd, cfg)
    torch.cuda.synchronize()
    secs, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2 ** 30
    if sd:
        raise AssertionError(f"(K1) load_family_float left {sorted(sd)[:4]} unconverted")
    if params["rope_cache"].shape[-1] != 32 or params["lm_head_b"].shape != (cfg.vocab_size,):
        raise AssertionError("(K1) gpt-j-6b: the rope cache or the head bias is not GPT-J's")
    log(f"load (K1) gpt-j-6b: {n_bytes / 1e9:.2f} GB bf16 in GPT-J's keys, converted by "
        f"load_family_float on the card in {secs:.2f} s, peak {peak:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    prompts = float_prompts(cfg.vocab_size)

    def make(method, p):
        spec = SpeculativeConfig(num_speculative_tokens=3, method=method)
        return LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=128, num_pages=80),
                                      scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=512),
                                      speculative=spec), p or params, device="cuda", seed=0)
    label = f"(K1) gpt-j-6b bf16 ({cfg.num_layers} layers, head bias, bf16 KV, n-gram k=3)"
    spec, launches, summary = float_run(label, make, cfg, prompts, every=("d256",))
    summary.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, load_s=secs,
                   load_peak_gib=peak)
    e2e_log(label, prompts, spec, summary)
    log(f"e2e (K1) gpt-j-6b, {cfg.num_layers} layers: n-gram == null, acceptance "
        f"{summary['acceptance_rate']:.5g}, {summary['spec_tokens_per_s']:.5g} / "
        f"{summary['oracle_tokens_per_s']:.5g} tok/s (host clock), attention "
        f"{launches['paged_attention']} = {cfg.num_layers} x {summary['forwards']} forwards, all "
        "D=256; "
        f"load {secs:.2f} s, peak {peak:.2f} GiB")
    log(f"e2e (K1): card {smi}", stdout=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary


def phase_k_dirs(smi: str):
    """(K2) LLM(model=<dir>, quantization=None) on Pythia-6.9B, GPT-NeoX-20B
    (D=96), Phi-2 (the head bias, D=80), StableLM-2-1.6B (the qkv bias,
    D=64), Command-R v01 (the tied head, logit_scale), GLM-4-9B (the gptj
    rope over half of each head, group 16, the gamma norm) and Helium
    directories (K_DIRS at K_LAYERS layers, random bf16 in the family's own
    keys written here): n-gram (k = 3) == its null oracle, only the
    attention (and the gamma norm of the RMSNorm families) launched, the
    attention K_LAYERS a forward. First, each of K_REFUSALS raises
    NotImplementedError naming ROADMAP queue 1 item 9 from a directory
    holding only its config.json."""
    import tempfile
    from qspec_tpu_torch import LLM
    from qspec_tpu_torch.models.registry import resolve
    for what, base, over in K_REFUSALS:
        with tempfile.TemporaryDirectory() as d:
            write_config(d, {**K_DIRS[base], **over, "num_hidden_layers": K_LAYERS})
            try:
                LLM(model=d, quantization=None, device="cuda")
            except NotImplementedError as e:
                if "queue 1 item 9" not in str(e):
                    raise
            else:
                raise AssertionError(f"(K2) {what}: not refused")
    out = {}
    for i, (name, published) in enumerate(K_DIRS.items()):
        hf = {**published, "num_hidden_layers": K_LAYERS}
        cfg = resolve(hf)
        held = {}
        with tempfile.TemporaryDirectory() as d:
            sd = random_state_dict(k_entries(cfg), seed=110 + i)
            write_safetensors(os.path.join(d, "model.safetensors"), sd)
            del sd
            write_config(d, hf)
            out[name] = float_dir_run(f"(K2) {name} dir, {K_LAYERS} layers, bf16, n-gram k=3",
                                      d, cfg, held)
        lcfg, lp = held["cfg"], held["params"]
        if (lcfg.rotary_dim, lcfg.rope_style, lcfg.quant) != (cfg.rotary_dim, cfg.rope_style,
                                                              "none") or \
                lp["rope_cache"].shape[-1] != cfg.rope_dim // 2 or \
                ("lm_head_b" in lp) != cfg.lm_head_bias:
            raise AssertionError(f"(K2) {name}: loaded as {lcfg}")
        del held, lp
        gc.collect()
        torch.cuda.empty_cache()
    log("e2e (K2) LLM(model=<dir>, quantization=None), published widths at 2 layers, n-gram == "
        "null: " + ", ".join(
            f"{n} {r[1]['acceptance_rate']:.3f} (load {r[1]['load_s']:.1f} s)"
            for n, r in out.items()) + f"; {len(K_REFUSALS)} refusals raise before a weight "
        "is read", stdout=False)
    log(f"e2e (K2): card {smi}", stdout=False)
    return out


# ----------------------------------- (M) compressed-tensors and GGUF checkpoints

# Llama-3-8B's four trunk projections (qkv, o, gate_up, down) as the W8A16
# trunk runs them, K x N
W8_TRUNK = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))
W8_TRUNK_NAMES = ("qkv", "o", "gate_up", "down")
# the kernels of a compressed-tensors int8 Llama (W8A16 trunk and int8 head);
# an fp8 checkpoint's trunk launches the fp8 instantiation, counted apart
CT_KERNELS = {"matmul_w8a16", "rmsnorm", "paged_attention"}
CT_FP8_KERNELS = CT_KERNELS | {"matmul_w8a16_fp8"}
M_WINDOW = 64
# (M3)'s loaders of induction_lm_v2
M3_LOADERS = ("ct-int8", "ct-fp8", "ct-packed-g128", "gguf-q4_0")
# (M3) on the CPU (tests/test_torch_ct_induction.py), same prompts and
# settings: per loader, drafted / accepted / emitted of QSpec (windowed
# W4A16 draft, k = 3) and of EAGLE (induction_eagle_v1, k = 4), and where
# each prompt's greedy tokens first leave its segment's copy (-1: never)
M3_CPU = {
    "ct-int8": {"qspec": [102, 90, 124], "eagle": [480, 4, 124], "copy_breaks": [-1, -1, 11, -1]},
    "ct-fp8": {"qspec": [102, 90, 124], "eagle": [480, 4, 124], "copy_breaks": [-1, -1, 11, -1]},
    "ct-packed-g128": {"qspec": [102, 90, 124], "eagle": [476, 5, 124],
                       "copy_breaks": [-1, -1, 11, -1]},
    "gguf-q4_0": {"qspec": [99, 91, 124], "eagle": [480, 4, 124],
                  "copy_breaks": [-1, -1, 11, -1]}}
EAGLE_NET = INDUCTION[:-len("induction_lm_v2")] + "induction_eagle_v1.npz"


def _w8_trunk_weights(gen, k, n, kind, layers=None):
    """Per-channel byte weights [K, N] (or [L, K, N]) and scales made on the
    card by the compressed-tensors writers: int8 or float8_e4m3fn."""
    from qspec_tpu_torch.model_loader import ct
    make = ct.make_ct_fp8_tensors if kind == "fp8" else ct.make_ct_int8_tensors
    ws, ss = [], []
    for _ in range(layers or 1):
        t, _ = make(torch.randn(k, n, generator=gen, device="cuda") * 0.02)
        ws.append(t["weight"].t().contiguous())
        ss.append(t["weight_scale"].reshape(-1).contiguous())
    if layers is None:
        return ws[0], ss[0]
    return torch.stack(ws), torch.stack(ss)


def check_w8a16_trunk(gen, report):
    """matmul_w8a16 over int8 and float8_e4m3fn weights against the plain
    version at Llama-3-8B's four trunk shapes (a 2-layer stack read in
    place, M = 4, 16, 60 and 64, bf16 and f32 out) and the fp8
    instantiation at the head's (M = 16, f32 out); all 256 e4m3 codes
    decoded (NaN codes give NaN); a row's bits independent of M (1 to the
    prefill threshold, 176 at K = 14336) and of its place; the torch.mm
    branch past BIGM_BYTES (M = 1024 at K = 4096, 256 at 14336) against the
    plain version, no kernel launched."""
    from qspec_tpu_torch.ops import linear_kernels as lk
    errs = {"int8": 0.0, "fp8": 0.0}
    for kind in ("int8", "fp8"):
        for k, n in W8_TRUNK:
            qw, qs = _w8_trunk_weights(gen, k, n, kind, layers=2)
            for m in (4, 16, 60, 64):
                x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
                for li in (0, 1):
                    for dt in (torch.float32, torch.bfloat16):
                        out = lk.matmul_w8a16(x, qw, qs, out_dtype=dt, layer_idx=li).float()
                        ref = lk.matmul_w8a16_ref(x, qw[li], qs[li], out_dtype=dt).float()
                        torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
                        errs[kind] = max(errs[kind], (out - ref).abs().max().item())
            del qw, qs
    m, k, n = HEAD_SHAPE
    qw, qs = _w8_trunk_weights(gen, k, n, "fp8")
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    out = lk.matmul_w8a16(x, qw, qs, out_dtype=torch.float32)
    ref = lk.matmul_w8a16_ref(x, qw, qs, out_dtype=torch.float32)
    torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
    errs["fp8"] = max(errs["fp8"], (out - ref).abs().max().item())
    del qw, qs, out, ref
    # every e4m3 code: x = I picks weight row k, so out[k, n] = bf16(w[k, n]);
    # the NaN codes sit in columns 0..7 only (0 x NaN fills their column)
    K = N = 256
    codes = torch.arange(K, dtype=torch.int32, device="cuda")[:, None].expand(K, N).clone()
    nan_code = (codes == 0x7F) | (codes == 0xFF)
    codes[nan_code & (torch.arange(N, device="cuda")[None, :] >= 8)] = 0
    w = codes.to(torch.uint8).view(torch.float8_e4m3fn)
    out = lk.matmul_w8a16(torch.eye(K, device="cuda").to(torch.bfloat16), w,
                          torch.ones(N, device="cuda"), out_dtype=torch.float32)
    if not (torch.equal(out[:, 8:], w.to(torch.float32)[:, 8:]) and out[:, :8].isnan().all()):
        raise AssertionError("matmul_w8a16 fp8: an e4m3 code decodes wrong")
    # a row's bits across M (split mode to 64 rows, whole mode past them) and
    # place, at the down projection's shape
    k, n = W8_TRUNK[3]
    mbig = _max_kernel_m(k)
    for kind in ("int8", "fp8"):
        qw, qs = _w8_trunk_weights(gen, k, n, kind)
        x = torch.randn(mbig, k, generator=gen, device="cuda").to(torch.bfloat16)
        full = lk.matmul_w8a16(x, qw, qs)
        same = all(torch.equal(lk.matmul_w8a16(x[:mm].contiguous(), qw, qs), full[:mm])
                   for mm in (*range(1, 17), 33, 60, 64, 65, 100))
        if not (same and torch.equal(lk.matmul_w8a16(x.flip(0).contiguous(), qw, qs),
                                     full.flip(0))):
            raise AssertionError(f"matmul_w8a16 {kind}: a row's bits depend on M or place")
    # the torch.mm branch past BIGM_BYTES: no launch, the plain version's result
    err_mm = 0.0
    launched = (lk.matmul_w8a16.launches, lk.matmul_w8a16_fp8.launches)
    for kind in ("int8", "fp8"):
        for (k, n), m in ((W8_TRUNK[1], 1024), (W8_TRUNK[3], 256)):
            qw, qs = _w8_trunk_weights(gen, k, n, kind)
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            out = lk.matmul_w8a16(x, qw, qs, out_dtype=torch.float32)
            ref = lk.matmul_w8a16_ref(x, qw, qs, out_dtype=torch.float32)
            torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
            err_mm = max(err_mm, (out - ref).abs().max().item())
    if (lk.matmul_w8a16.launches, lk.matmul_w8a16_fp8.launches) != launched:
        raise AssertionError("matmul_w8a16 past BIGM_BYTES launched the kernel")
    report["matmul_w8a16"].update(trunk_max_err=errs["int8"], bigm_max_err=err_mm)
    report["matmul_w8a16_fp8"].update(max_err=errs["fp8"], tol="rtol=atol=2e-2")
    log(f"check matmul_w8a16 trunk (8B qkv/o/gate_up/down stacked, M=4,16,60,64; fp8 head): "
        f"max_abs_err int8 {errs['int8']:.3g}, fp8 {errs['fp8']:.3g} (tol 2e-2); 256 e4m3 "
        f"codes exact; row bits independent of M, place; torch.mm branch {err_mm:.3g}")


def time_w8a16_trunk(gen, report):
    """One Llama-3-8B layer's four trunk projections at M = 4 and 16, over
    int8 and fp8 weights: kernel, plain version and, for int8,
    torch._weight_int8pack_mm (weights [N, K], bf16 scales); fp8 has no one
    PyTorch call of bf16 x fp8-weight with per-column scales
    (torch._scaled_mm wants fp8 activations too). Each input set rotated
    past L2; the bound from the bytes (x, weights, scales, out) and
    operations of this call."""
    from qspec_tpu_torch.ops import linear_kernels as lk
    wbytes = sum(k * n + 4 * n for k, n in W8_TRUNK)
    rows = {}
    for kind in ("int8", "fp8"):
        rot = Rotating(lambda: [_w8_trunk_weights(gen, k, n, kind) for k, n in W8_TRUNK],
                       wbytes)
        rot_t = (Rotating(lambda: [(w.t().contiguous(), s.to(torch.bfloat16)) for w, s in
                                   (_w8_trunk_weights(gen, k, n, "int8") for k, n in W8_TRUNK)],
                          wbytes) if kind == "int8" else None)
        for m in (4, 16):
            xs = [torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
                  for k, _ in W8_TRUNK]
            per, t_down = [], None
            tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0 if rot_t else None}
            for i, (k, n) in enumerate(W8_TRUNK):
                def kern(i=i):
                    w, s = rot.next()[i]
                    lk.matmul_w8a16(xs[i], w, s)

                def plain(i=i):
                    w, s = rot.next()[i]
                    lk.matmul_w8a16_ref(xs[i], w, s)

                def library(i=i):
                    w, s = rot_t.next()[i]
                    torch._weight_int8pack_mm(xs[i], w, s)
                t_k, t_p = graph_ms(kern), graph_ms(plain, reps=3)
                tot["ms"] += t_k
                tot["plain_ms"] += t_p
                t_l = graph_ms(library) if rot_t else None
                if rot_t:
                    tot["library_ms"] += t_l
                per.append(f"{W8_TRUNK_NAMES[i]} {t_k:.4f}")
                if W8_TRUNK_NAMES[i] == "down":
                    b_d = bound_ms(m * k * 2 + k * n + 4 * n + m * n * 2, 2 * m * k * n, "bf16")
                    t_down = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_d[0],
                              "bound_by": b_d[1]}
            nbytes = sum(m * k * 2 + k * n + 4 * n + m * n * 2 for k, n in W8_TRUNK)
            b, kind_b = bound_ms(nbytes, sum(2 * m * k * n for k, n in W8_TRUNK), "bf16")
            r = {**tot, "bound_ms": b, "bound_by": kind_b,
                 "gb_per_s": nbytes / (tot["ms"] * 1e-3) / 1e9,
                 "per_projection_ms": per, "down": t_down}
            rows[(kind, m)] = r
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            log(f"time matmul_w8a16 {kind} trunk, one Llama-3-8B layer M={m} ({', '.join(per)} "
                f"ms; down alone bound {t_down['bound_ms']:.4f}, "
                f"{lk.w8_workers(*W8_TRUNK[3], sms)} runs on {sms} SMs): "
                f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f}"
                + (f", _weight_int8pack_mm {tot['library_ms']:.4f}" if rot_t else
                   ", library none") + f", bound {b:.4f} ({kind_b}), "
                f"{r['gb_per_s']:.0f} GB/s", stdout=False)
        del rot, rot_t
        torch.cuda.empty_cache()
    log("time matmul_w8a16 trunk, one 8B layer, M=4 / 16 ms: " + "; ".join(
        f"{kind} {rows[(kind, 4)]['ms']:.4f} / {rows[(kind, 16)]['ms']:.4f}"
        + (f" (_weight_int8pack_mm {rows[(kind, 4)]['library_ms']:.3f} / "
           f"{rows[(kind, 16)]['library_ms']:.3f})" if kind == "int8" else " (library none)")
        for kind in ("int8", "fp8"))
        + f"; bound {rows[('fp8', 4)]['bound_ms']:.4f} / {rows[('fp8', 16)]['bound_ms']:.4f}")
    shape = "one Llama-3-8B layer's qkv+o+gate_up+down, M=16, bf16 out"
    report["matmul_w8a16_fp8"].update(
        {f: rows[("fp8", 16)][f] for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                                            "bound_by")},
        shape=shape, m4={f: rows[("fp8", 4)][f] for f in ("ms", "plain_ms", "bound_ms")},
        down={f"m{m}": rows[("fp8", m)]["down"] for m in (4, 16)})
    report["matmul_w8a16"]["trunk"] = {
        f"m{m}": {f: rows[("int8", m)][f] for f in ("ms", "plain_ms", "library_ms",
                                                    "bound_ms", "bound_by", "down")}
        for m in (4, 16)}


def time_w4a16_g32(gen, report, int4pack_missing):
    """The grouped GEMM at group 32 (GGUF Q4_0's, phase (M4)'s trunk) per
    Llama-3-8B layer at M = 4 and 16, beside torch._weight_int4pack_mm at
    the same group size (to the log: the standard output has the g = 128
    rows)."""
    library = int4pack_missing is None
    rows = {}
    for m in (4, 16):
        r = _time_w4g_layer(gen, GEMM_SHAPES, m, library, group=32)
        per = r.pop("per")
        r.pop("nbytes")
        rows[f"m{m}"] = r
        log(f"time matmul_w4a16_g llama3-8b M={m} g=32, one layer: {r['ms']:.4f} ms (per "
            f"projection {', '.join(per)}), plain {r['plain_ms']:.4f}, library "
            + (f"{r['library_ms']:.4f}" if library else "none")
            + f", bound {r['bound_ms']:.4f} ms", stdout=False)
    report["matmul_w4a16_g"]["g32"] = rows


def w8_tally(eng) -> dict:
    """Wrap ``eng.runner.run_spec_rounds``: the rounds' target (verify) and
    draft forwards, whose rows always take the W8A16 kernel (the prompt
    forwards' rectangles take the torch product past BIGM_BYTES)."""
    runner, inner = eng.runner, eng.runner.run_spec_rounds
    tally = {"forwards": 0}

    def run(*a, **kw):
        before = runner.target_forwards + runner.draft_forwards
        out = inner(*a, **kw)
        tally["forwards"] += runner.target_forwards + runner.draft_forwards - before
        return out
    runner.run_spec_rounds = run
    return tally


def phase_ct_8b(smi: str):
    """(M1) Llama-3-8B at full width and depth as a compressed-tensors
    int-quantized checkpoint (per-channel int8, made on the card by
    make_ct_state_dict from normal(0.02) weights, loaded by
    load_compressed_tensors), QSpec with the W4A16 draft (a) under
    draft_kv_window=64 on its ring pool and (b) with no window, each ==
    qspec_null, exactly CT_KERNELS launched (trunk and head int8), (b)
    accepting more than half its drafts (its draft is the target's
    arithmetic); (M2) the same checkpoint as float-quantized fp8, run (a):
    == qspec_null, exactly CT_FP8_KERNELS, the peak memory printed. The
    launches are counted exactly: the trunk 4 L a forward of the rounds
    (w8_tally; the prompt forwards take the torch product), on the fp8
    counter for (M2), and the int8 head 1 a forward of either model."""
    from qspec_tpu_torch.config import ModelConfig
    from qspec_tpu_torch.model_loader.ct import load_compressed_tensors, make_ct_state_dict
    base = ModelConfig.llama3_8b(quant="w8")
    L = base.num_layers
    prompts = e2e_prompts()
    out = {}
    for fmt, runs in (("int-quantized", (("M1a", M_WINDOW), ("M1b", None))),
                      ("float-quantized", (("M2a", M_WINDOW),))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sd = make_ct_state_dict(base, fmt, seed=0, device="cuda")
        params, cfg = load_compressed_tensors(sd, base, device="cuda")
        del sd
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        w8 = params["layers"]["qkv"]["w8"]
        log(f"load (M) llama3-8b compressed-tensors {fmt}: {L} layers, trunk {w8.dtype}, made "
            f"and loaded on the card in {secs:.1f} s, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
            stdout=False)
        fp8 = fmt == "float-quantized"
        for key, window in runs:
            label = (f"({key}) llama3-8b compressed-tensors {'fp8' if fp8 else 'int8'} W8A16 "
                     f"(int8 head, bf16 KV, w4a16 draft, "
                     + (f"window {window}, ring pool)" if window else "no window)"))
            tally = []
            engine = qspec_engine(cfg, params, draft_scheme="w4a16", draft_kv_window=window)

            def make(method, p, engine=engine, tally=tally):
                eng = engine(method, p)
                tally.append(w8_tally(eng))
                return eng
            spec, launches, opts, summary = spec_vs_oracle(
                make, label, CT_FP8_KERNELS if fp8 else CT_KERNELS, prompts, 32)
            summary.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                           load_s=secs)
            e2e_log(label, prompts, spec, summary)
            if (opts["paged_attention"]["window"] > 0) != bool(window):
                raise AssertionError(f"{label}: {opts['paged_attention']['window']} windowed "
                                     "attention launches")
            fw = summary["target_forwards"] + summary["draft_forwards"]
            trunk = 4 * L * tally[0]["forwards"]
            want = ({"matmul_w8a16": fw, "matmul_w8a16_fp8": trunk} if fp8 else
                    {"matmul_w8a16": fw + trunk, "matmul_w8a16_fp8": 0})
            got = {n: launches[n] for n in want}
            if got != want:
                raise AssertionError(f"{label}: launches {got}, expected {want} (4 x {L} "
                                     f"trunk a forward of the rounds' {tally[0]['forwards']}, "
                                     f"the head 1 a forward of {fw})")
            summary["round_forwards"] = tally[0]["forwards"]
            out[key] = (launches, opts, summary)
        # the engine factories hold the parameters too
        del params, w8, engine, make
    acc_b = out["M1b"][2]["acceptance_rate"]
    if acc_b <= 0.5:
        raise AssertionError(f"(M1b) compressed-tensors int8, no window: acceptance {acc_b} "
                             "<= 0.5")
    log("e2e (M1) llama3-8b ct int8, 32 layers, == qspec_null: (a) window 64 "
        f"{out['M1a'][2]['spec_tokens_per_s']:.1f} tok/s, accept "
        f"{out['M1a'][2]['acceptance_rate']:.3f}; (b) {out['M1b'][2]['spec_tokens_per_s']:.1f}, "
        f"accept {acc_b:.3f}; (M2) fp8 (a) {out['M2a'][2]['spec_tokens_per_s']:.1f}, head / "
        f"trunk launches {out['M2a'][0]['matmul_w8a16']} / "
        f"{out['M2a'][0]['matmul_w8a16_fp8']}, peak {out['M2a'][2]['peak_mem_gib']:.2f} GiB")
    log(f"e2e (M1)/(M2): card {smi}", stdout=False)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _induction_cfg(device):
    """induction_lm_v2's ModelConfig and float state dict (tensors on
    ``device``)."""
    from qspec_tpu_torch.config import ModelConfig
    with open(INDUCTION + ".json") as f:
        meta = json.load(f)["cfg"]
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in meta.items() if k in names})
    with np.load(INDUCTION + ".npz") as z:
        sd = {k: torch.as_tensor(z[k]).to(device) for k in z.files}
    return cfg, sd


def gguf_permute(w: torch.Tensor, heads: int) -> torch.Tensor:
    """llama.cpp's convert_hf_to_gguf permute of q / k rows (HF -> gguf)."""
    return (w.reshape(heads, 2, w.shape[0] // heads // 2, *w.shape[1:])
            .transpose(1, 2).reshape(w.shape))


def write_llama_gguf(path: str, cfg, sd: dict, embed_type: str = "F32") -> None:
    """A GGUF file of a Hugging Face-named Llama state dict (tensors on any
    device) by the port's writers, as llama.cpp's converter lays it out:
    q / k rows permuted, every trunk projection Q4_0 (model_loader.gguf's
    torch quantize_q4_0, on the tensors' device), token_embd and output in
    ``embed_type`` ("F32" or "F16"), the norms F32."""
    from qspec_tpu_torch.model_loader import gguf as tg
    blk = {v: k for k, v in tg._BLK_MAP.items()}
    top = {v: k for k, v in tg._NAME_MAP.items()}
    flt = {"F32": (tg.GGML_F32, torch.float32), "F16": (tg.GGML_F16, torch.float16)}
    tensors = {}
    for name, w in sd.items():
        ne = list(reversed(w.shape))
        if name in top:
            ty, dt = flt["F32" if w.dim() == 1 else embed_type]
            tensors[top[name]] = (ty, w.to(dt).cpu().numpy(), ne)
            continue
        li, rest = name[len("model.layers."):].split(".", 1)
        if w.dim() == 1:
            tensors[f"blk.{li}.{blk[rest]}"] = (tg.GGML_F32, w.float().cpu().numpy(), ne)
            continue
        heads = (cfg.num_heads if "q_proj" in rest else cfg.num_kv_heads
                 if "k_proj" in rest else None)
        w = gguf_permute(w, heads) if heads else w
        tensors[f"blk.{li}.{blk[rest]}"] = (tg.GGML_Q4_0, tg.quantize_q4_0(w), ne)
    meta = {"general.architecture": "llama", "llama.embedding_length": cfg.hidden_size,
            "llama.block_count": cfg.num_layers, "llama.attention.head_count": cfg.num_heads,
            "llama.attention.head_count_kv": cfg.num_kv_heads,
            "llama.feed_forward_length": cfg.intermediate_size,
            "llama.context_length": cfg.max_position_embeddings,
            "llama.rope.freq_base": float(cfg.rope_theta),
            "llama.attention.layer_norm_rms_epsilon": float(cfg.rms_norm_eps)}
    tg.write_gguf(path, meta, tensors)


def m3_params(loader: str, device: str):
    """induction_lm_v2 through one of M3_LOADERS, on ``device``, with the
    trained induction_eagle_v1 net: ct-int8 / ct-fp8 / ct-packed-g128 (the
    port's compressed-tensors writers, then load_compressed_tensors), or
    gguf-q4_0 (write_llama_gguf into a temporary directory, then
    load_gguf). -> (params, cfg)."""
    import tempfile
    from qspec_tpu_torch.model_loader import ct
    from qspec_tpu_torch.model_loader.gguf import load_gguf
    from qspec_tpu_torch.spec_decode.eagle import load_eagle
    cfg, sd = _induction_cfg(device)
    if loader == "gguf-q4_0":
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "induction_lm_v2.Q4_0.gguf")
            write_llama_gguf(path, cfg, sd)
            params, cfg = load_gguf(path, device=device)
    else:
        fmt, kw = {"ct-int8": ("int-quantized", {}), "ct-fp8": ("float-quantized", {}),
                   "ct-packed-g128": ("pack-quantized", {"group_size": 128})}[loader]
        qsd = {}
        for name, w in sd.items():
            if name.endswith("proj.weight"):
                base = name[:-len(".weight")]
                for key, val in ct.WRITERS[fmt](w.t().float(), **kw)[0].items():
                    qsd[f"{base}.{key}"] = val
            else:
                qsd[name] = w
        params, cfg = ct.load_compressed_tensors(qsd, cfg, device=device)
    params["eagle"] = load_eagle(EAGLE_NET, cfg, device=device)
    return params, cfg


def m3_engine(cfg, params, method: str, device: str):
    """(M3)'s engines: "qspec" / "qspec_null" with the windowed W4A16 draft
    (window 64, k = 3), "eagle" (k = 4, 2 rounds a step, the trained-pair
    card test's settings), "ar" without speculation."""
    from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, SchedulerConfig,
                                 SpeculativeConfig)
    spec = (None if method == "ar" else
            SpeculativeConfig(num_speculative_tokens=4, method="eagle", rounds_per_step=2)
            if method == "eagle" else
            SpeculativeConfig(num_speculative_tokens=3, method=method, draft_scheme="w4a16",
                              draft_kv_window=M_WINDOW))
    sched = SchedulerConfig(max_num_seqs=4, max_model_len=512, prefill_chunk_size=128,
                            decode_batch_buckets=(4,), prefill_token_buckets=(128,))
    return LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16), scheduler=sched,
                                  speculative=spec), params, device=device, seed=0)


def m3_prompts(vocab: int):
    return induction_prompts(4, 128, vocab, seed=13)


def copy_breaks(prompts, toks) -> list:
    """Per prompt, the first generated position where the tokens leave the
    prompt's periodic copy (-1: never): where a card run and a CPU run
    part shows here."""
    out = []
    for p, t in zip(prompts, toks):
        period = next(q for q in range(16, 65) if p[q:] == p[:-q])
        want = [p[(len(p) + i) % period] for i in range(len(t))]
        out.append(next((i for i, (a, b) in enumerate(zip(t, want)) if a != b), -1))
    return out


# the kernels of each (M3) loader's path: its trunk GEMM, the gamma norm and
# the bf16 attention; the GGUF file's int8 head (the ct loaders keep
# induction_lm_v2's bf16 head, a torch product)
M3_KERNELS = {"ct-int8": {"matmul_w8a16"}, "ct-fp8": {"matmul_w8a16_fp8"},
              "ct-packed-g128": {"matmul_w4a16_g"},
              "gguf-q4_0": {"matmul_w4a16_g", "matmul_w8a16"}}


def phase_ct_induction(smi: str):
    """(M3) induction_lm_v2 through the four loaders of M3_LOADERS, each
    with greedy QSpec (windowed W4A16 draft, k = 3) == qspec_null and EAGLE
    (induction_eagle_v1, k = 4) == AR, exactly its loader's kernels; the
    drafted / accepted / emitted counts and the copy breaks printed beside
    the CPU's (M3_CPU). No acceptance floor: the EAGLE net was trained on
    the QuaRot basis, which these checkpoints lack."""
    out, lines = {}, []
    for loader in M3_LOADERS:
        params, cfg = m3_params(loader, "cuda")
        prompts = m3_prompts(cfg.vocab_size)
        expect = M3_KERNELS[loader] | {"rmsnorm", "paged_attention"}
        got = {}
        for method, oracle in (("qspec", "qspec_null"), ("eagle", "ar")):
            label = f"(M3) induction_lm_v2 {loader} {method}"
            toks, launches, _, summary = spec_vs_oracle(
                lambda m, p: m3_engine(cfg, p or params, m, "cuda"), label, expect, prompts,
                32, methods=(method, oracle))
            e2e_log(label, prompts, toks, summary)
            got[method] = summary["drafted_accepted_emitted"]
            out[f"{loader}_{method}"] = (launches, summary)
        got["copy_breaks"] = copy_breaks(prompts, toks)
        cpu = M3_CPU.get(loader, {})
        lines.append(f"{loader} " + ", ".join(
            "/".join(map(str, v)) + ("" if cpu.get(k) == v else
                                     f" (CPU {'/'.join(map(str, cpu.get(k, [])))})")
            for k, v in got.items()))
        del params
        torch.cuda.empty_cache()
    log("e2e (M3) induction_lm_v2 drafted/accepted/emitted of QSpec (w4a16, window 64, "
        "k=3), EAGLE (k=4), and copy breaks, each == its oracle, == the CPU's unless "
        "bracketed: " + "; ".join(lines), stdout=False)
    log(f"e2e (M3): card {smi}", stdout=False)
    return out


def phase_ct_dirs(smi: str):
    """(M4) at Llama-3-8B's widths cut to 2 layers: (a) a GGUF Q4_0 file
    (the port's writers: trunk Q4_0 at g = 32 quantized on the card,
    token_embd and output F16) read by load_gguf onto the grouped-int4 path,
    QSpec (windowed W4A16 draft) == qspec_null, exactly W4G_KERNELS, every
    trunk weight at group 32; (b) a compressed-tensors directory
    (config.json with its quantization_config, model.safetensors holding
    F8_E4M3 weights) through LLM(model=<dir>): its tensors load bit for bit
    to the state-dict route's, its QSpec == qspec_null, and its replies ==
    LLM(model=<dir>, params=<the state-dict route's>)."""
    import tempfile
    from qspec_tpu_torch import LLM
    from qspec_tpu_torch.config import LLAMA3_8B_HF
    from qspec_tpu_torch.model_loader.ct import load_compressed_tensors, make_ct_state_dict
    from qspec_tpu_torch.model_loader.gguf import load_gguf
    from qspec_tpu_torch.model_loader.grouped import random_state_dict
    from qspec_tpu_torch.models.registry import resolve
    hf = {**LLAMA3_8B_HF, "num_hidden_layers": 2}
    cfg2 = resolve(hf)
    prompts = e2e_prompts()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        sd = random_state_dict(cfg2, lambda w: {"weight": w.t().contiguous()}, seed=31,
                               device="cuda")
        path = os.path.join(d, "llama3-8b-2l.Q4_0.gguf")
        write_llama_gguf(path, cfg2, sd, embed_type="F16")
        del sd
        t_w = time.perf_counter() - t0
        t0 = time.perf_counter()
        params, cfg = load_gguf(path, device="cuda")
        torch.cuda.synchronize()
        t_r = time.perf_counter() - t0
        groups = {n: params["layers"][n]["qs_g"].shape[1] for n in ("qkv", "o", "gate_up", "down")}
        want = {"qkv": 4096 // 32, "o": 4096 // 32, "gate_up": 4096 // 32, "down": 14336 // 32}
        if cfg.quant != "w4g" or groups != want:
            raise AssertionError(f"(M4a) GGUF Q4_0: quant {cfg.quant}, groups {groups}")
        label = "(M4a) llama3-8b 2 layers GGUF Q4_0 (g=32, int8 head, w4a16 draft, window 64)"
        spec, launches, _, summary = spec_vs_oracle(
            qspec_engine(cfg, params, draft_scheme="w4a16", draft_kv_window=M_WINDOW), label,
            W4G_KERNELS, prompts, 32)
        summary.update(write_s=t_w, load_s=t_r, file_gb=os.path.getsize(path) / 1e9)
        e2e_log(label, prompts, spec, summary)
        out["M4a"] = (launches, summary)
        os.remove(path)
        del params
        torch.cuda.empty_cache()

        ctdir = os.path.join(d, "ct")
        os.makedirs(ctdir)
        cfg_ct = dataclasses.replace(cfg2, quant="w8")
        sd = make_ct_state_dict(cfg_ct, "float-quantized", seed=32, device="cuda")
        write_config(ctdir, {**hf, "quantization_config": {
            "quant_method": "compressed-tensors", "format": "float-quantized",
            "config_groups": {"group_0": {"targets": ["Linear"], "weights": {
                "num_bits": 8, "type": "float", "strategy": "channel", "symmetric": True}}},
            "ignore": ["lm_head"]}})
        t0 = time.perf_counter()
        write_safetensors(os.path.join(ctdir, "model.safetensors"), sd)
        t_w = time.perf_counter() - t0
        own, _ = load_compressed_tensors(sd, cfg_ct, device="cuda")
        del sd
        kw = dict(device="cuda", num_speculative_tokens=3, speculative_draft_scheme="w4a16",
                  spec_draft_kv_window=M_WINDOW, max_model_len=512, max_num_seqs=4,
                  block_size=128, seed=0)
        held = {}

        def make(m, p):
            t0 = time.perf_counter()
            llm = LLM(model=ctdir, params=p, speculative_method=m, **kw)
            if p is None:
                held.update(params=llm.llm_engine.runner.params, load_s=time.perf_counter() - t0,
                            quant=llm.engine_config.model.quant)
            return llm.llm_engine
        label = "(M4b) llama3-8b 2 layers compressed-tensors fp8 dir, LLM(model=<dir>)"
        spec, launches, _, summary = spec_vs_oracle(make, label, CT_FP8_KERNELS, prompts, 32)
        summary.update(write_s=t_w, load_s=held["load_s"])
        e2e_log(label, prompts, spec, summary)

        def raw(t):
            return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
        if held["quant"] != "w8" or not all(
                torch.equal(raw(held["params"]["layers"][n][k]), raw(own["layers"][n][k]))
                for n in ("qkv", "o", "gate_up", "down") for k in ("w8", "s8")):
            raise AssertionError("(M4b) the directory's tensors differ from the state dict's")
        del held
        sd_route = generate(LLM(model=ctdir, params=own, **kw).llm_engine, prompts, 32)
        if sd_route != spec:
            raise AssertionError("(M4b) LLM(model=<dir>) replies differ from the state-dict "
                                 "route's")
        out["M4b"] = (launches, summary)
        del own
    log(f"e2e (M4) 8B widths, 2 layers, == qspec_null: (a) GGUF Q4_0 g=32, "
        f"{out['M4a'][1]['file_gb']:.2f} GB written {out['M4a'][1]['write_s']:.1f} s, loaded "
        f"{out['M4a'][1]['load_s']:.1f} s; (b) ct fp8 dir, LLM(model=<dir>) "
        f"{out['M4b'][1]['load_s']:.1f} s, tensors and replies == the state-dict route's")
    log(f"e2e (M4): card {smi}", stdout=False)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ----------------------------------- (N) multi-head latent attention (MLA)

# the latent attention shapes (N) brings: (label, query heads over one
# latent KV row, stored head dim, K lanes r + dr, V lanes r, qk_nope +
# qk_rope): MiniCPM3-4B, DeepSeek-V2-Lite and DeepSeek-V2 / V3
MLA_ATTN = (("minicpm3-4b", 40, 384, 288, 256, 96),
            ("deepseek-v2-lite", 16, 640, 576, 512, 192),
            ("deepseek-v3", 128, 640, 576, 512, 192))
MLA_TOL = {"bfloat16": 3e-2, **KV8_TOL}
# the long-context verify's tokens a sequence (time_mla_shapes, --ab): there
# the bound is more than launch cost (DeepSeek-V3's operations, the other
# groups' bytes)
MLA_LONG = 4096
# the gamma rmsnorm's widths in (N): the hidden sizes of MiniCPM3-4B,
# DeepSeek-V2-Lite and DeepSeek-V3, each also after the residual add, and
# the latents' (q-LoRA's 768 and 1536, c_kv's 256 and 512: no residual)
MLA_NORM_H = (2560, 2048, 7168)
MLA_LATENT_H = (768, 1536, 256, 512)
N2_LAYERS = 4         # DeepSeek-V2-Lite's dense first layer and 3 of its 26 MoE layers
N3_LAYERS = 2


def _attn_name(kv_dtype: str) -> str:
    return "paged_attention" if kv_dtype == "bfloat16" else f"paged_attention_{kv_dtype}"


def _mla_inputs(gen, q_len, kv_dtype, Hq, D, dk, dv, B=4, S=128, ctx=None):
    """A latent cache of ``kv_dtype`` as MLA writes it (update_layer of one
    KV head a token: K rows [c, 0...] over the K lanes, V rows [c[:dv],
    0...]) under ``ctx`` (B contexts; _ctx_lens' by default), pages
    shuffled; q over the K lanes, zero past them."""
    from qspec_tpu_torch.ops import kv_cache as kvc
    ctx = list(ctx or _ctx_lens(q_len, S))
    pages = [-(-c // S) for c in ctx]
    P = 1 + sum(pages)
    cache = kvc.allocate(kvc.KVCacheConfig(2, 1, D, P, S, kv_dtype), "cuda")
    T = (P - 1) * S
    lat = torch.randn(T, 1, dk, generator=gen, device="cuda")
    pad = torch.nn.functional.pad
    kvc.update_layer(cache, 1, pad(lat, (0, D - dk)).to(torch.bfloat16),
                     pad(lat[..., :dv], (0, D - dv)).to(torch.bfloat16),
                     torch.arange(T, device="cuda") + S)
    ids = torch.randperm(P - 1, generator=torch.Generator().manual_seed(q_len)) + 1
    tables = torch.zeros(B, max(pages), dtype=torch.int32)
    o = 0
    for b, n in enumerate(pages):
        tables[b, :n] = ids[o:o + n]
        o += n
    q = pad(torch.randn(B, q_len, Hq, dk, generator=gen, device="cuda"), (0, D - dk))
    return (q.to(torch.bfloat16), cache, tables.cuda(),
            torch.tensor(ctx, dtype=torch.int32, device="cuda"))


def _mla_call(inputs, dqk, dk, dv, plain=False):
    """The latent attention as _mla_attention calls it (the kernel over K's
    first dk lanes and V's first dv), or its plain version on the same
    inputs."""
    from qspec_tpu_torch.ops.attention import paged_attention_ref
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    q, cache, tables, ctx = inputs
    if plain:
        return paged_attention_ref(q, cache, 1, tables, ctx, dqk ** -0.5, lanes=(dk, dv))
    return paged_attention_cuda(q, cache.kv_pages, tables, ctx, dqk ** -0.5, layer=1,
                                kv_scales=cache.kv_scales, lanes=(dk, dv))


def check_mla_shapes(gen, report):
    """(N) the MLA instantiations (head dims 384 and 640, each KV entry type)
    at MLA_ATTN's groups over one latent row, B = 4, the verify's contexts,
    decode (Q = 1), the n-gram verify (Q = 4) and a prefill rectangle (Q =
    64), and the verify at MLA_LONG tokens a sequence (B = 4: 32 splits of
    128), against the plain version over the same lanes (MLA_TOL: the other
    entry-type checks' tolerances), the output zero past the V lanes; the
    gamma rmsnorm at MLA_NORM_H (alone and with the residual add, h bit for
    bit the torch add) and MLA_LATENT_H (alone), M = 4 and 16, against its
    plain version (2e-2)."""
    errs = {}
    for kv_dtype in ("bfloat16", *KV8):
        err, tol = 0.0, MLA_TOL[kv_dtype]
        for label, Hq, D, dk, dv, dqk in MLA_ATTN:
            for q_len, ctx in ((1, None), (4, None), (64, None), (4, (MLA_LONG,) * 4)):
                inputs = _mla_inputs(gen, q_len, kv_dtype, Hq, D, dk, dv, ctx=ctx)
                out = _mla_call(inputs, dqk, dk, dv)
                ref = _mla_call(inputs, dqk, dk, dv, plain=True)
                torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
                if torch.count_nonzero(out[..., dv:]):
                    raise AssertionError(f"(N) {label} {kv_dtype} Q={q_len}: output past "
                                         f"the V lanes ({dv}) is not zero")
                err = max(err, (out.float() - ref.float()).abs().max().item())
                del inputs, out, ref
        report[_attn_name(kv_dtype)]["mla_max_err"] = float(f"{err:.3g}")
        errs[kv_dtype] = err
    torch.cuda.empty_cache()
    e_norm = 0.0
    for h in (*MLA_NORM_H, *MLA_LATENT_H):
        g = _gamma(gen, h)
        kern, plain = norm_fn("rmsnorm", None, g), norm_fn("rmsnorm", None, g, True)
        for m in DENSE_M:
            x, r = _norm_set(gen, m, h)
            for res in (None, r) if h in MLA_NORM_H else (None,):
                got, want = kern(x, res), plain(x, res)
                if res is not None and not (torch.equal(got[-1], x + r)
                                            and torch.equal(want[-1], x + r)):
                    raise AssertionError(f"(N) rmsnorm gamma H={h} M={m}: h is not x + r")
                torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2e-2,
                                           atol=2e-2)
                e_norm = max(e_norm, (got[0].float() - want[0].float()).abs().max().item())
    report["rmsnorm"]["mla_max_err"] = float(f"{e_norm:.3g}")
    log("check (N) MLA attention D=384/640, " + "/".join(str(a[1]) for a in MLA_ATTN)
        + f" heads over 1, Q=1,4,64 and Q=4 at {MLA_LONG}, max_abs_err "
        + "/".join(f"{v:.3g}" for v in errs.values())
        + " (bf16/int8/e4m3/e5m2; tol " + "/".join(f"{MLA_TOL[k]:g}" for k in errs)
        + f"), 0 past the V lanes; rmsnorm gamma at {len(MLA_NORM_H + MLA_LATENT_H)} MLA "
        f"widths {e_norm:.3g} (tol 2e-2)")


def mla_bound(Hq, dk, dv, kv_dtype, ctx, pps, q_len=4):
    """The least time the card could take for one latent attention call:
    (bound ms, "bytes" or "operations", the bound with V's lanes counted
    apart). Bytes: each live token's K row (dk lanes) read once, its V lanes
    (dv) apart only over int8 and fp8_e4m3, whose V rows are not K's bits
    (bf16 and fp8_e5m2 store V's lanes as K's first), the per-token scales
    of those two, q's dk lanes and the output's dv, the block table and the
    lengths; operations 2 Hq (dk + dv) a (query row, live token) pair. The
    third number counts V's lanes apart on every type: the bound of a kernel
    that reads the V plane."""
    entry = 2 if kv_dtype == "bfloat16" else 1
    scaled = kv_dtype in ("int8", "fp8_e4m3")
    B = len(ctx)
    seen = sum(sum(c - q_len + i + 1 for i in range(q_len)) for c in ctx)
    ops = 2 * Hq * (dk + dv) * seen
    io = B * q_len * Hq * (dk + dv) * 2 + B * pps * 4 + B * 4

    def rows(v_lanes):
        return sum(ctx) * ((dk + v_lanes) * entry + (8 if scaled else 0))
    b, kind = bound_ms(rows(dv if scaled else 0) + io, ops, "bf16")
    return b, kind, bound_ms(rows(dv) + io, ops, "bf16")[0]


def time_mla_shapes(gen, report):
    """(N) each MLA instantiation at MLA_ATTN's three groups at the n-gram
    verify (B = 4, Q = 4, the verify's contexts 379 / 263 / 512 / 40), and
    the bf16 instantiations also at MLA_LONG tokens a sequence, inputs
    rotated past L2 and made before the graph captures, beside its plain
    version; the bound is mla_bound's (K's lanes once where V's are its
    bits, with V's lanes counted apart beside it). No one PyTorch call
    computes paged attention over a latent cache (library none).
    report[entry]["mla_times"]: label -> [ms, plain_ms, bound_ms,
    library_ms, bound_ms with V apart]."""
    fields = ("ms", "plain_ms", "bound_ms", "library_ms", "bound_v_ms")
    short = []
    for kv_dtype in ("bfloat16", *KV8):
        entry = 2 if kv_dtype == "bfloat16" else 1
        times = report[_attn_name(kv_dtype)].setdefault("mla_times", {})
        for label, Hq, D, dk, dv, dqk in MLA_ATTN:
            for ctx in (_ctx_lens(4), (MLA_LONG,) * 4)[:2 if kv_dtype == "bfloat16" else 1]:
                stored = sum(ctx) * 2 * D * entry
                rot = Rotating(lambda Hq=Hq, D=D, dk=dk, dv=dv, ctx=ctx: _mla_inputs(
                    gen, 4, kv_dtype, Hq, D, dk, dv, ctx=ctx), stored)
                pps = rot.sets[0][2].shape[1]
                b, kind, b_v = mla_bound(Hq, dk, dv, kv_dtype, ctx, pps)
                r = dict(ms=graph_ms(lambda: _mla_call(rot.next(), dqk, dk, dv),
                                     reps=max(20, len(rot.sets))),
                         plain_ms=graph_ms(lambda: _mla_call(rot.next(), dqk, dk, dv, True),
                                           reps=3),
                         bound_ms=b, bound_by=kind, library_ms=None, bound_v_ms=b_v)
                key = label if len(set(ctx)) > 1 else f"{label}_ctx{ctx[0]}"
                times[key] = [float(f"{r[f]:.4g}") if r[f] is not None else None
                              for f in fields]
                log(f"time (N) {_attn_name(kv_dtype)} {key} Hq={Hq} D={D} (K {dk}, V {dv}) "
                    f"B=4 Q=4 ctx={list(ctx)}: " + ", ".join(
                        f"{f} {r[f]:.5f}" for f in ("ms", "plain_ms", "bound_ms"))
                    + f" ({kind}; V apart {b_v:.5f}, {b / r['ms']:.1%} of the bound), "
                    "library none", stdout=False)
                if kv_dtype == "bfloat16":
                    short.append(f"{key} {r['ms']:.4f}/{r['plain_ms']:.4f}/{b:.5f}")
                del rot
                torch.cuda.empty_cache()
    log("time (N) MLA verify B=4 Q=4 bf16 KV, ms kernel/plain/bound (every KV type: "
        "mla_times): " + "; ".join(short), stdout=False)


def time_mla_norms(report):
    """(N) the gamma rmsnorm at the latents' widths (MLA_LATENT_H: q-LoRA's
    768 and 1536, c_kv's 256 and 512) at M = 4 and 16, alone, beside its
    plain version, F.rms_norm and its byte bound (time_norm_shape's fields).
    report["rmsnorm"]["mla_norm_times"]: label -> [ms, plain_ms, bound_ms,
    library_ms]."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = report["rmsnorm"].setdefault("mla_norm_times", {})
    for h in MLA_LATENT_H:
        for m in DENSE_M:
            t = time_norm_shape(gen, "rmsnorm", m, h, None, True)
            rows[norm_label("rmsnorm", m, h, None, True)] = [
                float(f"{t[f]:.4g}") for f in ("ms", "plain_ms", "bound_ms", "library_ms")]
    log("time (N) rmsnorm gamma at the latent widths, ms kernel/plain/bound/F.rms_norm: "
        + json.dumps(rows, separators=(",", ":")), stdout=False)


def mla_entries(cfg):
    """A DeepSeek-V2 / V3 or MiniCPM3 checkpoint's names and shapes (the keys
    convert_deepseek_v2 reads): weights normal(0.02), norm gammas 1 + 0.1
    N(0, 1); q_proj, or q-LoRA's q_a_proj / q_a_layernorm / q_b_proj;
    kv_a_proj_with_mqa (the latent and the rope key), kv_a_layernorm,
    kv_b_proj [heads x (qk_nope + v), r], o_proj; the dense MLP below
    first_k_dense_replace, the routed experts, their router and the shared
    experts above it; the head unless tied."""
    H, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    nh, r, dr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dn, dv, ql = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.q_lora_rank

    def mlp(p, inter):
        return [(p + "gate_proj.weight", (inter, H), "w"), (p + "up_proj.weight", (inter, H), "w"),
                (p + "down_proj.weight", (H, inter), "w")]
    out = [("model.embed_tokens.weight", (V, H), "w")]
    for li in range(L):
        p = f"model.layers.{li}."
        a = p + "self_attn."
        out.append((p + "input_layernorm.weight", (H,), "gamma"))
        if ql:
            out += [(a + "q_a_proj.weight", (ql, H), "w"),
                    (a + "q_a_layernorm.weight", (ql,), "gamma"),
                    (a + "q_b_proj.weight", (nh * (dn + dr), ql), "w")]
        else:
            out.append((a + "q_proj.weight", (nh * (dn + dr), H), "w"))
        out += [(a + "kv_a_proj_with_mqa.weight", (r + dr, H), "w"),
                (a + "kv_a_layernorm.weight", (r,), "gamma"),
                (a + "kv_b_proj.weight", (nh * (dn + dv), r), "w"),
                (a + "o_proj.weight", (H, nh * dv), "w"),
                (p + "post_attention_layernorm.weight", (H,), "gamma")]
        m = p + "mlp."
        if cfg.num_experts and li >= cfg.first_k_dense:
            out.append((m + "gate.weight", (cfg.num_experts, H), "w"))
            for e in range(cfg.num_experts):
                out += mlp(f"{m}experts.{e}.", cfg.moe_intermediate_size)
            if cfg.shared_expert_intermediate_size:
                out += mlp(m + "shared_experts.", cfg.shared_expert_intermediate_size)
        else:
            out += mlp(m, cfg.intermediate_size)
    out.append(("model.norm.weight", (H,), "gamma"))
    return out + ([] if cfg.tie_word_embeddings else [("lm_head.weight", (V, H), "w")])


def mla_run(label: str, make, cfg, prompts, kv: str = "bfloat16"):
    """Greedy n-gram (k = 3) against greedy AR (``make("ar", params)``: no
    speculation) through ``make``, 32 tokens each: the tokens equal; exactly
    the gamma rmsnorm and the attention instantiation of ``kv`` launched,
    every attention launch at the latent head dim (cfg.cache_head_dim),
    cfg.num_layers a forward, and the norm L x (3 + q-LoRA) + 1 a forward
    (input, q-LoRA's q, the latent and post-attention norms of each layer,
    the final one), 2 L of them with the residual add. Returns (launches,
    summary)."""
    name = _attn_name(kv)
    D, L = cfg.cache_head_dim, cfg.num_layers
    spec, launches, _, summary = spec_vs_oracle(make, label, {"rmsnorm", name}, prompts, 32,
                                                every_launch=(f"d{D}",),
                                                methods=("ngram", "ar"))
    n = summary["forwards"]
    want = {name: L * n, "rmsnorm": (L * (3 + bool(cfg.q_lora_rank)) + 1) * n,
            "rmsnorm_gamma": (L * (3 + bool(cfg.q_lora_rank)) + 1) * n, "rmsnorm_fused": 2 * L * n}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, not {want} ({n} forwards)")
    e2e_log(label, prompts, spec, summary)
    return launches, summary


def _mla_engine(cfg, params, kv="bfloat16"):
    """The (N) engine factory: LLMEngine over ``params`` with n-gram (k = 3)
    or, for "ar", no speculation, 4 sequences, pages of 128."""
    from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, SchedulerConfig,
                                 SpeculativeConfig)

    def make(method, p):
        spec = None if method == "ar" else SpeculativeConfig(num_speculative_tokens=3,
                                                              method=method)
        return LLMEngine(EngineConfig(
            model=cfg, cache=CacheConfig(page_size=128, num_pages=40, kv_cache_dtype=kv),
            scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=512), speculative=spec),
            p or params, device="cuda", seed=0)
    return make


def _mla_load(hf: dict, seed: int, tag: str):
    """A published MLA config's random checkpoint made on the card in its
    own keys (mla_entries), converted there by load_family_float: (params,
    cfg, GB of bf16, seconds, peak GiB)."""
    from qspec_tpu_torch.model_loader.families import load_family_float
    from qspec_tpu_torch.models.registry import resolve
    cfg = resolve(hf)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sd = random_state_dict(mla_entries(cfg), seed=seed)
    n_bytes = sum(t.numel() * 2 for t in sd.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, cfg = load_family_float(sd, cfg)
    torch.cuda.synchronize()
    secs, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2 ** 30
    if sd:
        raise AssertionError(f"{tag} load_family_float left {sorted(sd)[:4]} unconverted")
    if cfg.attention_type != "mla" or cfg.quant != "none" or cfg.cache_kv_heads != 1:
        raise AssertionError(f"{tag} loaded as {cfg}")
    return params, cfg, n_bytes / 1e9, secs, peak


def _mla_summary(s: dict) -> str:
    return (f"accept {s['acceptance_rate']:.4f}, {s['spec_tokens_per_s']:.1f} tok/s (AR "
            f"{s['oracle_tokens_per_s']:.1f})")


def phase_minicpm3_4b(smi: str):
    """(N1) MiniCPM3-4B at full width and depth (config.py's MINICPM3_4B_HF:
    62 layers, hidden 2560, 40 heads, q_lora_rank 768, kv_lora_rank 256,
    qk_nope 64 / qk_rope 32 / v 64, vocab 73448, the muP scales, the tied
    head; its longrope left out: the published factors are not in the
    repository): random bf16 made on the card in its keys, converted by
    load_family_float there, then greedy n-gram (k = 3) == greedy AR over a
    bf16 and an int8 latent cache (mla_run's exact launches, every attention
    launch the D=384 instantiation)."""
    from qspec_tpu_torch.config import MINICPM3_4B_HF
    params, cfg, gb, secs, peak = _mla_load(MINICPM3_4B_HF, 120, "(N1)")
    if (cfg.cache_head_dim, cfg.embed_scale, cfg.logits_scaling) != (384, 12.0, 10.0):
        raise AssertionError(f"(N1) minicpm3-4b read as {cfg}")
    prompts = float_prompts(cfg.vocab_size)
    out = {}
    for kv in ("bfloat16", "int8"):
        torch.cuda.reset_peak_memory_stats()
        out[kv] = mla_run(f"(N1) minicpm3-4b bf16, {cfg.num_layers} layers, {kv} KV, n-gram "
                          "k=3 vs AR", _mla_engine(cfg, params, kv), cfg, prompts, kv)
        out[kv][1]["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"e2e (N1) minicpm3-4b, {cfg.num_layers} layers, {gb:.2f} GB in {secs:.2f} s: n-gram "
        "== AR, exact launches, all D=384; " + "; ".join(
            f"{'bf16' if kv == 'bfloat16' else kv} KV {_mla_summary(r[1])}, peak "
            f"{r[1]['peak_mem_gib']:.2f} GiB"
            for kv, r in out.items()))
    log(f"e2e (N1): card {smi}", stdout=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_deepseek_v2_lite(smi: str):
    """(N2) DeepSeek-V2-Lite at full width (config.py's DEEPSEEK_V2_LITE_HF:
    hidden 2048, 16 heads, a direct q, kv_lora_rank 512, qk_nope 128 / qk_rope
    64 / v 128, 64 routed experts of 1408 and 2 shared, top 6, vocab 102400)
    at N2_LAYERS of its 27 layers (the dense first and 3 MoE layers: the
    expert loop is host-bound), random bf16 made on the card in its keys,
    converted there, greedy n-gram (k = 3) == greedy AR over a bf16 latent
    cache, every attention launch the D=640 instantiation."""
    from qspec_tpu_torch.config import DEEPSEEK_V2_LITE_HF
    hf = {**DEEPSEEK_V2_LITE_HF, "num_hidden_layers": N2_LAYERS}
    params, cfg, gb, secs, peak = _mla_load(hf, 121, "(N2)")
    if (cfg.cache_head_dim, cfg.first_k_dense, cfg.num_experts) != (640, 1, 64):
        raise AssertionError(f"(N2) deepseek-v2-lite read as {cfg}")
    prompts = float_prompts(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    launches, summary = mla_run(f"(N2) deepseek-v2-lite bf16, {N2_LAYERS} layers, bf16 KV, "
                                "n-gram k=3 vs AR", _mla_engine(cfg, params), cfg, prompts)
    summary["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"e2e (N2) deepseek-v2-lite, {N2_LAYERS} of 27 layers, {gb:.2f} GB in {secs:.2f} s: "
        f"n-gram == AR, exact launches, all D=640; {_mla_summary(summary)}, peak "
        f"{summary['peak_mem_gib']:.2f} GiB")
    log(f"e2e (N2): card {smi}", stdout=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary


def phase_mla_dirs(smi: str):
    """(N3) LLM(model=<dir>, quantization=None) on a DeepSeek-V2-Lite and a
    MiniCPM3-4B directory (published widths at N3_LAYERS layers, random bf16
    in their keys written here): greedy n-gram (k = 3) == greedy AR (the
    directory without a speculative model) in mla_run's exact launches; the
    default quantization refuses the directory before a weight is read."""
    import tempfile
    from qspec_tpu_torch import LLM
    from qspec_tpu_torch.config import DEEPSEEK_V2_LITE_HF, MINICPM3_4B_HF
    from qspec_tpu_torch.models.registry import resolve
    out = {}
    for i, (name, published) in enumerate((("deepseek-v2-lite", DEEPSEEK_V2_LITE_HF),
                                           ("minicpm3-4b", MINICPM3_4B_HF))):
        hf = {**published, "num_hidden_layers": N3_LAYERS}
        cfg = resolve(hf)
        held = {}
        with tempfile.TemporaryDirectory() as d:
            write_config(d, hf)
            try:
                LLM(model=d, device="cuda")
            except NotImplementedError as e:
                if "bf16" not in str(e):
                    raise
            else:
                raise AssertionError(f"(N3) {name}: the default quantization did not raise")
            sd = random_state_dict(mla_entries(cfg), seed=130 + i)
            write_safetensors(os.path.join(d, "model.safetensors"), sd)
            del sd

            def make(method, p):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                spec = {} if method == "ar" else dict(num_speculative_tokens=3,
                                                      speculative_model="[ngram]")
                llm = LLM(model=d, params=p, quantization=None, device="cuda", max_model_len=512,
                          max_num_seqs=4, seed=0, num_pages=40, **spec)
                if p is None:
                    torch.cuda.synchronize()
                    held.update(cfg=llm.engine_config.model, load_s=time.perf_counter() - t0)
                return llm.llm_engine
            out[name] = mla_run(f"(N3) {name} dir, {N3_LAYERS} layers, bf16, n-gram k=3 vs AR",
                                make, cfg, float_prompts(cfg.vocab_size))
        if held["cfg"] != cfg:
            raise AssertionError(f"(N3) {name}: loaded as {held['cfg']}")
        out[name][1]["load_s"] = held["load_s"]
        del held
        gc.collect()
        torch.cuda.empty_cache()
    log(f"e2e (N3) LLM(model=<dir>, quantization=None), {N3_LAYERS} layers, n-gram == AR, exact "
        "launches: " + ", ".join(f"{n} accept {r[1]['acceptance_rate']:.3f} (load "
                                 f"{r[1]['load_s']:.1f} s)" for n, r in out.items())
        + "; the default quantization refused")
    log(f"e2e (N3): card {smi}", stdout=False)
    return out


KERNEL_META = {
    "matmul_w4a16": ("qspec_tpu_torch/csrc/w4.cu",
                     "qspec_tpu/ops/linear_kernels.py:139 (_w4a16_kernel)"),
    "matmul_w4a4": ("qspec_tpu_torch/csrc/w4.cu",
                    "qspec_tpu/ops/linear_kernels.py:160 (_w4a4_kernel)"),
    "rmsnorm": ("qspec_tpu_torch/csrc/rmsnorm.cu",
                "qspec_tpu/ops/rmsnorm_quant.py:78 (_rmsnorm_kernel)"),
    "rmsnorm_quant": ("qspec_tpu_torch/csrc/rmsnorm.cu",
                      "qspec_tpu/ops/rmsnorm_quant.py:68 (_rmsnorm_quant_kernel)"),
    "paged_attention": ("qspec_tpu_torch/csrc/paged_attention.cu",
                        "qspec_tpu/ops/attention_pallas.py:52 (_paged_attn_kernel; "
                        "window, softcap :183, head dims 128, 256, 384, 640, tree mask "
                        ":131-139,188-194, ALiBi :175-182)"),
    "matmul_w8a16": ("qspec_tpu_torch/csrc/w8a16.cu",
                     "qspec_tpu/ops/linear_kernels.py:538 (_w8a16_kernel)"),
    "matmul_w8a16_fp8": ("qspec_tpu_torch/csrc/w8a16.cu",
                         "qspec_tpu/ops/linear_kernels.py:538 (_w8a16_kernel over "
                         "float8_e4m3fn weights; pallas_call :596, stacked :615)"),
    "matmul_w4a16_g": ("qspec_tpu_torch/csrc/w4a16_g.cu",
                       "qspec_tpu/ops/linear_kernels.py:372 (_w4a16_g_kernel; stacked "
                       "_stacked_g_kernel, :402)"),
}
# the fields of the kernels line on the standard output (the log has all)
STDOUT_KEYS = ("name", "route", "source", "replaces", "launches", "launches_in",
               "max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
               "shape", "qwen2_7b", "qwen2_7b_shape", "j_times", "k_max_err", "k_times",
               "mla_times")
# the 8-bit instantiations of the attention kernel: (source, TPU kernel)
KV8_META = {f"paged_attention_{dt}": (
    "qspec_tpu_torch/csrc/paged_attention.cu",
    "qspec_tpu/ops/attention_pallas.py:52 (_paged_attn_kernel, 8-bit KV option)")
    for dt in KV8}


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    _LOG.append(open(os.path.join(out_dir, "chip_smoke.log"), "w"))
    step("start")
    phase_build()
    step("build")
    gen = torch.Generator(device="cuda").manual_seed(0)
    gen_w4 = torch.Generator(device="cuda").manual_seed(1)
    report = {name: {} for name in (*KERNEL_META, *KV8_META)}
    check_gemms(gen, gen_w4, report)
    check_w4a16_g(gen, report)
    int4pack_missing = check_int4pack(gen)
    check_w8a16(gen, report)
    check_w8a16_trunk(torch.Generator(device="cuda").manual_seed(8), report)
    check_norms(gen, report)
    check_norms_fused(report)
    check_attention(gen, report)
    check_attention_window(gen, report)
    check_attention_kv8(gen, report)
    check_attention_d256(gen, report)
    check_attention_tree(gen, report)
    check_attention_tree_main(gen, report)
    check_attention_alibi(gen, report)
    step("kernel checks")
    time_kernels(gen, gen_w4, report, int4pack_missing)
    time_w4a16_g(gen, report, int4pack_missing)
    time_attention_window(gen, report)
    time_attention_d256(gen, report)
    time_attention_long(gen, report)
    time_attention_tree(gen, report)
    time_attention_alibi(gen, report)
    time_bloom_projections(gen)
    time_w8a16_trunk(torch.Generator(device="cuda").manual_seed(9), report)
    time_w4a16_g32(torch.Generator(device="cuda").manual_seed(10), report, int4pack_missing)
    step("kernel times")
    phase_small_reference("bf16", "bfloat16")
    phase_small_reference("auto", "int8")
    phase_small_reference("auto", "bfloat16", quant="w4g")
    phase_small_reference("auto", "bfloat16", quant="gemma2")
    phase_small_reference("auto", "bfloat16", quant="bloom")
    print("check tiny model_forward, 9 cases (w4 at w4a16/w4a8/w4a4 with two heads and "
          "KVs, w4g, gemma2, bloom): each within its tolerance vs the CPU (the log has "
          "each)", flush=True)
    tiny = phase_tiny_end_to_end()
    step("tiny")
    first, default = phase_end_to_end(smi)
    step("llama3-8b")
    awq = phase_grouped_8b("llama3-8b", smi)
    step("awq")
    gemma = phase_grouped_8b("gemma2-9b", smi)
    step("gemma2")
    medusa = phase_medusa_8b(smi)
    step("medusa")
    bloom = phase_bloom_7b1(smi)
    step("bloom")
    mpt = phase_mpt_dir(smi)
    step("mpt")
    params8, cfg8, quarot = phase_quarot_float_8b(smi)
    step("A")
    draft = phase_draft_1b(params8, cfg8, smi)
    step("B")
    forced = phase_forced_8b(params8, cfg8, smi)
    step("C")
    dirs = phase_llama_dirs(params8, cfg8, smi)
    step("D")
    server = phase_server_8b(params8, cfg8, smi)
    step("F")
    guided = phase_guided_8b(params8, cfg8, smi)
    step("I")
    # (L) the engine surface: LoRA, swap, soft prompts, beam search, the
    # LoRA routes, on (A)'s parameters against (A)'s W4A8 tokens
    surface = phase_engine_surface_8b(params8, cfg8, quarot["w4a8"][2], smi)
    step("L")
    del params8
    torch.cuda.empty_cache()
    proposers = phase_proposers_8b(smi)
    step("E")
    # (G) the sparse-MoE MLP, with the 8B phases' parameters released
    gc.collect()
    torch.cuda.empty_cache()
    t_moe = time.perf_counter()
    gen_moe = torch.Generator(device="cuda").manual_seed(2)
    check_moe_shapes(gen_moe, report)
    time_moe_shapes(gen_moe, report, int4pack_missing)
    step("G shapes")
    moe = {"G1": phase_moe_mixtral(smi), "G2": phase_moe_qwen15(smi)}
    step("G1 G2")
    moe_dirs = phase_moe_dirs(smi)
    step("G3")
    log(f"(G) took {time.perf_counter() - t_moe:.1f} s")
    # (H) the dense families, with the MoE phases' parameters released
    gc.collect()
    torch.cuda.empty_cache()
    t_dense = time.perf_counter()
    gen_dense = torch.Generator(device="cuda").manual_seed(4)
    check_dense_shapes(gen_dense, report)
    time_dense_shapes(gen_dense, report, int4pack_missing)
    step("H shapes")
    qwen2 = phase_qwen2_7b(smi)
    step("H1")
    dense_dirs, kept = phase_dense_dirs(smi)
    step("H2")
    quarot_dirs = phase_quarot_dirs(kept, smi)
    step("H3")
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    log(f"(H) took {time.perf_counter() - t_dense:.1f} s")
    # (J) the llama graph under other key names and the float families
    t_remap = time.perf_counter()
    gen_remap = torch.Generator(device="cuda").manual_seed(5)
    check_remap_shapes(gen_remap, report)
    time_remap_shapes(gen_remap, report, int4pack_missing)
    step("J shapes")
    internlm2, internlm2_load = phase_internlm2_7b(smi)
    step("J1")
    remap_dirs = phase_remap_dirs(smi)
    step("J2")
    float_dirs = phase_float_dirs(smi)
    step("J3")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"(J) took {time.perf_counter() - t_remap:.1f} s")
    # (K) the gptj rope and partial rotary: the parallel-residual families,
    # GLM-4 and Helium
    t_k = time.perf_counter()
    gen_k = torch.Generator(device="cuda").manual_seed(6)
    check_k_shapes(gen_k, report)
    time_k_shapes(gen_k, report)
    step("K shapes")
    gptj = phase_gptj_6b(smi)
    step("K1")
    k_dirs = phase_k_dirs(smi)
    step("K2")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"(K) took {time.perf_counter() - t_k:.1f} s")
    # (M) compressed-tensors and GGUF checkpoints: the W8A16 trunk (int8 and
    # fp8), the trained pair through four loaders, a GGUF file and a
    # compressed-tensors directory
    t_m = time.perf_counter()
    ct8b = phase_ct_8b(smi)
    step("M1 M2")
    ct_ind = phase_ct_induction(smi)
    step("M3")
    ct_dirs = phase_ct_dirs(smi)
    step("M4")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"(M) took {time.perf_counter() - t_m:.1f} s")
    # (N) multi-head latent attention: the attention kernel at the latent
    # head dims 384 and 640, MiniCPM3-4B and DeepSeek-V2-Lite
    t_n = time.perf_counter()
    gen_n = torch.Generator(device="cuda").manual_seed(11)
    check_mla_shapes(gen_n, report)
    time_mla_shapes(gen_n, report)
    time_mla_norms(report)
    step("N shapes")
    minicpm3 = phase_minicpm3_4b(smi)
    step("N1")
    v2_lite = phase_deepseek_v2_lite(smi)
    step("N2")
    mla_dirs = phase_mla_dirs(smi)
    step("N3")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"(N) took {time.perf_counter() - t_n:.1f} s")
    log(f"e2e: {len(_E2E)} runs of phases 5-23, each greedy == its oracle (the log has each)")
    # each kernel's launches in (N)'s paths: (N1) over bf16 and int8 KV,
    # (N2), (N3) each directory
    mla_paths = {f"N1_{kv}": r[0] for kv, r in minicpm3.items()}
    mla_paths["N2"] = v2_lite[0]
    mla_paths.update({f"N3_{n}": r[0] for n, r in mla_dirs.items()})
    # each kernel's launches in (M)'s paths: (M1) a / b, (M2) a, (M3) each
    # loader's QSpec and EAGLE, (M4) a / b
    ct_paths = {k: r[0] for k, r in ct8b.items()}
    ct_paths.update({f"M3_{k}": r[0] for k, r in ct_ind.items()})
    ct_paths.update({k: r[0] for k, r in ct_dirs.items()})
    # each kernel's launches in (K)'s paths: (K1) GPT-J-6B, (K2) each directory
    k_paths = {"K1": gptj[0], **{f"K2_{n}": r[0] for n, r in k_dirs.items()}}
    # each kernel's launches in (J)'s paths: (J1) InternLM2.5-7B at W4A4 and
    # W4A8, (J2) each remap directory, (J3) each float directory
    remap_paths = {f"J1_{s}": r[0] for s, r in internlm2.items()}
    remap_paths.update({f"J2_{n}": r[0] for n, r in remap_dirs.items()})
    remap_paths.update({f"J3_{n}": r[0] for n, r in float_dirs.items()})
    # each kernel's launches in the MoE paths: (G1) W4A4 and W4A8, (G2) W4A8,
    # (G3) each directory
    moe_paths = {f"{g}_{s}": r[0] for g, runs in moe.items() for s, r in runs.items()}
    moe_paths.update({f"G3_{f}": r[0] for f, r in moe_dirs.items()})
    # each kernel's launches in the dense families' paths: (H1) Qwen2-7B at
    # W4A4 and W4A8, (H2) each directory, (H3) the QuaRot and AWQ directories
    dense_paths = {f"H1_{s}": r[0] for s, r in qwen2.items()}
    dense_paths.update({f"H2_{n}": r[0] for n, r in dense_dirs.items()})
    dense_paths.update({f"H3{k}": r[0] for k, r in quarot_dirs.items()})
    # each kernel's launches in the real-weights loaders' paths: (A) W4A4 and
    # W4A8, (B) the separate draft, (C) forced, (D1) the bf16 directory,
    # (D2) the float directory quantized at load, (D3) the QSpec directory
    new_paths = {"A_w4a4": quarot["w4a4"][0], "A_w4a8": quarot["w4a8"][0], "B": draft[0],
                 "C": forced[0], "D1": dirs["D1"][0], "D2": dirs["D2"][0], "D3": dirs["D3"][0]}

    # each row's launches from the 8B run of its own path (its first draft):
    # the bf16 instantiation from the first slice's (bf16 head, bf16 KV), the
    # grouped GEMM and the attention's windowed launches from the third
    # slice's (a), the rest from the second slice's (defaults, int8 KV); the
    # fp8 instantiations, which no 8B run takes, from the tiny model's run
    # over their cache; and, beside, the w4g kernels' launches in the
    # Gemma-2-9B run (a) and the Medusa path's kernels' in the Llama-3-8B tree
    # run (d) and the Gemma-2-9B tree run
    kernels = []
    for name, (source, replaces) in {**KERNEL_META, **KV8_META}.items():
        r = report[name]
        extra = {}
        if name == "paged_attention":
            n_launch, where = first[name], "llama3-8b, bf16 head, bf16 KV, w4a4 draft"
            extra = {"window_launches": awq["a"][1][name]["window"],
                     "window_launches_in": "llama3-8b AWQ, w4a16 draft, window 64",
                     "window": r["window"],
                     "d256_softcap_launches": gemma["a"][1][name]["d256"],
                     "tree": r["tree"],
                     "tree_launches": {"llama3-8b Medusa tree": medusa["d"][1][name]["tree"],
                                       "llama3-8b Medusa chain": medusa["c"][1][name]["tree"],
                                       "gemma2-9b Medusa tree": gemma["tree"][1][name]["tree"]},
                     "medusa_rounds": {"llama3-8b tree": medusa["d"][2]["rounds_run"],
                                       "gemma2-9b tree": gemma["tree"][2]["rounds_run"]},
                     "alibi": r["alibi"],
                     "long": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")}
                              for k, v in r["long"].items()},
                     "alibi_launches": {"bloom-7b1 n-gram": bloom[1][name]["alibi"],
                                        "mpt-7b 2-layer n-gram": mpt["alibi_launches"]},
                     "bloom_forwards": bloom[2]["forwards"]}
        elif name == "matmul_w4a16_g":
            n_launch, where = awq["a"][0][name], "llama3-8b AWQ, w4a16 draft, window 64"
            extra = {key: r[key] for key in ("m4_draft", "gemma2_9b", "library_note") if key in r}
            extra["gemma2_tree_launches"] = gemma["tree"][0][name]
        elif name == "matmul_w8a16_fp8":
            n_launch, where = ct8b["M2a"][0][name], "llama3-8b ct fp8, w4a16 draft, window 64"
            extra.update(m4=r["m4"], down=r["down"])
        elif name.startswith("paged_attention_fp8"):
            dt = name.split("_", 2)[2]
            n_launch, where = tiny[dt][name], f"tiny, int8 head, {dt} KV, w4a4 draft"
        else:
            n_launch, where = default[name], "llama3-8b, int8 head, int8 KV, w4a4 draft"
        if name in W4G_KERNELS:
            extra["gemma2_launches"] = gemma["a"][0][name]
        if name in MEDUSA_KERNELS:
            extra["medusa_tree_launches"] = medusa["d"][0][name]
        if name in NORMS:
            extra.update(floor_ms=r["floor_ms"], fused=dict(
                r["fused"], launches=default[f"{name}_fused"], max_abs_err=r["fused_max_err"]))
        if r.get("library"):
            extra["library"] = r["library"]
        for key in W4_KEYS.values():
            if key in r:
                extra[key] = {f: r[key][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms")}
        for opt in ("tree", "alibi"):
            if opt in r and name != "paged_attention":
                extra[opt] = r[opt]
        if "d256_softcap" in r:
            extra["d256_softcap"] = r["d256_softcap"]
        loaders = {k: v[name] for k, v in new_paths.items() if v.get(name)}
        if loaders:
            extra["loader_launches"] = loaders
        if name in PROPOSER_KERNELS:
            extra["proposer_launches"] = [proposers[k][0][name] for k in ("E1", "E2")]
        if name in server[0]:
            extra["server_launches"] = server[0][name]
        if name in surface[0]:
            extra["lora_launches"] = surface[0][name]
        guided_launch = {k: v[name] for k, v in guided[0].items() if v.get(name)}
        if guided_launch:
            extra["guided_launches"] = guided_launch
        moe_launch = {k: v[name] for k, v in moe_paths.items() if v.get(name)}
        if moe_launch:
            extra["moe_launches"] = moe_launch
        for key in ("moe_max_err", "moe_head_max_err", "dense_max_err", "qwen2_7b",
                    "qwen2_7b_shape", "j_max_err", "j_times", "k_max_err", "k_times"):
            if key in r:
                extra[key] = r[key]
        remap_launch = {k: v[name] for k, v in remap_paths.items() if v.get(name)}
        if remap_launch:
            extra["remap_launches"] = remap_launch
        if name == "matmul_w4a16":
            extra["internlm2_load"] = {k: float(f"{v:.4g}") for k, v in internlm2_load.items()}
        ct_launch = {k: v[name] for k, v in ct_paths.items() if v.get(name)}
        if ct_launch:
            extra["ct_launches"] = ct_launch
        for key in ("trunk", "trunk_max_err", "g32", "head_m4", "head_m60", "bigm_max_err"):
            if key in r:
                extra[key] = r[key]
        k_launch = {k: v[name] for k, v in k_paths.items() if v.get(name)}
        if k_launch:
            extra["k_launches"] = k_launch
        dense_launch = {k: v[name] for k, v in dense_paths.items() if v.get(name)}
        if dense_launch:
            extra["dense_launches"] = dense_launch
        for key in ("mla_max_err", "mla_times"):
            if key in r:
                extra[key] = r[key]
        mla_launch = {k: v[name] for k, v in mla_paths.items() if v.get(name)}
        if mla_launch:
            extra["mla_launches"] = mla_launch
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launch, "launches_in": where, "max_abs_err": r["max_err"],
            "tol": r["tol"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"], **extra})
    step("kernels line")
    log(f"wall: {time.perf_counter() - t_start:.1f} s")
    log("steps (s): " + json.dumps(_STEPS, separators=(",", ":")), stdout=False)
    # every field to the log; to the standard output, which a runner may
    # keep only the end of, each kernel's summary fields
    log(json.dumps({"kernels": kernels}, separators=(",", ":")), stdout=False)
    print(json.dumps({"kernels": [{k: v for k, v in kern.items() if k in STDOUT_KEYS}
                                  for kern in kernels]}, separators=(",", ":")), flush=True)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


# the attention shapes --ab times, each (label, KV entry, head dim, Hq, Hkv,
# Q, contexts, option): the verify shapes of time_kernels and
# time_attention_d256, the long contexts of time_attention_long, the
# draft's window and the same decode without it (time_attention_window), the
# tree verify (time_attention_tree) and BLOOM's ALiBi (time_attention_alibi)
AB_SHAPES = (
    ("d128_bf16", "bfloat16", 128, 32, 8, 4, None, {}),
    ("d128_int8", "int8", 128, 32, 8, 4, None, {}),
    ("d256_bf16_cap50", "bfloat16", 256, 16, 8, 4, None, {"softcap": 50.0}),
    ("d256_bf16", "bfloat16", 256, 16, 8, 4, None, {}),
    ("ctx8192_bf16", "bfloat16", 128, 32, 8, 4, (LONG_CTX,) * 4, {}),
    ("ctx8192_int8", "int8", 128, 32, 8, 4, (LONG_CTX,) * 4, {}),
    ("window128_ctx2048_q1", "bfloat16", 128, 32, 8, 1, (2048,) * 4, {"window": 128}),
    ("ctx2048_q1", "bfloat16", 128, 32, 8, 1, (2048,) * 4, {}),
    ("tree_q15", "bfloat16", 128, 32, 8, None, None, {"tree": True}),
    ("alibi_bloom_q4", "bfloat16", 128, 32, 32, 4, None, {"alibi": True}),
    # the MLA kernel (time_mla_shapes): MLA_ATTN's groups at the verify over
    # bf16 and int8, DeepSeek-V2-Lite's decode, MLA_LONG tokens over bf16
    *((f"mla_{a[0]}_{kv}", kv, a[2], a[1], 1, 4, None, {"mla": a[3:]})
      for kv in ("bfloat16", "int8") for a in MLA_ATTN),
    ("mla_deepseek-v2-lite_bfloat16_q1", "bfloat16", 640, 16, 1, 1, None,
     {"mla": MLA_ATTN[1][3:]}),
    *((f"mla_{a[0]}_bfloat16_ctx{MLA_LONG}", "bfloat16", a[2], a[1], 1, 4, (MLA_LONG,) * 4,
       {"mla": a[3:]}) for a in MLA_ATTN))
AB_KV = ("bfloat16", "int8", "fp8_e4m3", "fp8_e5m2")


def instantiations():
    """The attention kernel's 44 instantiations as --ab shapes: every entry
    type x head dim 128 / 256 x softcap 50 or none x the tree or not, at the
    verify shape (B=4, Q=4, or the tree rectangle, Q=15; Hq=32 at D=128, 16
    at D=256, Hkv=8; contexts 379/263/512/40), ALiBi on every entry type
    at BLOOM-7B1's (Hq=Hkv=32, Q=4), and the MLA kernel on every entry type
    at head dims 384 (MiniCPM3-4B's 40 heads) and 640 (DeepSeek-V2-Lite's
    16), the same verify."""
    out = []
    for kv in AB_KV:
        for D in (128, 256):
            for cap in (None, 50.0):
                for tree in (False, True):
                    opt = {"softcap": cap} if cap else {}
                    if tree:
                        opt["tree"] = True
                    out.append((f"{kv}/D{D}/cap{int(bool(cap))}/tree{int(tree)}", kv, D,
                                32 if D == 128 else 16, 8, None if tree else 4, None, opt))
        out.append((f"{kv}/D128/alibi", kv, 128, 32, 32, 4, None, {"alibi": True}))
        for a in MLA_ATTN[:2]:
            out.append((f"{kv}/D{a[2]}/mla", kv, a[2], a[1], 1, 4, None, {"mla": a[3:]}))
    return out


def ab_attention_ms(gen, shape) -> float:
    """One --ab shape's kernel time: inputs rotated past L2, CUDA-graph
    replays (graph_ms); only the kernel's wrapper of the checkout runs."""
    from qspec_tpu_torch.ops.attention import alibi_slopes, tree_mask
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    from qspec_tpu_torch.spec_decode.medusa_tree import DEFAULT_TREE, build_tree
    _, kv, D, Hq, Hkv, q_len, ctx, opt = shape
    if "mla" in opt:   # the latent attention as _mla_attention calls it
        dk, dv, dqk = opt["mla"]
        ctx = ctx or _ctx_lens(q_len)
        rot = Rotating(lambda: _mla_inputs(gen, q_len, kv, Hq, D, dk, dv, ctx=ctx),
                       sum(ctx) * 2 * D * (2 if kv == "bfloat16" else 1))
        ms = graph_ms(lambda: _mla_call(rot.next(), dqk, dk, dv), reps=max(20, len(rot.sets)))
        del rot
        torch.cuda.empty_cache()
        return ms
    kw = {k: v for k, v in opt.items() if k in ("softcap", "window")}
    if opt.get("tree"):
        tspec = build_tree(DEFAULT_TREE)
        positions, ctx = _tree_rect(tspec)
        q_len = positions.shape[1]
        kw.update(q_positions=positions, tree=tree_mask(TREE_PREFIX, tspec.ancestors, "cuda"))
    if opt.get("alibi"):
        kw["alibi"] = torch.as_tensor(alibi_slopes(Hq), device="cuda")
    ctx = ctx or _ctx_lens(q_len)
    nbytes = sum(ctx) * Hkv * D * 2 * (2 if kv == "bfloat16" else 1)
    live_pages = None
    if "window" in kw:      # only the pages the window reaches get pages of their own
        live_pages = -(-ctx[0] // 128) - max(ctx[0] - q_len - kw["window"] + 1, 0) // 128
        nbytes = nbytes * live_pages * 128 // ctx[0]
    if len(set(ctx)) == 1:
        rot = Rotating(lambda: _attn_window_inputs(gen, q_len, kv, ctx, Hq=Hq, Hkv=Hkv, D=D,
                                                   live_pages=live_pages), nbytes)
    elif kv == "bfloat16":
        rot = Rotating(lambda: _attn_inputs(gen, q_len, Hq=Hq, Hkv=Hkv, D=D, ctx=ctx), nbytes)
    else:
        rot = Rotating(lambda: _attn_inputs_kv(gen, q_len, kv, Hq=Hq, Hkv=Hkv, D=D, ctx=ctx),
                       nbytes)

    def kern():
        q, cache, tables, c = rot.next()
        paged_attention_cuda(q, cache.kv_pages, tables, c, D ** -0.5, layer=1,
                             kv_scales=cache.kv_scales, **kw)
    ms = graph_ms(kern, reps=max(20, len(rot.sets)))
    del rot
    torch.cuda.empty_cache()
    return ms


def ab_norms_ms() -> dict:
    """The checkout's norm kernels at NORM_TIMED (time_norms' inputs and
    rotation): alone, and after the residual add: in the kernel where the
    checkout's norm takes ``residual``, else the torch add and the norm in
    one graph, so that both checkouts do the same work."""
    import inspect
    from qspec_tpu_torch.ops import rmsnorm_quant as rq
    takes_residual = "residual" in inspect.signature(rq.rmsnorm).parameters
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for name, m, h, bits, gamma in NORM_TIMED:
        rot = _norm_rot(gen, m, h)
        norm, kw = _norm_wrapper(name, bits, _gamma(gen, h) if gamma else None)

        def alone():
            norm(rot.next()[0], **kw)

        def fused():
            x, r = rot.next()
            norm(x, residual=r, **kw) if takes_residual else norm(x + r, **kw)
        label = norm_label(name, m, h, bits, gamma)
        reps = max(20, len(rot.sets))
        out[f"norm_{label}"] = graph_ms(alone, reps)
        out[f"norm_{label}_add"] = graph_ms(fused, reps)
        del rot
        torch.cuda.empty_cache()
    return out


# matmul_w8a16's --ab shapes: (label, [(K, N)], M, weight type): one
# Llama-3-8B trunk layer (time_w8a16_trunk's, bf16 out) over int8 and fp8 at
# the draft's M = 4 and the verify's 16, its down projection alone, and
# (f32 out) the int8 head at the draft's 4, the verify's 16 and the tree
# verify's 60 (time_kernels'), and Qwen1.5-MoE's and Qwen2-7B's heads
# (time_moe_shapes', time_dense_shapes')
W8_AB = (*((f"w8_trunk_{kind}_m{m}", W8_TRUNK, m, kind) for kind in ("int8", "fp8")
           for m in (4, 16)),
         *((f"w8_down_{kind}_m{m}", W8_TRUNK[3:], m, kind) for kind in ("int8", "fp8")
           for m in (4, 16)),
         *((f"w8_head_m{m}", (HEAD_SHAPE[1:],), m, "head") for m in (4, 16, 60)),
         *((f"w8_head_qwen15moe_m{m}", (MOE_HEAD,), m, "head") for m in MOE_M),
         *((f"w8_head_qwen2_7b_m{m}", (DENSE_HEADS["qwen2-7b"],), m, "head") for m in DENSE_M))


def w8_ms(gen, shapes, m: int, kind: str) -> list:
    """Kernel ms of matmul_w8a16 at each (K, N) of ``shapes``, M = ``m``:
    trunk weights of ``kind`` (int8 / fp8) made by the compressed-tensors
    writers, bf16 out; ``kind`` "head": int8 head weights
    (quantize_weight_int8_torch), f32 out. Each input set rotated past L2,
    CUDA-graph replays (graph_ms)."""
    from qspec_tpu_torch.ops import linear_kernels as lk
    head = kind == "head"
    out_dtype = torch.float32 if head else torch.bfloat16
    per = []
    for k, n in shapes:
        rot = Rotating(lambda k=k, n=n: _w8(gen, k, n) if head else
                       _w8_trunk_weights(gen, k, n, kind), k * n + 4 * n)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        per.append(graph_ms(lambda: lk.matmul_w8a16(x, *rot.next(), out_dtype=out_dtype),
                            reps=max(20, len(rot.sets))))
        del rot
        torch.cuda.empty_cache()
    return per


def ab_child(root: str):
    """One checkout's attention times at AB_SHAPES and at the 44
    instantiations, its grouped GEMM's per layer (the four projections,
    kernel only, weights made by that checkout's model_loader.grouped) of
    Llama-3-8B and Gemma-2-9B at M = 4, 16 and 60, its matmul_w4a16 and
    matmul_w4a4 at W4_TIMED (kernel only), its norms at NORM_TIMED, its
    matmul_w8a16 at W8_AB (kernel only, weights made by that checkout's
    writers), and those kernels' ptxas registers and spills, as one JSON
    line (--ab's child process)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from qspec_tpu_torch import _build
    from qspec_tpu_torch.ops import linear_kernels as lk
    if not _build.__file__.startswith(root + os.sep):
        raise SystemExit(f"chip_smoke --ab: {root} holds no qspec_tpu_torch")
    _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {shape[0]: ab_attention_ms(gen, shape) for shape in AB_SHAPES}
    inst = {shape[0]: ab_attention_ms(gen, shape) for shape in instantiations()}
    for model, shapes in (("llama3-8b", GEMM_SHAPES), ("gemma2-9b", GEMMA_SHAPES)):
        for m in (4, 16, 60):
            per = []
            for k, n in shapes:
                rot = Rotating(lambda k=k, n=n: _w4g(gen, k, n), k * n // 2 + (k // GROUP) * n * 8)
                x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
                per.append(graph_ms(lambda: lk.matmul_w4a16_g(x, *rot.next()),
                                    reps=max(20, len(rot.sets))))
                del rot
                torch.cuda.empty_cache()
            out[f"w4a16_g_{model}_m{m}"] = [sum(per), per]
    for name, m, key in W4_TIMED:
        r = time_w4_layer(gen, name, m, head=key == "head", plain=False, library=False)
        out[f"{name[7:]}_m{m}" + ("_head" if key == "head" else "")] = [r["ms"], r["per"]]
    out.update(ab_norms_ms())
    gen_w8 = torch.Generator(device="cuda").manual_seed(12)
    for label, shapes, m, kind in W8_AB:
        per = w8_ms(gen_w8, shapes, m, kind)
        out[label] = [sum(per), per]
    regs = {_kernel_name(k): [v.get("regs"), v.get("spill_stores", 0)]
            for k, v in _build.build_info.get("ptxas", {}).items()
            if any(f in k for f in ("paged_attention", "w4a16_g", "w4_kernel", "w4a4_kernel",
                                    "w4a16_kernel", "w8a16_kernel", "rmsnorm_kernel"))}
    print(json.dumps({"checkout": root, "ms": out, "instantiations_ms": inst,
                      "ptxas_regs_spills": regs}, separators=(",", ":")), flush=True)


def ab(roots):
    """--ab: each checkout of ``roots`` timed by a process of its own, in
    the order given. Every child's JSON line goes to the log; the standard
    output gets, per AB_SHAPES entry, the times in that order and the ratio
    of the first checkout's mean time to the second's, and for the 44
    instantiations how many the second checkout runs faster."""
    if not roots:
        raise SystemExit(__doc__)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    _LOG.append(open(os.path.join(out_dir, "chip_smoke.log"), "a"))
    phase_device()
    res = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--ab-child", root],
                              check=True, stdout=subprocess.PIPE, text=True)
        line = proc.stdout.strip().splitlines()[-1]
        log(line, stdout=False)
        res.append(json.loads(line))
    names = list(dict.fromkeys(r["checkout"] for r in res))

    def val(x):          # a grouped GEMM's entry is [layer ms, per projection]
        return x[0] if isinstance(x, list) else x

    def ratio(key, label):
        mean = [np.mean([val(r[key][label]) for r in res if r["checkout"] == n])
                for n in names]
        return mean[0] / mean[-1]
    log(f"ab checkouts: {' / '.join(r['checkout'] for r in res)}")
    for label in res[0]["ms"]:
        vals = [val(r["ms"][label]) for r in res]
        log(f"ab {label}: " + " / ".join(f"{v:.5f}" for v in vals)
            + f" ({ratio('ms', label):.2f}x)")
    inst = {label: ratio("instantiations_ms", label) for label in res[0]["instantiations_ms"]}
    for label, x in inst.items():
        log(f"ab instantiation {label}: " + " / ".join(
            f"{r['instantiations_ms'][label]:.5f}" for r in res) + f" ({x:.2f}x)", stdout=False)
    log(f"ab instantiations: the second checkout faster at {sum(x > 1 for x in inst.values())} "
        f"of {len(inst)}, {min(inst.values()):.2f}-{max(inst.values()):.2f}x (each in the log)")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"]:
        ab(sys.argv[2:])
    elif sys.argv[1:2] == ["--ab-child"]:
        ab_child(sys.argv[2])
    else:
        main()
