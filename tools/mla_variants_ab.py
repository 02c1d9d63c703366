"""csrc/paged_attention.cu's MLA kernel (head dims 384 and 640) timed
against variants of itself on one card.

    python3 tools/mla_variants_ab.py [VARIANT ...]    # from the repository root

Each variant is a copy of qspec_tpu_torch under qspec_tpu_torch/_build/
variants/ (git-ignored) with a text patch of csrc/paged_attention.cu (or
of ops/attention_cuda.py's plan), checked to apply. The base (the package as it is) and each variant are
built and timed by a process of their own, in the order base, the variants,
base; each builds csrc/paged_attention.cu (and csrc/w4.cu, which holds the
library's error strings) alone. A process first holds its
build to the plain version at chip_smoke.MLA_ATTN (bf16 and int8 caches, Q
= 1, 4 and 64, chip_smoke.MLA_TOL; skipped by the diagnostics, whose
results are wrong by design), then times the kernel at MLA_ATTN's three
groups at the n-gram verify (B = 4, Q = 4, contexts 379 / 263 / 512 / 40)
over bf16 and int8 caches and at DeepSeek-V2-Lite's decode (Q = 1): inputs
rotated past L2, CUDA events over CUDA-graph replays (chip_smoke's
time_mla_shapes). It prints the card's name and power limit, one JSON line
per run and a table of ms per shape.

Variants (all by default):
  acc2    S = Q.K^T into two accumulators (the even and the odd k16 steps of
          each 32 lanes), added at the end (the kernel: one chain)
  acc2u   acc2 with the k loop unrolled 3 times
  wave    one split a block wherever the launch's split blocks fit in one
          wave of 132 SMs (ops/attention_cuda.py's plan; the kernel: one
          split a block at up to 4 row tiles, all of them past)
  wave128 wave, with MLA's splits of 128 tokens (the kernel: 256)
  nocopy  diagnostic: no KV copies (the ring is never filled)
  nos     diagnostic: no S products
  nopv    diagnostic: no P.V products
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "qspec_tpu_torch")

S_LOOP = ('''        float sc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = 0; j < dk / 32; ++j) {
          uint32_t a0[4], a1[4], bk[4];
          ldmatrix_x4(a0, q_base + swz<kD>(a_row, 4 * j + a_c));
          ldmatrix_x4(a1, q_base + swz<kD>(a_row, 4 * j + 2 + a_c));
          ldmatrix_x4(bk, k_base + swz<kD>(8 * warp + lr, 4 * j + lm));
          mma_bf16(sc, a0, bk[0], bk[1]);
          mma_bf16(sc, a1, bk[2], bk[3]);
        }
''')


def acc2(unroll: str) -> tuple:
    return (S_LOOP, f'''        float sc[4] = {{0.f, 0.f, 0.f, 0.f}}, sc2[4] = {{0.f, 0.f, 0.f, 0.f}};
{unroll}        for (int j = 0; j < dk / 32; ++j) {{
          uint32_t a0[4], a1[4], bk[4];
          ldmatrix_x4(a0, q_base + swz<kD>(a_row, 4 * j + a_c));
          ldmatrix_x4(a1, q_base + swz<kD>(a_row, 4 * j + 2 + a_c));
          ldmatrix_x4(bk, k_base + swz<kD>(8 * warp + lr, 4 * j + lm));
          mma_bf16(sc, a0, bk[0], bk[1]);
          mma_bf16(sc2, a1, bk[2], bk[3]);
        }}
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[e] = __fadd_rn(sc[e], sc2[e]);
''')


VARIANTS = {
    "acc2": [acc2("")],
    "acc2u": [acc2("#pragma unroll 3\n")],
    "wave": [("py", "    spb = 1 if tiles <= MAX_SPLIT_TILES else n_splits",
              "    spb = 1 if tiles <= MAX_SPLIT_TILES or (\n"
              "        D in MLA_DIMS and tiles * B * Hkv * n_splits <= 132) else n_splits")],
    "wave128": [("py", "    spb = 1 if tiles <= MAX_SPLIT_TILES else n_splits",
                 "    spb = 1 if tiles <= MAX_SPLIT_TILES or (\n"
                 "        D in MLA_DIMS and tiles * B * Hkv * n_splits <= 132) else n_splits"),
                ("py", "    split = split_tokens(S)\n    n_splits",
                 "    split = split_tokens(S) if D not in MLA_DIMS else S * -(-128 // S)\n"
                 "    n_splits")],
    "nocopy": [("      for (int c = lane; c < kc; c += 32)\n        cp_async16(kd",
                "      for (int c = lane; c < 0; c += 32)\n        cp_async16(kd"),
               ("      for (int c = lane; c < vc; c += 32)\n        cp_async16(vd",
                "      for (int c = lane; c < 0; c += 32)\n        cp_async16(vd")],
    "nos": [("        for (int j = 0; j < dk / 32; ++j) {",
             "        for (int j = 0; j < 0; ++j) {")],
    "nopv": [("          if (2 * dp < nt_w) {", "          if (false) {")],
}
DIAGNOSTIC = {"nocopy", "nos", "nopv"}


def make(name: str) -> str:
    """A patched copy of the package; the checkout root to import it from."""
    root = os.path.join(PKG, "_build", "variants", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, os.path.join(root, "qspec_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for patch in VARIANTS[name]:
        f, old, new = patch if len(patch) == 3 else ("cu", *patch)
        path = os.path.join(root, "qspec_tpu_torch", *(("csrc", "paged_attention.cu")
                                                       if f == "cu" else
                                                       ("ops", "attention_cuda.py")))
        src = open(path).read()
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: the patch does not apply: {old!r}")
        open(path, "w").write(src.replace(old, new))
    return root


def child(root: str, check: bool) -> None:
    """Build root's paged_attention.cu, check, time; one JSON line."""
    sys.path.insert(0, root)
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke_main",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from qspec_tpu_torch import _build
    if not _build.__file__.startswith(root + os.sep):
        raise SystemExit(f"{root} holds no qspec_tpu_torch")
    _build.SOURCES = ("w4.cu", "paged_attention.cu")     # w4.cu: qspec_error_string
    _build.SIGNATURES = {k: v for k, v in _build.SIGNATURES.items()
                         if k == "qspec_paged_attention"}
    _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if check:
        for kv in ("bfloat16", "int8"):
            for label, Hq, D, dk, dv, dqk in cs.MLA_ATTN:
                for q_len in (1, 4, 64):
                    inputs = cs._mla_inputs(gen, q_len, kv, Hq, D, dk, dv)
                    torch.testing.assert_close(
                        cs._mla_call(inputs, dqk, dk, dv).float(),
                        cs._mla_call(inputs, dqk, dk, dv, plain=True).float(),
                        rtol=cs.MLA_TOL[kv], atol=cs.MLA_TOL[kv])
        torch.cuda.empty_cache()
    ms = {}
    cases = [(a, kv, 4) for kv in ("bfloat16", "int8") for a in cs.MLA_ATTN]
    cases.append((cs.MLA_ATTN[1], "bfloat16", 1))
    for (label, Hq, D, dk, dv, dqk), kv, q_len in cases:
        rot = cs.Rotating(lambda: cs._mla_inputs(gen, q_len, kv, Hq, D, dk, dv),
                          sum(cs._ctx_lens(q_len)) * 2 * D * 2)
        ms[f"{label} {kv} Q={q_len}"] = cs.graph_ms(
            lambda: cs._mla_call(rot.next(), dqk, dk, dv), reps=max(20, len(rot.sets)))
        del rot
        torch.cuda.empty_cache()
    regs = {cs._kernel_name(k): [v.get("regs"), v.get("spill_stores", 0)]
            for k, v in _build.build_info.get("ptxas", {}).items() if "mla" in k}
    print(json.dumps({"root": root, "checked": check, "ms": ms, "ptxas_regs_spills": regs},
                     separators=(",", ":")), flush=True)


def main(names) -> None:
    for n in names:
        if n not in VARIANTS:
            raise SystemExit(f"unknown variant {n}; one of {', '.join(VARIANTS)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    roots = {"base": ROOT, **{n: make(n) for n in names}}
    runs = []
    for n in ("base", *names, "base"):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", roots[n],
                              "0" if n in DIAGNOSTIC else "1"],
                             check=True, stdout=subprocess.PIPE, text=True).stdout
        line = out.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append((n, json.loads(line)["ms"]))
    shapes = list(runs[0][1])
    print("ms: " + " | ".join(["variant", *shapes]))
    for n, ms in runs:
        print(" | ".join([n, *(f"{ms[s]:.5f}" for s in shapes)]))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], sys.argv[3] == "1")
    else:
        main(sys.argv[1:] or list(VARIANTS))
