"""csrc/paged_attention.cu's MLA kernel (head dims 384 and 640) timed
against variants of itself on one card.

    python3 tools/mla_variants_ab.py [VARIANT ...]    # from the repository root

Each variant is a copy of qspec_tpu_torch under qspec_tpu_torch/_build/
variants/ (git-ignored) with text patches of csrc/paged_attention.cu (and of
ops/attention_cuda.py's plan), each checked to apply once. The base (the
package as it is) and each variant are built and timed by a process of
their own, in the order base, the variants, base; each builds
csrc/paged_attention.cu (and csrc/w4.cu, which holds the library's error
strings) alone. A process first holds its build to the plain version at
chip_smoke.MLA_ATTN (bf16 and int8 caches, Q = 1, 4 and 64,
chip_smoke.MLA_TOL; skipped by the diagnostics, whose results are wrong by
design), then times the kernel at MLA_ATTN's three groups at the n-gram
verify (B = 4, Q = 4, contexts 379 / 263 / 512 / 40) over bf16 and int8
caches, at DeepSeek-V2-Lite's decode (Q = 1) and at chip_smoke.MLA_LONG
tokens a sequence over bf16: inputs rotated past L2, CUDA events over
CUDA-graph replays (chip_smoke's time_mla_shapes). It prints the card's
name and power limit, one JSON line per run and a table of ms per shape.

Variants (all by default):
  ring2    a 2-stage TMA ring at D = 384 over bf16 (the kernel: 3)
  ring4    a 4-stage ring at D = 384 over bf16
  step32   32-token steps over every entry type, 4-stage bf16 rings at both
           head dims (the kernel: 64-token bf16 steps, 2 stages at 640, 3 at
           384)
  rows128  128 rows a block at D = 384: two row groups of 64, each one
           warpgroup owning its S, softmax and all 256 V lanes, over
           shared K stages (the kernel: 64 rows, two warpgroups splitting
           the step's tokens and V's lanes)
  vplane   bf16 reads V from the V plane, as int8 does (the kernel: from
           K's first lanes; 32-token steps at 640 and a 2-stage ring at 384,
           where K and V stages of 64 tokens do not fit otherwise)
  split256, split512, split1024
           MLA splits of 256, 512, 1024 tokens (the kernel: 128)
  splitg   MLA splits of 8 tokens per query head, 128 to 1024 (V2-Lite's 16
           heads: 128, MiniCPM3's 40: 320 -> 384, DeepSeek-V3's 128: 1024)
  nocopy   diagnostic: no KV copies (the stages' barriers complete empty)
  nos      diagnostic: no S products
  nopv     diagnostic: no P.V products
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

RING = ("  static constexpr int kRing = kD == 640 ? (kKind == 1 ? 4 : 2) : "
        "(kKind == 0 ? 3 : 2);")
STEP = ("  static constexpr int kStep = kD == 640 ? (kKind == 0 ? 64 : 32) : "
        "(kKind == 2 ? 32 : 64);")


def ring(at384: int, at640: int = 2) -> tuple:
    return (RING, RING.replace("(kKind == 1 ? 4 : 2) : (kKind == 0 ? 3 : 2)",
                               f"(kKind == 1 ? 4 : kKind == 0 ? {at640} : 2) : "
                               f"(kKind == 0 ? {at384} : 2)"))


VARIANTS = {
    "ring2": [ring(2)],
    "ring4": [ring(4)],
    "step32": [ring(4, 4), (STEP, STEP.replace("(kKind == 0 ? 64 : 32)", "32")
                                     .replace("(kKind == 2 ? 32 : 64)", "32"))],
    "rows128": [("  static constexpr int kKC = 5, kVC = 4, kRG = 1, kDS = 2;",
                 "  static constexpr int kKC = 5, kVC = 4, kRG = 2, kDS = 1;"),
                ("py", "MLA_ROWS = {384: 64, 640: 64}", "MLA_ROWS = {384: 128, 640: 64}")],
    "vplane": [("  static constexpr bool kVPlane = kKind == 2;",
                "  static constexpr bool kVPlane = kKind != 1;"),
               (STEP, STEP.replace("(kKind == 0 ? 64 : 32)", "32")), ring(2)],
    **{f"split{n}": [("py", "MLA_SPLIT_MIN = 128", f"MLA_SPLIT_MIN = {n}")]
       for n in (256, 512, 1024)},
    "splitg": [("py", "    split = split_tokens(S, D)\n",
                "    split = split_tokens(S, D) if D not in MLA_DIMS else \\\n"
                "        S * -(-min(1024, max(128, 8 * (Hq // Hkv))) // S)\n")],
    "nocopy": [("    mbar_expect_tx(full(st), L::kRawK + L::kRawV + L::kScl);",
                "    mbar_expect_tx(full(st), 0);"),
               ("    for (int r = 0; r < kN / box; ++r) {\n      const int krow = krows[r];",
                "    for (int r = 0; r < 0; ++r) {\n      const int krow = krows[r];")],
    "nos": [("      for (int ks = 0; ks < nks; ++ks) {", "      for (int ks = 0; ks < 0; ++ks) {")],
    "nopv": [("      for (int kt = 0; kt < kN / 16; ++kt)", "      for (int kt = 0; kt < 0; ++kt)")],
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
    cases = [(a, kv, 4, None) for kv in ("bfloat16", "int8") for a in cs.MLA_ATTN]
    cases.append((cs.MLA_ATTN[1], "bfloat16", 1, None))
    cases += [(a, "bfloat16", 4, (cs.MLA_LONG,) * 4) for a in cs.MLA_ATTN]
    for (label, Hq, D, dk, dv, dqk), kv, q_len, ctx in cases:
        ctx = ctx or cs._ctx_lens(q_len)
        rot = cs.Rotating(lambda: cs._mla_inputs(gen, q_len, kv, Hq, D, dk, dv, ctx=ctx),
                          sum(ctx) * 2 * D * 2)
        key = f"{label} {kv} Q={q_len}" + (f" ctx{ctx[0]}" if len(set(ctx)) == 1 else "")
        ms[key] = cs.graph_ms(
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
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", roots[n],
                               "0" if n in DIAGNOSTIC else "1"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        if proc.returncode != 0:   # a variant that does not build or check: say so, go on
            print(f"{n} failed ({proc.returncode}): " + proc.stderr.strip()[-2000:], flush=True)
            continue
        line = proc.stdout.strip().splitlines()[-1]
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
