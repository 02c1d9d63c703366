"""csrc/w4.cu's design choices timed against each other on one card.

    python3 tools/w4_variants_ab.py [VARIANT ...]    # from the repository root

Each variant is a copy of qspec_tpu_torch under qspec_tpu_torch/_build/
variants/ (git-ignored) with a text patch of csrc/w4.cu (and, where the
plan's unit changes, of ops/linear_kernels.py), checked to apply. The base
(the package as it is) and each variant are built and timed by a process of
their own, in the order base, the variants, base; each builds csrc/w4.cu
alone. A process first holds its build to the plain versions (w4a4 bit for
bit, w4a16 within rtol = atol = 2e-2; skipped by the diagnostics, whose
results are wrong by design), then times matmul_w4a16 and matmul_w4a4 at
chip_smoke.W4_TIMED (kernel only: weights rotated past L2, CUDA events over
CUDA-graph replays). It prints the card's name and power limit, one JSON
line per run and a table of ms per Llama-3-8B layer (the int4 head alone).

Variants (all by default):
  nopdl   launched without the programmatic dependent launch
  r16     16-row stages (64 k of each plane), a ring of up to 16 of them
  s6      a ring of up to 6 stages (the kernel: 4)
  nox     diagnostic: no activation copies
  nocomp  diagnostic: no compute (no decode, no MMA)
  stream  diagnostic: neither: the ring, the segments' flushes and folds
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "qspec_tpu_torch")

NOX = ("w4.cu", "      if (row < 16 * MT) {", "      if (false && row < 16 * MT) {")
NOCOMP = ("w4.cu", "    compute_stage<kInt8, MT>(smem + (i % kStages) * sbytes,",
          "    if (false) compute_stage<kInt8, MT>(smem + (i % kStages) * sbytes,")
VARIANTS = {
    "nopdl": [("w4.cu", "  attr[0].val.programmaticStreamSerializationAllowed = 1;",
               "  attr[0].val.programmaticStreamSerializationAllowed = 0;"),
              ("w4.cu", '  asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n', "")],
    "r16": [("w4.cu", "constexpr int kStageRows = 32;", "constexpr int kStageRows = 16;"),
            ("w4.cu", "constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 16;"),
            ("lk", "W4_STAGE_K = 256\n", "W4_STAGE_K = 128\n")],
    "s6": [("w4.cu", "constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 6;")],
    "nox": [NOX],
    "nocomp": [NOCOMP],
    "stream": [NOX, NOCOMP],
}
DIAGNOSTIC = {"nox", "nocomp", "stream"}


def make(name: str) -> str:
    """A patched copy of the package; the checkout root to import it from."""
    root = os.path.join(PKG, "_build", "variants", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, os.path.join(root, "qspec_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for f, old, new in VARIANTS[name]:
        path = os.path.join(root, "qspec_tpu_torch", *(("csrc", "w4.cu") if f == "w4.cu"
                                                       else ("ops", "linear_kernels.py")))
        src = open(path).read()
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: the patch does not apply: {old!r}")
        open(path, "w").write(src.replace(old, new))
    return root


def child(root: str, check: bool) -> None:
    """Build root's csrc/w4.cu, check it, time W4_TIMED; one JSON line."""
    sys.path.insert(0, root)
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs
    from qspec_tpu_torch import _build
    from qspec_tpu_torch.ops import linear_kernels as lk
    from qspec_tpu_torch.ops.quant import sym_quant_int8
    if not _build.__file__.startswith(root + os.sep):
        raise SystemExit(f"{root} holds no qspec_tpu_torch")
    _build.SOURCES = ("w4.cu",)
    _build.SIGNATURES = {k: v for k, v in _build.SIGNATURES.items()
                         if k in ("qspec_w4a16", "qspec_w4a4")}
    _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if check:
        for k, n in ((4096, 4096), (14336, 4096), (448, 200)):
            qw, qs = cs._w4(gen, k, n)
            for m in (4, 60, 100):
                x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
                xq = sym_quant_int8(x)
                if not torch.equal(lk.matmul_w4a4(xq.values, xq.scales, qw, qs),
                                   lk.matmul_w4a4_ref(xq.values, xq.scales, qw, qs)):
                    raise SystemExit(f"{root}: w4a4 differs from its plain version")
                torch.testing.assert_close(lk.matmul_w4a16(x, qw, qs).float(),
                                           lk.matmul_w4a16_ref(x, qw, qs).float(),
                                           rtol=2e-2, atol=2e-2)
    ms = {}
    for name, m, key in cs.W4_TIMED:
        r = cs.time_w4_layer(gen, name, m, head=key == "head", plain=False, library=False)
        ms[f"{name[7:]}_m{m}" + ("_head" if key == "head" else "")] = [r["ms"], r["per"]]
    regs = {cs._kernel_name(k): [v.get("regs"), v.get("spill_stores", 0)]
            for k, v in _build.build_info.get("ptxas", {}).items()}
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
    print("ms per layer: " + " | ".join(["variant", *shapes]))
    for n, ms in runs:
        print(" | ".join([n, *(f"{ms[s][0]:.5f}" for s in shapes)]))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], sys.argv[3] == "1")
    else:
        main(sys.argv[1:] or list(VARIANTS))
