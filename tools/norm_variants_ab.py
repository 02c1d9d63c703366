"""csrc/rmsnorm.cu's launch and block-shape choices timed against each other
on one card.

    python3 tools/norm_variants_ab.py [VARIANT ...]    # from the repository root

Each variant is a copy of qspec_tpu_torch under qspec_tpu_torch/_build/
variants/ (git-ignored) with a text patch of csrc/rmsnorm.cu, checked to
apply. The base (the package as it is) and each variant are built and timed
by a process of their own, in the order base, the variants, base; each
builds csrc/rmsnorm.cu and csrc/w4.cu alone. A process first holds its norm
kernels to their plain versions (tests/test_torch_gpu.py's tolerances, h
bit for bit), then times, with chip_smoke's inputs and CUDA events over
CUDA-graph replays: the norms at chip_smoke.NORM_TIMED alone and with the
residual add, and the norm between two GEMMs as the forward runs it (the
fused norm, then the qkv GEMM of one Llama-3-8B layer, its weights rotated
past L2; the median of three timings): rmsnorm_quant then matmul_w4a4 at
M = 4 (4 bits), 8 (8 bits, the backfill step) and the draft prefill's 1024,
rmsnorm then matmul_w4a16 at M = 16 and 60. It prints the card's name and
power limit, one JSON line per run and a table of ms.

Variants (all by default):
  early   griddepcontrol.launch_dependents once the loads are issued, not
          after the stores (the next kernel's blocks launch beside the norm's)
  notrig  no griddepcontrol.launch_dependents: the next kernel launches as
          the norm's blocks exit
  nopdl   launched without the programmatic dependent launch
  t512    blocks of up to 512 threads: one vector a thread at H = 4096
          (512 x 1) and 3584 (448 x 1), not 256 x 2 and 224 x 2
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "qspec_tpu_torch")

VARIANTS = {
    "early": [("\n  float ss = 0.f;", "  launch_dependents();\n\n  float ss = 0.f;"),
              ("  launch_dependents();\n}\n\n// A yardstick", "}\n\n// A yardstick")],
    "notrig": [("  launch_dependents();\n}\n\n// A yardstick", "}\n\n// A yardstick")],
    "nopdl": [("  attr[0].val.programmaticStreamSerializationAllowed = 1;",
               "  attr[0].val.programmaticStreamSerializationAllowed = 0;")],
    "t512": [("constexpr int kMaxThreads = 256;", "constexpr int kMaxThreads = 512;")],
}
# the norm, then the GEMM it feeds: (label, norm, M, bits, GEMM)
CHAINS = (("quant4_m4_w4a4", "rmsnorm_quant", 4, 4, "matmul_w4a4"),
          ("quant8_m8_w4a4", "rmsnorm_quant", 8, 8, "matmul_w4a4"),
          ("quant4_m1024_w4a4", "rmsnorm_quant", 1024, 4, "matmul_w4a4"),
          ("rmsnorm_m16_w4a16", "rmsnorm", 16, None, "matmul_w4a16"),
          ("rmsnorm_m60_w4a16", "rmsnorm", 60, None, "matmul_w4a16"))
CHAIN_REPEATS = 3       # each chain timed this many times; the median kept


def make(name: str) -> str:
    """A patched copy of the package; the checkout root to import it from."""
    root = os.path.join(PKG, "_build", "variants", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, os.path.join(root, "qspec_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(root, "qspec_tpu_torch", "csrc", "rmsnorm.cu")
    src = open(path).read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: the patch does not apply: {old!r}")
        src = src.replace(old, new)
    open(path, "w").write(src)
    return root


def child(root: str) -> None:
    """Build root's csrc/rmsnorm.cu and csrc/w4.cu, check the norms, time
    them and the chains; one JSON line."""
    sys.path.insert(0, root)
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs
    from qspec_tpu_torch import _build
    from qspec_tpu_torch.ops import linear_kernels as lk
    if not _build.__file__.startswith(root + os.sep):
        raise SystemExit(f"{root} holds no qspec_tpu_torch")
    _build.SOURCES = ("rmsnorm.cu", "w4.cu")
    _build.SIGNATURES = {k: v for k, v in _build.SIGNATURES.items()
                         if k in ("qspec_w4a16", "qspec_w4a4", "qspec_rmsnorm",
                                  "qspec_rmsnorm_quant", "qspec_norm_launch_floor")}
    _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, m, h, bits, gamma in cs.NORM_TIMED:
        x, r = cs._norm_set(gen, m, h)
        g = cs._gamma(gen, h) if gamma else None
        got, want = cs.norm_fn(name, bits, g)(x, r), cs.norm_fn(name, bits, g, True)(x, r)
        if not torch.equal(got[-1], x + r):
            raise SystemExit(f"{root}: h is not x + r")
        if name == "rmsnorm_quant":
            torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=0)
            d = (got[0].int() - want[0].int()).abs()
            if d.max().item() > 1 or (d == 0).float().mean().item() <= 0.99:
                raise SystemExit(f"{root}: rmsnorm_quant values differ")
        else:
            torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2e-2, atol=2e-2)
    ms = cs.ab_norms_ms()
    k, n = cs.GEMM_SHAPES[0]
    for label, norm, m, bits, gemm in CHAINS:
        rot = cs.Rotating(lambda: cs._w4(gen, k, n), k * n // 2 + 4 * n)
        x, r = cs._norm_set(gen, m, k)
        fn = cs.norm_fn(norm, bits, None)

        def chain():
            out = fn(x, r)
            if gemm == "matmul_w4a4":
                lk.matmul_w4a4(out[0], out[1], *rot.next())
            else:
                lk.matmul_w4a16(out[0], *rot.next())
        ms[f"chain_{label}"] = sorted(cs.graph_ms(chain, reps=max(20, len(rot.sets)))
                                      for _ in range(CHAIN_REPEATS))[CHAIN_REPEATS // 2]
        del rot
        torch.cuda.empty_cache()
    regs = {cs._kernel_name(k): [v.get("regs"), v.get("spill_stores", 0)]
            for k, v in _build.build_info.get("ptxas", {}).items() if "rmsnorm" in k}
    print(json.dumps({"root": root, "ms": ms, "ptxas_regs_spills": regs},
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
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", roots[n]],
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
        child(sys.argv[2])
    else:
        main(sys.argv[1:] or list(VARIANTS))
