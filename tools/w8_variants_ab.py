"""csrc/w8a16.cu's design choices timed against each other on one card.

    python3 tools/w8_variants_ab.py [VARIANT ...]    # from the repository root

Each variant is a copy of qspec_tpu_torch under qspec_tpu_torch/_build/
variants/ (git-ignored) with a text patch of csrc/w8a16.cu (and, where the
plan's unit or block rows change, of ops/linear_kernels.py), checked to
apply. The base (the package as it is) and each variant are built and timed
by a process of their own, in the order base, the variants, base; each
builds csrc/w4.cu and csrc/w8a16.cu alone. A process first holds its build
to the plain version (both weight types, M = 4, 60 and 100, rtol = atol =
2e-2; skipped by the diagnostics, whose results are wrong by design), then
times matmul_w8a16 at chip_smoke.W8_AB (kernel only: weights rotated past
L2, CUDA events over CUDA-graph replays) and counts, where the toolkit's
cuobjdump is found, the SASS instructions of the one-tile kernels per
weight: a thread decodes 64 weights a stage, so the kernel's static count
of each decode opcode over 64. It prints the card's name and power limit,
one JSON line per run and a table of ms per shape.

Variants (all by default):
  nopdl   launched without the programmatic dependent launch
  s3      a ring of up to 3 stages (the kernel: 4)
  s6      a ring of up to 6 stages (5 at four m16 tiles: the ring's 180 KB)
  k64     64-k stages (8 KB units), a ring of up to 8
  t2      2 m16 tiles a block (past 32 rows, whole mode in 32-row blocks)
  w256    256-column stripes (32 KB units), 8 N warps and no K split inside
          a block, a ring of up to 210 KB
  noevict the weight copies with an L2 evict_normal policy (the kernel:
          evict_first)
  dec23   the int8 decode of the first kernel: the byte, sign flipped, as
          the low mantissa byte of 2^23 in f32, less 2^23 + 128, then a
          bf16 pair (5.5 instructions a pair, against 4)
  nox     diagnostic: no activation copies
  nocomp  diagnostic: no compute (no decode, no MMA)
  stream  diagnostic: neither: the ring, the segments' flushes and folds
"""

from __future__ import annotations

import collections
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "qspec_tpu_torch")

DEC23 = ('''    // bytes 0 and 2 <- byte J of a and of b (1 and 3: copies, masked off)
    const uint32_t p = __byte_perm(a, b, J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12));
    uint32_t lo, hi, d;
    asm("lop3.b32 %0, %1, %2, %3, 0xEA;\\n"        // (p & 0x7F) | 0x4300: 128 + l
        : "=r"(lo) : "r"(p), "n"(0x007F007Fu), "r"(0x43004300u));
    asm("lop3.b32 %0, %1, %2, %3, 0xEA;\\n"        // (p & 0x80) | 0xC300: -(128 + 128 s)
        : "=r"(hi) : "r"(p), "n"(0x00800080u), "r"(0xC300C300u));
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\\n"         // l - 128 s, exactly
        : "=r"(d) : "r"(lo), "r"(0x3F803F80u), "r"(hi));
    return d;''', '''\
    const uint32_t c = 0x4B000000u, sel = 0x7540u | J;   // 2^23 + the biased byte
    const float lo = __uint_as_float(__byte_perm(a ^ 0x80808080u, c, sel)) - 8388736.0f;
    const float hi = __uint_as_float(__byte_perm(b ^ 0x80808080u, c, sel)) - 8388736.0f;
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);''')
NOX = ("      cp_async16(dst + row * kXStride, p, ok ? 16 : 0);",
       "      if (false) cp_async16(dst + row * kXStride, p, ok ? 16 : 0);")
NOCOMP = ("    compute_stage<kFp8, MT>(smem + (i % kStages) * sbytes,",
          "    if (false) compute_stage<kFp8, MT>(smem + (i % kStages) * sbytes,")
VARIANTS = {
    "nopdl": [("attr[0].val.programmaticStreamSerializationAllowed = 1;",
               "attr[0].val.programmaticStreamSerializationAllowed = 0;"),
              ('  asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n', "")],
    "s3": [("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 3;")],
    "s6": [("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 6;")],
    "k64": [("constexpr int kStageK = 128; ", "constexpr int kStageK = 64;  "),
            ("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 8;"),
            ("lk", "W8_STAGE_K = 128\n", "W8_STAGE_K = 64\n")],
    "t2": [("constexpr int kMaxTiles = 4; ", "constexpr int kMaxTiles = 2; "),
           ("lk", "W8_BLOCK_ROWS = 64\n", "W8_BLOCK_ROWS = 32\n")],
    "w256": [("constexpr int kWarpsN = 4;", "constexpr int kWarpsN = 8;"),
             ("constexpr int kRingBytes = 180 * 1024;", "constexpr int kRingBytes = 210 * 1024;"),
             ("lk", "W8_COLS = 128\n", "W8_COLS = 256\n")],
    "noevict": [("createpolicy.fractional.L2::evict_first.b64",
                 "createpolicy.fractional.L2::evict_normal.b64")],
    "dec23": [DEC23],
    "nox": [NOX],
    "nocomp": [NOCOMP],
    "stream": [NOX, NOCOMP],
}
DIAGNOSTIC = {"nox", "nocomp", "stream"}
# the SASS opcodes of the decode and the products
OPCODES = ("PRMT", "LOP3", "HFMA2", "F2FP", "F2F", "FADD", "HADD2", "HMMA", "LDS", "LDSM")


def make(name: str) -> str:
    """A patched copy of the package; the checkout root to import it from."""
    root = os.path.join(PKG, "_build", "variants", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, os.path.join(root, "qspec_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for patch in VARIANTS[name]:
        f, old, new = patch if len(patch) == 3 else ("cu", *patch)
        path = os.path.join(root, "qspec_tpu_torch", *(("csrc", "w8a16.cu") if f == "cu"
                                                       else ("ops", "linear_kernels.py")))
        src = open(path).read()
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: the patch does not apply: {old!r}")
        open(path, "w").write(src.replace(old, new))
    return root


def sass_counts(lib: str) -> dict:
    """{kernel: {opcode: count / 64}} of the one-tile split-mode kernels
    (w8a16_kernel<fp8, 1, N % 16 == 0, split>), from cuobjdump -sass; {}
    where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True).stdout
    out, fn, counts = {}, None, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "w8a16_kernel" in m.group(1) else None
            counts = collections.Counter() if fn else None
            if fn:
                out[fn] = counts
            continue
        if counts is not None:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1).split(".")[0]] += 1
    return out


def child(root: str, check: bool) -> None:
    """Build root's w4.cu and w8a16.cu, check, time W8_AB; one JSON line."""
    sys.path.insert(0, root)
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke_main",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from qspec_tpu_torch import _build
    from qspec_tpu_torch.ops import linear_kernels as lk
    if not _build.__file__.startswith(root + os.sep):
        raise SystemExit(f"{root} holds no qspec_tpu_torch")
    _build.SOURCES = ("w4.cu", "w8a16.cu")
    _build.SIGNATURES = {k: v for k, v in _build.SIGNATURES.items()
                         if k in ("qspec_w4a16", "qspec_w4a4", "qspec_w8a16", "qspec_w8a16_fp8")}
    lib = str(_build.build())
    _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if check:
        for kind in ("int8", "fp8"):
            for k, n in ((4096, 4096), (14336, 4096), (448, 200), (4096, 128256)):
                qw, qs = cs._w8_trunk_weights(gen, k, n, kind)
                for m in (4, 60, 100):
                    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
                    torch.testing.assert_close(
                        lk.matmul_w8a16(x, qw, qs, out_dtype=torch.float32),
                        lk.matmul_w8a16_ref(x, qw, qs, out_dtype=torch.float32),
                        rtol=2e-2, atol=2e-2)
                del qw, qs
        torch.cuda.empty_cache()
    ms = {}
    for label, shapes, m, kind in cs.W8_AB:
        per = cs.w8_ms(gen, shapes, m, kind)
        ms[label] = [sum(per), per]
    regs = {cs._kernel_name(k): [v.get("regs"), v.get("spill_stores", 0)]
            for k, v in _build.build_info.get("ptxas", {}).items() if "w8a16" in k}
    sass = {cs._kernel_name(k): {op: round(c[op] / 64, 3) for op in OPCODES if c[op]}
            for k, c in sass_counts(lib).items()
            if re.search(r"w8a16_kernel<[01],1,1,0>", cs._kernel_name(k))}
    print(json.dumps({"root": root, "checked": check, "ms": ms, "ptxas_regs_spills": regs,
                      "sass_per_weight": sass}, separators=(",", ":")), flush=True)


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
        print(" | ".join([n, *(f"{ms[s][0]:.5f}" for s in shapes)]))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], sys.argv[3] == "1")
    else:
        main(sys.argv[1:] or list(VARIANTS))
