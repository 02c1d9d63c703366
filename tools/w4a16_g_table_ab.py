"""The grouped GEMM's two dequant candidates, timed against each other on one
card.

    python3 tools/w4a16_g_table_ab.py        # from the repository root

`qspec_tpu_torch/csrc/w4a16_g.cu` dequantizes each weight in registers:
the nibble made an exact float (one LOP3, one FADD), then the f32 product
and difference and a bf16x2 pack. The other candidate looks the value up in
a table of the 16 possible bf16 values per (group, column), built in shared
memory by each warp for its 32 columns when a stage's group changes (one
FMUL, FSUB and cvt per entry). This script builds the kernel as it is and a
copy whose dequant is replaced by that table (a text patch of the source,
checked to apply), holds the table build's output to the kernel's bit for
bit (both compute the same bf16 weights), and times one Llama-3-8B layer's
four grouped projections (g = 128, weights rotated past L2, CUDA events
over CUDA-graph replays) at M = 4 and 16, the two builds in turns A B B A.
It prints the card's name and power limit and one JSON line of times.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))
GROUP = 128

# the table: per warp, per plane, per q, the warp's 32 columns (bf16 bits),
# rebuilt when the stage's group slot changes
TABLE_BUILD = '''      slot_loaded = slot;
      __syncwarp();
      {
        const float* sw = so_s - col + (warp % kWarpsN) * 8 * kNT + slot * 4 * kBN;
        const float s0 = sw[lane], o0 = sw[kBN + lane];
        const float s1 = sw[2 * kBN + lane], o1 = sw[3 * kBN + lane];
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          table[warp][0][q][lane] = __bfloat16_as_ushort(__float2bfloat16_rn(deq(q, s0, o0)));
          table[warp][1][q][lane] = __bfloat16_as_ushort(__float2bfloat16_rn(deq(q, s1, o1)));
        }
      }
      __syncwarp();'''
TABLE_LOOKUP = '''      const uint16_t* tl = &table[warp][0][0][4 * (lane >> 2) + j];
      const uint16_t* th = &table[warp][1][0][4 * (lane >> 2) + j];
      const uint32_t bl0 = tl[32 * (u & 0xF)] | (uint32_t)tl[32 * ((u >> 8) & 0xF)] << 16;
      const uint32_t bl1 = tl[32 * (v & 0xF)] | (uint32_t)tl[32 * ((v >> 8) & 0xF)] << 16;
      const uint32_t bh0 = th[32 * ((u >> 4) & 0xF)] | (uint32_t)th[32 * ((u >> 12) & 0xF)] << 16;
      const uint32_t bh1 = th[32 * ((v >> 4) & 0xF)] | (uint32_t)th[32 * ((v >> 12) & 0xF)] << 16;
'''


def table_source(src: str) -> str:
    """The kernel source with its dequant replaced by the table lookup."""
    head = "  int slot_loaded = 0;\n"
    assert src.count(head) == 1 and src.count("      slot_loaded = slot;") == 1
    src = src.replace(head, "  __shared__ uint16_t table[kThreads / 32][2][16][32];\n" + head)
    src = src.replace("      slot_loaded = slot;", TABLE_BUILD)
    start = src.index("      // low plane at bits 0 and 8")
    end = src.index("#pragma unroll\n      for (int mi = 0; mi < MT; ++mi) {\n        mma_bf16")
    return src[:start] + TABLE_LOOKUP + src[end:]


def build(name: str, src: str, out_dir: str, nvcc: str, arch) -> ctypes.CDLL:
    cu = os.path.join(out_dir, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(out_dir, f"{name}.so")
    log = subprocess.run([nvcc, *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                          "-Xptxas", "-v", "-o", so, cu], capture_output=True, text=True)
    if log.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{log.stdout}{log.stderr}")
    lib = ctypes.CDLL(so)
    return lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("w4a16_g_table_ab: no CUDA device")
    import chip_smoke as cs
    from qspec_tpu_torch import _build
    from qspec_tpu_torch.ops import linear_kernels as lk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    main_lib = _build.lib()
    out_dir = os.path.join(ROOT, "qspec_tpu_torch", "_build", "dequant_ab")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(ROOT, "qspec_tpu_torch", "csrc", "w4a16_g.cu")) as f:
        src = f.read()
    nvcc = _build._nvcc()
    libs = {"arith": build("arith", src, out_dir, nvcc, _build.ARCH),
            "table": build("table", table_source(src), out_dir, nvcc, _build.ARCH)}
    for lib in libs.values():
        lib.qspec_w4a16_g.argtypes = _build.SIGNATURES["qspec_w4a16_g"]
        lib.qspec_w4a16_g.restype = ctypes.c_int

    class Lib:        # the wrapper's library with one kernel swapped
        def __init__(self, fn):
            self.qspec_w4a16_g = fn
            self.qspec_error_string = main_lib.qspec_error_string

    def use(name):
        _build._lib = Lib(libs[name].qspec_w4a16_g)

    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    for m in (4, 16):
        tot = {"arith": [], "table": []}
        for k, n in SHAPES:
            rot = cs.Rotating(lambda k=k, n=n: cs._w4g(gen, k, n), k * n // 2 + (k // GROUP) * n * 8)
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            outs = {}
            for name in libs:
                use(name)
                outs[name] = lk.matmul_w4a16_g(x, *rot.sets[0], out_dtype=torch.float32)
            if not torch.equal(outs["arith"], outs["table"]):
                raise SystemExit(f"K={k} N={n} M={m}: the table's bits differ")
            for name in ("arith", "table", "table", "arith"):
                use(name)
                tot[name].append(cs.graph_ms(lambda: lk.matmul_w4a16_g(x, *rot.next()),
                                             reps=max(20, len(rot.sets))))
            del rot
            torch.cuda.empty_cache()
        # per build: the layer's sum over the projections, both turns
        times[f"m{m}"] = {name: [sum(v[0::2]), sum(v[1::2])] for name, v in tot.items()}
    _build._lib = main_lib
    print(json.dumps({"card": smi, "layer_ms": times}), flush=True)


if __name__ == "__main__":
    main()
