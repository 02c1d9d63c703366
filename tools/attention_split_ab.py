"""The paged-attention kernel at other split sizes, timed against the shipped
one on one card.

    python3 tools/attention_split_ab.py      # from the repository root

`qspec_tpu_torch/csrc/paged_attention.cu` splits a sequence at every
`ops/attention_cuda.py:SPLIT_MIN` = 256 tokens (rounded up to whole pages).
A longer split means fewer blocks and fewer split states to fold, so fewer
heads and tails per byte at long contexts, but fewer blocks in flight at
short ones. This script copies the package once per split size (a text
patch of `SPLIT_MIN`, checked to apply; each copy builds its own kernels in
a process of its own) and times the kernel at chip_smoke.py's `AB_SHAPES`
(inputs rotated past L2, CUDA events over CUDA-graph replays), the copies in
turns A B C A B C. It prints the card's name and power limit and one JSON
line per copy and turn.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = (256, 512, 1024)
# the copies live in the package's (git-ignored) build directory
OUT = os.path.join(ROOT, "qspec_tpu_torch", "_build", "attention_split_ab")


def copy_with_split(split: int) -> str:
    """A copy of qspec_tpu_torch whose SPLIT_MIN is ``split``."""
    d = os.path.join(OUT, f"split{split}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "qspec_tpu_torch"), os.path.join(d, "qspec_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(d, "qspec_tpu_torch", "ops", "attention_cuda.py")
    src = open(path).read()
    if "\nSPLIT_MIN = 256\n" not in src:
        raise SystemExit("attention_split_ab: SPLIT_MIN = 256 not found; the patch does not apply")
    with open(path, "w") as f:
        f.write(src.replace("\nSPLIT_MIN = 256\n", f"\nSPLIT_MIN = {split}\n"))
    return d


def child(d: str) -> None:
    """Build the copy's kernels and time them at AB_SHAPES (one JSON line)."""
    sys.path.insert(0, d)
    import torch
    from qspec_tpu_torch import _build
    from qspec_tpu_torch.ops import attention_cuda
    if not _build.__file__.startswith(d + os.sep):
        raise SystemExit(f"attention_split_ab: {d} holds no qspec_tpu_torch")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms = {shape[0]: smoke.ab_attention_ms(gen, shape) for shape in smoke.AB_SHAPES}
    print(json.dumps({"split_min": attention_cuda.SPLIT_MIN, "ms": ms},
                     separators=(",", ":")), flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("attention_split_ab: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dirs = [copy_with_split(s) for s in SPLITS]
    for d in dirs + dirs:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", d], check=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        main()
