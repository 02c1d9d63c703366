"""The host side of the QuaRot int4 GEMMs' kernel (csrc/w4.cu) on the CPU.

The kernel cuts a weight's (128-column stripe, 256-k stage) units into
equal runs, one a block (stream-K), and adds each stripe's pieces in block
order. The planner (``w4_workers``, ``w4_runs``, ``w4_segments``), the plain
PyTorch model of that order (``matmul_w4_split_ref``) and the wrappers'
checks are Python, and are tested here: over every projection and head of
the model configurations in the repo (the port's and the JAX package's), at
the SM counts of an H100 SXM and PCIe, the runs give every SM work in equal
shares, cover K exactly once per stripe and do not depend on M; the
grouped GEMM's planner ``w4g_splits`` returns what it returned before this
kernel; the split-then-fold model equals the plain versions (w4a16 to 1e-5
in f32, w4a4 bit for bit) and the JAX kernels in interpret mode at the JAX
kernel tests' tolerances (w4a16 rtol / atol 2e-2, w4a4 1e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu import config as jconfig
from qspec_tpu.ops import quant as jq
from qspec_tpu.ops.linear_kernels import matmul_w4a4 as j_w4a4
from qspec_tpu.ops.linear_kernels import matmul_w4a16 as j_w4a16
from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.ops import linear_kernels as lk
from qspec_tpu_torch.ops import packing as tpk

# SMs of an H100 SXM (and H200) and of an H100 PCIe
SM_COUNTS = (132, 114)

J = jconfig.ModelConfig
CONFIGS = {
    "llama3-8b": ModelConfig.llama3_8b(),
    "gemma2-9b": ModelConfig.gemma2_9b(),
    "tiny": ModelConfig.tiny(),
    "llama3-70b": J.llama3_70b(),
    "qwen2-7b": J.qwen2_7b(),
    "gemma-7b": J.gemma_7b(),
    "gemma-2b": J.gemma_2b(),
    "mixtral-8x7b": J.mixtral_8x7b(),
}


def _shapes(cfg) -> dict:
    """(K, N) of each projection and of the (int4) head."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    return {"qkv": (H, cfg.qkv_out), "o": (cfg.q_size, H), "gate_up": (H, 2 * I),
            "down": (I, H), "head": (H, cfg.vocab_size)}


SHAPES = sorted({kn for cfg in CONFIGS.values() for kn in _shapes(cfg).values()})

# w4g_splits(K, N, 132), w4g_splits(K, N, 114) for every shape above, as
# csrc/w4a16_g.cu's planner returned them before csrc/w4.cu was added
W4G_SPLITS = {
    (256, 256): (2, 2), (256, 512): (2, 2), (256, 896): (2, 2), (448, 256): (3, 3),
    (2048, 2048): (9, 8), (2048, 2560): (7, 6), (2048, 32768): (1, 1),
    (2048, 256000): (1, 1), (3072, 12288): (4, 2), (3072, 49152): (1, 1),
    (3072, 256000): (1, 1), (3584, 3584): (7, 7), (3584, 4608): (7, 6), (3584, 8192): (4, 3),
    (3584, 28672): (1, 1), (3584, 37888): (2, 1), (3584, 152064): (1, 1),
    (3584, 256000): (1, 1), (4096, 3072): (8, 8), (4096, 3584): (8, 8), (4096, 4096): (8, 7),
    (4096, 6144): (5, 4), (4096, 28672): (1, 1), (4096, 32000): (1, 2),
    (4096, 128256): (1, 1), (8192, 8192): (4, 5), (8192, 10240): (3, 4),
    (8192, 57344): (2, 1), (8192, 128256): (1, 1), (14336, 3584): (9, 8),
    (14336, 4096): (8, 7), (16384, 2048): (16, 13), (18944, 3584): (9, 8),
    (24576, 3072): (11, 9), (28672, 8192): (4, 7),
}


# the MoE presets' shapes that the dense configurations above lack, apart so
# that W4G_SPLITS stays as it was: Qwen1.5-MoE-A2.7B's experts (gate_up N =
# 2816; down K = 1408, whose last 256-k stage is half full), shared expert,
# qkv with its bias and int8 head's (K, N), and Qwen3-30B-A3B's experts (K =
# 768); Mixtral-8x7B's experts are the dense 8x7B widths above
EXPERT_SHAPES = [(2048, 2816), (1408, 2048), (2048, 11264), (5632, 2048), (2048, 6144),
                 (2048, 151936), (2048, 1536), (768, 2048)]


def test_shapes_cover_the_presets_and_the_kernel_takes_them():
    """Every projection and head of these configurations (the Llama-3-8B
    int4 head at N = 128256 among them) is one the kernel takes: K a
    multiple of 32 and under 2^17."""
    assert len(SHAPES) >= 30 and (4096, 128256) in SHAPES
    assert set(SHAPES) == set(W4G_SPLITS)
    for k, n in SHAPES + EXPERT_SHAPES:
        assert k % 32 == 0 and k < 2 ** 17, (k, n)


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("k,n", SHAPES)
def test_runs_fill_the_card_in_equal_shares(k, n, n_sm):
    """min(SMs, units) runs, one a block, none empty, no two more than one
    unit apart; together they cover the units once, in order."""
    units = -(-n // lk.W4_COLS) * -(-k // lk.W4_STAGE_K)
    runs = lk.w4_runs(k, n, n_sm)
    assert len(runs) == lk.w4_workers(k, n, n_sm) == min(n_sm, units)
    lengths = [b - a for a, b in runs]
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1
    assert runs[0][0] == 0 and runs[-1][1] == units
    assert all(runs[i][1] == runs[i + 1][0] for i in range(len(runs) - 1))


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("k,n", SHAPES + EXPERT_SHAPES)
def test_segments_cover_k_once_per_stripe(k, n, n_sm):
    """Each stripe's segments, in the order the kernel adds them, tile the
    k of a plane [0, K/2) exactly once; a stripe is cut only where a run
    ends."""
    segs = lk.w4_segments(k, n, n_sm)
    assert len(segs) == -(-n // lk.W4_COLS)
    half = lk.W4_STAGE_K // 2
    T = -(-k // lk.W4_STAGE_K)
    cuts = {b for _, b in lk.w4_runs(k, n, n_sm)}
    for s, pieces in enumerate(segs):
        covered = np.zeros(k // 2, np.int32)
        for i, (a, b) in enumerate(pieces):
            assert a < b and a % half == 0
            covered[a:b] += 1
            if i + 1 < len(pieces):
                assert s * T + b // half in cuts
        assert (covered == 1).all() and pieces[0][0] == 0 and pieces[-1][1] == k // 2


@pytest.mark.parametrize("k,n", [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                                 (4096, 128256), (448, 200), *EXPERT_SHAPES])
def test_plan_does_not_depend_on_m(k, n):
    """The runs are the same at every M (the draft's 4 and 8, the verify's
    16, the tree verify's 60, past one block's 64 rows, the prefill's 1024);
    only the mode changes past 64 rows, where no workspace is needed."""
    plans = {m: lk.w4_plan(m, k, n, 132) for m in (1, 4, 8, 16, 17, 60, 64, 65, 200, 1024)}
    assert len({p[0] for p in plans.values()}) == 1
    for m, (workers, whole, slots) in plans.items():
        assert whole == (m > 64)
        assert slots == (0 if whole else 2 * workers)


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("k,n", SHAPES)
def test_w4g_splits_unchanged(k, n, n_sm):
    assert lk.w4g_splits(k, n, n_sm) == W4G_SPLITS[(k, n)][SM_COUNTS.index(n_sm)]


# (M, K, N, SMs): stripes split across runs and runs across stripes, N not a
# multiple of 128 (nor, at 130, of 4), K not a multiple of the 256-k stage
# (448, 288, and Qwen1.5-MoE's expert down 1408), the whole mode's M past 64
SPLIT_CASES = [(4, 512, 384, 7), (16, 448, 200, 5), (60, 1024, 130, 13), (5, 256, 96, 132),
               (8, 2048, 640, 11), (70, 288, 256, 3), (16, 4096, 1024, 132),
               (16, 1408, 384, 7)]


def _weights(rng, k, n):
    qw, qs = tpk.quantize_weight_int4(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
    return torch.tensor(qw), torch.tensor(qs)


@pytest.mark.parametrize("m,k,n,n_sm", SPLIT_CASES)
def test_split_then_fold_w4a16(m, k, n, n_sm):
    """The kernel's order (segments rounded to f32, added in block order)
    within 1e-5 of the plain version, and within the JAX kernel test's 2e-2
    of JAX matmul_w4a16 (Pallas, interpret mode), bf16 and f32 out."""
    rng = np.random.default_rng(31)
    qw, qs = _weights(rng, k, n)
    xj = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    xt = torch.tensor(np.asarray(xj, np.float32)).to(torch.bfloat16)
    got = lk.matmul_w4_split_ref(xt, qw, qs, n_sm=n_sm, out_dtype=torch.float32)
    ref = lk.matmul_w4a16_ref(xt, qw, qs, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())
    jref = np.asarray(j_w4a16(xj, jnp.asarray(qw.numpy()), jnp.asarray(qs.numpy())), np.float32)
    bf = lk.matmul_w4_split_ref(xt, qw, qs, n_sm=n_sm)
    assert bf.dtype == torch.bfloat16 and tuple(bf.shape) == (m, n)
    np.testing.assert_allclose(bf.float().numpy(), jref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,n,n_sm", SPLIT_CASES)
def test_split_then_fold_w4a4(bits, m, k, n, n_sm):
    """Exact sums in any order: the kernel's order equals the plain version
    bit for bit, and JAX matmul_w4a4 (Pallas, interpret mode) within the JAX
    kernel test's 1e-2, on int4 and int8 activations."""
    rng = np.random.default_rng(32)
    qw, qs = _weights(rng, k, n)
    xj = jnp.asarray(rng.standard_normal((m, k)) * 2, jnp.bfloat16)
    jx = jq.sym_quant_int4(xj) if bits == 4 else jq.sym_quant_int8(xj)
    xq = torch.tensor(np.asarray(jx.values))
    sx = torch.tensor(np.asarray(jx.scales))
    got = lk.matmul_w4_split_ref(xq, qw, qs, sx, n_sm=n_sm)
    assert torch.equal(got, lk.matmul_w4a4_ref(xq, sx, qw, qs))
    jref = np.asarray(j_w4a4(jx.values, jx.scales, jnp.asarray(qw.numpy()),
                             jnp.asarray(qs.numpy())), np.float32)
    np.testing.assert_allclose(got.float().numpy(), jref, rtol=1e-2, atol=1e-2)


def test_split_then_fold_int4_head():
    """The int4 head's width (N = 128256, 1002 stripes) at a short K and
    M = 2: the plan of 132 runs (whole stripes and cut ones) against the
    plain version, f32 out; at K = 4096 most stripes are whole."""
    rng = np.random.default_rng(33)
    k, n, m = 512, 128256, 2
    w = torch.tensor(rng.integers(-8, 8, size=(k, n), dtype=np.int8))
    qw = tpk.pack_int4(w)
    qs = torch.tensor(rng.uniform(0.001, 0.01, size=n).astype(np.float32))
    x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    got = lk.matmul_w4_split_ref(x, qw, qs, n_sm=132, out_dtype=torch.float32)
    ref = lk.matmul_w4a16_ref(x, qw, qs, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())
    segs = lk.w4_segments(k, n, 132)
    assert {len(p) for p in segs} == {1, 2}
    segs = lk.w4_segments(4096, n, 132)
    assert sum(len(p) == 1 for p in segs) > 800 and max(len(p) for p in segs) == 2


@pytest.mark.parametrize("bad", ["x_dtype", "x_dim", "k32", "k_big", "w_shape", "w_dtype",
                                 "s_shape"])
def test_checks_refuse_what_the_kernel_does_not_take(bad):
    """The wrappers' checks on a call csrc/w4.cu would get (they run on
    CUDA tensors; here the checks themselves, on CPU tensors)."""
    k, n = 512, 256
    x = torch.zeros(4, k, dtype=torch.bfloat16)
    w = torch.zeros(k // 8, n, dtype=torch.int32)
    s = torch.ones(n)
    act, match = torch.bfloat16, None
    if bad == "x_dtype":
        x, match = x.float(), "activations"
    elif bad == "x_dim":
        x, match = x[None], "activations"
    elif bad == "k32":
        x, w = torch.zeros(4, 528, dtype=torch.bfloat16), torch.zeros(66, n, dtype=torch.int32)
        match = "multiple of 32"
    elif bad == "k_big":
        k = 2 ** 17
        x, w = torch.zeros(1, k, dtype=torch.bfloat16), torch.zeros(k // 8, 8, dtype=torch.int32)
        s, match = torch.ones(8), "131072"
    elif bad == "w_shape":
        w, match = torch.zeros(k // 4, n, dtype=torch.int32), "packed weights"
    elif bad == "w_dtype":
        w, match = w.to(torch.int64), "packed weights"
    else:
        s, match = torch.ones(n + 1), "scales"
    with pytest.raises(ValueError, match=match):
        lk._check_w4_call(x, w, s, act, "matmul_w4a16")


def test_checks_take_what_the_kernel_takes():
    for act, x in ((torch.bfloat16, torch.zeros(5, 448, dtype=torch.bfloat16)),
                   (torch.int8, torch.zeros(5, 448, dtype=torch.int8))):
        assert lk._check_w4_call(x, torch.zeros(56, 130, dtype=torch.int32), torch.ones(130),
                                 act, "w") == (5, 448, 130)
