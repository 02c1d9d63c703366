"""The host side of matmul_w8a16's kernel (csrc/w8a16.cu) on the CPU.

The kernel cuts a byte weight's (128-column stripe, 128-k stage) units into
equal runs, one a block (stream-K), and adds each stripe's pieces in block
order, as csrc/w4.cu does for int4. The planner (``w8_workers``,
``w8_runs``, ``w8_segments``, ``w8_plan``), the plain PyTorch model of that
order (``matmul_w8_split_ref``) and the wrapper's checks are Python, and
are tested here: over every trunk projection and quantized head of the
model configurations and families in the repo (the port's presets, the JAX
package's, and the published widths of the families the port loads), at
the SM counts of an H100 SXM and PCIe, the runs give every SM work in equal
shares, cover K exactly once per stripe and do not depend on M; the int4
planners (``w4_workers``, ``w4_runs``, ``w4_segments``, ``w4g_splits``)
return what they returned before this kernel; the split-then-fold model is
within f32 rounding of the plain version over int8 and float8_e4m3fn
weights, and within the JAX kernel test's 2e-2 of JAX matmul_w8a16 (its
Pallas body in interpret mode), plain and layer-stacked.
"""

import hashlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from qspec_tpu import config as jconfig
from qspec_tpu.ops.linear_kernels import matmul_w8a16 as j_w8a16
from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.ops import linear_kernels as lk

# SMs of an H100 SXM (and H200) and of an H100 PCIe
SM_COUNTS = (132, 114)

J = jconfig.ModelConfig
CONFIGS = {
    "llama3-8b": ModelConfig.llama3_8b(), "gemma2-9b": ModelConfig.gemma2_9b(),
    "tiny": ModelConfig.tiny(), "qwen15-moe": ModelConfig.qwen15_moe_a2_7b(),
    "mixtral-8x7b": ModelConfig.mixtral_8x7b(), "llama3-70b": ModelConfig.llama3_70b(),
    "qwen2-7b": ModelConfig.qwen2_7b(), "gemma-7b": ModelConfig.gemma_7b(),
    "gemma-2b": ModelConfig.gemma_2b(), "jax llama3-8b": J.llama3_8b(),
    "jax llama3-70b": J.llama3_70b(), "jax qwen2-7b": J.qwen2_7b(),
    "jax gemma-7b": J.gemma_7b(), "jax gemma-2b": J.gemma_2b(),
    "jax mixtral-8x7b": J.mixtral_8x7b(), "jax qwen15-moe": J.qwen15_moe_a2_7b(),
    "jax tiny": J.tiny(),
}

# the int8 heads (K, N) of the families the port loads, at their published
# widths, beside the presets' (Granite's 49155 columns padded at load to a
# multiple of 128)
FAMILY_HEADS = [(4096, 151936), (4096, 92544), (4096, 102400), (4096, 125696),
                (4096, 131072), (3584, 152064), (3072, 32064), (4096, 49280), (4096, 151552),
                (2560, 48000), (4096, 32000)]
# their trunk projections (qkv, o, gate_up, down) that the presets lack:
# Qwen-7B / Baichuan2-7B (MLP 11008), Qwen3-8B (12288), Granite-3.0-8B
# (12800), Phi-3-mini, Helium
FAMILY_TRUNK = [(4096, 12288), (4096, 22016), (11008, 4096), (4096, 24576), (12288, 4096),
                (4096, 25600), (12800, 4096), (3072, 9216), (3072, 3072), (3072, 16384),
                (8192, 3072), (2560, 7680), (2560, 2560), (2560, 14080), (7040, 2560)]


def _shapes(cfg) -> list:
    """(K, N) of each trunk projection (and MoE expert) and of the head."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    out = [(H, cfg.qkv_out), (cfg.q_size, H), (H, 2 * I), (I, H), (H, cfg.vocab_size)]
    if cfg.num_experts:
        E = cfg.expert_intermediate_size
        out += [(H, 2 * E), (E, H)]
    return out


SHAPES = sorted({kn for cfg in CONFIGS.values() for kn in _shapes(cfg)}
                | set(FAMILY_HEADS) | set(FAMILY_TRUNK))
HEAD_NS = {128256, 151936, 152064, 92544, 102400, 125696, 131072, 256000, 32000, 49280}

# sha256 of repr([(K, N, SMs, w4_workers, w4_runs, w4_segments, w4g_splits)
# for (K, N) in SHAPES with K % 256 == 0 for SMs in SM_COUNTS]), computed by
# the int4 planners as they were before csrc/w8a16.cu's planner was added
W4_PLANS_SHA256 = "b4c3a428c9e740138ad0c05d00fe6578f7541686902a58beeea297736623baad"


def test_shapes_cover_every_quantized_head_and_the_kernel_takes_them():
    """Every trunk projection and head above is one the kernel takes (K a
    multiple of 16, N of 8), and the heads of the presets and families are
    all there."""
    assert HEAD_NS <= {n for _, n in SHAPES}
    assert len(SHAPES) >= 50
    for k, n in SHAPES:
        assert k % 16 == 0 and n % 8 == 0, (k, n)


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("k,n", SHAPES)
def test_runs_fill_the_card_in_equal_shares(k, n, n_sm):
    """min(SMs, units) runs, one a block, none empty, no two more than one
    unit apart; together they cover the units once, in order."""
    units = -(-n // lk.W8_COLS) * -(-k // lk.W8_STAGE_K)
    runs = lk.w8_runs(k, n, n_sm)
    assert len(runs) == lk.w8_workers(k, n, n_sm) == min(n_sm, units)
    if units >= n_sm:
        assert len(runs) == n_sm           # every SM gets work
    lengths = [b - a for a, b in runs]
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1
    assert runs[0][0] == 0 and runs[-1][1] == units
    assert all(runs[i][1] == runs[i + 1][0] for i in range(len(runs) - 1))


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("k,n", SHAPES)
def test_segments_cover_k_once_per_stripe(k, n, n_sm):
    """Each stripe's segments, in the order the kernel adds them, tile
    [0, K) exactly once; a stripe is cut only where a run ends."""
    segs = lk.w8_segments(k, n, n_sm)
    assert len(segs) == -(-n // lk.W8_COLS)
    T = -(-k // lk.W8_STAGE_K)
    cuts = {b for _, b in lk.w8_runs(k, n, n_sm)}
    for s, pieces in enumerate(segs):
        covered = np.zeros(k, np.int32)
        for i, (a, b) in enumerate(pieces):
            assert a < b and a % lk.W8_STAGE_K == 0
            covered[a:b] += 1
            if i + 1 < len(pieces):
                assert s * T + b // lk.W8_STAGE_K in cuts
        assert (covered == 1).all() and pieces[0][0] == 0 and pieces[-1][1] == k


@pytest.mark.parametrize("k,n", [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                                 (4096, 128256), (2048, 151936), (3584, 152064), (448, 200)])
def test_plan_does_not_depend_on_m(k, n):
    """The runs are the same at every M (the draft's 4 and 8, the verify's
    16, the tree verify's 60, past one block's 64 rows, up to the prefill
    threshold); only the mode changes past 64 rows, where no workspace is
    needed."""
    for n_sm in SM_COUNTS:
        plans = {m: lk.w8_plan(m, k, n, n_sm) for m in (1, 4, 8, 16, 17, 60, 64, 65, 200, 640)}
        assert len({p[0] for p in plans.values()}) == 1
        for m, (workers, whole, slots) in plans.items():
            assert whole == (m > lk.W8_BLOCK_ROWS)
            assert slots == (0 if whole else 2 * workers)


def test_int4_planners_unchanged():
    """w4_workers, w4_runs, w4_segments and w4g_splits give what they gave
    before matmul_w8a16's planner shared their run and segment code."""
    plans = [(k, n, sm, lk.w4_workers(k, n, sm), lk.w4_runs(k, n, sm), lk.w4_segments(k, n, sm),
              lk.w4g_splits(k, n, sm))
             for k, n in SHAPES if k % 256 == 0 for sm in SM_COUNTS]
    assert len(plans) >= 90
    assert hashlib.sha256(repr(plans).encode()).hexdigest() == W4_PLANS_SHA256


def test_llama3_8b_shapes_fill_the_card():
    """o and down (32 stripes), which one block a 64-column stripe gave 64
    blocks, and gate_up (224 stripes, a partial second wave before) now
    take all 132 SMs; the int8 head's 1002 stripes run about 7.6 a block,
    most of them whole."""
    for k, n in ((4096, 4096), (14336, 4096), (4096, 28672), (4096, 6144), (4096, 128256)):
        assert lk.w8_workers(k, n, 132) == 132
    segs = lk.w8_segments(4096, 128256, 132)
    assert sum(len(p) == 1 for p in segs) > 850 and max(len(p) for p in segs) == 2
    assert {len(p) for p in lk.w8_segments(14336, 4096, 132)} <= {4, 5, 6}


# (M, K, N, SMs): stripes split across runs and runs across stripes, N not a
# multiple of 128 (nor, at 200 and 136, of 16), K not a multiple of the
# 128-k stage (448, 272, and Qwen1.5-MoE's expert down 1408), the whole
# mode's M past 64
SPLIT_CASES = [(4, 512, 384, 7), (16, 448, 200, 5), (60, 1024, 136, 13), (5, 256, 96, 132),
               (8, 2048, 640, 11), (70, 272, 256, 3), (16, 4096, 1024, 132),
               (16, 1408, 384, 7), (64, 768, 256, 9)]


def _byte_weights(rng, k, n, kind):
    """Random int8 weights (every value) or float8_e4m3fn ones (every code
    but the two NaNs), torch and numpy views of the same bytes."""
    if kind == "int8":
        a = rng.integers(-128, 128, size=(k, n), dtype=np.int8)
        return torch.from_numpy(a.copy()), a
    b = rng.integers(0, 256, size=(k, n), dtype=np.uint8)
    b[(b & 0x7F) == 0x7F] = 0x38                      # NaN codes -> 1.0
    return torch.from_numpy(b.copy()).view(torch.float8_e4m3fn), b.view(ml_dtypes.float8_e4m3fn)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("m,k,n,n_sm", SPLIT_CASES)
def test_split_then_fold(kind, m, k, n, n_sm):
    """The kernel's order (segments rounded to f32, added in block order)
    within f32 rounding (1e-5) of the plain version, and within the JAX
    kernel test's 2e-2 of JAX matmul_w8a16 (Pallas, interpret mode), bf16
    and f32 out."""
    rng = np.random.default_rng(41)
    w, wn = _byte_weights(rng, k, n, kind)
    s = rng.uniform(0.001, 0.01, size=n).astype(np.float32)
    xj = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    xt = torch.tensor(np.asarray(xj, np.float32)).to(torch.bfloat16)
    st = torch.from_numpy(s)
    got = lk.matmul_w8_split_ref(xt, w, st, n_sm=n_sm, out_dtype=torch.float32)
    ref = lk.matmul_w8a16_ref(xt, w, st, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())
    jref = np.asarray(j_w8a16(xj, jnp.asarray(wn), jnp.asarray(s), out_dtype=jnp.float32),
                      np.float32)
    np.testing.assert_allclose(got.numpy(), jref, rtol=2e-2, atol=2e-2 * np.abs(jref).max())
    bf = lk.matmul_w8_split_ref(xt, w, st, n_sm=n_sm)
    assert bf.dtype == torch.bfloat16 and tuple(bf.shape) == (m, n)
    np.testing.assert_allclose(bf.float().numpy(), jref, rtol=2e-2, atol=2e-2 * np.abs(jref).max())


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_split_then_fold_stacked(kind):
    """Layer 1 of a 2-layer stack through JAX matmul_w8a16's stacked form
    (Pallas, interpret mode) against the split model of that layer and the
    port's wrapper reading it in place (its plain version on the CPU)."""
    rng = np.random.default_rng(42)
    m, k, n = 16, 512, 384
    ws = [_byte_weights(rng, k, n, kind) for _ in range(2)]
    s = rng.uniform(0.001, 0.01, size=(2, n)).astype(np.float32)
    xj = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    xt = torch.tensor(np.asarray(xj, np.float32)).to(torch.bfloat16)
    jref = np.asarray(j_w8a16(xj, jnp.asarray(np.stack([b for _, b in ws])), jnp.asarray(s),
                              out_dtype=jnp.float32, layer_idx=jnp.asarray(1)), np.float32)
    got = lk.matmul_w8_split_ref(xt, ws[1][0], torch.from_numpy(s[1]), n_sm=7,
                                 out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), jref, rtol=2e-2, atol=2e-2 * np.abs(jref).max())
    stacked = lk.matmul_w8a16(xt, torch.stack([w for w, _ in ws]), torch.from_numpy(s),
                              out_dtype=torch.float32, layer_idx=1)
    np.testing.assert_allclose(stacked.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-5 * got.abs().max().item())


def test_split_then_fold_int8_head():
    """The int8 head's width (N = 128256, 1002 stripes) at a short K and M =
    2: the plan of 132 runs (whole stripes and cut ones) against the plain
    version, f32 out."""
    rng = np.random.default_rng(43)
    k, n, m = 256, 128256, 2
    w, _ = _byte_weights(rng, k, n, "int8")
    s = torch.tensor(rng.uniform(0.001, 0.01, size=n).astype(np.float32))
    x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    got = lk.matmul_w8_split_ref(x, w, s, n_sm=132, out_dtype=torch.float32)
    ref = lk.matmul_w8a16_ref(x, w, s, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())
    assert {len(p) for p in lk.w8_segments(k, n, 132)} == {1, 2}


def test_split_model_keeps_nan_codes():
    """A NaN weight code (0x7F / 0xFF) gives NaN in its column and nowhere
    else, as in the kernel's fold."""
    k, n = 256, 136
    b = np.full((k, n), 0x38, np.uint8)               # 1.0
    b[5, 3], b[200, 130] = 0x7F, 0xFF
    w = torch.from_numpy(b).view(torch.float8_e4m3fn)
    x = torch.ones(3, k, dtype=torch.bfloat16)
    out = lk.matmul_w8_split_ref(x, w, torch.ones(n), n_sm=3, out_dtype=torch.float32)
    assert out[:, 3].isnan().all() and out[:, 130].isnan().all()
    keep = [c for c in range(n) if c not in (3, 130)]
    assert torch.equal(out[:, keep], torch.full((3, n - 2), float(k)))


@pytest.mark.parametrize("bad", ["w_dtype", "w_shape", "s_shape", "s_dtype", "k16", "n8",
                                 "x_dtype", "out_dtype"])
def test_checks_refuse_what_the_kernel_does_not_take(bad):
    """The wrapper's checks on a call csrc/w8a16.cu would get (they run on
    CUDA tensors; here the checks themselves, on CPU tensors)."""
    k, n = 512, 256
    x = torch.zeros(4, k, dtype=torch.bfloat16)
    w = torch.zeros(k, n, dtype=torch.int8)
    s = torch.ones(n)
    out_dtype = torch.bfloat16
    if bad == "w_dtype":
        w, match = w.to(torch.uint8), "int8 or float8_e4m3fn"
    elif bad == "w_shape":
        w, match = torch.zeros(k + 16, n, dtype=torch.int8), r"weights \[K, N\]"
    elif bad == "s_shape":
        s, match = torch.ones(n + 8), "scales"
    elif bad == "s_dtype":
        s, match = s.to(torch.bfloat16), "scales"
    elif bad == "k16":
        x, w = torch.zeros(4, 504, dtype=torch.bfloat16), torch.zeros(504, n, dtype=torch.int8)
        match = "K % 16"
    elif bad == "n8":
        w, s, match = torch.zeros(k, 260, dtype=torch.int8), torch.ones(260), "N % 8"
    elif bad == "x_dtype":
        x, match = x.float(), "x bf16"
    else:
        out_dtype, match = torch.float16, "out_dtype"
    with pytest.raises(ValueError, match=match):
        lk._check_w8_call(x, w, s, out_dtype)


def test_checks_take_what_the_kernel_takes():
    """K a multiple of 16, N of 8 (not of 16 or 128), bf16 or f32 out; past
    the prefill threshold only the shapes are checked (the torch.mm branch
    takes any K and N)."""
    for dt in (torch.int8, torch.float8_e4m3fn):
        w = torch.zeros(448, 200).to(dt)
        for out_dtype in (torch.bfloat16, torch.float32):
            assert lk._check_w8_call(torch.zeros(5, 448, dtype=torch.bfloat16), w, torch.ones(200),
                                     out_dtype) == (5, 448, 200)
    big = torch.zeros(3000, 1000, dtype=torch.float32)
    assert lk._bigm(3000, 1000)
    assert lk._check_w8_call(big, torch.zeros(1000, 12, dtype=torch.int8), torch.ones(12),
                             torch.float16) == (3000, 1000, 12)
