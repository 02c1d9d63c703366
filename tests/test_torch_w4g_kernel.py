"""The host side of the grouped W4A16 kernel (csrc/w4a16_g.cu) on the CPU.

The kernel splits K into slices per 128-column stripe and adds the slices'
partial sums in a fixed order; the planner that picks the split, the group
slots a pipeline stage copies and the wrapper's checks are Python, and are
tested here: over every projection shape of the model configurations in
the repo (the port's and the JAX package's), the split does not depend on
M, gives every SM of the card a unit and covers K exactly once; the
parameters the loaders make reach the same result through the port's
plain version as through the JAX Pallas kernel in interpret mode (rtol /
atol 2e-2 x max|ref|, the JAX kernel test's tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.config import ModelConfig as JModel
from qspec_tpu.model_loader import grouped as jg
from qspec_tpu.ops.linear_kernels import matmul_w4a16_g as j_matmul_g
from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.model_loader import grouped as tg
from qspec_tpu_torch.ops import linear_kernels as lk

# SMs of an H100 SXM (and H200) and of an H100 PCIe
SM_COUNTS = (132, 114)


def _projections(cfg) -> dict:
    H, I = cfg.hidden_size, cfg.intermediate_size
    return {"qkv": (H, cfg.qkv_out), "o": (cfg.q_size, H),
            "gate_up": (H, 2 * I), "down": (I, H)}


CONFIGS = {
    "llama3-8b": ModelConfig.llama3_8b(),
    "gemma2-9b": ModelConfig.gemma2_9b(),
    "llama3-70b": JModel.llama3_70b(),
    "qwen2-7b": JModel.qwen2_7b(),
    "gemma-7b": JModel.gemma_7b(),
    "gemma-2b": JModel.gemma_2b(),
}
SHAPES = sorted({kn for cfg in CONFIGS.values() for kn in _projections(cfg).values()})


def test_model_shapes_take_the_kernel():
    """Every projection of these configurations is one the kernel takes
    (K % 256 == 0); the grid below covers them all."""
    assert len(SHAPES) >= 16
    for k, n in SHAPES:
        assert k % 256 == 0, (k, n)


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("k,n", SHAPES)
def test_split_fills_the_card_and_covers_k_once(k, n, n_sm):
    splits = lk.w4g_splits(k, n, n_sm)
    stages = k // lk.W4G_STAGE_K
    assert 1 <= splits <= min(stages, lk.W4G_MAX_SPLITS)
    assert -(-n // lk.W4G_COLS) * splits >= n_sm
    # the kernel's slices: split i takes stages [i T / S, (i + 1) T / S)
    covered = np.zeros(k, np.int32)
    for i in range(splits):
        lo, hi = i * stages // splits, (i + 1) * stages // splits
        assert hi > lo
        covered[lo * lk.W4G_STAGE_K:hi * lk.W4G_STAGE_K] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("k,n", [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                                 (3584, 8192), (4096, 3584), (3584, 28672), (14336, 3584)])
def test_plan_does_not_depend_on_m(k, n):
    """The split and the group slots are the same at every M the kernel
    takes (the draft's 4, the verify's 16, the tree verify's 60, up to the
    prefill threshold); only the counter tiles grow with the 64-row
    blocks."""
    G = k // 128
    plans = {m: lk.w4g_plan(m, k, n, G, 132) for m in (1, 4, 16, 17, 60, 64, 65, 176)}
    assert len({p[:2] for p in plans.values()}) == 1
    for m, (_, _, tiles) in plans.items():
        assert tiles == -(-n // 128) * -(-m // 64)


@pytest.mark.parametrize("k,g", [(k, g) for k in (768, 3584, 4096, 14336)
                                 for g in (16, 32, 48, 64, 96, 128, 256) if (k // 2) % g == 0])
def test_scale_slots_bound_the_groups_a_stage_touches(k, g):
    """A stage's 64 k of a plane touch at most w4g_scale_slots groups, and
    some stage touches that many; at most 4 for g >= 16, 1 for g = 64, 128."""
    slots = lk.w4g_scale_slots(k, k // g)
    touched = [len({kk // g for kk in range(a, a + 64)}) for a in range(0, k // 2, 64)]
    assert slots == max(touched)
    assert slots <= 4
    if g in (64, 128, 256):
        assert slots == 1


def test_large_group_count_is_taken():
    """The scales are staged per stage: no bound on G from shared memory
    (the old wrapper refused G * 256 + 16384 > 232448, i.e. G > 844)."""
    k, n, g = 28672, 256, 16
    G = k // g
    assert G * 256 + 16384 > 232448
    w = torch.zeros(k // 8, n, dtype=torch.int32)
    s = torch.ones(G, n)
    assert lk._check_w4g(k, w, s, s) == (n, G)
    assert lk.w4g_scale_slots(k, G) == 4


@pytest.mark.parametrize("bad", ["k", "group", "dtype"])
def test_checks_refuse_what_the_kernel_does_not_take(bad):
    k, n, G = 512, 128, 8
    w = torch.zeros(k // 8, n, dtype=torch.int32)
    s = torch.ones(G, n)
    if bad == "k":
        with pytest.raises(ValueError, match="K % 256"):
            lk._check_w4g(384, torch.zeros(48, n, dtype=torch.int32), torch.ones(6, n),
                          torch.ones(6, n))
    elif bad == "group":
        with pytest.raises(ValueError, match="group"):
            lk._check_w4g(k, w, torch.ones(5, n), torch.ones(5, n))
    else:
        with pytest.raises(ValueError, match="f32"):
            lk._check_w4g(k, w, s.half(), s)


@pytest.mark.parametrize("m,k,n,g,n_sm", [(4, 512, 384, 64, 132), (16, 1024, 256, 32, 8),
                                          (60, 768, 200, 128, 6), (5, 512, 130, 64, 3),
                                          (16, 1280, 128, 64, 7)])
def test_split_partials_add_up_to_the_plain_version(m, k, n, g, n_sm):
    """The kernel's arithmetic order, in float64 on the CPU: each K-slice of
    the planned split over both nibble planes, the slices added in index
    order, equals the plain version."""
    rng = np.random.default_rng(11)
    q, zp, s = jg._group_quantize(rng.standard_normal((k, n)).astype(np.float32) * 0.1, g, 0)
    p = tg.pack_grouped_proj(q, zp, s)
    x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    ref = lk.matmul_w4a16_g_ref(x, p["qw"], p["qs_g"], p["qo_g"], out_dtype=torch.float32)
    w = lk._dequant_g(torch.tensor(q, dtype=torch.int32), p["qs_g"], p["qo_g"]).double()
    xd = x.double()
    splits = lk.w4g_splits(k, n, n_sm)
    stages = k // lk.W4G_STAGE_K
    half = lk.W4G_STAGE_K // 2                  # k of each plane per stage
    total = torch.zeros(m, n, dtype=torch.float64)
    for i in range(splits):
        a, b = i * stages // splits * half, (i + 1) * stages // splits * half
        lo, hi = slice(a, b), slice(k // 2 + a, k // 2 + b)
        total += xd[:, lo] @ w[lo] + xd[:, hi] @ w[hi]
    np.testing.assert_allclose(total.float().numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("fmt", ["awq", "gptq"])
def test_loaded_params_match_the_jax_kernel(fmt):
    """One projection (M=4, K=512, N=384, g=64) written as a checkpoint by
    the port's writer, read by the port's loader, through the plain version
    the wrapper runs on the CPU, against the JAX Pallas kernel (interpret
    mode) on the JAX package's pack of the same (q, zp, s)."""
    m, k, n, g = 4, 512, 384, 64
    rng = np.random.default_rng(12)
    w = torch.tensor(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
    if fmt == "awq":
        t = tg.make_awq_tensors(w, g)
        q, zp, s = tg.unpack_awq(t["qweight"], t["qzeros"], t["scales"])
    else:
        t = tg.make_gptq_tensors(w, g)
        q, zp, s = tg.unpack_gptq(t["qweight"], t["qzeros"], t["scales"])
    tp = tg.pack_grouped_proj(q, zp, s)
    jp = jg.pack_grouped_proj(np.asarray(q), np.asarray(zp), np.asarray(s))
    for key in ("qw", "qs_g", "qo_g"):
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]))
    xj = jnp.asarray(rng.standard_normal((m, k)) * 0.5, jnp.bfloat16)
    xt = torch.tensor(np.asarray(xj, np.float32)).to(torch.bfloat16)
    ref = np.asarray(j_matmul_g(xj, jp["qw"], jp["qs_g"], jp["qo_g"], out_dtype=jnp.float32),
                     np.float32)
    got = lk.matmul_w4a16_g(xt, tp["qw"], tp["qs_g"], tp["qo_g"], out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-2, atol=2e-2 * np.abs(ref).max())
