"""The port's dual-scheme Llama against the JAX package's, on the CPU.

The JAX parameter tree (ModelConfig.tiny(quant="w4", lm_head_quant="bf16"),
numpy seed 0) is carried over with params_from_numpy; the same token ids go
through both model_forward implementations under each scheme.

Tolerances, as the relative L2 error of the logits against the JAX package's:
w4a16 (the verify scheme) 2e-2, w4a8 5e-2, w4a4 0.3; and for the argmax, a
disagreement only where the JAX logits are a near-tie (within 2e-2 for
w4a16, 5e-2 for w4a8), agreement on 60% of positions for w4a4. The quantized-activation
schemes cannot agree closely: bf16 inputs often put y / scale exactly on a
rounding tie of the per-token quantizer, and an ulp of difference in rsqrt
or in a sum (XLA's and torch's differ on about a third of values) decides
the side, as the JAX package's own Pallas-vs-jnp tolerance of one step
admits. One step of int4 is a seventh of the row's absmax, so in this random
2-layer model the w4a4 logits move by about as much as w4a4 differs from
w4a16 in the JAX package itself (relative L2 0.20 with these weights). w4a4
is held at the kernel level exactly (tests/test_torch_ops.py); here it is
held to stay within that band and to agree on most argmaxes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.config import ModelConfig as JModelConfig
from qspec_tpu.models import llama as jllama
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.ops import kv_cache as tkv

REL_TOL = {"w4a16": 2e-2, "w4a8": 5e-2, "w4a4": 0.3}
# w4a16 / w4a8: where the argmaxes differ, the port's pick must be within
# this much of the JAX package's best logit (a near-tie); w4a4: the share of
# positions whose argmaxes agree
TIE_GAP = {"w4a16": 2e-2, "w4a8": 5e-2}
W4A4_ARGMAX_AGREE = 0.6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run faster on one thread, and the suite's parallel
    workers then do not oversubscribe the cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = JModelConfig.tiny(quant="w4", lm_head_quant="bf16")
    tcfg = ModelConfig.tiny(quant="w4", lm_head_quant="bf16")
    jparams = jllama.init_params(jcfg, seed=0)
    tparams = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                       tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _forward_both(models, scheme, toks, pos, ctx, tables, S=16, P=10, steps=()):
    """Run a prefill rectangle, then each (toks, pos, ctx) step, through both
    packages; return the logits of every call."""
    jcfg, jparams, tcfg, tparams = models
    jc = jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.num_kv_heads,
                                        jcfg.cache_head_dim, P, S))
    tc = tkv.allocate(tkv.KVCacheConfig(tcfg.num_layers, tcfg.num_kv_heads,
                                        tcfg.cache_head_dim, P, S), "cpu")
    out = []
    for t, p, c in [(toks, pos, ctx), *steps]:
        slot = np.take_along_axis(tables, p // S, axis=1) * S + p % S
        jb = jllama.AttentionBatch(jnp.asarray(p), jnp.asarray(slot),
                                   jnp.asarray(tables), jnp.asarray(c))
        tb = tllama.AttentionBatch(torch.tensor(p), torch.tensor(slot),
                                   torch.tensor(tables), torch.tensor(c))
        jl, jc = jllama.model_forward(jparams, jcfg, jnp.asarray(t), jc, jb, scheme=scheme)
        tl, tc = tllama.model_forward(tparams, tcfg, torch.tensor(t), tc, tb, scheme=scheme)
        out.append((np.asarray(jl), tl.numpy()))
    return out


@pytest.mark.parametrize("scheme", ["w4a16", "w4a8", "w4a4"])
def test_model_forward_matches_jax(models, scheme):
    rng = np.random.default_rng(11)
    B, Q = 2, 12
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    toks = rng.integers(1, 512, size=(B, Q)).astype(np.int32)
    pos = np.tile(np.arange(Q, dtype=np.int32), (B, 1))
    ctx = np.full(B, Q, np.int32)
    # then a verify-shaped step (Q=4) on top of the prefilled cache
    toks2 = rng.integers(1, 512, size=(B, 4)).astype(np.int32)
    pos2 = Q + np.tile(np.arange(4, dtype=np.int32), (B, 1))
    outs = _forward_both(models, scheme, toks, pos, ctx, tables,
                         steps=[(toks2, pos2, np.full(B, Q + 4, np.int32))])
    for jl, tl in outs:
        assert tl.shape == jl.shape and tl.dtype == np.float32
        assert np.isfinite(tl).all()
        rel = np.linalg.norm(tl - jl) / np.linalg.norm(jl)
        assert rel <= REL_TOL[scheme], rel
        pick = tl.argmax(-1)
        if scheme == "w4a4":
            assert (pick == jl.argmax(-1)).mean() >= W4A4_ARGMAX_AGREE
        else:
            gap = jl.max(-1) - np.take_along_axis(jl, pick[..., None], -1)[..., 0]
            assert gap.max() <= TIE_GAP[scheme], gap.max()


def test_params_carry_packed_weights_unchanged(models):
    _, jparams, tcfg, tparams = models
    for name in tllama.PROJECTIONS:
        np.testing.assert_array_equal(tparams["layers"][name]["qw"].numpy(),
                                      np.asarray(jparams["layers"][name]["qw"]))
        np.testing.assert_array_equal(tparams["layers"][name]["qs"].numpy(),
                                      np.asarray(jparams["layers"][name]["qs"]))
    assert tparams["embed"].dtype == torch.bfloat16
    assert tuple(tparams["lm_head"].shape) == (tcfg.hidden_size, tcfg.vocab_size)


def test_init_params_layout():
    cfg = ModelConfig.tiny(lm_head_quant="bf16")
    p = tllama.init_params(cfg, seed=1, device="cpu")
    qkv = p["layers"]["qkv"]
    assert qkv["qw"].dtype == torch.int32
    assert tuple(qkv["qw"].shape) == (cfg.num_layers, cfg.hidden_size // 8, cfg.qkv_out)
    assert tuple(p["layers"]["down"]["qs"].shape) == (cfg.num_layers, cfg.hidden_size)
    again = tllama.init_params(cfg, seed=1, device="cpu")
    assert torch.equal(again["layers"]["down"]["qw"], p["layers"]["down"]["qw"])


def test_unported_heads_raise():
    """Every head of the JAX package is ported (bf16, int8, int4; "auto" is
    int8 for w4); a kind it does not know is refused."""
    with pytest.raises(ValueError):
        tllama.init_params(ModelConfig.tiny(lm_head_quant="fp8"), seed=0, device="cpu")
    assert "qw8" in tllama.init_params(ModelConfig.tiny(), seed=0, device="cpu")["lm_head"]


def test_cuda_entry_point_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.init_params(ModelConfig.tiny(lm_head_quant="bf16"), seed=0, device="cuda")
