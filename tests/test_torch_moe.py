"""The port's sparse-MoE MLP against the JAX package's, on the CPU.

The same parameters (the JAX ``init_params`` tree, numpy seed 0, carried
over by ``params_from_numpy``) and the same inputs go through
``qspec_tpu/models/llama.py::_moe_block`` (its Pallas-free CPU path) and the
port's ``_moe_block``, for each routing (Mixtral's top-k then softmax, the
softmax before top-k with the renormalization, sparsemixer, DeepSeek-V3's
noaux_tc with ``routed_scaling_factor``), with no shared expert, a gated
and an ungated one, under each scheme: bf16 on ``quant="none"``, W4A16,
W4A4 and W4A8 on ``quant="w4"``; the JAX function runs op by op (see
``jax_moe_block``). Tolerances are the JAX kernel tests'
(``tests/kernels/test_linear_kernels.py``): rtol / atol 2e-2 for bf16 and
W4A16, 1e-2 for the quantized-activation schemes, the atol relative to the
delta's largest magnitude (the kernels' outputs are of order one there;
the MoE delta is a sum of experts of order 1e-2). Ties in the router's logits go to
the lower expert index in both packages. Then ``model_forward`` on the JAX
test's tiny MoE (``tests/models/test_mixtral.py:130``), a tiny Qwen2-MoE
(shared expert, qkv bias) and a tiny Qwen3-MoE (q/k norms) at
``tests/test_torch_model.py``'s tolerances, DeepSeek's dense prefix in bf16,
and the port's engine: greedy QSpec equals its oracle and AR bit for bit
through the MoE MLP at W4A4 and W4A8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.config import ModelConfig as JModelConfig
from qspec_tpu.models import llama as jllama
from qspec_tpu.ops import quant as jquant
from qspec_tpu_torch import LLMEngine, SamplingParams
from qspec_tpu_torch.config import (CacheConfig, EngineConfig, ModelConfig,
                                    SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.ops.quant import QuantizedActivation
from tests.test_torch_model import REL_TOL, TIE_GAP, W4A4_ARGMAX_AGREE, _forward_both

# the JAX kernel tests' tolerances, by scheme (relative to the largest |delta|)
BLOCK_TOL = {"bf16": 2e-2, "w4a16": 2e-2, "w4a4": 1e-2, "w4a8": 1e-2}
SCHEMES = ("bf16", "w4a16", "w4a4", "w4a8")
# a tiny MoE layer: hidden 256, 4 experts of width 128 (= 2 * 64, the
# Hadamard's Sylvester factors), a shared expert of 192 (= 12 * 16, a Paley
# factor)
MOE_KW = dict(vocab_size=512, hidden_size=256, intermediate_size=448, num_layers=1,
              num_heads=4, num_kv_heads=2, head_dim=64, rope_theta=10000.0,
              max_position_embeddings=512, num_experts=4, num_experts_per_tok=2,
              moe_intermediate_size=128)
ROUTINGS = {
    "topk": {},
    "softmax_norm": dict(moe_softmax_before_topk=True, moe_norm_topk_prob=True),
    "sparsemixer": dict(moe_routing="sparsemixer"),
    "noaux_tc": dict(moe_routing="noaux_tc", moe_n_group=2, moe_topk_group=1,
                     moe_norm_topk_prob=True, routed_scaling_factor=2.5),
}
SHARED = {"none": {}, "gated": dict(shared_expert_intermediate_size=192),
          "ungated": dict(shared_expert_intermediate_size=192, shared_expert_gated=False)}
BLOCK_CASES = [("topk", "none"), ("topk", "gated"), ("softmax_norm", "gated"),
               ("softmax_norm", "ungated"), ("sparsemixer", "none"), ("noaux_tc", "ungated")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_params(kw: dict, seed: int = 0):
    """(JAX cfg, JAX params, port cfg, port params) of the JAX init_params
    tree; under noaux_tc the selection bias is made nonzero."""
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    jp = jax.tree_util.tree_map(np.asarray, jllama.init_params(jcfg, seed=seed))
    if "router_bias" in jp["layers"]:
        rb = np.random.default_rng(seed + 1).standard_normal(jp["layers"]["router_bias"].shape)
        jp["layers"]["router_bias"] = (0.05 * rb).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    return jcfg, jparams, tcfg, tllama.params_from_numpy(jp, tcfg, device="cpu")


def block_inputs(scheme: str, T: int = 12, H: int = 256, seed: int = 3):
    """The normed rows (bf16) or their per-token quantization, for both."""
    x = np.random.default_rng(seed).standard_normal((T, H)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    if scheme in ("bf16", "w4a16"):
        return (xj, None), (torch.tensor(np.asarray(xj.astype(jnp.float32))).bfloat16(), None)
    q = jquant.sym_quant_int4(xj) if scheme == "w4a4" else jquant.sym_quant_int8(xj)
    tq = QuantizedActivation(torch.tensor(np.asarray(q.values)),
                             torch.tensor(np.asarray(q.scales)))
    return (None, q), (None, tq)


def jax_moe_block(jxn, jxq, jp, jcfg, scheme):
    """The JAX package's _moe_block, op by op (``jax.disable_jit``): under
    jit, XLA's fusion of the scan body rounds the GLU otherwise than the
    function's own ops and moves an int4 activation code by a step on some
    rows (3 of 12 at W4A4 here, 3% of the largest |delta|), as far from
    the JAX package's eager result as from the port's."""
    with jax.disable_jit():
        return np.asarray(jllama._moe_block(jxn, jxq, jp["layers"], 0, jcfg, scheme,
                                            jp.get("hadamards"), None))


def moe_both(kw: dict, scheme: str, seed: int = 3):
    jcfg, jp, tcfg, tp = both_params(kw)
    (jxn, jxq), (txn, txq) = block_inputs(scheme, seed=seed)
    ref = jax_moe_block(jxn, jxq, jp, jcfg, scheme)
    got = tllama._moe_block(txn, txq, tp["layers"], 0, tcfg, scheme, tp.get("hadamards"))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    return ref, got.numpy()


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("routing,shared", BLOCK_CASES)
def test_moe_block_matches_jax(routing, shared, scheme):
    kw = {**MOE_KW, **ROUTINGS[routing], **SHARED[shared],
          "quant": "none" if scheme == "bf16" else "w4"}
    ref, got = moe_both(kw, scheme)
    tol = BLOCK_TOL[scheme] * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=BLOCK_TOL[scheme], atol=tol)


def test_router_ties_go_to_the_lower_index():
    """Tied logits: jax.lax.top_k takes the lower index first, and so does
    the port's stable sort; argmax (sparsemixer) takes the first maximum in
    both."""
    logits = np.array([[1.0, 3.0, 3.0, 3.0, 0.0, 3.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.5, -1.0, 0.5, 4.0, 4.0, 0.5]], np.float32)
    for routing in ("topk", "softmax_norm", "sparsemixer"):
        cfg = ModelConfig(**{**MOE_KW, "num_experts": 6, **ROUTINGS[routing]})
        combine = tllama.moe_combine(torch.tensor(logits), cfg).numpy()
        if routing == "sparsemixer":
            first = logits.argmax(-1)
            assert (combine[np.arange(3), first] > 0).all()
        picked = [sorted(np.nonzero(row)[0].tolist()) for row in combine]
        vals = jnp.asarray(logits)
        if routing == "softmax_norm":
            vals = jax.nn.softmax(vals, axis=-1)
        want = [sorted(r) for r in np.asarray(jax.lax.top_k(vals, 2)[1]).tolist()]
        assert picked == want == [[1, 2], [0, 1], [3, 4]], (routing, picked)


@pytest.mark.parametrize("scheme", ["w4a16", "w4a4"])
def test_moe_block_with_tied_router_columns_matches_jax(scheme):
    """Experts 1 and 2 with equal router columns: every token's logits tie
    there, exactly, in both packages, and both route alike."""
    kw = {**MOE_KW, "quant": "w4", "num_experts_per_tok": 1}
    jcfg, jp, tcfg, tp = both_params(kw)
    router = np.asarray(jp["layers"]["router"], np.float32)
    router[..., 2] = router[..., 1] = np.abs(router).max() * 4   # the top two, tied
    jp["layers"]["router"] = jnp.asarray(router, jnp.bfloat16)
    tp["layers"]["router"] = torch.tensor(router).bfloat16()
    (jxn, jxq), (txn, txq) = block_inputs(scheme)
    if jxn is not None:
        jxn, txn = jnp.abs(jxn), txn.abs()      # positive rows: the tied logits lead
    else:
        jxq = jxq._replace(values=jnp.abs(jxq.values))
        txq = txq._replace(values=txq.values.abs())
    ref = jax_moe_block(jxn, jxq, jp, jcfg, scheme)
    got = tllama._moe_block(txn, txq, tp["layers"], 0, tcfg, scheme, tp["hadamards"]).numpy()
    x_fp = txn if txn is not None else (txq.values.float() * txq.scales).bfloat16()
    combine = tllama.moe_combine(tllama._f32_matmul(x_fp, tp["layers"]["router"][0]), tcfg)
    assert (combine[:, 1] == 1).all() and (combine[:, 2] == 0).all()
    np.testing.assert_allclose(got, ref, rtol=BLOCK_TOL[scheme],
                               atol=BLOCK_TOL[scheme] * np.abs(ref).max())


# ------------------------------------------------------------ model_forward

TINY_MOE = {
    # the JAX test's tiny MoE (tests/models/test_mixtral.py:130)
    "mixtral": dict(num_experts=4, num_experts_per_tok=2),
    "qwen2moe": dict(arch="qwen2moe", num_experts=4, num_experts_per_tok=2,
                     moe_intermediate_size=128, shared_expert_intermediate_size=192,
                     moe_softmax_before_topk=True, qkv_bias=True),
    "qwen3moe": dict(arch="qwen3moe", num_experts=4, num_experts_per_tok=2,
                     moe_intermediate_size=128, moe_softmax_before_topk=True,
                     moe_norm_topk_prob=True, qk_norm=True),
}


def tiny_models(family: str, quant: str = "w4", **over):
    kw = dict(TINY_MOE[family], quant=quant, lm_head_quant="bf16", **over)
    jcfg, tcfg = JModelConfig.tiny(**kw), ModelConfig.tiny(**kw)
    jparams = jllama.init_params(jcfg, seed=0)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    if family == "qwen3moe":
        # gammas away from 1, so the q/k norms are exercised
        rng = np.random.default_rng(9)
        for n in ("q_norm", "k_norm"):
            g = 1 + 0.2 * rng.standard_normal(tree["layers"][n].shape)
            tree["layers"][n] = np.asarray(jnp.asarray(g, jnp.bfloat16))
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, tllama.params_from_numpy(tree, tcfg, device="cpu")


def forward_case(models, scheme):
    """A prefill rectangle, then a verify-shaped step, through both
    packages. The JAX model_forward runs op by op (``jax.disable_jit``), as
    ``jax_moe_block`` does: its jitted layer scan fuses the router's and the
    experts' arithmetic otherwise than the function's ops, so a router
    near-tie can fall the other way there (measured: one position of 24 at
    0.172 relative L2 on the tiny Mixtral at W4A16, where the port is
    within 1e-5 of the op-by-op result)."""
    with jax.disable_jit():
        return _forward_case(models, scheme)


def _forward_case(models, scheme):
    rng = np.random.default_rng(11)
    B, Q = 2, 12
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    toks = rng.integers(1, 512, size=(B, Q)).astype(np.int32)
    pos = np.tile(np.arange(Q, dtype=np.int32), (B, 1))
    toks2 = rng.integers(1, 512, size=(B, 4)).astype(np.int32)
    pos2 = Q + np.tile(np.arange(4, dtype=np.int32), (B, 1))
    return _forward_both(models, scheme, toks, pos, np.full(B, Q, np.int32), tables,
                         steps=[(toks2, pos2, np.full(B, Q + 4, np.int32))])


@pytest.mark.parametrize("scheme", ["w4a16", "w4a8", "w4a4"])
@pytest.mark.parametrize("family", sorted(TINY_MOE))
def test_model_forward_matches_jax(family, scheme):
    """tests/test_torch_model.py's tolerances; at W4A4 the argmaxes of the
    prefill and the verify step are pooled (32 positions): a one-step
    difference of an activation's int4 code moves the dequantized row that
    the router reads, and a token's experts with it, so 8 positions alone
    swing widely (measured 0.375 on the tiny Qwen3-MoE's verify step, 0.69
    pooled; the JAX package's own W4A4 is that far from its W4A16)."""
    models = tiny_models(family)
    agree = []
    for jl, tl in forward_case(models, scheme):
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        rel = np.linalg.norm(tl - jl) / np.linalg.norm(jl)
        assert rel <= REL_TOL[scheme], rel
        pick = tl.argmax(-1)
        if scheme == "w4a4":
            agree += (pick == jl.argmax(-1)).reshape(-1).tolist()
        else:
            gap = jl.max(-1) - np.take_along_axis(jl, pick[..., None], -1)[..., 0]
            assert gap.max() <= TIE_GAP[scheme], gap.max()
    if scheme == "w4a4":
        assert np.mean(agree) >= W4A4_ARGMAX_AGREE, np.mean(agree)


@pytest.mark.parametrize("family", ["qwen2moe", "qwen3moe"])
def test_model_forward_bf16_matches_jax(family):
    """The float tree (quant="none") through the bf16 scheme."""
    models = tiny_models(family, quant="none")
    for jl, tl in forward_case(models, "bf16"):
        rel = np.linalg.norm(tl - jl) / np.linalg.norm(jl)
        assert rel <= REL_TOL["w4a16"], rel


def test_deepseek_dense_prefix_matches_jax():
    """DeepSeek-MoE in bf16: a dense first layer (layers_dense, the dense
    width 448) before the MoE layer (experts of 128, an ungated shared
    expert); weights by segment, the KV cache by the global layer."""
    kw = dict(arch="deepseek", quant="none", lm_head_quant="bf16", num_experts=4,
              num_experts_per_tok=2, moe_intermediate_size=128,
              shared_expert_intermediate_size=256, shared_expert_gated=False,
              first_k_dense=1, moe_softmax_before_topk=True)
    jcfg, tcfg = JModelConfig.tiny(**kw), ModelConfig.tiny(**kw)
    jparams = jllama.init_params(jcfg, seed=0)
    tparams = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                       device="cpu")
    assert tuple(tparams["layers_dense"]["gate_up"]["w"].shape) == (1, 256, 896)
    assert tuple(tparams["layers"]["experts_down"]["w"].shape) == (1, 4, 128, 256)
    for jl, tl in forward_case((jcfg, jparams, tcfg, tparams), "bf16"):
        rel = np.linalg.norm(tl - jl) / np.linalg.norm(jl)
        assert rel <= REL_TOL["w4a16"], rel


def test_quarot_dense_prefix_of_another_width_raises():
    """QuaRot with a dense prefix whose width is not the experts': the JAX
    package's one intermediate Hadamard cannot rotate both (it fails with a
    shape error); the port refuses the configuration, naming why."""
    kw = dict(arch="deepseek", num_experts=4, num_experts_per_tok=2, moe_intermediate_size=128,
              first_k_dense=1, moe_softmax_before_topk=True)
    with pytest.raises(ValueError, match="448"):
        jcfg = JModelConfig.tiny(quant="w4", **kw)
        jllama._mlp_hadamard(jnp.ones((2, 448), jnp.bfloat16),
                             *(jllama.make_hadamards(jcfg)[n] for n in ("mlp_K", "mlp_P")))
    cfg = ModelConfig.tiny(quant="w4", **kw)
    with pytest.raises(NotImplementedError, match="dense prefix.*448.*128.*bf16"):
        tllama.check_served(cfg)
    with pytest.raises(NotImplementedError, match="dense prefix"):
        tllama.init_params(cfg, device="cpu")
    # the same widths compose (one Hadamard fits both), and bf16 always does
    tllama.check_served(dataclasses.replace(cfg, moe_intermediate_size=448))
    tllama.check_served(dataclasses.replace(cfg, quant="none"))


def test_init_params_layout():
    """init_params of an MoE: the expert stacks [L, E, K//8, N] quantized
    one (layer, expert) at a time, the bf16 router [L, H, E], the shared
    expert and its gate, the qkv bias, the q/k norms; the same seed gives
    the same tensors."""
    cfg = ModelConfig.tiny(quant="w4", lm_head_quant="bf16", **TINY_MOE["qwen2moe"])
    p = tllama.init_params(cfg, seed=1, device="cpu")
    L, E, H = cfg.num_layers, cfg.num_experts, cfg.hidden_size
    lay = p["layers"]
    assert tuple(lay["experts_gate_up"]["qw"].shape) == (L, E, H // 8, 256)
    assert tuple(lay["experts_down"]["qs"].shape) == (L, E, H)
    assert lay["router"].dtype == torch.bfloat16 and tuple(lay["router"].shape) == (L, H, E)
    assert tuple(lay["shared_gate"].shape) == (L, H, 1)
    assert tuple(lay["qkv"]["b"].shape) == (L, cfg.qkv_out)
    assert "gate_up" not in lay and set(p["hadamards"]) >= {"shared_K", "shared_P"}
    again = tllama.init_params(cfg, seed=1, device="cpu")
    assert torch.equal(again["layers"]["experts_down"]["qw"], lay["experts_down"]["qw"])
    assert not torch.equal(lay["experts_down"]["qw"][0, 0], lay["experts_down"]["qw"][0, 1])
    q3 = tllama.init_params(ModelConfig.tiny(quant="none", **TINY_MOE["qwen3moe"]),
                            seed=0, device="cpu")
    assert tuple(q3["layers"]["q_norm"].shape) == (2, 64)
    assert tuple(q3["layers"]["experts_gate_up"]["w"].shape) == (2, 4, 256, 256)


# ------------------------------------------------------------------ engine


def generate(cfg, params, prompts, spec=None):
    ec = EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                      scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=256,
                                                prefill_chunk_size=64),
                      speculative=spec)
    eng = LLMEngine(ec, params, device="cpu")
    sp = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
    ids = [eng.add_request(p, sp) for p in prompts]
    outs = {}
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
    return [outs[i] for i in ids], eng.spec_metrics


@pytest.mark.parametrize("family", sorted(TINY_MOE))
def test_engine_greedy_spec_equals_ar(family):
    """Greedy QSpec through the MoE MLP equals its qspec_null oracle and AR,
    bit for bit, with the W4A4 and the W4A8 draft (whose router reads the
    dequantized activations, and may route otherwise than the verify), and
    the drafts are accepted."""
    cfg = ModelConfig.tiny(quant="w4", **TINY_MOE[family])
    params = tllama.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(17)
    prompts = [list(map(int, rng.integers(1, 500, size=int(rng.integers(8, 30)))))
               for _ in range(3)]
    ar, _ = generate(cfg, params, prompts)
    for scheme in ("w4a4", "w4a8"):
        spec, m = generate(cfg, params, prompts,
                           SpeculativeConfig(num_speculative_tokens=3, draft_scheme=scheme))
        oracle, _ = generate(cfg, params, prompts, SpeculativeConfig(
            num_speculative_tokens=3, draft_scheme=scheme, method="qspec_null"))
        assert spec == oracle == ar, (family, scheme)
        assert m.draft_acceptance_rate > 0, (family, scheme)


def test_proposer_nets_on_an_moe_target_raise():
    """Medusa, MLPSpeculator and EAGLE read a dense target's hidden state;
    on an MoE target they are refused, as before this slice."""
    cfg = ModelConfig.tiny(quant="w4", **TINY_MOE["mixtral"])
    params = tllama.init_params(cfg, seed=0, device="cpu")
    for method in ("medusa", "eagle"):
        spec = SpeculativeConfig(num_speculative_tokens=2, method=method)
        with pytest.raises(NotImplementedError, match="mixture-of-experts"):
            LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                   scheduler=SchedulerConfig(max_num_seqs=2,
                                                             max_model_len=128),
                                   speculative=spec), params, device="cpu")
