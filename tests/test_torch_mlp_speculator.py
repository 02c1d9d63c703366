"""The port's MLPSpeculator proposer on the CPU: the JAX package's tests
(tests/spec_decode/test_mlp_speculator.py) on the port, and the port held
against the JAX package on the same numpy arrays: the proposals, the random
net's numbers, and the engine's greedy tokens (== AR, == the medusa_null
oracle, == the JAX engine's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.config import CacheConfig as JCache
from qspec_tpu.config import EngineConfig as JEngine
from qspec_tpu.config import ModelConfig as JModel
from qspec_tpu.config import SchedulerConfig as JSched
from qspec_tpu.config import SpeculativeConfig as JSpec
from qspec_tpu.engine import model_runner as jmr
from qspec_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from qspec_tpu.models import llama as jllama
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu.ops.sampling import SamplingTensors as JSamplingTensors
from qspec_tpu.sampling_params import SamplingParams as JSamplingParams
from qspec_tpu.spec_decode import mlp_speculator as jmlp
from qspec_tpu_torch import (LLM, CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                             SamplingParams, SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.engine import model_runner as tmr
from qspec_tpu_torch.engine.arg_utils import EngineArgs
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.ops import kv_cache as tkv
from qspec_tpu_torch.ops.sampling import SamplingTensors
from qspec_tpu_torch.spec_decode.mlp_speculator import (init_mlp_speculator_params,
                                                        load_mlp_speculator,
                                                        mlp_speculator_propose)
from tests.test_torch_medusa import _agree_up_to_ties


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The JAX test's setup: the tiny QuaRot model with a random net (k = 4,
    seed 3, scale_input), made by the JAX package and carried over."""
    jcfg = JModel.tiny(quant="w4")
    jparams = {**jllama.init_params(jcfg, seed=0), "mlp_spec": jmlp.init_mlp_speculator_params(
        jcfg.hidden_size, jcfg.vocab_size, k=4, seed=3, scale_input=True)}
    cfg = ModelConfig.tiny(quant="w4")
    params = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                      device="cpu")
    sched = dict(max_num_seqs=4, max_model_len=256, prefill_chunk_size=64,
                 decode_batch_buckets=(2, 4), prefill_token_buckets=(64,))
    return jcfg, jparams, cfg, params, sched


def run_engine(cfg, params, sched, spec, prompts, max_tokens=20, temp=0.0):
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**sched), speculative=spec),
                    params, device="cpu")
    for p in prompts:
        eng.add_request(p, SamplingParams(temperature=temp, max_tokens=max_tokens))
    outs, steps = {}, 0
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
        steps += 1
        assert steps < 600
    return [outs[i] for i in range(len(prompts))], eng


def prompts(n=4):
    r = np.random.default_rng(17)
    return [list(map(int, r.integers(1, 500, size=int(r.integers(5, 40))))) for _ in range(n)]


def mlp(k, **kw):
    return SpeculativeConfig(num_speculative_tokens=k, method="mlp_speculator", **kw)


def _net(rng, H, D, V, K):
    return {"emb": rng.standard_normal((K, V, D)).astype(np.float32) * 0.2,
            "proj_first": rng.standard_normal((H, D)).astype(np.float32) * 0.2,
            "proj_rest": rng.standard_normal((K - 1, D, D)).astype(np.float32) * 0.2,
            "ln_w": rng.standard_normal((K, D)).astype(np.float32) * 0.3 + 1.0,
            "ln_b": rng.standard_normal((K, D)).astype(np.float32) * 0.1,
            "head": rng.standard_normal((K, D, V)).astype(np.float32) * 0.2}


def test_propose_matches_numpy_reference():
    """The recurrence against a plain numpy transcription of the
    reference's forward (mlp_speculator.py:162-186)."""
    rng = np.random.default_rng(0)
    H, D, V, K, B = 48, 64, 96, 3, 5
    net = _net(rng, H, D, V, K)
    h = rng.standard_normal((B, H)).astype(np.float32)
    last0 = rng.integers(0, V, size=B).astype(np.int32)
    sw = 0.5 ** (0.5 / K)
    ew = np.sqrt((1 - sw ** 2) * (D / 2))

    def l2norm(x):
        return x / np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-6)

    def gelu(x):
        from math import erf, sqrt
        return x * np.vectorize(lambda v: 0.5 * (1.0 + erf(v / sqrt(2.0))))(x)

    state, last = h, last0
    want = np.zeros((B, K), np.int64)
    for j in range(K):
        z = net["emb"][j][last]
        w = net["proj_first"] if j == 0 else net["proj_rest"][j - 1]
        s = l2norm(state @ w + z * (ew / sw)) * net["ln_w"][j] + net["ln_b"][j]
        state = gelu(s)
        last = np.argmax(state @ net["head"][j], axis=-1)
        want[:, j] = last
    got = mlp_speculator_propose({k: torch.tensor(v) for k, v in net.items()},
                                 torch.tensor(h), torch.tensor(last0)).numpy()
    assert got.dtype == np.int32
    # the JAX test's bar (>90% agreement); f32 on the CPU gives all of them
    assert (got == want).mean() > 0.9


@pytest.mark.parametrize("scale_input", [False, True])
def test_propose_matches_jax(scale_input):
    """The port's proposals equal the JAX package's on the same arrays."""
    rng = np.random.default_rng(6)
    H, D, V, K, B = 64, 80, 128, 4, 7
    net = _net(rng, H, D, V, K)
    if scale_input:
        net["ln0"] = np.ones((), np.float32)
    h = rng.standard_normal((B, H)).astype(np.float32) * 3
    last = rng.integers(0, V, size=B).astype(np.int32)
    want = np.asarray(jmlp.mlp_speculator_propose({k: jnp.asarray(v) for k, v in net.items()},
                                                  jnp.asarray(h), jnp.asarray(last)))
    got = mlp_speculator_propose({k: torch.tensor(v) for k, v in net.items()},
                                 torch.tensor(h), torch.tensor(last)).numpy()
    np.testing.assert_array_equal(got, want)


def test_init_matches_jax():
    """On the CPU the random net is numpy's, the JAX package's numbers."""
    want = jmlp.init_mlp_speculator_params(32, 64, k=3, seed=5, scale_input=True)
    got = init_mlp_speculator_params(32, 64, k=3, seed=5, scale_input=True, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(want[k], np.float32))


def test_scale_input_prenorm_changes_proposals():
    rng = np.random.default_rng(2)
    H, V, K, B = 32, 64, 2, 4
    net = init_mlp_speculator_params(H, V, k=K, seed=5, device="cpu")
    net_si = dict(net, ln0=torch.ones(()))
    h = torch.tensor(rng.standard_normal((B, H)).astype(np.float32) * 7)
    last = torch.tensor(rng.integers(0, V, size=B).astype(np.int32))
    a = mlp_speculator_propose(net, h, last)
    b = mlp_speculator_propose(net_si, h, last)
    assert a.shape == b.shape == (B, K)
    # the prenorm takes the hidden's scale out: a rescaled hidden proposes
    # the same tokens
    assert torch.equal(mlp_speculator_propose(net_si, h * 3, last), b)


@pytest.mark.parametrize("k,rounds", [(2, 1), (4, 3)])
def test_greedy_mlp_speculator_equals_ar(setup, k, rounds):
    """Greedy MLPSpeculator == AR and == the medusa_null oracle (the same
    rounds with the proposals nulled), bit for bit."""
    _, _, cfg, params, sched = setup
    ps = prompts()
    ar, _ = run_engine(cfg, params, sched, None, ps)
    sp, eng = run_engine(cfg, params, sched, mlp(k, rounds_per_step=rounds), ps)
    assert ar == sp
    m = eng.spec_metrics
    assert m.num_spec_rounds > 0
    assert 0.0 <= m.draft_acceptance_rate <= 1.0
    assert eng.runner.draft_cache is None and eng.runner._mnet == "mlp_spec"
    oracle, o_eng = run_engine(cfg, params, sched, SpeculativeConfig(
        num_speculative_tokens=k, method="medusa_null", rounds_per_step=rounds), ps)
    assert oracle == sp and o_eng.runner._mnet == "mlp_spec"


def test_greedy_tokens_match_jax_engine(setup):
    """The port's MLPSpeculator engine gives the JAX engine's greedy tokens
    on the same weights, or the first difference is a near-tie of the JAX
    logits, as tests/test_torch_medusa.py holds Medusa's (the port's and
    the JAX package's W4A16 forwards differ by rounding; each engine's
    tokens are its own AR's)."""
    jcfg, jparams, cfg, params, sched = setup
    ps = prompts(3)
    got, eng = run_engine(cfg, params, sched, mlp(3), ps, max_tokens=16)
    jeng = JLLMEngine(JEngine(model=jcfg, cache=JCache(page_size=16), scheduler=JSched(**sched),
                              speculative=JSpec(num_speculative_tokens=3,
                                                method="mlp_speculator")), jparams)
    for p in ps:
        jeng.add_request(p, JSamplingParams(temperature=0.0, max_tokens=16))
    want = {}
    while jeng.has_unfinished_requests():
        for o in jeng.step():
            if o.finished:
                want[o.request_id] = o.output_token_ids
    want = [want[i] for i in range(len(ps))]
    _agree_up_to_ties(jcfg, jparams, ps, want, got)
    if got == want:
        assert eng.spec_metrics.num_draft_accepted == jeng.spec_metrics.num_draft_accepted


def test_rounds_step_matches_jax(setup):
    """Both packages prefill the tiny model's cache with the same prompts
    over the same page tables, then run R chain rounds of
    medusa_rounds_step with the MLPSpeculator net from the same proposals
    (-1: none yet): each round's tokens and accepted lengths, and the
    proposals the chain writes back, equal the JAX package's, or a
    sequence's first difference is a near-tie of the JAX logits (as the
    engine tests hold the two W4A16 forwards) and its proposals are not
    compared. The random net accepts nothing: one token a round, none past
    the budget."""
    jcfg, jparams, cfg, params, _ = setup
    S, k, R, budget = 16, 3, 11, 10
    rng = np.random.default_rng(12)
    ps = [rng.integers(1, 500, size=n).astype(np.int32) for n in (30, 9, 21)]
    B = len(ps)
    n_pages = -(-(max(map(len, ps)) + R * (k + 1) + 1) // S)
    tables = (1 + np.arange(B * n_pages, dtype=np.int32)).reshape(B, n_pages)
    kv = (jcfg.num_layers, jcfg.num_kv_heads, jcfg.cache_head_dim, B * n_pages + 1, S)
    jc, tc = jkv.allocate(jkv.KVCacheConfig(*kv)), tkv.allocate(tkv.KVCacheConfig(*kv), "cpu")
    first = []
    for b, p in enumerate(ps):
        args = (p[None], np.arange(len(p), dtype=np.int32)[None], tables[b:b + 1],
                np.array([len(p)], np.int32))
        jl, jc = jmr.prefill_step(jparams, jc, *map(jnp.asarray, args), cfg=jcfg,
                                  scheme="w4a16")
        tl, _ = tmr.prefill_step(params, tc, *map(torch.tensor, args), cfg=cfg, scheme="w4a16")
        first.append(int(np.asarray(jl).argmax(-1)[0]))
        assert int(tl.argmax(-1)[0]) == first[-1]
    props = np.full((B + 1, 4), -1, np.int32)
    rows = np.arange(B, dtype=np.int32)
    args = (rows, np.array(first, np.int32), np.array([len(p) for p in ps], np.int32), tables,
            np.full(B, budget, np.int32))
    jst = JSamplingTensors(jnp.zeros(B), jnp.zeros(B, jnp.int32), jnp.ones(B), jnp.zeros(B))
    tst = SamplingTensors(torch.zeros(B), torch.zeros(B, dtype=torch.int32), torch.ones(B),
                          torch.zeros(B), needs_filter=False)
    jr = jmr.medusa_rounds_step(jparams, jc, jnp.asarray(props), *map(jnp.asarray, args),
                                jnp.asarray(True), jst, jax.random.PRNGKey(0), cfg=jcfg,
                                scheme="w4a16", k=k, num_rounds=R)
    tprops = torch.tensor(props)
    tr = tmr.medusa_rounds_step(params, tc, tprops, *map(torch.tensor, args), True, tst,
                                torch.Generator(), cfg=cfg, scheme="w4a16", k=k, num_rounds=R,
                                net="mlp_spec")
    assert tr[1].tolist() == np.asarray(jr[1]).tolist()
    assert (tr[1].numpy().sum(0) == budget).all() and (tr[1][-1] == 0).all()

    def streams(toks):
        return [[int(t) for t in toks[:, b].reshape(-1) if t >= 0] for b in range(B)]
    got, want = streams(tr[0].numpy()), streams(np.asarray(jr[0]))
    _agree_up_to_ties(jcfg, jparams, [list(map(int, p)) + [f] for p, f in zip(ps, first)],
                      want, got)
    same = [b for b in range(B) if got[b] == want[b]]
    assert same and tprops[same].tolist() == np.asarray(jr[4])[same].tolist()
    assert (tprops[:B] >= 0).all()


def test_k_exceeding_heads_rejected(setup):
    _, _, cfg, params, sched = setup
    with pytest.raises(ValueError, match="proposer heads"):
        run_engine(cfg, params, sched, mlp(9), prompts(1))


def test_requires_net(setup):
    _, _, cfg, params, sched = setup
    bare = {k: v for k, v in params.items() if k != "mlp_spec"}
    with pytest.raises(ValueError, match="mlp_spec"):
        run_engine(cfg, bare, sched, mlp(2), prompts(1))
    # a tree needs Medusa's heads
    with pytest.raises(ValueError, match="tree"):
        run_engine(cfg, params, sched, mlp(2, medusa_tree=((0,), (0, 0))), prompts(1))
    with pytest.raises(ValueError, match="Medusa heads"):
        run_engine(cfg, params, sched, SpeculativeConfig(
            num_speculative_tokens=2, method="medusa_null", medusa_tree=((0,), (0, 0))),
            prompts(1))


def test_sampling_completes(setup):
    _, _, cfg, params, sched = setup
    sp, eng = run_engine(cfg, params, sched, mlp(3), prompts(3), max_tokens=12, temp=0.8)
    assert all(len(v) <= 12 for v in sp)
    assert eng.spec_metrics.num_emitted_tokens > 0


def test_save_load_roundtrip(tmp_path):
    net = init_mlp_speculator_params(32, 64, k=3, seed=1, scale_input=True, device="cpu")
    p = tmp_path / "net.npz"
    np.savez(p, **{k: v.float().numpy() for k, v in net.items()})
    back = load_mlp_speculator(str(p), device="cpu")
    assert set(back) == set(net)
    assert back["head"].shape == net["head"].shape
    h = torch.zeros((2, 32))
    last = torch.zeros(2, dtype=torch.int32)
    assert torch.equal(mlp_speculator_propose(net, h, last), mlp_speculator_propose(back, h, last))
    want = jmlp.load_mlp_speculator(str(p))
    for k in want:
        np.testing.assert_array_equal(back[k].float().numpy(), np.asarray(want[k], np.float32))


def test_llm_entry_points(setup, tmp_path):
    """LLM(speculative_model="[mlp_speculator]") with the net in params, and
    with a net's .npz (proj_first: MLPSpeculator), give the same tokens;
    EngineArgs names the method and takes medusa_null as its oracle."""
    _, _, cfg, params, _ = setup
    args = EngineArgs(num_speculative_tokens=3, speculative_model="[mlp_speculator]")
    assert args.create_engine_config().speculative.method == "mlp_speculator"
    args.speculative_method = "medusa_null"
    assert args.create_engine_config().speculative.method == "medusa_null"
    kw = dict(device="cpu", num_speculative_tokens=3, block_size=16, max_model_len=256,
              max_num_seqs=4, prefill_chunk_size=64, num_pages=48, seed=0)
    ps = prompts(2)
    sp = SamplingParams(temperature=0.0, max_tokens=10, ignore_eos=True)
    a = LLM(model="tiny", params=params, speculative_model="[mlp_speculator]", **kw)
    outs = [o.output_token_ids for o in a.generate(ps, sp)]
    path = tmp_path / "net.npz"
    np.savez(path, **{k: v.float().numpy() for k, v in params["mlp_spec"].items()})
    bare = {k: v for k, v in params.items() if k != "mlp_spec"}
    b = LLM(model="tiny", params=bare, speculative_model=str(path), **kw)
    assert b.engine_config.speculative.method == "mlp_speculator"
    assert [o.output_token_ids for o in b.generate(ps, sp)] == outs
