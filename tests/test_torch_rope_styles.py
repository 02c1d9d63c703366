"""The rotary embedding's two pairings and its partial width against the
JAX package, on the CPU.

``ops/rotary.py::apply_rope`` in the neox (half-split) and gptj
(interleaved) styles, over the whole head and over a part of it, against
``qspec_tpu.ops.rotary.apply_rope`` on the same inputs (made with numpy from
a seed), to 1e-6; the partial cache against the JAX one; the rotation's
relative-position property; and a tiny QuaRot Llama with the gptj rope over
half its head through both packages' ``model_forward`` (the JAX Pallas
kernels in interpret mode), at tests/test_torch_model.py's tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.config import ModelConfig as JModelConfig
from qspec_tpu.models import llama as jllama
from qspec_tpu.ops import rotary as jrotary
from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.ops import rotary as trotary
from tests.test_torch_model import REL_TOL, TIE_GAP, _forward_both

T, HQ, HK, D = 37, 4, 2, 64
# (style, rotated width): the whole head, half of it (GLM, Phi), a quarter
# (Pythia, StableLM) and GPT-J's 64 of 256 scaled down (an eighth)
CASES = [(s, rd) for s in ("neox", "gptj") for rd in (D, D // 2, D // 4, D // 8)]


def inputs(seed=0, dtype=np.float32):
    r = np.random.default_rng(seed)
    q = r.standard_normal((T, HQ, D)).astype(dtype)
    k = r.standard_normal((T, HK, D)).astype(dtype)
    pos = r.integers(0, 500, size=T).astype(np.int32)
    return q, k, pos


@pytest.mark.parametrize("style,rd", CASES)
def test_apply_rope_matches_jax(style, rd):
    """float32 q / k, positions up to 500, base 10000: the port's rotation
    equals the JAX one within 1e-6, the dims past ``rd`` untouched."""
    q, k, pos = inputs()
    jcache = jrotary.make_rope_cache(rd, 512, 10000.0)
    tcache = trotary.make_rope_cache(rd, 512, 10000.0)
    np.testing.assert_array_equal(tcache.numpy(), np.asarray(jcache))
    jq, jk = jrotary.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), jcache,
                                style=style)
    tq, tk = trotary.apply_rope(torch.tensor(q), torch.tensor(k), torch.tensor(pos), tcache,
                                style)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tq.numpy()[..., rd:], q[..., rd:])
    assert not np.allclose(tq.numpy()[..., :rd], q[..., :rd])


@pytest.mark.parametrize("style", ["neox", "gptj"])
def test_apply_rope_bf16_matches_jax(style):
    """bf16 q / k (the model's dtype), half the head rotated: both packages
    rotate in float32 and round once, so the results are equal."""
    q, k, pos = inputs(1)
    tq, tk = (torch.tensor(a).to(torch.bfloat16) for a in (q, k))
    jq, jk = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (tq, tk))
    cache = jrotary.make_rope_cache(D // 2, 512, 10000.0)
    jout = jrotary.apply_rope(jq, jk, jnp.asarray(pos), cache, style=style)
    tout = trotary.apply_rope(tq, tk, torch.tensor(pos), torch.tensor(np.asarray(cache)), style)
    for j, t in zip(jout, tout):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))


@pytest.mark.parametrize("style,rd", CASES)
def test_rotation_keeps_relative_positions(style, rd):
    """Both pairings are rotations of pairs by angles linear in the
    position: a q at p and a k at p' score q . k by p - p' alone, and the
    norm of each row is kept (to the float32 cache's and rotation's
    rounding)."""
    r = np.random.default_rng(2)
    q = torch.tensor(r.standard_normal((1, 1, D)))
    k = torch.tensor(r.standard_normal((1, 1, D)))
    cache = trotary.make_rope_cache(rd, 512, 10000.0).to(torch.float64)

    def score(p, pk):
        qr, _ = trotary.apply_rope(q, q, torch.tensor([p]), cache, style)
        kr, _ = trotary.apply_rope(k, k, torch.tensor([pk]), cache, style)
        return float((qr * kr).sum()), float(qr.norm())
    base, norm = score(7, 3)
    for p in (11, 100, 400):
        s, n = score(p, p - 4)
        assert abs(s - base) < 1e-5 and abs(n - norm) < 1e-5


def test_rope_refuses_an_unknown_style_and_odd_widths():
    with pytest.raises(NotImplementedError, match="rope_style"):
        ModelConfig.tiny(rope_style="glm")
    for bad in (0, 3, D + 2):
        with pytest.raises(ValueError, match="rotary_dim"):
            ModelConfig.tiny(rotary_dim=bad)


# a tiny QuaRot Llama whose heads (64) rope their first 32 dims, gptj style
PARTIAL = dict(rotary_dim=32, rope_style="gptj")


@pytest.fixture(scope="module")
def models():
    """The JAX init_params of the tiny QuaRot Llama with the partial gptj
    rope (its cache rebuilt at the rotated width), carried over by
    params_from_numpy."""
    jcfg = dataclasses.replace(JModelConfig.tiny(), **PARTIAL)
    tcfg = ModelConfig.tiny(**PARTIAL)
    jparams = jllama.init_params(jcfg, seed=0)
    jparams["rope_cache"] = jrotary.make_rope_cache(32, jcfg.max_position_embeddings,
                                                    jcfg.rope_theta)
    tparams = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                       device="cpu")
    assert tparams["rope_cache"].shape[-1] == 16
    init = tllama.init_params(tcfg, device="cpu")
    assert init["rope_cache"].shape == tparams["rope_cache"].shape
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("scheme", ["w4a16", "w4a8"])
def test_partial_gptj_rope_in_the_model_matches_jax(models, scheme):
    """A prefill rectangle and a verify-shaped step through both packages:
    relative L2 within REL_TOL, the port's argmax within TIE_GAP of the JAX
    maximum; at W4A16, with the neox pairing the port's logits are more
    than 4 times as far from the JAX ones (the style reaches the layers;
    W4A8's activation codes alone move the logits by a third of that)."""
    rng = np.random.default_rng(11)
    B, Q = 2, 12
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    toks = rng.integers(1, 512, size=(B, Q)).astype(np.int32)
    pos = np.tile(np.arange(Q, dtype=np.int32), (B, 1))
    step = (rng.integers(1, 512, size=(B, 4)).astype(np.int32),
            Q + np.tile(np.arange(4, dtype=np.int32), (B, 1)), np.full(B, Q + 4, np.int32))
    outs = _forward_both(models, scheme, toks, pos, np.full(B, Q, np.int32), tables,
                         steps=[step])
    rels = []
    for jl, tl in outs:
        rels.append(np.linalg.norm(tl - jl) / np.linalg.norm(jl))
        assert rels[-1] <= REL_TOL[scheme], rels[-1]
        pick = tl.argmax(-1)
        gap = jl.max(-1) - np.take_along_axis(jl, pick[..., None], -1)[..., 0]
        assert gap.max() <= TIE_GAP[scheme]
    if scheme != "w4a16":
        return
    jcfg, jparams, tcfg, tparams = models
    neox = (jcfg, jparams, dataclasses.replace(tcfg, rope_style="neox"), tparams)
    (jl, tl), _ = _forward_both(neox, scheme, toks, pos, np.full(B, Q, np.int32), tables,
                                steps=[step])
    assert np.linalg.norm(tl - jl) / np.linalg.norm(jl) > 4 * rels[0]
