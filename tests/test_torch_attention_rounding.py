"""The plain attention's ``bf16_products`` rounding against the JAX Pallas
kernel in interpret mode, on the CPU.

``paged_attention_ref(..., bf16_products=True)`` rounds q times the scale
and the probabilities to bf16 where the Pallas body does
(``qspec_tpu/ops/attention_pallas.py:128, 208``). q's rounding is then the
same on both sides. What is left is rounding: each side rounds a
probability to bf16 (2^-8 of itself at most), the Pallas body against its
running maximum and the plain version against the row's, where the row
maximum's own weight is 1 on both sides; and each rounds its output to
bf16, which can leave the two one bf16 ulp (2^-7 of the value) apart. The
tolerance, here and in ``chip_smoke.py``'s tree check on the card:
atol = 2^-8 max|v|, rtol = 2^-7. Queries are scaled by 4 (a sharp
softmax), as there; the rectangle is the Medusa tree verify's
(DEFAULT_TREE after a prefix).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.ops.attention_pallas import paged_attention_pallas
from qspec_tpu_torch.ops import kv_cache as tkv
from qspec_tpu_torch.ops.attention import paged_attention_ref, tree_mask
from qspec_tpu_torch.spec_decode.medusa_tree import DEFAULT_TREE, build_tree

ATOL_OF_VMAX = 2.0 ** -8    # a probability's bf16 rounding, times max|v|
RTOL = 2.0 ** -7            # one bf16 ulp of the output


@pytest.mark.parametrize("prefix,window", [(3, None), (5, None), (5, 40)])
def test_bf16_products_match_pallas_tree(prefix, window):
    rng = np.random.default_rng(prefix)
    tspec = build_tree(DEFAULT_TREE)
    B, Hq, Hkv, D, S, P = 2, 4, 2, 128, 8, 24
    jpages = jnp.asarray(rng.standard_normal((1, P, 2, Hkv, S, D)).astype(np.float32),
                         jnp.bfloat16)
    tcache = tkv.PagedKVCache(torch.tensor(np.asarray(jpages, np.float32)).to(torch.bfloat16))
    Q = prefix + tspec.num_nodes
    q = jnp.asarray(4 * rng.standard_normal((B, Q, Hq, D)).astype(np.float32), jnp.bfloat16)
    tables = rng.permutation(np.arange(1, 21)).reshape(B, 10).astype(np.int32)
    root = np.asarray([40, 62], np.int32)
    pos = np.concatenate([(root - (prefix - 1))[:, None] + np.arange(prefix)[None],
                          root[:, None] + np.asarray(tspec.depth)[None]], 1).astype(np.int32)
    ctx = (root + 1 + tspec.num_nodes).astype(np.int32)
    scale = D ** -0.5
    want = np.asarray(paged_attention_pallas(
        q, jpages, jnp.asarray(tables), jnp.asarray(ctx), scale,
        q_positions=jnp.asarray(pos), window=window, tree=(prefix, tspec.ancestors)),
        np.float32)
    args = (torch.tensor(np.asarray(q, np.float32)).to(torch.bfloat16), tcache, 0,
            torch.tensor(tables), torch.tensor(ctx), scale)
    kw = dict(q_positions=torch.tensor(pos), window=window,
              tree=tree_mask(prefix, tspec.ancestors, "cpu"))
    got = paged_attention_ref(*args, bf16_products=True, **kw).float().numpy()
    # under a window the JAX kernel bounds a tree row by its root, the port
    # by the node's own position (tests/test_torch_medusa.py): prefix rows only
    rows = slice(None) if window is None else slice(0, prefix)
    vmax = tcache.kv_pages[:, :, 1].float().abs().max().item()
    err = np.abs(got - want)[:, rows]
    assert (err <= ATOL_OF_VMAX * vmax + RTOL * np.abs(want[:, rows])).all(), err.max()
    # the f32 version differs from both by q's rounding, which this one shares
    f32 = paged_attention_ref(*args, **kw).float().numpy()
    assert not np.array_equal(f32, got)


def test_bf16_products_take_a_bf16_cache_only():
    cache = tkv.PagedKVCache(torch.zeros(1, 2, 2, 1, 8, 64, dtype=torch.int8),
                             torch.ones(1, 2, 2, 1, 8))
    with pytest.raises(ValueError, match="bf16 cache"):
        paged_attention_ref(torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16), cache, 0,
                            torch.ones(1, 1, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
                            0.125, bf16_products=True)
