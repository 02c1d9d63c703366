"""chip_smoke.py's (M3) rehearsed on the CPU: induction_lm_v2 with the
trained induction_eagle_v1 net through the four loaders of (M3)
(compressed-tensors int8, fp8 and pack-quantized g = 128, the port's
writers; a GGUF Q4_0 file the port writes and load_gguf reads back), each
with greedy QSpec (windowed W4A16 draft, k = 3) and EAGLE (k = 4) == AR, and
the drafted / accepted / emitted counts and copy breaks the card prints
beside its own (chip_smoke.M3_CPU). The card holds QSpec to qspec_null,
which equals AR in the port.
"""

import pytest
import torch

import chip_smoke


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _greedy(eng, ps, max_tokens=32):
    from qspec_tpu_torch import SamplingParams
    ids = [eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens,
                                             ignore_eos=True)) for p in ps]
    outs = {}
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
    m = eng.spec_metrics
    return [outs[i] for i in ids], [m.num_draft_tokens, m.num_draft_accepted,
                                    m.num_emitted_tokens]


@pytest.mark.parametrize("loader", chip_smoke.M3_LOADERS)
def test_trained_pair_through_the_loaders(loader):
    """chip_smoke.py (M3) on the CPU: induction_lm_v2 through ``loader``
    with induction_eagle_v1; QSpec (windowed W4A16 draft, k = 3) ==
    AR and EAGLE (k = 4) == AR; the counts and copy breaks are the
    ones chip_smoke.M3_CPU records for the card to print beside its own."""
    params, cfg = chip_smoke.m3_params(loader, "cpu")
    assert cfg.quant == ("w8" if loader in ("ct-int8", "ct-fp8") else "w4g")
    ps = chip_smoke.m3_prompts(cfg.vocab_size)
    got = {}
    ar, _ = _greedy(chip_smoke.m3_engine(cfg, params, "ar", "cpu"), ps)
    for method in ("qspec", "eagle"):
        toks, got[method] = _greedy(chip_smoke.m3_engine(cfg, params, method, "cpu"), ps)
        assert toks == ar, method
    got["copy_breaks"] = chip_smoke.copy_breaks(ps, ar)
    assert got == chip_smoke.M3_CPU[loader]
