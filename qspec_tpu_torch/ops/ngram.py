"""Device-side n-gram (prompt-lookup) proposal matching.

Port of ``qspec_tpu/ops/ngram.py::ngram_match_device``: the token history
lives in a device tensor and matching is a few shifted compares, so the
rounds read nothing back to the host (``engine/model_runner.py::
ngram_rounds_step``). The JAX package leaves it to XLA, not to a Pallas
kernel; here it is torch ops.

Semantics of the JAX package's host matcher
(``qspec_tpu/spec_decode/ngram.py::NgramProposer``, the tests' reference):
the longest n in [nmin, nmax] whose tail n-gram has an earlier occurrence;
the proposal is the k tokens after the MOST RECENT such occurrence,
truncated at the history's end and padded with the last in-range token.
"""

from __future__ import annotations

import torch


def ngram_match_device(history: torch.Tensor, hist_len: torch.Tensor, *, k: int,
                       nmin: int = 1, nmax: int = 4) -> torch.Tensor:
    """history [B, H] int (tokens 0..hist_len-1 valid), hist_len [B] ->
    proposals [B, k] int32, -1 where no n-gram matches.

    For each n from nmax down to nmin, ``matched[b, w]``: the n tokens from
    w equal the tail n-gram, for window starts w <= hist_len - 1 - n (the
    tail itself, at hist_len - n, is excluded, as the host matcher scans
    hist[:-1]).
    """
    B, H = history.shape
    dev = history.device
    hist_len = hist_len.to(torch.int64)
    k_ar = torch.arange(k, device=dev)[None, :]
    props = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    for n in range(nmax, nmin - 1, -1):
        if n + 1 > H:
            continue
        usable = hist_len >= n + 1          # the tail and at least one earlier token
        tail_idx = (hist_len[:, None] - n).clamp_min(0) + torch.arange(n, device=dev)[None, :]
        tail = history.gather(1, tail_idx.clamp(max=H - 1))
        W = H - n + 1                       # candidate window starts
        matched = torch.ones((B, W), dtype=torch.bool, device=dev)
        for j in range(n):
            matched &= history[:, j:j + W] == tail[:, j:j + 1]
        w_ar = torch.arange(W, device=dev)[None, :]
        valid = w_ar <= hist_len[:, None] - 1 - n
        w_best = torch.where(matched & valid, w_ar, -1).amax(dim=1)          # [B]
        hit = usable & (w_best >= 0)
        gather = torch.minimum(w_best[:, None] + n + k_ar,
                               (hist_len[:, None] - 1).clamp_min(0))
        cand = history.gather(1, gather.clamp_min(0)).to(torch.int32)
        props = torch.where((hit & ~found)[:, None], cand, props)
        found = found | hit
    return props
