"""Token-level grammar FSM: byte DFA x vocabulary -> device transition table.

The per-token transition table T[s, v] = DFA state after emitting token v
from state s (-1 = v not allowed at s) is precomputed once per grammar
(vectorized over the vocab, looping only states x max-token-length) and
lives on the engine's device as int32 [S, V] (engine/model_runner.py keeps
one copy a grammar there). Guided decoding then costs one gather per step
inside the rounds, with no host round-trip, and speculative verification
re-masks every draft position by advancing states through the proposed
tokens (see ops/sampling.grammar_* and engine/model_runner).

The port's copy of ``qspec_tpu/guided/tokenfsm.py``. Reference counterpart:
vllm/model_executor/guided_decoding/outlines_logits_processors.py walks
outlines' lazily-materialized states_to_token_maps per step on the host;
precomputing the table dense and resident is the same automaton.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from qspec_tpu_torch.guided.json_schema import schema_to_regex
from qspec_tpu_torch.guided.regex_dfa import ByteDFA, compile_regex


class TokenFSM:
    """next_state: np [S, V] int32, -1 disallowed. State 0 is the start.

    EOS is allowed exactly in accepting states and self-loops (the sequence
    is finished once it's emitted). Tokens whose byte sequence dies in the
    DFA — or that are special ids with no grammar meaning — are disallowed.
    """

    def __init__(self, next_state: np.ndarray, pattern: str):
        self.next_state = next_state
        self.pattern = pattern

    @property
    def num_states(self) -> int:
        return self.next_state.shape[0]

    def allowed(self, state: int) -> np.ndarray:
        return self.next_state[state] >= 0


def build_token_fsm(dfa: ByteDFA, vocab: Sequence[Optional[bytes]],
                    eos_token_id: Optional[int], pattern: str = "") -> TokenFSM:
    """vocab[v]: UTF-8 bytes of token v, or None for special/unmappable
    tokens (always disallowed, except EOS which follows acceptance)."""
    V = len(vocab)
    S = dfa.num_states
    maxlen = max((len(b) for b in vocab if b), default=1)
    # byte matrix [V, maxlen] + lengths
    bmat = np.zeros((V, maxlen), np.int32)
    blen = np.zeros((V,), np.int32)
    for v, b in enumerate(vocab):
        if not b:
            continue
        blen[v] = len(b)
        bmat[v, :len(b)] = np.frombuffer(b, np.uint8)

    table = np.full((S, V), -1, np.int32)
    char_t = dfa.table  # [S, 256]
    for s in range(S):
        cur = np.full((V,), s, np.int32)
        for p in range(maxlen):
            live = (blen > p) & (cur >= 0)
            nxt = np.where(live, char_t[np.maximum(cur, 0), bmat[:, p]], cur)
            cur = np.where(live, nxt, cur)
        cur = np.where(blen > 0, cur, -1)
        table[s] = cur
    if eos_token_id is not None and 0 <= eos_token_id < V:
        table[:, eos_token_id] = np.where(dfa.accepting,
                                          np.arange(S, dtype=np.int32), -1)
    return TokenFSM(table, pattern)


class GrammarCompiler:
    """Compiles and caches TokenFSMs for a fixed vocabulary.

    ``vocab`` is a list of token byte-strings indexed by token id (None for
    specials). Engine-level construction passes the tokenizer's vocab; tests
    use toy vocabularies.
    """

    def __init__(self, vocab: Sequence[Optional[bytes]],
                 eos_token_id: Optional[int] = None):
        self.vocab = list(vocab)
        self.eos_token_id = eos_token_id
        self._cache: dict = {}

    def from_regex(self, pattern: str) -> TokenFSM:
        key = ("regex", pattern)
        if key not in self._cache:
            dfa = compile_regex(pattern)
            self._cache[key] = build_token_fsm(dfa, self.vocab,
                                               self.eos_token_id, pattern)
        return self._cache[key]

    def from_json_schema(self, schema) -> TokenFSM:
        import json
        canon = schema if isinstance(schema, str) else \
            json.dumps(schema, sort_keys=True)
        key = ("schema", canon)
        if key not in self._cache:
            self._cache[key] = self.from_regex(schema_to_regex(schema))
            self._cache[key] = TokenFSM(self._cache[key].next_state,
                                        f"schema:{canon[:60]}")
        return self._cache[key]

    def from_choice(self, choices: List[str]) -> TokenFSM:
        from qspec_tpu_torch.guided.json_schema import _esc
        return self.from_regex("(" + "|".join(_esc(c) for c in choices) + ")")


def hf_vocab_bytes(tokenizer) -> List[Optional[bytes]]:
    """Token-id -> emitted bytes for a HuggingFace tokenizer, resolving
    byte-level BPE mangling (Ġ -> space etc.) via convert_tokens_to_string
    on each token; specials map to None."""
    size = getattr(tokenizer, "vocab_size", None) or len(tokenizer)
    try:
        size = max(size, max(tokenizer.get_vocab().values()) + 1)
    except Exception:
        pass
    out: List[Optional[bytes]] = [None] * size
    special = set(getattr(tokenizer, "all_special_ids", []) or [])
    vocab = tokenizer.get_vocab()
    for tok, idx in vocab.items():
        if idx >= size or idx in special:
            continue
        try:
            s = tokenizer.convert_tokens_to_string([tok])
        except Exception:
            continue
        out[idx] = s.encode("utf-8")
    return out
