"""Incremental detokenization: the port's copy of ``qspec_tpu/detokenizer.py``.

Streaming text and stop-string checks must not re-decode the whole output
every step, which is O(n^2) over a long generation. Each sequence carries a
DetokState (prefix_offset / read_offset / accumulated text); every update
decodes only a short token window and appends the newly *stable* text (a
multi-byte character split across tokens is held back until it completes,
signalled by a trailing U+FFFD from the tokenizer).
"""

from __future__ import annotations

from typing import List


class DetokState:
    """Per-sequence incremental decode state."""

    __slots__ = ("prefix_offset", "read_offset", "text")

    def __init__(self) -> None:
        self.prefix_offset = 0   # start of the context window
        self.read_offset = 0     # tokens already represented in `text`
        self.text = ""


def detokenize_incrementally(tokenizer, token_ids: List[int],
                             state: DetokState) -> str:
    """Extend ``state.text`` with the text of token_ids[read_offset:].

    Decodes only the window [prefix_offset:], never the full sequence. Text
    is appended only once it is byte-stable: if the window decode ends in
    U+FFFD the trailing tokens are part of an incomplete UTF-8 sequence and
    emission waits for the next call. Returns the accumulated text.
    """
    n = len(token_ids)
    if n <= state.read_offset:
        return state.text
    prefix_text = tokenizer.decode(
        token_ids[state.prefix_offset:state.read_offset])
    new_text = tokenizer.decode(token_ids[state.prefix_offset:])
    if new_text.endswith("�"):
        # incomplete multi-byte sequence: hold back, re-decode next call
        return state.text
    if len(new_text) > len(prefix_text):
        state.text += new_text[len(prefix_text):]
    state.prefix_offset = state.read_offset
    state.read_offset = n
    return state.text
