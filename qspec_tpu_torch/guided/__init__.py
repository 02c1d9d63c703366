"""Grammar-guided decoding: regex / JSON-schema -> token-level FSMs whose
transition tables live on the engine's device and advance inside the decode
and speculative rounds (reference: vllm/model_executor/guided_decoding/).

The port's copy of ``qspec_tpu/guided/``: pure Python and numpy, the same
tables bit for bit."""

from qspec_tpu_torch.guided.json_schema import schema_to_regex
from qspec_tpu_torch.guided.regex_dfa import ByteDFA, compile_regex
from qspec_tpu_torch.guided.tokenfsm import (GrammarCompiler, TokenFSM,
                                       build_token_fsm, hf_vocab_bytes)

__all__ = ["schema_to_regex", "ByteDFA", "compile_regex", "GrammarCompiler",
           "TokenFSM", "build_token_fsm", "hf_vocab_bytes"]
