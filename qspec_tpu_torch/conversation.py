"""Conversation templates: the port's copy of ``qspec_tpu/conversation.py``.

A small registry of fastchat-style chat templates, usable without a
tokenizer's ``apply_chat_template``: ``LLM.chat`` falls back on them (the
"llama-3" template by default) when the tokenizer has none.
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import Dict, List, Optional, Tuple


class SeparatorStyle(Enum):
    ADD_COLON_SINGLE = auto()
    ADD_COLON_TWO = auto()
    LLAMA3 = auto()
    CHATML = auto()
    RAW = auto()


@dataclasses.dataclass
class Conversation:
    name: str
    system_template: str = "{system_message}"
    system_message: str = ""
    roles: Tuple[str, str] = ("USER", "ASSISTANT")
    messages: List[Tuple[str, Optional[str]]] = dataclasses.field(default_factory=list)
    sep_style: SeparatorStyle = SeparatorStyle.ADD_COLON_SINGLE
    sep: str = "\n"
    sep2: str = ""
    stop_str: Optional[str] = None

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append((role, message))

    def get_prompt(self) -> str:
        system = self.system_template.format(system_message=self.system_message) \
            if self.system_message else ""
        if self.sep_style == SeparatorStyle.RAW:
            return system + self.sep.join(m for _, m in self.messages if m)
        if self.sep_style == SeparatorStyle.LLAMA3:
            out = "<|begin_of_text|>"
            if self.system_message:
                out += ("<|start_header_id|>system<|end_header_id|>\n\n"
                        f"{self.system_message}<|eot_id|>")
            for role, msg in self.messages:
                out += f"<|start_header_id|>{role}<|end_header_id|>\n\n"
                if msg:
                    out += f"{msg}<|eot_id|>"
            return out
        if self.sep_style == SeparatorStyle.CHATML:
            out = (system + self.sep) if system else ""
            for role, msg in self.messages:
                if msg:
                    out += f"<|im_start|>{role}\n{msg}<|im_end|>{self.sep}"
                else:
                    out += f"<|im_start|>{role}\n"
            return out
        # colon styles
        seps = [self.sep, self.sep2 or self.sep]
        out = system + seps[0] if system else ""
        for i, (role, msg) in enumerate(self.messages):
            if msg:
                out += f"{role}: {msg}{seps[i % 2]}"
            else:
                out += f"{role}:"
        return out

    def copy(self) -> "Conversation":
        return dataclasses.replace(self, messages=list(self.messages))


_TEMPLATES: Dict[str, Conversation] = {}


def register_conv_template(t: Conversation) -> None:
    _TEMPLATES[t.name] = t


def get_conv_template(name: str) -> Conversation:
    return _TEMPLATES[name].copy()


register_conv_template(Conversation(
    name="raw", sep_style=SeparatorStyle.RAW, roles=("", "")))

register_conv_template(Conversation(
    name="one_shot",
    system_message="A chat between a curious human and an artificial "
                   "intelligence assistant.",
    roles=("Human", "Assistant"),
    sep_style=SeparatorStyle.ADD_COLON_SINGLE,
    sep="\n### ",
    stop_str="###"))

register_conv_template(Conversation(
    name="vicuna_v1.1",
    system_message="A chat between a curious user and an artificial "
                   "intelligence assistant. The assistant gives helpful, "
                   "detailed, and polite answers to the user's questions.",
    roles=("USER", "ASSISTANT"),
    sep_style=SeparatorStyle.ADD_COLON_TWO,
    sep=" ", sep2="</s>"))

register_conv_template(Conversation(
    name="llama-3", roles=("user", "assistant"),
    sep_style=SeparatorStyle.LLAMA3, stop_str="<|eot_id|>"))

register_conv_template(Conversation(
    name="qwen-7b-chat", roles=("user", "assistant"),
    system_message="You are a helpful assistant.",
    sep_style=SeparatorStyle.CHATML, sep="\n", stop_str="<|im_end|>"))
