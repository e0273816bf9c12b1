"""Conversation prompt templates, copied from
callireader_tpu/runtime/conversation.py (the port imports nothing of the JAX
package).

Parity target: InternVL/conversation.py — a registry of chat
templates rendered by separator style. The CalliReader pipeline uses
``internlm2-chat`` (:358-374, MPT separator style :238-247):

  <|im_start|>system\n{system}<|im_end|><|im_start|>user\n{q}<|im_end|><|im_start|>assistant\n

(no newline after <|im_end|>; roles carry a trailing newline). The other
registered templates cover the model families the training stack fine-tunes
(vicuna/llama2/llama3/phi3/chatml-style), rendered from their public prompt
specs rather than translated from the reference table.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

DEFAULT_SYSTEM = (
    "你是由上海人工智能实验室联合商汤科技开发的书生多模态大模型，"
    "英文名叫InternVL, 是一个有用无害的人工智能助手。"
)


class SeparatorStyle(enum.Enum):
    MPT = enum.auto()            # system+sep, role+msg+sep  (internlm2 / chatml)
    ADD_COLON_TWO = enum.auto()  # vicuna: "role: msg" + alternating sep/sep2
    LLAMA2 = enum.auto()         # [INST] ... [/INST] blocks
    LLAMA3 = enum.auto()         # <|start_header_id|>role<|end_header_id|>
    PLAIN = enum.auto()          # bare alternating messages joined by sep


@dataclasses.dataclass
class Conversation:
    name: str = "internlm2-chat"
    system_template: str = "<|im_start|>system\n{system_message}"
    system_message: str = DEFAULT_SYSTEM
    roles: Tuple[str, str] = ("<|im_start|>user\n", "<|im_start|>assistant\n")
    sep_style: SeparatorStyle = SeparatorStyle.MPT
    sep: str = "<|im_end|>"
    sep2: Optional[str] = None
    stop_token_ids: Tuple[int, ...] = (2, 92543, 92542)
    stop_str: Optional[str] = None
    messages: List[List[Optional[str]]] = dataclasses.field(default_factory=list)

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        system = (
            self.system_template.format(system_message=self.system_message)
            if self.system_message
            else ""
        )
        if self.sep_style is SeparatorStyle.MPT:
            ret = system + self.sep if system else ""
            for role, message in self.messages:
                ret += role + message + self.sep if message else role
            return ret
        if self.sep_style is SeparatorStyle.ADD_COLON_TWO:
            seps = (self.sep, self.sep2 or self.sep)
            ret = system + seps[0] if system else ""
            for i, (role, message) in enumerate(self.messages):
                ret += f"{role}: {message}{seps[i % 2]}" if message else f"{role}:"
            return ret
        if self.sep_style is SeparatorStyle.LLAMA2:
            seps = (self.sep, self.sep2 or self.sep)
            ret = ""
            for i, (role, message) in enumerate(self.messages):
                if message:
                    prefix = system + message if i == 0 and system else message
                    ret += f"{role} {prefix} {seps[i % 2]}" if i % 2 == 0 else f"{prefix}{seps[i % 2]}"
                else:
                    ret += role
            return ret
        if self.sep_style is SeparatorStyle.LLAMA3:
            ret = f"<|begin_of_text|>{system}{self.sep}" if system else "<|begin_of_text|>"
            for role, message in self.messages:
                ret += role + (message + self.sep if message else "")
            return ret
        # PLAIN
        ret = ""
        for _role, message in self.messages:
            ret += (message or "") + self.sep
        return ret

    def copy(self) -> "Conversation":
        return dataclasses.replace(self, messages=[list(m) for m in self.messages])


_TEMPLATES: dict = {}


def register_conv_template(conv: Conversation) -> None:
    _TEMPLATES[conv.name] = conv


def get_conv_template(name: str) -> Conversation:
    return _TEMPLATES[name].copy()


register_conv_template(Conversation(name="internlm2-chat"))
register_conv_template(
    Conversation(
        name="internvl2_5",
        system_message="你是书生·万象，英文名是InternVL，是由上海人工智能实验室、"
        "清华大学及多家合作单位联合开发的多模态大语言模型。",
    )
)
register_conv_template(
    Conversation(
        name="Hermes-2",
        system_message="Answer the questions.",
        stop_token_ids=(2, 6, 7, 8),
        stop_str="<|endoftext|>",
    )
)
register_conv_template(
    Conversation(
        name="phi3-chat",
        system_template="<|system|>\n{system_message}",
        system_message="Answer the questions.",
        roles=("<|user|>\n", "<|assistant|>\n"),
        sep="<|end|>",
        stop_token_ids=(2, 32000, 32007),
    )
)
register_conv_template(
    Conversation(
        name="llama3-chat",
        system_template="<|start_header_id|>system<|end_header_id|>\n\n{system_message}",
        system_message="You are an AI assistant whose name is InternVL.",
        roles=(
            "<|start_header_id|>user<|end_header_id|>\n\n",
            "<|start_header_id|>assistant<|end_header_id|>\n\n",
        ),
        sep_style=SeparatorStyle.LLAMA3,
        sep="<|eot_id|>",
        stop_token_ids=(128000, 128001, 128009),
    )
)
register_conv_template(
    Conversation(
        name="vicuna_v1.1",
        system_template="{system_message}",
        system_message="A chat between a curious user and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite answers to the "
        "user's questions.",
        roles=("USER", "ASSISTANT"),
        sep_style=SeparatorStyle.ADD_COLON_TWO,
        sep=" ",
        sep2="</s>",
    )
)
register_conv_template(
    Conversation(
        name="llama2-chat",
        system_template="<<SYS>>\n{system_message}\n<</SYS>>\n\n",
        system_message="You are a helpful, respectful and honest assistant.",
        roles=("[INST]", "[/INST]"),
        sep_style=SeparatorStyle.LLAMA2,
        sep=" ",
        sep2="</s>",
    )
)
register_conv_template(
    Conversation(
        name="internvl_zh",
        system_template="",
        system_message="",
        roles=("<human>", "<bot>"),
        sep_style=SeparatorStyle.ADD_COLON_TWO,
        sep=" ",
        sep2="</s>",
    )
)


def build_chat_prompt(
    question: str,
    history: Optional[List[Tuple[str, str]]] = None,
    system_message: Optional[str] = None,
    template: str = "internlm2-chat",
) -> Conversation:
    conv = get_conv_template(template)
    if system_message is not None:
        conv.system_message = system_message
    for old_q, old_a in history or []:
        conv.append_message(conv.roles[0], old_q)
        conv.append_message(conv.roles[1], old_a)
    conv.append_message(conv.roles[0], question)
    conv.append_message(conv.roles[1], None)
    return conv
