"""Prompt-template registry for the SFT data pipeline (a copy of
callireader_tpu/train/templates.py; it tokenizes with the port's
runtime/tokenizer.py).

Parity target: train/xtuner/utils/templates.py PROMPT_TEMPLATE (27 model
families) and SYSTEM_TEMPLATE (task system prompts). The template strings are
the reference's constants — they define each model family's chat wire format
and cannot differ. Turn layout (templates.py:4-7):

  Turn 0:   SYSTEM + INSTRUCTION, [output + SUFFIX], SEP
  Turn 1+:  INSTRUCTION, [output + SUFFIX], SEP      ([...] = supervised)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PromptTemplate:
    name: str
    instruction: str                      # contains {input} (and maybe {round})
    system: Optional[str] = None          # contains {system}
    suffix: str = ""
    suffix_as_eos: bool = False
    sep: str = ""
    stop_words: Tuple[str, ...] = ()


_T: Dict[str, PromptTemplate] = {}


def _reg(name, instruction, system=None, suffix="", suffix_as_eos=False,
         sep="", stop_words=()):
    _T[name] = PromptTemplate(
        name=name, instruction=instruction, system=system, suffix=suffix,
        suffix_as_eos=suffix_as_eos, sep=sep, stop_words=tuple(stop_words),
    )


_reg("default", "<|User|>:{input}\n<|Bot|>:", "<|System|>:{system}\n", sep="\n")
_reg("zephyr", "<|user|>\n{input}\n<|assistant|>\n", "<|system|>\n{system}\n", sep="\n")
_reg("internlm_chat", "<|User|>:{input}<eoh>\n<|Bot|>:", "<|System|>:{system}\n",
     suffix="<eoa>", suffix_as_eos=True, sep="\n", stop_words=["<eoa>"])
_reg("internlm2_chat",
     "<|im_start|>user\n{input}<|im_end|>\n<|im_start|>assistant\n",
     "<|im_start|>system\n{system}<|im_end|>\n",
     suffix="<|im_end|>", suffix_as_eos=True, sep="\n", stop_words=["<|im_end|>"])
_reg("moss_sft", "<|Human|>: {input}<eoh>\n", "{system}\n", sep="\n",
     stop_words=["<eoc>", "<eom>"])
_reg("llama2_chat", "[INST] {input} [/INST]",
     "[INST] <<SYS>>\n You are a helpful, respectful and honest assistant. "
     "Always answer as helpfully as possible, while being safe. Your answers "
     "should not include any harmful, unethical, racist, sexist, toxic, "
     "dangerous, or illegal content. Please ensure that your responses are "
     "socially unbiased and positive in nature.\n{system}\n<</SYS>>\n [/INST] ",
     sep="\n")
_reg("code_llama_chat", "[INST] {input} [/INST]", "{system}\n")
_reg("chatglm2", "[Round {round}]\n\n问：{input}\n\n答：", "{system}\n", sep="\n\n")
_reg("chatglm3", "<|user|>\n{input}<|assistant|>\n", "<|system|>\n{system}", sep="\n")
_reg("qwen_chat",
     "<|im_start|>user\n{input}<|im_end|>\n<|im_start|>assistant\n",
     "<|im_start|>system\n{system}<|im_end|>\n",
     suffix="<|im_end|>", suffix_as_eos=True, sep="\n",
     stop_words=["<|im_end|>", "<|endoftext|>"])
_reg("baichuan_chat", "<reserved_102>{input}<reserved_103>", "{system}\n", sep="\n")
_reg("baichuan2_chat", "<reserved_106>{input}<reserved_107>", "{system}\n", sep="\n")
_reg("wizardlm", "USER: {input} ASSISTANT:",
     "A chat between a curious user and an artificial intelligence "
     "assistant. The assistant gives helpful, detailed, and polite answers "
     "to the user's questions. {system}\n ", sep="\n")
_reg("wizardcoder", "### Instruction:\n{input}\n\n### Response:",
     "Below is an instruction that describes a task. Write a response that "
     "appropriately completes the request.\n\n{system}\n ", sep="\n\n")
_reg("vicuna", "USER: {input} ASSISTANT:",
     "A chat between a curious user and an artificial intelligence "
     "assistant. The assistant gives helpful, detailed, and polite answers "
     "to the user's questions. {system}\n ", sep="\n")
_DEEPSEEK_CODER_SYS = (
    "You are an AI programming assistant, utilizing the DeepSeek Coder "
    "model, developed by DeepSeekCompany, and you only answer questions "
    "related to computer science. For politically sensitive questions, "
    "security and privacy issues, and other non-computer science questions, "
    "you will refuse to answer. {system}\n"
)
_reg("deepseek_coder", "### Instruction:\n{input}\n### Response:\n",
     _DEEPSEEK_CODER_SYS, sep="\n")
_reg("deepseekcoder", "### Instruction:\n{input}\n### Response:\n",
     _DEEPSEEK_CODER_SYS, sep="\n")  # deprecated alias kept for parity
_reg("deepseek_moe", "[INST] {input} [/INST]", "[INST] {system} [/INST]\n", sep="\n")
_reg("deepseek_v2", "User: {input}\n\nAssistant: ", "{system}\n\n",
     suffix="<｜end▁of▁sentence｜>", suffix_as_eos=True,
     stop_words=["<｜end▁of▁sentence｜>"])
_reg("mistral", "[INST] {input} [/INST]", "[INST] {system} [/INST]\n", sep="\n")
_reg("mixtral", "[INST] {input} [/INST]", "[INST] {system} [/INST]\n", sep="\n")
_reg("minicpm", "<用户> {input} <AI>", sep="\n")
_reg("gemma",
     "<start_of_turn>user\n{input}<end_of_turn>\n<start_of_turn>model\n",
     "<start_of_turn>system\n{system}<end_of_turn>\n",
     suffix="<end_of_turn>", suffix_as_eos=False, sep="\n",
     stop_words=["<end_of_turn>"])
_reg("cohere_chat",
     "<|START_OF_TURN_TOKEN|><|USER_TOKEN|>{input}<|END_OF_TURN_TOKEN|>"
     "<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>",
     "<|START_OF_TURN_TOKEN|><|SYSTEM_TOKEN|>{system}<|END_OF_TURN_TOKEN|>",
     suffix="<|END_OF_TURN_TOKEN|>", suffix_as_eos=True,
     stop_words=["<|END_OF_TURN_TOKEN|>"])
_reg("llama3_chat",
     "<|start_header_id|>user<|end_header_id|>\n\n{input}<|eot_id|>"
     "<|start_header_id|>assistant<|end_header_id|>\n\n",
     "<|start_header_id|>system<|end_header_id|>\n\n{system}<|eot_id|>",
     suffix="<|eot_id|>", suffix_as_eos=True, stop_words=["<|eot_id|>"])
_reg("phi3_chat", "<|user|>\n{input}<|end|>\n<|assistant|>\n",
     "<|system|>\n{system}<|end|>\n",
     suffix="<|end|>", suffix_as_eos=True, sep="\n", stop_words=["<|end|>"])

PROMPT_TEMPLATES: Dict[str, PromptTemplate] = dict(_T)

# task system prompts (SYSTEM_TEMPLATE, templates.py:170-193)
SYSTEM_TEMPLATE: Dict[str, str] = {
    "moss_sft": (
        "You are an AI assistant whose name is {bot_name}.\n"
        "Capabilities and tools that {bot_name} can possess.\n"
        "- Inner thoughts: enabled.\n"
        "- Web search: enabled. API: Search(query)\n"
        "- Calculator: enabled. API: Calculate(expression)\n"
        "- Equation solver: enabled. API: Solve(equation)\n"
        "- Text-to-image: disabled.\n"
        "- Image edition: disabled.\n"
        "- Text-to-speech: disabled.\n"
    ),
    "alpaca": (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n"
    ),
    "arxiv_gentile": (
        "If you are an expert in writing papers, please generate a good "
        "paper title for this paper based on other authors' descriptions of "
        "their abstracts.\n"
    ),
    "colorist": (
        "You are a professional color designer. Please provide the "
        "corresponding colors based on the description of Human.\n"
    ),
    "coder": (
        "You are a professional programer. Please provide the corresponding "
        "code based on the description of Human.\n"
    ),
    "lawyer": "你现在是一名专业的中国律师，请根据用户的问题给出准确、有理有据的回复。\n",
    "medical": "如果你是一名医生，请根据患者的描述回答医学问题。\n",
    "sql": (
        "If you are an expert in SQL, please generate a good SQL Query for "
        "Question based on the CREATE TABLE statement.\n"
    ),
}


def get_prompt_template(name: str) -> PromptTemplate:
    return PROMPT_TEMPLATES[name]


def tokenize_with_template(
    conversation: List[Dict],
    tokenizer,
    template: str = "internlm2_chat",
    max_length: int = 8192,
    ignore_index: int = -100,
) -> Dict[str, np.ndarray]:
    """Reference turn layout: SYSTEM only on turn 0 (or on any turn that
    carries its own "system" key), supervision on output + SUFFIX, SEP joins
    turns. Matches xtuner's encode_fn semantics
    (dataset/utils.py template encoding)."""
    t = get_prompt_template(template)
    input_ids: List[int] = [tokenizer.bos_token_id]
    labels: List[int] = [ignore_index]
    for i, turn in enumerate(conversation):
        chunk = ""
        # SYSTEM is emitted only when the dataset provides a system string
        # (xtuner encode_fn behavior) — never formatted with an empty value
        sys_text = turn.get("system")
        if sys_text and t.system is not None:
            chunk += t.system.format(system=sys_text)
        chunk += t.instruction.format(input=turn["input"], round=i + 1)
        ids = tokenizer.encode(chunk, add_bos=False)
        input_ids += ids
        labels += [ignore_index] * len(ids)
        out = turn["output"] + t.suffix
        ids = tokenizer.encode(out, add_bos=False)
        input_ids += ids
        labels += ids
        if t.sep:
            ids = tokenizer.encode(t.sep, add_bos=False)
            input_ids += ids
            labels += [ignore_index] * len(ids)
    return {
        "input_ids": np.asarray(input_ids[:max_length], np.int32),
        "labels": np.asarray(labels[:max_length], np.int32),
    }
