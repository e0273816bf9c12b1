"""Generic SFT / pretraining data pipeline (a copy of
callireader_tpu/train/sft_data.py on the port's tokenizer and conversation
template).

Parity targets in train/xtuner/dataset/:
  - huggingface.py:22-94  process pipeline: origin -> map_fn -> template ->
    tokenize -> pack
  - map_fns/dataset_map_fns/ (alpaca, conversation/openai formats, ...)
  - utils.py Packer :132-191 (cumulative-length varlen packing) — expressed
    here as segment ids + reset positions
  - intern_repo.py JsonlDataset/PackedDataset (:22-165) — packed_length-sized
    rows for pretraining

A packed row gives each document (each piece of one that spills into the
next row) its own segment id, 0..n-1, pad -1, with positions restarting at 0:
the training attention kernels (kernels/attention_bwd.py) mask across
segments.

Everything emits the same batch dict the e-IT/SFT loss consumes
(train/e_it.py): input_ids, labels, segment_ids, positions.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from callireader_tpu_torch.runtime.conversation import build_chat_prompt
from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer
from callireader_tpu_torch.train.e_it import IGNORE_INDEX

MapFn = Callable[[Dict], Dict]


# ---------------------------------------------------------------------------
# map fns: raw record -> {"conversation": [{"input": ..., "output": ...}]}
# ---------------------------------------------------------------------------


def alpaca_map_fn(example: Dict) -> Dict:
    """Reference semantics (dataset_map_fns/alpaca_map_fn.py:4-13): records
    whose output is the ``<nooutput>`` sentinel are dropped entirely, and
    instruction+input are always joined with a newline (including when input
    is empty or ``<noinput>`` — the reference does not special-case it)."""
    if example.get("output") == "<nooutput>":
        return {"conversation": []}
    return {"conversation": [{
        "input": f"{example['instruction']}\n{example.get('input', '')}",
        "output": example["output"],
    }]}


def openai_map_fn(example: Dict) -> Dict:
    """[{role, content}] chat format."""
    conv = []
    pending_user: Optional[str] = None
    for msg in example["messages"]:
        if msg["role"] == "user":
            pending_user = msg["content"]
        elif msg["role"] == "assistant" and pending_user is not None:
            conv.append({"input": pending_user, "output": msg["content"]})
            pending_user = None
    return {"conversation": conv}


def sharegpt_map_fn(example: Dict) -> Dict:
    conv = []
    pending = None
    for turn in example["conversations"]:
        role = turn.get("from", turn.get("role"))
        value = turn.get("value", turn.get("content"))
        if role in ("human", "user"):
            pending = value
        elif pending is not None:
            conv.append({"input": pending, "output": value})
            pending = None
    return {"conversation": conv}


def alpaca_zh_map_fn(example: Dict) -> Dict:
    """Chinese alpaca variant: instruction_zh/input_zh/output_zh fields."""
    inp = example.get("input_zh", "")
    instr = example["instruction_zh"]
    text = instr if not inp or inp == "<noinput>" else f"{instr}\n{inp}"
    return {"conversation": [{"input": text, "output": example["output_zh"]}]}


def code_alpaca_map_fn(example: Dict) -> Dict:
    return {
        "conversation": [
            {"input": example["prompt"], "output": example["completion"]}
        ]
    }


def oasst1_map_fn(example: Dict) -> Dict:
    """### Human: ... ### Assistant: ... single-text transcripts."""
    conv = []
    for chunk in example["text"].split("### Human: ")[1:]:
        if "### Assistant: " not in chunk:
            continue
        q, a = chunk.split("### Assistant: ", 1)
        conv.append({"input": q.strip(), "output": a.strip()})
    return {"conversation": conv}


def wizardlm_map_fn(example: Dict) -> Dict:
    return sharegpt_map_fn(example)


def tiny_codes_map_fn(example: Dict) -> Dict:
    return {
        "conversation": [
            {"input": example["prompt"], "output": example["response"]}
        ]
    }


def sql_map_fn(example: Dict) -> Dict:
    return {
        "conversation": [
            {
                "input": f"{example['context']}\n{example['question']}",
                "output": example["answer"],
            }
        ]
    }


def medical_map_fn(example: Dict) -> Dict:
    instr = example.get("instruction", "")
    inp = example.get("input", "")
    text = f"{instr}\n{inp}".strip()
    return {"conversation": [{"input": text, "output": example["output"]}]}


def crime_kg_assistant_map_fn(example: Dict) -> Dict:
    return {
        "conversation": [
            {"input": example["input"], "output": example["output"]}
        ]
    }


def pretrain_map_fn(example: Dict) -> Dict:
    """Raw-text pretraining rows: everything is target."""
    return {"conversation": [{"input": "", "output": example["text"]}]}


# task system prompts (utils/templates.py SYSTEM_TEMPLATE in the reference)
SYSTEM_PROMPTS = {
    "arxiv": (
        "If you are an expert in writing papers, please generate a good paper "
        "title for this paper based on other authors' descriptions of their "
        "abstracts.\n"
    ),
    "colorist": (
        "You are a professional color designer. Please provide the "
        "corresponding colors based on the description of Human.\n"
    ),
    "lawyer": "你现在是一名专业的中国律师，请根据用户的问题给出准确、有理有据的回复。\n",
}


def default_map_fn(example: Dict) -> Dict:
    """Plain {input, output} rows (default_map_fn in the reference)."""
    return {"conversation": [{"input": example["input"], "output": example["output"]}]}


def arxiv_map_fn(example: Dict) -> Dict:
    """arXiv title generation: abstract -> title with the gentitle system
    prompt (arxiv_map_fn.py + SYSTEM_TEMPLATE.arxiv_gentile)."""
    return {
        "conversation": [{
            "system": SYSTEM_PROMPTS["arxiv"],
            "input": example["abstract"],
            "output": example["title"],
        }]
    }


def colors_map_fn(example: Dict) -> Dict:
    """Color-design rows: strip the 'Color: ...' prefix from the description
    (colors_map_fn.py)."""
    desc = ":".join(example["description"].split(":")[1:]).strip()
    return {
        "conversation": [{
            "system": SYSTEM_PROMPTS["colorist"],
            "input": desc,
            "output": example["color"],
        }]
    }


def law_reference_map_fn(example: Dict) -> Dict:
    return {
        "conversation": [{
            "system": SYSTEM_PROMPTS["lawyer"],
            "input": example["question"],
            "output": example["answer"],
        }]
    }


def openorca_map_fn(example: Dict) -> Dict:
    return {
        "conversation": [{
            "system": example["system_prompt"],
            "input": example["question"],
            "output": example["response"],
        }]
    }


def stack_exchange_map_fn(example: Dict) -> Dict:
    return {
        "conversation": [{
            "input": example["question"], "output": example["response"],
        }]
    }


def llava_map_fn(example: Dict) -> Dict:
    """LLaVA rows: normalize <image> to a leading token per human turn
    (llava_map_fn.py llava_map_fn)."""
    messages = list(example["conversations"])
    while messages and messages[0]["from"] == "gpt":
        messages = messages[1:]
    conv: List[Dict] = []
    pending = ""
    for msg in messages:
        if msg["from"] == "human":
            value = msg["value"]
            if "<image>" in value:
                value = ("<image>\n" + value.replace("<image>", "").strip()).strip()
            pending += value
        elif msg["from"] == "gpt":
            conv.append({"input": pending, "output": msg["value"]})
            pending = ""
    return {"conversation": conv}


def llava_image_only_map_fn(example: Dict) -> Dict:
    """Pretrain variant: the input is the <image> token alone
    (llava_map_fn.py llava_image_only_map_fn)."""
    messages = list(example["conversations"])
    while messages and messages[0]["from"] == "gpt":
        messages = messages[1:]
    conv: List[Dict] = []
    pending = ""
    for msg in messages:
        if msg["from"] == "human":
            assert "<image>" in msg["value"]
            pending += "<image>"
        elif msg["from"] == "gpt":
            conv.append({"input": pending, "output": msg["value"]})
            pending = ""
    return {"conversation": conv}


_THINK_RE = r"(.*?)(<\|startofthink\|\>)(.*?)(<\|endofthink\|\>)"
_EXEC_RE = r"(<\|startofexec\|\>)(.*?)(<\|endofexec\|\>)(.*?)$"


def msagent_react_map_fn(example: Dict) -> Dict:
    """ModelScope-Agent transcripts -> ReAct-style turns: <|startofthink|>
    JSON becomes Action/Action Input lines, <|startofexec|> JSON becomes a
    Response line (msagent_map_fn.py). Invalid rows map to an empty
    conversation (filtered downstream)."""
    import re

    def _think(match):
        out = ""
        if match.group(1).strip():
            out += f"Thought:{match.group(1).strip()}\n"
        blob = match.group(3).replace("```JSON", "").replace("```", "").replace("\n", "")
        j = json.loads(blob)
        return out + f"Action:{j['api_name']}\nAction Input:{j['parameters']}\n"

    def _exec(match):
        blob = match.group(2).replace("```JSON", "").replace("```", "").replace("\n", "")
        out = f"Response:{json.loads(blob)}\n"
        if match.group(4).strip():
            out += f"Final Answer:{match.group(4).strip()}\n"
        return out

    text = example["conversations"]
    if isinstance(text, str):
        text = json.loads(text)
    if not isinstance(text, list) or len(text) < 2:
        return {"conversation": []}
    conv: List[Dict] = []
    system_text, input_text = "", ""
    for t in text:
        role, value = t.get("from"), t.get("value", "")
        if role == "system":
            system_text = value
        elif role == "user":
            input_text = value
        elif role == "assistant":
            import re as _re

            output, response = value, None
            if "<|startofexec|>" in output:
                output, response = output.split("<|startofexec|>", 1)
                response = "<|startofexec|>" + response
            try:
                output, n_think = _re.subn(_THINK_RE, _think, output, flags=_re.DOTALL)
            except Exception:
                return {"conversation": []}
            output = f"Final Answer:{output}\n" if n_think == 0 else f"{output}\n"
            conv.append({"system": system_text, "input": input_text, "output": output})
            system_text, input_text = "", ""
            if response is not None:
                try:
                    response, _ = _re.subn(_EXEC_RE, _exec, response, flags=_re.DOTALL)
                    if "Final Answer:" in response:
                        resp_sys, answer = response.split("Final Answer:")
                        conv.append({
                            "system": resp_sys, "input": "",
                            "output": "Final Answer:" + answer,
                        })
                except Exception:
                    pass
    return {"conversation": conv}


MAP_FNS: Dict[str, MapFn] = {
    "default": default_map_fn,
    "alpaca": alpaca_map_fn,
    "alpaca_zh": alpaca_zh_map_fn,
    "arxiv": arxiv_map_fn,
    "code_alpaca": code_alpaca_map_fn,
    "colors": colors_map_fn,
    "crime_kg_assistant": crime_kg_assistant_map_fn,
    "law_reference": law_reference_map_fn,
    "llava": llava_map_fn,
    "llava_image_only": llava_image_only_map_fn,
    "medical": medical_map_fn,
    "msagent_react": msagent_react_map_fn,
    "oasst1": oasst1_map_fn,
    "openai": openai_map_fn,
    "openorca": openorca_map_fn,
    "pretrain": pretrain_map_fn,
    "sharegpt": sharegpt_map_fn,
    "sql": sql_map_fn,
    "stack_exchange": stack_exchange_map_fn,
    "tiny_codes": tiny_codes_map_fn,
    "wizardlm": wizardlm_map_fn,
}


# ---------------------------------------------------------------------------
# tokenize with template
# ---------------------------------------------------------------------------


def tokenize_conversation(
    conversation: List[Dict], tokenizer: InternLM2Tokenizer, max_length: int = 8192
) -> Dict[str, np.ndarray]:
    conv = build_chat_prompt("x")  # template instance for chrome strings
    input_ids: List[int] = [tokenizer.bos_token_id]
    labels: List[int] = [IGNORE_INDEX]
    # a per-dataset system prompt (map_fn "system" key, first turn) replaces
    # the template default, matching the reference's template_map_fn behavior
    system_message = conversation[0].get("system") or conv.system_message
    system = conv.system_template.format(system_message=system_message) + conv.sep
    ids = tokenizer.encode(system, add_bos=False)
    input_ids += ids
    labels += [IGNORE_INDEX] * len(ids)
    for i, turn in enumerate(conversation):
        sys_text = turn.get("system") if i > 0 else None
        prefix = (
            conv.system_template.format(system_message=sys_text) + conv.sep
            if sys_text
            else ""
        )
        prompt = prefix + conv.roles[0] + turn["input"] + conv.sep + conv.roles[1]
        ids = tokenizer.encode(prompt, add_bos=False)
        input_ids += ids
        labels += [IGNORE_INDEX] * len(ids)
        ids = tokenizer.encode(turn["output"] + conv.sep, add_bos=False)
        input_ids += ids
        labels += ids
    return {
        "input_ids": np.asarray(input_ids[:max_length], np.int32),
        "labels": np.asarray(labels[:max_length], np.int32),
    }


def process_dataset(
    records: Sequence[Dict],
    tokenizer: InternLM2Tokenizer,
    *,
    map_fn: MapFn | str = "sharegpt",
    max_length: int = 8192,
    template: Optional[str] = None,
) -> List[Dict[str, np.ndarray]]:
    """origin -> map -> template+tokenize (huggingface.py pipeline stages).
    ``template``: a train/templates.py PROMPT_TEMPLATES name for non-InternLM2
    model families; default uses the engine's internlm2-chat conversation."""
    if isinstance(map_fn, str):
        map_fn = MAP_FNS[map_fn]
    out = []
    for rec in records:
        conv = map_fn(rec)["conversation"]
        if not conv:
            continue
        if template is None:
            out.append(tokenize_conversation(conv, tokenizer, max_length))
        else:
            from callireader_tpu_torch.train.templates import tokenize_with_template

            out.append(
                tokenize_with_template(conv, tokenizer, template, max_length,
                                       ignore_index=IGNORE_INDEX)
            )
    return out


# ---------------------------------------------------------------------------
# packed pretraining (intern_repo equivalent)
# ---------------------------------------------------------------------------


class JsonlTextDataset:
    """Line-indexed jsonl of {"content": str} (intern_repo.py JsonlDataset,
    offset-indexed instead of mmap — same random access contract)."""

    def __init__(self, path: str, text_key: str = "content"):
        self.path = path
        self.text_key = text_key
        self.offsets: List[int] = []
        with open(path, "rb") as f:
            off = 0
            for line in f:
                if line.strip():
                    self.offsets.append(off)
                off += len(line)

    def __len__(self) -> int:
        return len(self.offsets)

    def __getitem__(self, idx: int) -> str:
        with open(self.path, "rb") as f:
            f.seek(self.offsets[idx])
            return json.loads(f.readline())[self.text_key]


class PackedTextDataset:
    """Greedy-pack tokenized documents into fixed packed_length rows with
    segment ids + per-doc positions (intern_repo.py PackedDataset; the
    reference's cu_seqlens become segment ids for the flash kernel)."""

    def __init__(
        self,
        dataset: JsonlTextDataset,
        tokenizer: InternLM2Tokenizer,
        packed_length: int = 8192,
        pad_token_id: int = 2,
    ):
        self.packed_length = packed_length
        self.rows: List[Dict[str, np.ndarray]] = []
        ids_buf: List[np.ndarray] = []
        seg_buf: List[np.ndarray] = []
        pos_buf: List[np.ndarray] = []
        used = 0
        seg = 0

        def flush():
            nonlocal used, seg
            if not ids_buf:
                return
            ids = np.concatenate(ids_buf)
            segs = np.concatenate(seg_buf)
            poss = np.concatenate(pos_buf)
            pad = self.packed_length - len(ids)
            row = {
                "input_ids": np.pad(ids, (0, pad), constant_values=pad_token_id)[None],
                "labels": np.pad(
                    np.where(segs >= 0, ids, IGNORE_INDEX), (0, pad),
                    constant_values=IGNORE_INDEX,
                )[None],
                "segment_ids": np.pad(segs, (0, pad), constant_values=-1)[None],
                "positions": np.pad(poss, (0, pad))[None],
            }
            self.rows.append(row)
            ids_buf.clear(); seg_buf.clear(); pos_buf.clear()
            used = 0
            seg = 0

        for i in range(len(dataset)):
            toks = np.asarray(tokenizer.encode(dataset[i]), np.int32)
            start = 0
            while start < len(toks):
                room = self.packed_length - used
                take = toks[start : start + room]
                ids_buf.append(take)
                seg_buf.append(np.full(len(take), seg, np.int32))
                pos_buf.append(np.arange(len(take), dtype=np.int32))
                used += len(take)
                start += len(take)
                seg += 1
                if used == self.packed_length:
                    flush()
        flush()

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.rows[idx]


def packed_loader(
    dataset: PackedTextDataset, batch_size: int, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    order = np.random.RandomState(seed).permutation(len(dataset))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        rows = [dataset[j] for j in order[i : i + batch_size]]
        yield {k: np.concatenate([r[k] for r in rows], axis=0) for k in rows[0]}
