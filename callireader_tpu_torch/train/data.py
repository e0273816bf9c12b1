"""e-IT dataset and collator (PyTorch port of callireader_tpu/train/data.py).

A JSON list (or JSONL) of {"image", "conversations", "embedding"} samples:
the page is tiled (max 6 tiles + thumbnail), the pre-computed pseudo
embeddings are loaded from disk, and the prompt is built with IGNORE_INDEX
labels on everything but the assistant's turns. The collator right-pads to a
length bucket with segment ids (pad = -1) and flattens tiles and pseudo rows
batch-wide in slot order for ``align.vq.splice_embeds``.

The port has no image decoder: an ``image`` is a ``.npy`` array of uint8
pixels ((H, W, 3) or (H, W)), and any other image file raises. Tiles stay
uint8 ((T, H, W, 3)); the ViT normalises them on the device
(models/internvit.normalize_uint8), to the JAX dataset's float32 values
within float32 rounding. ``embedding`` is ``.npy`` or a torch file.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np
import torch

from callireader_tpu_torch.core.config import VLMConfig
from callireader_tpu_torch.runtime.conversation import build_chat_prompt
from callireader_tpu_torch.runtime.engine import ALIGNED, IMG_CONTEXT, IMG_END, IMG_START
from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer
from callireader_tpu_torch.train.e_it import IGNORE_INDEX
from callireader_tpu_torch.vision import preprocess

LENGTH_BUCKETS = (256, 512, 1024, 2048, 4096, 8192)


def _load_embedding(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    t = torch.load(path, map_location="cpu", weights_only=False)
    return t.detach().float().numpy() if hasattr(t, "detach") else np.asarray(t)


def _load_pixels(path: str) -> np.ndarray:
    if not path.endswith(".npy"):
        raise ValueError(
            f"{path}: the port reads page images as .npy arrays of uint8 pixels (it has no "
            "image decoder); convert the image first, e.g. np.save(p, np.asarray(PIL.Image.open(f)))")
    return np.load(path)


class EITDataset:
    """Map-style dataset over a JSON/JSONL annotation file."""

    def __init__(
        self,
        annotation_path: str,
        cfg: VLMConfig,
        tokenizer: InternLM2Tokenizer,
        *,
        image_root: str = "",
        max_tiles: int = 6,
        max_length: int = 8192,
        max_refetch: int = 1000,
    ):
        self.cfg = cfg
        self.tok = tokenizer
        self.image_root = image_root
        self.max_tiles = max_tiles
        self.max_length = max_length
        self.max_refetch = max_refetch
        with open(annotation_path) as f:
            if annotation_path.endswith(".jsonl"):
                self.items = [json.loads(line) for line in f if line.strip()]
            else:
                self.items = json.load(f)

    def __len__(self) -> int:
        return len(self.items)

    def _build(self, item: Dict[str, Any]) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        pixel_values = None
        num_tiles = 0
        if item.get("image"):
            page = _load_pixels(os.path.join(self.image_root, item["image"]))
            pixel_values = preprocess.load_image(page, cfg.force_image_size, self.max_tiles,
                                                 cfg.use_thumbnail)
            num_tiles = pixel_values.shape[0]

        pseudo = None
        if item.get("embedding"):
            pseudo = _load_embedding(os.path.join(self.image_root, item["embedding"]))
            pseudo = pseudo.reshape(-1, pseudo.shape[-1])

        input_ids: List[int] = [self.tok.bos_token_id]
        labels: List[int] = [IGNORE_INDEX]
        conv = build_chat_prompt("placeholder")
        system_part = conv.system_template.format(system_message=conv.system_message) + conv.sep
        sys_ids = self.tok.encode(system_part, add_bos=False)
        input_ids += sys_ids
        labels += [IGNORE_INDEX] * len(sys_ids)

        first_human = True
        for turn in item["conversations"]:
            role = turn.get("from", turn.get("role"))
            value = turn["value"] if "value" in turn else turn["content"]
            if role in ("human", "user"):
                if first_human:
                    if pixel_values is not None and "<image>" not in value:
                        value = "<image>\n" + value
                    if pseudo is not None and ALIGNED not in value:
                        value = value + ALIGNED * pseudo.shape[0]
                    if pixel_values is not None:
                        image_tokens = IMG_START + IMG_CONTEXT * cfg.num_image_token * num_tiles + IMG_END
                        value = value.replace("<image>", image_tokens, 1)
                    first_human = False
                ids = self.tok.encode(conv.roles[0] + value + conv.sep + conv.roles[1], add_bos=False)
                input_ids += ids
                labels += [IGNORE_INDEX] * len(ids)
            else:
                ids = self.tok.encode(value + conv.sep, add_bos=False)
                input_ids += ids
                labels += ids

        if len(input_ids) > self.max_length:
            raise ValueError(f"sample longer than max_length ({len(input_ids)})")

        out = {
            "input_ids": np.asarray(input_ids, np.int32),
            "labels": np.asarray(labels, np.int32),
        }
        if pixel_values is not None:
            out["pixel_values"] = pixel_values
        if pseudo is not None:
            out["pseudo_embeds"] = pseudo.astype(np.float32)
        # the slots must match the payloads
        n_ctx = int((out["input_ids"] == cfg.img_context_token_id).sum())
        if n_ctx != num_tiles * cfg.num_image_token:
            raise ValueError(f"{n_ctx} image slots for {num_tiles} tiles")
        if pseudo is not None:
            n_al = int((out["input_ids"] == cfg.aligned_token_id).sum())
            if n_al != pseudo.shape[0]:
                raise ValueError(f"{n_al} pseudo slots for {pseudo.shape[0]} rows")
        return out

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        """Sample ``idx``; a sample that fails to build is replaced by the
        next one (the reference's broken-sample refetch)."""
        for attempt in range(self.max_refetch):
            try:
                return self._build(self.items[(idx + attempt) % len(self.items)])
            except Exception:
                if attempt == self.max_refetch - 1:
                    raise
        raise RuntimeError("unreachable")

    def lengths(self) -> List[int]:
        """Approximate token lengths for length-grouped sampling (no image
        read: text characters plus the image-token budget)."""
        out = []
        for item in self.items:
            n = 64  # system + chrome
            for turn in item["conversations"]:
                n += len(turn.get("value", turn.get("content", ""))) // 2 + 8
            if item.get("image"):
                n += self.cfg.num_image_token * (self.max_tiles + 1)
            out.append(n)
        return out


def length_grouped_indices(
    lengths: Sequence[int], batch_size: int, mega_factor: int = 50, seed: int = 0
) -> List[int]:
    """Shuffle, then sort by length (longest first) within megabatches of
    batch_size * mega_factor."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(lengths))
    mega = batch_size * mega_factor
    out: List[int] = []
    for i in range(0, len(idx), mega):
        out.extend(sorted(idx[i:i + mega], key=lambda j: -lengths[j]))
    return out


def collate(
    samples: List[Dict[str, np.ndarray]],
    pad_token_id: int = 2,
    length_buckets: Sequence[int] = LENGTH_BUCKETS,
) -> Dict[str, np.ndarray]:
    """Right-pad to a bucketed length; flatten tiles and pseudo rows batch-wide."""
    B = len(samples)
    max_len = max(len(s["input_ids"]) for s in samples)
    S = next(b for b in length_buckets if b >= max_len)

    input_ids = np.full((B, S), pad_token_id, np.int32)
    labels = np.full((B, S), IGNORE_INDEX, np.int32)
    segment_ids = np.full((B, S), -1, np.int32)
    positions = np.zeros((B, S), np.int32)
    for i, s in enumerate(samples):
        n = len(s["input_ids"])
        input_ids[i, :n] = s["input_ids"]
        labels[i, :n] = s["labels"]
        segment_ids[i, :n] = 0
        positions[i, :n] = np.arange(n)

    out = {"input_ids": input_ids, "labels": labels, "segment_ids": segment_ids,
           "positions": positions}
    tiles = [s["pixel_values"] for s in samples if "pixel_values" in s]
    if tiles:
        out["pixel_values"] = np.concatenate(tiles, axis=0)
    pseudo = [s["pseudo_embeds"] for s in samples if "pseudo_embeds" in s]
    if pseudo:
        out["pseudo_embeds"] = np.concatenate(pseudo, axis=0)
    return out


def pack_samples(
    samples: List[Dict[str, np.ndarray]],
    target_length: int,
    pad_token_id: int = 2,
) -> Dict[str, np.ndarray]:
    """Pack text-only samples into one row: per-sample segment ids and
    positions restarting at 0, truncated / padded to ``target_length``."""
    ids, lbl, seg, pos = [], [], [], []
    for k, s in enumerate(samples):
        n = len(s["input_ids"])
        ids.append(s["input_ids"])
        lbl.append(s["labels"])
        seg.append(np.full(n, k, np.int32))
        pos.append(np.arange(n, dtype=np.int32))
    ids = np.concatenate(ids)[:target_length]
    lbl = np.concatenate(lbl)[:target_length]
    seg = np.concatenate(seg)[:target_length]
    pos = np.concatenate(pos)[:target_length]
    pad = target_length - len(ids)
    return {
        "input_ids": np.pad(ids, (0, pad), constant_values=pad_token_id)[None],
        "labels": np.pad(lbl, (0, pad), constant_values=IGNORE_INDEX)[None],
        "segment_ids": np.pad(seg, (0, pad), constant_values=-1)[None],
        "positions": np.pad(pos, (0, pad))[None],
    }


def batches_per_epoch(n_items: int, batch_size: int, *, drop_last: bool = True) -> int:
    """Batches ``data_loader`` yields per epoch (its own range arithmetic, so
    a resume's fast-forward stays in step with the stream)."""
    return len(range(0, n_items - (batch_size - 1 if drop_last else 0), batch_size))


def data_loader(
    dataset: EITDataset,
    batch_size: int,
    *,
    shuffle_seed: int = 0,
    length_grouped: bool = True,
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    if length_grouped:
        order = length_grouped_indices(dataset.lengths(), batch_size, seed=shuffle_seed)
    else:
        order = list(np.random.RandomState(shuffle_seed).permutation(len(dataset)))
    for i in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
        yield collate([dataset[j] for j in order[i:i + batch_size]])


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A collated batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
