"""The plain reference of the OCR cells: from the same pages, the same drawn
weights and the same asset files, it works out again every step the served
engine takes (the box stage's reading order, the char route's pseudo
embeddings, the page tiles and the tile tower, the prompt and its splice)
and runs InternLM2 in float32 over each compared prompt followed by the
tokens the program served, with the positions the program gave them: the
prompt at 0 .. n - 1, the served token j at slot S + j of its left-padded
batch of S slots. It reads the program's outputs (the served tokens) only to
judge them.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from chipbench import weights
from chipbench.reference import boxes as boxes_mod
from chipbench.reference import models, preprocess, resample
from chipbench.reference.device_resize import CHAR_RAW_BUCKETS, bicubic_canvas
from chipbench.reference.tokenizer import InternLM2Tokenizer

SYSTEM = ("你是由上海人工智能实验室联合商汤科技开发的书生多模态大模型，"
          "英文名叫InternVL, 是一个有用无害的人工智能助手。")
ALIGNED = "[UNUSED_TOKEN_140]"
PROMPT_BUCKETS = (128, 256, 512, 1024, 2048, 3072, 3584, 4096, 6144, 8192)


def bucket_length(n: int) -> int:
    return next(b for b in PROMPT_BUCKETS if b >= n)


def n_tiles(cfg: Dict, page: np.ndarray) -> int:
    """Tiles of a page: the dynamic grid, and a thumbnail when it has more than one."""
    c, r = preprocess.tile_grid(page.shape[1], page.shape[0], max_num=cfg["max_dynamic_patch"],
                                image_size=cfg["force_image_size"])
    return c * r + (1 if cfg["use_thumbnail"] and c * r != 1 else 0)


def luma(c: np.ndarray) -> np.ndarray:
    """The served char route's grey conversion: PIL's weights summed in
    uint16, which wraps past 65535 (the committed char tower was trained
    through the same sum)."""
    c16 = c.astype(np.uint16)
    return ((c16[..., 0] * 299 + c16[..., 1] * 587 + c16[..., 2] * 114) // 1000).astype(np.uint8)


# ------------------------------------------------------------ OrderFormer host half


def _prep_inputs(max_boxes: int, shapes: List[Dict], w: float, h: float):
    entries, xs, ys = [], [], []
    for obj in shapes:
        p = obj["points"]
        entries.append([p[0][0], p[0][1], p[1][0], p[1][1]])
        xs.extend([p[0][0] / w, p[1][0] / w])
        ys.extend([p[0][1] / h, p[1][1] / h])
    xmin, ymin = min(xs), min(ys)
    norm = [[[xs[2 * i] - xmin, ys[2 * i] - ymin, xs[2 * i + 1] - xmin, ys[2 * i + 1] - ymin], flat]
            for i, flat in enumerate(entries)]
    norm.sort(key=lambda x: ((x[0][0] + x[0][2]) / 2) ** 2 + ((x[0][1] + x[0][3]) / 2) ** 2)
    n = min(len(norm), max_boxes)
    row = np.zeros((max_boxes, 4), np.float32)
    for i, (coord, _) in enumerate(norm[:n]):
        row[i] = coord
    return row, [flat for _, flat in norm[:n]]


def _permute3(b1, b2, b3):
    hs = [b[3] - b[1] for b in (b1, b2, b3)]
    c = [[(b[0] + b[2]) / 2, (b[1] + b[3]) / 2] for b in (b1, b2, b3)]
    s = [(b[2] - b[0]) * (b[3] - b[1]) for b in (b1, b2, b3)]
    dy = max(abs(c[0][1] - c[1][1]), abs(c[0][1] - c[2][1]), abs(c[1][1] - c[2][1]))
    vals = [c[0][0], c[1][0], c[2][0]] if dy < min(hs) and max(s) > 0 and min(s) / max(s) > 0.7 \
        else [3, 2, 1]
    return sorted(range(3), key=lambda i: vals[i], reverse=True)


def _decode(scores: np.ndarray, labels, w, h) -> Dict[int, List[float]]:
    """Double argsort -> 1-based ranks, then the sliding re-permutation of
    three boxes on one visual row."""
    order = np.argsort(scores.reshape(-1)[:len(labels)], kind="stable")
    ranks = np.argsort(order, kind="stable") + 1
    res = dict(sorted({int(r): l for r, l in zip(ranks, labels)}.items()))
    keys = list(res)
    bx = [[b[0] / w, b[1] / h, b[2] / w, b[3] / h] for b in res.values()]
    for i in range(len(keys) - 2):
        o = _permute3(bx[i], bx[i + 1], bx[i + 2])
        j = keys[i]
        bx[i], bx[i + 1], bx[i + 2] = bx[i + o[0]], bx[i + o[1]], bx[i + o[2]]
        res[j], res[j + 1], res[j + 2] = res[j + o[0]], res[j + o[1]], res[j + o[2]]
    return dict(sorted(res.items()))


class PlainOCR:
    """The reference pipeline of a configuration (``configs/<name>.json``)
    for one seed, on ``device``."""

    def __init__(self, cfg: Dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        v, llm = cfg["vision"], cfg["llm"]
        self.vit = weights.draw_vit(v, seed, device)
        self.proj = weights.draw_projector(v["hidden_size"], llm["hidden_size"], seed, device)
        self.align = weights.draw_align(llm["vocab_size"], llm["hidden_size"], seed, device)
        ca = weights.ASSETS / cfg["char_tower"]["asset"]
        meta = json.loads(str(np.load(ca)["meta"]))
        self.char_cfg, self.res_cfg = meta["char_vision"], meta["char_resampler"]
        self.char_vit = weights.load_npz_tree(ca, device, prefix="v3/char_vision/")
        self.char_proj = weights.load_npz_tree(ca, device, prefix="v3/char_projector/")
        self.res = weights.load_npz_tree(ca, device, prefix="v3/resampler/")
        self.det = weights.load_npz_tree(weights.ASSETS / "detector_640.npz", device)
        self.of = weights.load_npz_tree(weights.ASSETS / "orderformer.npz", device)
        self.tok = InternLM2Tokenizer(str(weights.ASSETS / "tokenizer.model"))
        self.llm = weights.draw_llm(llm, seed, device)

    # ------------------------------------------------------------ box stage

    def detect(self, pages: Sequence[np.ndarray]) -> List[List[List[float]]]:
        d = self.cfg["detector"]
        metas = [models.letterbox(p, d["img_size"]) for p in pages]
        x = torch.from_numpy(np.stack([m[0] for m in metas])).to(self.device)
        b, s = models.detector(self.det, d["reg_max"], x)
        b, s = b.cpu().numpy(), s.cpu().numpy()
        out = []
        for page, (_, scale, (px, py)), bi, si in zip(pages, metas, b, s):
            m = si >= d["conf_threshold"]
            bi, si = bi[m], si[m]
            if not len(bi):
                out.append([])
                continue
            bi = bi[models.nms(bi, si, d["iou_threshold"], d["max_detections"])].copy()
            bi[:, [0, 2]] = ((bi[:, [0, 2]] - px) / scale).clip(0, page.shape[1])
            bi[:, [1, 3]] = ((bi[:, [1, 3]] - py) / scale).clip(0, page.shape[0])
            out.append(bi.tolist())
        return out

    def order(self, page: np.ndarray, flat: List[List[float]]) -> List[List[float]]:
        """Detections -> reading-ordered boxes: IoU dedup, k-means / column
        merge, OrderFormer over the columns, y-sort within each column."""
        if len(flat) > 250:
            raise NotImplementedError("a saturated page (>250 boxes) takes the masking path, "
                                      "which the reference does not cover")
        h, w = page.shape[:2]
        pair = [[[max(int(b[0]), 0), max(int(b[1]), 0)], [min(int(b[2]), w), min(int(b[3]), h)]]
                for b in flat]
        char_boxes = boxes_mod.dedup_boxes_iou(pair, 0.8)
        if not char_boxes:
            return []
        shapes = boxes_mod.char2col_with_kmeans(char_boxes, w, h)["shapes"]
        row, labels = _prep_inputs(self.cfg["orderformer"]["max_boxes"], shapes, w, h)
        scores = models.orderformer(self.of, self.cfg["orderformer"], torch.from_numpy(row[None]).to(self.device))
        cols = _decode(scores[0].cpu().numpy(), labels, w, h)
        flat_boxes = [[c[0][0], c[0][1], c[1][0], c[1][1]] for c in char_boxes]
        final = []
        for col in cols.values():
            lst = [fb for fb in flat_boxes if boxes_mod.calculate_iou(col, fb, mini=True) >= 0.8]
            lst.sort(key=lambda b: (b[1] + b[3]) / 2)
            final.extend(lst)
        return final

    # ----------------------------------------------------------- embeddings

    def pseudo(self, page: np.ndarray, ordered: List[List[float]]) -> Optional[torch.Tensor]:
        """Reading-ordered crops -> (3 n, E) pseudo embeddings: grey crops
        scaled by the [200, 350] rule onto the white char canvas, the
        compact tower, its projector, the resampler, VQ and denorm."""
        crops = []
        for x1, y1, x2, y2 in ordered:
            x1, y1, x2, y2 = int(x1), int(y1), int(x2), int(y2)
            if x2 > x1 and y2 > y1:
                crops.append(page[y1:y2, x1:x2])
        if not crops:
            return None
        size = self.char_cfg["image_size"]
        hi = preprocess.char_content_canvas(size)
        canv = []
        for c in crops:
            h, w = c.shape[:2]
            nw, nh = preprocess.char_content_dims(w, h, size)
            if max(h, w) > hi or max(h, w) > CHAR_RAW_BUCKETS[-1]:
                canv.append(self._host_canvas(c, nw, nh, size))
                continue
            raw = np.full((1, max(h, w), max(h, w)), 255, np.uint8)
            raw[0, :h, :w] = luma(c)
            canv.append(bicubic_canvas(torch.from_numpy(raw).to(self.device),
                                       torch.tensor([[h, w]], device=self.device),
                                       torch.tensor([[nh, nw]], device=self.device), size)[0])
        x = torch.stack(canv)[..., None].expand(-1, size, size, 3)
        feats = models.projector(self.char_proj, models.vit(self.char_vit, self.char_cfg, x))
        return models.vq_denorm(self.align, models.resampler(self.res, self.res_cfg, feats))

    def _host_canvas(self, crop, nw, nh, size) -> torch.Tensor:
        """A crop that would be downscaled: bicubic on the host (PIL's), white
        content canvas, grey, then white to the tower's canvas."""
        content = next((b for b in preprocess.char_canvas_buckets(size) if b >= max(nw, nh)),
                       preprocess.char_canvas_buckets(size)[-1])
        out = np.full((content, content, 3), 255, np.uint8)
        top, left = (content - nh) // 2, (content - nw) // 2
        out[top:top + nh, left:left + nw] = resample.pil_resize(crop, (nw, nh), "bicubic")
        pad = (size - content) // 2
        full = np.full((size, size), 255, np.uint8)
        full[pad:pad + content, pad:pad + content] = luma(out)
        return torch.from_numpy(full).to(self.device)

    def tiles(self, page: np.ndarray) -> torch.Tensor:
        """Dynamic tiling on the device: jax "cubic" resize to the grid,
        row-major tiles, the thumbnail last."""
        S = self.cfg["force_image_size"]
        h, w = page.shape[:2]
        c, r = preprocess.tile_grid(w, h, max_num=self.cfg["max_dynamic_patch"], image_size=S)
        x = torch.from_numpy(page).to(self.device).float()[None]
        grid = resample.jax_resize_hw(x, r * S, c * S)
        t = grid.reshape(1, r, S, c, S, 3).permute(0, 1, 3, 2, 4, 5).reshape(r * c, S, S, 3)
        if self.cfg["use_thumbnail"] and r * c != 1:
            t = torch.cat([t, resample.jax_resize_hw(x, S, S)])
        return torch.clamp(torch.round(t), 0, 255).to(torch.uint8)

    def image_feats(self, page: np.ndarray) -> torch.Tensor:
        t = self.tiles(page)
        return torch.cat([models.projector(self.proj, models.vit(self.vit, self.cfg["vision"], t[i:i + 4]))
                          for i in range(0, t.shape[0], 4)]).reshape(-1, self.cfg["llm"]["hidden_size"])

    def prompt_ids(self, n_tiles: int, n_pseudo: int, question: str) -> np.ndarray:
        img = "<img>" + "<IMG_CONTEXT>" * (self.cfg["num_image_token"] * n_tiles) + "</img>"
        q = img + "\n" + question + ALIGNED * n_pseudo
        text = (f"<|im_start|>system\n{SYSTEM}<|im_end|><|im_start|>user\n{q}<|im_end|>"
                "<|im_start|>assistant\n")
        return np.asarray(self.tok.encode(text, add_bos=True), np.int64)

    # ------------------------------------------------------------------ LLM

    def embed_rows(self, ids: torch.Tensor, levels: Optional[int]) -> torch.Tensor:
        rows = self.llm["tok_embeddings"][ids].float()
        if levels is None:
            return rows
        s = rows.abs().amax(-1, keepdim=True).clamp_min(1e-8) / levels
        return torch.clamp(torch.round(rows / s), -levels, levels) * s

    def logits(self, ids: np.ndarray, img: torch.Tensor, pseudo: Optional[torch.Tensor],
               bucket: int, served: np.ndarray, levels: Optional[int] = None) -> torch.Tensor:
        """(T, V) float32 logits at the prompt's last position and at each
        served token but the last: the logits that chose served[0 .. T-1]."""
        cfg = self.cfg
        n, T = len(ids), len(served)
        dev = self.device
        all_ids = torch.from_numpy(np.concatenate([ids, served[:-1].astype(np.int64)])).to(dev)
        x = self.embed_rows(all_ids, levels)
        is_img = all_ids[:n] == cfg["img_context_token_id"]
        x[:n][is_img] = img[:int(is_img.sum())]
        if pseudo is not None:
            is_al = all_ids[:n] == cfg["aligned_token_id"]
            x[:n][is_al] = pseudo[:int(is_al.sum())]
        pos = torch.cat([torch.arange(n, device=dev), bucket + torch.arange(T - 1, device=dev)])
        W = (models.plain_weight(self.llm) if levels is None
             else models.quantized_weight(self.llm, levels))
        h = models.llm_hidden(W, cfg["llm"], x[None], pos)[0, n - 1:]
        return models.llm_logits(W, h, cfg["llm"]["vocab_size"])


def served_gaps(ref: torch.Tensor, served: np.ndarray) -> torch.Tensor:
    """Per position, how far the served token's logit lies below the
    reference's best."""
    tok = torch.from_numpy(served.astype(np.int64)).to(ref.device)
    return ref.max(-1).values - ref.gather(1, tok[:, None])[:, 0]
