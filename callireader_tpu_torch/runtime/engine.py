"""CalliReader engine, batched full-page ``chat_ocr`` (PyTorch port of
callireader_tpu/runtime/engine.py, the ``batch_chat_ocr`` path).

    pages -> on-device dynamic tiling -> InternViT tile tower + projector
          -> YOLO detector + host NMS -> dedup / k-means / column merge
          -> OrderFormer + per-column y-sort -> raw char crops
          -> on-device bicubic canvas -> compact char tower + projector
          -> resampler -> cosine VQ -> Gaussian denorm
          -> double splice into the token embeddings
          -> one prefill + greedy decode (repetition penalty) for all rows

The options of the JAX engine that select other paths (host tiling, RGB
char crops, the shared-tower canvas lever, meshes) are not ported: this
engine always tiles on the device, ships luma crops and resizes them on the
device, except crops that would be downscaled, which take the host path
(PIL-compatible antialiased bicubic in numpy), as in the JAX engine.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from callireader_tpu_torch.align import vq as vq_mod
from callireader_tpu_torch.core.config import VLMConfig, get_config
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy, require_device
from callireader_tpu_torch.models import detector as detector_mod
from callireader_tpu_torch.models import internlm2, internvit, orderformer, projector, resampler
from callireader_tpu_torch.runtime import generate as gen
from callireader_tpu_torch.runtime import weights
from callireader_tpu_torch.runtime.conversation import build_chat_prompt, get_conv_template
from callireader_tpu_torch.runtime.tokenizer import DEFAULT_MODEL, InternLM2Tokenizer
from callireader_tpu_torch.vision import boxes as boxes_mod
from callireader_tpu_torch.vision import preprocess, resample
from callireader_tpu_torch.vision.device_resize import CHAR_RAW_BUCKETS, bicubic_canvas

CHAR_BUCKETS = (8, 16, 32, 64, 96, 128, 192, 256)
IMG_START, IMG_END, IMG_CONTEXT = "<img>", "</img>", "<IMG_CONTEXT>"
ALIGNED = "[UNUSED_TOKEN_140]"
CHAR_WINDOW = CHAR_BUCKETS[-1]
BATCH_TILE_BUCKETS = (26, 39, 52, 65, 78, 91, 104, 156, 208)


@dataclasses.dataclass
class Timings:
    """Wall seconds per stage; on CUDA each span ends with a device sync, so
    the spans are device-inclusive."""

    spans: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, name: str, dt: float):
        self.spans[name] = self.spans.get(name, 0.0) + dt


def _luma(c: np.ndarray) -> np.ndarray:
    """PIL convert("L") weights on uint8 RGB."""
    if c.ndim == 2:
        return c
    c16 = c.astype(np.uint16)
    return ((c16[..., 0] * 299 + c16[..., 1] * 587 + c16[..., 2] * 114) // 1000).astype(np.uint8)


class CalliReaderEngine:
    def __init__(
        self,
        cfg: VLMConfig,
        params: Dict[str, Any],
        tokenizer: InternLM2Tokenizer,
        *,
        device="cuda",
        policy: DTypePolicy = DEFAULT_POLICY,
    ):
        self.device = require_device(device)
        self.cfg = cfg
        self.params = params
        self.tok = tokenizer
        self.policy = policy
        self.char_canvas = (cfg.char_vision.image_size if cfg.char_vision is not None
                            else cfg.force_image_size)
        self.detector = (detector_mod.Detector(params["detector"], cfg.detector, self.device)
                         if "detector" in params else None)
        self.timings = Timings()

    # ------------------------------------------------------------------ util

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings.add(name, time.perf_counter() - t0)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------ towers

    def _encode_tower(self, vision_params, proj_params, vision_cfg, pixel_values):
        hidden = internvit.forward(vision_params, vision_cfg, pixel_values, policy=self.policy)
        return projector.extract_feature(proj_params, hidden, self.cfg, policy=self.policy)

    def _vision_encode(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) tiles -> (N, num_image_token, E_llm)."""
        p = self.params
        return self._encode_tower(p["vision"], p["projector"], self.cfg.vision, pixel_values)

    def _char_encode(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """The compact char tower when configured, else the tile tower."""
        p = self.params
        if self.cfg.char_vision is not None:
            return self._encode_tower(p["char_vision"], p["char_projector"],
                                      self.cfg.char_vision, pixel_values)
        return self._encode_tower(p["vision"], p["projector"], self.cfg.vision, pixel_values)

    def _resample_vq(self, feats: torch.Tensor):
        """(N, tok, dim) -> (pseudo embeds (N*3, E), indices (N, 3))."""
        out = resampler.forward(self.params["resampler"], self.cfg.resampler, feats,
                                policy=self.policy)
        a = self.params["align"]
        return vq_mod.calli_align_embed(out, a["normed_emb"], a["mu"], a["sigma"])

    def _char_pipeline_raw(self, raw, src_hw, tgt_hw):
        """Raw luma crops -> device bicubic canvas -> tower -> resampler -> VQ."""
        canvas = bicubic_canvas(raw, src_hw, tgt_hw, self.char_canvas)
        canvas = canvas[..., None].expand(*canvas.shape, 3)
        return self._resample_vq(self._char_encode(canvas))

    def _char_pipeline(self, content: torch.Tensor):
        """(N, c, c) luma content canvases -> white pad to the char canvas ->
        tower -> resampler -> VQ."""
        size, c = self.char_canvas, content.shape[1]
        pad = (size - c) // 2
        x = torch.nn.functional.pad(content, (pad, size - c - pad, pad, size - c - pad), value=255)
        x = x[..., None].expand(*x.shape, 3)
        return self._resample_vq(self._char_encode(x))

    # ------------------------------------------------------------ tiling

    def _page_tiles(self, pages_u8: torch.Tensor, cols: int, rows: int, thumb: bool):
        """(B, H, W, 3) uint8 pages -> (B*T, S, S, 3) uint8 tiles on the
        device: jax-"cubic" resize to the grid, row-major split, thumbnail
        appended per page."""
        S = self.cfg.force_image_size
        B = pages_u8.shape[0]
        x = pages_u8.float()
        grid = resample.jax_resize_hw(x, rows * S, cols * S)
        tiles = (grid.reshape(B, rows, S, cols, S, 3).permute(0, 1, 3, 2, 4, 5)
                 .reshape(B, rows * cols, S, S, 3))
        if thumb:
            tn = resample.jax_resize_hw(x, S, S)
            tiles = torch.cat([tiles, tn[:, None]], dim=1)
        tiles = torch.clamp(torch.round(tiles), 0, 255).to(torch.uint8)
        return tiles.reshape(-1, S, S, 3)

    def batch_tile_pages(self, imgs_np: Sequence[np.ndarray]) -> Tuple[torch.Tensor, List[int]]:
        """Pages grouped by (shape, grid), one device resize per group, tiles
        reassembled image-major. -> (tiles (T_total, S, S, 3), counts)."""
        cfg = self.cfg
        groups: Dict[Tuple[int, int, int, int], List[int]] = {}
        for i, im in enumerate(imgs_np):
            h, w = im.shape[:2]
            c, r = preprocess.tile_grid(w, h, max_num=cfg.max_dynamic_patch,
                                        image_size=cfg.force_image_size)
            groups.setdefault((h, w, c, r), []).append(i)
        per_image: List[Optional[torch.Tensor]] = [None] * len(imgs_np)
        counts = [0] * len(imgs_np)
        for (h, w, c, r), idxs in groups.items():
            thumb = cfg.use_thumbnail and (c * r) != 1
            t = c * r + (1 if thumb else 0)
            stack = self._to_dev(np.stack([imgs_np[i] for i in idxs]))
            tiles = self._page_tiles(stack, c, r, thumb)
            for j, i in enumerate(idxs):
                per_image[i] = tiles[j * t:(j + 1) * t]
                counts[i] = t
        return torch.cat(per_image, dim=0), counts

    def encode_image_tiles(self, tiles: torch.Tensor) -> torch.Tensor:
        """ViT + projector over a tile stack, zero-padded to a tile bucket
        (chunked at the largest) as the JAX engine does."""
        buckets = preprocess.TILE_BUCKETS
        if tiles.shape[0] > buckets[-1]:
            buckets = (*buckets, *BATCH_TILE_BUCKETS)
        cap = buckets[-1]
        outs = []
        for lo in range(0, tiles.shape[0], cap):
            part = tiles[lo:lo + cap]
            n = part.shape[0]
            target = preprocess.bucket_tiles(n, buckets)
            if target != n:
                pad = torch.zeros((target - n,) + tuple(part.shape[1:]), dtype=part.dtype,
                                  device=part.device)
                part = torch.cat([part, pad], dim=0)
            outs.append(self._vision_encode(part)[:n])
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    # ------------------------------------------------------------ char path

    def _prep_char_raw_groups(self, raw_crops: List[np.ndarray]):
        """Group crops by raw square bucket with (src, tgt) dims for the
        device resize; crops that would downscale go to the host path."""
        size = self.char_canvas
        hi = preprocess.char_content_canvas(size)
        by_bucket: Dict[int, List[int]] = {}
        host_idx: List[int] = []
        for i, c in enumerate(raw_crops):
            m = max(c.shape[0], c.shape[1])
            if m > hi or m > CHAR_RAW_BUCKETS[-1]:
                host_idx.append(i)
                continue
            by_bucket.setdefault(next(b for b in CHAR_RAW_BUCKETS if b >= m), []).append(i)
        groups = []
        for bucket, idxs in by_bucket.items():
            n = len(idxs)
            raw = np.full((n, bucket, bucket), 255, np.uint8)
            src = np.ones((n, 2), np.int32)
            tgt = np.ones((n, 2), np.int32)
            for j, i in enumerate(idxs):
                c = _luma(raw_crops[i])
                h, w = c.shape[:2]
                raw[j, :h, :w] = c
                nw, nh = preprocess.char_content_dims(w, h, size)
                src[j] = (h, w)
                tgt[j] = (nh, nw)
            groups.append((np.asarray(idxs, np.int64), raw, src, tgt))
        return groups, host_idx

    def _prep_char_crop_groups(self, raw_crops: List[np.ndarray]):
        """Host path: PIL-compatible bicubic to the [200, 350] rule, white pad
        to the smallest content-canvas bucket that holds it, luma."""
        size = self.char_canvas
        buckets = preprocess.char_canvas_buckets(size)
        by_bucket: Dict[int, List[int]] = {}
        for i, c in enumerate(raw_crops):
            nw, nh = preprocess.char_content_dims(c.shape[1], c.shape[0], size)
            m = max(nw, nh)
            by_bucket.setdefault(next((b for b in buckets if b >= m), buckets[-1]), []).append(i)
        out = []
        for bucket, idxs in by_bucket.items():
            stack = np.stack([_luma(preprocess.load_char_content(raw_crops[i], size, canvas=bucket))
                              for i in idxs])
            out.append((np.asarray(idxs, np.int64), stack))
        return out

    def _char_parts(self, raw_crops: List[np.ndarray]):
        """One char pipeline per bucket group -> (parts_ps, parts_ix, counts,
        original-index arrays)."""
        parts_ps, parts_ix, ns, idx_order = [], [], [], []
        t0 = time.perf_counter()
        raw_groups, host_idx = self._prep_char_raw_groups(raw_crops)
        host_groups = []
        if host_idx:
            host_map = np.asarray(host_idx, np.int64)
            host_groups = [(host_map[idxs], stack) for idxs, stack in
                           self._prep_char_crop_groups([raw_crops[i] for i in host_idx])]
        self.timings.add("char_crops", time.perf_counter() - t0)
        with self._span("vit_resampler_vq"):
            for idxs, raw, src, tgt in raw_groups:
                raw_p, n = preprocess.pad_to_bucket(raw, CHAR_BUCKETS)
                pad = raw_p.shape[0] - n
                if pad:
                    src = np.concatenate([src, np.ones((pad, 2), np.int32)])
                    tgt = np.concatenate([tgt, np.ones((pad, 2), np.int32)])
                ps, ix = self._char_pipeline_raw(self._to_dev(raw_p), self._to_dev(src),
                                                 self._to_dev(tgt))
                parts_ps.append(ps)
                parts_ix.append(ix)
                ns.append(n)
                idx_order.append(idxs)
            for idxs, stack in host_groups:
                padded, n = preprocess.pad_to_bucket(stack, CHAR_BUCKETS)
                ps, ix = self._char_pipeline(self._to_dev(padded))
                parts_ps.append(ps)
                parts_ix.append(ix)
                ns.append(n)
                idx_order.append(idxs)
        return parts_ps, parts_ix, ns, idx_order

    def _reorder(self, parts_ps, parts_ix, ns, idx_parts):
        """Strip count padding, concatenate, permute into reading order."""
        n_learns = self.cfg.resampler.num_learns
        E = parts_ps[0].shape[-1]
        perm = torch.from_numpy(np.argsort(np.concatenate(idx_parts))).to(self.device)
        ps = torch.cat([p.reshape(-1, n_learns, E)[:n] for p, n in zip(parts_ps, ns)])
        ix = torch.cat([x[:n] for x, n in zip(parts_ix, ns)])
        return ps[perm].reshape(-1, E), ix[perm]

    # -------------------------------------------------- slicing priors

    def iterative_detect(self, image: np.ndarray, max_passes: int = 10):
        """Iterative detection with masking while a pass saturates (>250)."""
        img = image.copy()
        h, w = img.shape[:2]
        color = boxes_mod.most_frequent_rgb_fast(img)
        flat: List[List[float]] = []
        for _ in range(max_passes):
            dets = self.detector(img)
            to_mask = [[int(b[0]), int(b[1]), int(b[2]), int(b[3])] for b in dets]
            flat.extend(to_mask)
            if len(to_mask) > 250:
                img = boxes_mod.mask_area(img, to_mask, color)
            else:
                break
        pair = [[[max(b[0], 0), max(b[1], 0)], [min(b[2], w), min(b[3], h)]] for b in flat]
        return boxes_mod.dedup_boxes_iou(pair, 0.8)

    def _order_columns(self, char_boxes, col_order, thres):
        final: List[List[float]] = []
        for _, col in col_order.items():
            lst = []
            for item in char_boxes:
                fb = [item[0][0], item[0][1], item[1][0], item[1][1]]
                if boxes_mod.calculate_iou(col, fb, mini=True) >= thres:
                    lst.append(fb)
            lst.sort(key=lambda b: (b[1] + b[3]) / 2)
            final.extend(lst)
        return final

    def sort_boxes(self, image: np.ndarray, thres: float = 0.8) -> List[List[float]]:
        h, w = image.shape[:2]
        char_boxes = self.iterative_detect(image)
        if not char_boxes:
            return []
        data = boxes_mod.char2col_with_kmeans(char_boxes, w, h)
        col_order = orderformer.predict(self.params["orderformer"], self.cfg.orderformer,
                                        data["shapes"], w, h)
        return self._order_columns(char_boxes, col_order, thres)

    def columns_stage(self, images: Sequence[np.ndarray], dets, thres: float = 0.8):
        """Host: int-truncate, IoU dedup, k-means/merge columns. Saturated
        pages (>250 boxes) are deferred to the serial masking path."""
        results: List[Optional[List[List[float]]]] = [None] * len(images)
        pages, page_owner, saturated = [], [], []
        char_boxes_per: List[Any] = [None] * len(images)
        for i, (img, flat) in enumerate(zip(images, dets)):
            if len(flat) > 250:
                saturated.append((i, img))
                continue
            h, w = img.shape[:2]
            pair = [[[max(int(b[0]), 0), max(int(b[1]), 0)],
                     [min(int(b[2]), w), min(int(b[3]), h)]] for b in flat]
            char_boxes = boxes_mod.dedup_boxes_iou(pair, 0.8)
            if not char_boxes:
                results[i] = []
                continue
            data = boxes_mod.char2col_with_kmeans(char_boxes, w, h)
            pages.append((data["shapes"], w, h))
            page_owner.append(i)
            char_boxes_per[i] = char_boxes
        return {"results": results, "pages": pages, "page_owner": page_owner,
                "char_boxes_per": char_boxes_per, "saturated": saturated, "thres": thres}

    def order_stage(self, inter, thres: float = 0.8):
        results = inter["results"]
        for i, img in inter["saturated"]:
            results[i] = self.sort_boxes(img, inter["thres"])
        if inter["pages"]:
            orders = orderformer.predict_batch(self.params["orderformer"],
                                               self.cfg.orderformer, inter["pages"])
            for owner, col_order in zip(inter["page_owner"], orders):
                results[owner] = self._order_columns(inter["char_boxes_per"][owner],
                                                     col_order, thres)
        return results

    def batch_sort_boxes(self, images: Sequence[np.ndarray], thres: float = 0.8):
        """One detector forward and one OrderFormer forward for N pages ->
        reading-ordered flat box lists."""
        dets = self.detector.batch(list(images))
        return self.order_stage(self.columns_stage(images, dets, thres), thres)

    def batch_calli_align(
        self,
        images: Sequence[np.ndarray],
        *,
        ordered_lists: Optional[List[Optional[List[List[float]]]]] = None,
    ):
        """Per page (pseudo (3*chars, E), indices (chars, 3)) or (None, None)."""
        if ordered_lists is None:
            with self._span("yolo_orderformer"):
                ordered_lists = self.batch_sort_boxes(images)
        t0 = time.perf_counter()
        all_crops: List[np.ndarray] = []
        counts = []
        for img, ordered in zip(images, ordered_lists):
            n0 = len(all_crops)
            for x1, y1, x2, y2 in ordered or []:
                x1, y1, x2, y2 = int(x1), int(y1), int(x2), int(y2)
                if x2 <= x1 or y2 <= y1:
                    continue
                all_crops.append(img[y1:y2, x1:x2])
            counts.append(len(all_crops) - n0)
        self.timings.add("char_crops", time.perf_counter() - t0)
        if not all_crops:
            return [(None, None)] * len(images)

        n_learns = self.cfg.resampler.num_learns
        parts_ps, parts_ix, ns, idx_parts = [], [], [], []
        # windows of at most CHAR_WINDOW crops bound the char tower's live
        # activations; the small pseudo outputs reassemble in one reorder
        for lo in range(0, len(all_crops), CHAR_WINDOW):
            pp, pi, nn, ii = self._char_parts(all_crops[lo:lo + CHAR_WINDOW])
            parts_ps += pp
            parts_ix += pi
            ns += nn
            idx_parts += [i + lo for i in ii]
        with self._span("vit_resampler_vq"):
            pseudo_all, idx_all = self._reorder(parts_ps, parts_ix, ns, idx_parts)

        out = []
        off = 0
        for count, ordered in zip(counts, ordered_lists):
            if ordered is None or count == 0:
                out.append((None, None))
                continue
            pseudo = pseudo_all[off * n_learns:(off + count) * n_learns]
            idx = idx_all[off:off + count]
            off += count
            out.append((pseudo, idx))
        return out

    # ------------------------------------------------------------ chat

    def _tokenize_prompt(self, query: str) -> np.ndarray:
        return np.asarray(self.tok.encode(query, add_bos=True), np.int32)

    def _expand_image_tokens(self, query: str, num_patches_list: Sequence[int]) -> str:
        for n in num_patches_list:
            query = query.replace(
                "<image>", IMG_START + IMG_CONTEXT * self.cfg.num_image_token * n + IMG_END, 1)
        return query

    def _build_embeds(self, input_ids: torch.Tensor, img_embeds, pseudo_embeds) -> torch.Tensor:
        """Token embed + double splice (<IMG_CONTEXT> = image, ALIGNED = pseudo)."""
        embeds = internlm2.embed_tokens(self.params["llm"], input_ids, self.policy.compute_dtype)
        if img_embeds is not None:
            embeds = vq_mod.splice_embeds(embeds, input_ids, img_embeds,
                                          self.cfg.img_context_token_id)
        if pseudo_embeds is not None:
            embeds = vq_mod.splice_embeds(embeds, input_ids, pseudo_embeds,
                                          self.cfg.aligned_token_id)
        return embeds

    def batch_build_rows(
        self,
        images: Sequence[Any],
        questions: Sequence[str],
        *,
        histories: Optional[Sequence[Optional[List[Tuple[str, str]]]]] = None,
        ordered_lists: Optional[List[Optional[List[List[float]]]]] = None,
    ) -> Dict[str, Any]:
        """Vision + CalliAlign + splice for a batch -> left-padded embeds."""
        if len(images) != len(questions):
            raise ValueError("one question per image")
        if histories is None:
            histories = [None] * len(images)
        conv_sep = get_conv_template(self.cfg.template).sep
        imgs_np = [preprocess.as_rgb_array(im) for im in images]
        with self._span("page_tiling"):
            tile_cat, tile_counts = self.batch_tile_pages(imgs_np)
        aligned = self.batch_calli_align(imgs_np, ordered_lists=ordered_lists)
        with self._span("tile_encode"):
            all_feats = self.encode_image_tiles(tile_cat)

        t0 = time.perf_counter()
        rows, out_questions = [], []
        for i, (question, history) in enumerate(zip(questions, histories)):
            pseudo = aligned[i][0]
            q = "<image>\n" + question if "<image>" not in question else question
            if history is None and pseudo is not None and ALIGNED not in q:
                q = q + ALIGNED * pseudo.shape[0]
            out_questions.append(q)
            conv = build_chat_prompt(q, history)
            query = self._expand_image_tokens(conv.get_prompt(), [tile_counts[i]])
            rows.append((self._tokenize_prompt(query), pseudo))
        self.timings.add("tokenize", time.perf_counter() - t0)

        with self._span("embed_build"):
            bucket = gen.bucket_length(max(len(r[0]) for r in rows))
            B = len(rows)
            padded_ids = np.full((B, bucket), self.tok.pad_token_id, np.int32)
            mask = np.zeros((B, bucket), np.int32)
            for i, (ids, _) in enumerate(rows):
                padded_ids[i, bucket - len(ids):] = ids
                mask[i, bucket - len(ids):] = 1
            nit = self.cfg.num_image_token
            ctx_id, al_id = self.cfg.img_context_token_id, self.cfg.aligned_token_id
            batched_ok = all(
                int(np.sum(padded_ids[i] == ctx_id)) == tile_counts[i] * nit
                and int(np.sum(padded_ids[i] == al_id)) == (0 if ps is None else int(ps.shape[0]))
                for i, (_, ps) in enumerate(rows)
            )
            ids_dev = self._to_dev(padded_ids)
            E = all_feats.shape[-1]
            if batched_ok:
                pseudo_parts = [ps for _, ps in rows if ps is not None]
                embeds = self._build_embeds(
                    ids_dev, all_feats.reshape(-1, E),
                    torch.cat(pseudo_parts, dim=0) if pseudo_parts else None)
            else:
                # per-row splice when a row's slot count differs from its
                # replacement rows (e.g. a history turn without ALIGNED slots)
                off, built = 0, []
                for i, (_, ps) in enumerate(rows):
                    img = all_feats[off:off + tile_counts[i]].reshape(-1, E)
                    off += tile_counts[i]
                    built.append(self._build_embeds(ids_dev[i:i + 1], img, ps))
                embeds = torch.cat(built, dim=0)
        return {"embeds": embeds, "mask": mask, "bucket": bucket,
                "out_questions": out_questions, "histories": histories,
                "conv_sep": conv_sep, "n": B}

    def batch_prepare(
        self,
        images: Sequence[Any],
        questions: Sequence[str],
        *,
        histories=None,
        repetition_penalty: float = 1.5,
        max_new_tokens: int = 1024,
        eos_token_ids: Optional[Tuple[int, ...]] = None,
        prepared_rows: Optional[Dict[str, Any]] = None,
        ordered_lists=None,
    ) -> Dict[str, Any]:
        """batch_build_rows (or ``prepared_rows``) + prefill + greedy decode."""
        rows = prepared_rows if prepared_rows is not None else self.batch_build_rows(
            images, questions, histories=histories, ordered_lists=ordered_lists,
        )
        gen_cfg = gen.GenerateConfig(
            max_new_tokens=max_new_tokens,
            eos_token_ids=(eos_token_ids if eos_token_ids is not None
                           else (self.tok.convert_tokens_to_ids(rows["conv_sep"]),)),
            pad_token_id=self.tok.pad_token_id,
            repetition_penalty=repetition_penalty,
        )
        with self._span("generate"):
            tokens, lengths = gen.generate_from_embeds(
                self.params["llm"], self.cfg.llm, rows["embeds"], self._to_dev(rows["mask"]),
                gen_cfg=gen_cfg, max_cache_len=rows["bucket"] + max_new_tokens,
                policy=self.policy,
            )
        return {"tokens": tokens, "lengths": lengths, "embeds": rows["embeds"],
                "out_questions": rows["out_questions"], "histories": rows["histories"],
                "conv_sep": rows["conv_sep"], "n": rows["n"]}

    def batch_decode(self, prepared: Dict[str, Any], *, return_histories: bool = False):
        """Token ids -> response text (and histories)."""
        t0 = time.perf_counter()
        tokens = prepared["tokens"].cpu().numpy()
        lengths = prepared["lengths"].cpu().numpy()
        conv_sep = prepared["conv_sep"]
        out, new_histories = [], []
        for i in range(prepared["n"]):
            text = self.tok.decode(tokens[i, :lengths[i]].tolist(), skip_special_tokens=True)
            resp = text.split(conv_sep)[0].strip()
            out.append(resp)
            h = list(prepared["histories"][i] or [])
            h.append((prepared["out_questions"][i], resp))
            new_histories.append(h)
        self.timings.add("detokenize", time.perf_counter() - t0)
        return (out, new_histories) if return_histories else out

    def batch_chat_ocr(
        self,
        images: Sequence[Any],
        questions: Sequence[str],
        *,
        histories=None,
        return_histories: bool = False,
        repetition_penalty: float = 1.5,
        max_new_tokens: int = 1024,
        eos_token_ids: Optional[Tuple[int, ...]] = None,
        ordered_lists=None,
    ):
        """Batched full chat_ocr: slicing priors + CalliAlign over all pages,
        then one prefill and one greedy decode for all rows. ``ordered_lists``
        replaces the detector + OrderFormer stage with given reading-order
        boxes per page."""
        prepared = self.batch_prepare(
            images, questions, histories=histories, repetition_penalty=repetition_penalty,
            max_new_tokens=max_new_tokens, eos_token_ids=eos_token_ids,
            ordered_lists=ordered_lists,
        )
        return self.batch_decode(prepared, return_histories=return_histories)


def build_engine(
    preset: str = "callireader-2b",
    device="cuda",
    *,
    seed: int = 0,
    tokenizer_path: str = DEFAULT_MODEL,
    quant: Optional[str] = None,
) -> CalliReaderEngine:
    """Engine for ``preset`` with seeded random weights (no InternVL
    checkpoint ships with the repo; outputs are noise) and, where the
    preset's architecture matches, the committed trained detector,
    OrderFormer and compact CalliAlign tower.

    ``quant="int8"``: the JAX bench's flagship build. The LLM is drawn as
    int8 weight-only in the fused wqkv / w13 layout, its vocab tables are
    padded to a multiple of 128 (``real_vocab_size`` keeps the true size),
    and the decode products run through the int8 kernels."""
    if quant not in (None, "int8"):
        raise ValueError(f"quant={quant!r}: the port has None (bf16) and 'int8'")
    dev = require_device(device)
    cfg = get_config(preset)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = weights.init_params(cfg, g, dtype=torch.bfloat16, device=dev, llm_int8=quant == "int8")
    if quant == "int8":
        params["llm"], llm_cfg = internlm2.pad_vocab(params["llm"], cfg.llm, 128)
        cfg = dataclasses.replace(cfg, llm=llm_cfg)
    cfg, loaded = weights.overlay_trained_assets(params, cfg, dtype=torch.bfloat16, device=dev)
    if loaded:
        print(f"[engine] trained assets loaded: {', '.join(loaded)}", file=sys.stderr)
    return CalliReaderEngine(cfg, params, InternLM2Tokenizer(tokenizer_path), device=dev)
