"""CalliReader engine (PyTorch port of callireader_tpu/runtime/engine.py):
batched full-page ``batch_chat_ocr``, the per-request pieces the servers call
(``calli_align``, ``_build_row_embeds``), the phased box stage a pipelined
caller schedules around a decode (``detect_dispatch`` / ``detect_fetch`` /
``columns_stage`` / ``order_dispatch`` / ``order_fetch``), and the
single-image chat APIs (``chat_ocr`` with region-wise crops and beam search,
``chat``, ``dynamic_chat``, ``batch_chat``), which tile pages on the host as
the JAX engine's do.

    pages -> dynamic tiling (host, or on the device with device_tile_pages)
          -> InternViT tile tower + projector
          -> YOLO detector + host NMS -> dedup / k-means / column merge
          -> OrderFormer + per-column y-sort -> raw char crops
          -> on-device bicubic canvas -> char tower + projector
          -> resampler -> cosine VQ -> Gaussian denorm
          -> double splice into the token embeddings
          -> one prefill + greedy decode (repetition penalty) for all rows

The engine options of the JAX package, with its defaults:
``device_tile_pages`` (the batch API's tiling route; host by default),
``char_canvas`` (the shared tower's canvas lever), ``char_window`` (crops per
fused char dispatch), ``gray_chars`` (default on: char crops ship as luma,
broadcast to RGB on the device; off: full RGB, the reference's crops) and
``device_resize_chars`` (default on: raw crops are resized on the device,
except crops that would be downscaled, which take the host path; off: every
crop takes the host path, the PIL-compatible antialiased bicubic in numpy).
Every entry point that builds char canvases (``batch_calli_align``,
``calli_align``, ``batch_build_rows``, ``chat_ocr``) follows both.

Each stage runs inside a span of utils/profiling.SPANS, named as the stage
(``detect_dispatch`` ... ``order_fetch``, ``page_tiling``, ``char_prep``,
``char_route``, ``tile_encode``, ``tokenize``, ``embed_build``, then
generate's ``prefill`` and ``decode``, then ``readback`` and
``detokenize``), once a call of the batch route; the stages that run on the
device also time it between CUDA events. No span synchronises: the host waits
only in the blocking uploads and readbacks, each a ``blocked.upload`` /
``blocked.readback`` span inside its stage's.

``mesh`` (core/partition.Mesh, one process per rank): the LLM runs tensor
parallel on each rank's blocks (models/internlm2.py; a fused int8 tree is
split back to wq / wk / wv and w1 / w3 first, and the vocabulary is padded to
a multiple of 128 x tensor, so that each rank's share of the LM head stays a
multiple of the int8 kernel's 128). The towers, projector, resampler,
detector and OrderFormer stay whole on every rank. The batch API splits its
rows over "data" (``shard_rows_over_data``): each data rank prefills and
decodes its own rows and the token ids are gathered in row order.
"""

from __future__ import annotations

import dataclasses
import re
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from callireader_tpu_torch.align import vq as vq_mod
from callireader_tpu_torch.core import partition
from callireader_tpu_torch.core.config import MLAMoEConfig, VLMConfig, get_config
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy, require_device
from callireader_tpu_torch.kernels._build import Counter
from callireader_tpu_torch.models import detector as detector_mod
from callireader_tpu_torch.models import internlm2, internvit, mla_moe, orderformer, projector, resampler
from callireader_tpu_torch.parallel import spmd
from callireader_tpu_torch.runtime import generate as gen
from callireader_tpu_torch.runtime import quantize, weights
from callireader_tpu_torch.runtime.conversation import build_chat_prompt, get_conv_template
from callireader_tpu_torch.runtime.tokenizer import DEFAULT_MODEL, InternLM2Tokenizer
from callireader_tpu_torch.utils.profiling import SPANS, readback, upload
from callireader_tpu_torch.vision import boxes as boxes_mod
from callireader_tpu_torch.vision import native, preprocess, resample
from callireader_tpu_torch.vision.device_resize import CHAR_RAW_BUCKETS, bicubic_canvas

CHAR_BUCKETS = (8, 16, 32, 64, 96, 128, 192, 256)
IMG_START, IMG_END, IMG_CONTEXT = "<img>", "</img>", "<IMG_CONTEXT>"
ALIGNED = "[UNUSED_TOKEN_140]"
BATCH_TILE_BUCKETS = (26, 39, 52, 65, 78, 91, 104, 156, 208)
# decode steps batch_prepare enqueued after every row of their batch was done
# (the pad steps of an enqueued decode), counted by batch_decode
DECODE_PAD_STEPS = Counter("decode_pad_steps")


def _drop_zero_rows(pseudo: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """The pseudo rows whose VQ index is not 0 (rows follow indices.reshape(-1))."""
    return pseudo[indices.reshape(-1) != 0]


def _luma(c: np.ndarray) -> np.ndarray:
    """PIL convert("L")'s weights on uint8 RGB, summed in uint16 as the JAX
    package sums them: the sum wraps past 65535 (white gives 58), and the
    committed CalliAlign tower was trained through the same sum (ROADMAP
    queue C)."""
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
        gray_chars: bool = True,
        device_resize_chars: bool = True,
        device_tile_pages: bool = False,
        char_canvas: Optional[int] = None,
        char_window: Optional[int] = None,
        mesh=None,
    ):
        self.device = require_device(device)
        self.mesh = mesh
        if isinstance(cfg.llm, MLAMoEConfig) and "llm" in params:
            if mesh is not None:
                raise NotImplementedError("the MLA-MoE LLM runs on one device: no mesh")
            mla_moe.prepare(params["llm"], cfg.llm)  # the served layout of a drawn tree
        if mesh is not None and "llm" in params:
            cfg, params = self.shard_llm(cfg, params, mesh)
        self.cfg = cfg
        self.params = params
        self.tok = tokenizer
        self.policy = policy
        # char crops as luma (3x fewer bytes to the device; _luma's sum
        # wraps, as the JAX package's) or, off, full RGB: the reference's crops
        self.gray_chars = gray_chars
        # raw crops resized on the device (crops that would downscale take the
        # host path), or, off, every crop resized on the host
        self.device_resize_chars = device_resize_chars
        # the batch API's page tiling: raw pages tiled on the device, or host
        # load_image (the default, bit-equal to the JAX host tiles)
        self.device_tile_pages = device_tile_pages
        if cfg.char_vision is not None:
            # the compact tower's canvas is its native size
            if char_canvas and char_canvas != cfg.char_vision.image_size:
                raise ValueError(f"char_canvas {char_canvas} conflicts with the dedicated char "
                                 f"tower's native {cfg.char_vision.image_size}")
            canvas = cfg.char_vision.image_size
        else:
            canvas = char_canvas or cfg.force_image_size
            if canvas != cfg.force_image_size:
                patch = cfg.vision.patch_size
                if canvas % patch or (canvas // patch) % 2:
                    raise ValueError(f"char_canvas {canvas} must be a multiple of {2 * patch} "
                                     f"(even patch grid for pixel-shuffle)")
                content_hi = preprocess.char_content_canvas(cfg.force_image_size)
                if canvas < content_hi:
                    raise ValueError(f"char_canvas {canvas} cannot hold the [200,{content_hi}] "
                                     f"char content scale")
        self.char_canvas = canvas
        # the input size of the [200, 350] content rule: the compact tower's
        # canvas, else the reference 448 semantics whatever the canvas
        self.char_content_size = (cfg.char_vision.image_size if cfg.char_vision is not None
                                  else cfg.force_image_size)
        # crops per fused char dispatch: bounds the char tower's live set
        self.char_window = int(char_window) if char_window else CHAR_BUCKETS[-1]
        self.detector = (detector_mod.Detector(params["detector"], cfg.detector, self.device)
                         if "detector" in params else None)

    @staticmethod
    def shard_llm(cfg: VLMConfig, params: Dict[str, Any], mesh):
        """The LLM's tree -> this rank's blocks (the unfused layout, the
        vocabulary padded to 128 x tensor where tensor > 1)."""
        llm = quantize.unfuse_llm_int8(params["llm"], cfg.llm)
        t = mesh.axis_size("tensor")
        llm_cfg = cfg.llm
        if t > 1:
            llm, llm_cfg = internlm2.pad_vocab(llm, llm_cfg, 128 * t)
        llm = spmd.shard_tree(llm, spmd.llm_logical_axes(llm_cfg, llm), mesh)
        return dataclasses.replace(cfg, llm=llm_cfg), {**params, "llm": llm}

    def shard_rows_over_data(self, rows: Dict[str, Any]) -> Dict[str, Any]:
        """A batch_build_rows result -> this data rank's rows: the batch is
        padded to a multiple of the "data" size (the last row repeated) and
        split in order; ``rows["n"]`` keeps the true count, so that
        ``_gather_rows`` drops the pad rows again."""
        mesh = self.mesh
        if mesh is None or mesh.axis_size("data") <= 1:
            return rows
        d = mesh.axis_size("data")
        n = int(rows["embeds"].shape[0])
        pad = (-n) % d
        embeds, mask = rows["embeds"], np.asarray(rows["mask"])
        if pad:
            embeds = torch.cat([embeds, embeds[-1:].expand(pad, *embeds.shape[1:])])
            mask = np.concatenate([mask, np.repeat(mask[-1:], pad, axis=0)], axis=0)
        out = dict(rows)
        out["embeds"] = partition.local_shard(embeds, ("data",), mesh)
        out["mask"] = partition.local_shard(torch.from_numpy(mask), ("data",), mesh).numpy()
        return out

    def _gather_rows(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """Every data rank's rows of ``x`` in order, the pad rows dropped."""
        if self.mesh is None or self.mesh.axis_size("data") <= 1:
            return x
        return spmd.all_gather(x, self.mesh, "data", 0)[:n]

    # ------------------------------------------------------------------ util

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return upload(torch.from_numpy(np.ascontiguousarray(a)), self.device)

    # ------------------------------------------------------------ towers

    def _encode_tower(self, vision_params, proj_params, vision_cfg, pixel_values):
        hidden = internvit.forward(vision_params, vision_cfg, pixel_values, policy=self.policy)
        return projector.extract_feature(proj_params, hidden, self.cfg, policy=self.policy)

    def _vision_encode(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) tiles -> (N, num_image_token, E_llm)."""
        p = self.params
        return self._encode_tower(p["vision"], p["projector"], self.cfg.vision, pixel_values)

    def _char_encode(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """The compact char tower when configured; else a ``char_vision``
        overlay over the tile-tower architecture (a v2 CalliAlign asset),
        else the tile tower."""
        p = self.params
        if self.cfg.char_vision is not None:
            return self._encode_tower(p["char_vision"], p["char_projector"],
                                      self.cfg.char_vision, pixel_values)
        return self._encode_tower(p.get("char_vision", p["vision"]), p["projector"],
                                  self.cfg.vision, pixel_values)

    def _resample_vq(self, feats: torch.Tensor, hard_vq: bool = False):
        """(N, tok, dim) -> (pseudo embeds (N*3, E), indices (N, 3))."""
        out = resampler.forward(self.params["resampler"], self.cfg.resampler, feats,
                                policy=self.policy)
        a = self.params["align"]
        return vq_mod.calli_align_embed(out, a["normed_emb"], a["mu"], a["sigma"],
                                        hard_vq=hard_vq)

    def _char_pipeline_raw(self, raw, src_hw, tgt_hw, hard_vq: bool = False):
        """Raw (N, R, R) luma or (N, R, R, 3) RGB crops -> device bicubic
        canvas -> tower -> resampler -> VQ."""
        canvas = bicubic_canvas(raw, src_hw, tgt_hw, self.char_canvas)
        if canvas.ndim == 3:
            canvas = canvas[..., None].expand(*canvas.shape, 3)
        return self._resample_vq(self._char_encode(canvas), hard_vq)

    def _char_pipeline(self, content: torch.Tensor, hard_vq: bool = False):
        """(N, c, c) luma or (N, c, c, 3) RGB content canvases -> white pad to
        the char canvas -> tower -> resampler -> VQ."""
        size, c = self.char_canvas, content.shape[1]
        pad = (size - c) // 2
        spatial = (pad, size - c - pad, pad, size - c - pad)
        if content.ndim == 3:
            x = torch.nn.functional.pad(content, spatial, value=255)
            x = x[..., None].expand(*x.shape, 3)
        else:  # RGB: pad H and W of (N, H, W, 3)
            x = torch.nn.functional.pad(content.permute(0, 3, 1, 2), spatial,
                                        value=255).permute(0, 2, 3, 1)
        return self._resample_vq(self._char_encode(x), hard_vq)

    # ------------------------------------------------------------ tiling

    def _page_tiles(self, pages_u8: torch.Tensor, cols: int, rows: int, thumb: bool):
        """(B, H, W, 3) uint8 pages -> (B*T, S, S, 3) uint8 tiles on the
        device: jax-"cubic" resize to the grid, row-major split, thumbnail
        appended per page. The resize weights are uploaded first, so that the
        ``page_tiling`` bracket holds the launches alone."""
        S = self.cfg.force_image_size
        B, H, W = pages_u8.shape[:3]
        dev = pages_u8.device
        w_grid = resample.jax_resize_hw_weights(H, W, rows * S, cols * S, dev)
        w_thumb = resample.jax_resize_hw_weights(H, W, S, S, dev) if thumb else None
        with SPANS.device("page_tiling"):
            x = pages_u8.float()
            grid = resample.jax_resize_hw(x, rows * S, cols * S, w_grid)
            tiles = (grid.reshape(B, rows, S, cols, S, 3).permute(0, 1, 3, 2, 4, 5)
                     .reshape(B, rows * cols, S, S, 3))
            if thumb:
                tn = resample.jax_resize_hw(x, S, S, w_thumb)
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

    def _luma_if_gray(self, c: np.ndarray) -> np.ndarray:
        return _luma(c) if self.gray_chars else c

    def _prep_char_raw_groups(self, raw_crops: List[np.ndarray]):
        """Group crops by raw square bucket with (src, tgt) dims for the
        device resize, (n, bucket, bucket) luma or (n, bucket, bucket, 3)
        RGB; crops that would downscale go to the host path."""
        size = self.char_content_size
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
            raw = np.full((n, bucket, bucket) if self.gray_chars else (n, bucket, bucket, 3), 255,
                          np.uint8)
            src = np.ones((n, 2), np.int32)
            tgt = np.ones((n, 2), np.int32)
            for j, i in enumerate(idxs):
                c = self._luma_if_gray(raw_crops[i])
                h, w = c.shape[:2]
                raw[j, :h, :w] = c
                nw, nh = preprocess.char_content_dims(w, h, size)
                src[j] = (h, w)
                tgt[j] = (nh, nw)
            groups.append((np.asarray(idxs, np.int64), raw, src, tgt))
        return groups, host_idx

    def _prep_char_crop_groups(self, raw_crops: List[np.ndarray]):
        """Host path: the native char-prep library (vision/native.py, the JAX
        engine's default route) scales each crop by PIL-compatible bicubic to
        the [200, 350] rule and white-pads it to the smallest content-canvas
        bucket that holds it -> [(indices, (n, c, c) luma or (n, c, c, 3)
        RGB)], one entry a bucket."""
        size = self.char_content_size
        buckets = preprocess.char_canvas_buckets(size)
        by_bucket: Dict[int, List[int]] = {}
        for i, c in enumerate(raw_crops):
            nw, nh = preprocess.char_content_dims(c.shape[1], c.shape[0], size)
            m = max(nw, nh)
            by_bucket.setdefault(next((b for b in buckets if b >= m), buckets[-1]), []).append(i)
        lo = max(1, round(200 * size / 448))
        hi = preprocess.char_content_canvas(size)
        out = []
        for bucket, idxs in by_bucket.items():
            stack = native.char_content_batch([raw_crops[i] for i in idxs], bucket, lo, hi)
            out.append((np.asarray(idxs, np.int64), self._luma_if_gray(stack)))
        return out

    def _char_prep(self, raw_crops: List[np.ndarray]):
        """The host half of the char route -> (raw groups for the device
        resize, host-resized groups). Without ``device_resize_chars`` every
        crop takes the host path."""
        if self.device_resize_chars:
            raw_groups, host_idx = self._prep_char_raw_groups(raw_crops)
        else:
            raw_groups, host_idx = [], list(range(len(raw_crops)))
        host_groups = []
        if host_idx:
            host_map = np.asarray(host_idx, np.int64)
            host_groups = [(host_map[idxs], stack) for idxs, stack in
                           self._prep_char_crop_groups([raw_crops[i] for i in host_idx])]
        return raw_groups, host_groups

    def _char_parts(self, groups, hard_vq: bool = False):
        """One char pipeline per bucket group of ``_char_prep`` -> (parts_ps,
        parts_ix, counts, original-index arrays)."""
        raw_groups, host_groups = groups
        parts_ps, parts_ix, ns, idx_order = [], [], [], []
        for idxs, raw, src, tgt in raw_groups:
            raw_p, n = preprocess.pad_to_bucket(raw, CHAR_BUCKETS)
            pad = raw_p.shape[0] - n
            if pad:
                src = np.concatenate([src, np.ones((pad, 2), np.int32)])
                tgt = np.concatenate([tgt, np.ones((pad, 2), np.int32)])
            raw_d, src_d, tgt_d = self._to_dev(raw_p), self._to_dev(src), self._to_dev(tgt)
            with SPANS.device("char_route"):
                ps, ix = self._char_pipeline_raw(raw_d, src_d, tgt_d, hard_vq)
            parts_ps.append(ps)
            parts_ix.append(ix)
            ns.append(n)
            idx_order.append(idxs)
        for idxs, stack in host_groups:
            padded, n = preprocess.pad_to_bucket(stack, CHAR_BUCKETS)
            content = self._to_dev(padded)
            with SPANS.device("char_route"):
                ps, ix = self._char_pipeline(content, hard_vq)
            parts_ps.append(ps)
            parts_ix.append(ix)
            ns.append(n)
            idx_order.append(idxs)
        return parts_ps, parts_ix, ns, idx_order

    def _reorder(self, parts_ps, parts_ix, ns, idx_parts):
        """Strip count padding, concatenate, permute into reading order."""
        n_learns = self.cfg.resampler.num_learns
        E = parts_ps[0].shape[-1]
        perm = self._to_dev(np.argsort(np.concatenate(idx_parts)))
        with SPANS.device("char_route"):
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
        with SPANS.span("columns"):
            data = boxes_mod.char2col_with_kmeans(char_boxes, w, h)
        handle = orderformer.predict_batch_dispatch(self.params["orderformer"], self.cfg.orderformer,
                                                    [(data["shapes"], w, h)])
        with SPANS.span("order_fetch"):
            (col_order,) = orderformer.predict_batch_fetch(handle)
            return self._order_columns(char_boxes, col_order, thres)

    # The batched box stage in phases, for a caller that schedules them around
    # a decode in flight (bench.py): the phases wait for the work queued
    # before them in their readbacks and in their blocking uploads.
    #
    #   detect_dispatch  letterbox + upload + detector forward, no readback
    #   detect_fetch     one readback + host NMS
    #   columns_stage    host: dedup + k-means / column merge
    #   order_dispatch   OrderFormer forward, no readback
    #   order_fetch      score readback + per-column y-sort (+ saturated pages)
    #
    # batch_sort_boxes composes them for callers that do not pipeline.

    def detect_dispatch(self, images: Sequence[np.ndarray]):
        """One batched detector forward, no readback. A detector without
        ``dispatch`` (a stub) is evaluated here, eagerly."""
        disp = getattr(self.detector, "dispatch", None)
        if disp is None:
            det_batch = getattr(self.detector, "batch", None)
            if det_batch is not None:
                return ("dets", det_batch(list(images)))
            return ("dets", [self.detector(im) for im in images])
        return ("handle", disp(list(images)))

    def detect_fetch(self, images: Sequence[np.ndarray], handle):
        """The readback of the detector's candidates, then host NMS -> per
        page box lists."""
        kind, payload = handle
        if kind == "dets":
            return payload
        with SPANS.span("detect_fetch"):
            return self.detector.postprocess(list(images), self.detector.fetch(payload))

    def columns_stage(self, images: Sequence[np.ndarray], dets, thres: float = 0.8):
        """Host: int-truncate, IoU dedup, k-means/merge columns. Saturated
        pages (>250 boxes) are deferred to the serial masking path."""
        results: List[Optional[List[List[float]]]] = [None] * len(images)
        pages, page_owner, saturated = [], [], []
        char_boxes_per: List[Any] = [None] * len(images)
        with SPANS.span("columns"):
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

    def order_dispatch(self, inter):
        """Queue the batched OrderFormer forward, no readback. Saturated
        pages stay deferred to order_fetch."""
        handle = None
        if inter["pages"]:
            handle = orderformer.predict_batch_dispatch(self.params["orderformer"],
                                                        self.cfg.orderformer, inter["pages"])
        return {"inter": inter, "handle": handle}

    def order_fetch(self, st, thres: float = 0.8):
        """The score readback and the per-column y-sort -> reading-ordered
        flat box lists; saturated pages take the serial masking path here,
        first (its box-stage spans beside this one's, none inside
        another)."""
        inter = st["inter"]
        results = inter["results"]
        for i, img in inter["saturated"]:
            results[i] = self.sort_boxes(img, inter["thres"])
        with SPANS.span("order_fetch"):
            if st["handle"] is not None:
                orders = orderformer.predict_batch_fetch(st["handle"])
                for owner, col_order in zip(inter["page_owner"], orders):
                    results[owner] = self._order_columns(inter["char_boxes_per"][owner],
                                                         col_order, thres)
        return results

    def order_stage(self, inter, thres: float = 0.8):
        """order_dispatch then order_fetch, back to back."""
        return self.order_fetch(self.order_dispatch(inter), thres)

    def batch_sort_boxes(self, images: Sequence[np.ndarray], thres: float = 0.8, dets=None):
        """One detector forward and one OrderFormer forward for N pages ->
        reading-ordered flat box lists. ``dets``: detect_fetch's output, when
        the caller ran the detector already."""
        if dets is None:
            dets = self.detect_fetch(images, self.detect_dispatch(images))
        return self.order_stage(self.columns_stage(images, dets, thres), thres)

    def batch_calli_align(
        self,
        images: Sequence[np.ndarray],
        *,
        drop_zero: bool = False,
        hard_vq: bool = False,
        ordered_lists: Optional[List[Optional[List[List[float]]]]] = None,
    ):
        """Per page (pseudo (3*chars, E), indices (chars, 3)) or (None, None);
        ``drop_zero`` drops the pseudo rows whose VQ index is 0, ``hard_vq``
        replaces low-confidence rows by their table rows."""
        if ordered_lists is None:
            ordered_lists = self.batch_sort_boxes(images)
        # windows of at most char_window crops bound the char tower's live
        # activations; the small pseudo outputs reassemble in one reorder
        win = self.char_window
        with SPANS.span("char_prep"):
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
            windows = [(lo, self._char_prep(all_crops[lo:lo + win]))
                       for lo in range(0, len(all_crops), win)]
        if not all_crops:
            return [(None, None)] * len(images)

        n_learns = self.cfg.resampler.num_learns
        parts_ps, parts_ix, ns, idx_parts = [], [], [], []
        with SPANS.span("char_route"):
            for lo, groups in windows:
                pp, pi, nn, ii = self._char_parts(groups, hard_vq)
                parts_ps += pp
                parts_ix += pi
                ns += nn
                idx_parts += [i + lo for i in ii]
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
            out.append((_drop_zero_rows(pseudo, idx) if drop_zero else pseudo, idx))
        return out

    def calli_align(self, image: np.ndarray, *, drop_zero: bool = False, hard_vq: bool = False,
                    verbose: bool = False):
        """One page -> (pseudo (3 * chars, E), indices (chars, 3)) on the
        device, or (None, None) when the detector finds no character.
        ``drop_zero`` drops the pseudo rows whose VQ index is 0, ``hard_vq``
        replaces low-confidence rows by their table rows."""
        ordered = self.sort_boxes(image)
        with SPANS.span("char_prep"):
            raw_crops = []
            for x1, y1, x2, y2 in ordered:
                x1, y1, x2, y2 = int(x1), int(y1), int(x2), int(y2)
                if x2 <= x1 or y2 <= y1:
                    continue
                raw_crops.append(image[y1:y2, x1:x2])
            groups = self._char_prep(raw_crops)
        if not raw_crops:
            return None, None
        with SPANS.span("char_route"):
            pseudo, indices = self._reorder(*self._char_parts(groups, hard_vq))
        if drop_zero:
            pseudo = _drop_zero_rows(pseudo, indices)
        if verbose:
            print(f"calli_align: {len(ordered)} chars -> {pseudo.shape[0]} pseudo tokens")
        return pseudo, indices

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
        embeds = gen.llm_family(self.cfg.llm).embed_tokens(
            self.params["llm"], input_ids, self.policy.compute_dtype, self.mesh, self.cfg.llm)
        if img_embeds is not None:
            embeds = vq_mod.splice_embeds(embeds, input_ids, img_embeds,
                                          self.cfg.img_context_token_id)
        if pseudo_embeds is not None:
            embeds = vq_mod.splice_embeds(embeds, input_ids, pseudo_embeds,
                                          self.cfg.aligned_token_id)
        return embeds

    def _build_row_embeds(self, input_ids: np.ndarray, img_embeds, pseudo_embeds, bucket: int):
        """One request's prompt -> (embeds (1, bucket, E) on the device, mask
        (1, bucket)), left-padded. (The JAX engine also pads the replacement
        rows to buckets so that its splice compiles once per bucket; the
        splice ignores extra rows and nothing compiles here.)"""
        S = len(input_ids)
        padded_ids = np.full((1, bucket), self.tok.pad_token_id, np.int32)
        padded_ids[0, bucket - S:] = input_ids
        mask = np.zeros((1, bucket), np.int32)
        mask[0, bucket - S:] = 1
        img = None if img_embeds is None else img_embeds.reshape(-1, img_embeds.shape[-1])
        ids_dev = self._to_dev(padded_ids)
        with SPANS.device("embed_build"):
            return self._build_embeds(ids_dev, img, pseudo_embeds), mask

    def batch_build_rows(
        self,
        images: Sequence[Any],
        questions: Sequence[str],
        *,
        histories: Optional[Sequence[Optional[List[Tuple[str, str]]]]] = None,
        use_p: bool = True,
        drop_zero: bool = False,
        hard_vq: bool = False,
        ordered_lists: Optional[List[Optional[List[List[float]]]]] = None,
    ) -> Dict[str, Any]:
        """Vision + CalliAlign (``use_p``) + splice for a batch -> left-padded
        embeds."""
        if len(images) != len(questions):
            raise ValueError("one question per image")
        if histories is None:
            histories = [None] * len(images)
        conv_sep = get_conv_template(self.cfg.template).sep
        imgs_np = [preprocess.as_rgb_array(im) for im in images]
        with SPANS.span("page_tiling"):
            if self.device_tile_pages:
                tile_cat, tile_counts = self.batch_tile_pages(imgs_np)
            else:
                cfg = self.cfg
                pixel_list = [preprocess.load_image(im, cfg.force_image_size, cfg.max_dynamic_patch,
                                                    cfg.use_thumbnail) for im in imgs_np]
                tile_counts = [pv.shape[0] for pv in pixel_list]
                tile_cat = self._to_dev(np.concatenate(pixel_list, axis=0))
        aligned = (self.batch_calli_align(imgs_np, drop_zero=drop_zero, hard_vq=hard_vq,
                                          ordered_lists=ordered_lists)
                   if use_p else [(None, None)] * len(images))
        with SPANS.span("tile_encode"), SPANS.device("tile_encode"):
            all_feats = self.encode_image_tiles(tile_cat)

        with SPANS.span("tokenize"):
            rows, out_questions = [], []
            for i, (question, history) in enumerate(zip(questions, histories)):
                pseudo = aligned[i][0]
                q = "<image>\n" + question if "<image>" not in question else question
                if history is None and use_p and pseudo is not None and ALIGNED not in q:
                    q = q + ALIGNED * pseudo.shape[0]
                out_questions.append(q)
                conv = build_chat_prompt(q, history)
                query = self._expand_image_tokens(conv.get_prompt(), [tile_counts[i]])
                rows.append((self._tokenize_prompt(query), pseudo))

        with SPANS.span("embed_build"):
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
            with SPANS.device("embed_build"):
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
        use_p: bool = True,
        drop_zero: bool = False,
        hard_vq: bool = False,
        repetition_penalty: float = 1.5,
        max_new_tokens: int = 1024,
        eos_token_ids: Optional[Tuple[int, ...]] = None,
        prepared_rows: Optional[Dict[str, Any]] = None,
        ordered_lists=None,
        overlap: bool = True,
    ) -> Dict[str, Any]:
        """Front half of batch_chat_ocr: batch_build_rows (or
        ``prepared_rows``), then the prefill and the greedy decode put on the
        stream, returning before the decode retires (the JAX batch_prepare's
        async dispatch); batch_decode waits for it. ``overlap`` (default):
        every chunk of the decode is enqueued now, so the host can build the
        next batch meanwhile (the pipelined schedule of bench.py); ``tokens``
        and ``lengths`` of the result are device tensors the decode fills.
        An enqueued decode cannot stop early: the chunks after every row is
        done run as pad steps (no token changes; batch_decode counts them in
        the result's ``pad_steps`` and in ``DECODE_PAD_STEPS``).
        ``overlap=False`` (batch_chat_ocr, where nothing overlaps the
        decode): the decode runs here, looking at ``done``
        between chunks and stopping at the first boundary where every row is
        done, as chat_ocr's does."""
        rows = prepared_rows if prepared_rows is not None else self.batch_build_rows(
            images, questions, histories=histories, use_p=use_p, drop_zero=drop_zero,
            hard_vq=hard_vq, ordered_lists=ordered_lists,
        )
        rows = self.shard_rows_over_data(rows)
        gen_cfg = gen.GenerateConfig(
            max_new_tokens=max_new_tokens,
            eos_token_ids=(eos_token_ids if eos_token_ids is not None
                           else (self.tok.convert_tokens_to_ids(rows["conv_sep"]),)),
            pad_token_id=self.tok.pad_token_id,
            repetition_penalty=repetition_penalty,
        )
        tokens, lengths = gen.generate_from_embeds(
            self.params["llm"], self.cfg.llm, rows["embeds"],
            torch.from_numpy(np.ascontiguousarray(rows["mask"])),
            gen_cfg=gen_cfg, max_cache_len=rows["bucket"] + max_new_tokens,
            policy=self.policy, overlap=overlap, mesh=self.mesh,
        )
        tokens, lengths = self._gather_rows(tokens, rows["n"]), self._gather_rows(lengths, rows["n"])
        return {"tokens": tokens, "lengths": lengths, "embeds": rows["embeds"],
                "mask": rows["mask"], "bucket": rows["bucket"], "gen_cfg": gen_cfg,
                "overlap": overlap, "out_questions": rows["out_questions"],
                "histories": rows["histories"], "conv_sep": rows["conv_sep"], "n": rows["n"]}

    def batch_decode(self, prepared: Dict[str, Any], *, return_histories: bool = False):
        """Back half of batch_chat_ocr: wait for the decode of batch_prepare
        (the device-to-host read of its tokens), then token ids -> response
        text (and histories)."""
        with SPANS.span("readback"):
            tokens = readback(prepared["tokens"]).numpy()
            lengths = readback(prepared["lengths"]).numpy()
        if prepared.get("overlap"):
            prepared["pad_steps"] = gen.pad_steps(tokens, lengths,
                                                  prepared["gen_cfg"].eos_token_ids)
            DECODE_PAD_STEPS.add(prepared["pad_steps"])
        with SPANS.span("detokenize"):
            conv_sep = prepared["conv_sep"]
            out, new_histories = [], []
            for i in range(prepared["n"]):
                text = self.tok.decode(tokens[i, :lengths[i]].tolist(), skip_special_tokens=True)
                resp = text.split(conv_sep)[0].strip()
                out.append(resp)
                h = list(prepared["histories"][i] or [])
                h.append((prepared["out_questions"][i], resp))
                new_histories.append(h)
        return (out, new_histories) if return_histories else out

    def batch_chat_ocr(
        self,
        images: Sequence[Any],
        questions: Sequence[str],
        *,
        histories=None,
        return_histories: bool = False,
        use_p: bool = True,
        drop_zero: bool = False,
        hard_vq: bool = False,
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
            images, questions, histories=histories, use_p=use_p, drop_zero=drop_zero,
            hard_vq=hard_vq, repetition_penalty=repetition_penalty,
            max_new_tokens=max_new_tokens, eos_token_ids=eos_token_ids,
            ordered_lists=ordered_lists, overlap=False,
        )
        return self.batch_decode(prepared, return_histories=return_histories)

    # ------------------------------------------------------- single-image chat

    @staticmethod
    def find_coordinates(text: str) -> List[int]:
        return [int(n) for n in re.findall(r"\d+", text)]

    def _gen_cfg(self, conv_sep: str, **kw) -> gen.GenerateConfig:
        return gen.GenerateConfig(eos_token_ids=(self.tok.convert_tokens_to_ids(conv_sep),),
                                  pad_token_id=self.tok.pad_token_id, **kw)

    def _generate(self, input_ids: np.ndarray, img_embeds, pseudo_embeds,
                  gen_cfg: gen.GenerateConfig) -> List[int]:
        """One prompt -> its generated token ids (beam search when
        ``gen_cfg.num_beams > 1``)."""
        bucket = gen.bucket_length(len(input_ids))
        with SPANS.span("embed_build"):
            embeds, mask = self._build_row_embeds(input_ids, img_embeds, pseudo_embeds, bucket)
        gen_fn = gen.beam_generate_from_embeds if gen_cfg.num_beams > 1 else gen.generate_from_embeds
        tokens, lengths = gen_fn(self.params["llm"], self.cfg.llm, embeds, torch.from_numpy(mask),
                                 gen_cfg=gen_cfg, max_cache_len=bucket + gen_cfg.max_new_tokens,
                                 policy=self.policy, mesh=self.mesh)
        with SPANS.span("readback"):
            tokens, lengths = readback(tokens), readback(lengths)
        return tokens[0, :int(lengths[0])].tolist()

    def _page_tiles_host(self, img_np: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        with SPANS.span("page_tiling"):
            return preprocess.load_image(img_np, cfg.force_image_size, cfg.max_dynamic_patch,
                                         cfg.use_thumbnail)

    def _respond(self, out_tokens: List[int], conv_sep: str) -> str:
        with SPANS.span("detokenize"):
            return self.tok.decode(out_tokens, skip_special_tokens=True).split(conv_sep)[0].strip()

    def chat_ocr(
        self,
        image: Optional[Any],
        question: str,
        *,
        history: Optional[List[Tuple[str, str]]] = None,
        return_history: bool = False,
        use_p: bool = True,
        drop_zero: bool = False,
        hard_vq: bool = False,
        repetition_penalty: float = 1.5,
        max_new_tokens: int = 1024,
        num_beams: int = 1,
        region_wise: bool = False,
        verbose: bool = False,
    ):
        """Full CalliReader chat on one page (a path, ``.npy`` or image file,
        or an array): host tiling, CalliAlign (``use_p``), one prompt, greedy
        decode or beam search (``num_beams > 1``). ``region_wise`` crops the
        page to the first four numbers of the question (x1 x2 y1 y2) and
        answers "检测失败" when no character is found there."""
        pixel_values = img_np = None
        if image is not None:
            img_np = preprocess.open_image(image)
            if region_wise:
                x1, x2, y1, y2 = self.find_coordinates(question)[:4]
                img_np = img_np[y1:y2, x1:x2]
                question = "输出图片中所有文字:"
            pixel_values = self._page_tiles_host(img_np)

        pseudo = None
        if use_p and img_np is not None:
            pseudo, _ = self.calli_align(img_np, drop_zero=drop_zero, hard_vq=hard_vq,
                                         verbose=verbose)
            if pseudo is None and region_wise:
                return ("检测失败", history) if return_history else "检测失败"

        if pixel_values is not None and "<image>" not in question:
            question = "<image>\n" + question
        if history is None and use_p and pseudo is not None and ALIGNED not in question:
            question = question + ALIGNED * pseudo.shape[0]
        conv = build_chat_prompt(question, history)
        n_tiles = [] if pixel_values is None else [pixel_values.shape[0]]
        with SPANS.span("tokenize"):
            input_ids = self._tokenize_prompt(self._expand_image_tokens(conv.get_prompt(), n_tiles))
        img_embeds = None
        if pixel_values is not None:
            with SPANS.span("tile_encode"):
                tiles = self._to_dev(pixel_values)
                with SPANS.device("tile_encode"):
                    img_embeds = self.encode_image_tiles(tiles)
        gen_cfg = self._gen_cfg(conv.sep, max_new_tokens=max_new_tokens,
                                repetition_penalty=repetition_penalty, num_beams=num_beams)
        response = self._respond(self._generate(input_ids, img_embeds, pseudo, gen_cfg), conv.sep)
        history = list(history or [])
        history.append((question, response))
        return (response, history) if return_history else response

    def chat(
        self,
        image: Optional[Any],
        question: str,
        *,
        history: Optional[List[Tuple[str, str]]] = None,
        return_history: bool = False,
        repetition_penalty: float = 1.0,
        max_new_tokens: int = 1024,
        num_beams: int = 1,
    ):
        """Plain VLM chat, no CalliAlign."""
        return self.chat_ocr(
            image, question, history=history, return_history=return_history, use_p=False,
            repetition_penalty=repetition_penalty, max_new_tokens=max_new_tokens,
            num_beams=num_beams,
        )

    def dynamic_chat(
        self,
        image: Optional[Any],
        question: str,
        *,
        history: Optional[List[Tuple[str, str]]] = None,
        return_history: bool = False,
        use_p: bool = True,
        repetition_penalty: float = 1.0,
        max_new_tokens: int = 1024,
    ):
        """Ablation path: the page's tile features run through the resampler,
        VQ and denorm and stand in for the usual image tokens (num_learns
        per tile in place of num_image_token)."""
        if not use_p or image is None:
            return self.chat(image, question, history=history, return_history=return_history,
                             repetition_penalty=repetition_penalty, max_new_tokens=max_new_tokens)
        pixel_values = self._page_tiles_host(preprocess.open_image(image))
        n_tiles = pixel_values.shape[0]
        padded, n = preprocess.pad_to_bucket(pixel_values)
        with SPANS.span("tile_encode"):
            tiles = self._to_dev(padded)
            with SPANS.device("tile_encode"):
                pseudo, _ = self._resample_vq(self._vision_encode(tiles))
        n_learns = self.cfg.resampler.num_learns
        pseudo = pseudo[:n * n_learns]

        conv = build_chat_prompt(question, history)
        query = conv.get_prompt()
        image_tokens = IMG_CONTEXT * n_learns * n_tiles
        if "<image>" in query:
            query = query.replace("<image>", image_tokens, 1)
        else:
            query = query.replace(conv.roles[1], image_tokens + conv.roles[1], 1)
        gen_cfg = self._gen_cfg(conv.sep, max_new_tokens=max_new_tokens,
                                repetition_penalty=repetition_penalty)
        # the pseudo embeddings stand at the <IMG_CONTEXT> positions
        out = self._generate(self._tokenize_prompt(query), pseudo[None], None, gen_cfg)
        response = self._respond(out, conv.sep)
        history = list(history or [])
        history.append((question, response))
        return (response, history) if return_history else response

    def batch_chat(
        self,
        images: Sequence[Any],
        questions: Sequence[str],
        *,
        repetition_penalty: float = 1.0,
        max_new_tokens: int = 1024,
    ) -> List[str]:
        """Left-padded batched plain chat: every row in one prefill and one
        decode loop."""
        if len(images) != len(questions):
            raise ValueError("one question per image")
        conv_sep = get_conv_template(self.cfg.template).sep
        rows = []
        for image, question in zip(images, questions):
            pixel_values = self._page_tiles_host(preprocess.open_image(image))
            q = "<image>\n" + question if "<image>" not in question else question
            query = self._expand_image_tokens(build_chat_prompt(q, None).get_prompt(),
                                              [pixel_values.shape[0]])
            with SPANS.span("tile_encode"):
                tiles = self._to_dev(pixel_values)
                with SPANS.device("tile_encode"):
                    feats = self.encode_image_tiles(tiles)
            with SPANS.span("tokenize"):
                rows.append((self._tokenize_prompt(query), feats))
        bucket = gen.bucket_length(max(len(ids) for ids, _ in rows))
        with SPANS.span("embed_build"):
            built = [self._build_row_embeds(ids, feats, None, bucket) for ids, feats in rows]
            embeds = torch.cat([e for e, _ in built], dim=0)
        mask = np.concatenate([m for _, m in built], axis=0)
        gen_cfg = self._gen_cfg(conv_sep, max_new_tokens=max_new_tokens,
                                repetition_penalty=repetition_penalty)
        tokens, lengths = gen.generate_from_embeds(
            self.params["llm"], self.cfg.llm, embeds, torch.from_numpy(mask), gen_cfg=gen_cfg,
            max_cache_len=bucket + max_new_tokens, policy=self.policy, mesh=self.mesh)
        with SPANS.span("readback"):
            tokens, lengths = readback(tokens).numpy(), readback(lengths).numpy()
        return [self._respond(tokens[i, :lengths[i]].tolist(), conv_sep) for i in range(len(rows))]


def build_engine(
    preset: str = "callireader-2b",
    device="cuda",
    *,
    seed: int = 0,
    tokenizer_path: str = DEFAULT_MODEL,
    quant: Optional[str] = None,
    assets: Sequence[str] = weights.TRAINED_ASSETS,
    **engine_options,
) -> CalliReaderEngine:
    """Engine for ``preset`` with seeded random weights (no InternVL
    checkpoint ships with the repo; outputs are noise) and, where the
    preset's architecture matches, the committed trained assets named in
    ``assets`` (detector, OrderFormer, compact CalliAlign tower); the names
    loaded are kept in ``engine.assets``. ``engine_options`` go to
    CalliReaderEngine (``gray_chars``, ``device_resize_chars``,
    ``device_tile_pages``, ``char_canvas``, ``char_window``).

    ``quant="int8"``: the JAX bench's flagship build. The LLM is drawn as
    int8 weight-only in the fused wqkv / w13 layout, its vocab tables are
    padded to a multiple of 128 (``real_vocab_size`` keeps the true size),
    and the decode products run through the int8 kernels. ``"int8-all"``
    adds the W8A8 tile tower (runtime/quantize.quantize_vit_int8); the
    compact char tower stays bf16, as in the JAX builders."""
    if quant not in (None, "int8", "int8-all"):
        raise ValueError(f"quant={quant!r}: the port has None (bf16), 'int8' and 'int8-all'")
    dev = require_device(device)
    cfg = get_config(preset)
    if quant is not None and isinstance(cfg.llm, MLAMoEConfig):
        raise ValueError(f"{preset}: the MLA-MoE LLM is served in bf16, as published (quant=None)")
    params = weights.init_params(cfg, seed, dtype=torch.bfloat16, device=dev,
                                 llm_int8=quant is not None)
    if quant is not None:
        params["llm"], llm_cfg = internlm2.pad_vocab(params["llm"], cfg.llm, 128)
        cfg = dataclasses.replace(cfg, llm=llm_cfg)
    if quant == "int8-all":
        params["vision"] = quantize.quantize_vit_int8(params["vision"])
    cfg, loaded = weights.overlay_trained_assets(params, cfg, dtype=torch.bfloat16, device=dev,
                                                 names=assets)
    if loaded:
        print(f"[engine] trained assets loaded: {', '.join(loaded)}", file=sys.stderr)
    engine = CalliReaderEngine(cfg, params, InternLM2Tokenizer(tokenizer_path), device=dev,
                               **engine_options)
    engine.assets = loaded
    return engine
