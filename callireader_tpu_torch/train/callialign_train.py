"""CalliAlign training: char crop -> resampler -> cosine VQ == its own token
(PyTorch port of callireader_tpu/train/callialign_train.py).

Trains the contract the reference ships as ``callialign.pth`` +
``gauss_norm.pth``: a detected character crop runs through a ViT + projector
and the PerceiverResampler, and each of its ``num_learns`` pseudo tokens must
cosine-VQ (argmax over the 92553-row normalised token table) to the
character's own vocab token. The table is the engine's seed-0
``align.normed_emb`` (runtime/weights.draw_align_table), drawn without the
LLM, so one asset serves every preset whose LLM has the 2b's and the 8b's
hidden size and vocab.

Data: augmented crops of the reference fixture page (``examples/0.jpg`` with
its labelme ``0.json`` at the root of the repository; the readers raise while
it is absent) and procedural brush glyphs (train/detector_train.make_glyph,
codepoint-seeded) for the other single-char vocab pieces. The augmentation
is Pillow's arithmetic in numpy (vision/resample.py): a numpy
``RandomState`` gives the JAX package's views byte for byte, and the card's
machine needs no Pillow.

Two recipes:
  - v2: LoRA over the engine's seed-0 tile-tower InternViT (its
    VIT_LORA_MATS) and the seed-0 resampler (LORA_MATS), plus their small
    leaves; the asset stores the LoRA factors in fp16 and the small leaves
    in fp32, and ``apply_asset`` merges them over the seed-0 draws.
  - v3 (the shipping one): a compact char tower (CHAR_VISION_V3, its
    projector, CHAR_RESAMPLER_V3 with a 4096-wide output) trained from
    scratch; the asset is the whole stack in fp16.

The ViT runs its plain attention in training (``attn_impl="reference"``):
the ViT kernel has no backward, and its wrapper raises
on an input that requires grad. The v2 tower runs each layer under
``torch.utils.checkpoint``. Both steps are: the loss, the trainable leaves'
gradients, then train/e_it.Optimizer (clip by global norm, AdamW) writing
the trainable tree in place. Steps and evals run inside
core.dtypes.exact_fp32: float32 products in full float32 (matmul precision
"highest", cuDNN's TF32 off), as the JAX trainer's FP32_POLICY computes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from callireader_tpu_torch.core.config import ResamplerConfig, VLMConfig
from callireader_tpu_torch.core.dtypes import DTypePolicy, exact_fp32
from callireader_tpu_torch.models import internvit, projector, resampler
from callireader_tpu_torch.models.internvit import VIT_LORA_MATS
from callireader_tpu_torch.models.resampler import LORA_MATS
from callireader_tpu_torch.runtime import weights
from callireader_tpu_torch.runtime.weights import (  # noqa: F401  (the trainer's asset API)
    CHAR_RESAMPLER_V3, CHAR_VISION_V3, apply_v3_asset, asset_version, load_v3_asset, v3_configs,
)
from callireader_tpu_torch.train import e_it
from callireader_tpu_torch.train.detector_train import FIXTURE_IMG, FIXTURE_JSON, make_glyph
from callireader_tpu_torch.vision import preprocess
from callireader_tpu_torch.vision import resample as rs
from callireader_tpu_torch.vision.device_resize import bicubic_canvas

RAW_BUCKET = 128  # augmented crops are kept <= this square (page-res pixels)
Tree = Dict

# ---------------------------------------------------------------------------
# the engine's seed-0 draws
# ---------------------------------------------------------------------------


def base_resampler_params(cfg: ResamplerConfig, dtype=torch.bfloat16, device="cuda") -> Tree:
    """The engine's resampler for seed 0 (runtime/weights.init_params draws
    the same)."""
    return weights.draw_resampler(cfg, 0, dtype=dtype, device=device)


def base_vision_params(cfg: VLMConfig, dtype=torch.bfloat16, device="cuda") -> Tree:
    """The engine's tile-tower ViT for seed 0: the v2 char-ViT asset is a
    delta over it."""
    return weights.draw_vision(cfg.vision, 0, dtype=dtype, device=device)


def align_table(vocab_size: int, hidden_size: int, dtype=torch.bfloat16,
                device="cuda") -> torch.Tensor:
    """The engine's random ``align.normed_emb`` for seed 0: the VQ codebook
    the training targets."""
    return weights.draw_align_table(vocab_size, hidden_size, 0, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# data: fixture crops + procedural glyphs
# ---------------------------------------------------------------------------


def single_char_vocab(tok) -> List[Tuple[int, str]]:
    """Every single-CJK-character vocab piece [(token_id, char)]: the label
    space (~7k)."""
    out = []
    for tid in range(tok.vocab_size):
        t = tok.convert_ids_to_tokens(tid)
        if t and len(t) == 1 and "一" <= t <= "鿿":
            out.append((tid, t))
    return out


def _to_luma(rgb: np.ndarray) -> np.ndarray:
    if rgb.ndim == 2:
        return rgb
    c = rgb.astype(np.uint16)
    return ((c[..., 0] * 299 + c[..., 1] * 587 + c[..., 2] * 114) // 1000).astype(np.uint8)


def _read_fixture(jpg, js):
    """-> (RGB page, labelme shapes); Pillow decodes the page. Raises naming
    the file while the fixture is not in the repository."""
    for path in (jpg, js):
        if not os.path.exists(path):
            raise FileNotFoundError(f"the CalliAlign fixture {path} is not in the repository")
    from PIL import Image

    img = np.asarray(Image.open(jpg).convert("RGB"))
    with open(js) as f:
        return img, json.load(f)["shapes"]


def _margined(img, x1, y1, x2, y2, margin):
    H, W = img.shape[:2]
    mw, mh = (x2 - x1) * margin, (y2 - y1) * margin
    gx1, gy1 = max(0, int(x1 - mw)), max(0, int(y1 - mh))
    gx2, gy2 = min(W, int(x2 + mw)), min(H, int(y2 + mh))
    crop = _to_luma(img[gy1:gy2, gx1:gx2])
    # the box relative to the margined crop (the augmentation re-crops it)
    return crop, (int(y1) - gy1, int(x1) - gx1, int(y2) - gy1, int(x2) - gx1)


def fixture_samples(tok, jpg=FIXTURE_IMG, js=FIXTURE_JSON, margin: float = 0.12):
    """[(luma crop with margin, box (y1, x1, y2, x2) px, char, token_id)] for
    every GT char of the fixture page whose label is one vocab token."""
    img, shapes = _read_fixture(jpg, js)
    H, W = img.shape[:2]
    out = []
    for s in shapes:
        ids = tok.encode(s["label"], add_bos=False)
        if len(ids) != 1:
            continue
        (x1, y1), (x2, y2) = s["points"]
        crop, rel = _margined(img, x1 * W, y1 * H, x2 * W, y2 * H, margin)
        out.append((crop, rel, s["label"], ids[0]))
    return out


def fixture_detector_samples(tok, jpg=FIXTURE_IMG, js=FIXTURE_JSON, margin: float = 0.12,
                             match_iou: float = 0.4, device="cuda"):
    """Like fixture_samples, but the crops come from the trained detector's
    own boxes on the page (the committed detector_640.npz at conf 0.5, IoU
    0.3), each matched to the GT label it overlaps most (IoU >= match_iou).
    [] where the detector asset is absent."""
    from callireader_tpu_torch.core.config import DetectorConfig
    from callireader_tpu_torch.models import detector as det_mod

    img, shapes = _read_fixture(jpg, js)
    ckpt = weights.ASSETS_DIR / "detector_640.npz"
    if not ckpt.exists():
        return []
    det_cfg = dataclasses.replace(DetectorConfig(), conf_threshold=0.5, iou_threshold=0.3)
    det = det_mod.Detector(det_mod.load_npz(str(ckpt), device), det_cfg, device)
    H, W = img.shape[:2]
    gt = []
    for s in shapes:
        ids = tok.encode(s["label"], add_bos=False)
        if len(ids) != 1:
            continue
        (x1, y1), (x2, y2) = s["points"]
        gt.append((x1 * W, y1 * H, x2 * W, y2 * H, ids[0], s["label"]))

    def iou(a, b):
        ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
        ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
        inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
        ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
        return inter / max(ua - inter, 1e-6)

    out = []
    for box in det(img):
        x1, y1, x2, y2 = box[:4]
        best = max(gt, key=lambda g: iou((x1, y1, x2, y2), g[:4]))
        if iou((x1, y1, x2, y2), best[:4]) < match_iou:
            continue
        crop, rel = _margined(img, x1, y1, x2, y2, margin)
        out.append((crop, rel, best[5], best[4]))
    return out


def glyph_for_char(char: str, size: int = 72) -> np.ndarray:
    """Deterministic procedural glyph for a vocab char: brush-bezier strokes
    seeded by the codepoint. Luma uint8 ink on paper."""
    rng = np.random.RandomState((ord(char) * 2654435761) % (2**31 - 1))
    mask = make_glyph(rng, size)  # (s, s) in [0, 1]
    paper = rng.randint(235, 252)
    ink = rng.randint(15, 70)
    return np.clip(paper - mask * (paper - ink), 0, 255).astype(np.uint8)


def augment_luma(luma: np.ndarray, rng: np.random.RandomState,
                 box: Optional[Tuple[int, int, int, int]] = None,
                 strength: float = 1.0) -> np.ndarray:
    """Geometric + photometric augmentation of a luma crop, drawing from
    ``rng`` draw for draw as the JAX function does. ``box`` (margined
    fixture crops): the GT box jittered by +-8% an edge before the crop (the
    detector's box noise). -> luma uint8 with max edge <= RAW_BUCKET."""
    a = luma
    if box is not None:
        y1, x1, y2, x2 = box
        h, w = y2 - y1, x2 - x1
        j = 0.08 * strength
        y1 = int(np.clip(y1 + rng.uniform(-j, j) * h, 0, a.shape[0] - 2))
        y2 = int(np.clip(y2 + rng.uniform(-j, j) * h, y1 + 2, a.shape[0]))
        x1 = int(np.clip(x1 + rng.uniform(-j, j) * w, 0, a.shape[1] - 2))
        x2 = int(np.clip(x2 + rng.uniform(-j, j) * w, x1 + 2, a.shape[1]))
        a = a[y1:y2, x1:x2]
    # rotation (white fill: calligraphy columns are near-upright)
    if rng.rand() < 0.8:
        a = rs.pil_rotate(np.ascontiguousarray(a), rng.uniform(-7, 7) * strength, fillcolor=255)
    # scale wobble (the [200, 350] rule renormalises; this varies resampling)
    if rng.rand() < 0.7:
        s = rng.uniform(0.7, 1.25)
        a = rs.pil_resize(a, (max(8, int(a.shape[1] * s)), max(8, int(a.shape[0] * s))),
                          "bilinear")
    # ink thickness: the min filter dilates dark strokes, the max filter erodes
    r = rng.rand()
    if r < 0.25:
        a = rs.pil_rank_filter(a, 3, "min")
    elif r < 0.4:
        a = rs.pil_rank_filter(a, 3, "max")
    if rng.rand() < 0.3:
        a = rs.pil_gaussian_blur(a, rng.uniform(0.3, 0.9))
    a = np.asarray(a).astype(np.float32)
    # photometric: gamma + brightness / contrast + noise
    if rng.rand() < 0.8:
        a = 255.0 * (a / 255.0) ** rng.uniform(0.7, 1.4)
    a = (a - 128.0) * rng.uniform(0.75, 1.15) + 128.0 + rng.uniform(-20, 20)
    a = a + rng.normal(0, rng.uniform(1, 7 * strength), a.shape)
    a = np.clip(a, 0, 255).astype(np.uint8)
    m = max(a.shape)
    if m > RAW_BUCKET:
        sc = RAW_BUCKET / m
        a = rs.pil_resize(a, (max(2, int(a.shape[1] * sc)), max(2, int(a.shape[0] * sc))),
                          "bilinear")
    return a


def pack_raw_batch(crops: Sequence[np.ndarray], input_size: int = 448):
    """Luma crops -> (raw (B, RB, RB) uint8, src (B, 2), tgt (B, 2)) for the
    on-device bicubic canvas (the engine's device-resized char route)."""
    B = len(crops)
    raw = np.full((B, RAW_BUCKET, RAW_BUCKET), 255, np.uint8)
    src = np.ones((B, 2), np.int32)
    tgt = np.ones((B, 2), np.int32)
    for i, c in enumerate(crops):
        h, w = c.shape[:2]
        raw[i, :h, :w] = c
        nw, nh = preprocess.char_content_dims(w, h, input_size)
        src[i] = (h, w)
        tgt[i] = (nh, nw)
    return raw, src, tgt


class BatchSampler:
    """Mixes augmented fixture views with procedural-glyph views."""

    def __init__(self, fixture, synth_classes, rng: np.random.RandomState,
                 p_fixture: float = 0.5, strength: float = 1.0):
        self.fixture = fixture            # [(crop, box, char, tid)]
        self.synth = synth_classes        # [(tid, char)]
        self._glyphs: Dict[str, np.ndarray] = {}
        self.rng = rng
        self.p_fixture = p_fixture
        self.strength = strength

    def _glyph(self, char: str) -> np.ndarray:
        g = self._glyphs.get(char)
        if g is None:
            g = glyph_for_char(char)
            self._glyphs[char] = g
        return g

    def sample(self, n: int):
        crops, labels = [], []
        rng = self.rng
        for _ in range(n):
            if self.fixture and rng.rand() < self.p_fixture:
                crop, box, _c, tid = self.fixture[rng.randint(len(self.fixture))]
                crops.append(augment_luma(crop, rng, box=box, strength=self.strength))
            else:
                tid, char = self.synth[rng.randint(len(self.synth))]
                crops.append(augment_luma(self._glyph(char), rng, strength=self.strength))
            labels.append(tid)
        raw, src, tgt = pack_raw_batch(crops)
        return raw, src, tgt, np.asarray(labels, np.int32)


# ---------------------------------------------------------------------------
# LoRA over the resampler and the char ViT
# ---------------------------------------------------------------------------


def _init_lora(generator: torch.Generator, base_layers: Tree, names, key, rank: int) -> Tree:
    out = {}
    for name in names:
        w = base_layers[key(name)]
        L, fin, fout = w.shape
        a = torch.randn((L, fin, rank), generator=generator, dtype=torch.float32, device=w.device)
        out[name + "_a"] = a * fin**-0.5
        out[name + "_b"] = torch.zeros((L, rank, fout), dtype=torch.float32, device=w.device)
    return out


def init_lora(generator: torch.Generator, base_layers: Tree, rank: int) -> Tree:
    """{name_a: (L, in, r) ~ N(0, in^-0.5), name_b: (L, r, out) zeros} over
    LORA_MATS: the delta starts at exactly 0, so step 0 is the base
    function."""
    return _init_lora(generator, base_layers, LORA_MATS, lambda n: n, rank)


def init_vit_lora(generator: torch.Generator, base_layers: Tree, rank: int) -> Tree:
    """LoRA over the char ViT's big matrices (internvit.VIT_LORA_MATS)."""
    return _init_lora(generator, base_layers, VIT_LORA_MATS, lambda n: f"{n}_kernel", rank)


VIT_SMALL_LAYER = ("norm1_scale", "norm1_bias", "norm2_scale", "norm2_bias", "ls1", "ls2")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.detach().float().clone()


def vit_small_leaves(vision: Tree) -> Tree:
    """The directly trained char-ViT leaves, float32: the patch / position /
    CLS embeddings, every norm and the per-layer layer scales."""
    return {
        "patch_embed": {k: _f32(v) for k, v in vision["patch_embed"].items()},
        "cls_token": _f32(vision["cls_token"]),
        "pos_embed": _f32(vision["pos_embed"]),
        "layers": {k: _f32(vision["layers"][k]) for k in VIT_SMALL_LAYER},
    }


def merge_vit_small(base: Tree, small: Tree, dtype) -> Tree:
    return {
        "patch_embed": {k: v.to(dtype) for k, v in small["patch_embed"].items()},
        "cls_token": small["cls_token"].to(dtype),
        "pos_embed": small["pos_embed"].to(dtype),
        "layers": {**base["layers"], **{k: v.to(dtype) for k, v in small["layers"].items()}},
    }


def _delta(lora: Tree, name: str) -> torch.Tensor:
    return torch.einsum("lir,lro->lio", lora[name + "_a"].float(), lora[name + "_b"].float())


def merge_full_vision(base: Tree, trained: Tree, dtype=torch.bfloat16,
                      lora_scale: float = 1.0) -> Tree:
    """The merged char ViT (the engine's ``char_vision``)."""
    merged = merge_vit_small(base, trained["vit_small"], dtype)
    merged["layers"] = dict(merged["layers"])
    for name in VIT_LORA_MATS:
        w = base["layers"][f"{name}_kernel"].float()
        d = _delta(trained["vit_lora"], name).to(w.device)
        merged["layers"][f"{name}_kernel"] = (w + lora_scale * d).to(dtype)
    return merged


def small_leaves(params: Tree) -> Tree:
    """The directly trained (non-LoRA) resampler leaves, float32."""
    return {
        "learns": _f32(params["learns"]),
        "layers": {k: _f32(v) for k, v in params["layers"].items() if k not in LORA_MATS},
        "norm_scale": _f32(params["norm_scale"]),
        "norm_bias": _f32(params["norm_bias"]),
    }


def merge_small(base: Tree, small: Tree, dtype) -> Tree:
    return {
        "learns": small["learns"].to(dtype),
        "layers": {**base["layers"], **{k: v.to(dtype) for k, v in small["layers"].items()}},
        "norm_scale": small["norm_scale"].to(dtype),
        "norm_bias": small["norm_bias"].to(dtype),
    }


def merge_full(base: Tree, trained: Tree, dtype=torch.bfloat16, lora_scale: float = 1.0) -> Tree:
    """The merged resampler: base + LoRA deltas + trained small leaves, what
    the engine runs."""
    merged = merge_small(base, trained["small"], dtype)
    merged["layers"] = dict(merged["layers"])
    for name in LORA_MATS:
        w = base["layers"][name].float()
        d = _delta(trained["lora"], name).to(w.device)
        merged["layers"][name] = (w + lora_scale * d).to(dtype)
    return merged


# ---------------------------------------------------------------------------
# assets: v2 (LoRA + small leaves) and v3 (the compact stack)
# ---------------------------------------------------------------------------

ASSET_VERSION = 2


def _np(t, dtype) -> np.ndarray:
    return np.asarray(t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else t,
                      dtype)


def save_asset(path, trained: Tree, meta: Dict) -> None:
    """v2 asset: the LoRA factors in fp16, the small leaves in fp32 (the
    JAX package's keys, so either package reads the other's file)."""
    flat = {"meta": json.dumps({"version": ASSET_VERSION, **meta})}
    for name, v in trained["lora"].items():
        flat["lora/" + name] = _np(v, np.float16)
    s = trained["small"]
    for k in ("learns", "norm_scale", "norm_bias"):
        flat["small/" + k] = _np(s[k], np.float32)
    for k, v in s["layers"].items():
        flat["small/layers/" + k] = _np(v, np.float32)
    if "vit_lora" in trained:
        for name, v in trained["vit_lora"].items():
            flat["vit_lora/" + name] = _np(v, np.float16)
        vs = trained["vit_small"]
        for k in ("kernel", "bias"):
            flat["vit_small/patch_embed/" + k] = _np(vs["patch_embed"][k], np.float32)
        flat["vit_small/cls_token"] = _np(vs["cls_token"], np.float32)
        flat["vit_small/pos_embed"] = _np(vs["pos_embed"], np.float32)
        for k, v in vs["layers"].items():
            flat["vit_small/layers/" + k] = _np(v, np.float32)
    np.savez_compressed(path, **flat)


def load_asset(path, device="cuda") -> Tuple[Tree, Dict]:
    """A v1 / v2 asset -> ({lora, small[, vit_lora, vit_small]} of tensors on
    ``device``: the LoRA factors as float32, the rest as stored), meta)."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))

    def t(k, f32=False):
        a = z[k].astype(np.float32) if f32 else z[k]
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    lora, layers, small = {}, {}, {}
    vit_lora, vit_layers, vit_small = {}, {}, {}
    for k in z.files:
        if k.startswith("lora/"):
            lora[k[5:]] = t(k, True)
        elif k.startswith("small/layers/"):
            layers[k[len("small/layers/"):]] = t(k)
        elif k.startswith("small/"):
            small[k[6:]] = t(k)
        elif k.startswith("vit_lora/"):
            vit_lora[k[len("vit_lora/"):]] = t(k, True)
        elif k.startswith("vit_small/layers/"):
            vit_layers[k[len("vit_small/layers/"):]] = t(k)
        elif k.startswith("vit_small/patch_embed/"):
            vit_small.setdefault("patch_embed", {})[k[len("vit_small/patch_embed/"):]] = t(k)
        elif k.startswith("vit_small/"):
            vit_small[k[len("vit_small/"):]] = t(k)
    small["layers"] = layers
    out = {"lora": lora, "small": small}
    if vit_lora:  # version >= 2: the asset carries the char-ViT delta too
        vit_small["layers"] = vit_layers
        out["vit_lora"] = vit_lora
        out["vit_small"] = vit_small
    return out, meta


def apply_asset(cfg: VLMConfig, path, dtype=torch.bfloat16, device="cuda") -> Tree:
    """A v1 / v2 asset -> {"resampler": merged, "char_vision": merged char
    ViT (v2 only)} over the seed-0 draws of ``device`` (the engine's random
    init there); runtime/weights.overlay_trained_assets applies it. v3
    assets go through apply_v3_asset."""
    trained, meta = load_asset(path, device)
    scale = meta.get("lora_scale", 1.0)
    base = base_resampler_params(cfg.resampler, dtype, device)
    out = {"resampler": merge_full(base, trained, dtype, lora_scale=scale)}
    if "vit_lora" in trained:
        out["char_vision"] = merge_full_vision(base_vision_params(cfg, dtype, device), trained,
                                               dtype, lora_scale=scale)
    return out


def save_v3_asset(path, stack: Tree, meta: Dict) -> None:
    """The whole compact stack in fp16 under ``v3/<path of the leaf>``
    (runtime/weights.load_v3_asset reads it)."""
    flat = {"meta": json.dumps({"version": 3, **meta})}
    for name, leaf in e_it.flatten(stack).items():
        flat["v3/" + name] = _np(leaf, np.float16)
    np.savez_compressed(path, **flat)


# ---------------------------------------------------------------------------
# training: the heads and the steps
# ---------------------------------------------------------------------------


def _ink_weights(canvas_luma: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, S, S) luma canvas -> (B, n_tok) ink mass of each projected token:
    a (2 patch)^2 pixel square (pixel shuffle 0.5), row-major, as
    extract_feature orders its tokens. White (255) is no ink."""
    B, S, _ = canvas_luma.shape
    blk = 2 * patch
    g = S // blk
    ink = (255.0 - canvas_luma.float()) / 255.0
    ink = ink.reshape(B, g, blk, g, blk).mean(dim=(2, 4))
    return ink.reshape(B, g * g)


def _normed(out: torch.Tensor) -> torch.Tensor:
    out = out.float()
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-12)


def _encode(frozen: Tree, cfg: VLMConfig, raw, src, tgt, canvas: int, policy: DTypePolicy,
            vit_trainable: Tree, return_ink: bool = False, remat: bool = True):
    """On-device bicubic canvas -> char ViT -> projector. The ViT runs the
    trained small leaves of ``vit_trainable`` ({vit_small, vit_lora}) and
    its functional LoRA through the plain attention, each layer under
    ``remat``. ``return_ink``: also the tokens' ink weights for the aux
    head."""
    x = bicubic_canvas(raw, src, tgt, canvas)          # (B, canvas, canvas)
    ink = _ink_weights(x, cfg.vision.patch_size) if return_ink else None
    x = x[..., None].expand(*x.shape, 3)
    vis = merge_vit_small(frozen["vision"], vit_trainable["vit_small"], policy.compute_dtype)
    hidden = internvit.forward(vis, cfg.vision, x, policy=policy, attn_impl="reference",
                               lora=vit_trainable["vit_lora"], remat=remat)
    feats = projector.extract_feature(frozen["projector"], hidden, cfg, policy=policy)
    return (feats, ink) if return_ink else feats


def _pseudo_normed(trainable: Tree, base_res: Tree, cfg: VLMConfig, feats,
                   policy: DTypePolicy) -> torch.Tensor:
    res = merge_small(base_res, trainable["small"], policy.compute_dtype)
    out = resampler.forward(res, cfg.resampler, feats, policy=policy, lora=trainable["lora"])
    return _normed(out)


def _heads(trainable: Tree, table_sub: torch.Tensor, out: torch.Tensor, feats: torch.Tensor,
           ink: torch.Tensor, cls_labels: torch.Tensor, aux_weight: float):
    """(1) InfoNCE of each pseudo token against the single-char sub-table,
    ``logit_scale`` capped at 100; (2) ``aux_weight`` x CE of a linear probe
    over the ink-weighted pooled features. -> (loss, (loss_vq, acc,
    aux_acc))."""
    labels = cls_labels.long()
    scale = torch.clamp(torch.exp(trainable["logit_scale"]), max=100.0)
    logits = torch.einsum("bne,ce->bnc", out, table_sub) * scale
    lab = labels[:, None].expand(logits.shape[:2])
    logp = torch.log_softmax(logits, dim=-1)
    loss_vq = -logp.gather(-1, lab[..., None]).mean()
    acc = (logits.argmax(-1) == lab).float().mean()

    # ink-weighted pooling: a uniform mean is ~75% white-margin tokens
    w = ink / ink.sum(dim=1, keepdim=True).clamp_min(1e-6)
    pooled = torch.einsum("bn,bne->be", w, feats.float())
    aux_logits = pooled @ trainable["aux"]["w"] + trainable["aux"]["b"]
    aux_logp = torch.log_softmax(aux_logits, dim=-1)
    loss_aux = -aux_logp.gather(-1, labels[:, None]).mean()
    aux_acc = (aux_logits.argmax(-1) == labels).float().mean()
    return loss_vq + aux_weight * loss_aux, (loss_vq, acc, aux_acc)


def _step(loss_fn, optimizer: e_it.Optimizer):
    """step(trainable, opt_state, *args) -> (trainable, opt_state, loss_vq,
    acc, aux_acc): the loss, the gradients of every trainable leaf, the
    update written into the leaves and the state."""

    def step(trainable, opt_state, *args):
        flat = e_it.flatten(trainable)
        for leaf in flat.values():
            leaf.requires_grad_(True)
        with exact_fp32():
            loss, (loss_vq, acc, aux_acc) = loss_fn(trainable, *args)
            grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True,
                                        materialize_grads=True)
        optimizer.update(dict(zip(flat, grads)), opt_state, flat)
        return trainable, opt_state, loss_vq.detach(), acc, aux_acc

    return step


def make_loss_fn(cfg: VLMConfig, canvas: int, policy: DTypePolicy, aux_weight: float = 1.0, remat: bool = True):
    """The v2 loss: loss_fn(trainable, frozen, base_res, batch) -> (loss,
    (loss_vq, acc, aux_acc)). On-device bicubic canvas -> LoRA'd char ViT
    -> frozen projector -> LoRA resampler -> the two heads. ``trainable``:
    {small, lora, vit_small, vit_lora, aux, logit_scale}; ``batch``: (raw,
    src, tgt, class labels) on the device."""

    def loss_fn(trainable, frozen, base_res, batch):
        raw, src, tgt, cls_labels = batch
        feats, ink = _encode(frozen, cfg, raw, src, tgt, canvas, policy, trainable,
                             return_ink=True, remat=remat)
        out = _pseudo_normed(trainable, base_res, cfg, feats, policy)
        return _heads(trainable, frozen["table_sub"], out, feats, ink, cls_labels, aux_weight)

    return loss_fn


def make_step_fn(cfg: VLMConfig, canvas: int, policy: DTypePolicy, optimizer: e_it.Optimizer,
                 aux_weight: float = 1.0, remat: bool = True):
    """One v2 train step at a fixed canvas: step(trainable, opt_state,
    frozen, base_res, batch) -> (trainable, opt_state, loss_vq, acc,
    aux_acc), the trainable tree updated in place (make_loss_fn's loss)."""
    return _step(make_loss_fn(cfg, canvas, policy, aux_weight, remat), optimizer)


def _vq_scores(out: torch.Tensor, table_n: torch.Tensor, labels: torch.Tensor):
    sims = torch.einsum("bne,ve->bnv", out, table_n)
    idx = sims.argmax(dim=-1)  # (B, n_learns)
    hit = idx == labels.long()[:, None]
    per_tok = hit.float().mean()
    per_char = (hit.sum(dim=1) * 2 > idx.shape[1]).float().mean()
    return per_tok, per_char, idx


def make_eval_fn(cfg: VLMConfig, canvas: int, policy: DTypePolicy):
    """eval_fn(trainable, frozen, base_res, raw, src, tgt, labels) ->
    (per-token VQ top-1 over the full table, per-char majority, ids)."""

    @torch.no_grad()
    def eval_fn(trainable, frozen, base_res, raw, src, tgt, labels):
        with exact_fp32():
            feats = _encode(frozen, cfg, raw, src, tgt, canvas, policy, trainable)
            out = _pseudo_normed(trainable, base_res, cfg, feats, policy)
            return _vq_scores(out, frozen["table_n"], labels)

    return eval_fn


def _table_n(cfg: VLMConfig, dtype, device, class_token_ids) -> Tree:
    t = align_table(cfg.llm.vocab_size, cfg.llm.hidden_size, dtype, device).float()
    t = _normed(t)
    out = {"table_n": t}
    if class_token_ids is not None:
        out["table_sub"] = t[torch.as_tensor(np.asarray(class_token_ids), device=t.device).long()]
    return out


def build_frozen(cfg: VLMConfig, dtype=torch.bfloat16,
                 class_token_ids: Optional[Sequence[int]] = None, device="cuda") -> Tree:
    """The frozen towers and the normalised VQ table, all the engine's
    seed-0 draws (the LLM is never drawn). ``class_token_ids``: the
    single-char label space; adds ``table_sub`` (n_cls, E), the training
    softmax's support."""
    return {"vision": base_vision_params(cfg, dtype, device),
            "projector": weights.draw_projector(cfg, 0, dtype=dtype, device=device),
            **_table_n(cfg, dtype, device, class_token_ids)}


def init_aux_head(generator: torch.Generator, cfg: VLMConfig, n_classes: int, dim: int = 0,
                  device="cuda") -> Tree:
    """Training-only linear probe over the pooled ViT + projector features.
    ``dim``: the feature width (v3: cfg.resampler.dim, the char projector's
    output); 0 = the v2 LLM-width features."""
    E = dim or cfg.llm.hidden_size
    w = torch.randn((E, n_classes), generator=generator, dtype=torch.float32, device=device)
    return {"w": w * E**-0.5, "b": torch.zeros((n_classes,), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# v3: the compact char tower, trained from scratch
# ---------------------------------------------------------------------------


def init_v3_params(generator: torch.Generator, cfg: VLMConfig, *, white_center: bool = True,
                   dtype=torch.float32, device="cuda") -> Tree:
    """From-scratch {char_vision, char_projector, resampler} at
    cfg.char_vision / cfg.resampler, drawn in that order from
    ``generator``. ``white_center``: the patch-embed bias set so that the
    all-white patch embeds to exactly 0 (the white canvas margin then adds
    nothing and ink is the signal from step 0)."""
    r = weights._Init(generator, device, dtype)
    vis = weights.init_vision(r, cfg.char_vision)
    if white_center:
        P = cfg.char_vision.patch_size
        white = ((1.0 - np.asarray(internvit.IMAGENET_MEAN)) / np.asarray(internvit.IMAGENET_STD))
        wvec = torch.as_tensor(np.repeat(white, P * P), dtype=dtype, device=device)
        vis["patch_embed"]["bias"] = -(wvec @ vis["patch_embed"]["kernel"])
    proj = weights.init_projector(r, cfg, vit_hidden=cfg.char_vision.hidden_size,
                                  out_dim=cfg.resampler.dim)
    res = weights.init_resampler(r, cfg.resampler)
    return {"char_vision": vis, "char_projector": proj, "resampler": res}


def v3_forward(stack: Tree, cfg: VLMConfig, raw, src, tgt, policy: DTypePolicy, *,
               return_ink: bool = False):
    """Raw luma crops -> on-device bicubic canvas -> compact ViT (plain
    attention) -> char projector -> resampler -> L2-normalised (B, 3, out)
    pseudo tokens: the engine's char route on the compact tower
    (runtime/engine._char_pipeline_raw), which attends through the kernel."""
    canvas = cfg.char_vision.image_size
    x = bicubic_canvas(raw, src, tgt, canvas)            # (B, S, S) luma
    ink = _ink_weights(x, cfg.char_vision.patch_size) if return_ink else None
    x = x[..., None].expand(*x.shape, 3)
    hidden = internvit.forward(stack["char_vision"], cfg.char_vision, x, policy=policy,
                               attn_impl="reference")
    feats = projector.extract_feature(stack["char_projector"], hidden, cfg, policy=policy)
    out = _normed(resampler.forward(stack["resampler"], cfg.resampler, feats, policy=policy))
    return (out, feats, ink) if return_ink else out


def make_v3_loss_fn(cfg: VLMConfig, policy: DTypePolicy, aux_weight: float = 0.5):
    """The v3 loss: loss_fn(trainable, frozen, batch) -> (loss, (loss_vq,
    acc, aux_acc)); ``trainable``: {stack, aux, logit_scale}. The heads of
    make_loss_fn over v3_forward."""

    def loss_fn(trainable, frozen, batch):
        raw, src, tgt, cls_labels = batch
        out, feats, ink = v3_forward(trainable["stack"], cfg, raw, src, tgt, policy,
                                     return_ink=True)
        return _heads(trainable, frozen["table_sub"], out, feats, ink, cls_labels, aux_weight)

    return loss_fn


def make_v3_step_fn(cfg: VLMConfig, policy: DTypePolicy, optimizer: e_it.Optimizer,
                    aux_weight: float = 0.5):
    """One from-scratch step: step(trainable, opt_state, frozen, batch) ->
    (trainable, opt_state, loss_vq, acc, aux_acc), in place."""
    return _step(make_v3_loss_fn(cfg, policy, aux_weight), optimizer)


def make_v3_eval_fn(cfg: VLMConfig, policy: DTypePolicy):
    """eval_fn(stack, table_n, raw, src, tgt, labels) -> (per-token VQ top-1
    over the full table, per-char majority, ids)."""

    @torch.no_grad()
    def eval_fn(stack, table_n, raw, src, tgt, labels):
        with exact_fp32():
            return _vq_scores(v3_forward(stack, cfg, raw, src, tgt, policy), table_n, labels)

    return eval_fn


def build_v3_frozen(cfg: VLMConfig, class_token_ids: Optional[Sequence[int]] = None,
                    device="cuda") -> Tree:
    """The v3 targets: the normalised seed-0 VQ table in float32 (and the
    single-char sub-table); the compact recipe has no frozen tower."""
    return _table_n(cfg, torch.float32, device, class_token_ids)


def v3_optimizer(lr: float, steps: int, warmup: int, weight_decay: float) -> e_it.Optimizer:
    """The v3 recipe's optimizer: clip by global norm 1.0, then AdamW under
    optax.warmup_cosine_decay_schedule(0, lr, warmup, max(steps, warmup +
    1), lr * 0.05)."""
    sched = e_it.warmup_cosine_schedule(lr, warmup, max(steps, warmup + 1), end_value=lr * 0.05)
    return e_it.Optimizer(sched, weight_decay=weight_decay, grad_clip=1.0)
