"""Parameters of the port: the reference checkpoint's loaders and
converters, conversion from the JAX tree, seeded random init, and the
committed trained assets.

The port keeps the JAX package's parameter tree (same keys, layers stacked
on axis 0, kernels (in, out), detector convolutions HWIO), so
``from_jax_params`` is a leaf-wise numpy -> torch move. ``init_params``
draws every component at full width, each from its own generators derived
from the seed and the component's slot (``draw_key``; the numbers differ from
jax.random's, a torch seed is its own reference). The
loaders read the npz assets under callireader_tpu/assets by path.

The deployed reference checkpoint (InternVL/model.safetensors.index.json)
holds
  language_model.model.layers.N.attention.{wqkv,wo}.weight   (fused GQA qkv)
  language_model.model.layers.N.feed_forward.{w1,w2,w3}.weight
  language_model.model.{norm,tok_embeddings}.weight, language_model.output.weight
  vision_model.embeddings.*, vision_model.encoder.layers.N.*
  mlp1.{0,1,3}.*          (LayerNorm, Linear, GELU, Linear)
  resampler.*             (perceiver layers, learns, final norm)
  normed_emb.weight       (normalized token-embedding VQ table)
beside the torch side files gauss_norm_mu_sigma.pth ({'weight': (V, 2)}),
orderformer.pth (a TransformerEncoder state dict) and best.pt (ultralytics
YOLOv8). ``convert_reference_checkpoint`` maps it onto the tree as the JAX
package's runtime/weights.py does, leaf for leaf. The shards are memory
mapped (runtime/safetensors_io.py) and each tensor goes to the device in its
stored dtype, where it is transposed, stacked and cast: the host never holds
more than the page cache of the files, and a BF16 file is never widened on
the host. The fused-wqkv rows are laid out per kv head as
[G query heads | k | v] x head_dim (modeling_internlm2.py:364-373).
"""

from __future__ import annotations

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
import os
import zipfile
from pathlib import Path
from typing import Any, Collection, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from callireader_tpu_torch.core.config import (
    DetectorConfig, LLMConfig, MLAMoEConfig, OrderFormerConfig, ResamplerConfig, VisionConfig,
    VLMConfig,
)
from callireader_tpu_torch.models import detector as detector_mod
from callireader_tpu_torch.models import orderformer as orderformer_mod
from callireader_tpu_torch.runtime import detector_weights, quantize, safetensors_io

ASSETS_DIR = Path(__file__).resolve().parents[2] / "callireader_tpu" / "assets"

# ------------------------------------------------------------ JAX -> torch


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def from_jax_params(tree, *, device):
    """JAX param pytree (dicts/lists of arrays) -> the same tree of torch
    tensors on ``device``, dtypes kept (int8 weights and their fp32 scales
    cross unchanged)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device=device) for v in tree]
    return _to_tensor(tree, device)


# ------------------------------------------------------------ reference checkpoints


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a directory's shards (those its index names, else
    every ``*.safetensors``), memory mapped in their stored dtype. A tensor
    the index names that no shard holds raises."""
    out: Dict[str, torch.Tensor] = {}
    for shard in safetensors_io.shard_files(path):
        out.update(safetensors_io.load_file(os.path.join(path, shard)))
    index = os.path.join(path, safetensors_io.INDEX_FILE)
    if os.path.exists(index):
        with open(index) as f:
            missing = sorted(set(json.load(f)["weight_map"]) - set(out))
        if missing:
            raise KeyError(f"{path}: the index names tensors no shard holds: {missing[:5]}")
    return out


def load_torch_pth(path: str) -> Dict[str, torch.Tensor]:
    """A torch side file's tensors (a ``model_state_dict`` or ``state_dict``
    entry unwrapped, ``module.`` prefixes stripped, other values dropped),
    on the CPU in their stored dtype; zip files are memory mapped."""
    obj = torch.load(path, map_location="cpu", weights_only=False, mmap=zipfile.is_zipfile(path))
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if isinstance(obj, dict) and "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    out = {}
    for k, v in obj.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if isinstance(v, torch.Tensor):
            out[k] = v.detach()
    return out


def _put(t: torch.Tensor, dtype, device) -> torch.Tensor:
    """``t`` (a view of a mapped tensor) to the device in its stored dtype,
    then cast and laid out row-major there."""
    return t.to(device).to(dtype).contiguous()


def _T(t: torch.Tensor) -> torch.Tensor:
    return t.T


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _stack(sd, pattern: str, num: int, *, dtype, device, fn=_same) -> torch.Tensor:
    """(num, ...) on the device: ``fn(sd[pattern.format(i)])`` for each i,
    moved one at a time and cast into its slot."""
    first = fn(sd[pattern.format(0)])
    out = torch.empty((num, *first.shape), dtype=dtype, device=device)
    for i in range(num):
        out[i].copy_(fn(sd[pattern.format(i)]).to(device))
    return out


def split_wqkv(wqkv: torch.Tensor, cfg: LLMConfig):
    """(out=(Hq+2Hkv)*D, E) torch layout -> wq (E, Hq*D), wk, wv (E, Hkv*D)."""
    Hkv, G, D = cfg.num_key_value_heads, cfg.num_query_groups, cfg.head_dim
    E = wqkv.shape[1]
    w = wqkv.reshape(Hkv, G + 2, D, E)
    wq = w[:, :G].reshape(Hkv * G * D, E).T
    wk = w[:, G].reshape(Hkv * D, E).T
    wv = w[:, G + 1].reshape(Hkv * D, E).T
    return wq, wk, wv


def fuse_wqkv(wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor, cfg: LLMConfig) -> torch.Tensor:
    """Inverse of split_wqkv (for exporting back to the reference format)."""
    Hkv, G, D = cfg.num_key_value_heads, cfg.num_query_groups, cfg.head_dim
    E = wq.shape[0]
    q = wq.T.reshape(Hkv, G, D, E)
    k = wk.T.reshape(Hkv, 1, D, E)
    v = wv.T.reshape(Hkv, 1, D, E)
    return torch.cat([q, k, v], dim=1).reshape(-1, E)


def convert_llm(sd, cfg: LLMConfig, prefix: str = "language_model.", *, dtype=torch.float32,
                device="cuda") -> Dict[str, Any]:
    L, p = cfg.num_hidden_layers, prefix
    E, D = cfg.hidden_size, cfg.head_dim
    qkv = {name: torch.empty((L, E, h * D), dtype=dtype, device=device) for name, h in
           (("wq", cfg.num_attention_heads), ("wk", cfg.num_key_value_heads),
            ("wv", cfg.num_key_value_heads))}
    for i in range(L):
        parts = split_wqkv(sd[f"{p}model.layers.{i}.attention.wqkv.weight"].to(device), cfg)
        for out, part in zip(qkv.values(), parts):
            out[i].copy_(part)
    put = dict(dtype=dtype, device=device)
    layer = p + "model.layers.{}."
    return {
        "tok_embeddings": _put(sd[f"{p}model.tok_embeddings.weight"], **put),
        "layers": {
            "attn_norm": _stack(sd, layer + "attention_norm.weight", L, **put),
            "ffn_norm": _stack(sd, layer + "ffn_norm.weight", L, **put),
            **qkv,
            "wo": _stack(sd, layer + "attention.wo.weight", L, fn=_T, **put),
            "w1": _stack(sd, layer + "feed_forward.w1.weight", L, fn=_T, **put),
            "w3": _stack(sd, layer + "feed_forward.w3.weight", L, fn=_T, **put),
            "w2": _stack(sd, layer + "feed_forward.w2.weight", L, fn=_T, **put),
        },
        "norm": _put(sd[f"{p}model.norm.weight"], **put),
        "output": _put(sd[f"{p}output.weight"], **put),
    }


def _stack_layers(sd, pre: str, table, num: int, **put) -> Dict[str, torch.Tensor]:
    """Every leaf of ``table`` (leaf -> (key under ``pre`` + "{layer}.",
    transposed)) stacked over ``num`` layers."""
    return {ours: _stack(sd, pre + "{}." + theirs, num, fn=_T if transposed else _same, **put)
            for ours, (theirs, transposed) in table.items()}


def convert_vit(sd, cfg: VisionConfig, prefix: str = "vision_model.", *, dtype=torch.float32,
                device="cuda") -> Dict[str, Any]:
    p, put = prefix, dict(dtype=dtype, device=device)
    conv_w = sd[f"{p}embeddings.patch_embedding.weight"]  # (E, C, P, P)
    return {
        "patch_embed": {
            "kernel": _put(conv_w.reshape(conv_w.shape[0], -1).T, **put),  # (C*P*P, E)
            "bias": _put(sd[f"{p}embeddings.patch_embedding.bias"], **put),
        },
        "cls_token": _put(sd[f"{p}embeddings.class_embedding"], **put),
        "pos_embed": _put(sd[f"{p}embeddings.position_embedding"], **put),
        "layers": _stack_layers(sd, p + "encoder.layers.", VIT_LAYER, cfg.num_hidden_layers,
                                **put),
    }


def convert_projector(sd, prefix: str = "mlp1.", *, dtype=torch.float32,
                      device="cuda") -> Dict[str, Any]:
    p, put = prefix, dict(dtype=dtype, device=device)
    return {
        "ln_scale": _put(sd[f"{p}0.weight"], **put),
        "ln_bias": _put(sd[f"{p}0.bias"], **put),
        "fc1_kernel": _put(sd[f"{p}1.weight"].T, **put),
        "fc1_bias": _put(sd[f"{p}1.bias"], **put),
        "fc2_kernel": _put(sd[f"{p}3.weight"].T, **put),
        "fc2_bias": _put(sd[f"{p}3.bias"], **put),
    }


# a stacked leaf -> (its key in one layer of the reference's module,
# transposed), in the order the export writes a layer (train/checkpoint.py:
# the order decides where the shards split, as in the JAX exporter)
VIT_LAYER = {
    "norm1_scale": ("norm1.weight", False), "norm1_bias": ("norm1.bias", False),
    "norm2_scale": ("norm2.weight", False), "norm2_bias": ("norm2.bias", False),
    "qkv_bias": ("attn.qkv.bias", False), "proj_bias": ("attn.proj.bias", False),
    "fc1_bias": ("mlp.fc1.bias", False), "fc2_bias": ("mlp.fc2.bias", False),
    "ls1": ("ls1", False), "ls2": ("ls2", False),
    "qkv_kernel": ("attn.qkv.weight", True), "proj_kernel": ("attn.proj.weight", True),
    "fc1_kernel": ("mlp.fc1.weight", True), "fc2_kernel": ("mlp.fc2.weight", True),
}
RESAMPLER_LAYER = {
    "norm_media_scale": ("0.norm_media.weight", False),
    "norm_media_bias": ("0.norm_media.bias", False),
    "norm_learns_scale": ("0.norm_learns.weight", False),
    "norm_learns_bias": ("0.norm_learns.bias", False),
    "ff_norm_scale": ("1.net.0.weight", False), "ff_norm_bias": ("1.net.0.bias", False),
    "ff1_bias": ("1.net.1.bias", False), "ff2_bias": ("1.net.3.bias", False),
    "to_q": ("0.to_q.weight", True), "to_kv": ("0.to_kv.weight", True),
    "to_out": ("0.to_out.weight", True), "ff1": ("1.net.1.weight", True),
    "ff2": ("1.net.3.weight", True),
}
ORDERFORMER_LAYER = {
    "in_proj_kernel": ("self_attn.in_proj_weight", True),
    "in_proj_bias": ("self_attn.in_proj_bias", False),
    "out_proj_kernel": ("self_attn.out_proj.weight", True),
    "out_proj_bias": ("self_attn.out_proj.bias", False),
    "norm1_scale": ("norm1.weight", False), "norm1_bias": ("norm1.bias", False),
    "norm2_scale": ("norm2.weight", False), "norm2_bias": ("norm2.bias", False),
    "ff1_kernel": ("linear1.weight", True), "ff1_bias": ("linear1.bias", False),
    "ff2_kernel": ("linear2.weight", True), "ff2_bias": ("linear2.bias", False),
}


def convert_resampler(sd, cfg: ResamplerConfig, prefix: str = "resampler.", *,
                      dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    p, put = prefix, dict(dtype=dtype, device=device)
    return {
        "learns": _put(sd[f"{p}learns"], **put),
        "layers": _stack_layers(sd, p + "layers.", RESAMPLER_LAYER, cfg.depth, **put),
        "norm_scale": _put(sd[f"{p}norm.weight"], **put),
        "norm_bias": _put(sd[f"{p}norm.bias"], **put),
    }


def convert_orderformer(sd, num_layers: int, *, dtype=torch.float32,
                        device="cuda") -> Dict[str, Any]:
    put = dict(dtype=dtype, device=device)
    return {
        "embed_kernel": _put(sd["embedding.weight"].T, **put),
        "embed_bias": _put(sd["embedding.bias"], **put),
        "layers": _stack_layers(sd, "transformer_encoder.layers.", ORDERFORMER_LAYER,
                                num_layers, **put),
        "decode_kernel": _put(sd["decoder.weight"].T, **put),
        "decode_bias": _put(sd["decoder.bias"], **put),
    }


def discover_side_files(internvl_dir: str) -> Dict[str, str]:
    """The reference's torch side files next to a checkpoint directory
    (config/configu.py:7-13,61-62 keeps them under ./params): checks
    ``<dir>/params/<name>`` then ``<dir>/<name>``."""
    names = {"mu_sigma": "gauss_norm_mu_sigma.pth", "orderformer": "orderformer.pth",
             "detector": "best.pt"}
    out: Dict[str, str] = {}
    for key, fname in names.items():
        for cand in (os.path.join(internvl_dir, "params", fname),
                     os.path.join(internvl_dir, fname)):
            if os.path.exists(cand):
                out[key] = cand
                break
    return out


def tree_to(tree, dtype, device):
    """A tree of numpy arrays or tensors -> tensors on ``device`` in ``dtype``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, dtype, device) for v in tree]
    t = torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree
    return _put(t, dtype, device)


def convert_reference_checkpoint(
    internvl_dir: str,
    cfg: VLMConfig,
    *,
    mu_sigma_path: Optional[str] = None,
    orderformer_path: Optional[str] = None,
    detector_path: Optional[str] = None,
    dtype=torch.float32,
    device="cuda",
) -> Dict[str, Any]:
    """The engine tree from a deployed reference checkpoint, on ``device``
    in ``dtype``; the detector and OrderFormer stay fp32 (casting those small
    host-side priors to bf16 would shift box and order decisions). Side files
    not passed are discovered under ``<dir>/params/`` or ``<dir>/``; a
    component with no tensors in the checkpoint is left out of the tree."""
    side = discover_side_files(internvl_dir)
    mu_sigma_path = mu_sigma_path or side.get("mu_sigma")
    orderformer_path = orderformer_path or side.get("orderformer")
    detector_path = detector_path or side.get("detector")
    sd = load_safetensors_dir(internvl_dir)
    put = dict(dtype=dtype, device=device)
    params: Dict[str, Any] = {
        "llm": convert_llm(sd, cfg.llm, **put),
        "vision": convert_vit(sd, cfg.vision, **put),
        "projector": convert_projector(sd, **put),
    }
    if "resampler.learns" in sd:
        params["resampler"] = convert_resampler(sd, cfg.resampler, **put)
    if "normed_emb.weight" in sd:
        params.setdefault("align", {})["normed_emb"] = _put(sd["normed_emb.weight"], **put)
    if mu_sigma_path:
        ms = load_torch_pth(mu_sigma_path)["weight"]  # (V, 2)
        params.setdefault("align", {})["mu"] = _put(ms[:, 0], **put)
        params["align"]["sigma"] = _put(ms[:, 1], **put)
    f32 = dict(dtype=torch.float32, device=device)
    if orderformer_path:
        params["orderformer"] = convert_orderformer(load_torch_pth(orderformer_path),
                                                    cfg.orderformer.num_layers, **f32)
    if detector_path:
        params["detector"] = tree_to(detector_weights.load_detector(detector_path), **f32)
    return params


# ------------------------------------------------------------ random init


class _Init:
    def __init__(self, generator: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = generator, device, dtype

    def normal(self, shape, std=1.0, dtype=None):
        x = torch.randn(shape, generator=self.g, dtype=torch.float32, device=self.device)
        return (x * std).to(dtype or self.dtype)

    def uniform(self, shape, bound, dtype=torch.float32):
        x = torch.rand(shape, generator=self.g, dtype=torch.float32, device=self.device)
        return ((2 * x - 1) * bound).to(dtype)

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or self.dtype, device=self.device)

    def ones(self, shape, dtype=None):
        return torch.ones(shape, dtype=dtype or self.dtype, device=self.device)


def init_llm(r: _Init, cfg: LLMConfig) -> Dict[str, Any]:
    L, E, M = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, D, V = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.vocab_size
    return {
        "tok_embeddings": r.normal((V, E), 0.02),
        "layers": {
            "attn_norm": r.ones((L, E)), "ffn_norm": r.ones((L, E)),
            "wq": r.normal((L, E, Hq * D), 0.02), "wk": r.normal((L, E, Hkv * D), 0.02),
            "wv": r.normal((L, E, Hkv * D), 0.02), "wo": r.normal((L, Hq * D, E), 0.02),
            "w1": r.normal((L, E, M), 0.02), "w3": r.normal((L, E, M), 0.02),
            "w2": r.normal((L, M, E), 0.02),
        },
        "norm": r.ones((E,)),
        "output": r.normal((V, E), 0.02),
    }


def init_vision(r: _Init, cfg: VisionConfig) -> Dict[str, Any]:
    L, E, M = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    P, C, s = cfg.patch_size, cfg.num_channels, cfg.initializer_range
    return {
        "patch_embed": {"kernel": r.normal((C * P * P, E), s), "bias": r.zeros((E,))},
        "cls_token": r.normal((1, 1, E), s),
        "pos_embed": r.normal((1, cfg.num_patches + 1, E), s),
        "layers": {
            "norm1_scale": r.ones((L, E)), "norm1_bias": r.zeros((L, E)),
            "norm2_scale": r.ones((L, E)), "norm2_bias": r.zeros((L, E)),
            "qkv_kernel": r.normal((L, E, 3 * E), s), "qkv_bias": r.zeros((L, 3 * E)),
            "proj_kernel": r.normal((L, E, E), s), "proj_bias": r.zeros((L, E)),
            "fc1_kernel": r.normal((L, E, M), s), "fc1_bias": r.zeros((L, M)),
            "fc2_kernel": r.normal((L, M, E), s), "fc2_bias": r.zeros((L, E)),
            "ls1": r.ones((L, E)), "ls2": r.ones((L, E)),
        },
    }


def init_projector(r: _Init, cfg: VLMConfig, vit_hidden: int = 0, out_dim: int = 0):
    vit_e = vit_hidden or cfg.vision.hidden_size
    llm_e = out_dim or cfg.llm.hidden_size
    in_dim = vit_e * int(1 / cfg.downsample_ratio) ** 2
    return {
        "ln_scale": r.ones((in_dim,)), "ln_bias": r.zeros((in_dim,)),
        "fc1_kernel": r.normal((in_dim, llm_e), 0.02), "fc1_bias": r.zeros((llm_e,)),
        "fc2_kernel": r.normal((llm_e, llm_e), 0.02), "fc2_bias": r.zeros((llm_e,)),
    }


def init_resampler(r: _Init, cfg: ResamplerConfig) -> Dict[str, Any]:
    E, L, inner, F = cfg.dim, cfg.depth, cfg.dim_head * cfg.heads, cfg.ff_mult * cfg.dim
    out = {} if cfg.out_dim is None else {
        "out_kernel": r.normal((E, cfg.out_dim), 0.02), "out_bias": r.zeros((cfg.out_dim,)),
    }
    return {
        **out,
        "learns": r.normal((cfg.num_learns, E)),
        "layers": {
            "norm_media_scale": r.ones((L, E)), "norm_media_bias": r.zeros((L, E)),
            "norm_learns_scale": r.ones((L, E)), "norm_learns_bias": r.zeros((L, E)),
            "to_q": r.normal((L, E, inner), 0.02), "to_kv": r.normal((L, E, 2 * inner), 0.02),
            "to_out": r.normal((L, inner, E), 0.02),
            "ff_norm_scale": r.ones((L, E)), "ff_norm_bias": r.zeros((L, E)),
            "ff1": r.normal((L, E, F), 0.02), "ff1_bias": r.zeros((L, F)),
            "ff2": r.normal((L, F, E), 0.02), "ff2_bias": r.zeros((L, E)),
        },
        "norm_scale": r.ones((E,)), "norm_bias": r.zeros((E,)),
    }


# each component's slot in the JAX init_all_params: its index in
# jax.random.split(key, 7), and the fold_in data of the compact char tower
COMPONENT_SLOTS = {"llm": 0, "vision": 1, "projector": 2, "resampler": 3, "orderformer": 4,
                   "detector": 5, "align": 6, "char_vision": 101, "char_projector": 102}
SLOT_SPAN = 256  # > every slot
LEAF_SPAN = 256  # > the leaves one component draws
BLOCK = 1 << 22  # elements one host generator draws
BLOCK_SPAN = 4096  # > the blocks of one leaf (leaves below 2^34 elements)
MAX_SEED = 2**64 // (SLOT_SPAN * LEAF_SPAN * BLOCK_SPAN)  # every key then fits in uint64


def draw_key(seed: int, name: str, leaf: int = 0, block: int = 0) -> int:
    """The generator seed of block ``block`` of leaf ``leaf`` of component
    ``name`` for engine seed ``seed``: the four numbers as digits of one
    integer, each below its span, so two draws never share a generator seed
    (the map is one to one for 0 <= seed < MAX_SEED). Leaf 0 block 0 seeds
    ``component_generator``; the host-drawn leaves count from 1."""
    if not 0 <= seed < MAX_SEED:
        raise ValueError(f"seed {seed} is outside [0, {MAX_SEED})")
    if not (0 <= leaf < LEAF_SPAN and 0 <= block < BLOCK_SPAN):
        raise ValueError(f"leaf {leaf} / block {block} outside {LEAF_SPAN} / {BLOCK_SPAN}")
    return ((seed * SLOT_SPAN + COMPONENT_SLOTS[name]) * LEAF_SPAN + leaf) * BLOCK_SPAN + block


def component_generator(seed: int, name: str, device) -> torch.Generator:
    """One generator for the whole of component ``name``, on ``device``."""
    return torch.Generator(device=device).manual_seed(draw_key(seed, name))


class _HostInit(_Init):
    """The draws of one component that do not depend on the device: torch's
    CPU (mt19937) and CUDA (Philox) generators give different streams, so
    each normal / uniform leaf is drawn on the host in float32, in blocks of
    BLOCK elements, block j of leaf i from a CPU generator seeded with
    ``draw_key(seed, name, i, j)``. Each block is scaled and cast on the
    host (IEEE float32 products, a round-to-nearest-even cast) and copied
    into the leaf on the device; the blocks run in threads, so one block's
    copy overlaps the others' draws."""

    def __init__(self, seed: int, name: str, device, dtype):
        super().__init__(None, device, dtype)
        self.seed, self.name, self.leaf = seed, name, 0

    def _host(self, shape, dtype, fill, finish) -> torch.Tensor:
        self.leaf += 1
        leaf, out = self.leaf, torch.empty(shape, dtype=dtype, device=self.device)
        flat = out.view(-1)

        def draw(j):
            blk = flat[j * BLOCK:(j + 1) * BLOCK]
            g = torch.Generator().manual_seed(draw_key(self.seed, self.name, leaf, j))
            x = fill(torch.empty(blk.numel(), dtype=torch.float32), g)
            blk.copy_(finish(x).to(dtype))

        n = -(-flat.numel() // BLOCK)
        with ThreadPoolExecutor(max(1, min(n, torch.get_num_threads()))) as pool:
            list(pool.map(draw, range(n)))
        return out

    def normal(self, shape, std=1.0, dtype=None):
        return self._host(shape, dtype or self.dtype, lambda x, g: x.normal_(generator=g),
                          lambda x: x * std)

    def uniform(self, shape, bound, dtype=torch.float32):
        return self._host(shape, dtype, lambda x, g: x.uniform_(generator=g),
                          lambda x: (2 * x - 1) * bound)


def draw_llm(cfg: LLMConfig, seed: int, *, dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """The engine's bf16 LLM drawn for ``seed``: on the device, by its own
    generator (``init_params``); an MLA-MoE config draws models/mla_moe.py's
    tree, in the published layout."""
    r = _Init(component_generator(seed, "llm", device), device, dtype)
    if isinstance(cfg, MLAMoEConfig):
        from callireader_tpu_torch.models import mla_moe

        return mla_moe.init_params(r, cfg)
    return init_llm(r, cfg)


def draw_vision(cfg: VisionConfig, seed: int, *, dtype=torch.bfloat16, device="cuda",
                name: str = "vision") -> Dict[str, Any]:
    """Component ``name`` (the tile tower, or ``char_vision``) of the
    engine drawn for ``seed``."""
    return init_vision(_HostInit(seed, name, device, dtype), cfg)


def draw_resampler(cfg: ResamplerConfig, seed: int, *, dtype=torch.bfloat16,
                   device="cuda") -> Dict[str, Any]:
    """The engine's resampler drawn for ``seed``."""
    return init_resampler(_HostInit(seed, "resampler", device, dtype), cfg)


def draw_projector(cfg: VLMConfig, seed: int, *, dtype=torch.bfloat16,
                   device="cuda") -> Dict[str, Any]:
    """The engine's tile-tower projector drawn for ``seed``."""
    return init_projector(_HostInit(seed, "projector", device, dtype), cfg)


def draw_align_table(vocab_size: int, hidden_size: int, seed: int, *, dtype=torch.bfloat16,
                     device="cuda") -> torch.Tensor:
    """The engine's ``align.normed_emb`` (vocab_size, hidden_size) drawn for
    ``seed``: N(0, 1) in float32, cast."""
    return _HostInit(seed, "align", device, dtype).normal((vocab_size, hidden_size))


def init_params(cfg: VLMConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda", *, llm_int8: bool = False) -> Dict[str, Any]:
    """Seeded full-width random init of the whole engine tree (the JAX
    engine's ``init_all_params`` layout). Each component draws from its own
    generators (``draw_key``), so no other component's depth, width or dtype
    moves it, as in the JAX package, whose components each take their own
    key. Every component but the LLM is drawn on the host (``_HostInit``;
    the OrderFormer and detector, fp32, by one CPU generator each) and is
    the same on every device. The LLM is drawn on the device by
    ``component_generator(seed, "llm", device)``, so its numbers differ
    between the CPU and the card (an 8B drawn on the host would take
    minutes): no trained asset reads it, and a ``cli.train --random-init``
    adapter merges onto its own base only on the kind of device that
    trained it.
    ``llm_int8``: the LLM is drawn directly as int8 + scales in the fused
    layout (runtime/quantize.init_llm_int8), never as a bf16 tree."""
    if llm_int8 and isinstance(cfg.llm, MLAMoEConfig):
        raise ValueError("the MLA-MoE LLM is drawn in bf16 only")
    llm = (quantize.init_llm_int8(cfg.llm, component_generator(seed, "llm", device), dtype=dtype,
                                  device=device) if llm_int8
           else draw_llm(cfg.llm, seed, dtype=dtype, device=device))
    V = cfg.llm.vocab_size
    host = lambda name: component_generator(seed, name, "cpu")  # noqa: E731
    out = {
        "llm": llm,
        "vision": draw_vision(cfg.vision, seed, dtype=dtype, device=device),
        "projector": draw_projector(cfg, seed, dtype=dtype, device=device),
        "resampler": draw_resampler(cfg.resampler, seed, dtype=dtype, device=device),
        "orderformer": tree_to(orderformer_mod.init_params(cfg.orderformer, host("orderformer"),
                                                           device="cpu"), None, device),
        "detector": tree_to(detector_mod.init_params(cfg.detector, host("detector"),
                                                     device="cpu"), None, device),
        "align": {
            "normed_emb": draw_align_table(V, cfg.llm.hidden_size, seed, dtype=dtype,
                                           device=device),
            "mu": torch.zeros((V,), dtype=torch.float32, device=device),
            "sigma": torch.ones((V,), dtype=torch.float32, device=device),
        },
    }
    if cfg.char_vision is not None:
        out["char_vision"] = draw_vision(cfg.char_vision, seed, dtype=dtype, device=device,
                                         name="char_vision")
        out["char_projector"] = init_projector(
            _HostInit(seed, "char_projector", device, dtype), cfg,
            vit_hidden=cfg.char_vision.hidden_size, out_dim=cfg.resampler.dim)
    return out


# ------------------------------------------------------------ trained assets

CHAR_VISION_V3 = VisionConfig(
    hidden_size=256, intermediate_size=1024, num_hidden_layers=6,
    num_attention_heads=8, image_size=224, patch_size=14,
)
CHAR_RESAMPLER_V3 = ResamplerConfig(
    dim=512, depth=3, dim_head=64, heads=8, num_learns=3, ff_mult=2, out_dim=4096,
)


def asset_version(path) -> int:
    z = np.load(path, allow_pickle=False)
    return json.loads(str(z["meta"])).get("version", 1)


def v3_configs(meta: Dict) -> Tuple[VisionConfig, ResamplerConfig]:
    """The compact tower's architecture from the asset meta (shipping
    defaults where the meta is silent)."""
    return (dataclasses.replace(CHAR_VISION_V3, **meta.get("char_vision", {})),
            dataclasses.replace(CHAR_RESAMPLER_V3, **meta.get("char_resampler", {})))


def load_v3_asset(path, dtype, device) -> Tuple[Dict, Dict]:
    """callialign.npz v3 -> ({char_vision, char_projector, resampler}, meta)."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    stack: Dict = {}
    for k in z.files:
        if not k.startswith("v3/"):
            continue
        node = stack
        parts = k[3:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(z[k].astype(np.float32)).to(device, dtype)
    return stack, meta


def apply_v3_asset(cfg: VLMConfig, path, dtype, device):
    """-> (stack params, cfg with the asset's compact char_vision and
    resampler, meta)."""
    stack, meta = load_v3_asset(path, dtype, device)
    vcfg, rcfg = v3_configs(meta)
    return stack, dataclasses.replace(cfg, char_vision=vcfg, resampler=rcfg), meta


TRAINED_ASSETS = ("detector", "orderformer", "callialign")
# the component each asset replaces: the CalliAlign tower was trained against
# the seed-0 resampler, ViT and align table, so it goes only where the
# resampler was drawn at random
ASSET_REPLACES = {"detector": "detector", "orderformer": "orderformer", "callialign": "resampler"}
# the components a random init may have replaced (JAX cli/common.build_engine)
RANDOM_COMPONENTS = ("detector", "orderformer", "resampler")


def overlay_trained_assets(params: Dict, cfg: VLMConfig, *, dtype, device,
                           names: Sequence[str] = TRAINED_ASSETS,
                           replaceable: Optional[Collection[str]] = None,
                           ) -> Tuple[VLMConfig, List[str]]:
    """The committed detector, OrderFormer and CalliAlign asset (those of them
    in ``names``) over the components drawn at random, where the preset's
    architecture matches them (the JAX cli/common._overlay_trained_assets
    rule). A v3 CalliAlign asset brings the compact tower and its
    architecture; a v1 / v2 asset is merged over the seed-0 resampler (v2:
    and the seed-0 tile ViT, as ``char_vision``). ``replaceable``: the
    components drawn at random (None: every one an asset replaces); a
    component loaded from a checkpoint is never replaced. Returns (cfg,
    loaded names)."""
    if replaceable is not None:
        names = [n for n in names if ASSET_REPLACES[n] in replaceable]
    loaded = []
    det_d, of_d = DetectorConfig(), OrderFormerConfig()
    if "detector" in names and all(
            getattr(cfg.detector, f) == getattr(det_d, f) for f in
            ("num_classes", "depth_mult", "width_mult", "max_channels", "reg_max", "img_size")):
        path = ASSETS_DIR / "detector_640.npz"
        if path.exists():
            params["detector"] = detector_mod.load_npz(str(path), device)
            loaded.append("detector")
    if "orderformer" in names and all(
            getattr(cfg.orderformer, f) == getattr(of_d, f) for f in
            ("input_dim", "model_dim", "num_heads", "num_layers", "output_dim", "ff_dim")):
        path = ASSETS_DIR / "orderformer.npz"
        if path.exists():
            params["orderformer"] = detector_mod.load_npz(str(path), device)
            loaded.append("orderformer")
    ca = ASSETS_DIR / "callialign.npz"
    if ("callialign" in names and cfg.resampler == ResamplerConfig() and cfg.char_vision is None
            and cfg.llm.hidden_size == 4096 and ca.exists()):
        if asset_version(ca) >= 3:  # the compact tower: its params and its architecture
            stack, cfg, _meta = apply_v3_asset(cfg, ca, dtype, device)
            params.update(stack)
        else:  # v1 / v2: deltas over the seed-0 resampler (and tile ViT, as char_vision)
            from callireader_tpu_torch.train import callialign_train

            params.update(callialign_train.apply_asset(cfg, ca, dtype, device))
        loaded.append("callialign")
    return cfg, loaded
