"""Train-state and parameter checkpoints, and the export back to the
reference's deployable layout (PyTorch port of
callireader_tpu/train/checkpoint.py).

The JAX package writes orbax checkpoints, which cannot be read without JAX;
the port writes its own format: ``<path>/state.pt`` (``torch.save`` of the
flattened {"trainable/...", "opt_state/...": tensor} tree plus the integer
counters) beside the same ``metadata.json``. A restore copies into the
template's tensors, so the leaves keep their device, dtype and
``requires_grad``.

The export half writes what the JAX package writes, file for file and
tensor for tensor: ``export_reference_format`` (the reference's
convert_to_official.py:15-38, LoRA merged) a model.safetensors set with the
reference's key names (fused wqkv etc.) in fp32, sharded by size with its
index; ``export_full_reference_checkpoint`` adds every torch side file of
config/configu.py:7-13,61-62 under ``params/``; and
``consolidate_safetensors_dtype`` casts and reshards such a set. The
``*_to_reference_sd`` converters return each tensor in its leaf's dtype on
its leaf's device (transposes are views); the writer casts one tensor at a
time to fp32 on its way to the file, so an 8b export never holds the fp32
model in device or host memory.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, Optional

import torch

from callireader_tpu_torch.core.config import LLMConfig, VLMConfig
from callireader_tpu_torch.runtime import quantize, safetensors_io
from callireader_tpu_torch.runtime.detector_weights import BN_EPS
from callireader_tpu_torch.runtime.weights import (
    ORDERFORMER_LAYER, RESAMPLER_LAYER, VIT_LAYER, fuse_wqkv,
)
from callireader_tpu_torch.train.e_it import TrainState, flatten
from callireader_tpu_torch.train.lora import merge_lora

STATE_FILE = "state.pt"
PARAMS_FILE = "params.pt"


def _tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state's own tensors under their checkpoint keys."""
    out = {f"trainable/{k}": v for k, v in flatten(state.trainable).items()}
    for k, v in state.opt_state.items():
        if isinstance(v, dict):
            out.update({f"opt_state/{k}/{p}": t for p, t in v.items()})
    return out


def save_train_state(path: str, state: TrainState, metadata: Optional[Dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    counters = {"step": state.step}
    counters.update({f"opt_state/{k}": v for k, v in state.opt_state.items()
                     if not isinstance(v, dict)})
    tensors = {k: v.detach().cpu() for k, v in _tensors(state).items()}
    torch.save({"tensors": tensors, "counters": counters}, os.path.join(path, STATE_FILE))
    if metadata is not None:
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(metadata, f)


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """The saved state, written into ``template``'s tensors (every leaf the
    template has must be in the file, with its shape; a template without
    optimizer moments restores the trainable leaves alone)."""
    # mmap: only the template's tensors are read (a serving restore skips the
    # optimizer moments, most of an 8b state file)
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", mmap=True,
                       weights_only=True)
    want = _tensors(template)
    missing = sorted(set(want) - set(saved["tensors"]))
    if missing:
        raise KeyError(f"{path}: the checkpoint lacks {missing[:5]}")
    with torch.no_grad():
        for key, dst in want.items():
            src = saved["tensors"][key]
            if src.shape != dst.shape:
                raise ValueError(f"{path}: {key} has shape {tuple(src.shape)}, want {tuple(dst.shape)}")
            dst.copy_(src)
    counters = saved["counters"]
    opt_state = dict(template.opt_state)
    for k in opt_state:
        if not isinstance(opt_state[k], dict):
            opt_state[k] = int(counters[f"opt_state/{k}"])
    return dataclasses.replace(template, opt_state=opt_state, step=int(counters["step"]))


def save_params(path: str, params: Any) -> None:
    """A params tree as ``<path>/params.pt`` (leaves moved to the CPU)."""
    os.makedirs(path, exist_ok=True)
    flat = {k: v.detach().cpu() for k, v in flatten(params).items()}
    torch.save(flat, os.path.join(path, PARAMS_FILE))


def load_params(path: str, device="cpu") -> Dict[str, Any]:
    """The tree ``save_params`` wrote, without a template (a node whose keys
    are all digits is a list), its leaves on ``device`` in their saved
    dtype."""
    flat = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu", mmap=True,
                      weights_only=True)
    root: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node, parts = root, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf.to(device)

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def restore_params(path: str, template: Any) -> Any:
    """A new tree shaped like ``template`` with the saved leaves, each on its
    template leaf's device and in its dtype."""
    flat = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu", weights_only=True)

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(tree))
        if tree is None:
            return None
        return flat[prefix].to(tree.device, tree.dtype)

    return build(template, "")


# ------------------------------------------------------------ export to the reference format


def llm_to_reference_sd(llm_params: Dict[str, Any], cfg: LLMConfig) -> Dict[str, torch.Tensor]:
    """Our tree -> reference key names (inverse of weights.convert_llm)."""
    layers = llm_params["layers"]
    sd = {
        "language_model.model.tok_embeddings.weight": llm_params["tok_embeddings"],
        "language_model.model.norm.weight": llm_params["norm"],
        "language_model.output.weight": llm_params["output"],
    }
    for i in range(cfg.num_hidden_layers):
        pre = f"language_model.model.layers.{i}."
        sd[pre + "attention.wqkv.weight"] = fuse_wqkv(layers["wq"][i], layers["wk"][i],
                                                      layers["wv"][i], cfg)
        sd[pre + "attention.wo.weight"] = layers["wo"][i].T
        sd[pre + "attention_norm.weight"] = layers["attn_norm"][i]
        sd[pre + "ffn_norm.weight"] = layers["ffn_norm"][i]
        sd[pre + "feed_forward.w1.weight"] = layers["w1"][i].T
        sd[pre + "feed_forward.w3.weight"] = layers["w3"][i].T
        sd[pre + "feed_forward.w2.weight"] = layers["w2"][i].T
    return sd


def _layer_sd(layers: Dict[str, torch.Tensor], pre: str, i: int, names) -> Dict[str, torch.Tensor]:
    """Layer ``i`` of stacked leaves under ``pre`` + their reference names
    (``names``: leaf -> (name, transposed))."""
    return {pre + theirs: layers[ours][i].T if transposed else layers[ours][i]
            for ours, (theirs, transposed) in names.items()}


def vit_to_reference_sd(vit_params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    pe = vit_params["patch_embed"]
    E, P = pe["kernel"].shape[1], cfg.patch_size
    sd = {
        "vision_model.embeddings.patch_embedding.weight":
            pe["kernel"].T.reshape(E, cfg.num_channels, P, P),
        "vision_model.embeddings.patch_embedding.bias": pe["bias"],
        "vision_model.embeddings.class_embedding": vit_params["cls_token"],
        "vision_model.embeddings.position_embedding": vit_params["pos_embed"],
    }
    for i in range(cfg.num_hidden_layers):
        sd.update(_layer_sd(vit_params["layers"], f"vision_model.encoder.layers.{i}.", i,
                            VIT_LAYER))
    return sd


def projector_to_reference_sd(proj: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {
        "mlp1.0.weight": proj["ln_scale"],
        "mlp1.0.bias": proj["ln_bias"],
        "mlp1.1.weight": proj["fc1_kernel"].T,
        "mlp1.1.bias": proj["fc1_bias"],
        "mlp1.3.weight": proj["fc2_kernel"].T,
        "mlp1.3.bias": proj["fc2_bias"],
    }


def resampler_to_reference_sd(res: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """Inverse of weights.convert_resampler: the deployed checkpoint's
    ``resampler.*`` keys (torch PerceiverResampler module layout, reference
    models/perceiver_resampler.py:54-100)."""
    sd = {"resampler.learns": res["learns"], "resampler.norm.weight": res["norm_scale"],
          "resampler.norm.bias": res["norm_bias"]}
    for i in range(cfg.depth):
        sd.update(_layer_sd(res["layers"], f"resampler.layers.{i}.", i, RESAMPLER_LAYER))
    return sd


def orderformer_to_reference_sd(of: Dict[str, Any], num_layers: int) -> Dict[str, torch.Tensor]:
    """Inverse of weights.convert_orderformer: torch nn.TransformerEncoder
    state-dict layout (reference models/model.py:210-226), for
    params/orderformer.pth."""
    sd = {"embedding.weight": of["embed_kernel"].T, "embedding.bias": of["embed_bias"],
          "decoder.weight": of["decode_kernel"].T, "decoder.bias": of["decode_bias"]}
    for i in range(num_layers):
        sd.update(_layer_sd(of["layers"], f"transformer_encoder.layers.{i}.", i, ORDERFORMER_LAYER))
    return sd


def detector_to_ultralytics_sd(det: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Inverse of detector_weights.convert_yolov8: an ultralytics-layout
    state dict (keys ``model.N...``) whose BN folds back to our convs exactly:
    identity BatchNorm (gamma=1, mean=0, var=1-eps) carries the bias, so
    fold_bn(w, 1, b, 0, 1-eps) == (w, b)."""
    sd: Dict[str, torch.Tensor] = {}

    def conv_block(prefix: str, blk: Dict[str, torch.Tensor]) -> None:
        cout = blk["w"].shape[3]
        sd[f"{prefix}.conv.weight"] = blk["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        sd[f"{prefix}.bn.weight"] = torch.ones(cout)
        sd[f"{prefix}.bn.bias"] = blk["b"]
        sd[f"{prefix}.bn.running_mean"] = torch.zeros(cout)
        sd[f"{prefix}.bn.running_var"] = torch.full((cout,), 1.0 - BN_EPS)

    def plain_conv(prefix: str, blk: Dict[str, torch.Tensor]) -> None:
        sd[f"{prefix}.weight"] = blk["w"].permute(3, 2, 0, 1)
        sd[f"{prefix}.bias"] = blk["b"]

    def c2f(prefix: str, node: Dict[str, Any]) -> None:
        conv_block(f"{prefix}.cv1", node["cv1"])
        conv_block(f"{prefix}.cv2", node["cv2"])
        for i, blk in enumerate(node["blocks"]):
            conv_block(f"{prefix}.m.{i}.cv1", blk["cv1"])
            conv_block(f"{prefix}.m.{i}.cv2", blk["cv2"])

    bb, neck, head = det["backbone"], det["neck"], det["head"]
    for idx, name in ((0, "stem"), (1, "down1"), (3, "down2"), (5, "down3"), (7, "down4")):
        conv_block(f"model.{idx}", bb[name])
    for idx, name in ((2, "c2f1"), (4, "c2f2"), (6, "c2f3"), (8, "c2f4")):
        c2f(f"model.{idx}", bb[name])
    conv_block("model.9.cv1", bb["sppf"]["cv1"])
    conv_block("model.9.cv2", bb["sppf"]["cv2"])
    for idx, name in ((12, "c2f_p4"), (15, "c2f_p3"), (18, "c2f_n4"), (21, "c2f_n5")):
        c2f(f"model.{idx}", neck[name])
    conv_block("model.16", neck["down_p3"])
    conv_block("model.19", neck["down_p4"])
    for i, name in enumerate(("p3", "p4", "p5")):
        for branch, key in (("box", "cv2"), ("cls", "cv3")):
            b = head[name][branch]
            conv_block(f"model.22.{key}.{i}.0", b["cv1"])
            conv_block(f"model.22.{key}.{i}.1", b["cv2"])
            plain_conv(f"model.22.{key}.{i}.2", b["out"])
    return sd


def _host32(tree):
    """A tree of tensors (any device and dtype) -> fresh contiguous fp32 CPU
    tensors, so that ``torch.save`` writes each tensor's own bytes."""
    if isinstance(tree, dict):
        return {k: _host32(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=torch.float32).copy_(tree)


def export_reference_format(
    params: Dict[str, Any],
    cfg: VLMConfig,
    out_dir: str,
    *,
    merge_lora_first: bool = True,
    max_shard_bytes: Optional[int] = None,
) -> str:
    """Write model.safetensors (or its shards and index) with the
    reference's key layout in fp32: the 'convert_to_official' deployable
    export. An int8 QLoRA base is folded back to dense bf16 first, so the
    adapters can merge -> the first file written."""
    llm = params["llm"]
    if any(k.endswith("_q") for k in llm["layers"]):
        llm = quantize.dequantize_llm_int8(llm)
    if merge_lora_first and any("_lora_" in k for k in llm["layers"]):
        llm = merge_lora(llm)
    sd = llm_to_reference_sd(llm, cfg.llm)
    sd.update(vit_to_reference_sd(params["vision"], cfg.vision))
    sd.update(projector_to_reference_sd(params["projector"]))
    if "resampler" in params:
        sd.update(resampler_to_reference_sd(params["resampler"], cfg.resampler))
    if "align" in params:
        sd["normed_emb.weight"] = params["align"]["normed_emb"]
    entries = [safetensors_io.Entry.of(k, v, torch.float32) for k, v in sd.items()]
    return safetensors_io.write_sharded(out_dir, entries, max_shard_bytes)[0]


def export_full_reference_checkpoint(
    params: Dict[str, Any],
    cfg: VLMConfig,
    out_dir: str,
    *,
    max_shard_bytes: Optional[int] = None,
) -> str:
    """Write a complete reference checkpoint directory: the safetensors set
    (llm / vision / mlp1 / resampler / normed_emb) plus every torch side
    file of config/configu.py:7-13,61-62: params/{gauss_norm_mu_sigma.pth,
    gauss_norm.pth, token_embedding.pth, mlp1.pth, vit_model.pt,
    callialign.pth, orderformer.pth, best.pt}, fp32. This is the layout
    ``build_engine(checkpoint_dir=...)`` boots from (the side files are
    discovered under ``params/``)."""
    os.makedirs(os.path.join(out_dir, "params"), exist_ok=True)
    export_reference_format(params, cfg, out_dir, max_shard_bytes=max_shard_bytes)

    def tsave(obj, name):
        torch.save(_host32(obj), os.path.join(out_dir, "params", name))

    align = params.get("align", {})
    if "mu" in align:
        tsave({"weight": torch.stack([align["mu"], align["sigma"]], dim=1)},
              "gauss_norm_mu_sigma.pth")
    if "normed_emb" in align:
        tsave({"weight": align["normed_emb"]}, "gauss_norm.pth")
    tsave({"weight": params["llm"]["tok_embeddings"]}, "token_embedding.pth")
    tsave(projector_to_reference_sd(params["projector"]), "mlp1.pth")
    tsave({k[len("vision_model."):]: v for k, v in
           vit_to_reference_sd(params["vision"], cfg.vision).items()}, "vit_model.pt")
    if "resampler" in params:
        tsave({k[len("resampler."):]: v for k, v in
               resampler_to_reference_sd(params["resampler"], cfg.resampler).items()},
              "callialign.pth")
    if "orderformer" in params:
        tsave(orderformer_to_reference_sd(params["orderformer"], cfg.orderformer.num_layers),
              "orderformer.pth")
    if "detector" in params:
        tsave({"model": detector_to_ultralytics_sd(params["detector"])}, "best.pt")
    return out_dir


CAST = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def consolidate_safetensors_dtype(src_dir: str, out_dir: str, dtype: Optional[str] = "float32",
                                  max_shard_bytes: Optional[int] = None) -> str:
    """Re-write a safetensors set with every float tensor cast to ``dtype``
    (None: kept) and resharded at ``max_shard_bytes``: the stand-in for the
    reference's ZeRO-shard consolidation (zero_to_any_dtype.py) and for
    tools/model_converters/split.py. Reads the ``*.safetensors`` files of
    ``src_dir`` in name order, each tensor in the order of its bytes."""
    if dtype is not None and dtype not in CAST:
        raise ValueError(f"dtype {dtype!r}: have {sorted(CAST)}")
    target = CAST.get(dtype)
    entries = []
    for path in sorted(glob.glob(os.path.join(src_dir, "*.safetensors"))):
        for k, v in safetensors_io.load_file(path).items():
            cast = target if target is not None and v.is_floating_point() else None
            entries.append(safetensors_io.Entry.of(k, v, cast))
    safetensors_io.write_sharded(out_dir, entries, max_shard_bytes)
    return out_dir
