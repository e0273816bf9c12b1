"""The cells' weights, drawn from ``--seed`` on the device in the dtype they
are served in, one call a stacked leaf, and the committed trained assets
read from their files. The program gets these trees and derives its own
(int8 codes, fused layouts, padded tables) from them; the plain reference
draws the same trees again after the window and reads the same files.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
ASSETS = ROOT / "callireader_tpu" / "assets"
STREAMS = {"llm": 1, "vision": 2, "projector": 3, "align": 4, "lora": 5, "inputs": 6}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """One generator a component: (seed, component) -> its own stream."""
    return torch.Generator(device=device).manual_seed((int(seed) * 64 + STREAMS[stream]) % (1 << 63))


class Draw:
    def __init__(self, seed: int, stream: str, device, dtype=torch.bfloat16):
        self.g, self.device, self.dtype = generator(seed, stream, device), device, dtype

    def normal(self, shape, std: float, dtype=None) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype or self.dtype, device=self.device)
        return t.normal_(0.0, std, generator=self.g)

    def full(self, shape, value: float, dtype=None) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype or self.dtype, device=self.device)


def draw_llm(cfg: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """InternLM2, N(0, 0.02) matrices and unit norms, (in, out) layers stacked."""
    r = Draw(seed, "llm", device, dtype)
    L, E, M, V = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = E // Hq
    layers = {"attn_norm": r.full((L, E), 1.0), "ffn_norm": r.full((L, E), 1.0)}
    for name, shape in (("wq", (E, Hq * D)), ("wk", (E, Hkv * D)), ("wv", (E, Hkv * D)),
                        ("wo", (Hq * D, E)), ("w1", (E, M)), ("w3", (E, M)), ("w2", (M, E))):
        layers[name] = r.normal((L,) + shape, 0.02)
    return {"tok_embeddings": r.normal((V, E), 0.02), "layers": layers,
            "norm": r.full((E,), 1.0), "output": r.normal((V, E), 0.02)}


def draw_vit(cfg: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """InternViT, N(0, initializer_range) matrices, zero biases, unit norms and layer scales."""
    r = Draw(seed, "vision", device, dtype)
    L, E, M = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    P, s = cfg["patch_size"], cfg.get("initializer_range", 0.02)
    n = (cfg["image_size"] // P) ** 2 + 1
    zeros = lambda *shape: r.full(shape, 0.0)  # noqa: E731
    ones = lambda *shape: r.full(shape, 1.0)  # noqa: E731
    return {
        "patch_embed": {"kernel": r.normal((3 * P * P, E), s), "bias": zeros(E)},
        "cls_token": r.normal((1, 1, E), s),
        "pos_embed": r.normal((1, n, E), s),
        "layers": {
            "norm1_scale": ones(L, E), "norm1_bias": zeros(L, E),
            "norm2_scale": ones(L, E), "norm2_bias": zeros(L, E),
            "qkv_kernel": r.normal((L, E, 3 * E), s), "qkv_bias": zeros(L, 3 * E),
            "proj_kernel": r.normal((L, E, E), s), "proj_bias": zeros(L, E),
            "fc1_kernel": r.normal((L, E, M), s), "fc1_bias": zeros(L, M),
            "fc2_kernel": r.normal((L, M, E), s), "fc2_bias": zeros(L, E),
            "ls1": ones(L, E), "ls2": ones(L, E),
        },
    }


def draw_projector(vit_hidden: int, out_dim: int, seed: int, device, dtype=torch.bfloat16):
    """The tile tower's pixel-shuffle projector (4 E_vit -> out -> out)."""
    r = Draw(seed, "projector", device, dtype)
    d = 4 * vit_hidden
    return {"ln_scale": r.full((d,), 1.0), "ln_bias": r.full((d,), 0.0),
            "fc1_kernel": r.normal((d, out_dim), 0.02), "fc1_bias": r.full((out_dim,), 0.0),
            "fc2_kernel": r.normal((out_dim, out_dim), 0.02), "fc2_bias": r.full((out_dim,), 0.0)}


def draw_align(vocab: int, hidden: int, seed: int, device, dtype=torch.bfloat16):
    """The VQ token table N(0, 1) and an identity denorm (mu 0, sigma 1)."""
    r = Draw(seed, "align", device, dtype)
    return {"normed_emb": r.normal((vocab, hidden), 1.0),
            "mu": r.full((vocab,), 0.0, torch.float32), "sigma": r.full((vocab,), 1.0, torch.float32)}


def load_npz_tree(path: Path, device, dtype=torch.float32, prefix: str = "") -> Dict[str, Any]:
    """A committed asset as a tree: '/'-joined keys, numeric segments are
    list indices, float16 storage widened to ``dtype``. ``prefix``: only the
    keys under it, with it stripped."""
    z = np.load(path, allow_pickle=False)
    root: Dict[str, Any] = {}
    for key in z.files:
        if key == "meta" or not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        a = z[key]
        t = torch.from_numpy(np.ascontiguousarray(a))
        node[parts[-1]] = t.to(device, dtype) if a.dtype.kind == "f" else t.to(device)

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)
