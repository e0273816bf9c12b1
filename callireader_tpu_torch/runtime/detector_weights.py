"""ultralytics YOLOv8 checkpoint -> the detector tree (PyTorch port of
callireader_tpu/runtime/detector_weights.py).

The reference's character detector is a fine-tuned ultralytics model
(``YOLO("./params/best.pt")``, config/configu.py:62). This converter maps the
standard v8 ``model.model.{i}`` module list onto models/detector.py's tree,
folding BatchNorm into the conv (inference deployment):

    w' = w * gamma / sqrt(var + eps)        b' = beta - gamma * mean / sqrt(var + eps)

The fold runs the JAX package's numpy fp32 operations in the same order, so
the folded weights are bit-equal. The tree holds numpy arrays (HWIO convs);
runtime/weights.tree_to moves it to a device.

Module index map (v8n detect):
  0 stem | 1 down1 | 2 c2f1 | 3 down2 | 4 c2f2 | 5 down3 | 6 c2f3
  7 down4 | 8 c2f4 | 9 sppf | 12 c2f_p4 | 15 c2f_p3 | 16 down_p3
  18 c2f_n4 | 19 down_p4 | 21 c2f_n5 | 22 detect (cv2=box, cv3=cls, dfl)
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

BN_EPS = 1e-3  # ultralytics BatchNorm2d default


def fold_bn(conv_w: np.ndarray, gamma: np.ndarray, beta: np.ndarray, mean: np.ndarray,
            var: np.ndarray, eps: float = BN_EPS):
    """(cout, cin, k, k) conv and its BatchNorm -> (w', b')."""
    scale = gamma / np.sqrt(var + eps)
    w = conv_w * scale[:, None, None, None]
    b = beta - mean * scale
    return w, b


def _to_hwio(w: np.ndarray) -> np.ndarray:
    """(cout, cin, kh, kw) -> (kh, kw, cin, cout)."""
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _conv_block(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    w, b = fold_bn(sd[f"{prefix}.conv.weight"], sd[f"{prefix}.bn.weight"],
                   sd[f"{prefix}.bn.bias"], sd[f"{prefix}.bn.running_mean"],
                   sd[f"{prefix}.bn.running_var"])
    return {"w": _to_hwio(w), "b": b}


def _plain_conv(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "w": _to_hwio(sd[f"{prefix}.weight"]),
        "b": sd.get(f"{prefix}.bias", np.zeros(sd[f"{prefix}.weight"].shape[0], np.float32)),
    }


def _c2f(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """A C2f block; its shortcut flag is structural, not a leaf
    (models/detector.py runs the backbone's with shortcuts, the neck's
    without)."""
    blocks = []
    i = 0
    while f"{prefix}.m.{i}.cv1.conv.weight" in sd:
        blocks.append({"cv1": _conv_block(sd, f"{prefix}.m.{i}.cv1"),
                       "cv2": _conv_block(sd, f"{prefix}.m.{i}.cv2")})
        i += 1
    return {"cv1": _conv_block(sd, f"{prefix}.cv1"), "cv2": _conv_block(sd, f"{prefix}.cv2"),
            "blocks": blocks}


def _head_branch(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    return {"cv1": _conv_block(sd, f"{prefix}.0"), "cv2": _conv_block(sd, f"{prefix}.1"),
            "out": _plain_conv(sd, f"{prefix}.2")}


def load_ultralytics_state_dict(path: str) -> Dict[str, np.ndarray]:
    """best.pt -> flat fp32 numpy dict with 'model.N.' prefixes stripped to
    'N.' (a ``{"model": module or state dict}`` checkpoint, or a bare state
    dict)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    model = obj.get("model", obj) if isinstance(obj, dict) else obj
    sd = model.state_dict() if hasattr(model, "state_dict") else model
    out = {}
    for k, v in sd.items():
        k = k[len("model."):] if k.startswith("model.") else k
        out[k] = v.detach().float().numpy()
    return out


def convert_yolov8(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Numpy state dict (keys 'N.conv.weight'...) -> detector tree."""
    params = {
        "backbone": {
            "stem": _conv_block(sd, "0"),
            "down1": _conv_block(sd, "1"),
            "c2f1": _c2f(sd, "2"),
            "down2": _conv_block(sd, "3"),
            "c2f2": _c2f(sd, "4"),
            "down3": _conv_block(sd, "5"),
            "c2f3": _c2f(sd, "6"),
            "down4": _conv_block(sd, "7"),
            "c2f4": _c2f(sd, "8"),
            "sppf": {"cv1": _conv_block(sd, "9.cv1"), "cv2": _conv_block(sd, "9.cv2")},
        },
        "neck": {
            "c2f_p4": _c2f(sd, "12"),
            "c2f_p3": _c2f(sd, "15"),
            "down_p3": _conv_block(sd, "16"),
            "c2f_n4": _c2f(sd, "18"),
            "down_p4": _conv_block(sd, "19"),
            "c2f_n5": _c2f(sd, "21"),
        },
        "head": {},
    }
    for i, name in enumerate(("p3", "p4", "p5")):
        params["head"][name] = {"box": _head_branch(sd, f"22.cv2.{i}"),
                                "cls": _head_branch(sd, f"22.cv3.{i}")}
    return params


def load_detector(path: str) -> Dict[str, Any]:
    return convert_yolov8(load_ultralytics_state_dict(path))
