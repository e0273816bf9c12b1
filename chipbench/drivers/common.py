"""What the drivers share: the port's configuration object built from a
configuration file, the build of the port's kernels, logging."""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict


def log(msg: str) -> None:
    print(f"[chipbench] {msg}", file=sys.stderr, flush=True)


def build_kernels() -> None:
    """Every CUDA source of the port (and its host char-prep library),
    compiled in parallel where stale, into the port's fixed build directory
    inside the checkout."""
    from callireader_tpu_torch.kernels import _build

    _build.build_all(sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu")) + ["charprep"])


def port_config(cfg: Dict):
    """The port's VLMConfig of the configuration file (which is the truth);
    where the file names a preset of the port, every number must agree."""
    from callireader_tpu_torch.core import config as C

    def pick(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    d = cfg.get("detector", {})
    vcfg = C.VLMConfig(
        vision=pick(C.VisionConfig, cfg["vision"]), llm=pick(C.LLMConfig, cfg["llm"]),
        detector=dataclasses.replace(C.DetectorConfig(), **{k: d[k] for k in (
            "conf_threshold", "iou_threshold", "max_detections") if k in d}),
        downsample_ratio=cfg["downsample_ratio"], force_image_size=cfg["force_image_size"],
        max_dynamic_patch=cfg["max_dynamic_patch"], use_thumbnail=cfg["use_thumbnail"])
    if vcfg.num_image_token != cfg["num_image_token"]:
        raise RuntimeError(f"{vcfg.num_image_token} image tokens a tile, the file says {cfg['num_image_token']}")
    if "preset" in cfg and C.get_config(cfg["preset"]) != vcfg:
        raise RuntimeError(f"the port's preset {cfg['preset']} differs from the configuration file")
    return vcfg

