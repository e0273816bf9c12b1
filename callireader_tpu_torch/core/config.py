"""Model and pipeline configuration for the PyTorch/CUDA port.

A copy of callireader_tpu/core/config.py (the port imports nothing from the
JAX package): the same dataclasses and presets, so a preset name means the
same widths and depths in both packages. The values of the flagship preset
mirror the reference deployment config (InternVL/config.json).

Reference citations (for parity checking):
  - vision config:      InternVL/config.json  "vision_config"
  - llm config:         InternVL/config.json  "llm_config"
  - resampler:          models/perceiver_resampler.py:54-79 (dim 4096, depth 4,
                        heads 8, dim_head 64, 3 learned queries, ff_mult 4)
  - orderformer:        models/model.py:528-546 (d_model 256, 4 layers, 8 heads,
                        input_dim 4, max 50 boxes at inference)
  - pixel-shuffle:      modeling_internvl_chat.py:283-297 (ps_version v2)
  - num_image_token:    modeling_internvl_chat.py:146  ((448/14)^2 * 0.25 = 256)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """InternViT-style vision encoder."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 448
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    qk_normalization: bool = False
    norm_type: str = "layer_norm"  # or "rms_norm"
    hidden_act: str = "gelu"
    initializer_range: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    """InternLM2-style decoder-only LLM (GQA, SwiGLU, RMSNorm, RoPE)."""

    vocab_size: int = 92553
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1_000_000.0
    max_position_embeddings: int = 32768
    # rope_scaling {"type": "dynamic", "factor": 2.0} in the reference config.
    # Dynamic-NTK only changes the base when seq_len > max_position_embeddings
    # (modeling_internlm2.py:205-233); CalliReader sequences never get close, so
    # at matching lengths this is exactly vanilla RoPE.
    # when the vocab tables are padded (pad_vocab, for even sharding over the
    # tensor axis), ids >= real_vocab_size carry -inf logits so greedy/sample
    # decode can never emit them; None = no padding
    real_vocab_size: Optional[int] = None
    rope_scaling_type: Optional[str] = "dynamic"
    rope_scaling_factor: float = 2.0
    tie_word_embeddings: bool = False
    bias: bool = False
    pad_token_id: int = 2
    bos_token_id: int = 1
    eos_token_id: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_query_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    """Perceiver resampler ("CalliAlign"): compresses 256 image-patch embeds
    into `num_learns` pseudo-text embeddings."""

    dim: int = 4096
    depth: int = 4
    dim_head: int = 64
    heads: int = 8
    num_learns: int = 3
    ff_mult: int = 4
    # When set (compact CalliAlign tower, docs/CALLIALIGN.md), a final linear
    # projects the num_learns outputs from `dim` to `out_dim` so the VQ still
    # runs over the 4096-dim token table. None = reference shape (dim == VQ
    # dim, no extra layer).
    out_dim: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class OrderFormerConfig:
    """Reading-order regressor over normalized column boxes."""

    input_dim: int = 4
    model_dim: int = 256
    num_heads: int = 8
    num_layers: int = 4
    output_dim: int = 1
    ff_dim: int = 2048  # torch nn.TransformerEncoderLayer default
    max_boxes: int = 50  # models/model.py:529 load_orderformer(max_num=50)


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """YOLOv8-style anchor-free single-class character detector."""

    num_classes: int = 1
    depth_mult: float = 0.33  # "n" scale
    width_mult: float = 0.25
    max_channels: int = 1024
    reg_max: int = 16
    img_size: int = 640
    # operating point swept on the reference fixture with the shipped
    # checkpoint (assets/detector_640.npz): conf 0.5 / NMS IoU 0.3 gives
    # P 0.860 R 0.958 F1 0.906 at 107 post-dedup boxes — grid chars barely
    # overlap, so tight NMS only removes cross-scale duplicates
    # (ultralytics general-object defaults are 0.25/0.7)
    conf_threshold: float = 0.5
    iou_threshold: float = 0.3
    max_detections: int = 300


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """Top-level composition = vision tower + projector + LLM + plug-ins."""

    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    llm: LLMConfig = dataclasses.field(default_factory=LLMConfig)
    # Dedicated char-path encoder. The reference deploys its char encoder as
    # a SEPARATE module (params/vit_model.pt, config/configu.py:7 +
    # models/model.py:20-30) — same freedom here: when set, the calli_align
    # path runs this compact tower (params["char_vision"] +
    # params["char_projector"]) instead of the shared tile tower, and the
    # char canvas/content scale follow its image_size. None = share the tile
    # tower (reference InternViT shapes).
    char_vision: Optional[VisionConfig] = None
    resampler: ResamplerConfig = dataclasses.field(default_factory=ResamplerConfig)
    orderformer: OrderFormerConfig = dataclasses.field(default_factory=OrderFormerConfig)
    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)

    downsample_ratio: float = 0.5
    ps_version: str = "v2"
    select_layer: int = -1
    force_image_size: int = 448
    min_dynamic_patch: int = 1
    max_dynamic_patch: int = 12
    use_thumbnail: bool = True
    template: str = "internlm2-chat"

    # Special token ids (InternVL/added_tokens.json, tokenizer_config.json)
    img_start_token_id: int = 92544  # <img>
    img_end_token_id: int = 92545  # </img>
    img_context_token_id: int = 92546  # <IMG_CONTEXT>
    aligned_token_id: int = 92537  # [UNUSED_TOKEN_140]: pseudo-text slot
    im_start_token_id: int = 92543  # <|im_start|>
    im_end_token_id: int = 92542  # <|im_end|>

    @property
    def num_image_token(self) -> int:
        ratio = self.downsample_ratio
        image_size = self.force_image_size or self.vision.image_size
        return int((image_size // self.vision.patch_size) ** 2 * ratio**2)

    @property
    def vit_seq_len(self) -> int:
        return self.vision.num_patches + 1  # + CLS


def callireader_8b() -> VLMConfig:
    """Flagship: InternViT-300M + InternLM2.5-7B-chat + CalliAlign plug-ins."""
    return VLMConfig()


def callireader_2b() -> VLMConfig:
    """Reduced-depth variant (12 ViT / 8 LLM layers) at the flagship's widths;
    identical layer architecture, bf16 on one device."""
    return VLMConfig(
        vision=VisionConfig(num_hidden_layers=12),
        llm=LLMConfig(num_hidden_layers=8),
    )


def callireader_tiny() -> VLMConfig:
    """Tiny config for unit tests: same topology, trivial widths."""
    return VLMConfig(
        vision=VisionConfig(
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            image_size=56,
            patch_size=14,
        ),
        llm=LLMConfig(
            # full vocab (+1 for <ALIGNED_TOKEN>=92553) so the real tokenizer's
            # special-token ids stay in range in end-to-end tests
            vocab_size=92554,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            max_position_embeddings=512,
        ),
        resampler=ResamplerConfig(dim=64, depth=2, dim_head=8, heads=4),
        orderformer=OrderFormerConfig(model_dim=32, num_layers=2, num_heads=4, ff_dim=64),
        detector=DetectorConfig(img_size=64, max_detections=50),
        force_image_size=56,
    )


PRESETS = {
    "callireader-8b": callireader_8b,
    "callireader-2b": callireader_2b,
    "callireader-tiny": callireader_tiny,
}


def get_config(name: str) -> VLMConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
