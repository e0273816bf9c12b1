"""The operation and byte counts of chipbench/flops.py against hand counts
at tiny shapes, and the tower counts against torch's own count of the plain
reference's products."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from chipbench import flops, weights
from chipbench.reference import models

TINY_VIT = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2, "num_attention_heads": 2,
            "image_size": 28, "patch_size": 14}
TINY_LLM = {"hidden_size": 8, "intermediate_size": 12, "num_hidden_layers": 3, "num_attention_heads": 2,
            "num_key_value_heads": 1}


def test_hand_counts():
    assert flops.causal_pairs([3, 1]) == 6 + 1
    assert flops.decode_valid_keys([2], 3) == 3 + 4 + 5
    # per layer: q 8x8, k and v 8x4 each, o 8x8, three 8x12 -> 64 + 32 + 32 + 64 + 288
    assert flops.llm_layer_params(TINY_LLM) == 480
    # 2 tokens: products 2 * 2 * 3 * 448, causal pairs 3 x heads 2 x width 4 x 4 x 3 layers,
    # the LM head at the last position 2 * 8 * 10
    assert flops.prefill_flops(TINY_LLM, [2], 10) == 2 * 2 * 3 * 480 + 4 * 3 * 2 * 4 * 3 + 2 * 8 * 10
    # 2 steps after a 2-token prompt: keys 3 + 4
    assert flops.decode_flops(TINY_LLM, [2], 2, 10) == 2 * 2 * (3 * 480 + 80) + 4 * 7 * 2 * 4 * 3
    assert flops.int8_kn_bytes(128, 256, 4) == 128 * 256 + 4 * 256 + 2 * 4 * 128 + 2 * 4 * 256
    assert flops.flash_decode_bytes(TINY_LLM, 5, 2, 16) == 5 * 1 * 4 * 4 + 4 * 2 * 8 + 4 * 2 * 16
    assert flops.int8_kn_shapes({"hidden_size": 4096, "intermediate_size": 14336, "num_attention_heads": 32,
                                 "num_key_value_heads": 8}) == [(4096, 6144), (4096, 4096), (4096, 28672),
                                                                (14336, 4096)]
    lora = flops.lora_flops(TINY_LLM, 2, 5, ["wq", "w2"])
    assert lora["forward"] == 3 * 2 * 5 * 2 * ((8 + 8) + (12 + 8))
    assert lora["backward"] == 2 * lora["forward"]


def test_vit_count_matches_torch():
    p = weights.draw_vit(TINY_VIT, 3, "cpu", torch.float32)
    x = torch.randint(0, 256, (3, 28, 28, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as fc:
        models.vit(p, TINY_VIT, x)
    assert fc.get_total_flops() == flops.vit_flops(TINY_VIT, 3)


def test_projector_and_resampler_counts_match_torch():
    proj = weights.draw_projector(8, 12, 3, "cpu", torch.float32)
    h = torch.randn(2, 1 + 16, 8)
    with FlopCounterMode(display=False) as fc:
        models.projector(proj, h)
    assert fc.get_total_flops() == flops.projector_flops(8, 12, 4, 2)
    cfg = {"dim": 8, "depth": 2, "dim_head": 4, "heads": 2, "num_learns": 3, "ff_mult": 2, "out_dim": 16}
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    L = 2
    p = {"learns": r(3, 8), "norm_scale": torch.ones(8), "norm_bias": torch.zeros(8),
         "out_kernel": r(8, 16), "out_bias": torch.zeros(16),
         "layers": {"norm_media_scale": torch.ones(L, 8), "norm_media_bias": torch.zeros(L, 8),
                    "norm_learns_scale": torch.ones(L, 8), "norm_learns_bias": torch.zeros(L, 8),
                    "to_q": r(L, 8, 8), "to_kv": r(L, 8, 16), "to_out": r(L, 8, 8),
                    "ff_norm_scale": torch.ones(L, 8), "ff_norm_bias": torch.zeros(L, 8),
                    "ff1": r(L, 8, 16), "ff1_bias": torch.zeros(L, 16), "ff2": r(L, 16, 8),
                    "ff2_bias": torch.zeros(L, 8)}}
    with FlopCounterMode(display=False) as fc:
        models.resampler(p, cfg, r(5, 4, 8))
    assert fc.get_total_flops() == flops.resampler_flops(cfg, 4, 5)
