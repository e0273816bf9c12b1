"""The plain reference of chipbench/reference/ against the port's plain
path (its CPU route, float32), piece by piece at small sizes: the towers,
the char route, the box stage's reading order, the prompt, and InternLM2's
prefill and cached decode with the served positions."""

import numpy as np
import pytest
import torch

from callireader_tpu_torch.align import vq as port_vq
from callireader_tpu_torch.core import config as C
from callireader_tpu_torch.core.dtypes import FP32_POLICY
from callireader_tpu_torch.models import internlm2, internvit, projector, resampler
from chipbench import traffic, weights
from chipbench.drivers import ocr
from chipbench.reference import models
from chipbench.reference.ocr import PlainOCR, n_tiles
from chipbench.tests.small import small_config, small_traffic

VIT = {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
       "image_size": 56, "patch_size": 14, "layer_norm_eps": 1e-6}


def close(a, b, tol=2e-5):
    a, b = a.float(), b.float()
    assert float((a - b).norm() / b.norm()) < tol


def test_tile_tower_and_projector():
    p = weights.draw_vit(VIT, 5, "cpu", torch.float32)
    proj = weights.draw_projector(32, 48, 5, "cpu", torch.float32)
    x = torch.randint(0, 256, (3, 56, 56, 3), dtype=torch.uint8)
    cfg = C.VLMConfig(vision=C.VisionConfig(**VIT), force_image_size=56)
    port = internvit.forward(p, cfg.vision, x, policy=FP32_POLICY, attn_impl="reference")
    close(models.vit(p, VIT, x), port)
    close(models.projector(proj, port), projector.extract_feature(proj, port, cfg, policy=FP32_POLICY))


def test_char_route_on_the_committed_asset():
    ref = PlainOCR(small_config(), 9, "cpu")
    feats = torch.randn(4, 64, 512) * 0.5
    rcfg = C.ResamplerConfig(**ref.res_cfg)
    port = resampler.forward(ref.res, rcfg, feats, policy=FP32_POLICY)
    close(models.resampler(ref.res, ref.res_cfg, feats), port)
    align = {k: v.float() for k, v in ref.align.items()}
    want, _ = port_vq.calli_align_embed(port, align["normed_emb"], align["mu"], align["sigma"])
    close(models.vq_denorm(align, port), want)


@pytest.fixture(scope="module")
def engine():
    return ocr.build_engine(small_config(), 11, "cpu")


def test_box_stage_and_prompt(engine):
    spec = small_traffic()
    pages, _ = traffic.page_pool(dict(spec, pool_batches=1), 2**33 + 5)
    ref = PlainOCR(small_config(), 11, "cpu")
    with torch.no_grad():
        want = engine.batch_sort_boxes(pages)
        got = [ref.order(p, d) for p, d in zip(pages, ref.detect(pages))]
    assert got == want
    rows = engine.batch_build_rows(pages, [spec["question"]] * len(pages), ordered_lists=want)
    lengths = np.asarray(rows["mask"]).sum(1).tolist()
    n_chars = [len(o) for o in got]
    assert lengths == [len(ref.prompt_ids(n_tiles(small_config(), p), 3 * n, spec["question"])) for p, n in zip(pages, n_chars)]


def test_llm_prefill_and_cached_decode():
    llm_cfg = {"vocab_size": 300, "hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
               "num_attention_heads": 4, "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
               "rope_theta": 1e6, "max_position_embeddings": 32768}
    port_cfg = C.LLMConfig(**llm_cfg)
    tree = weights.draw_llm(llm_cfg, 4, "cpu", torch.float32)
    g = torch.Generator().manual_seed(1)
    n, S, T = 5, 8, 4
    ids = torch.randint(0, 300, (n,), generator=g)
    embeds = torch.zeros(1, S, 64)
    embeds[0, S - n:] = tree["tok_embeddings"][ids]
    mask = torch.zeros(1, S, dtype=torch.int32)
    mask[0, S - n:] = 1
    served = torch.randint(0, 300, (T,), generator=g)
    logits, cache = internlm2.prefill(tree, port_cfg, inputs_embeds=embeds, attention_mask=mask,
                                      max_len=S + T, cache_dtype=torch.float32, policy=FP32_POLICY)
    port = [logits[0]]
    valid = torch.zeros(1, S + T, dtype=torch.int32)
    valid[:, :S] = mask
    for j in range(T - 1):
        lg, cache = internlm2.decode_step(tree, port_cfg, input_ids=served[j].view(1, 1), cache=cache,
                                          kv_valid_mask=valid, policy=FP32_POLICY)
        port.append(lg[0])
    x = tree["tok_embeddings"][torch.cat([ids, served[:-1]])][None]
    pos = torch.cat([torch.arange(n), S + torch.arange(T - 1)])
    W = models.plain_weight(tree)
    ref = models.llm_logits(W, models.llm_hidden(W, llm_cfg, x, pos)[0, n - 1:], 300)
    close(ref, torch.stack(port), 1e-5)


def test_int4_weights_round_to_seven_levels():
    tree = {"layers": {"wq": torch.randn(2, 8, 4)}}
    w = models.quantized_weight(tree, 7)("wq", 1)
    steps = w / (tree["layers"]["wq"][1].abs().amax(0, keepdim=True) / 7)
    assert torch.allclose(steps, steps.round(), atol=1e-4) and steps.abs().max() <= 7 + 1e-4

