"""A small configuration and traffic for the benchmark's CPU tests: the
served engine's whole route with the committed detector, OrderFormer and
CalliAlign assets (which fix the LLM width at 4096 and the vocabulary),
one LLM layer, a one-layer tile tower at 56 pixels, two pages a batch and
four tokens out."""

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def small_config():
    cfg = json.loads((HERE / "configs" / "internvl2_8b_int8.json").read_text())
    cfg.pop("preset")
    cfg["vision"].update(hidden_size=64, intermediate_size=128, num_hidden_layers=1, num_attention_heads=4,
                         image_size=56)
    cfg["llm"].update(intermediate_size=256, num_hidden_layers=1)
    cfg.update(force_image_size=56, num_image_token=4)
    return cfg


def small_traffic(name="fullpage_ocr"):
    spec = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    spec = copy.deepcopy(spec)
    spec.update(batch=2, pool_batches=3, columns=[4, 5], chars_per_column=[12, 13], max_new_tokens=4,
                warm_steps=1, trace_steps=1, check_requests=1)
    return spec


def small_train_config():
    cfg = json.loads((HERE / "configs" / "internvl2_8b_bf16_lora.json").read_text())
    cfg.pop("preset")
    cfg["vision"].update(hidden_size=64, intermediate_size=128, num_hidden_layers=1, num_attention_heads=4,
                         image_size=56)
    cfg["llm"].update(hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2)
    cfg.update(force_image_size=56, num_image_token=4)
    cfg["recipe"].update(lora_rank=8, lora_alpha=16.0)
    return cfg


def small_train_traffic():
    spec = json.loads((HERE / "traffic" / "eit.json").read_text())
    spec.update(samples_per_pass=4, pool_passes=2, tiles=[1, 2], chars=[4, 8], trace_steps=1)
    return spec
