"""The MLA-MoE page cell (``drivers/moonlight.py``) at a small size on the
CPU: a whole run against its reference (the three exact checks at 0, the
gaps 0 on the CPU, the expert probe at bf16's rounding), no JAX loaded, and
a planted fault (faults_moe.py) moving the gaps and the probe; the cell's operations and bytes."""

import json
import subprocess
import sys
from pathlib import Path

from chipbench import flops_moe

ROOT = Path(__file__).resolve().parents[2]

SMALL_RUN = """
import json, time
from chipbench.drivers import moonlight
from chipbench.run import forbidden_modules
from chipbench.tests.small import small_traffic
cfg = json.load(open("chipbench/configs/moonlight_16b_a3b_bf16.json"))
cfg.pop("preset")
cfg["vision"].update(hidden_size=64, intermediate_size=128, num_hidden_layers=1, num_attention_heads=4,
                     image_size=56)
cfg.update(force_image_size=56, num_image_token=4, vocab_size=92554, hidden_size=128, intermediate_size=256,
           moe_intermediate_size=64, num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=32,
           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
           num_experts_per_tok=3, n_shared_experts=1)
cfg["char_tower"]["vision"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=4)
cfg["char_tower"]["resampler"].update(dim=32, depth=1, dim_head=8, heads=4, out_dim=128)
spec, seed = small_traffic("interpret"), 2**31 + 101
spec["max_new_tokens"] = 4
class C: process_start = time.time()
out = moonlight.run(cfg, spec, seed, 1.0, False, C, device="cpu")
from chipbench.drivers.ocr import Pipeline
from chipbench.tests.faults_moe import plant
from chipbench import traffic
engine = moonlight.build_engine(cfg, seed, "cpu")
plant(engine, "no_shared")
pages, drawn = traffic.page_pool(spec, seed)
pipe = Pipeline(engine, pages, spec)
pipe.prime()
sample = moonlight.sample_of(pipe, 0, drawn)
sample["probe"] = moonlight.expert_probe(engine, seed)
faulty, _ = moonlight.judge(cfg, spec, seed, sample, "cpu")
print(json.dumps({"checks": out["checks"], "notes": out["notes"], "faulty": faulty,
                  "forbidden": forbidden_modules(), "attempted": out["attempted"]}))
"""


def test_moe_page_run_against_its_reference():
    proc = subprocess.run([sys.executable, "-c", SMALL_RUN], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["forbidden"] == [] and r["attempted"] > 0
    c = r["checks"]
    assert c["order_mismatch"] == c["prompt_length_mismatch"] == c["bucket_mismatch"] == 0, c
    assert c["max_served_gap"] < 1e-3 and c["mean_served_gap"] < 1e-4
    assert r["notes"]["routing"]["choices"] > 0
    assert r["faulty"]["max_served_gap"] > c["max_served_gap"] + 1e-3
    # the expert probe: bf16's rounding alone (at this width mostly the residual's, which the
    # blocks' small output lies under) against the shared experts left out
    assert 0 < c["expert_layer_error"] < 0.1 < r["faulty"]["expert_layer_error"], (c, r["faulty"])
    assert 0 < r["notes"]["probe_rows_left_out"] < 0.5


def test_moe_operations_and_bytes_at_the_cell():
    cfg = json.loads((ROOT / "chipbench" / "configs" / "moonlight_16b_a3b_bf16.json").read_text())
    lens = [3300] * 8
    # ~35 of 64 experts touched a layer at 8 rows: ~15.7 GB of expert weights a step
    assert 15.0e9 < flops_moe.expert_decode_bytes(cfg, 35 * 26, 8) < 16.5e9
    # a step's latent rows: ~3.8k keys x 8 rows x 576 x 2 B x 27 layers
    assert 0.9e9 < flops_moe.latent_decode_bytes(cfg, lens, 1024) / 1024 < 1.0e9
    # the prefill: ~26.4k tokens x 2 x ~2.5 G active parameters, plus attention
    assert 120e12 < flops_moe.prefill_flops(cfg, lens) < 140e12
    assert flops_moe.expert_prefill_flops(cfg, lens) == 2.0 * sum(lens) * 6 * 3 * 2048 * 1408 * 26
