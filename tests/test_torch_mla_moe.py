"""The MLA-MoE LLM (models/mla_moe.py, the Moonlight-16B-A3B block) against
the plain float32 reference (chipbench/reference/moonlight.py) at a tiny
preset on seeded weights: the plain path, prefill then decode through the
latent cache, the absorbed against the non-absorbed attention, the grouped
experts against a per-token loop, and the tiny engine's page route against a
greedy loop over the reference. Card-only tests hold each new kernel to its
plain version at the cell's shapes."""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from callireader_tpu_torch.core.config import MLAMoEConfig, get_config
from callireader_tpu_torch.core.dtypes import FP32_POLICY
from callireader_tpu_torch.kernels import mla_decode, mla_prefill, moe_experts, tolerance
from callireader_tpu_torch.models import mla_moe
from callireader_tpu_torch.runtime.weights import _Init
from chipbench.reference import moonlight as ref

V = 512  # a small vocabulary for the model-level tests


def _cfg(**kw) -> MLAMoEConfig:
    return dataclasses.replace(get_config("moonlight-tiny").llm, vocab_size=V, **kw)


def _tree(cfg: MLAMoEConfig, seed: int = 0, bias_std: float = 0.05):
    """A drawn fp32 tree; a correction bias large enough to move the choice."""
    tree = mla_moe.init_params(_Init(torch.Generator().manual_seed(seed), "cpu", torch.float32), cfg)
    tree["moe"]["gate_bias"] = torch.randn(tree["moe"]["gate_bias"].shape,
                                           generator=torch.Generator().manual_seed(seed + 1)) * bias_std
    return tree


@pytest.fixture(scope="module")
def model():
    cfg = _cfg()
    tree = _tree(cfg)
    return cfg, tree, mla_moe.prepare(copy.deepcopy(tree), cfg)


def _ref_logits(cfg, tree, embeds, positions):
    d = dataclasses.asdict(cfg)
    return ref.logits(tree, d, ref.hidden(tree, d, embeds.float(), positions))


def test_plain_path_matches_the_reference_logits(model):
    cfg, tree, port = model
    ids = torch.randint(0, V, (2, 10), generator=torch.Generator().manual_seed(3))
    got = mla_moe.forward(port, cfg, input_ids=ids, policy=FP32_POLICY)
    for b in range(2):
        want = _ref_logits(cfg, tree, tree["tok_embeddings"][ids[b]], torch.arange(10))
        torch.testing.assert_close(got[b], want, rtol=0, atol=2e-5)


def test_prefill_then_decode_through_the_latent_cache_matches_the_full_forward(model):
    """Two left-padded prompts (7 and 10 valid tokens in 12 slots), then three
    decode steps at slots 12, 13, 14 (RoPE at the slot, as the port's decode
    always does), against the reference over each row's valid tokens."""
    cfg, tree, port = model
    g = torch.Generator().manual_seed(4)
    S, steps, lens = 12, 3, (7, 10)
    embeds = torch.randn((2, S, cfg.hidden_size), generator=g) * 0.02
    mask = torch.zeros((2, S), dtype=torch.int32)
    for b, n in enumerate(lens):
        mask[b, S - n:] = 1
    logits, cache = mla_moe.prefill(port, cfg, inputs_embeds=embeds, attention_mask=mask,
                                    max_len=S + steps, cache_dtype=torch.float32, policy=FP32_POLICY)
    kv_valid = torch.zeros((2, S + steps), dtype=torch.int32)
    kv_valid[:, :S] = mask
    toks = torch.randint(0, V, (2, steps), generator=g)
    got = [logits]
    for j in range(steps):
        got.append(mla_moe.decode_step_at(port, cfg, input_ids=toks[:, j:j + 1], cache=cache,
                                          kv_valid=kv_valid, slot=torch.tensor([S + j]), policy=FP32_POLICY))
    got = torch.stack(got, 1)  # (2, steps + 1, V)
    for b, n in enumerate(lens):
        x = torch.cat([embeds[b, S - n:], tree["tok_embeddings"][toks[b]]])
        pos = torch.cat([torch.arange(n), S + torch.arange(steps)])
        want = _ref_logits(cfg, tree, x, pos)[n - 1:]
        torch.testing.assert_close(got[b], want, rtol=0, atol=3e-5)


def test_absorbed_and_non_absorbed_attention_agree(model):
    """One layer: the prefill's context (k_nope and v expanded from the
    latents) at each position against the decode's absorbed form over the
    same latent rows (q_nope W_kb^T, the latent kernel's plain version, then
    W_vb)."""
    cfg, _, port = model
    S, H, R, Dn = 9, cfg.num_attention_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim
    p = mla_moe._layer(port, 1)
    h = torch.randn((1, S, cfg.hidden_size), generator=torch.Generator().manual_seed(5))
    pos = torch.arange(S)[None]
    cos, sin = mla_moe.rope_tables(cfg, pos)
    ctx, rows = mla_moe._attend_full(p, cfg, h, cos, sin, torch.zeros((1, S), dtype=torch.int32),
                                     FP32_POLICY)
    q = (h[0] @ p["wq"]).view(S, H, -1)
    q_pe = mla_moe.rope_pairs(q[..., Dn:], cos[0, :, None], sin[0, :, None])
    q_lat = torch.einsum("shd,hdr->shr", q[..., :Dn], p["wkb_t"])
    for t in range(S):
        valid = torch.zeros((1, S), dtype=torch.int32)
        valid[0, :t + 1] = 1
        o_lat = mla_decode.latent_decode(torch.cat([q_lat[t], q_pe[t]], -1)[None], rows, valid,
                                         torch.tensor([t]), R, cfg.qk_head_dim ** -0.5)
        o = torch.einsum("hr,hrv->hv", o_lat[0], p["wvb"])
        torch.testing.assert_close(o.reshape(-1), ctx[0, t], rtol=0, atol=2e-6)


def _per_token(h, gate, bias, w1, w3, w2, cfg, scale=True, with_bias=True):
    """The routed experts token by token, as the published MoEGate and
    moe_infer state them."""
    out = torch.zeros_like(h)
    for t in range(h.shape[0]):
        s = torch.sigmoid(h[t] @ gate)
        sel = torch.topk(s + bias if with_bias else s, cfg.num_experts_per_tok).indices
        w = s[sel] / (s[sel].sum() + 1e-20) * (cfg.routed_scaling_factor if scale else 1.0)
        for j, e in enumerate(sel.tolist()):
            out[t] += w[j] * ((F.silu(h[t] @ w1[e]) * (h[t] @ w3[e])) @ w2[e])
    return out


@pytest.mark.parametrize("tokens", [1, 5, 23])
def test_grouped_experts_match_a_per_token_loop(tokens):
    """route + the grouped route (the kernel's plain version on the fused
    gate / up layout) against the published rule token by token: the bias
    moves the choice, not the weights; the weights are normalised, then
    scaled. Each fault of the benchmark's (no bias, no scale) reads apart."""
    cfg = _cfg()
    tree = _tree(cfg, seed=7, bias_std=0.2)
    m = {k: v[0] for k, v in tree["moe"].items()}
    h = torch.randn((tokens, cfg.hidden_size), generator=torch.Generator().manual_seed(tokens))
    p = dict(m, w13=mla_moe.fuse_w13(m["w1"], m["w3"]))
    sel, w = mla_moe.route(p, cfg, h)
    tally = torch.zeros(1, dtype=torch.int64)
    got = moe_experts.moe_experts(h, sel, w, p["w13"], m["w2"], tally=tally)
    want = _per_token(h, m["gate"], m["gate_bias"], m["w1"], m["w3"], m["w2"], cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert int(tally) == len(set(sel.flatten().tolist()))
    for fault in (dict(scale=False), dict(with_bias=False)):
        other = _per_token(h, m["gate"], m["gate_bias"], m["w1"], m["w3"], m["w2"], cfg, **fault)
        assert (other - want).abs().max() > 1e-3, fault


def test_fused_gate_up_layout_round_trips():
    w1, w3 = torch.randn(3, 4, 32), torch.randn(3, 4, 32)
    w13 = mla_moe.fuse_w13(w1, w3)
    assert torch.equal(w13[..., :8], w1[..., :8]) and torch.equal(w13[..., 8:16], w3[..., :8])
    g, u = moe_experts.split_w13(w13)
    assert torch.equal(g, w1) and torch.equal(u, w3)


def test_pairwise_rope_keeps_the_published_dot_products():
    """The port rotates pairs in place, the published code de-interleaves them
    and rotates halves: the same dot products between a query and a key."""
    g = torch.Generator().manual_seed(9)
    q, k = torch.randn(5, 16, generator=g), torch.randn(5, 16, generator=g)
    pos = torch.arange(5) * 7
    cfg = _cfg(qk_rope_head_dim=16)
    cos, sin = mla_moe.rope_tables(cfg, pos)
    got = mla_moe.rope_pairs(q, cos, sin) @ mla_moe.rope_pairs(k, cos, sin).T
    want = ref.rope(q, pos, cfg.rope_theta) @ ref.rope(k, pos, cfg.rope_theta).T
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def engine():
    from callireader_tpu_torch.runtime.engine import build_engine

    return build_engine("moonlight-tiny", device="cpu", policy=FP32_POLICY)


def test_tiny_engine_page_route_matches_a_plain_greedy_loop(engine):
    """The batch route (box stage, batch_build_rows, batch_prepare with every
    chunk enqueued, batch_decode) against a greedy loop over the reference
    from the same spliced prompt rows: the same token ids."""
    from callireader_tpu_torch.models import mla_moe as m
    from callireader_tpu_torch.utils import profiling

    rng = np.random.RandomState(0)
    pages = [rng.randint(60, 255, (96, 72, 3), np.uint8) for _ in range(2)]
    touched0 = m.EXPERTS_TOUCHED.counter.launches
    rows = engine.batch_build_rows(pages, ["read it"] * 2, ordered_lists=engine.batch_sort_boxes(pages))
    T = 6
    prepared = engine.batch_prepare([], [], prepared_rows=rows, max_new_tokens=T, repetition_penalty=1.0)
    engine.batch_decode(prepared)
    tokens, lengths = prepared["tokens"].numpy(), prepared["lengths"].numpy()
    cfg, tree = engine.cfg.llm, engine.params["llm"]
    drawn = dict(tree, moe=dict(tree["moe"]))
    drawn["moe"]["w1"], drawn["moe"]["w3"] = moe_experts.split_w13(tree["moe"]["w13"].flatten(0, 1))
    Lm = cfg.moe_layers
    drawn["moe"]["w1"] = drawn["moe"]["w1"].unflatten(0, (Lm, -1))
    drawn["moe"]["w3"] = drawn["moe"]["w3"].unflatten(0, (Lm, -1))
    bucket = rows["bucket"]
    eos = prepared["gen_cfg"].eos_token_ids
    for b in range(2):
        n = int(rows["mask"][b].sum())
        x = rows["embeds"][b, bucket - n:].float()
        want = []
        for j in range(T):
            pos = torch.cat([torch.arange(n), bucket + torch.arange(j)])
            nxt = int(_ref_logits(cfg, drawn, x, pos)[-1].argmax())
            want.append(nxt)
            if nxt in eos:
                break
            x = torch.cat([x, tree["tok_embeddings"][nxt][None].float()])
        assert tokens[b, :lengths[b]].tolist() == want
    assert m.EXPERTS_TOUCHED.counter.launches > touched0  # read back with the tokens
    assert "moe.experts_touched" in profiling.counters_report()
    assert "moe.rows" in profiling.counters_report()


def test_the_other_serving_paths_refuse_the_family(engine):
    from callireader_tpu_torch.runtime import generate as gen
    from callireader_tpu_torch.runtime.engine import build_engine
    from callireader_tpu_torch.runtime.paged_cache import PagedBatcher
    from callireader_tpu_torch.runtime.serving import ContinuousBatcher

    llm, cfg = engine.params["llm"], engine.cfg.llm
    for server in (ContinuousBatcher, PagedBatcher):
        with pytest.raises(NotImplementedError, match="batch route"):
            server(llm, cfg)
    with pytest.raises(NotImplementedError, match="beam"):
        gen.beam_generate_from_embeds(llm, cfg, torch.zeros(1, 4, cfg.hidden_size), torch.ones(1, 4),
                                      gen_cfg=gen.GenerateConfig(num_beams=2, max_new_tokens=2),
                                      max_cache_len=8)
    with pytest.raises(ValueError, match="bf16"):
        build_engine("moonlight-tiny", device="cpu", quant="int8")
    with pytest.raises(NotImplementedError, match="mesh"):
        mla_moe.prefill(llm, cfg, inputs_embeds=torch.zeros(1, 2, cfg.hidden_size),
                        attention_mask=torch.ones(1, 2), max_len=4, mesh=object())


def test_the_preset_holds_the_published_widths():
    c = get_config("moonlight-16b-a3b")
    llm = c.llm
    assert (llm.hidden_size, llm.num_hidden_layers, llm.num_attention_heads, llm.kv_lora_rank) == (2048, 27, 16, 512)
    assert (llm.qk_nope_head_dim, llm.qk_rope_head_dim, llm.v_head_dim, llm.latent_dim) == (128, 64, 128, 576)
    assert (llm.n_routed_experts, llm.num_experts_per_tok, llm.n_shared_experts) == (64, 6, 2)
    assert (llm.intermediate_size, llm.moe_intermediate_size, llm.vocab_size) == (11264, 1408, 163840)
    assert llm.routed_scaling_factor == 2.446 and llm.rope_theta == 50000.0
    assert c.resampler.out_dim == 2048 and c.char_vision.image_size == 224
    assert (mla_decode.SUPPORTED_SHAPES[0] == (llm.num_attention_heads, llm.kv_lora_rank, llm.qk_rope_head_dim))
    assert mla_prefill.SUPPORTED_SHAPES[0] == (llm.qk_head_dim, llm.v_head_dim)


# ------------------------------------------------------------ card-only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [8, 4096])
def test_grouped_expert_kernel_matches_its_plain_version(cuda, tokens):
    """At the cell's widths (E 2048, Me 1408, 64 experts, 6 a token): a decode
    step's 8 tokens (the decode tiles) and a prefill block (the prefill
    tiles). Tolerance: the bf16 rounding of each expert's output (the two
    sum the products in another order) plus 1e-3 of the output's scale."""
    cfg = get_config("moonlight-16b-a3b").llm
    g = torch.Generator(device=cuda).manual_seed(tokens)
    n, E, Me = cfg.n_routed_experts, cfg.hidden_size, cfg.moe_intermediate_size
    h = torch.randn((tokens, E), generator=g, device=cuda).bfloat16()
    w13 = (torch.randn((n, E, 2 * Me), generator=g, device=cuda) * 0.02).bfloat16()
    w2 = (torch.randn((n, Me, E), generator=g, device=cuda) * 0.02).bfloat16()
    gate = torch.randn((E, n), generator=g, device=cuda) * 0.02
    sel, w = mla_moe.route({"gate": gate, "gate_bias": torch.zeros(n, device=cuda)}, cfg, h)
    t0, t1 = torch.zeros(1, dtype=torch.int64, device=cuda), torch.zeros(1, dtype=torch.int64, device=cuda)
    launches = moe_experts.KERNEL_GATE_UP.launches
    got = moe_experts.moe_experts(h, sel, w, w13, w2, tally=t0)
    want = moe_experts.moe_experts_reference(h, sel, w, w13, w2, tally=t1)
    torch.cuda.synchronize()
    assert moe_experts.KERNEL_GATE_UP.launches == launches + 1 and int(t0) == int(t1)
    err = (got.float() - want.float()).abs()
    print("moe_experts", tokens, float(err.max()), float(want.float().abs().max()),
          float((err - 2 ** -7 * want.float().abs()).max()))
    assert float(err.max()) <= 2 * 2 ** -8 * float(want.float().abs().max()) + 1e-3


@pytest.mark.cuda
def test_latent_decode_kernel_matches_its_plain_version(cuda):
    """A page batch's decode shape: B 8, 16 heads, 576-wide latent rows, a
    4608-slot cache, left-padded prompts of 3.1-3.4k keys plus decode slots.
    The plain version in fp32 on the same bf16 inputs; the excess over the
    output's bf16 rounding within ATOL (fp32 sums in another order, the
    splits merged; P split into two bf16 parts)."""
    B, H, R, Dr, T = 8, 16, 512, 64, 4608
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((B, H, R + Dr), generator=g, device=cuda).bfloat16()
    kv = torch.randn((B, T, R + Dr), generator=g, device=cuda).bfloat16()
    valid = torch.zeros((B, T), dtype=torch.int32, device=cuda)
    slot = torch.tensor([3584 + 200], device=cuda)
    for b in range(B):
        valid[b, 3584 - 3100 - 40 * b:3584 + 201] = 1
    got = mla_decode.latent_decode(q, kv, valid, slot, R, 192 ** -0.5)
    want = mla_decode.latent_decode_reference(q.float(), kv.float(), valid, slot, R, 192 ** -0.5)
    torch.cuda.synchronize()
    print("latent_decode excess", tolerance.excess_error(got, want))
    assert tolerance.excess_error(got, want) <= tolerance.ATOL["latent_decode"]


@pytest.mark.cuda
def test_latent_prefill_kernel_matches_its_plain_version(cuda):
    """Dqk 192, Dv 128, 16 heads, left-padded rows of 1024 slots, v a strided
    view as the model passes it. The plain version in fp32; tolerance as
    flash_attention's (the same loop)."""
    B, S, H = 2, 1024, 16
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((B, S, H, 192), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, S, H, 192), generator=g, device=cuda).bfloat16()
    kv = torch.randn((B, S, H, 256), generator=g, device=cuda).bfloat16()
    seg = torch.zeros((B, S), dtype=torch.int32, device=cuda)
    seg[1, :300] = -1
    got = mla_prefill.mla_prefill_attention(q, k, kv[..., 128:], seg, scale=192 ** -0.5)
    want = mla_prefill.mla_prefill_reference(q.float(), k.float(), kv[..., 128:].float(), seg, 192 ** -0.5)
    torch.cuda.synchronize()
    print("mla_prefill excess", tolerance.excess_error(got, want))
    assert tolerance.excess_error(got, want) <= tolerance.ATOL["mla_prefill"]
