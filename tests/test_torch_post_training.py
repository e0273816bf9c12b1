"""The port's post-training modules against the JAX package on the CPU: SFT
data (the 21 map functions, the prompt templates, tokenization, packing and
its loader), the packed SFT loss, DPO / ORPO / reward losses and train
steps, linear RoPE, the recipe zoo and ``preprocess``.

Same parameters (the JAX tiny LLM + LoRA, moved by ``from_jax_params``), same
numpy data, tiny config, FP32 policy; the JAX side runs its reference
attention (``use_flash=False``), the port its training attention's plain
version. Tolerances (fp32, summation order only):
- data (map functions, token ids, labels, packed rows and batches, collated
  pairs, recipes, preprocess files): identical;
- losses: 1e-5 relative; metrics: 1e-5 relative or 1e-5 absolute (a margin
  is beta times a difference of sequence log-likelihoods of ~1e2, whose fp32
  sums differ by ~1e-6 between the two summation orders); every trainable
  leaf's gradient: 1e-5 relative L2 (a leaf whose gradient is zero in both,
  the ``a`` leaves of fresh adapters, is required to be exactly zero in the
  port);
- two train steps: each leaf's update (its change from the start) within
  1e-3 relative L2 of JAX's, every element within 1e-5 max abs, 1% of the
  learning rate (Adam's m / (sqrt(v) + eps) of an element whose gradient
  is near zero carries that gradient's rounding noise: seen up to 6e-6);
- linear RoPE: cos / sin within 1e-6, logits within 1e-5 max abs.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from callireader_tpu import configs as jconfigs
from callireader_tpu.cli import preprocess as jpre
from callireader_tpu.cli import train as jtrain_cli
from callireader_tpu.core.config import callireader_tiny
from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.models import internlm2 as jllm
from callireader_tpu.runtime.tokenizer import InternLM2Tokenizer as JTok
from callireader_tpu.train import dpo as jdpo
from callireader_tpu.train import e_it as jeit
from callireader_tpu.train import lora as jlora
from callireader_tpu.train import reward as jreward
from callireader_tpu.train import sft_data as jsft
from callireader_tpu.train import templates as jtpl
from callireader_tpu_torch import __main__ as tmain
from callireader_tpu_torch import configs as tconfigs
from callireader_tpu_torch.cli import preprocess as tpre
from callireader_tpu_torch.cli import train as ttrain_cli
from callireader_tpu_torch.core import config as tconfig
from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from callireader_tpu_torch.models import internlm2 as tllm
from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer as TTok
from callireader_tpu_torch.runtime.weights import from_jax_params
from callireader_tpu_torch.train import dpo as tdpo
from callireader_tpu_torch.train import e_it as teit
from callireader_tpu_torch.train import reward as treward
from callireader_tpu_torch.train import sft_data as tsft
from callireader_tpu_torch.train import templates as ttpl

JCFG = callireader_tiny()
TCFG = tconfig.callireader_tiny()
JTOK = JTok("callireader_tpu/assets/tokenizer.model")
TTOK = TTok()

# records of tests/test_sft_data.py and tests/test_completeness.py::test_map_fns,
# a few more rows a function
_MSAGENT = [
    {"from": "system", "value": "api list..."},
    {"from": "user", "value": "翻译这句话"},
    {"from": "assistant",
     "value": "好的<|startofthink|>```JSON\n{\"api_name\": \"translate\", \"parameters\": "
              "{\"text\": \"hi\"}}\n```<|endofthink|>"
              "<|startofexec|>```JSON\n{\"result\": \"你好\"}\n```<|endofexec|>翻译结果是你好"},
]
RECORDS = {
    "default": [{"input": "hi", "output": "yo"}],
    "alpaca": [{"instruction": "写一首诗", "input": "", "output": "好"},
               {"instruction": "翻译", "input": "hi", "output": "你好"},
               {"instruction": "x", "input": "y", "output": "<nooutput>"},
               {"instruction": "x", "output": "z"}],
    "alpaca_zh": [{"instruction_zh": "翻译", "input_zh": "hello", "output_zh": "你好"},
                  {"instruction_zh": "写", "input_zh": "<noinput>", "output_zh": "诗"}],
    "arxiv": [{"abstract": "We study X.", "title": "On X"}],
    "code_alpaca": [{"prompt": "sort a list", "completion": "sorted(x)"}],
    "colors": [{"description": "Color: deep sea blue", "color": "#003366"}],
    "crime_kg_assistant": [{"input": "盗窃罪", "output": "刑法第264条"}],
    "law_reference": [{"question": "合同无效怎么办", "answer": "依据民法典..."}],
    "llava": [{"conversations": [{"from": "gpt", "value": "skip"},
                                 {"from": "human", "value": "what is this <image>"},
                                 {"from": "gpt", "value": "a cat"},
                                 {"from": "human", "value": "color?"},
                                 {"from": "gpt", "value": "black"}]}],
    "llava_image_only": [{"conversations": [{"from": "human", "value": "<image>"},
                                            {"from": "gpt", "value": "a dog"}]}],
    "medical": [{"instruction": "头痛", "input": "三天", "output": "休息"},
                {"input": "发热", "output": "就医"}],
    "msagent_react": [{"conversations": _MSAGENT}, {"conversations": json.dumps(_MSAGENT)},
                      {"conversations": [{"from": "user", "value": "x"}]}],
    "oasst1": [{"text": "### Human: hi### Assistant: hello"},
               {"text": "### Human: a ### Assistant: b ### Human: c ### Assistant: d"}],
    "openai": [{"messages": [{"role": "user", "content": "q"},
                             {"role": "assistant", "content": "a"},
                             {"role": "assistant", "content": "orphan"}]}],
    "openorca": [{"system_prompt": "Be terse.", "question": "2+2?", "response": "4"}],
    "pretrain": [{"text": "raw corpus line"}],
    "sharegpt": [{"conversations": [{"from": "human", "value": "q"}, {"from": "gpt", "value": "a"},
                                    {"role": "user", "content": "q2"},
                                    {"role": "assistant", "content": "a2"}]}],
    "sql": [{"context": "CREATE TABLE t(a int)", "question": "count?",
             "answer": "SELECT COUNT(*) FROM t"}],
    "stack_exchange": [{"question": "How?", "response": "Thus."}],
    "tiny_codes": [{"prompt": "add", "response": "a + b"}],
    "wizardlm": [{"conversations": [{"from": "human", "value": "hi"},
                                    {"from": "gpt", "value": "hello"}]}],
}
PAIRS = [
    {"prompt": "这幅作品写了什么？", "chosen": "春眠不觉晓", "rejected": "不知道"},
    {"prompt": "作者是谁？", "chosen": "王羲之", "rejected": "颜真卿柳公权"},
]


def _t(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _flat(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in teit.flatten(tree).items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def llm():
    """The tiny LLM with rank-4 LoRA, every b drawn (so every a has a
    gradient), and a value head."""
    params = jllm.init_params(jax.random.PRNGKey(0), JCFG.llm, dtype=jnp.float32)
    params = jlora.add_lora(params, JCFG.llm, jax.random.PRNGKey(1), rank=4, alpha=8.0)
    rng = np.random.default_rng(0)
    layers = dict(params["layers"])
    for k in layers:
        if k.endswith("_lora_b"):
            layers[k] = jnp.asarray(rng.standard_normal(layers[k].shape, dtype=np.float32) * 0.02)
    return jreward.add_value_head(dict(params, layers=layers), JCFG.llm, jax.random.PRNGKey(2))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check_grads(t_grads, j_grads):
    assert sorted(t_grads) == sorted(j_grads)
    for k, g in t_grads.items():
        want, got = j_grads[k].numpy(), g.numpy()
        if not np.abs(want).max():
            assert not np.abs(got).max(), k  # fresh adapters' a: zero in both
            continue
        assert _rel_l2(got, want) <= 1e-5, (k, _rel_l2(got, want))


def _jax_value_and_grads(loss_fn, params):
    j_train, j_frozen = jeit.partition_params(params, jeit.TrainConfig())
    (loss, metrics), grads = jax.value_and_grad(
        lambda tr: loss_fn(jeit.merge_params(tr, j_frozen)), has_aux=True)(j_train)
    return loss, metrics, _flat(grads)


def _port_value_and_grads(loss_fn, params):
    train, frozen = teit.partition_params(_t(params), teit.TrainConfig())
    flat = teit.flatten(train)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    loss, metrics = loss_fn(teit.merge_params(train, frozen))
    return loss, metrics, dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))


# ---------------------------------------------------------------- SFT data


@pytest.mark.parametrize("name", sorted(jsft.MAP_FNS))
def test_map_fn_matches_jax(name):
    assert sorted(tsft.MAP_FNS) == sorted(jsft.MAP_FNS)
    for rec in RECORDS[name]:
        assert tsft.MAP_FNS[name](rec) == jsft.MAP_FNS[name](rec), rec


def test_prompt_templates_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in ttpl.PROMPT_TEMPLATES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jtpl.PROMPT_TEMPLATES.items()}
    assert ttpl.SYSTEM_TEMPLATE == jtpl.SYSTEM_TEMPLATE
    assert tsft.SYSTEM_PROMPTS == jsft.SYSTEM_PROMPTS


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_tokenize_conversation_matches_jax():
    convs = [
        [{"input": "问题", "output": "回答"}, {"input": "再问", "output": "再答"}],
        [{"system": "You are a poet.\n", "input": "写诗", "output": "春眠不觉晓"},
         {"system": "Now a critic.\n", "input": "评价", "output": "好"}],
    ]
    for conv in convs:
        for max_length in (8192, 11):
            _same_rows([tsft.tokenize_conversation(conv, TTOK, max_length)],
                       [jsft.tokenize_conversation(conv, JTOK, max_length)])


@pytest.mark.parametrize("template", [None, "internlm2_chat", "llama3_chat", "chatglm2",
                                      "qwen_chat", "gemma"])
def test_process_dataset_matches_jax(template):
    records = RECORDS["sharegpt"] + [
        {"conversations": [{"from": "human", "value": "你好"}, {"from": "gpt", "value": "你好！"}]},
        {"conversations": []}]
    for map_fn, recs in (("sharegpt", records), ("arxiv", RECORDS["arxiv"]),
                         ("openorca", RECORDS["openorca"])):
        _same_rows(tsft.process_dataset(recs, TTOK, map_fn=map_fn, template=template),
                   jsft.process_dataset(recs, JTOK, map_fn=map_fn, template=template))
    conv = [{"system": "sys", "input": "a", "output": "b"}, {"input": "c", "output": "d"}]
    if template is not None:
        _same_rows([ttpl.tokenize_with_template(conv, TTOK, template, 16)],
                   [jtpl.tokenize_with_template(conv, JTOK, template, 16)])


def _corpus(tmp_path):
    path = tmp_path / "corpus.jsonl"
    docs = [{"content": "春眠不觉晓，" * 20}, {"content": "hello world. " * 30},
            {"content": "处处闻啼鸟。" * 15}, {"content": "夜来风雨声"}, {"content": "花落知多少。" * 9}]
    path.write_text("\n".join(json.dumps(d, ensure_ascii=False) for d in docs) + "\n\n")
    return str(path)


def test_packed_dataset_and_loader_match_jax(tmp_path):
    path = _corpus(tmp_path)
    tds, jds = tsft.JsonlTextDataset(path), jsft.JsonlTextDataset(path)
    assert len(tds) == len(jds) == 5 and [tds[i] for i in range(5)] == [jds[i] for i in range(5)]
    tp, jp = tsft.PackedTextDataset(tds, TTOK, 128), jsft.PackedTextDataset(jds, JTOK, 128)
    _same_rows([tp[i] for i in range(len(tp))], [jp[i] for i in range(len(jp))])
    assert len(tp) >= 3 and max(int(tp[i]["segment_ids"].max()) for i in range(len(tp))) >= 2
    for seed in (0, 3):
        _same_rows(list(tsft.packed_loader(tp, 2, seed)), list(jsft.packed_loader(jp, 2, seed)))


def test_sft_packed_loss_and_grads_match_jax(tmp_path, llm):
    """A packed SFT batch (several documents a row, positions restarting at
    each) through e_it.eit_loss."""
    path = _corpus(tmp_path)
    packed = tsft.PackedTextDataset(tsft.JsonlTextDataset(path), TTOK, 128)
    batch = next(tsft.packed_loader(packed, 2, seed=1))
    assert (batch["segment_ids"].max(axis=1) >= 1).all()
    params = {"llm": llm}
    j_loss, j_m, j_grads = _jax_value_and_grads(
        lambda p: jeit.eit_loss(p, JCFG, _jb(batch), policy=J_FP32, use_flash=False, remat=False),
        params)
    t_loss, t_m, t_grads = _port_value_and_grads(
        lambda p: teit.eit_loss(p, TCFG, _tb(batch), policy=T_FP32, remat=True), params)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    assert int(t_m["n_tokens"]) == int(j_m["n_tokens"])
    _check_grads(t_grads, j_grads)


# ------------------------------------------------------- DPO, ORPO, reward


def test_preference_collate_matches_jax():
    for buckets in ((256, 512, 1024, 2048), (8, 16, 32)):
        got = tdpo.preference_collate(PAIRS, TTOK, buckets)
        want = jdpo.preference_collate(PAIRS, JTOK, buckets)
        _same_rows([got], [want])
    assert got["input_ids"].shape == (4, 16)


LOSSES = {
    "dpo": (lambda p, b: jdpo.dpo_loss(p, JCFG, b, jdpo.DPOConfig(), policy=J_FP32,
                                       use_flash=False),
            lambda p, b: tdpo.dpo_loss(p, TCFG, b, tdpo.DPOConfig(), policy=T_FP32, remat=True)),
    "dpo_smoothed": (
        lambda p, b: jdpo.dpo_loss(p, JCFG, b, jdpo.DPOConfig(beta=0.5, label_smoothing=0.1),
                                   policy=J_FP32, use_flash=False),
        lambda p, b: tdpo.dpo_loss(p, TCFG, b, tdpo.DPOConfig(beta=0.5, label_smoothing=0.1),
                                   policy=T_FP32)),
    "orpo": (lambda p, b: jdpo.dpo_loss(p, JCFG, b, jdpo.DPOConfig(loss_type="orpo"),
                                        policy=J_FP32, use_flash=False),
             lambda p, b: tdpo.dpo_loss(p, TCFG, b, tdpo.DPOConfig(loss_type="orpo"),
                                        policy=T_FP32)),
    "reward": (lambda p, b: jreward.reward_loss(p, JCFG, b, policy=J_FP32, use_flash=False),
               lambda p, b: treward.reward_loss(p, TCFG, b, policy=T_FP32, remat=True)),
}


@pytest.mark.parametrize("kind", sorted(LOSSES))
def test_preference_losses_and_grads_match_jax(kind, llm):
    batch = jdpo.preference_collate(PAIRS, JTOK, (32, 64))
    j_fn, t_fn = LOSSES[kind]
    j_loss, j_m, j_grads = _jax_value_and_grads(lambda p: j_fn(p, _jb(batch)), {"llm": llm})
    t_loss, t_m, t_grads = _port_value_and_grads(lambda p: t_fn(p, _tb(batch)), {"llm": llm})
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    assert sorted(t_m) == sorted(j_m)
    for k in j_m:
        np.testing.assert_allclose(t_m[k].item(), float(j_m[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    _check_grads(t_grads, j_grads)


def test_dpo_zero_adapter_loss_is_log2(llm):
    """Fresh adapters (b = 0): the policy is the reference, the loss log 2,
    and the a leaves' gradients exactly zero in both routes."""
    params = {"llm": dict(llm, layers={k: (jnp.zeros_like(v) if k.endswith("_lora_b") else v)
                                       for k, v in llm["layers"].items()})}
    batch = jdpo.preference_collate(PAIRS, JTOK, (32,))
    j_fn, t_fn = LOSSES["dpo"]
    _, _, j_grads = _jax_value_and_grads(lambda p: j_fn(p, _jb(batch)), params)
    t_loss, t_m, t_grads = _port_value_and_grads(lambda p: t_fn(p, _tb(batch)), params)
    np.testing.assert_allclose(t_loss.item(), np.log(2.0), rtol=1e-6)
    assert t_m["reward_margin"].item() == 0.0
    zero_a = [k for k, g in t_grads.items() if k.endswith("_lora_a")]
    assert len(zero_a) == 7 and all(not t_grads[k].abs().max() for k in zero_a)
    _check_grads(t_grads, j_grads)


STEPS = {
    "dpo": (lambda tx: jdpo.make_dpo_train_step(JCFG, jdpo.DPOConfig(), tx, policy=J_FP32,
                                                use_flash=False),
            lambda tx: tdpo.make_dpo_train_step(TCFG, tdpo.DPOConfig(), tx, policy=T_FP32)),
    "orpo": (lambda tx: jdpo.make_dpo_train_step(JCFG, jdpo.DPOConfig(loss_type="orpo"), tx,
                                                 policy=J_FP32, use_flash=False),
             lambda tx: tdpo.make_dpo_train_step(TCFG, tdpo.DPOConfig(loss_type="orpo"), tx,
                                                 policy=T_FP32)),
    "reward": (lambda tx: jreward.make_reward_train_step(JCFG, tx, policy=J_FP32, use_flash=False),
               lambda tx: treward.make_reward_train_step(TCFG, tx, policy=T_FP32)),
}


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_train_step_matches_jax(kind, llm):
    """Two updates from the same params and batch (the first at lr 0, the
    warm-up's start): metrics and every trainable leaf after each."""
    batch = jdpo.preference_collate(PAIRS, JTOK, (32,))
    kw = dict(learning_rate=1e-3, total_steps=10, warmup_ratio=0.1, grad_clip=0.5)
    j_state, j_frozen, j_tx = jeit.create_train_state({"llm": llm}, jeit.TrainConfig(**kw))
    t_state, t_frozen, t_tx = teit.create_train_state(_t({"llm": llm}), teit.TrainConfig(**kw))
    j_step, t_step = jax.jit(STEPS[kind][0](j_tx)), STEPS[kind][1](t_tx)
    start_leaves = {k: v.detach().clone() for k, v in teit.flatten(t_state.trainable).items()}
    for i in range(2):
        j_state, j_m = j_step(j_state, j_frozen, _jb(batch))
        t_state, t_m = t_step(t_state, t_frozen, _tb(batch))
        assert t_state.step == int(j_state.step) == i + 1
        for k in j_m:
            np.testing.assert_allclose(t_m[k].item(), float(j_m[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
        want = _flat(j_state.trainable)
        for k, v in teit.flatten(t_state.trainable).items():
            got, w, start = v.detach().numpy(), want[k].numpy(), start_leaves[k].numpy()
            np.testing.assert_allclose(got, w, atol=1e-5, rtol=0, err_msg=f"step {i + 1} {k}")
            if i:  # the first update runs at lr 0
                assert _rel_l2(got - start, w - start) <= 1e-3, (i, k, _rel_l2(got - start, w - start))
    moved = teit.flatten(t_state.trainable)["llm/layers/wq_lora_b"]
    assert not torch.equal(moved, _t(llm)["layers"]["wq_lora_b"])


def test_value_head_and_rewards_match_jax(llm):
    """v_head crosses with the tree; the rewards read each row's last valid
    token; add_value_head draws N(0, 1/(E+1)) from the caller's generator."""
    t_llm = _t(llm)
    assert torch.equal(t_llm["v_head"], torch.from_numpy(np.array(llm["v_head"])))
    batch = jdpo.preference_collate(PAIRS, JTOK, (32,))
    want = jreward.sequence_rewards(llm, JCFG.llm, _jb(batch), policy=J_FP32, use_flash=False)
    got = treward.sequence_rewards(t_llm, TCFG.llm, _tb(batch), policy=T_FP32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    head = treward.add_value_head({}, TCFG.llm, torch.Generator().manual_seed(0))["v_head"]
    E = TCFG.llm.hidden_size
    assert head.shape == (E, 1) and abs(head.std().item() * (E + 1) - 1) < 0.3


# ----------------------------------------------------------------- linear RoPE


def test_long_context_configs_match_jax():
    for target in (4, 512, 513, 1024, 1500):
        want = dataclasses.asdict(jreward.long_context_config(JCFG.llm, target))
        assert dataclasses.asdict(treward.long_context_config(TCFG.llm, target)) == want
        assert dataclasses.asdict(tllm.prepare_long_context(TCFG.llm, target)) == \
            dataclasses.asdict(jllm.prepare_long_context(JCFG.llm, target)) == want
    assert treward.long_context_config(TCFG.llm, 1500).rope_scaling_factor == 3.0


def test_linear_rope_matches_jax(llm):
    """The tiny preset (max_position_embeddings 512) at factor 2: positions
    past the native window, rows of packed segments."""
    jcfg = jllm.prepare_long_context(JCFG.llm, 1024)
    tcfg = tllm.prepare_long_context(TCFG.llm, 1024)
    assert tcfg.rope_scaling_type == "linear" and tcfg.rope_scaling_factor == 2.0
    rng = np.random.default_rng(3)
    ids = rng.integers(10, 1000, (2, 48)).astype(np.int32)
    pos = np.stack([np.arange(48) + 600, np.r_[np.arange(20), np.arange(28) + 900]]).astype(np.int32)
    seg = np.stack([np.zeros(48), np.r_[np.zeros(20), np.ones(28)]]).astype(np.int32)
    j_cos, j_sin = jllm.cos_sin_for(jcfg, jnp.asarray(pos), 48)
    t_cos, t_sin = tllm.cos_sin_for(tcfg, torch.from_numpy(pos), 48)
    np.testing.assert_allclose(t_cos.numpy(), np.asarray(j_cos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(t_sin.numpy(), np.asarray(j_sin), atol=1e-6, rtol=0)
    base_cos, _ = tllm.cos_sin_for(TCFG.llm, torch.from_numpy(pos), 48)
    assert not torch.allclose(base_cos, t_cos)  # the scaling changed the tables
    want = jllm.forward(llm, jcfg, input_ids=jnp.asarray(ids), positions=jnp.asarray(pos),
                        segment_ids=jnp.asarray(seg), policy=J_FP32, use_flash=False)
    got = tllm.forward(_t(llm), tcfg, input_ids=torch.from_numpy(ids),
                       positions=torch.from_numpy(pos), segment_ids=torch.from_numpy(seg),
                       policy=T_FP32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ---------------------------------------------------------------- zoo, recipes


def test_zoo_lists_and_resolves_like_jax():
    names = tconfigs.list_configs()
    assert names == jconfigs.list_configs() and len(names) == 1764
    assert tconfigs.list_configs(include_zoo=False) == jconfigs.list_configs(include_zoo=False)
    for name in names:
        assert tconfigs.get_config(name) == jconfigs.get_config(name), name
    for bad in ("internlm2_9b_lora_alpaca_e3", "internlm2_tiny_lora_alpaca_e9", "nonsense"):
        with pytest.raises(ValueError):
            tconfigs.get_config(bad)


@pytest.mark.parametrize("name", ["sft_internlm2_7b", "e_it", "internlm2_7b_qlora_alpaca_e3_sp4_32k",
                                  "internlm2_tiny_full_dpo"])
def test_copy_cfg_matches_jax(name, tmp_path, capsys):
    import importlib.util

    def load(path):
        spec = importlib.util.spec_from_file_location("_copied", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.config()

    (tmp_path / "t").mkdir()
    assert tmain.main(["copy-cfg", name, str(tmp_path / "t")]) == 0
    dst = tmp_path / "t" / f"{name}_copy.py"
    assert f"copied to {dst}" in capsys.readouterr().out
    want = jconfigs.copy_config(name, str(tmp_path / "j.py"))
    assert load(str(dst)) == load(want) == jconfigs.get_config(name)
    assert tconfigs.copy_config(name, str(tmp_path / "f.py")) == str(tmp_path / "f.py")


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("config", ["e_it", "sft_internlm2_7b", "reward_internlm2",
                                    "internlm2_7b_qlora_alpaca_e3", "internlm2_tiny_full_dpo",
                                    "internlm2_2b_lora_oasst1_e2_len8k", "copied"])
def test_train_config_sets_jax_flag_defaults(config, tmp_path, monkeypatch):
    """``train --config`` takes the same flag defaults from a recipe as the
    JAX CLI (tests/test_completeness.py::test_train_config_recipe_defaults),
    a zoo name or a copied file: each CLI's parsed arguments are caught
    before it builds anything."""
    import argparse

    if config == "copied":
        config = jconfigs.copy_config("sft_internlm2_7b", str(tmp_path))
    parsed = []
    parse_args = argparse.ArgumentParser.parse_args

    def catch(self, *a, **kw):
        parsed.append(vars(parse_args(self, *a, **kw)))
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    for main in (jtrain_cli.main, ttrain_cli.main):
        with pytest.raises(_Parsed):
            main(["--data", "x.jsonl", "--config", config])
    want, got = parsed
    assert {k: v for k, v in got.items() if k != "device"} == want
    assert ttrain_cli._load_recipe(config) == jtrain_cli._load_recipe(config)


# ------------------------------------------------------------------ preprocess


def test_preprocess_arxiv_and_refcoco_match_jax(tmp_path, capsys):
    """The synthetic inputs of tests/test_completeness.py::
    test_preprocess_arxiv_and_refcoco: the files the port writes equal the
    JAX package's byte for byte; the mode prints the same."""
    src = tmp_path / "arxiv.jsonl"
    src.write_text("\n".join([
        json.dumps({"categories": "cs.CL stat.ML", "update_date": "2021-05-01", "title": "keep"}),
        json.dumps({"categories": "math.CO", "update_date": "2021-05-01", "title": "drop-cat"}),
        json.dumps({"categories": "cs.CL", "update_date": "2019-01-01", "title": "drop-date"}),
        "not json",
        "",
    ]))
    ann = tmp_path / "refs.json"
    ann.write_text(json.dumps([
        {"sents": "the cat", "bbox": [10, 20, 30, 40], "height": 100, "width": 100,
         "image": "img/1.jpg"},
        {"sents": "左边的字", "bbox": [0, 0, 50, 25], "height": 200, "width": 100,
         "image": "img/2.jpg", "id": 7},
    ], ensure_ascii=False))
    runs = [["arxiv", str(src), "{dst}", "--categories", "cs.CL"],
            ["arxiv", str(src), "{dst}", "--categories", "math.CO", "cs.CL", "--start-date",
             "2018-06-01"],
            ["refcoco", "--ann-path", str(ann), "--save-path", "{dst}"],
            ["refcoco", "--ann-path", str(ann), "--save-path", "{dst}", "--inv", "--image-path",
             "/data/"]]
    for i, run in enumerate(runs):
        out = {}
        for name, main in (("jax", jpre.main), ("port", lambda a: tmain.main(["preprocess", *a]))):
            dst = tmp_path / f"{name}{i}.json"
            assert main([a.format(dst=dst) for a in run]) == 0
            out[name] = (capsys.readouterr().out.replace(str(dst), "DST"), dst.read_bytes())
        assert out["port"] == out["jax"], run
    assert tpre.preprocess_arxiv(str(src), str(tmp_path / "a.json"), ["cs.CL"], "2020-01-01") == 1
