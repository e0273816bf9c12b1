"""Generated config zoo: the full named recipe matrix (a copy of
callireader_tpu/configs/zoo.py; the same names and the same dicts).

Parity target: train/xtuner/configs/ — ~590 generated mmengine configs, one
file per (model x method x dataset x schedule) combination (e.g.
``internlm2_chat_7b_qlora_alpaca_e3``). The reference generates that matrix
with template scripts and ships the expansion; here the expansion IS a
function: every name is parsed back into its axes and synthesized on demand,
so ``list-cfg`` enumerates the whole zoo and ``copy-cfg``/``--config`` resolve
any member without 590 checked-in files.

Axes (the zoo does not name model families the rebuild cannot run; the
port's train CLI reads each member's hyperparameters, as the JAX CLI does):

  model    internlm2_tiny | internlm2_2b | internlm2_7b   (core.config presets)
  method   full | lora | qlora                            (train/lora, --qlora)
  dataset  the 21 map_fns of train/sft_data.MAP_FNS       (alpaca, oasst1, ...)
  schedule e1 | e2 | e3                                   (epochs)
  variant  ''              standard 2k packed
           _len8k          max_length 8192 (no packing)
           _sp4_32k        32k context over a seq=4 Ulysses mesh

plus the task specials per model x method: e_it, dpo, orpo, reward_model,
llava_pretrain, llava_finetune (hyperparams mirror the corresponding
reference config families; see each base dict).

Hyperparameters follow the xtuner family defaults: qlora r64 a16 lr 2e-4
batch 1 x accum 16 (configs/internlm/internlm2_chat_7b/*qlora*_e3.py), lora
ditto at fp precision, full lr 2e-5 accum 4; dpo beta 0.1 lr 5e-7; orpo
lr 5e-6; reward lr 2e-5; e-IT per configs/internvl/v2/e-IT.py.
"""

from __future__ import annotations

from typing import Dict, List

MODELS = {
    "internlm2_tiny": "callireader-tiny",
    "internlm2_2b": "callireader-2b",
    "internlm2_7b": "callireader-8b",
}

METHODS = ("full", "lora", "qlora")
SCHEDULES = {"e1": 1, "e2": 2, "e3": 3}
VARIANTS = ("", "_len8k", "_sp4_32k")

_BASE = dict(
    betas=(0.9, 0.999),
    weight_decay=0.0,
    max_norm=1.0,
    warmup_ratio=0.03,
    save_steps=500,
    save_total_limit=2,
)

_METHOD = {
    "qlora": dict(lora_rank=64, lora_alpha=16.0, lr=2e-4, batch_size=1,
                  accumulative_counts=16, quant_base=True),
    "lora": dict(lora_rank=64, lora_alpha=16.0, lr=2e-4, batch_size=1,
                 accumulative_counts=16),
    "full": dict(lora_rank=0, lr=2e-5, batch_size=1, accumulative_counts=4),
}

_TASKS = {
    "dpo": dict(task="dpo", beta=0.1, loss_type="sigmoid", lr=5e-7,
                max_length=2048, max_epochs=1),
    "orpo": dict(task="orpo", orpo_lambda=0.1, lr=5e-6, max_length=2048,
                 max_epochs=1),
    "reward_model": dict(task="reward", lr=2e-5, max_length=2048,
                         max_epochs=1),
    "e_it": dict(task="e_it", lora_rank=128, lora_alpha=256.0, lr=5e-5,
                 weight_decay=0.05, batch_size=2, accumulative_counts=2,
                 max_length=8192, max_epochs=1, length_grouped=True,
                 freeze_llm=True, freeze_vit=True),
    "llava_pretrain": dict(task="llava_pretrain", dataset_map_fn="llava",
                           lr=1e-3, batch_size=32, accumulative_counts=1,
                           max_length=2048, max_epochs=1,
                           freeze_llm=True, freeze_vit=True),
    "llava_finetune": dict(task="llava_finetune", dataset_map_fn="llava",
                           lr=2e-5, batch_size=16, accumulative_counts=1,
                           max_length=2048, max_epochs=1, freeze_vit=True),
}


def _datasets() -> List[str]:
    from callireader_tpu_torch.train.sft_data import MAP_FNS

    return sorted(MAP_FNS)


def list_zoo() -> List[str]:
    """Every generated recipe name (the xtuner configs/ expansion)."""
    names: List[str] = []
    for model in MODELS:
        for method in METHODS:
            for task in _TASKS:
                names.append(f"{model}_{method}_{task}")
            for ds in _datasets():
                for sched in SCHEDULES:
                    for var in VARIANTS:
                        names.append(f"{model}_{method}_{ds}_{sched}{var}")
    return names


def generate(name: str) -> Dict:
    """Parse a zoo name back into its axes and synthesize the recipe dict.
    Raises ValueError for names outside the matrix."""
    model = next(
        (m for m in sorted(MODELS, key=len, reverse=True)
         if name.startswith(m + "_")),
        None,
    )
    if model is None:
        raise ValueError(f"unknown zoo model in {name!r}")
    rest = name[len(model) + 1 :]
    method = next((m for m in METHODS if rest.startswith(m)), None)
    if method is None or rest[len(method) : len(method) + 1] not in ("_", ""):
        raise ValueError(f"unknown zoo method in {name!r}")
    rest = rest[len(method) + 1 :]

    cfg = dict(_BASE)
    cfg["preset"] = MODELS[model]
    cfg.update(_METHOD[method])

    if rest in _TASKS:
        cfg.update(_TASKS[rest])
        if method != "qlora":
            cfg.pop("quant_base", None)
        return cfg

    # sft matrix member: {dataset}_{schedule}[{variant}]
    variant = ""
    for var in ("_sp4_32k", "_len8k"):
        if rest.endswith(var):
            variant, rest = var, rest[: -len(var)]
            break
    ds, _, sched = rest.rpartition("_")
    if sched not in SCHEDULES or ds not in _datasets():
        raise ValueError(f"unknown zoo dataset/schedule in {name!r}")
    cfg.update(
        task="sft",
        dataset_map_fn=ds,
        prompt_template="internlm2_chat",
        max_length=2048,
        pack_to_max_length=True,
        max_epochs=SCHEDULES[sched],
    )
    if variant == "_len8k":
        cfg.update(max_length=8192, pack_to_max_length=False)
    elif variant == "_sp4_32k":
        cfg.update(
            max_length=32768,
            pack_to_max_length=False,
            sequence_parallel_size=4,
            mesh="data=2,seq=4",
        )
    return cfg
