"""e-IT (embedding instruction tuning) recipe.

Parity target: train/xtuner/configs/internvl/v2/e-IT.py:51-126 — LoRA r=128
α=256 on attention+MLP projections, ViT and LLM frozen, projector trainable,
batch 2 × accum 2, AdamW lr 5e-5 betas (0.9, 0.999) wd 0.05 max-norm 1,
warmup 3% then cosine, max_length 8192, LengthGroupedSampler."""


def config():
    return dict(
        preset="callireader-8b",
        task="e_it",
        lora_rank=128,
        lora_alpha=256.0,
        freeze_llm=True,
        freeze_vit=True,
        batch_size=2,
        accumulative_counts=2,
        lr=5e-5,
        betas=(0.9, 0.999),
        weight_decay=0.05,
        max_norm=1.0,
        warmup_ratio=0.03,
        max_length=8192,
        max_epochs=1,
        length_grouped=True,
        save_steps=1000,
        save_total_limit=1,
    )
