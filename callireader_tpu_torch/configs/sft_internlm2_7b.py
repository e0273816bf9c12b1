"""LLM-only SFT recipe (xtuner SupervisedFinetune defaults for internlm2-7b:
qlora-style LoRA r=64 α=16, AdamW lr 2e-4, warmup 3% cosine, max_length 2048,
pack_to_max_length)."""


def config():
    return dict(
        preset="callireader-8b",
        task="sft",
        lora_rank=64,
        lora_alpha=16.0,
        batch_size=1,
        accumulative_counts=16,
        lr=2e-4,
        betas=(0.9, 0.999),
        weight_decay=0.0,
        max_norm=1.0,
        warmup_ratio=0.03,
        max_length=2048,
        pack_to_max_length=True,
        max_epochs=3,
    )
