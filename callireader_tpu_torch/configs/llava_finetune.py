"""LLaVA stage-2 instruction finetune recipe.

Parity target: train/xtuner/configs/llava/internlm2_chat_7b_clip_vit_large_
p14_336/finetune/..._e1_gpu8_finetune.py — full LLM + projector training
(ViT frozen), lr 2e-5, batch 8 x accum 2, warmup 3% cosine, 1 epoch."""


def config():
    return dict(
        preset="callireader-8b",
        task="llava_finetune",
        freeze_llm=False,
        freeze_vit=True,
        batch_size=8,
        accumulative_counts=2,
        lr=2e-5,
        betas=(0.9, 0.999),
        weight_decay=0.0,
        max_norm=1.0,
        warmup_ratio=0.03,
        max_length=2048 - (336 // 14) ** 2,
        max_epochs=1,
    )
