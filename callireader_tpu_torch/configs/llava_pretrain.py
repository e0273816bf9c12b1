"""LLaVA stage-1 pretrain recipe (projector alignment only).

Parity target: train/xtuner/configs/llava/internlm2_chat_7b_clip_vit_large_
p14_336/pretrain/..._e1_gpu8_pretrain.py — LLM and ViT frozen, projector
trains at lr 1e-3, batch 32 x accum 1, warmup 3% cosine, 1 epoch,
max_length = 2048 - (336/14)^2 image tokens."""


def config():
    return dict(
        preset="callireader-8b",
        task="llava_pretrain",
        freeze_llm=True,
        freeze_vit=True,
        batch_size=32,
        accumulative_counts=1,
        lr=1e-3,
        betas=(0.9, 0.999),
        weight_decay=0.0,
        max_norm=1.0,
        warmup_ratio=0.03,
        max_length=2048 - (336 // 14) ** 2,
        max_epochs=1,
    )
