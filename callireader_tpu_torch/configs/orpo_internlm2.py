"""ORPO preference-tuning recipe (reference-free odds-ratio preference).

Parity target: train/xtuner/configs/orpo/internlm/
internlm2_chat_1_8b_orpo_full.py — loss_beta 0.1, batch 1 x accum 16,
AdamW lr 5e-6 betas (0.9, 0.999) max-norm 1, warmup 3% cosine,
max_length 2048, 3 epochs."""


def config():
    return dict(
        preset="callireader-8b",
        task="orpo",
        beta=0.1,
        batch_size=1,
        accumulative_counts=16,
        lr=5e-6,
        betas=(0.9, 0.999),
        weight_decay=0.0,
        max_norm=1.0,
        warmup_ratio=0.03,
        max_length=2048,
        max_epochs=3,
    )
