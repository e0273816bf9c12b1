"""DPO preference-tuning recipe (xtuner configs/dpo defaults: beta 0.1,
lr 5e-7 cosine, max_length 2048)."""


def config():
    return dict(
        preset="callireader-8b",
        task="dpo",
        beta=0.1,
        loss_type="sigmoid",
        batch_size=1,
        accumulative_counts=16,
        lr=5e-7,
        weight_decay=0.0,
        max_norm=1.0,
        warmup_ratio=0.03,
        max_length=2048,
        max_epochs=1,
    )
