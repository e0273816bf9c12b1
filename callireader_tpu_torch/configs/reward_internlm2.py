"""Reward-model training recipe.

Parity target: train/xtuner/configs/reward_model/internlm/
internlm2_chat_1_8b_reward_full_ultrafeedback.py — focal ranking loss with
log-barrier length penalty, batch 4 x accum 16, AdamW lr 2e-5 max-norm 1,
warmup 3% cosine, max_length 2048, ONE epoch (reward models overfit past 1)."""


def config():
    return dict(
        preset="callireader-8b",
        task="reward",
        loss_type="focal",
        penalty_type="log_barrier",
        batch_size=4,
        accumulative_counts=16,
        lr=2e-5,
        betas=(0.9, 0.999),
        weight_decay=0.0,
        max_norm=1.0,
        warmup_ratio=0.03,
        max_length=2048,
        max_epochs=1,
    )
