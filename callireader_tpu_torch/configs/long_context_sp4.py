"""Long-context SFT recipe with Ulysses sequence parallelism.

Parity target: train/xtuner/configs/llama_speed_benchmark/llama2_7b/
llama2_7b_full_alpaca_enzh_32k_sp4.py — 32k packed sequences split over a
4-way seq mesh axis (the reference's sequence_parallel_size=4 + varlen
flash attention), full-parameter training, lr 2e-5 cosine.
The train CLI reads the recipe's hyperparameters and turns
``sequence_parallel_size`` into a "seq" axis of its mesh (Ulysses,
parallel/ulysses.py), one process per rank under torchrun."""


def config():
    return dict(
        preset="callireader-8b",
        task="sft",
        sequence_parallel_size=4,
        pack_to_max_length=True,
        batch_size=1,
        accumulative_counts=1,
        lr=2e-5,
        betas=(0.9, 0.999),
        weight_decay=0.0,
        max_norm=1.0,
        warmup_ratio=0.03,
        max_length=32768,
        max_epochs=1,
    )
