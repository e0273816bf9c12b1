"""OrderFormer reading-order training recipe (reference models/model.py:351:
AdamW lr 2e-4 amsgrad, cosine warm restarts T_0=10 T_mult=2, MSE, bs 4)."""


def config():
    return dict(
        task="orderformer",
        batch_size=4,
        lr=2e-4,
        weight_decay=0.0,
        epochs=1000,
        t0=10,
        t_mult=2,
    )
