"""The asset trainers' command lines (ports of scripts/train_orderformer.py
and scripts/train_detector.py): ``python -m callireader_tpu_torch.scripts.<name>``."""
