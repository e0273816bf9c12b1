"""The command lines of the JAX repository's scripts/, ported: the asset
trainers (``train_orderformer``, ``train_detector``, ``train_callialign``)
and the measurement scripts (``bench_decode``, ``bench_serving``,
``bench_http``, ``bench_prefix``, ``bench_train_step``, ``bench_vit``,
``bench_8b_int8``, ``mb_scan_int8``; their shared helpers in
``bench_common``): ``python -m callireader_tpu_torch.scripts.<name>``."""
