"""Parallelism on torch.distributed: the mesh layer (spmd), the
head-sharded attention wrappers (tp_attention), Ulysses sequence
parallelism (ulysses) and the gloo dry run of every stage (dryrun)."""
