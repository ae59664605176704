"""Parallelism (counterpart of ``paddle_tpu/parallel``): so far only the
one-card routing of the mixture-of-experts op (``moe``); the mesh, the
sharded executor and the expert-parallel FFN wait for the multi-GPU
item of ``ROADMAP.md``."""
