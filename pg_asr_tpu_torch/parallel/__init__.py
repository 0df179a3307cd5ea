"""Counterpart of pg_asr_tpu/parallel/: the switch-MoE transformer (moe.py),
the mesh spec and its router (driver.py) and the ``data`` axis over
torch.distributed (mesh.py). The other axes are ROADMAP.md queue 1 items
15b.2 (``expert``: the expert stacks' sharding rules) and 15b.3
(``model``, ``fsdp``, ``seq``, ``pipe`` with ``--microbatches``)."""
