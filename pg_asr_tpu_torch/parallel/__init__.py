"""Counterpart of pg_asr_tpu/parallel/: the switch-MoE transformer and
its expert placement (moe.py), the mesh spec and the parallel plan
(driver.py), the ranks of the ``data``, ``model``, ``expert`` and ``fsdp``
axes over torch.distributed (mesh.py), Megatron tensor parallelism over
``model`` (tensor.py) and the fsdp placement (fsdp.py). The ``seq`` and
``pipe`` axes with ``--microbatches`` are ROADMAP.md queue 1 item 15b.3."""
