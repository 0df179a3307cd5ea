"""Counterpart of pg_asr_tpu/parallel/: the switch-MoE transformer and
its expert placement (moe.py), the mesh spec and the parallel plan
(driver.py), the ranks of every mesh axis over torch.distributed
(mesh.py), Megatron tensor parallelism over ``model`` (tensor.py), the
GPipe schedule over ``pipe`` (pipeline.py), sequence parallelism over
``seq`` (sequence.py) and the fsdp placement (fsdp.py)."""
