"""Counterpart of pg_asr_tpu/parallel/: so far the switch-MoE transformer
on one device (moe.py). The device meshes (data / model / expert / fsdp /
pipe / seq) and the expert axis's sharding rules are ROADMAP.md queue 1
item 15b."""
