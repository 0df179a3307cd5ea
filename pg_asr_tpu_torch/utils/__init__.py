"""Utilities of the port (counterpart of pg_asr_tpu/utils/)."""
