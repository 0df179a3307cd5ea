"""Run configuration (counterpart of pg_asr_tpu/config.py).

The JAX package's config dataclasses import no jax, so the port reuses them
as they are: one ``config.json`` schema serves both packages. Code of the
port and its callers import them from here.
"""

from pg_asr_tpu.config import Config, FeatureConfig, ModelConfig

__all__ = ["Config", "FeatureConfig", "ModelConfig"]
