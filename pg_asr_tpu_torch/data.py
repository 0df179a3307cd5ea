"""Corpus input (counterpart of pg_asr_tpu/data/).

The JAX package's data modules are numpy-only (manifests, WAV decode, padded
int16 batches, a prefetch thread, the synthetic corpus), so the port reuses
them as they are; a batch's arrays go to the device with
``torch.from_numpy``. Code of the port and its callers import them from here.
"""

from pg_asr_tpu.data.dataset import (BatchIterator, PrefetchIterator,
                                     load_manifest, make_synthetic_corpus)
from pg_asr_tpu.data.text import BLANK_ID, Alphabet

__all__ = ["BLANK_ID", "Alphabet", "BatchIterator", "PrefetchIterator",
           "load_manifest", "make_synthetic_corpus"]
