"""Corpus input (counterpart of pg_asr_tpu/data/): manifests, WAV decode,
padded int16 batches, a prefetch thread and the synthetic corpus, in numpy.
A batch's arrays go to the device with ``torch.from_numpy``."""

from .dataset import (Batch, BatchIterator, PrefetchIterator, load_manifest,
                      make_synthetic_corpus)
from .text import BLANK_ID, Alphabet

__all__ = ["BLANK_ID", "Alphabet", "Batch", "BatchIterator",
           "PrefetchIterator", "load_manifest", "make_synthetic_corpus"]
