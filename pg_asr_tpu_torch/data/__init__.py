"""Corpus input (counterpart of pg_asr_tpu/data/): manifests, WAV decode,
padded int16 batches (decode threads, a built-batch cache), a prefetch
thread, the native C++ WAV decoder and the synthetic corpora, in numpy.
A batch's arrays go to the device with ``torch.from_numpy``."""

from .dataset import (Batch, BatchIterator, PrefetchIterator, load_manifest,
                      make_phonetic_corpus, make_synthetic_corpus)
from .text import BLANK_ID, Alphabet

__all__ = ["BLANK_ID", "Alphabet", "Batch", "BatchIterator",
           "PrefetchIterator", "load_manifest", "make_phonetic_corpus",
           "make_synthetic_corpus"]
