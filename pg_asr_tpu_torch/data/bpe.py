"""Corpus tokenizer dispatch (counterpart of pg_asr_tpu/data/bpe.py
``load_tokenizer``). Character units are ported; BPE subword units are not
(ROADMAP.md)."""

from __future__ import annotations

import os

from .text import Alphabet


def load_tokenizer(corpus_path: str, units: str) -> Alphabet:
    """'char' -> <corpus_path>/alphabet.txt; 'bpe' raises."""
    if units == "bpe":
        raise NotImplementedError(
            "BPE units (text.units='bpe') are not yet ported to "
            "pg_asr_tpu_torch (see ROADMAP.md); use the JAX package "
            "(main.py) for it")
    if units != "char":
        raise ValueError(f"unknown text units {units!r}")
    return Alphabet.load(os.path.join(corpus_path, "alphabet.txt"))
