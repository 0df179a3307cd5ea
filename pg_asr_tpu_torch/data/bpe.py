"""Byte-pair-encoding subword units and the corpus tokenizer dispatch
(counterpart of pg_asr_tpu/data/bpe.py).

``BpeAlphabet`` has ``data.text.Alphabet``'s interface (``size``,
``encode``, ``decode``, ``piece``, ``save``/``load``, pad/blank at index
0), so models, losses, decoders and metrics take it unchanged. Scheme: a
SentencePiece-style word-start marker; each word is '▁' plus its
characters, training merges the most frequent adjacent pair (ties broken
lexicographically) until the vocabulary reaches its target size, encoding
replays the merges in learned order, decoding joins the tokens and maps
'▁' back to spaces. ``bpe.vocab`` (one token per line, pad implicit) and
``bpe.merges`` ("left right" per line, in merge order) are written next to
the corpus TSVs by ``--mode preproc --units bpe``, byte for byte those of
the JAX package.

``encode_batch`` runs the native segmenter (``native_bpe``, a g++ build
of native/pgasr_bpe.cpp) where it builds and the Python one elsewhere;
``SEGMENTED`` counts the batches each encoded.
"""

from __future__ import annotations

import os
import re
import threading
from collections import Counter
from dataclasses import dataclass

from .text import BLANK_ID, PAD, Alphabet

MARKER = "▁"  # word-start marker (SentencePiece convention)

# batches encoded by each segmenter, for the caller to read (the loader's
# threads add to it under the lock)
SEGMENTED = {"native": 0, "python": 0}
_segmented_lock = threading.Lock()


def _count(which: str) -> None:
    with _segmented_lock:
        SEGMENTED[which] += 1


def _pair_counts(words: dict[tuple[str, ...], int]) -> Counter:
    counts: Counter = Counter()
    for syms, freq in words.items():
        for a, b in zip(syms, syms[1:]):
            counts[(a, b)] += freq
    return counts


def _merge_word(syms: tuple[str, ...], pair: tuple[str, str]) -> tuple[str, ...]:
    out = []
    i = 0
    merged = pair[0] + pair[1]
    while i < len(syms):
        if i + 1 < len(syms) and syms[i] == pair[0] and syms[i + 1] == pair[1]:
            out.append(merged)
            i += 2
        else:
            out.append(syms[i])
            i += 1
    return tuple(out)


def train_bpe(texts, vocab_size: int) -> "BpeAlphabet":
    """Learn a BPE vocabulary of at most vocab_size tokens, pad included."""
    words: dict[tuple[str, ...], int] = {}
    for t in texts:
        for w in t.split():
            key = tuple([MARKER] + list(w))
            words[key] = words.get(key, 0) + 1

    merges: list[tuple[str, str]] = []
    vocab = {s for syms in words for s in syms}
    while len(vocab) + 1 < vocab_size:  # +1 for pad
        counts = _pair_counts(words)
        if not counts:
            break
        # the most frequent pair; ties broken lexicographically
        (a, b), freq = min(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        if freq < 2:
            break  # merging singletons only memorises the corpus
        merges.append((a, b))
        vocab.add(a + b)
        words = {_merge_word(syms, (a, b)): f for syms, f in words.items()}
    return BpeAlphabet(tuple([PAD] + sorted(vocab)), tuple(merges))


@dataclass(frozen=True)
class BpeAlphabet:
    """Subword symbol table + merge list ('<pad>'/blank at index 0)."""

    symbols: tuple[str, ...]
    merges: tuple[tuple[str, str], ...]

    @property
    def size(self) -> int:
        return len(self.symbols)

    @property
    def char2ind(self) -> dict[str, int]:
        return {s: i for i, s in enumerate(self.symbols)}

    @property
    def ind2char(self) -> dict[int, str]:
        return {i: s for i, s in enumerate(self.symbols)}

    def piece(self, i: int) -> str:
        """Printable text of one token (the marker as a space)."""
        return self.symbols[i].replace(MARKER, " ")

    def _segment(self, word: str) -> list[str]:
        syms = tuple([MARKER] + list(word))
        for pair in self.merges:
            if len(syms) < 2:
                break
            syms = _merge_word(syms, pair)
        return list(syms)

    def encode(self, text: str) -> list[int]:
        c2i = self.char2ind
        ids: list[int] = []
        for w in text.split():
            for tok in self._segment(w):
                if tok in c2i:
                    ids.append(c2i[tok])
                else:  # unseen symbol: its known characters, the rest dropped
                    ids.extend(c2i[ch] for ch in tok if ch in c2i)
        return ids

    def encode_batch(self, texts) -> list[list[int]]:
        """Encode a batch: the native segmenter where it builds (the same
        ids as ``encode``), else ``encode`` per text; ``SEGMENTED`` counts
        the batch under the one that ran."""
        native = getattr(self, "_native", None)
        if native is None:
            from . import native_bpe

            native = (native_bpe.NativeBpe(self.symbols, self.merges)
                      if native_bpe.native_available() else False)
            object.__setattr__(self, "_native", native)  # frozen dataclass
        if native:
            out = native.encode_batch(list(texts))
            _count("native")
            return out
        out = [self.encode(t) for t in texts]
        _count("python")
        return out

    def decode(self, ids) -> str:
        i2c = self.ind2char
        s = "".join(i2c[int(i)] for i in ids if int(i) != BLANK_ID)
        # collapse runs of markers (a word whose every character was
        # unknown leaves a bare marker behind)
        return re.sub(r"\s+", " ", s.replace(MARKER, " ")).strip()

    def save(self, vocab_path: str) -> None:
        with open(vocab_path, "w", encoding="utf-8") as fo:
            for s in self.symbols[1:]:  # pad implicit, like alphabet.txt
                fo.write(s + "\n")
        with open(self._merges_path(vocab_path), "w", encoding="utf-8") as fo:
            for a, b in self.merges:
                fo.write(f"{a} {b}\n")

    @staticmethod
    def _merges_path(vocab_path: str) -> str:
        root, _ = os.path.splitext(vocab_path)
        return root + ".merges"

    @staticmethod
    def load(vocab_path: str) -> "BpeAlphabet":
        with open(vocab_path, encoding="utf-8") as fo:
            syms = [ln.rstrip("\n") for ln in fo if ln.rstrip("\n")]
        merges: list[tuple[str, str]] = []
        mp = BpeAlphabet._merges_path(vocab_path)
        if os.path.exists(mp):
            with open(mp, encoding="utf-8") as fo:
                for ln in fo:
                    parts = ln.rstrip("\n").split(" ")
                    if len(parts) == 2:
                        merges.append((parts[0], parts[1]))
        return BpeAlphabet(tuple([PAD] + syms), tuple(merges))


def load_tokenizer(corpus_path: str, units: str):
    """'char' -> <corpus_path>/alphabet.txt; 'bpe' -> bpe.vocab and
    bpe.merges (written by ``--mode preproc --units bpe``)."""
    if units == "bpe":
        path = os.path.join(corpus_path, "bpe.vocab")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found - run --mode preproc --units bpe "
                "--bpe_vocab_size N first")
        return BpeAlphabet.load(path)
    if units != "char":
        raise ValueError(f"unknown text units {units!r}")
    return Alphabet.load(os.path.join(corpus_path, "alphabet.txt"))
