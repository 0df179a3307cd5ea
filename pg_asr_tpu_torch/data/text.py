"""Alphabets and manifest TSVs (counterpart of pg_asr_tpu/data/text.py).

Conventions of the JAX package, kept exactly:
  * index 0 is '<pad>' and doubles as the CTC blank;
  * alphabet.txt holds one symbol per line WITHOUT the pad entry; loaders
    prepend '<pad>'.
``normalize_text`` and ``preproc_text`` are ``--mode preproc``'s text
pass: the same normalised sentences and alphabet.txt as the JAX package.
"""

from __future__ import annotations

import csv
import os
import re
import unicodedata
from dataclasses import dataclass

PAD = "<pad>"
BLANK_ID = 0

# characters kept by the normalizer besides letters, per language
_LANG_EXTRA = {
    "en": "'",
    "eu": "'ñ",
    "es": "'ñáéíóúü",
    "fr": "'àâçéèêëîïôùûüÿœæ",
    "de": "'äöüß",
}


def normalize_text(text: str, lang: str = "en") -> str:
    """NFC, lower-case; keep letters (unicode-aware) and the language's
    extra set, turn whitespace and dashes, underscores and slashes into
    spaces, drop the rest (digits, punctuation); collapse whitespace."""
    text = unicodedata.normalize("NFC", text or "").lower()
    extra = set(_LANG_EXTRA.get(lang, "'"))
    out = []
    for ch in text:
        if ch.isalpha() or ch in extra:
            out.append(ch)
        elif ch.isspace() or ch in "-–—_/":
            out.append(" ")
    return re.sub(r"\s+", " ", "".join(out)).strip()


@dataclass(frozen=True)
class Alphabet:
    """Symbol table with '<pad>'/blank at index 0."""

    symbols: tuple[str, ...]  # includes PAD at 0

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
        """Printable text of one symbol (identity for characters; the BPE
        tokenizer maps its word-start marker to a space)."""
        return self.symbols[i]

    def encode(self, text: str) -> list[int]:
        c2i = self.char2ind
        return [c2i[c] for c in text if c in c2i]

    def encode_batch(self, texts) -> list[list[int]]:
        c2i = self.char2ind
        return [[c2i[c] for c in t if c in c2i] for t in texts]

    def decode(self, ids) -> str:
        i2c = self.ind2char
        return "".join(i2c[int(i)] for i in ids if int(i) != BLANK_ID)

    @staticmethod
    def from_symbols(chars) -> "Alphabet":
        syms = [PAD] + [c for c in chars if c != PAD]
        return Alphabet(tuple(syms))

    @staticmethod
    def from_texts(texts) -> "Alphabet":
        return Alphabet.from_symbols(sorted({c for t in texts for c in t}))

    @staticmethod
    def load(path: str) -> "Alphabet":
        """Read alphabet.txt (pad not stored) and prepend '<pad>'."""
        with open(path, "r", encoding="utf-8") as fo:
            lines = [ln.rstrip("\n") for ln in fo.readlines()]
        return Alphabet.from_symbols([ln for ln in lines if ln != ""])

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fo:
            for s in self.symbols[1:]:  # pad is implicit
                fo.write(s + "\n")


def read_tsv(path: str) -> tuple[list[str], list[dict]]:
    with open(path, "r", newline="", encoding="utf-8") as fo:
        rd = csv.DictReader(fo, delimiter="\t")
        rows = list(rd)
        return list(rd.fieldnames or []), rows


def write_tsv(path: str, fieldnames: list[str], rows: list[dict]) -> None:
    with open(path, "w", newline="", encoding="utf-8") as fo:
        wr = csv.DictWriter(fo, fieldnames=fieldnames, delimiter="\t")
        wr.writeheader()
        for r in rows:
            wr.writerow(r)


def preproc_text(corpus_path: str, lang: str = "en",
                 splits=("train", "dev", "test")) -> Alphabet:
    """``--mode preproc`` on a Common Voice-style corpus: normalise the
    'sentence' column of each split TSV in place and write alphabet.txt
    from the normalised train sentences."""
    train_texts: list[str] = []
    for split in splits:
        path = os.path.join(corpus_path, f"{split}.tsv")
        if not os.path.exists(path):
            continue
        fieldnames, rows = read_tsv(path)
        for r in rows:
            r["sentence"] = normalize_text(r.get("sentence", ""), lang)
        write_tsv(path, fieldnames, rows)
        if split == "train":
            train_texts = [r["sentence"] for r in rows]
    alphabet = Alphabet.from_texts(train_texts)
    alphabet.save(os.path.join(corpus_path, "alphabet.txt"))
    return alphabet
