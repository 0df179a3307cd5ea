"""Alphabets and manifest TSVs (counterpart of pg_asr_tpu/data/text.py).

Conventions of the JAX package, kept exactly:
  * index 0 is '<pad>' and doubles as the CTC blank;
  * alphabet.txt holds one symbol per line WITHOUT the pad entry; loaders
    prepend '<pad>'.
Text normalisation (``--mode preproc``) is not ported.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass

PAD = "<pad>"
BLANK_ID = 0


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
        with open(path, "r") as fo:
            lines = [ln.rstrip("\n") for ln in fo.readlines()]
        return Alphabet.from_symbols([ln for ln in lines if ln != ""])

    def save(self, path: str) -> None:
        with open(path, "w") as fo:
            for s in self.symbols[1:]:  # pad is implicit
                fo.write(s + "\n")


def read_tsv(path: str) -> tuple[list[str], list[dict]]:
    with open(path, "r", newline="") as fo:
        rd = csv.DictReader(fo, delimiter="\t")
        rows = list(rd)
        return list(rd.fieldnames or []), rows


def write_tsv(path: str, fieldnames: list[str], rows: list[dict]) -> None:
    with open(path, "w", newline="") as fo:
        wr = csv.DictWriter(fo, fieldnames=fieldnames, delimiter="\t")
        wr.writeheader()
        for r in rows:
            wr.writerow(r)
