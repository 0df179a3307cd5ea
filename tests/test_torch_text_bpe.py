"""The port's text layer against the JAX package's on the same inputs:
``normalize_text``, ``Alphabet.piece``, BPE training (ties included),
encoding, decoding and pieces, the native segmenter (the port's own build
of native/pgasr_bpe.cpp), the saved bpe.vocab / bpe.merges bytes and
``load_tokenizer``. Parity bar: equal values, equal bytes."""

import locale
import os
import unicodedata

import pytest

from pg_asr_tpu.data import bpe as jax_bpe
from pg_asr_tpu.data import text as jax_text
from pg_asr_tpu_torch.data import bpe, native_bpe, native_io
from pg_asr_tpu_torch.data import text

TEXTS = ["the cat sat on the mat", "the bad cab had a mad lad",
         "a cat and a bat", "the the the cab cab", "zorionak  bai\tñu"]

NORMALIZE_CASES = [
    ("en", "Hello, World! It's 2024 -- a test_case/slash."),
    ("en", "Ünïcödé  façade naïve"),
    ("eu", "Kaixo, Ñandú: zer moduz? 42 urte"),
    ("de", "Größe, Übermaß und Äpfel — «ja»"),
    ("fr", "L'œuvre d'Éloïse: où ça? Noël–été"),
    ("es", "¿Qué tal, señor? ¡Adiós!"),
    ("xx", "unknown lang keeps ' only; digits 123 go"),
    # NFD input (decomposed accents) normalises to the composed letters
    ("fr", unicodedata.normalize("NFD", "été à l'hôtel")),
    ("en", "tabs\tand\nnewlines   collapse  "),
    ("en", ""),
]


@pytest.mark.parametrize("lang,raw", NORMALIZE_CASES)
def test_normalize_text_matches_jax(lang, raw):
    got = text.normalize_text(raw, lang)
    assert got == jax_text.normalize_text(raw, lang)
    assert "  " not in got and got == got.strip()


def test_lang_extras_are_the_jax_tables():
    assert text._LANG_EXTRA == jax_text._LANG_EXTRA


def test_alphabet_piece_is_the_symbol():
    a = text.Alphabet.from_texts(TEXTS)
    j = jax_text.Alphabet.from_texts(TEXTS)
    assert a.symbols == j.symbols
    assert [a.piece(i) for i in range(a.size)] == [
        j.piece(i) for i in range(j.size)]


def _tie_texts():
    """Two pairs with equal counts at the first merge: ('▁', 'a') and
    ('▁', 'b') both occur 3 times, as do ('a', 'b') and ('b', 'a'); the
    lexicographic rule picks one."""
    return ["ab ab ab", "ba ba ba"]


@pytest.mark.parametrize("texts,size", [(TEXTS, 40), (TEXTS, 12),
                                        (_tie_texts(), 8), (TEXTS, 400)])
def test_train_bpe_matches_jax(texts, size):
    got = bpe.train_bpe(texts, size)
    want = jax_bpe.train_bpe(texts, size)
    assert got.symbols == want.symbols and got.merges == want.merges
    # merges stop at the target size (the characters always stay)
    base = {c for t in texts for w in t.split() for c in "▁" + w}
    assert got.size <= max(size, len(base) + 1)


def test_tie_breaks_lexicographically():
    tok = bpe.train_bpe(_tie_texts(), 8)
    counts = bpe._pair_counts({("▁", "a", "b"): 3, ("▁", "b", "a"): 3})
    top = max(counts.values())
    assert sum(v == top for v in counts.values()) > 1  # a real tie
    assert tok.merges[0] == min(p for p, v in counts.items() if v == top)


def test_encode_decode_piece_match_jax():
    got = bpe.train_bpe(TEXTS, 40)
    want = jax_bpe.train_bpe(TEXTS, 40)
    for t in TEXTS + ["a mad cat sat", "the zzz cat", "", "ñu ñu"]:
        ids = got.encode(t)
        assert ids == want.encode(t)
        assert got.decode(ids) == want.decode(ids)
    # a bare marker left by an all-unknown word collapses as in JAX
    ids = [got.char2ind["▁"], got.char2ind["▁the"]]
    assert got.decode(ids) == want.decode(ids) == "the"
    assert [got.piece(i) for i in range(got.size)] == [
        want.piece(i) for i in range(want.size)]


def test_native_segmenter_matches_python():
    if not native_bpe.native_available():
        pytest.fail("the native BPE segmenter did not build from "
                    f"{native_bpe.SOURCE} (g++ is on the CPU test host)")
    tok = bpe.train_bpe(TEXTS, 40)
    texts = TEXTS + ["a mad cat sat", "the zzz cat", "", "ñu ñu"]
    before = dict(bpe.SEGMENTED)
    got = tok.encode_batch(texts)
    assert bpe.SEGMENTED["native"] == before["native"] + 1
    assert bpe.SEGMENTED["python"] == before["python"]
    assert got == [tok.encode(t) for t in texts]
    assert got == jax_bpe.train_bpe(TEXTS, 40).encode_batch(texts)
    # the port's own build, not the JAX package's native/libpgasr_bpe.so
    lib = native_bpe._load()._name
    assert lib == native_io.library_path(native_bpe.SOURCE)
    assert os.sep + "_build" + os.sep in lib


def test_python_segmenter_is_counted(monkeypatch):
    tok = bpe.train_bpe(TEXTS, 40)
    object.__setattr__(tok, "_native", False)
    before = dict(bpe.SEGMENTED)
    assert tok.encode_batch(TEXTS) == [tok.encode(t) for t in TEXTS]
    assert bpe.SEGMENTED["python"] == before["python"] + 1
    assert bpe.SEGMENTED["native"] == before["native"]


def test_saved_files_are_the_jax_bytes(tmp_path):
    texts = TEXTS + ["ñandú öl être"] * 2
    bpe.train_bpe(texts, 40).save(str(tmp_path / "port.vocab"))
    jax_bpe.train_bpe(texts, 40).save(str(tmp_path / "jax.vocab"))
    # the JAX package writes in the locale's encoding, the port in UTF-8:
    # the same bytes under a UTF-8 locale, the same text under any
    enc = locale.getpreferredencoding(False)
    for ext in (".vocab", ".merges"):
        with open(tmp_path / f"port{ext}", "rb") as a, \
                open(tmp_path / f"jax{ext}", "rb") as b:
            got, want = a.read(), b.read()
        if enc.lower().replace("-", "") == "utf8":
            assert got == want
        assert got.decode("utf-8") == want.decode(enc)
    again = bpe.BpeAlphabet.load(str(tmp_path / "jax.vocab"))
    assert again == bpe.train_bpe(texts, 40)


def test_load_tokenizer_matches_jax(tmp_path):
    d = str(tmp_path)
    text.Alphabet.from_texts(TEXTS).save(os.path.join(d, "alphabet.txt"))
    assert isinstance(bpe.load_tokenizer(d, "char"), text.Alphabet)
    with pytest.raises(FileNotFoundError) as got:
        bpe.load_tokenizer(d, "bpe")
    with pytest.raises(FileNotFoundError) as want:
        jax_bpe.load_tokenizer(d, "bpe")
    assert str(got.value) == str(want.value)
    jax_bpe.train_bpe(TEXTS, 40).save(os.path.join(d, "bpe.vocab"))
    tok = bpe.load_tokenizer(d, "bpe")
    assert isinstance(tok, bpe.BpeAlphabet)
    assert tok.symbols == jax_bpe.load_tokenizer(d, "bpe").symbols
    with pytest.raises(ValueError, match="units"):
        bpe.load_tokenizer(d, "words")
