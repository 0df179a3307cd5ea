"""Manifests, length-bucketed batching and the synthetic corpus
(counterpart of pg_asr_tpu/data/dataset.py).

numpy only. The batches are those of the JAX package's ``BatchIterator``
(same bucketing, padding quanta, shuffle stream and int16 quantisation), so
one corpus and seed give the same batches in both packages. Ported: the
pure-Python WAV decode path. Not ported (ROADMAP.md): the native C++
decoder (``native_io``), decode worker threads, the built-batch cache and
multi-host sharding.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .audio import load_audio, synth_utterance, write_wav
from .text import Alphabet, read_tsv, write_tsv


@dataclass
class Utterance:
    audio_path: str
    text: str
    num_samples: int  # -1 until the audio is loaded


@dataclass
class Batch:
    """One padded batch of raw audio + encoded transcripts."""

    wave: np.ndarray          # (B, N) zero-padded int16 PCM
    num_samples: np.ndarray   # (B,) int32
    labels: np.ndarray        # (B, L) int32, 0-padded
    label_lens: np.ndarray    # (B,) int32
    texts: list[str]          # reference transcripts (for eval)

    @property
    def size(self) -> int:
        return self.wave.shape[0]


def load_manifest(tsv_path: str, audio_dir: str | None = None) -> list[Utterance]:
    """Common Voice style TSV (columns `path`, `sentence`) -> utterances."""
    _, rows = read_tsv(tsv_path)
    utts = []
    for r in rows:
        p = r["path"]
        if audio_dir is not None and not os.path.isabs(p):
            p = os.path.join(audio_dir, p)
        utts.append(Utterance(audio_path=p, text=r.get("sentence", ""),
                              num_samples=-1))
    return utts


# padded lengths are multiples of these (the JAX package's defaults), so
# a run sees few distinct batch shapes
WAVE_QUANTUM = 16000  # samples
LABEL_QUANTUM = 32    # symbols


def _round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


class BatchIterator:
    """Length-bucketed padded batches of raw audio as int16 PCM (the
    device converts with x / 32768).

    Utterances are sorted by sample count, chunked into batches and each
    batch padded to rounded-up max lengths. Batch order is shuffled per
    epoch from ``seed``; the composition of a batch stays the same."""

    def __init__(self, utterances: list[Utterance], alphabet: Alphabet,
                 batch_size: int, *, sample_rate: int = 16000,
                 shuffle: bool = True, seed: int = 0):
        self.utts = list(utterances)
        self.alphabet = alphabet
        self.batch_size = batch_size
        self.sample_rate = sample_rate
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def _load(self, utt: Utterance) -> np.ndarray:
        w, sr = load_audio(utt.audio_path)
        if sr != self.sample_rate:
            # linear resample; +0.5 truncation as in the JAX package
            n_out = int(len(w) * self.sample_rate / sr + 0.5)
            w = np.interp(np.linspace(0.0, len(w) - 1.0, n_out),
                          np.arange(len(w)), w).astype(np.float32)
        utt.num_samples = len(w)
        return w

    def __len__(self) -> int:
        return -(-len(self.utts) // self.batch_size)

    def _ensure_len(self, i: int) -> int:
        u = self.utts[i]
        if u.num_samples < 0:
            self._load(u)
        return u.num_samples

    def __iter__(self) -> Iterator[Batch]:
        order = sorted(range(len(self.utts)),
                       key=lambda i: (self._ensure_len(i), i))
        chunks = [order[i: i + self.batch_size]
                  for i in range(0, len(order), self.batch_size)]
        if self.shuffle:
            self.rng.shuffle(chunks)
        for chunk in chunks:
            yield self._make_batch([self.utts[i] for i in chunk])

    def skip_epochs(self, k: int) -> None:
        """Advance the shuffle stream past k epochs without building batches
        (each epoch draws one shuffle of a list of len(self) chunks)."""
        for _ in range(k):
            if self.shuffle:
                self.rng.shuffle(list(range(len(self))))

    def _make_batch(self, utts: list[Utterance]) -> Batch:
        waves = [self._load(u) for u in utts]
        lens = np.array([len(w) for w in waves], np.int32)
        N = _round_up(max(int(lens.max()), 1), WAVE_QUANTUM)
        wave = np.zeros((len(utts), N), np.float32)
        for i, w in enumerate(waves):
            wave[i, : len(w)] = w
        # exact for 16-bit sources: x / 32768 lands back on integers
        wave = np.clip(np.rint(wave * 32768.0), -32768, 32767).astype(np.int16)
        enc = self.alphabet.encode_batch([u.text for u in utts])
        llens = np.array([len(e) for e in enc], np.int32)
        L = _round_up(max(int(llens.max()), 1), LABEL_QUANTUM)
        labels = np.zeros((len(utts), L), np.int32)
        for i, e in enumerate(enc):
            labels[i, : len(e)] = e
        return Batch(wave, lens, labels, llens, [u.text for u in utts])


class PrefetchIterator:
    """Background-thread prefetch over any Batch iterable: builds the next
    ``depth`` batches (WAV decode + padding) while the device runs the
    current one. Producer exceptions are re-raised in the consumer; each
    ``__iter__`` starts one producer thread (one epoch)."""

    _DONE = object()

    def __init__(self, source, depth: int = 2):
        self.source = source
        self.depth = max(1, depth)

    def __len__(self) -> int:
        return len(self.source)

    def __iter__(self) -> Iterator[Batch]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        err: list[BaseException] = []
        stop = threading.Event()  # consumer abandoned the epoch

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for b in self.source:
                    if not _put(b):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err.append(e)
            finally:
                _put(self._DONE)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


def make_synthetic_corpus(root: str, n_utts: int = 16, seed: int = 0,
                          sample_rate: int = 16000,
                          min_dur: float = 0.3, max_dur: float = 1.2,
                          words=("abba", "cad", "bad", "cab", "dada")
                          ) -> tuple[str, Alphabet]:
    """Write a small on-disk corpus: clips/*.wav + train/dev/test.tsv +
    alphabet.txt (Common Voice layout). The same draws as the JAX
    package's, so one seed writes the same corpus. Returns
    (corpus_path, alphabet)."""
    rng = np.random.default_rng(seed)
    clips = os.path.join(root, "clips")
    os.makedirs(clips, exist_ok=True)
    rows = []
    for i in range(n_utts):
        dur = float(rng.uniform(min_dur, max_dur))
        wav = synth_utterance(rng, dur, sample_rate)
        fn = f"utt{i:04d}.wav"
        write_wav(os.path.join(clips, fn), wav, sample_rate)
        text = " ".join(rng.choice(words) for _ in range(rng.integers(1, 4)))
        rows.append({"path": fn, "sentence": text})

    alphabet = Alphabet.from_texts([r["sentence"] for r in rows])
    alphabet.save(os.path.join(root, "alphabet.txt"))
    n_dev = max(1, n_utts // 8)
    fields = ["path", "sentence"]
    write_tsv(os.path.join(root, "train.tsv"), fields,
              rows[: n_utts - 2 * n_dev])
    write_tsv(os.path.join(root, "dev.tsv"), fields,
              rows[n_utts - 2 * n_dev: n_utts - n_dev])
    write_tsv(os.path.join(root, "test.tsv"), fields, rows[n_utts - n_dev:])
    return root, alphabet
