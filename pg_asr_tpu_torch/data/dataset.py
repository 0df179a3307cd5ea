"""Manifests, length-bucketed batching and the synthetic corpus
(counterpart of pg_asr_tpu/data/dataset.py).

numpy only. The batches are those of the JAX package's ``BatchIterator``
(same bucketing, padding quanta, shuffle stream and int16 quantisation), so
one corpus and seed give the same batches in both packages, with the
native C++ WAV decoder (``native_io``) or the Python one, decode worker
threads and the built-batch cache, and ``skip_epochs`` / ``skip_batches``
for a mid-epoch resume. Not ported (ROADMAP.md): multi-host sharding and
``max_samples``.
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
    epoch from ``seed``; the composition of a batch stays the same.

    ``decoder``: "native" (the C++ decoder, ``native_io``; raises where it
    cannot be built), "python" (``audio.read_wav``) or "auto" (native when
    it builds); both give the same int16 samples. ``decoded`` counts the
    batches each built. ``num_workers`` > 0 builds batches on a thread
    pool, at most that many ahead and yielded in order (-1: 2 on a host of
    at least 4 CPUs, else 0). ``cache_mb`` > 0 keeps built batches up to
    that many MiB for later epochs (a batch's composition never changes).
    Neither changes a batch: one seed gives the same batches, byte for
    byte, with or without them."""

    def __init__(self, utterances: list[Utterance], alphabet: Alphabet,
                 batch_size: int, *, sample_rate: int = 16000,
                 shuffle: bool = True, seed: int = 0, cache_mb: float = 0.0,
                 num_workers: int = 0, decoder: str = "auto"):
        if decoder not in ("auto", "native", "python"):
            raise ValueError(f"decoder must be auto|native|python, got "
                             f"{decoder!r}")
        self.utts = list(utterances)
        self.alphabet = alphabet
        self.batch_size = batch_size
        self.sample_rate = sample_rate
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.decoder = decoder
        self.decoded = {"native": 0, "python": 0}
        self._count_lock = threading.Lock()
        self._skip_next = 0  # batches to drop at the next epoch (resume)
        self.cache_mb = float(cache_mb)
        self._batch_cache: dict[tuple, Batch] = {}
        self._batch_cache_bytes = 0
        if num_workers < 0:
            num_workers = 2 if (os.cpu_count() or 1) >= 4 else 0
        self.num_workers = int(num_workers)

    def _native(self) -> bool:
        if self.decoder == "python":
            return False
        from . import native_io

        if native_io.native_available():
            return True
        if self.decoder == "native":
            raise RuntimeError("decoder='native': the native WAV decoder "
                               f"could not be built ({native_io.SOURCE})")
        return False

    def _load(self, utt: Utterance) -> np.ndarray:
        w, sr = load_audio(utt.audio_path, self.decoder)
        if sr != self.sample_rate:
            # linear resample (native when it builds: the same semantics);
            # +0.5 truncation as in the JAX package
            n_out = int(len(w) * self.sample_rate / sr + 0.5)
            if self._native():
                from . import native_io

                w = native_io.resample(w, n_out)
            else:
                w = np.interp(np.linspace(0.0, len(w) - 1.0, n_out),
                              np.arange(len(w)), w).astype(np.float32)
        utt.num_samples = len(w)
        return w

    def __len__(self) -> int:
        return -(-len(self.utts) // self.batch_size)

    def _ensure_len(self, i: int) -> int:
        u = self.utts[i]
        if u.num_samples < 0:
            if u.audio_path.lower().endswith(".wav") and self._native():
                # a header read: bucketing needs only the sample count
                from . import native_io

                sr, n = native_io.wav_info(u.audio_path)
                if sr != self.sample_rate:
                    n = int(n * self.sample_rate / sr + 0.5)
                u.num_samples = max(int(n), 0)
            else:
                self._load(u)
        return u.num_samples

    def __iter__(self) -> Iterator[Batch]:
        order = sorted(range(len(self.utts)),
                       key=lambda i: (self._ensure_len(i), i))
        chunks = [order[i: i + self.batch_size]
                  for i in range(0, len(order), self.batch_size)]
        if self.shuffle:
            self.rng.shuffle(chunks)
        if self._skip_next:
            chunks = chunks[self._skip_next:]
            self._skip_next = 0
        if self.num_workers > 0:
            yield from self._iter_pooled(chunks)
            return
        for chunk in chunks:
            key = tuple(chunk)
            batch = self._batch_cache.get(key)
            if batch is None:
                batch = self._make_batch([self.utts[i] for i in chunk])
                self._maybe_cache(key, batch)
            yield batch

    def _maybe_cache(self, key: tuple, batch: Batch) -> None:
        if self.cache_mb > 0:
            nbytes = (batch.wave.nbytes + batch.num_samples.nbytes
                      + batch.labels.nbytes + batch.label_lens.nbytes)
            if self._batch_cache_bytes + nbytes <= self.cache_mb * (1 << 20):
                self._batch_cache[key] = batch
                self._batch_cache_bytes += nbytes

    def _iter_pooled(self, chunks) -> Iterator[Batch]:
        """Up to num_workers batches build at once, yielded in order. Cache
        hits are resolved in this (consumer) thread, so the cache has one
        writer; a consumer that stops early cancels the queued builds and
        waits for the running ones as the pool shuts down."""
        from concurrent.futures import ThreadPoolExecutor

        def resolve(key, item) -> Batch:
            if not isinstance(item, Batch):
                item = item.result()
                self._maybe_cache(key, item)
            return item

        window: list = []  # (key, Batch or Future), oldest first
        with ThreadPoolExecutor(max_workers=self.num_workers,
                                thread_name_prefix="batch-decode") as pool:
            try:
                for chunk in chunks:
                    key = tuple(chunk)
                    hit = self._batch_cache.get(key)
                    window.append((key, hit if hit is not None else
                                   pool.submit(self._make_batch,
                                               [self.utts[j] for j in chunk])))
                    if len(window) > self.num_workers:
                        yield resolve(*window.pop(0))
                while window:
                    yield resolve(*window.pop(0))
            finally:
                for _, item in window:
                    if not isinstance(item, Batch):
                        item.cancel()

    def skip_epochs(self, k: int) -> None:
        """Advance the shuffle stream past k epochs without building batches
        (each epoch draws one shuffle of a list of len(self) chunks)."""
        for _ in range(k):
            if self.shuffle:
                self.rng.shuffle(list(range(len(self))))

    def skip_batches(self, n: int) -> None:
        """Drop the first n batches of the next epoch (consumed before an
        interruption) without loading their audio: a mid-epoch resume goes
        on at the next batch of the same shuffled order."""
        self._skip_next = int(n)

    def _make_batch(self, utts: list[Utterance]) -> Batch:
        wave, lens = self._batch_waves(utts)
        enc = self.alphabet.encode_batch([u.text for u in utts])
        llens = np.array([len(e) for e in enc], np.int32)
        L = _round_up(max(int(llens.max()), 1), LABEL_QUANTUM)
        labels = np.zeros((len(utts), L), np.int32)
        for i, e in enumerate(enc):
            labels[i, : len(e)] = e
        return Batch(wave, lens, labels, llens, [u.text for u in utts])

    def _batch_waves(self, utts: list[Utterance]):
        """(B, N) int16 waves and lengths: one threaded native call for the
        whole batch when every file is a WAV, else a Python decode per
        utterance (exact for 16-bit sources: x / 32768 lands back on
        integers, which np.rint keeps)."""
        if self._native() and all(u.audio_path.lower().endswith(".wav")
                                  for u in utts):
            from . import native_io

            N = _round_up(max(max(u.num_samples for u in utts), 1),
                          WAVE_QUANTUM)
            wave, lens, _ = native_io.load_batch_i16(
                [u.audio_path for u in utts], N,
                target_rate=self.sample_rate)
            self._count("native")
            return wave, np.minimum(lens, N).astype(np.int32)
        waves = [self._load(u) for u in utts]
        lens = np.array([len(w) for w in waves], np.int32)
        N = _round_up(max(int(lens.max()), 1), WAVE_QUANTUM)
        wave = np.zeros((len(utts), N), np.float32)
        for i, w in enumerate(waves):
            wave[i, : len(w)] = w
        self._count("python")
        return (np.clip(np.rint(wave * 32768.0), -32768, 32767)
                .astype(np.int16), lens)

    def _count(self, which: str) -> None:
        with self._count_lock:
            self.decoded[which] += 1


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
    _write_splits(root, rows)
    return root, alphabet


def synth_phonetic_utterance(text: str, rng: np.random.Generator,
                             sample_rate: int = 16000) -> np.ndarray:
    """A waveform that encodes its transcript: each character a tone of
    its own frequency, spaces silence, with amplitude and phase jitter and
    noise (the JAX package's draws, in its order). A model can learn this
    mapping, so test CER measures learning, not memorisation."""
    char_n = int(0.090 * sample_rate)
    gap_n = int(0.020 * sample_rate)
    space_n = int(0.120 * sample_rate)
    pieces = [np.zeros(gap_n, np.float32)]
    for ch in text:
        if ch == " ":
            pieces.append(np.zeros(space_n, np.float32))
            continue
        f = 220.0 * 2.0 ** ((ord(ch) % 26) / 9.0)  # distinct per a-z
        t = np.arange(char_n, dtype=np.float32) / sample_rate
        amp = float(rng.uniform(0.25, 0.4))
        phase = float(rng.uniform(0, 2 * np.pi))
        tone = amp * np.sin(2 * np.pi * f * t + phase).astype(np.float32)
        ramp = min(int(0.005 * sample_rate), char_n // 2)  # 5 ms fades
        env = np.ones(char_n, np.float32)
        env[:ramp] = np.linspace(0, 1, ramp, dtype=np.float32)
        env[-ramp:] = np.linspace(1, 0, ramp, dtype=np.float32)
        pieces.append(tone * env)
        pieces.append(np.zeros(gap_n, np.float32))
    x = np.concatenate(pieces)
    return x + 0.01 * rng.standard_normal(len(x)).astype(np.float32)


def make_phonetic_corpus(root: str, n_utts: int = 96, seed: int = 0,
                         sample_rate: int = 16000,
                         words=("abba", "cad", "bad", "cab", "dada"),
                         max_words: int = 3) -> tuple[str, Alphabet]:
    """A learnable corpus (``synth_phonetic_utterance`` audio) in the
    layout of ``make_synthetic_corpus``: train/dev/test share the
    character-to-tone code but no utterance. The same draws as the JAX
    package's, so one seed writes the same WAV and TSV bytes."""
    rng = np.random.default_rng(seed)
    clips = os.path.join(root, "clips")
    os.makedirs(clips, exist_ok=True)
    rows = []
    for i in range(n_utts):
        text = " ".join(rng.choice(words)
                        for _ in range(rng.integers(1, max_words + 1)))
        wav = synth_phonetic_utterance(text, rng, sample_rate)
        fn = f"utt{i:04d}.wav"
        write_wav(os.path.join(clips, fn), wav, sample_rate)
        rows.append({"path": fn, "sentence": text})
    alphabet = Alphabet.from_texts([r["sentence"] for r in rows])
    alphabet.save(os.path.join(root, "alphabet.txt"))
    _write_splits(root, rows)
    return root, alphabet


def _write_splits(root: str, rows: list[dict]) -> None:
    """train/dev/test.tsv: the last n/8 rows test, the n/8 before dev."""
    n = len(rows)
    n_dev = max(1, n // 8)
    fields = ["path", "sentence"]
    write_tsv(os.path.join(root, "train.tsv"), fields, rows[: n - 2 * n_dev])
    write_tsv(os.path.join(root, "dev.tsv"), fields,
              rows[n - 2 * n_dev: n - n_dev])
    write_tsv(os.path.join(root, "test.tsv"), fields, rows[n - n_dev:])
