"""Streaming transcription (counterpart of pg_asr_tpu/serving.py, same
names): latency-controlled BiLSTM transcription of audio as it arrives.

  * Audio is consumed in chunks of C committed frames plus R frames of
    lookahead. The host buffers raw samples and assembles each window's
    samples exactly as the offline frontend reads them (reflect padding at
    the stream start, zeros past its end), so streamed features equal the
    offline ones.
  * LC-BLSTM: the forward direction of every layer carries (h, c) across
    chunks (``_fwd_scan_from``, the JAX package's XLA scan numerics in
    plain PyTorch: no Pallas kernel lies under it); the carry is taken at
    the committed boundary, then the scan goes on over the lookahead. The
    backward direction runs afresh over each window from a zero state at
    its right edge: ``ops/lstm.lstm_scan(reverse=True)``, the hand-written
    ``lstm_fwd`` kernel on a CUDA tensor (one launch a layer a chunk, at
    B=1 or, batched, B=S), its plain version on a CPU tensor.
  * Normalization: running scalar statistics over the committed frames, or
    a fixed (mean, var); fixed statistics with lookahead to the stream end
    reproduce the offline forward.
  * Greedy CTC collapse with the previous id carried across chunks; the
    CTC prefix beam (``decoder="beam"``) carries the buffer beam state
    (``decoding/beam._step``) across chunks and emits the live beams'
    agreed prefix; with ``lm=`` (an n-gram table, decoding/lm.py) the
    carry is the LM-fused beam's (``decoding/beam._step_lm_buffer``:
    prefixes, LM contexts and cumulative LM scores), ranked by acoustic +
    lm_weight * lm + length_bonus * len frame for frame as the offline
    ``beam_decode(lm=...)``; the transducer (BiLSTM encoder) continues its
    frame-synchronous greedy search from the carried prediction-network
    state.
  * Transformer / conformer: overlapping windows of up to ``left_context``
    exact left frames + C + R through the family's own ``encode()``
    (``pre_normalized``; the transformer's positions offset to the window's
    first subframe), so with ``flash_attention`` the window's attention is
    the hand-written ``flash_attn`` kernel on CUDA tensors.

``BatchedStreamingTranscriber`` runs S streams in lockstep through one
batched chunk step (the JAX package vmaps the single-stream step): idle
slots ride along with zero masks and their state freezes.

Device state lives on the transcriber's ``device`` (default ``cuda``;
asking for it without a GPU raises, the CPU runs only when asked for).
``BatchedStreamingTranscriber`` fuses no LM, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import resolve_device
from .config import Config
from .decoding.beam import (NEG, _lm_state0, _step, _step_lm_buffer,
                            fusion_coefficients, lm_context_scores)
from .decoding.transducer import greedy_scan, init_decode_state
from .models.bilstm_ctc import linear, torch_dtype
from .ops.features import _constants, full_f32_conv
from .ops.lstm import lstm_scan, lstm_scan_xla_from
from .utils import debug

# the forward direction from a carry, under the JAX package's name
_fwd_scan_from = lstm_scan_xla_from


def _window_features(window: torch.Tensor, fcfg) -> torch.Tensor:
    """(S, L) sample windows -> (S, Wf, F) log-mel features: the offline
    frontend's math as a VALID conv over the host-padded windows (no
    reflect here: the host placed the reflected and zero samples), the
    conv in full float32 as ``extract_features``."""
    kern, fb, _ = _constants(fcfg, window.device)
    with full_f32_conv():
        spec = F.conv1d(window[:, None, :], kern, stride=fcfg.hop_length)
    K = fcfg.n_fft // 2 + 1
    power = (spec[:, :K] ** 2 + spec[:, K:] ** 2).transpose(1, 2)
    return torch.log(torch.clamp(power @ fb, min=fcfg.log_floor))


def _running_norm(feats: torch.Tensor, valid: torch.Tensor,
                  committed: torch.Tensor, stats, fixed_norm: bool, dtype):
    """Running scalar statistics per row (S,) over committed frames (or a
    fixed (mean, var)), pooled over frames x channels like the offline
    ``normalize_features`` -> (x (S, Wf, F) in `dtype`, new stats)."""
    s, ss, cnt = stats
    if fixed_norm:
        mean, var = s, ss
        new_stats = stats
    else:
        cm = committed[:, :, None]
        s = s + (feats * cm).sum(dim=(1, 2))
        ss = ss + (feats.square() * cm).sum(dim=(1, 2))
        cnt = cnt + committed.sum(1) * feats.shape[-1]
        mean = s / cnt.clamp(min=1.0)
        var = (ss / cnt.clamp(min=1.0) - mean.square()).clamp(min=0.0)
        new_stats = (s, ss, cnt)
    x = ((feats - mean[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None]
         * valid[:, :, None]).to(dtype)
    return x, new_stats


def _frame_masks(feats: torch.Tensor, n_valid: torch.Tensor,
                 lo, hi: torch.Tensor):
    """(valid, committed) (S, Wf) float32: frame t is valid below
    n_valid and committed in [lo, hi)."""
    idx = torch.arange(feats.shape[1], device=feats.device)[None, :]
    valid = (idx < n_valid[:, None]).to(torch.float32)
    committed = ((idx >= lo) & (idx < hi[:, None])).to(torch.float32)
    return valid, committed


def _chunk_step_attention(params, window: torch.Tensor, stats,
                          n_valid: torch.Tensor, n_committed: torch.Tensor,
                          abs_frame0: int, cfg: Config, n_ctx: int,
                          chunk: int, fixed_norm: bool,
                          use_kernel: bool = True):
    """One transformer / conformer streaming step over windows of n_ctx
    left-context + chunk committed + R lookahead raw frames, all real
    audio, through the family's own ``encode()``; only the chunk's
    committed subframes are emitted. -> (ids (S, chunk/s), max log-probs
    (S, chunk/s), new stats)."""
    from .models import conformer_ctc, transformer_ctc

    fcfg, mcfg = cfg.features, cfg.model
    dtype = torch_dtype(mcfg.dtype)
    feats = _window_features(window, fcfg)
    valid, committed = _frame_masks(feats, n_valid, n_ctx,
                                    n_ctx + n_committed)
    feats = feats * valid[:, :, None]
    x, new_stats = _running_norm(feats, valid, committed, stats, fixed_norm,
                                 dtype)
    mask = valid.to(dtype)
    if mcfg.family == "conformer":
        s = cfg.conformer.subsample
        xs, _, _ = conformer_ctc.encode(params, x, mask, n_valid, mcfg,
                                        cfg.conformer, use_kernel=use_kernel,
                                        pre_normalized=True)
    else:
        s = cfg.transformer.subsample
        xs, _, _ = transformer_ctc.encode(
            params, x, mask, n_valid, mcfg, cfg.transformer,
            use_kernel=use_kernel, pos_offset=abs_frame0 // s,
            pre_normalized=True)
    log_probs = torch.log_softmax(linear(params, "ctc_head", xs).float(), -1)
    debug.check_nans(log_probs, "the stream's log-probs")
    ids, lp_max = torch.argmax(log_probs, dim=-1), log_probs.amax(dim=-1)
    lo = n_ctx // s
    return ids[:, lo:lo + chunk // s], lp_max[:, lo:lo + chunk // s], \
        new_stats


def _encode_window(enc: dict, window: torch.Tensor, stats, carries,
                   n_valid: torch.Tensor, n_committed: torch.Tensor,
                   cfg: Config, chunk: int, fixed_norm: bool,
                   use_kernel: bool = True):
    """Featurize + normalize + LC-BLSTM-encode (S, L) sample windows
    covering C+R frames. Shared by the CTC and transducer streaming heads.

    stats: per-row (sum, sumsq, count) (or (mean, var, _) with fixed_norm),
    each (S,) float32; carries: per-layer (h, c) (S, H) of the forward
    direction in the compute type; enc: the encoder's parameters
    (``input_proj.*``, ``lstm.{i}.{fwd,bwd}.*``). -> (x (S, C+R, 2H), new
    stats, new carries)."""
    fcfg, mcfg = cfg.features, cfg.model
    dtype = torch_dtype(mcfg.dtype)
    feats = _window_features(window, fcfg)
    valid, committed = _frame_masks(feats, n_valid, 0, n_committed)
    feats = feats * valid[:, :, None]
    x, new_stats = _running_norm(feats, valid, committed, stats, fixed_norm,
                                 dtype)
    mask = valid.to(dtype)
    x = F.leaky_relu(linear(enc, "input_proj", x), negative_slope=0.01)
    new_carries = []
    for i, (h0, c0) in enumerate(carries):
        fw = {k: enc[f"lstm.{i}.fwd.{k}"] for k in ("W", "U", "b")}
        bw = {k: enc[f"lstm.{i}.bwd.{k}"] for k in ("W", "U", "b")}
        xp_f = torch.matmul(x, fw["W"]) + fw["b"]
        # the committed frames continue the cross-chunk carry, which is
        # taken at the committed boundary: the lookahead frames are fed
        # again as committed frames by the next chunk
        ys_a, (h1, c1) = _fwd_scan_from(xp_f[:, :chunk], fw["U"],
                                        mask[:, :chunk] * committed[:, :chunk],
                                        h0, c0)
        ys_b, _ = _fwd_scan_from(xp_f[:, chunk:], fw["U"], mask[:, chunk:],
                                 h1, c1)
        xp_b = torch.matmul(x, bw["W"]) + bw["b"]
        bwd = lstm_scan(xp_b, bw["U"], mask, reverse=True,
                        use_kernel=use_kernel)
        x = torch.cat([torch.cat([ys_a, ys_b], dim=1), bwd], dim=-1)
        new_carries.append((h1, c1))
    return x, new_stats, tuple(new_carries)


def _ctc_log_probs(params, x: torch.Tensor, chunk: int) -> torch.Tensor:
    """The CTC head over the C committed slots -> (S, C, A) float32."""
    log_probs = torch.log_softmax(
        linear(params, "ctc_head", x[:, :chunk]).float(), dim=-1)
    debug.check_nans(log_probs, "the stream's log-probs")
    return log_probs


def _chunk_step(params, window, stats, carries, n_valid, n_committed,
                cfg: Config, chunk: int, fixed_norm: bool,
                use_kernel: bool = True):
    """One CTC streaming step: encode the windows, argmax over the C
    committed slots -> (ids (S, C), max log-probs (S, C), stats,
    carries)."""
    x, new_stats, new_carries = _encode_window(
        params, window, stats, carries, n_valid, n_committed, cfg, chunk,
        fixed_norm, use_kernel)
    log_probs = _ctc_log_probs(params, x, chunk)
    return (torch.argmax(log_probs, dim=-1), log_probs.amax(dim=-1),
            new_stats, new_carries)


def _chunk_step_beam(params, window, stats, carries, beam_state, n_valid,
                     n_committed, cfg: Config, chunk: int, fixed_norm: bool,
                     K: int, Lmax: int, use_kernel: bool = True):
    """One CTC streaming step with the prefix beam carried across chunks:
    encode, then advance the buffer beam state (prefixes (S, K, Lmax),
    lens, p_b, p_nb) over the committed frames; a row's frames at or past
    its n_committed leave its beam as it was. -> (beam_state, stats,
    carries)."""
    x, new_stats, new_carries = _encode_window(
        params, window, stats, carries, n_valid, n_committed, cfg, chunk,
        fixed_norm, use_kernel)
    log_probs = _ctc_log_probs(params, x, chunk)
    A = log_probs.shape[-1]
    beam_state = _advance_beam(
        beam_state, log_probs, n_committed, chunk,
        lambda state, lp: _step(state, lp, K=K, A=A, Lmax=Lmax, blank=0))
    return beam_state, new_stats, new_carries


def _chunk_step_beam_lm(params, window, stats, carries, beam_state, lm_tab,
                        lam: float, beta: float, n_valid, n_committed,
                        cfg: Config, chunk: int, fixed_norm: bool, K: int,
                        Lmax: int, use_kernel: bool = True):
    """``_chunk_step_beam`` with n-gram shallow fusion: the carry is
    ``_step_lm_buffer``'s state (prefixes, hash, last, last2, lens, p_b,
    p_nb, cumulative LM score), ranked frame for frame as the offline
    ``beam_decode(lm=...)``. -> (beam_state, stats, carries)."""
    x, new_stats, new_carries = _encode_window(
        params, window, stats, carries, n_valid, n_committed, cfg, chunk,
        fixed_norm, use_kernel)
    log_probs = _ctc_log_probs(params, x, chunk)
    A = log_probs.shape[-1]

    def step(state, lp):
        lmn = lm_context_scores(lm_tab, state[2], state[3])
        return _step_lm_buffer(state, lp, lmn, K=K, A=A, Lmax=Lmax, blank=0,
                               lam=lam, beta=beta)

    beam_state = _advance_beam(beam_state, log_probs, n_committed, chunk,
                               step)
    return beam_state, new_stats, new_carries


def _advance_beam(beam_state, log_probs, n_committed, chunk: int, step):
    """`step` over the chunk's committed frames; a row's frames at or past
    its n_committed leave its beam as it was, and frames no row commits
    are not run."""
    for t in range(min(chunk, int(n_committed.max()))):
        new = step(beam_state, log_probs[:, t])
        live = t < n_committed
        beam_state = tuple(
            torch.where(live.view(-1, *([1] * (n.dim() - 1))), n, o)
            for n, o in zip(new, beam_state))
    return beam_state


def _chunk_step_rnnt(params, enc, window, stats, carries, dec_state,
                     n_emitted, n_valid, n_committed, cfg: Config,
                     chunk: int, fixed_norm: bool, max_symbols: int,
                     use_kernel: bool = True):
    """One transducer streaming step: encode the windows, then continue
    the frame-synchronous greedy search over the committed frames from the
    carried decoder state; the whole-stream cap (``decode.max_label_len``)
    holds across chunks. -> (ids (S, C*max_symbols), n emitted, stats,
    carries, dec_state)."""
    x, new_stats, new_carries = _encode_window(
        enc, window, stats, carries, n_valid, n_committed, cfg, chunk,
        fixed_norm, use_kernel)
    E = linear(params, "joint_enc", x[:, :chunk])
    debug.check_nans(E, "the stream's encoder output")
    out, pos, dec_state = greedy_scan(
        params, E, n_committed, dec_state,
        max_label_len=chunk * max_symbols, max_symbols=max_symbols,
        pos_offset=n_emitted, global_cap=cfg.decode.max_label_len)
    return out, pos, new_stats, new_carries, dec_state


def _beam_init(S: int, K: int, L: int, device):
    """The empty beam of S rows: slot 0 holds the empty prefix."""
    p_b = torch.full((S, K), NEG, device=device)
    p_b[:, 0] = 0.0
    return (torch.zeros(S, K, L, dtype=torch.int32, device=device),
            torch.zeros(S, K, dtype=torch.int32, device=device), p_b,
            torch.full((S, K), NEG, device=device))


def _beam_view(beam_state, row: int, fusion=None):
    """Host view of one row's carried beam: (prefixes, lens, score, live).
    The score is the acoustic logaddexp(p_b, p_nb) in float64, plus lam *
    lm + beta * len on the live slots under fusion = (lam, beta) (the LM
    beam's layout). It is the JAX package's snapshot key, taken on the host
    in float64 there too, not ``decoding/beam.fused_score``'s float32 key:
    the streamed text picks its best hypothesis by it as the JAX stream
    does."""
    host = [t[row].cpu().numpy() for t in beam_state]
    if fusion is None:
        P, Ln, pb, pnb = host
    else:
        P, _, _, _, Ln, pb, pnb, lm_sc = host
    tot = np.logaddexp(pb.astype(np.float64), pnb.astype(np.float64))
    live = tot > NEG / 2
    if fusion is not None:
        lam, beta = fusion
        tot = np.where(live, tot + (lam * lm_sc.astype(np.float64)
                                    + beta * Ln), tot)
    return P, Ln, tot, live


def _agreed(prefixes, lens, live) -> int:
    """Length of the live beams' common prefix. Every live hypothesis
    extends an earlier live one by at most one symbol and pruning only
    removes rows, so it never shrinks: text up to it is final."""
    rows = prefixes[live]
    m = int(lens[live].min())
    agree = 0
    while agree < m and (rows[:, agree] == rows[0, agree]).all():
        agree += 1
    return agree


class StreamingTranscriber:
    """Incremental transcription of one audio stream.

    >>> st = StreamingTranscriber(params, cfg, alphabet)
    >>> for block in audio_blocks:
    ...     print(st.push(block), end="")
    >>> print(st.flush())

    Args (the JAX package's, plus ``device`` and ``use_kernel``):
      chunk_frames: committed frames per step (C), the emission grain.
      right_context: lookahead frames (R), the backward direction's
        window; adds R * hop_length samples of latency.
      norm: "streaming" (running statistics over committed frames) or a
        fixed (mean, var); fixed statistics with lookahead to the stream
        end reproduce the offline forward.
      left_context: transformer / conformer, exact left frames a window.
      lm: an n-gram table (decoding/lm.py) to fuse into the beam
        (decoder="beam"), with lm_weight and length_bonus (which needs
        an lm).
      device: where the device state lives and the steps run (default
        cuda); params are moved there.
      use_kernel: False runs the kernels' plain versions on any device.
    """

    def __init__(self, params, cfg: Config, alphabet,
                 chunk_frames: int = 64, right_context: int = 32,
                 norm: str | tuple = "streaming", left_context: int = 512,
                 timestamps: bool = False, decoder: str = "greedy",
                 beam_size: int = 8, max_label_len: int | None = None,
                 lm=None, lm_weight: float = 0.3,
                 length_bonus: float = 0.0,
                 device: torch.device | str = "cuda",
                 use_kernel: bool = True):
        self.rnnt = cfg.model.family == "transducer"
        if decoder not in ("greedy", "beam"):
            raise ValueError(f"decoder={decoder!r} (greedy or beam)")
        self.beam = decoder == "beam"
        if self.beam and (self.rnnt or cfg.model.family not in ("ctc",)):
            raise ValueError(
                "streaming beam search is implemented for the recurrent "
                f"CTC family (got {cfg.model.family!r}); the transducer "
                "streams its own frame-synchronous search and the "
                "attention families stream greedily")
        if self.beam and timestamps:
            raise ValueError("streaming timestamps use greedy emission "
                             "peaks; decoder='beam' revises hypotheses")
        self.K = int(beam_size)
        self.Lmax = int(max_label_len if max_label_len is not None
                        else min(cfg.decode.max_label_len, 512))
        if lm is not None and not self.beam:
            raise ValueError("streaming LM fusion needs decoder='beam'")
        if lm is None and length_bonus:
            raise ValueError(
                "length_bonus applies only under LM fusion (matching "
                "offline beam_decode, which ignores it without an LM); "
                "pass lm= or drop length_bonus")
        self._fusion = (None if lm is None
                        else fusion_coefficients(lm_weight, length_bonus))
        if timestamps and self.rnnt:
            raise ValueError("streaming timestamps use CTC emission peaks; "
                             "the transducer decoder is label-synchronous")
        self.timestamps = bool(timestamps)
        self.attention = cfg.model.family in ("transformer", "conformer")
        if self.rnnt and cfg.transducer.encoder != "bilstm":
            raise ValueError(
                "streaming transducer needs the recurrent encoder backbone "
                f"(TransducerConfig.encoder='bilstm', got "
                f"{cfg.transducer.encoder!r}): attention backbones require "
                "full left context")
        if cfg.model.family not in ("ctc", "transducer", "transformer",
                                    "conformer"):
            raise ValueError(
                f"family {cfg.model.family!r} has no streaming path "
                "(--model ctc/transducer/transformer/conformer)")
        if (self.attention and cfg.model.family == "transformer"
                and cfg.transformer.num_experts > 0):
            raise ValueError("MoE encoders have no streaming path yet")
        if cfg.features.kind != "logmel":
            raise ValueError("streaming supports logmel features only "
                             "(MFCC deltas use whole-utterance context)")
        self.device = resolve_device(str(device))
        self.use_kernel = use_kernel
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self._lm = (None if lm is None else torch.as_tensor(
            lm, dtype=torch.float32, device=self.device))
        # the BiLSTM encoder's parameters (the transducer's sit under
        # "encoder.")
        self._enc = ({k[len("encoder."):]: v for k, v in self.params.items()
                      if k.startswith("encoder.")} if self.rnnt
                     else self.params)
        self.cfg = cfg
        self.alphabet = alphabet
        self.chunk = int(chunk_frames)
        self.right = int(right_context)
        if self.attention:
            # chunk boundaries land on subsample boundaries, so a chunk
            # emits exactly chunk/s subframes
            s = (cfg.conformer.subsample
                 if cfg.model.family == "conformer"
                 else cfg.transformer.subsample)
            self.sub = s
            self.chunk = -(-self.chunk // s) * s
            self.right = -(-self.right // s) * s
            # left context in whole chunks: n_ctx grows chunk by chunk
            self.left = -(-int(left_context) // self.chunk) * self.chunk
        self.fixed_norm = not isinstance(norm, str)
        self._norm0 = ((float(norm[0]), float(norm[1]), 0.0)
                       if self.fixed_norm else (0.0, 0.0, 0.0))
        self.reset()

    def _stats0(self, S: int):
        return tuple(torch.full((S,), v, dtype=torch.float32,
                                device=self.device) for v in self._norm0)

    def _carries0(self, S: int):
        H = self.cfg.model.hidden_size
        dt = torch_dtype(self.cfg.model.dtype)
        return tuple((torch.zeros(S, H, dtype=dt, device=self.device),
                      torch.zeros(S, H, dtype=dt, device=self.device))
                     for _ in range(self.cfg.model.num_layers))

    def reset(self):
        self._carries = self._carries0(1)
        self._stats = self._stats0(1)
        self._buf = np.zeros((0,), np.float32)  # samples from _buf_start on
        self._buf_start = 0  # absolute index of _buf[0]
        self._n_samples = 0  # absolute samples received
        self._frames_done = 0
        self._prev_id = 0
        self._text: list[str] = []
        self._ended = False
        self._emitted = 0  # whole-stream label count (rnnt emission cap)
        self._words: list[dict] = []          # finalized word timings
        self._cur_word: list[tuple] = []      # (text, frame, logp, sub)
        if self.beam and self._lm is None:
            self._beam_state = _beam_init(1, self.K, self.Lmax, self.device)
        elif self.beam:
            self._beam_state = (torch.zeros(1, self.K, self.Lmax,
                                            dtype=torch.int32,
                                            device=self.device),
                                *_lm_state0(1, self.K, self.device))
        if self.beam:
            self._beam_emitted = 0  # common-prefix ids already emitted
        if self.rnnt:
            self._dec_state = init_decode_state(
                self.params, 1, torch_dtype(self.cfg.model.dtype))

    # -- host-side exact window assembly ------------------------------------
    def _sec_per_frame(self, sub: int) -> float:
        fcfg = self.cfg.features
        return fcfg.hop_length * sub / fcfg.sample_rate

    def _on_token(self, sym_id: int, frame: int, logp: float, sub: int):
        """Incremental word timings, with the conventions of
        decoding/greedy.assemble_word_timings: tokens anchor at their CTC
        emission peak, words split on a space or a BPE word marker, the
        confidence is the geometric mean of the word's token
        posteriors."""
        from .data.bpe import MARKER

        sym = self.alphabet.symbols[sym_id]
        if sym == " " or sym.startswith(MARKER):
            self._flush_word()
        text = self.alphabet.piece(sym_id).lstrip(" ")
        if text:
            self._cur_word.append((text, frame, logp, sub))

    def _flush_word(self):
        if not self._cur_word:
            return
        spf = self._sec_per_frame(self._cur_word[0][3])
        text = "".join(t for t, _, _, _ in self._cur_word).strip()
        if text:
            self._words.append({
                "word": text,
                "start": round(self._cur_word[0][1] * spf, 3),
                "end": round((self._cur_word[-1][1] + 1) * spf, 3),
                "conf": round(math.exp(
                    sum(l for _, _, l, _ in self._cur_word)
                    / len(self._cur_word)), 4),
            })
        self._cur_word.clear()

    @property
    def words(self) -> list[dict]:
        """Finalized word timings so far (timestamps=True). The word in
        progress finalizes at the next boundary or at flush()."""
        return list(self._words)

    def _beam_snapshot(self):
        """Host view of the carried beam: (prefixes, lens, score, live),
        the score the decision key (acoustic, plus lam * lm + beta * len
        under fusion)."""
        return _beam_view(self._beam_state, 0, self._fusion)

    @property
    def partial_text(self) -> str:
        """decoder='beam': the current best hypothesis (later audio may
        still revise it, unlike the emitted `text`, the live beams' agreed
        prefix)."""
        if not self.beam:
            return self.text
        prefixes, lens, tot, live = self._beam_snapshot()
        if not live.any():
            return ""
        best = int(np.where(live, tot, -np.inf).argmax())
        return "".join(self.alphabet.piece(int(i))
                       for i in prefixes[best, :lens[best]])

    def _window_samples(self, f0: int, wf: int | None = None) -> np.ndarray:
        """Samples backing frames [f0, f0 + wf): absolute range
        [f0*hop - pad, (f0 + wf - 1)*hop + pad), reflect-padded at the
        stream start, zero past the stream end (the offline semantics,
        where batch zero-padding follows the utterance)."""
        fcfg = self.cfg.features
        pad = fcfg.n_fft // 2
        if wf is None:
            wf = self.chunk + self.right
        lo = f0 * fcfg.hop_length - pad
        hi = (f0 + wf - 1) * fcfg.hop_length + pad
        out = np.zeros((hi - lo,), np.float32)
        a, b = max(lo, 0), min(hi, self._n_samples)
        if b > a:
            out[a - lo:b - lo] = self._buf[a - self._buf_start:
                                           b - self._buf_start]
        if lo < 0:
            # reflect (no edge repeat): sample[-k] == sample[k]
            k = -lo
            n = min(k, max(self._n_samples - 1, 0))
            out[k - n:k] = self._buf[1:1 + n][::-1]
        return out

    def _ready(self, f0: int) -> bool:
        """All real samples for the window exist (mid-stream)."""
        fcfg = self.cfg.features
        wf = self.chunk + self.right
        return (f0 + wf - 1) * fcfg.hop_length + fcfg.n_fft // 2 \
            <= self._n_samples

    def _total_frames(self) -> int:
        return self._n_samples // self.cfg.features.hop_length + 1

    def _drop_samples(self, back_frames: int = 0) -> None:
        """Drop buffered samples that no later window needs (a window
        reaches back `back_frames` before the next committed frame)."""
        fcfg = self.cfg.features
        keep_from = max((self._frames_done - back_frames) * fcfg.hop_length
                        - fcfg.n_fft // 2, 0)
        if keep_from > self._buf_start:
            self._buf = self._buf[keep_from - self._buf_start:]
            self._buf_start = keep_from

    def _ints(self, *values: int) -> list[torch.Tensor]:
        return [torch.tensor([v], dtype=torch.int32, device=self.device)
                for v in values]

    def _collapse(self, ids, lp_max, frame0: int, sub: int) -> list[str]:
        """Greedy CTC collapse of one chunk's ids, the previous id carried
        across chunks; word timings as the tokens come."""
        out = []
        for j, i in enumerate(ids):
            i = int(i)
            if i != self._prev_id and i != 0:
                out.append(self.alphabet.piece(i))
                if self.timestamps:
                    self._on_token(i, frame0 + j, float(lp_max[j]), sub=sub)
            self._prev_id = i
        return out

    def _emit_agreed(self, prefixes, lens, live) -> list[str]:
        """The live beams' agreed prefix past what was emitted."""
        if not live.any():
            return []
        agree = _agreed(prefixes, lens, live)
        row = prefixes[live][0]
        out = [self.alphabet.piece(int(i))
               for i in row[self._beam_emitted:agree]]
        self._beam_emitted = max(agree, self._beam_emitted)
        return out

    @torch.no_grad()
    def _run_chunk(self, n_valid: int, n_committed: int) -> str:
        if self.attention:
            return self._run_chunk_attention(n_valid, n_committed)
        window = torch.from_numpy(
            self._window_samples(self._frames_done)).to(self.device)[None]
        nv, nc = self._ints(n_valid, n_committed)
        if self.rnnt:
            (n_emit,) = self._ints(self._emitted)
            ids, n_emit, self._stats, self._carries, self._dec_state = (
                _chunk_step_rnnt(
                    self.params, self._enc, window, self._stats,
                    self._carries, self._dec_state, n_emit, nv, nc,
                    self.cfg, self.chunk, self.fixed_norm,
                    self.cfg.transducer.max_symbols_per_frame,
                    self.use_kernel))
            n = int(n_emit[0])
            out = [self.alphabet.piece(int(i)) for i in ids[0, :n].tolist()]
            self._emitted += len(out)
        elif self.beam:
            if self._lm is None:
                step = _chunk_step_beam(
                    self.params, window, self._stats, self._carries,
                    self._beam_state, nv, nc, self.cfg, self.chunk,
                    self.fixed_norm, self.K, self.Lmax, self.use_kernel)
            else:
                step = _chunk_step_beam_lm(
                    self.params, window, self._stats, self._carries,
                    self._beam_state, self._lm, *self._fusion, nv, nc,
                    self.cfg, self.chunk, self.fixed_norm, self.K, self.Lmax,
                    self.use_kernel)
            self._beam_state, self._stats, self._carries = step
            prefixes, lens, _, live = self._beam_snapshot()
            out = self._emit_agreed(prefixes, lens, live)
        else:
            ids, lp_max, self._stats, self._carries = _chunk_step(
                self.params, window, self._stats, self._carries, nv, nc,
                self.cfg, self.chunk, self.fixed_norm, self.use_kernel)
            out = self._collapse(ids[0, :n_committed].tolist(),
                                 lp_max[0, :n_committed].tolist(),
                                 self._frames_done, sub=1)
        self._frames_done += n_committed
        self._drop_samples()
        piece = "".join(out)
        self._text.append(piece)
        return piece

    def _run_chunk_attention(self, n_valid: int, n_committed: int) -> str:
        """Attention families: overlapping windows over [f0 - n_ctx, f0 +
        C + R) raw frames, all real audio (n_ctx grows chunk by chunk up to
        left_context); only the committed C subframes are emitted."""
        f0 = self._frames_done
        n_ctx = min(f0, self.left)  # a multiple of chunk by construction
        wf = n_ctx + self.chunk + self.right
        window = torch.from_numpy(
            self._window_samples(f0 - n_ctx, wf)).to(self.device)[None]
        nv, nc = self._ints(n_ctx + n_valid, n_committed)
        ids, lp_max, self._stats = _chunk_step_attention(
            self.params, window, self._stats, nv, nc, f0 - n_ctx, self.cfg,
            n_ctx, self.chunk, self.fixed_norm, self.use_kernel)
        n_emit = -(-n_committed // self.sub)  # ceil: offline out_lens
        out = self._collapse(ids[0, :n_emit].tolist(),
                             lp_max[0, :n_emit].tolist(), f0 // self.sub,
                             sub=self.sub)
        self._frames_done += n_committed
        self._drop_samples(self.left)
        text = "".join(out)
        self._text.append(text)
        return text

    # -- public API ----------------------------------------------------------
    def push(self, samples: np.ndarray) -> str:
        """Feed raw float32 samples; returns newly emitted text."""
        if self._ended:
            raise RuntimeError("push() after flush(); call reset() first")
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, samples])
        self._n_samples += len(samples)
        emitted = []
        wf = self.chunk + self.right
        while self._ready(self._frames_done):
            emitted.append(self._run_chunk(n_valid=wf,
                                           n_committed=self.chunk))
        return "".join(emitted)

    def flush(self) -> str:
        """End of stream: process the remaining frames and return the text
        they emit."""
        if self._ended:
            return ""
        self._ended = True
        total = self._total_frames() if self._n_samples > 0 else 0
        emitted = []
        while self._frames_done < total:
            left = total - self._frames_done
            emitted.append(self._run_chunk(
                n_valid=min(left, self.chunk + self.right),
                n_committed=min(left, self.chunk)))
        if self.timestamps:
            self._flush_word()  # finalize the word in progress
        if self.beam:
            rest = self._beam_rest(self._beam_snapshot())
            if rest:
                self._text.append(rest)
                emitted.append(rest)
        return "".join(emitted)

    def _beam_rest(self, snapshot) -> str:
        """End of stream: the best hypothesis is final; its remainder past
        the agreed prefix emitted so far."""
        prefixes, lens, tot, live = snapshot
        if not live.any():
            return ""
        best = int(np.where(live, tot, -np.inf).argmax())
        rest = "".join(self.alphabet.piece(int(i))
                       for i in prefixes[best, self._beam_emitted:lens[best]])
        self._beam_emitted = int(lens[best])
        return rest

    @property
    def text(self) -> str:
        """Everything emitted so far."""
        return "".join(self._text)


class BatchedStreamingTranscriber:
    """S concurrent audio streams through one batched chunk step.

    Every tick stacks the slots' windows into one (S, L) step, so the
    device sees S-row products and, on CUDA, one ``lstm_fwd`` launch a
    layer for all slots. Idle slots ride along with zero valid and
    committed masks: the masked scans keep their (h, c), the running norm
    adds nothing and their beams take no frame, so their state freezes.

    Per-slot host state (sample buffer, collapse carry, text) lives in
    embedded single-stream transcribers; the device state (LSTM carries,
    norm statistics, beams) lives stacked (S, ...) here. CTC BiLSTM family
    only (the carried-state path).

    >>> srv = BatchedStreamingTranscriber(params, cfg, alphabet, slots=8)
    >>> a, b = srv.open(), srv.open()
    >>> srv.push(a, wave_a); srv.push(b, wave_b)
    >>> emitted = srv.step()         # {slot: new_text} for ready slots
    >>> final_a = srv.flush(a); srv.close(a)
    """

    def __init__(self, params, cfg: Config, alphabet, slots: int = 8,
                 chunk_frames: int = 64, right_context: int = 32,
                 norm: str | tuple = "streaming", decoder: str = "greedy",
                 beam_size: int = 8, max_label_len: int | None = None,
                 device: torch.device | str = "cuda",
                 use_kernel: bool = True):
        if cfg.model.family != "ctc":
            raise ValueError(
                "batched streaming serves the CTC BiLSTM family (carried-"
                f"state path); got {cfg.model.family!r} — run attention/"
                "RNN-T streams through StreamingTranscriber")
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if decoder not in ("greedy", "beam"):
            raise ValueError(f"decoder={decoder!r} (greedy or beam)")
        self.beam = decoder == "beam"
        self.alphabet = alphabet
        self.slots = slots
        self._st = [StreamingTranscriber(params, cfg, alphabet,
                                         chunk_frames=chunk_frames,
                                         right_context=right_context,
                                         norm=norm, decoder=decoder,
                                         beam_size=beam_size,
                                         max_label_len=max_label_len,
                                         device=device,
                                         use_kernel=use_kernel)
                    for _ in range(slots)]
        proto = self._st[0]
        self.params, self.device = proto.params, proto.device
        self.use_kernel = use_kernel
        self.cfg, self.chunk, self.right = proto.cfg, proto.chunk, proto.right
        self.fixed_norm = proto.fixed_norm
        self.K, self.Lmax = proto.K, proto.Lmax
        self._carries = proto._carries0(slots)
        self._stats = proto._stats0(slots)
        if self.beam:
            self._beam_state = _beam_init(slots, self.K, self.Lmax,
                                          self.device)
        self._is_open = [False] * slots

    # -- session lifecycle ---------------------------------------------------
    def open(self) -> int:
        """Claim a free slot for a new stream; returns the slot id."""
        try:
            i = self._is_open.index(False)
        except ValueError:
            raise RuntimeError(f"all {self.slots} slots busy") from None
        self._is_open[i] = True
        self._st[i].reset()
        for h, c in self._carries:
            h[i] = 0
            c[i] = 0
        for s, v in zip(self._stats, self._st[i]._norm0):
            s[i] = v
        if self.beam:
            P, Ln, pb, pnb = self._beam_state
            P[i], Ln[i], pb[i], pnb[i] = 0, 0, NEG, NEG
            pb[i, 0] = 0.0
        return i

    def close(self, slot: int) -> None:
        self._is_open[slot] = False

    def push(self, slot: int, samples: np.ndarray) -> None:
        """Buffer raw float32 samples for one slot (no device work: its
        chunks run at the next step())."""
        if not self._is_open[slot]:
            raise RuntimeError(f"slot {slot} is not open")
        st = self._st[slot]
        if st._ended:
            raise RuntimeError("push() after flush(); close + open anew")
        samples = np.asarray(samples, np.float32).reshape(-1)
        st._buf = np.concatenate([st._buf, samples])
        st._n_samples += len(samples)

    # -- the lockstep tick -----------------------------------------------
    def _window_len(self) -> int:
        fcfg = self.cfg.features
        wf = self.chunk + self.right
        return (wf - 1) * fcfg.hop_length + 2 * (fcfg.n_fft // 2)

    @torch.no_grad()
    def _run(self, work: list[tuple[int, int, int]]) -> dict[int, str]:
        """One batched step over `work` = [(slot, n_valid, n_committed)];
        the other slots freeze. Returns {slot: new_text}."""
        if not work:
            return {}
        S = self.slots
        windows = np.zeros((S, self._window_len()), np.float32)
        nv = np.zeros((S,), np.int32)
        nc = np.zeros((S,), np.int32)
        for i, v, c in work:
            st = self._st[i]
            windows[i] = st._window_samples(st._frames_done)
            nv[i], nc[i] = v, c
        w = torch.from_numpy(windows).to(self.device)
        nv, nc = (torch.from_numpy(a).to(self.device) for a in (nv, nc))
        if self.beam:
            self._beam_state, self._stats, self._carries = _chunk_step_beam(
                self.params, w, self._stats, self._carries, self._beam_state,
                nv, nc, self.cfg, self.chunk, self.fixed_norm, self.K,
                self.Lmax, self.use_kernel)
        else:
            ids, _, self._stats, self._carries = _chunk_step(
                self.params, w, self._stats, self._carries, nv, nc, self.cfg,
                self.chunk, self.fixed_norm, self.use_kernel)
            ids = ids.cpu().numpy()
        out: dict[int, str] = {}
        for i, _, c in work:
            st = self._st[i]
            if self.beam:
                P, Ln, _, live = _beam_view(self._beam_state, i)
                toks = st._emit_agreed(P, Ln, live)
            else:
                toks = st._collapse(ids[i, :c], None, 0, sub=1)
            st._frames_done += c
            st._drop_samples()
            text = "".join(toks)
            st._text.append(text)
            out[i] = text
        return out

    def step(self) -> dict[int, str]:
        """Process one chunk for every open slot with a full window ready.
        Returns {slot: newly emitted text} for the slots that ran."""
        wf = self.chunk + self.right
        work = [(i, wf, self.chunk) for i in range(self.slots)
                if self._is_open[i]
                and self._st[i]._ready(self._st[i]._frames_done)]
        return self._run(work)

    def drain(self) -> dict[int, str]:
        """step() until no slot has a ready chunk; concatenates emissions."""
        out: dict[int, str] = {}
        while True:
            got = self.step()
            if not got:
                return out
            for i, t in got.items():
                out[i] = out.get(i, "") + t

    def flush(self, slot: int) -> str:
        """End of one stream: process its remaining frames (the other
        slots idle through the same batched steps) and return the text
        emitted."""
        st = self._st[slot]
        if st._ended:
            return ""
        st._ended = True
        wf = self.chunk + self.right
        total = st._total_frames() if st._n_samples > 0 else 0
        pieces = []
        while st._frames_done < total:
            left = total - st._frames_done
            got = self._run([(slot, min(left, wf), min(left, self.chunk))])
            pieces.append(got.get(slot, ""))
        if self.beam:
            rest = st._beam_rest(_beam_view(self._beam_state, slot))
            if rest:
                st._text.append(rest)
                pieces.append(rest)
        return "".join(pieces)

    def text(self, slot: int) -> str:
        """Everything the slot has emitted so far."""
        return self._st[slot].text
