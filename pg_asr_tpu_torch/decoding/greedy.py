"""Batched greedy CTC decoding on the device (counterpart of
pg_asr_tpu/decoding/greedy.py): argmax -> drop repeats -> drop blanks ->
left-compact, as masked tensor ops. Only the final (B, T) ids leave the
device. ``greedy_decode_with_timing`` also returns each token's onset
frame and log-posterior (``--timestamps``, ``--mode pseudolabel``), and
``assemble_word_timings`` groups them into words on the host."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..data import BLANK_ID


def collapse_frame_ids(frame_ids: torch.Tensor, frame_mask: torch.Tensor):
    """CTC-collapse per-frame symbol ids: merge repeats, drop blanks, compact.

    frame_ids: (B, T) int per-frame symbols. Returns (labels (B, T) int32
    0-padded, lengths (B,) int32)."""
    best = frame_ids.to(torch.int64)
    valid = frame_mask.to(torch.bool)
    prev = F.pad(best[:, :-1], (1, 0), value=BLANK_ID)
    keep = (best != BLANK_ID) & (best != prev) & valid
    B, T = best.shape
    # target slot of each kept id; the rest go to an overflow slot T
    pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1, T)
    out = torch.zeros(B, T + 1, dtype=torch.int64, device=best.device)
    out.scatter_(1, pos, best)
    return out[:, :T].to(torch.int32), keep.sum(dim=1).to(torch.int32)


def greedy_decode(log_probs: torch.Tensor, frame_mask: torch.Tensor):
    """(B, T, A) log-posteriors + (B, T) mask -> (labels (B, T), lengths (B,)).
    argmax takes the first maximum on ties, as jnp.argmax does."""
    return collapse_frame_ids(torch.argmax(log_probs, dim=-1), frame_mask)


def greedy_decode_with_timing(log_probs: torch.Tensor,
                              frame_mask: torch.Tensor):
    """Greedy CTC decode that also says where and how confidently each
    token was emitted. A collapsed token is anchored at its onset frame
    (the first frame of its repeat-run); its confidence is its
    log-posterior at that frame (exp of the mean over tokens is a
    geometric-mean utterance confidence).

    Returns labels (B, T) int32 left-compacted (0-padded), lengths (B,)
    int32, onsets (B, T) int32 (frame of each token, in the model's output
    frames) and token_logp (B, T) float32."""
    best = torch.argmax(log_probs, dim=-1)  # (B, T), first max on ties
    logp_best = log_probs.max(dim=-1).values.float()
    valid = frame_mask.to(torch.bool)
    prev = F.pad(best[:, :-1], (1, 0), value=BLANK_ID)
    keep = (best != BLANK_ID) & (best != prev) & valid
    B, T = best.shape
    pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1, T)
    frames = torch.arange(T, device=best.device).expand(B, T)

    def compact(values, dtype):
        out = torch.zeros(B, T + 1, dtype=dtype, device=best.device)
        out.scatter_(1, pos, values.to(dtype))
        return out[:, :T]

    return (compact(best, torch.int64).to(torch.int32),
            keep.sum(dim=1).to(torch.int32),
            compact(frames, torch.int64).to(torch.int32),
            compact(logp_best, torch.float32))


def assemble_word_timings(ids, length, onsets, token_logp, alphabet,
                          sec_per_frame: float):
    """Host side: one utterance's token onsets -> per-word start, end
    (seconds, 3 decimals) and confidence (4 decimals). Words break at a
    literal " " symbol (characters) or a word-start-marker token (BPE). A
    word ends one frame after its last token's onset (tokens anchor at
    emission peaks, not spans); its confidence is the geometric mean of
    its tokens' posteriors."""
    from ..data.bpe import MARKER

    words = []
    cur: list[tuple[str, int, float]] = []  # (text, frame, logp)

    def flush():
        if not cur:
            return
        text = "".join(t for t, _, _ in cur).strip()
        if text:
            words.append({
                "word": text,
                "start": round(cur[0][1] * sec_per_frame, 3),
                "end": round((cur[-1][1] + 1) * sec_per_frame, 3),
                "conf": round(math.exp(sum(lp for _, _, lp in cur)
                                       / len(cur)), 4),
            })
        cur.clear()

    for j in range(int(length)):
        sym = alphabet.symbols[int(ids[j])]
        boundary = sym == " " or sym.startswith(MARKER)
        if boundary:
            flush()
        piece = alphabet.piece(int(ids[j]))
        text = piece if not boundary else piece.lstrip(" ")
        if text:
            cur.append((text, int(onsets[j]), float(token_logp[j])))
    flush()
    return words


def ids_to_strings(labels, lengths, alphabet) -> list[str]:
    """Host-side: map compacted id rows to strings (tokenizer-aware)."""
    labels = labels.cpu().numpy() if torch.is_tensor(labels) else labels
    lengths = lengths.cpu().numpy() if torch.is_tensor(lengths) else lengths
    return [alphabet.decode(row[: int(n)]) for row, n in zip(labels, lengths)]
