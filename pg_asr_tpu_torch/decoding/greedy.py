"""Batched greedy CTC decoding on the device (counterpart of
pg_asr_tpu/decoding/greedy.py): argmax -> drop repeats -> drop blanks ->
left-compact, as masked tensor ops. Only the final (B, T) ids leave the
device."""

from __future__ import annotations

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


def ids_to_strings(labels, lengths, alphabet) -> list[str]:
    """Host-side: map compacted id rows to strings (tokenizer-aware)."""
    labels = labels.cpu().numpy() if torch.is_tensor(labels) else labels
    lengths = lengths.cpu().numpy() if torch.is_tensor(lengths) else lengths
    return [alphabet.decode(row[: int(n)]) for row, n in zip(labels, lengths)]
