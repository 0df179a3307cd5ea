"""Sequence losses of the attention seq2seq family (counterpart of
pg_asr_tpu/losses.py).

Pad (index 0) doubles as end-of-sequence. ``seq2seq_nll_loss`` masks
decoder steps by true target length and, with ``include_eos``, keeps the
first pad slot after each target in the loss, so that free-running
generation learns to stop. Every loss is a sum over decoder steps of a
per-step batch mean; ``seq2seq_nll_terms`` returns the per-step
numerators and denominators, (Td,) each, and every consumer sums their
quotients (the policy-gradient anchor, rl/reinforce.py, too).
"""

from __future__ import annotations

import torch

PAD_ID = 0


def _token_nll(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(B, T, A) log-probs, (B, T) ids -> (B, T) negative log-probs."""
    return -torch.gather(log_probs, -1, targets.long()[..., None])[..., 0]


def summed_nll_loss(log_probs: torch.Tensor, targets: torch.Tensor,
                    ignore_index: int | None = PAD_ID) -> torch.Tensor:
    """Sum over time steps of the per-step batch-mean NLL; targets equal to
    ``ignore_index`` are left out of each step's mean (None keeps all)."""
    nll = _token_nll(log_probs, targets)
    if ignore_index is None:
        return nll.mean(0).sum()
    keep = (targets != ignore_index).to(log_probs.dtype)
    return ((nll * keep).sum(0) / torch.clamp(keep.sum(0), min=1.0)).sum()


def seq2seq_nll_terms(log_probs: torch.Tensor, targets: torch.Tensor,
                      target_lens: torch.Tensor, include_eos: bool = True):
    """Per-decoder-step (numerator (Td,), denominator (Td,)) of the
    seq2seq loss: the NLL summed over the utterances still active at each
    step (position < target_len, + 1 with ``include_eos``) and their count.
    Rows of length 0 are batch padding and left out."""
    nll = _token_nll(log_probs, targets)
    pos = torch.arange(targets.shape[1], device=targets.device)[None, :]
    lim = target_lens.long()[:, None] + (1 if include_eos else 0)
    keep = ((pos < lim) & (target_lens[:, None] > 0)).to(log_probs.dtype)
    return (nll * keep).sum(0), keep.sum(0)


def seq2seq_nll_loss(log_probs: torch.Tensor, targets: torch.Tensor,
                     target_lens: torch.Tensor,
                     include_eos: bool = True) -> torch.Tensor:
    """Training loss of the attention seq2seq family: the sum over decoder
    steps of the batch-mean NLL over the utterances active at that step.
    log_probs (B, Td, A); targets (B, Td) 0-padded; target_lens (B,)."""
    num, den = seq2seq_nll_terms(log_probs, targets, target_lens, include_eos)
    return (num / torch.clamp(den, min=1.0)).sum()


def masked_mean_nll(log_probs: torch.Tensor, targets: torch.Tensor,
                    ignore_index: int = PAD_ID) -> torch.Tensor:
    """Token-mean NLL over the non-pad positions."""
    nll = _token_nll(log_probs, targets)
    keep = (targets != ignore_index).to(log_probs.dtype)
    return (nll * keep).sum() / torch.clamp(keep.sum(), min=1.0)
