"""CTC loss (counterpart of pg_asr_tpu/ops/ctc.py).

Conventions: blank = 0 (= '<pad>'), labels 0-padded (B, L) with true
lengths (B,), log_probs per-frame log-posteriors (B, T, A) with frame
lengths (B,).

Two implementations of one loss:
  * ``ctc_loss`` / ``ctc_loss_terms`` / ``ctc_loss_mean``: a transcription
    of the JAX package's log-space alpha recursion (NEG = -1e30 as a finite
    -inf, the can_skip and alive masks, frames past frame_lens leave alpha
    unchanged), differentiated by autograd, so its gradient with respect to
    log_probs is the true one. The reference the tests hold everything
    against, and the loss of the plain path (``use_kernel=False``).
  * ``ctc_loss_terms_fused``: one ``F.ctc_loss`` call per direction of
    autograd (the training path; a Python loop over T costs thousands of
    launches on the card). Its gradient with respect to log_probs is
    exp(log_probs) - posterior, which assumes log_probs is a log-softmax:
    after the model's log_softmax it gives the true gradient with respect to
    the logits and so to every parameter (tests/test_torch_train.py holds
    its parameter gradients against the plain loss's).

Both drop rows before the label-length normalisation exactly where the JAX
package does: rows with no alignment (too few frames; the recursion gives
nll ~ 1e30 there, which ``nll < 0.5e30`` rejects) and rows with no labels
(batch padding).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1.0e30  # finite -inf stand-in: keeps gradients NaN-free


def _extend_labels(labels: torch.Tensor, blank: int) -> torch.Tensor:
    """(B, L) labels -> (B, 2L+1) blank-interleaved extended sequence."""
    B, L = labels.shape
    z = torch.full((B, 2 * L + 1), blank, dtype=labels.dtype,
                   device=labels.device)
    z[:, 1::2] = labels
    return z


def ctc_loss(log_probs: torch.Tensor, frame_lens: torch.Tensor,
             labels: torch.Tensor, label_lens: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Per-utterance CTC negative log-likelihood -> (B,) float32 (~1e30 where
    no alignment exists)."""
    lp = log_probs.float()
    B, T, _ = lp.shape
    label_lens = label_lens.long()
    frame_lens = frame_lens.long()
    z = _extend_labels(labels.long(), blank)  # (B, S)
    S = z.shape[1]
    # a skip transition into s is allowed when z[s] != blank, z[s] != z[s-2]
    z_shift2 = F.pad(z[:, :-2], (2, 0), value=blank)
    can_skip = (z != blank) & (z != z_shift2)
    alive = torch.arange(S, device=lp.device)[None] < (2 * label_lens[:, None] + 1)
    # em[b, t, s] = lp[b, t, z[b, s]] (the JAX package's one-hot einsum)
    em_all = torch.gather(lp, 2, z[:, None, :].expand(B, T, S))

    neg = torch.full((B, S), NEG, device=lp.device)
    e0 = em_all[:, 0]
    alpha = torch.cat([e0[:, :1], torch.where(label_lens[:, None] > 0,
                                              e0[:, 1:2], neg[:, 1:2]),
                       neg[:, 2:]], dim=1) if S > 1 else e0[:, :1]
    alpha = torch.where(alive, alpha, neg)
    for t in range(1, T):
        a1 = F.pad(alpha[:, :-1], (1, 0), value=NEG)
        a2 = F.pad(alpha[:, :-2], (2, 0), value=NEG)
        acc = torch.logaddexp(alpha, a1)
        acc = torch.where(can_skip, torch.logaddexp(acc, a2), acc)
        new = torch.where(alive, acc + em_all[:, t], neg)
        # frames past each utterance's length leave alpha untouched
        alpha = torch.where((t < frame_lens)[:, None], new, alpha)

    # final states: last blank (2*len) and last label (2*len - 1)
    idx_last = 2 * label_lens[:, None]
    a_blank = torch.gather(alpha, 1, idx_last)[:, 0]
    a_label = torch.gather(alpha, 1, torch.clamp(idx_last - 1, min=0))[:, 0]
    total = torch.where(label_lens > 0, torch.logaddexp(a_blank, a_label),
                        a_blank)
    return -total


def _reduce_terms(nll, finite, label_lens, label_normalize: bool):
    if label_normalize:
        nll = nll / torch.clamp(label_lens.float(), min=1.0)
    nll = torch.where(finite, nll, torch.zeros_like(nll))
    return nll.sum(), finite.float().sum()


def ctc_loss_terms(log_probs, frame_lens, labels, label_lens, blank: int = 0,
                   label_normalize: bool = True):
    """(numerator, denominator) of the batch-mean CTC loss, both scalars.
    Rows with no alignment and rows with no labels are excluded BEFORE the
    label-length normalisation."""
    nll = ctc_loss(log_probs, frame_lens, labels, label_lens, blank)
    finite = (nll < 0.5e30) & (label_lens > 0)
    return _reduce_terms(nll, finite, label_lens, label_normalize)


def ctc_loss_mean(log_probs, frame_lens, labels, label_lens, blank: int = 0,
                  label_normalize: bool = True) -> torch.Tensor:
    """Scalar training loss: mean over the kept rows of the per-utterance
    NLL, normalised by label length."""
    num, den = ctc_loss_terms(log_probs, frame_lens, labels, label_lens,
                              blank, label_normalize)
    return num / torch.clamp(den, min=1.0)


def alignable(frame_lens: torch.Tensor, labels: torch.Tensor,
              label_lens: torch.Tensor) -> torch.Tensor:
    """(B,) bool: a CTC alignment of the labels fits in the frames, i.e.
    frames >= labels + adjacent repeats (each repeat needs a blank between).
    Exactly where the JAX recursion's nll stays below 0.5e30."""
    L = labels.shape[1]
    label_lens = label_lens.long()
    pos = torch.arange(1, L, device=labels.device)[None]
    repeats = ((labels[:, 1:] == labels[:, :-1])
               & (pos < label_lens[:, None])).sum(dim=1)
    return torch.clamp(frame_lens.long(), min=1) >= label_lens + repeats


def ctc_loss_terms_fused(log_probs, frame_lens, labels, label_lens,
                         blank: int = 0, label_normalize: bool = True):
    """``ctc_loss_terms`` through one ``F.ctc_loss`` call. Only for
    log_probs that are a log-softmax (see the module docstring)."""
    nll = F.ctc_loss(log_probs.float().transpose(0, 1), labels.long(),
                     frame_lens.long(), label_lens.long(), blank=blank,
                     reduction="none", zero_infinity=True)
    finite = alignable(frame_lens, labels, label_lens) & (label_lens > 0)
    return _reduce_terms(nll, finite, label_lens, label_normalize)
