"""RNN-T (transducer) loss (counterpart of pg_asr_tpu/ops/transducer.py).

Lattice: alpha(t, u) = log P(labels[:u] emitted | frames up to t),
    alpha(t, u) = logaddexp(alpha(t-1, u) + blank(t-1, u),
                            alpha(t, u-1) + y(t, u-1)),
with -log P = -(alpha(T_b-1, U_b) + blank(T_b-1, U_b)). As in the JAX
package, one loop walks the T+U anti-diagonals d = t + u (every cell of a
diagonal depends only on the previous one), after a single relayout of the
emission tables to diagonal-major rows; NEG = -1e30 stands for -inf, and
no validity mask is needed inside the recursion: the read-out cell
(T_b-1, U_b) is reachable only through t < T_b, u <= U_b.

Plain PyTorch under autograd (no TPU kernel lies under it). Conventions
match ops/ctc.py: blank = 0, labels 0-padded (B, U) with true lengths
(B,), per-utterance NLL and (num, den) terms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1.0e30  # finite -inf stand-in: keeps gradients NaN-free


def joint_log_probs(logits: torch.Tensor, labels: torch.Tensor,
                    blank: int = 0):
    """(B, T, U+1, A) joint logits (any float type; normalised in float32)
    and (B, U) 0-padded labels -> (lp_blank (B, T, U+1), lp_label (B, T,
    U)): log P(blank | t, u) and log P(labels[u] | t, u). The label's
    logit is gathered, which equals the JAX package's one-hot product."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)  # (B, T, U+1)
    lp_blank = logits[..., blank] - lse
    B, T, U1, _ = logits.shape
    idx = labels.long()[:, None, :, None].expand(B, T, U1 - 1, 1)
    num = torch.gather(logits[:, :, :-1, :], -1, idx)[..., 0]
    return lp_blank, num - lse[:, :, :-1]


def transducer_loss(lp_blank: torch.Tensor, lp_label: torch.Tensor,
                    frame_lens: torch.Tensor,
                    label_lens: torch.Tensor) -> torch.Tensor:
    """Per-utterance transducer NLL -> (B,) float32.

    lp_blank (B, T, U+1), lp_label (B, T, U); frame_lens (B,) valid frames
    (>= 1 for real rows); label_lens (B,) (0 marks batch-padding rows)."""
    lp_blank = lp_blank.float()
    lp_label = lp_label.float()
    B, T, U1 = lp_blank.shape
    U = U1 - 1
    dev = lp_blank.device
    # diagonal-major relayout, once: BL[b, d, u] = lp_blank[b, d - u, u],
    # Y[b, d, u] = lp_label[b, d - u, u - 1] (left-padded with NEG)
    D = T + U
    u_idx = torch.arange(U1, device=dev)[None, :]
    t_idx = torch.arange(D, device=dev)[:, None] - u_idx  # (D, U1)
    t_ok = (t_idx >= 0) & (t_idx < T)
    t_clip = t_idx.clamp(0, T - 1)
    BL = torch.where(t_ok[None], lp_blank[:, t_clip, u_idx], NEG)
    if U > 0:
        YD = torch.where(t_ok[None, :, :U],
                         lp_label[:, t_clip[:, :U], u_idx[:, :U]], NEG)
        Y = F.pad(YD, (1, 0), value=NEG)
    else:
        Y = torch.full((B, D, U1), NEG, device=dev)

    # rows by unbind (its backward stacks the rows' gradients once; a
    # per-step index would allocate a (B, D, U+1) gradient at every step)
    BL_rows, Y_rows = BL.unbind(1), Y.unbind(1)
    neg = torch.full((B, 1), NEG, device=dev)
    alpha = torch.where(u_idx == 0, 0.0, NEG).expand(B, U1)
    alphas = [alpha]
    for d in range(1, D):
        stay = alpha + BL_rows[d - 1]  # blank: (t-1, u) -> (t, u)
        adv = torch.cat([neg, alpha[:, :-1]], dim=1) + Y_rows[d - 1]
        alpha = torch.logaddexp(stay, adv)
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=0)  # (D, B, U1)

    # read-out: alpha(T_b - 1, U_b) lives on diagonal T_b - 1 + U_b
    b_idx = torch.arange(B, device=dev)
    t_fin = (frame_lens.long() - 1).clamp(min=0)
    u_fin = label_lens.long().clamp(max=U)
    a_fin = alphas[t_fin + u_fin, b_idx, u_fin]
    bl_fin = lp_blank[b_idx, t_fin, u_fin]
    return -(a_fin + bl_fin)


def transducer_loss_terms(lp_blank, lp_label, frame_lens, label_lens,
                          label_normalize: bool = True):
    """(numerator, denominator) of the batch-mean loss: rows with no
    labels (batch padding) and rows whose NLL is ~1e30 are left out, as in
    the JAX package."""
    nll = transducer_loss(lp_blank, lp_label, frame_lens, label_lens)
    finite = (nll < 0.5e30) & (label_lens > 0)
    if label_normalize:
        nll = nll / torch.clamp(label_lens.float(), min=1.0)
    nll = torch.where(finite, nll, 0.0)
    return nll.sum(), finite.float().sum()


def transducer_loss_mean(lp_blank, lp_label, frame_lens, label_lens,
                         label_normalize: bool = True) -> torch.Tensor:
    num, den = transducer_loss_terms(lp_blank, lp_label, frame_lens,
                                     label_lens, label_normalize)
    return num / torch.clamp(den, min=1.0)
