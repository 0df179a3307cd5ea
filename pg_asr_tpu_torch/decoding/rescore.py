"""Two-pass n-best rescoring with the neural LM (counterpart of
pg_asr_tpu/decoding/rescore.py), the alternative to fusing it in the beam
(decoding/beam.py ``neural_lm=``).

First pass: the exact CTC prefix beam's K-best list (distinct label
sequences, ``beam_decode_nbest``: one ``ctc_beam`` launch on CUDA tensors).
Second pass: every hypothesis re-scored by one teacher-forced LM pass over
the B*K rows (``neural_lm.lm_sequence_logp``: ``lstm_fwd`` a layer on
CUDA), and the list re-ranked by

    score = log P_am(h|x) + lm_weight * log P_lm(h) + length_bonus * |h|
"""

from __future__ import annotations

import torch

from .beam import _take, beam_decode_nbest, fused_score, fusion_coefficients
from .neural_lm import lm_sequence_logp


def rescore_nbest(log_probs: torch.Tensor, frame_lens: torch.Tensor,
                  neural_lm: dict, beam_size: int = 8,
                  max_label_len: int = 256, lm_weight: float = 0.3,
                  length_bonus: float = 0.0, use_kernel: bool = True):
    """CTC K-best decode + neural-LM re-ranking of (B, T, A) log-probs; the
    LM's parameters go to log_probs' device. -> labels (B, max_label_len)
    int32 of the re-ranked best (0-padded), lens (B,) int32, scores (B,)
    float32 (the winner's combined score). Dead slots (nll >= 1e29) never
    win."""
    labels, lens, nll = beam_decode_nbest(log_probs, frame_lens,
                                          beam_size=beam_size,
                                          max_label_len=max_label_len,
                                          use_kernel=use_kernel)
    B, K, L = labels.shape
    nlm = {k: v.to(device=labels.device, dtype=torch.float32)
           for k, v in neural_lm.items()}
    # steps past the longest hypothesis are masked in every row: the pass
    # runs up to it only
    n = max(int(lens.max()), 1)
    lm_lp = lm_sequence_logp(nlm, labels[..., :n].reshape(B * K, n),
                             lens.reshape(B * K),
                             use_kernel=use_kernel).reshape(B, K)
    lam, beta = fusion_coefficients(lm_weight, length_bonus)
    total = fused_score(-nll, lm_lp, lens, lam, beta)
    total = torch.where(nll < 1e29, total, -torch.inf)
    best = torch.argmax(total, dim=1, keepdim=True)  # first max, as jnp
    return (torch.gather(labels, 1, best[..., None].expand(B, 1, L))[:, 0],
            _take(lens, best)[:, 0], _take(total, best)[:, 0])
