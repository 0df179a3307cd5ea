"""Reward functions for policy-gradient fine-tuning (counterpart of
pg_asr_tpu/rl/reward.py), batched on the rows' device:

  * sequence-level: R = -CER = -ED(ref, hyp) / len(ref), or -WER over
    words (``kind="neg_wer"``, which needs the alphabet's space id);
  * step-level: r_i = -(ED(ref, hyp[:i+1]) - ED(ref, hyp[:i])) for every
    emitted symbol i, all prefixes from one DP pass, with ED(ref, "") =
    len(ref).
"""

from __future__ import annotations

import torch

from ..ops.edit_distance import (edit_distance, edit_distance_prefixes,
                                 wer_from_ids)


def sequence_reward(ref, ref_lens, hyp, hyp_lens, kind: str = "neg_cer",
                    space_id: int = -1) -> torch.Tensor:
    """(B,) float32 sequence-level reward: -ED / len(ref) for "neg_cer",
    -word-ED / ref word count for "neg_wer"."""
    if kind == "neg_wer":
        if space_id < 0:
            raise ValueError(
                "neg_wer reward needs the alphabet's space id "
                "(rl.space_id) — use character units with a space symbol")
        return -wer_from_ids(ref, ref_lens, hyp, hyp_lens, space_id)
    d = edit_distance(ref, ref_lens, hyp, hyp_lens)
    return -d.float() / torch.clamp(ref_lens.float(), min=1.0)


def stepwise_reward(ref, ref_lens, hyp, hyp_lens) -> torch.Tensor:
    """(B, Lh) per-emitted-symbol rewards r_i = -(d[i+1] - d[i]); positions
    at or past hyp_len get 0."""
    _, prefix = edit_distance_prefixes(ref, ref_lens, hyp, hyp_lens)
    r = -(prefix[:, 1:] - prefix[:, :-1]).float()
    pos = torch.arange(r.shape[1], device=r.device)[None, :]
    return r * (pos < hyp_lens[:, None])
