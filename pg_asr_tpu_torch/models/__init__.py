"""Model families + the CTC-family forward dispatch (counterpart of
pg_asr_tpu/models/__init__.py). Only the flagship BiLSTM-CTC ("ctc") is
ported so far."""

from __future__ import annotations

import torch

_NOT_PORTED = {
    "transformer": "ROADMAP.md queue 1 item 7 (transformer-CTC)",
    "conformer": "ROADMAP.md queue 1 item 7 (conformer-CTC)",
    "transducer": "ROADMAP.md queue 1 item 8 (transducer)",
    "seq2seq": "ROADMAP.md queue 1 item 9 (seq2seq)",
}


def check_family(family: str) -> None:
    if family != "ctc":
        where = _NOT_PORTED.get(family, "ROADMAP.md queue 1")
        raise NotImplementedError(
            f"model family {family!r} is not yet ported to pg_asr_tpu_torch; "
            f"see {where}")


def acoustic_forward(params, feats, frame_mask, frame_lens, cfg,
                     use_kernel: bool = True, train: bool = False,
                     generator=None):
    """CTC-family forward: (B,T,F) feats -> (log_probs (B,T,A), out_mask
    (B,T) f32, out_lens (B,)). The BiLSTM keeps T. train=True applies
    dropout with bits from `generator` (a torch.Generator on feats' device)."""
    check_family(cfg.model.family)
    from . import bilstm_ctc

    log_probs = bilstm_ctc.apply(params, feats, frame_mask, cfg.model,
                                 use_kernel=use_kernel, train=train,
                                 generator=generator)
    return log_probs, frame_mask.to(torch.float32), frame_lens
