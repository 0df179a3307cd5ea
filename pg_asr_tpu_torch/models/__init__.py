"""Model families + the CTC-family forward dispatch (counterpart of
pg_asr_tpu/models/__init__.py).

Ported, trained and served: the flagship BiLSTM-CTC ("ctc"), the
transformer-CTC ("transformer"; with ``transformer.num_experts`` > 0 the
switch-MoE transformer of parallel/moe.py, ``--model moe``), the
conformer-CTC ("conformer"), the
RNN-T transducer ("transducer", models/transducer.py; decoded by
decoding/transducer.py) and the attention seq2seq ("seq2seq",
models/seq2seq.py, which decodes itself); the last two are not CTC
families and have no part in the dispatch below. The
attention families subsample time, so the dispatch returns the shorter
output mask and lengths beside the log-probs; BiLSTM callers get their
inputs back unchanged.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import ONE_DEVICE

_PORTED = ("ctc", "transformer", "conformer", "transducer", "seq2seq")


def check_family(family: str) -> None:
    """Raise unless the port serves and trains the model family."""
    if family not in _PORTED:
        raise NotImplementedError(f"model family {family!r} is not yet "
                                  "ported to pg_asr_tpu_torch; see "
                                  "ROADMAP.md queue 1")


def _is_layer_norm(name: str) -> bool:
    # "blocks.0.ln1.scale", "ln_final.bias": the owner starts with "ln"
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2].startswith("ln")


def cast_params(params: dict[str, torch.Tensor], dtype: torch.dtype,
                device: torch.device | str) -> dict[str, torch.Tensor]:
    """Params onto `device` in the compute `dtype`; LayerNorm scales and
    biases stay float32 in every compute type, as in the JAX package (the
    MoE router and expert stacks take the compute type)."""
    return {k: v.to(device=device,
                    dtype=torch.float32 if _is_layer_norm(k) else dtype)
            for k, v in params.items()}


def acoustic_forward(params, feats, frame_mask, frame_lens, cfg,
                     use_kernel: bool = True, train: bool = False,
                     generator=None, dp=ONE_DEVICE):
    """CTC-family forward: (B,T,F) feats -> (log_probs (B,T',A), out_mask
    (B,T') f32, out_lens (B,)). T' == T for the BiLSTM, ceil(T / subsample)
    for the attention families. train=True applies dropout with bits from
    `generator` (a torch.Generator on feats' device). ``dp``: the switch-MoE
    routes over the ranks of a data axis (parallel/moe.py), and a model
    axis's rank runs its part of the attention families' Megatron pairs
    (parallel/tensor.py)."""
    family = cfg.model.family
    if family not in ("ctc", "transformer", "conformer"):
        raise ValueError(f"{family!r} is not a CTC family: its forward is "
                         "not acoustic_forward's")
    if family == "transformer":
        if cfg.transformer.num_experts > 0:
            from ..parallel.moe import moe_apply

            return moe_apply(params, feats, frame_mask, frame_lens, cfg,
                             train=train, generator=generator, dp=dp)
        from . import transformer_ctc

        return transformer_ctc.apply(params, feats, frame_mask, frame_lens,
                                     cfg.model, cfg.transformer,
                                     use_kernel=use_kernel, train=train,
                                     generator=generator, dp=dp)
    if family == "conformer":
        from . import conformer_ctc

        return conformer_ctc.apply(params, feats, frame_mask, frame_lens,
                                   cfg.model, cfg.conformer,
                                   use_kernel=use_kernel, train=train,
                                   generator=generator, dp=dp)
    from . import bilstm_ctc

    log_probs = bilstm_ctc.apply(params, feats, frame_mask, cfg.model,
                                 use_kernel=use_kernel, train=train,
                                 generator=generator)
    return log_probs, frame_mask.to(torch.float32), frame_lens
