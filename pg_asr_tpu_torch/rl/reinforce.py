"""Policy-gradient fine-tuning of every model family the port serves
(counterpart of pg_asr_tpu/rl/reinforce.py).

Objectives by family, each plus an entropy bonus where paths are sampled
and a supervised anchor (the CTC loss, the teacher-forced NLL or the RNN-T
loss, weight rl.ctc_mix_weight):

  * CTC families (ctc / transformer, dense or switch-MoE / conformer; the
    MoE's load-balance aux is a supervised term and has no part here, as
    in the JAX package):
      - REINFORCE over sampled alignment paths: S paths per utterance from
        the per-frame categorical (temperature-scaled), CTC-collapsed and
        rewarded with negative CER / WER through the edit-distance DP
        (ops/edit_distance.py) or the per-step ED deltas (rl/reward.py),
        minus a greedy self-critic or mean baseline, on the masked
        per-frame log-probs.
      - MWER over the prefix-beam n-best (``ctc_beam`` in its n-best mode
        on CUDA tensors), each hypothesis re-scored with its differentiable
        CTC log-likelihood (_mwer_terms).
  * seq2seq: SCST, continuations sampled from the autoregressive decoder
    with a greedy self-critic, mean or no baseline
    (_scst_seq2seq_terms), and MWER over the decoder beam's n-best
    re-scored teacher-forced (_mwer_seq2seq_terms); the anchor is the
    per-step teacher-forced NLL, whose per-step quotients
    _combine_terms sums.
  * transducer: MWER over the RNN-T beam's n-best, re-scored with the
    lattice loss (_mwer_transducer_terms).

The forward runs with gradient and without dropout (``train=False``), so on
CUDA the BiLSTM encoder takes the residual ``bilstm_fwd`` and ``bilstm_bwd``
kernels, and the seq2seq decoder's teacher-forced passes the residual
``lstm_fwd`` and ``lstm_bwd``. ``use_kernel=False`` is the plain reference path on any device:
the plain recurrences and scans and the plain CTC recursion.

Random draws come from an explicit ``torch.Generator``. One device, or
under ``--mesh`` one rank of the mesh (``make_pg_step(dp=)``,
``finetune_pg``; parallel/mesh.py): ``data``, ``model`` (Megatron tensor
parallelism, parallel/tensor.py), ``expert`` (the switch-MoE's experts
split over the ranks), ``model x expert``, or ``fsdp`` (the parameters and
the AdamW state split, the tree gathered for each step), each with
``data``, the same ranks and layouts as training's; every mesh takes the
global step, as the JAX package's pjit step does with its replicated
parameters. The JAX package does not pipeline or time-split the PG step:
under a ``pipe`` or ``seq`` mesh its GSPMD step runs on replicated
parameters, so here the ranks of a pipe or seq group are replicas of the
``data`` (or ``data x model``) step on the same rows, their gradients
averaged (``finetune_pg`` joins the plan made with ``replicas=True``),
for any family, as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .. import not_ported, resolve_device
from ..checkpoint import (FLAX_NAMES, checkpoint_path, load_checkpoint,
                          read_flax_checkpoint, save_checkpoint)
from ..config import Config
from ..data import BatchIterator, load_manifest
from ..data.bpe import load_tokenizer
from ..decoding.beam import beam_decode_nbest
from ..decoding.greedy import collapse_frame_ids, greedy_decode
from ..decoding.transducer import transducer_beam_nbest
from ..losses import seq2seq_nll_terms
from ..models import (acoustic_forward, cast_params, check_family, seq2seq,
                      transducer)
from ..models.bilstm_ctc import torch_dtype
from ..ops.ctc import (alignable, ctc_loss, ctc_loss_terms,
                       ctc_loss_terms_fused)
from ..ops.edit_distance import cer_from_ids, wer_from_ids
from ..ops.features import extract_features
from ..ops.transducer import transducer_loss, transducer_loss_terms
from ..parallel.mesh import ONE_DEVICE, DataParallel, join_mesh
from ..utils.logging import StepLogger
from ..utils.preempt import install_preemption_handler
from .reward import sequence_reward, stepwise_reward


def _sample_paths(generator: torch.Generator, log_probs: torch.Tensor,
                  num_samples: int, temperature: float) -> torch.Tensor:
    """(S, B, T) int64 alignment paths ~ Categorical(log_probs /
    temperature), an exact draw by the Gumbel-max rule from `generator` (on
    log_probs' device). The division is in log_probs' dtype, as in JAX."""
    logits = log_probs / max(temperature, 1e-6)
    u = torch.rand((num_samples,) + tuple(logits.shape), generator=generator,
                   device=logits.device, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)  # JAX's support
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _path_rewards(paths, frame_mask, labels, label_lens, kind: str,
                  space_id: int = -1):
    """Collapse sampled paths (S, B, T) and score them. Returns (R (S, B),
    frame_r (S, B, T) or None, hyp_lens (S, B))."""
    S, B, T = paths.shape
    flat = paths.reshape(S * B, T)
    fmask = frame_mask.repeat(S, 1)
    hyp, hyp_lens = collapse_frame_ids(flat, fmask)
    ref = labels.repeat(S, 1)
    ref_lens = label_lens.repeat(S)

    if kind == "stepwise_ed":
        r_steps = stepwise_reward(ref, ref_lens, hyp, hyp_lens)  # (S*B, T)
        # each emission's reward goes back onto the frame that emitted it
        prev = F.pad(flat[:, :-1], (1, 0))
        keep = (flat != 0) & (flat != prev) & (fmask > 0)
        pos = torch.cumsum(keep, dim=1) - 1
        frame_r = torch.gather(r_steps, 1, pos.clamp(0, T - 1)) * keep
        norm = torch.clamp(ref_lens.float(), min=1.0)
        R = frame_r.sum(1) / norm
        return (R.reshape(S, B), (frame_r / norm[:, None]).reshape(S, B, T),
                hyp_lens.reshape(S, B))

    R = sequence_reward(ref, ref_lens, hyp, hyp_lens, kind, space_id)
    return R.reshape(S, B), None, hyp_lens.reshape(S, B)


def _mwer_combine(logp, risk, live, valid_rows):
    """Shared MWER reduction over an n-best list.

    logp (B, K) differentiable sequence log-likelihoods (dead slots may be
    anything); risk (B, K) per-hypothesis risk, no gradient; live (B, K)
    bool, the real n-best entries; valid_rows (B,) bool. Returns (num, den,
    metrics) with num / den = E_w[risk] in the forward pass and the gradient
    of sum_k w_k (risk_k - sg(r_bar)): num = sum w risk - sg(r_bar) (sum w -
    1), and sum w = 1 in the forward pass."""
    logp = torch.where(live, logp, -math.inf)
    # an all-dead row (left out by `valid` below) would give softmax nan,
    # and nan in the backward pass; a finite row stands in for it
    row_ok = torch.isfinite(logp).any(dim=1, keepdim=True)
    w = torch.softmax(torch.where(row_ok, logp, 0.0), dim=1)
    risk = torch.where(live, risk, 0.0).detach()
    risk_bar = (w * risk).sum(1).detach()
    utt_loss = (w * risk).sum(1) - risk_bar * (w.sum(1) - 1.0)

    valid = valid_rows & row_ok[:, 0]
    num = torch.where(valid, utt_loss, 0.0).sum()
    den = valid.float().sum()
    expected_risk = (torch.where(valid, risk_bar, 0.0).sum()
                     / torch.clamp(den, min=1.0))
    oracle = torch.where(live, risk, math.inf).min(dim=1).values
    metrics = {
        # "risk", not "cer": CER, or WER with reward=neg_wer
        "expected_risk": expected_risk,
        "reward_mean": -expected_risk,
        "oracle_risk": (torch.where(valid, oracle, 0.0).sum()
                        / torch.clamp(den, min=1.0)),
        "nbest_live": live.float().sum(1).mean(),
    }
    return num, den, metrics


def _mwer_terms(log_probs, mask, frame_lens, labels, label_lens, rl,
                use_kernel: bool = True):
    """Minimum expected risk over the K-best list of the CTC prefix beam
    (exact search, M = K + 2; ``ctc_beam``'s n-best mode on CUDA tensors),
    decoded from the detached log-probs. Each hypothesis is re-scored with
    its differentiable CTC log-likelihood, all B x K rows in one call: one
    ``F.ctc_loss`` on the kernel path (its log-prob gradient is right after
    the model's log-softmax, which every CTC family has), the plain
    recursion with ``use_kernel=False``. Liveness comes from the beam and
    from ``ctc.alignable``, not from the loss's value."""
    if rl.reward == "neg_wer" and rl.space_id < 0:
        # an unresolved space id would hash every sequence to one word and
        # make the "WER" risk a 0/1 exact-match indicator
        raise ValueError(
            "mwer with reward=neg_wer needs the alphabet's space id "
            "(rl.space_id) — finetune_pg resolves it from alphabet.txt; set "
            "it explicitly when building steps directly")
    K = rl.mwer_beam
    B, L = labels.shape
    with torch.no_grad():
        hyp, hyp_lens, dec_nll = beam_decode_nbest(
            log_probs.detach(), frame_lens, beam_size=K, max_label_len=L,
            use_kernel=use_kernel)
    h = hyp.reshape(B * K, L)
    hl = hyp_lens.reshape(B * K)
    fl = frame_lens.repeat_interleave(K)
    lp = log_probs.repeat_interleave(K, dim=0)  # (B*K, T, A)
    if use_kernel:
        nll = F.ctc_loss(lp.float().transpose(0, 1), h.long(), fl.long(),
                         hl.long(), blank=0, reduction="none",
                         zero_infinity=True)
        ok = alignable(fl, h, hl)
    else:
        nll = ctc_loss(lp, fl, h, hl)
        ok = nll < 0.5e30
    live = (dec_nll < 1e29) & ok.reshape(B, K)
    ref = labels.repeat_interleave(K, dim=0)
    ref_lens = label_lens.repeat_interleave(K)
    risk = (wer_from_ids(ref, ref_lens, h, hl, rl.space_id)
            if rl.reward == "neg_wer" else cer_from_ids(ref, ref_lens, h, hl))
    risk = risk.reshape(B, K)
    valid_rows = (label_lens > 0) & (mask.sum(1) > 0)
    return _mwer_combine(-nll.reshape(B, K), risk, live, valid_rows)


def _risk_kind(rl) -> str:
    """Sequence-level risk granularity (stepwise_ed is a per-frame CTC
    credit scheme; sequence-level consumers fall back to CER)."""
    return rl.reward if rl.reward in ("neg_cer", "neg_wer") else "neg_cer"


def _mwer_transducer_terms(params, feats, fmask, flens, labels, label_lens,
                           cfg: Config, use_kernel: bool = True,
                           dp: DataParallel = ONE_DEVICE):
    """MWER for the RNN-T family: the n-best of the frame-synchronous beam
    (decoding/transducer.transducer_beam_nbest, on the detached encoder
    states), every hypothesis re-scored with the lattice loss. The B x K
    hypotheses go through the prediction network and the joint as one
    batch of rows (one fused-joint launch with ``fused_joint``), then the
    anchor, the RNN-T loss on the ground truth. On a model axis (``dp``)
    the beam runs on the pairs' leaves gathered whole."""
    rl = cfg.rl
    B, L = labels.shape
    K = rl.mwer_beam
    kind = _risk_kind(rl)
    enc, _, out_lens = transducer.encode(params, feats, fmask, flens, cfg,
                                         use_kernel=use_kernel, dp=dp)
    with torch.no_grad():
        hyp, hyp_lens, scores = transducer_beam_nbest(
            dp.whole_pairs(params), enc.detach(), out_lens, cfg,
            beam_size=K, max_label_len=L)
    h = hyp.reshape(B * K, L)
    hl = hyp_lens.reshape(B * K)
    ol = out_lens.repeat_interleave(K)
    pred = transducer.predict_states(params, h, hl, cfg)
    lp_blank, lp_label = transducer.joint_lattice_log_probs(
        params, enc.repeat_interleave(K, dim=0), pred, h, cfg,
        use_kernel=use_kernel, dp=dp)
    nll = transducer_loss(lp_blank, lp_label, ol, hl).reshape(B, K)
    live = (scores > -1e29) & (nll < 0.5e30)
    risk = -sequence_reward(labels.repeat_interleave(K, dim=0),
                            label_lens.repeat_interleave(K), h, hl, kind,
                            rl.space_id).reshape(B, K)
    valid_rows = (label_lens > 0) & (out_lens > 0)
    pg_num, pg_den, obj_metrics = _mwer_combine(-nll, risk, live, valid_rows)

    pred = transducer.predict_states(params, labels, label_lens, cfg)
    lp_blank, lp_label = transducer.joint_lattice_log_probs(
        params, enc, pred, labels, cfg, use_kernel=use_kernel, dp=dp)
    a_num, a_den = transducer_loss_terms(lp_blank, lp_label, out_lens,
                                         label_lens)
    zero = enc.new_zeros((), dtype=torch.float32)
    one = torch.ones((), device=enc.device)
    nums = {"pg": pg_num, "ent": zero, "ctc": a_num}
    dens = {"pg": pg_den, "ent": one, "ctc": a_den}
    return nums, dens, dict(obj_metrics, entropy=zero)


def _scst_seq2seq_terms(params, feats, fmask, labels, label_lens,
                        generator: torch.Generator | None, cfg: Config,
                        use_kernel: bool = True):
    """SCST (self-critical sequence training) for the attention seq2seq
    family: S continuations per utterance sampled from the decoder
    (``seq2seq.sample_from_encoder``, drawn from `generator`), each
    rewarded with negative CER or WER, minus the greedy decode's reward
    (Rennie et al. 2017), the samples' mean or nothing; REINFORCE on the
    mean log-prob of each sample's tokens up to and including its EOS, an
    entropy bonus over the same steps, and the teacher-forced NLL on the
    same encoder states as the anchor."""
    rl = cfg.rl
    B, L = labels.shape
    kind = _risk_kind(rl)
    S = rl.num_samples
    enc_out = seq2seq.encode(params, feats, fmask, cfg.model,
                             use_kernel=use_kernel)
    toks, tok_lp, ent = seq2seq.sample_from_encoder(
        params, enc_out, fmask, generator, S, max_steps=L,
        temperature=rl.temperature)  # (S, B, L) each
    lens = seq2seq.generated_lengths(toks)  # (S, B)
    R = sequence_reward(labels.repeat(S, 1), label_lens.repeat(S),
                        toks.reshape(S * B, L), lens.reshape(S * B), kind,
                        rl.space_id).reshape(S, B)

    if rl.baseline == "greedy":
        with torch.no_grad():
            g_toks, _ = seq2seq.greedy_from_encoder(params, enc_out.detach(),
                                                    fmask, L)
            base = sequence_reward(labels, label_lens, g_toks,
                                   seq2seq.generated_lengths(g_toks), kind,
                                   rl.space_id)[None, :]
    elif rl.baseline == "mean":
        base = R.mean(dim=0, keepdim=True)
    else:
        base = R.new_zeros((1, 1))

    # every sampled token up to and including the EOS action
    pos = torch.arange(L, device=labels.device)
    valid = label_lens > 0  # zero-length rows are batch padding
    step_mask = ((pos <= lens[:, :, None]) & valid[None, :, None]).float()
    seq_lp = ((tok_lp * step_mask).sum(2)
              / torch.clamp(step_mask.sum(2), min=1.0))
    adv = (R - base) * valid[None, :]
    pg_num = -(adv * seq_lp).sum()
    pg_den = float(S) * valid.float().sum()
    ent_num = (ent * step_mask).sum()
    ent_den = step_mask.sum()

    lp_tf = seq2seq.decode_teacher_forced(params, enc_out, fmask, labels,
                                          use_kernel=use_kernel)
    a_num, a_den = seq2seq_nll_terms(lp_tf, labels, label_lens)
    metrics = {
        "reward_mean": R.mean(),
        "baseline_mean": base.mean(),
        "advantage_mean": (R - base).mean(),
        "sample_len_mean": lens.float().mean(),
        "entropy": ent_num / torch.clamp(ent_den, min=1.0),
    }
    nums = {"pg": pg_num, "ent": ent_num, "ctc": a_num}
    dens = {"pg": pg_den, "ent": ent_den, "ctc": a_den}
    return nums, dens, metrics


def _hyp_log_lik_seq2seq(lp, hyp, hyp_lens):
    """(N, L, A) teacher-forced log-probs of hypotheses (N, L) -> (N,)
    sequence log-likelihoods including the EOS step (position hyp_lens,
    unless the beam reached L)."""
    tok_lp = torch.gather(lp, 2, hyp.long()[..., None])[..., 0]
    pos = torch.arange(hyp.shape[1], device=hyp.device)[None, :]
    return (tok_lp * (pos <= hyp_lens[:, None])).sum(1)


def _mwer_seq2seq_terms(params, feats, fmask, labels, label_lens,
                        cfg: Config, use_kernel: bool = True):
    """MWER for the attention seq2seq family: the K-best of the decoder's
    beam search (``seq2seq.beam_scan_from_encoder``, on the detached
    encoder states), each hypothesis re-scored with its differentiable
    teacher-forced log-likelihood: the B x K hypotheses in one decoder
    call over the shared encoder states (one ``lstm_fwd`` residual launch
    and one ``lstm_bwd`` on CUDA), then the anchor."""
    rl = cfg.rl
    B, L = labels.shape
    K = rl.mwer_beam
    kind = _risk_kind(rl)
    enc_out = seq2seq.encode(params, feats, fmask, cfg.model,
                             use_kernel=use_kernel)
    with torch.no_grad():
        hyp, hyp_lens, scores = seq2seq.beam_scan_from_encoder(
            params, enc_out.detach(), fmask, beam_size=K, max_steps=L)
    h = hyp.reshape(B * K, L)
    hl = hyp_lens.reshape(B * K)
    lp = seq2seq.decode_teacher_forced(params, enc_out, fmask, h,
                                       use_kernel=use_kernel)
    logp = _hyp_log_lik_seq2seq(lp, h, hl).reshape(B, K)
    risk = -sequence_reward(labels.repeat_interleave(K, dim=0),
                            label_lens.repeat_interleave(K), h, hl, kind,
                            rl.space_id).reshape(B, K)
    pg_num, pg_den, obj_metrics = _mwer_combine(logp, risk, scores > -1e29,
                                                label_lens > 0)

    lp_tf = seq2seq.decode_teacher_forced(params, enc_out, fmask, labels,
                                          use_kernel=use_kernel)
    a_num, a_den = seq2seq_nll_terms(lp_tf, labels, label_lens)
    zero = enc_out.new_zeros((), dtype=torch.float32)
    one = torch.ones((), device=enc_out.device)
    nums = {"pg": pg_num, "ent": zero, "ctc": a_num}
    dens = {"pg": pg_den, "ent": one, "ctc": a_den}
    return nums, dens, dict(obj_metrics, entropy=zero)


def pg_loss_terms(params, wave, num_samples, labels, label_lens,
                  generator: torch.Generator | None, cfg: Config,
                  use_kernel: bool = True, dp: DataParallel = ONE_DEVICE):
    """PG loss as (numerators, denominators, metrics), each component
    num / den. CTC families: REINFORCE over sampled alignment paths (drawn
    from `generator`) or MWER over the prefix-beam n-best; seq2seq: SCST
    (objective "reinforce", samples drawn from `generator`) or MWER over
    the decoder beam's n-best; the transducer: MWER over its beam's
    n-best. ``dp``: the switch-MoE routes over the ranks of a data axis, and
    a model axis's rank runs its part of the Megatron pairs."""
    rl = cfg.rl
    check_family(cfg.model.family)
    with torch.no_grad():
        feats, fmask, flens = extract_features(wave, num_samples,
                                               cfg.features)
    if cfg.model.family == "seq2seq":
        if rl.objective == "mwer":
            return _mwer_seq2seq_terms(params, feats, fmask, labels,
                                       label_lens, cfg, use_kernel)
        return _scst_seq2seq_terms(params, feats, fmask, labels, label_lens,
                                   generator, cfg, use_kernel)
    if cfg.model.family == "transducer":
        if rl.objective != "mwer":
            raise ValueError(
                "transducer PG fine-tuning uses the MWER objective "
                "(--pg_objective mwer): the on-device RNN-T n-best "
                "re-scored with the differentiable lattice loss. "
                "finetune_pg auto-selects it; set it explicitly when "
                "building steps directly.")
        return _mwer_transducer_terms(params, feats, fmask, flens, labels,
                                      label_lens, cfg, use_kernel, dp)

    # mask / frame_lens in the model's output time base
    log_probs, mask, frame_lens = acoustic_forward(
        params, feats, fmask, flens, cfg, use_kernel=use_kernel, train=False,
        dp=dp)

    if rl.objective == "mwer":
        pg_num, pg_den, obj_metrics = _mwer_terms(
            log_probs, mask, frame_lens, labels, label_lens, rl, use_kernel)
        return _shared_terms(pg_num, pg_den, obj_metrics, log_probs, mask,
                             frame_lens, labels, label_lens, use_kernel)
    if rl.objective != "reinforce":
        raise ValueError(f"unknown rl.objective {rl.objective!r} "
                         "(supported: reinforce, mwer)")

    S = rl.num_samples
    paths = _sample_paths(generator, log_probs.detach(), S, rl.temperature)
    R, frame_r, _ = _path_rewards(paths, mask, labels, label_lens, rl.reward,
                                  rl.space_id)

    # baseline (row-local: greedy self-critic or mean over the S samples)
    if rl.baseline == "greedy":
        greedy_ids, greedy_lens = greedy_decode(log_probs.detach(), mask)
        # the self-critic scores with the samples' reward kind
        base_kind = rl.reward if rl.reward != "stepwise_ed" else "neg_cer"
        base = sequence_reward(labels, label_lens, greedy_ids, greedy_lens,
                               base_kind, rl.space_id)[None, :]
    elif rl.baseline == "mean":
        base = R.mean(dim=0, keepdim=True)
    else:
        base = log_probs.new_zeros((1, 1))

    # log-prob of each sampled path, per frame: (S, B, T)
    lp_path = torch.gather(log_probs, 2, paths.permute(1, 2, 0)).permute(
        2, 0, 1) * mask[None]

    if rl.reward == "stepwise_ed":
        # per-step credit: the advantage on the emitting frames, the
        # baseline spread over each row's frames. (The JAX package divides
        # a (1, B) baseline by a (1, B, 1) count, which broadcasts to
        # (1, B, B) and raises unless B == 1 or the baseline is 0; this is
        # its B == 1 result for every row.)
        counts = torch.clamp(mask.sum(1), min=1.0)
        adv = frame_r - base[:, :, None] / counts[None, :, None]
        pg_num = -(adv * lp_path).sum()
        pg_den = mask.sum() * S
    else:
        adv = R - base  # (S, B)
        seq_lp = lp_path.sum(2) / torch.clamp(mask.sum(1)[None], min=1.0)
        # rows with no frames have seq_lp = 0
        pg_num = -(adv * seq_lp).sum()
        pg_den = float(S) * (mask.sum(1) > 0).float().sum()

    obj_metrics = {
        "reward_mean": R.mean(),
        "baseline_mean": base.mean(),
        "advantage_mean": (R - base).mean(),
    }
    return _shared_terms(pg_num, pg_den, obj_metrics, log_probs, mask,
                         frame_lens, labels, label_lens, use_kernel)


def _shared_terms(pg_num, pg_den, obj_metrics, log_probs, mask, frame_lens,
                  labels, label_lens, use_kernel: bool = True):
    """Entropy bonus + supervised CTC anchor, shared by the CTC
    objectives (the anchor through ``F.ctc_loss`` on the kernel path)."""
    ent_num = (-(torch.exp(log_probs) * log_probs).sum(-1) * mask).sum()
    ent_den = mask.sum()
    terms = ctc_loss_terms_fused if use_kernel else ctc_loss_terms
    ctc_num, ctc_den = terms(log_probs, frame_lens, labels, label_lens)
    nums = {"pg": pg_num, "ent": ent_num, "ctc": ctc_num}
    dens = {"pg": pg_den, "ent": ent_den, "ctc": ctc_den}
    metrics = dict(obj_metrics,
                   entropy=ent_num / torch.clamp(ent_den, min=1.0))
    return nums, dens, metrics


def _combine_terms(nums, dens, rl):
    pg = nums["pg"] / torch.clamp(dens["pg"], min=1.0)
    ent = nums["ent"] / torch.clamp(dens["ent"], min=1.0)
    loss = pg - rl.entropy_weight * ent
    if rl.ctc_mix_weight > 0:
        # the seq2seq anchor's terms are per-step vectors: the sum of the
        # per-step means, as losses.seq2seq_nll_loss
        loss = loss + rl.ctc_mix_weight * torch.sum(
            nums["ctc"] / torch.clamp(dens["ctc"], min=1.0))
    return loss


def pg_loss_fn(params, wave, num_samples, labels, label_lens,
               generator: torch.Generator | None, cfg: Config,
               use_kernel: bool = True):
    """Scalar PG loss + metrics dict (device tensors)."""
    nums, dens, metrics = pg_loss_terms(params, wave, num_samples, labels,
                                        label_lens, generator, cfg,
                                        use_kernel)
    return _combine_terms(nums, dens, cfg.rl), metrics


def make_pg_step(cfg: Config, optimizer, dp: DataParallel = ONE_DEVICE,
                 use_kernel: bool = True) -> Callable:
    """step(params, generator, wave, num_samples, labels, label_lens) ->
    (loss, metrics): the PG loss's gradients, then the optimizer, which
    updates params in place.

    ``dp`` (parallel/mesh.py): this rank's place on the mesh (the JAX
    package's ``shard_map`` step on a data axis): the samples drawn from
    ``dp.step_generator(generator)``, every component's denominator summed
    over the ranks of distinct rows before the quotients, the gradients
    summed before the optimizer, the forward on ``dp.forward_params`` (the
    fsdp leaves gathered) as train.make_train_step; the loss is the global
    one and the metrics the ranks' mean. On one device (``ONE_DEVICE``)
    every sum is the identity. Under a ``pipe`` or ``seq`` mesh ``dp`` is
    a rank of the plan made with ``replicas=True``, as ``finetune_pg``
    joins it."""
    from ..train import value_and_grad

    if dp.strategy in ("pipe", "seq"):
        raise ValueError("the policy-gradient step runs the replicas of a "
                         f"{dp.strategy} mesh: ParallelPlan(replicas=True)")

    def pg_step(params, generator, wave, ns, labels, label_lens):
        gen = dp.step_generator(generator)

        def loss_fn(p):
            nums, dens, metrics = pg_loss_terms(
                p, wave, ns, labels, label_lens, gen, cfg, use_kernel, dp)
            dens = {k: dp.all_sum(v) for k, v in dens.items()}
            return _combine_terms(nums, dens, cfg.rl), metrics

        (loss, metrics), grads = value_and_grad(loss_fn,
                                                dp.forward_params(params))
        optimizer.update(params, dp.sum_grads(grads))
        return dp.all_sum(loss.detach()), {
            k: dp.all_mean(v.detach()) for k, v in metrics.items()}

    return pg_step


def _refuse_jax_pg_resume(model_path: str, num_steps: int) -> None:
    """Refuse a directory where the JAX package left a policy-gradient run
    mid-way (its model_last.ckpt at epoch -1, no model_last.pt): the JAX
    package resumes it from there, with its optax state, which the port
    cannot map yet; starting over from model_best would not be that run."""
    flax_last = os.path.join(model_path, FLAX_NAMES["last"])
    if (os.path.exists(checkpoint_path(model_path, "last"))
            or not os.path.exists(flax_last)):
        return
    prev = read_flax_checkpoint(flax_last)
    if (int(prev.get("epoch", 0)) == -1
            and int(prev.get("step", 0)) < num_steps):
        raise not_ported("resuming a JAX package policy-gradient run "
                         "(model_last.ckpt at epoch -1: its optax state)")


def finetune_pg(corpus_path: str, model_path: str, num_steps: int = 200,
                batch_size: int | None = None, config: Config | None = None,
                eval_every: int = 50, device: str = "cuda") -> dict:
    """Policy-gradient fine-tuning of the model in <model_path> (its
    model_best.pt and config.json, written by the port's trainer, or the
    JAX package's model_best.ckpt), on the corpus's train split, with a greedy dev CER every `eval_every` steps
    selecting the best checkpoint.

    Optimizer: clip by global norm + AdamW at a constant rate of
    learning_rate * 0.1 and optax's default weight decay 1e-4. A PG
    model_last (epoch -1, step < num_steps) resumes the run; a supervised
    one is left alone. SIGTERM saves model_last at the exact step and
    returns. An EMA model (``train.ema_decay`` > 0: load_model serves its
    averaged weights) keeps its average through the PG steps; the dev CER
    and every checkpoint's ``ema_params`` are that average, as in the JAX
    package. Artifacts: pg_rewards.npy (reward per step), pg_dev_cer.npy
    ((step, CER) pairs), metrics.jsonl every 10 steps.

    Under ``--mesh`` this process is one rank of the joined process group,
    as in train.train: its slice of the train split at batch_size // N
    rows (N the ranks of distinct rows), its parts of the split leaves, the
    mesh's step (``make_pg_step(dp=)``), `num_steps` global steps on every
    rank, the dev CER over every slice, a SIGTERM to any rank agreed at the
    step, and only rank 0 writes, in the full shapes."""
    from ..predict import load_model
    from ..train import (AdamW, _copy, _ema_update, _opt_layout,
                         batch_to_device, corpus_cer, make_plan)

    cfg = config or Config()
    if batch_size:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    batch_size=batch_size))
    check_family(cfg.model.family)
    _refuse_jax_pg_resume(model_path, num_steps)
    dev = resolve_device(device)
    alphabet = load_tokenizer(corpus_path, cfg.text.units)
    params, cfg = load_model(model_path, alphabet, cfg, which="best",
                             device=dev)
    # the mesh, checked against the model this run fine-tunes
    # pipe and seq ranks run replicas of the data step (parallel/driver.py
    # ``ParallelPlan(replicas=True)``)
    dp = join_mesh(make_plan(cfg, replicas=True), dev)
    is_main, world = dp.is_main, dp.world

    # the word delimiter of WER-granularity rewards (neg_wer)
    space_id = alphabet.char2ind.get(" ", -1)
    cfg = cfg.replace(rl=dataclasses.replace(cfg.rl, space_id=space_id))
    if cfg.rl.reward == "neg_wer" and space_id < 0:
        raise ValueError(
            "--pg_reward neg_wer needs an alphabet with a space symbol "
            "(character units); this corpus/tokenizer has none")
    if cfg.model.family == "transducer" and cfg.rl.objective == "reinforce":
        print("[pg] transducer family: using the MWER objective "
              "(n-best re-scored with the differentiable lattice loss)")
        cfg = cfg.replace(rl=dataclasses.replace(cfg.rl, objective="mwer"))

    bs = max(1, cfg.train.batch_size // world)  # this rank's rows
    aud = os.path.join(corpus_path, "clips")
    it = BatchIterator(load_manifest(os.path.join(corpus_path, "train.tsv"),
                                     aud),
                       alphabet, bs, sample_rate=cfg.features.sample_rate,
                       seed=cfg.train.seed, shard_index=dp.rank,
                       shard_count=dp.world)
    logger = StepLogger(model_path) if is_main else None
    use_ema = cfg.train.ema_decay > 0.0
    ema = _copy(params) if use_ema else None
    opt_state = None  # a restored optimizer state, in the full shapes

    # resume an interrupted PG run: its checkpoints carry epoch -1
    start_step, best_val = 0, math.inf
    last_path = checkpoint_path(model_path, "last")
    if os.path.exists(last_path):
        prev = load_checkpoint(last_path)
        if (int(prev.get("epoch", 0)) == -1 and "opt_state" in prev
                and int(prev["step"]) < num_steps):
            params = cast_params(prev["params"],
                                 torch_dtype(cfg.model.dtype), dev)
            opt_state = prev["opt_state"]
            if use_ema and "ema_params" in prev:
                ema = cast_params(prev["ema_params"],
                                  torch_dtype(cfg.model.dtype), dev)
            start_step = int(prev["step"])
            best_val = float(prev.get("best_val_loss", math.inf))
            print(f"[pg] resumed from model_last at step {start_step}")
    dp.broadcast_(params)  # every rank starts from rank 0's parameters
    if use_ema:
        dp.broadcast_(ema)
    # from here on each rank holds its parts of the mesh's split leaves
    params = dp.shard(params)
    ema = dp.shard(ema) if use_ema else None
    optimizer = AdamW(cfg, params, learning_rate=cfg.train.learning_rate * 0.1,
                      weight_decay=1e-4, dp=dp)  # optax.adamw's default decay
    if opt_state is not None:
        optimizer.load_state_dict(_opt_layout(opt_state, dp.shard), dev)
    pg_step = make_pg_step(cfg, optimizer, dp=dp)

    preempted, restore_sigterm = install_preemption_handler()
    # the same on every rank: on the host when each rank draws from a
    # generator of its own (DataParallel.step_generator)
    generator = torch.Generator(device=dev if dp.n_ranks == 1 else "cpu"
                                ).manual_seed(cfg.train.seed + 17)

    dev_tsv = os.path.join(corpus_path, "dev.tsv")
    dev_rows = (load_manifest(dev_tsv, aud)
                if eval_every and os.path.exists(dev_tsv) else None)
    if dev_rows is not None and 0 < len(dev_rows) < world:
        dev_rows = None  # fewer dev rows than ranks: no rank evaluates

    def _save(step: int, val: float | None) -> bool:
        """model_last always; model_best too when `val` improves on the
        best so far (the JAX package's CheckpointManager.save). Every rank
        gathers the full shapes and keeps the same best; rank 0 writes."""
        nonlocal best_val
        is_best = val is not None and val < best_val
        if is_best:
            best_val = float(val)
        state = {"params": dp.unshard(params),
                 "opt_state": _opt_layout(optimizer.state_dict(), dp.unshard),
                 "step": step, "epoch": -1, "best_val_loss": best_val}
        if use_ema:
            state["ema_params"] = dp.unshard(ema)
        if not is_main:
            return is_best
        save_checkpoint(last_path, state)
        if is_best:
            save_checkpoint(checkpoint_path(model_path, "best"), state)
        return is_best

    def say(msg: str) -> None:
        if is_main:
            print(msg)

    # the rewards stay on the device; they are read at the log, eval and
    # end boundaries only (a read per step would wait for every step)
    reward_dev: list[torch.Tensor] = []
    dev_cers: list[tuple[int, float]] = []
    step = start_step
    t0 = time.time()
    try:
        while step < num_steps:
            for batch in it:
                loss, metrics = pg_step(params, generator,
                                        *batch_to_device(batch, dev))
                if use_ema:
                    _ema_update(ema, params, cfg.train.ema_decay)
                step += 1
                reward_dev.append(metrics["reward_mean"])
                if is_main and step % 10 == 0:
                    logger.log(step=step, pg_loss=float(loss),
                               reward=float(metrics["reward_mean"]),
                               entropy=float(metrics["entropy"]))
                if dev_rows is not None and (step % eval_every == 0
                                             or step >= num_steps):
                    cer = corpus_cer(ema if use_ema else params, dev_rows,
                                     alphabet, cfg, bs, dp)
                    dev_cers.append((step, cer))
                    if _save(step, val=cer):
                        say(f"[pg] step {step}: new best dev CER {cer:.4f}")
                    else:
                        say(f"[pg] step {step}: dev CER {cer:.4f} (best "
                            f"{best_val:.4f})")
                if dp.any(preempted.is_set()):  # one rank's SIGTERM stops all
                    _save(step, val=None)  # model_last at the exact step
                    say(f"[pg] SIGTERM: saved model_last at step {step}; "
                        "rerun finetune_pg to resume")
                    return {"rewards": _floats(reward_dev),
                            "params": dp.unshard(params),
                            "config": cfg, "dev_cers": dev_cers,
                            "interrupted": True}
                if step >= num_steps:
                    break

        rewards = _floats(reward_dev)
        if is_main:
            np.save(os.path.join(model_path, "pg_rewards.npy"),
                    np.array(rewards))
            if dev_cers:
                np.save(os.path.join(model_path, "pg_dev_cer.npy"),
                        np.array(dev_cers))
        if dev_rows is None:
            # no dev set: select on the reward proxy
            _save(step, val=-float(np.mean(rewards[-10:])))
        say(f"[pg] {step} steps, final reward {np.mean(rewards[-10:]):.4f} "
            f"({time.time() - t0:.1f}s)")
    finally:
        restore_sigterm()
    return {"rewards": rewards, "params": dp.unshard(params), "config": cfg,
            "dev_cers": dev_cers}


def _floats(values: list[torch.Tensor]) -> list[float]:
    """Device scalars -> floats, in one transfer."""
    return torch.stack(values).tolist() if values else []
