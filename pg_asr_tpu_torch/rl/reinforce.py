"""Policy-gradient fine-tuning of the CTC families and the transducer
(counterpart of pg_asr_tpu/rl/reinforce.py; seq2seq's SCST and MWER are not
ported, ROADMAP.md queue 1 item 10).

Objectives by family, each plus an entropy bonus where paths are sampled
and a supervised anchor (the CTC or RNN-T loss, weight rl.ctc_mix_weight):

  * CTC families (ctc / transformer / conformer):
      - REINFORCE over sampled alignment paths: S paths per utterance from
        the per-frame categorical (temperature-scaled), CTC-collapsed and
        rewarded with negative CER / WER through the edit-distance DP
        (ops/edit_distance.py) or the per-step ED deltas (rl/reward.py),
        minus a greedy self-critic or mean baseline, on the masked
        per-frame log-probs.
      - MWER over the prefix-beam n-best (``ctc_beam`` in its n-best mode
        on CUDA tensors), each hypothesis re-scored with its differentiable
        CTC log-likelihood (_mwer_terms).
  * transducer: MWER over the RNN-T beam's n-best, re-scored with the
    lattice loss (_mwer_transducer_terms).

The forward runs with gradient and without dropout (``train=False``), so on
CUDA the BiLSTM encoder takes the residual ``bilstm_fwd`` and ``bilstm_bwd``
kernels. ``use_kernel=False`` is the plain reference path on any device:
the plain recurrences and scans and the plain CTC recursion.

One device; random draws come from an explicit ``torch.Generator`` on it.
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
from ..checkpoint import checkpoint_path, load_checkpoint, save_checkpoint
from ..config import Config
from ..data import BatchIterator, load_manifest
from ..data.bpe import load_tokenizer
from ..decoding.beam import beam_decode_nbest
from ..decoding.greedy import collapse_frame_ids, greedy_decode
from ..decoding.transducer import transducer_beam_nbest
from ..models import acoustic_forward, cast_params, check_family, transducer
from ..models.bilstm_ctc import torch_dtype
from ..ops.ctc import (alignable, ctc_loss, ctc_loss_terms,
                       ctc_loss_terms_fused)
from ..ops.edit_distance import cer_from_ids, wer_from_ids
from ..ops.features import extract_features
from ..ops.transducer import transducer_loss, transducer_loss_terms
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
                           cfg: Config, use_kernel: bool = True):
    """MWER for the RNN-T family: the n-best of the frame-synchronous beam
    (decoding/transducer.transducer_beam_nbest, on the detached encoder
    states), every hypothesis re-scored with the lattice loss. The B x K
    hypotheses go through the prediction network and the joint as one
    batch of rows (one fused-joint launch with ``fused_joint``), then the
    anchor, the RNN-T loss on the ground truth."""
    rl = cfg.rl
    B, L = labels.shape
    K = rl.mwer_beam
    kind = _risk_kind(rl)
    enc, _, out_lens = transducer.encode(params, feats, fmask, flens, cfg,
                                         use_kernel=use_kernel)
    with torch.no_grad():
        hyp, hyp_lens, scores = transducer_beam_nbest(
            params, enc.detach(), out_lens, cfg, beam_size=K,
            max_label_len=L)
    h = hyp.reshape(B * K, L)
    hl = hyp_lens.reshape(B * K)
    ol = out_lens.repeat_interleave(K)
    pred = transducer.predict_states(params, h, hl, cfg)
    lp_blank, lp_label = transducer.joint_lattice_log_probs(
        params, enc.repeat_interleave(K, dim=0), pred, h, cfg,
        use_kernel=use_kernel)
    nll = transducer_loss(lp_blank, lp_label, ol, hl).reshape(B, K)
    live = (scores > -1e29) & (nll < 0.5e30)
    risk = -sequence_reward(labels.repeat_interleave(K, dim=0),
                            label_lens.repeat_interleave(K), h, hl, kind,
                            rl.space_id).reshape(B, K)
    valid_rows = (label_lens > 0) & (out_lens > 0)
    pg_num, pg_den, obj_metrics = _mwer_combine(-nll, risk, live, valid_rows)

    pred = transducer.predict_states(params, labels, label_lens, cfg)
    lp_blank, lp_label = transducer.joint_lattice_log_probs(
        params, enc, pred, labels, cfg, use_kernel=use_kernel)
    a_num, a_den = transducer_loss_terms(lp_blank, lp_label, out_lens,
                                         label_lens)
    zero = enc.new_zeros((), dtype=torch.float32)
    one = torch.ones((), device=enc.device)
    nums = {"pg": pg_num, "ent": zero, "ctc": a_num}
    dens = {"pg": pg_den, "ent": one, "ctc": a_den}
    return nums, dens, dict(obj_metrics, entropy=zero)


def pg_loss_terms(params, wave, num_samples, labels, label_lens,
                  generator: torch.Generator | None, cfg: Config,
                  use_kernel: bool = True):
    """PG loss as (numerators, denominators, metrics), each component
    num / den. CTC families: REINFORCE over sampled alignment paths (drawn
    from `generator`) or MWER over the prefix-beam n-best; the transducer:
    MWER over its beam's n-best."""
    rl = cfg.rl
    check_family(cfg.model.family)
    with torch.no_grad():
        feats, fmask, flens = extract_features(wave, num_samples,
                                               cfg.features)
    if cfg.model.family == "transducer":
        if rl.objective != "mwer":
            raise ValueError(
                "transducer PG fine-tuning uses the MWER objective "
                "(--pg_objective mwer): the on-device RNN-T n-best "
                "re-scored with the differentiable lattice loss. "
                "finetune_pg auto-selects it; set it explicitly when "
                "building steps directly.")
        return _mwer_transducer_terms(params, feats, fmask, flens, labels,
                                      label_lens, cfg, use_kernel)

    # mask / frame_lens in the model's output time base
    log_probs, mask, frame_lens = acoustic_forward(
        params, feats, fmask, flens, cfg, use_kernel=use_kernel, train=False)

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
        loss = loss + rl.ctc_mix_weight * nums["ctc"] / torch.clamp(
            dens["ctc"], min=1.0)
    return loss


def pg_loss_fn(params, wave, num_samples, labels, label_lens,
               generator: torch.Generator | None, cfg: Config,
               use_kernel: bool = True):
    """Scalar PG loss + metrics dict (device tensors)."""
    nums, dens, metrics = pg_loss_terms(params, wave, num_samples, labels,
                                        label_lens, generator, cfg,
                                        use_kernel)
    return _combine_terms(nums, dens, cfg.rl), metrics


def make_pg_step(cfg: Config, optimizer, mesh=None,
                 use_kernel: bool = True) -> Callable:
    """step(params, generator, wave, num_samples, labels, label_lens) ->
    (loss, metrics): the PG loss's gradients, then the optimizer, which
    updates params in place. One device: meshes are not ported."""
    from ..train import value_and_grad

    if mesh is not None:
        raise not_ported("--mesh (device meshes)")

    def pg_step(params, generator, wave, ns, labels, label_lens):
        (loss, metrics), grads = value_and_grad(
            lambda p: pg_loss_fn(p, wave, ns, labels, label_lens, generator,
                                 cfg, use_kernel), params)
        optimizer.update(params, grads)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return pg_step


def _check_pg_ported(cfg: Config) -> None:
    from ..train import _MOE

    check_family(cfg.model.family)
    t = cfg.train
    for bad, what in (
            (cfg.model.family == "transformer"
             and cfg.transformer.num_experts > 0, _MOE),
            (t.mesh_shape != () or t.mesh_axes != ("data",),
             "device meshes")):
        if bad:
            raise not_ported(what)


def finetune_pg(corpus_path: str, model_path: str, num_steps: int = 200,
                batch_size: int | None = None, config: Config | None = None,
                eval_every: int = 50, device: str = "cuda") -> dict:
    """Policy-gradient fine-tuning of the model in <model_path> (its
    model_best.pt and config.json, written by the port's trainer), on the
    corpus's train split, with a greedy dev CER every `eval_every` steps
    selecting the best checkpoint.

    Optimizer: clip by global norm + AdamW at a constant rate of
    learning_rate * 0.1 and optax's default weight decay 1e-4. A PG
    model_last (epoch -1, step < num_steps) resumes the run; a supervised
    one is left alone. SIGTERM saves model_last at the exact step and
    returns. An EMA model (``train.ema_decay`` > 0: load_model serves its
    averaged weights) keeps its average through the PG steps; the dev CER
    and every checkpoint's ``ema_params`` are that average, as in the JAX
    package. Artifacts: pg_rewards.npy (reward per step), pg_dev_cer.npy
    ((step, CER) pairs), metrics.jsonl every 10 steps."""
    from ..predict import load_model
    from ..train import (AdamW, _copy, _ema_update, batch_to_device,
                         corpus_cer)

    cfg = config or Config()
    if batch_size:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    batch_size=batch_size))
    _check_pg_ported(cfg)
    dev = resolve_device(device)
    alphabet = load_tokenizer(corpus_path, cfg.text.units)
    params, cfg = load_model(model_path, alphabet, cfg, which="best",
                             device=dev)

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

    bs = cfg.train.batch_size
    aud = os.path.join(corpus_path, "clips")
    it = BatchIterator(load_manifest(os.path.join(corpus_path, "train.tsv"),
                                     aud),
                       alphabet, bs, sample_rate=cfg.features.sample_rate,
                       seed=cfg.train.seed)
    optimizer = AdamW(cfg, params, learning_rate=cfg.train.learning_rate * 0.1,
                      weight_decay=1e-4)  # optax.adamw's default decay
    pg_step = make_pg_step(cfg, optimizer)
    logger = StepLogger(model_path)
    use_ema = cfg.train.ema_decay > 0.0
    ema = _copy(params) if use_ema else None

    # resume an interrupted PG run: its checkpoints carry epoch -1
    start_step, best_val = 0, math.inf
    last_path = checkpoint_path(model_path, "last")
    if os.path.exists(last_path):
        prev = load_checkpoint(last_path)
        if (int(prev.get("epoch", 0)) == -1 and "opt_state" in prev
                and int(prev["step"]) < num_steps):
            params = cast_params(prev["params"],
                                 torch_dtype(cfg.model.dtype), dev)
            optimizer.load_state_dict(prev["opt_state"], dev)
            if use_ema and "ema_params" in prev:
                ema = cast_params(prev["ema_params"],
                                  torch_dtype(cfg.model.dtype), dev)
            start_step = int(prev["step"])
            best_val = float(prev.get("best_val_loss", math.inf))
            print(f"[pg] resumed from model_last at step {start_step}")

    preempted, restore_sigterm = install_preemption_handler()
    generator = torch.Generator(device=dev).manual_seed(cfg.train.seed + 17)

    dev_tsv = os.path.join(corpus_path, "dev.tsv")
    dev_rows = (load_manifest(dev_tsv, aud)
                if eval_every and os.path.exists(dev_tsv) else None)

    def _save(step: int, val: float | None) -> bool:
        """model_last always; model_best too when `val` improves on the
        best so far (the JAX package's CheckpointManager.save)."""
        nonlocal best_val
        is_best = val is not None and val < best_val
        if is_best:
            best_val = float(val)
        state = {"params": params, "opt_state": optimizer.state_dict(),
                 "step": step, "epoch": -1, "best_val_loss": best_val}
        if use_ema:
            state["ema_params"] = ema
        save_checkpoint(last_path, state)
        if is_best:
            save_checkpoint(checkpoint_path(model_path, "best"), state)
        return is_best

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
                if step % 10 == 0:
                    logger.log(step=step, pg_loss=float(loss),
                               reward=float(metrics["reward_mean"]),
                               entropy=float(metrics["entropy"]))
                if dev_rows is not None and (step % eval_every == 0
                                             or step >= num_steps):
                    cer = corpus_cer(ema if use_ema else params, dev_rows,
                                     alphabet, cfg, bs)
                    dev_cers.append((step, cer))
                    if _save(step, val=cer):
                        print(f"[pg] step {step}: new best dev CER "
                              f"{cer:.4f}")
                    else:
                        print(f"[pg] step {step}: dev CER {cer:.4f} "
                              f"(best {best_val:.4f})")
                if preempted.is_set():
                    _save(step, val=None)  # model_last at the exact step
                    print(f"[pg] SIGTERM: saved model_last at step {step}; "
                          "rerun finetune_pg to resume")
                    return {"rewards": _floats(reward_dev), "params": params,
                            "config": cfg, "dev_cers": dev_cers,
                            "interrupted": True}
                if step >= num_steps:
                    break

        rewards = _floats(reward_dev)
        np.save(os.path.join(model_path, "pg_rewards.npy"), np.array(rewards))
        if dev_cers:
            np.save(os.path.join(model_path, "pg_dev_cer.npy"),
                    np.array(dev_cers))
        if dev_rows is None:
            # no dev set: select on the reward proxy
            _save(step, val=-float(np.mean(rewards[-10:])))
        print(f"[pg] {step} steps, final reward {np.mean(rewards[-10:]):.4f} "
              f"({time.time() - t0:.1f}s)")
    finally:
        restore_sigterm()
    return {"rewards": rewards, "params": params, "config": cfg,
            "dev_cers": dev_cers}


def _floats(values: list[torch.Tensor]) -> list[float]:
    """Device scalars -> floats, in one transfer."""
    return torch.stack(values).tolist() if values else []
