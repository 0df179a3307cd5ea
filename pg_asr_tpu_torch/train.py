"""Supervised training driver on one device (counterpart of
pg_asr_tpu/train.py).

Epoch loop with per-epoch validation on dev.tsv, best/last checkpoints
selected on validation loss (``val_metric="cer"``: the greedy dev CER of
the same pass), train_loss.npy / val_losses.npy, and resume from
model_last (with the model family and its config from the checkpoint's
config.json), at the next batch of the same shuffled order when the save
was mid-epoch (``save_every_steps``, or SIGTERM: ``utils/preempt.py``).
One step: with ``augment.enabled`` the waveform options then features then
SpecAugment (no gradient, draws from the step's generator) -> the family's
model with dropout (BiLSTM-CTC: the LSTM kernels under autograd;
transformer-CTC and conformer-CTC: with ``flash_attention`` the
flash-attention kernels under autograd, with ``model.remat`` each block
recomputed in the backward; the transducer: one of those encoders, the
prediction network, and with ``transducer.fused_joint`` the fused joint
kernels under autograd; the attention seq2seq: the BiLSTM encoder's kernels
and the teacher-forced decoder LSTM on ``lstm_fwd`` / ``lstm_bwd``) -> CTC,
the transducer's lattice loss or the seq2seq per-step NLL ->
gradients -> (``accum_steps``: their running mean over micro-batches) ->
clip by global norm -> AdamW, with optax's rules and rounding points
(``AdamW`` below) -> (``ema_decay``: the parameters' moving average, on
which validation and selection run). Parameters stay in the model's
dtype, as the JAX package creates them (LayerNorm params in float32);
there is no master copy. Rolling per-epoch snapshots (``keep_ckpts``) feed
``predict --ckpt avg``; ``init_from_torch`` warm-starts from a reference
checkpoint (models/torch_import.py); ``profile_steps`` traces steps with
torch.profiler (utils/profiling.py).

Also here for policy-gradient fine-tuning (rl/reinforce.py): ``AdamW``'s
constant-rate form, ``_ema_update`` and the greedy dev CER
(``corpus_cer``).

The switch-MoE transformer (``transformer.num_experts`` > 0,
parallel/moe.py) trains too: CTC plus the load-balance aux as stacked
num/den components. Under ``--debug_nans`` (utils/debug.py) every step's
loss and gradients are checked for NaN (``value_and_grad``), and the dev
pass's loss.

``--mesh`` (``train.mesh_shape`` / ``mesh_axes``; parallel/driver.py's
``ParallelPlan``): this process is one of the mesh's ranks joined in a
process group (parallel/mesh.py; the CLI starts them). The ranks that hold
distinct rows (``data``, or ``data x fsdp``; a model or an expert group's
ranks hold the same rows) each iterate their own slice of the corpus
(``BatchIterator(shard_index=rank, shard_count=N)``) at ``batch_size //
N`` rows, every rank running the same number of steps (the shortest
slice's), and the step takes the loss as the sum of the rank's
numerators over the all-reduced denominators and sums the gradients over
those ranks (``make_train_step(dp=)``: the JAX package's ``shard_map``
step under ``data``, its GSPMD step under ``model``, ``expert`` and
``fsdp``). The parameters are broadcast from rank 0, then each rank keeps
its part of the split leaves (``DataParallel.shard``: a model group's
Megatron parts and slices of the other leaves its rules split, an expert
group's experts, an fsdp group's slices of every divisible leaf), and
AdamW, its accumulator and the EMA run on those parts; the clip's global
norm completes each split leaf's squares over its group. Under ``fsdp`` a
step gathers the whole tree first and reduce-scatters the gradients
after; under ``model`` it gathers the leaves that no Megatron pair
computes in parts (parallel/tensor.py). Dropout and
augmentation draw from a generator of the rows (``step_generator``). Only
rank 0 writes checkpoints and artifacts, always in the one-device layout
(the parts gathered first), so that any mesh resumes and one device
serves them; a SIGTERM to any rank stops every rank at the same step.
``fault_step`` injects a crash for the elastic supervisor
(utils/elastic.py).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import os
import time
from typing import Callable

import numpy as np
import torch

from . import not_ported, resolve_device
from .checkpoint import (BEST_NAME, LAST_NAME, checkpoint_path,
                         cleanup_tmp, has_flax_checkpoints, load_checkpoint,
                         save_checkpoint, save_config, save_rolling)
from .config import Config, fit_vocab
from .data import BatchIterator, PrefetchIterator, load_manifest
from .data.bpe import load_tokenizer
from .losses import seq2seq_nll_terms
from .models import (acoustic_forward, bilstm_ctc, cast_params,
                     check_family, conformer_ctc, seq2seq, transducer,
                     transformer_ctc)
from .ops.augment import spec_augment, wave_augment, wave_augmented
from .ops.ctc import ctc_loss_terms, ctc_loss_terms_fused
from .ops.features import extract_features
from .ops.transducer import transducer_loss_terms
from .parallel.driver import ParallelPlan
from .parallel.mesh import ONE_DEVICE, DataParallel, join_mesh
from .parallel.moe import init_moe_params, moe_loss_terms
from .utils import debug
from .utils.logging import StepLogger
from .utils.preempt import install_preemption_handler
from .utils.profiling import start_trace, stop_trace


def init_model_params(cfg: Config, generator: torch.Generator,
                      device: torch.device | str) -> dict[str, torch.Tensor]:
    """Family dispatch (the JAX package's ``init_model_params``): the
    initial parameters of the configured family, drawn on the CPU from
    `generator`, then moved and cast."""
    family = cfg.model.family
    check_family(family)
    if family == "transducer":
        return transducer.init_params(cfg, generator, device)
    if family == "seq2seq":
        return seq2seq.init_params(cfg.model, cfg.seq2seq, generator, device)
    if family == "transformer":
        if cfg.transformer.num_experts > 0:
            return init_moe_params(cfg, cfg.transformer.num_experts,
                                   generator, device)
        return transformer_ctc.init_params(cfg.model, cfg.transformer,
                                           generator, device)
    if family == "conformer":
        return conformer_ctc.init_params(cfg.model, cfg.conformer, generator,
                                         device)
    return bilstm_ctc.init_params(cfg.model, generator, device)


def make_schedule(cfg: Config) -> Callable[[int], float]:
    """Learning rate at optimizer count n (before its increment), as the JAX
    package's optax schedules give it, evaluated in float32: linear warmup
    from 0 (so the first update has lr 0), then constant, or
    ``optax.warmup_cosine_decay_schedule``."""
    t = cfg.train
    lr = np.float32(t.learning_rate)

    def linear(count: int, steps: int) -> float:
        frac = np.float32(1.0) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
        return float(np.float32(-lr) * frac + lr)

    if t.lr_schedule == "warmup_cosine" and t.decay_steps > 0:
        warm = max(t.warmup_steps, 1)
        decay = max(t.decay_steps, t.warmup_steps + 1) - warm
        end = np.float32(t.learning_rate * t.lr_end_factor)
        alpha = np.float32(0.0) if lr == 0 else end / lr

        def cosine(count: int) -> float:
            if count < warm:
                return linear(count, warm)
            c = np.float32(min(count - warm, decay))
            cos = np.float32(0.5) * (np.float32(1.0) + np.cos(
                np.float32(np.pi) * c / np.float32(decay), dtype=np.float32))
            return float(lr * ((np.float32(1.0) - alpha) * cos + alpha))

        return cosine
    if t.warmup_steps > 0:
        return lambda count: linear(count, t.warmup_steps)
    return lambda count: float(lr)


def tree_order(name: str) -> list:
    """Sort key of a flat parameter name in the order ``jax.tree.leaves``
    walks the JAX package's tree: dict keys sorted, list items by index."""
    return [(0, int(s), "") if s.isdigit() else (1, 0, s)
            for s in name.split(".")]


def global_norm(grads: dict[str, torch.Tensor],
                dp: DataParallel = ONE_DEVICE) -> torch.Tensor:
    """``optax.global_norm`` of the whole tree: per leaf the sum of its
    squares (each square rounded to the leaf's dtype, summed in float32 as
    ``jnp.sum`` does, rounded back), those sums added in tree order in the
    promoted dtype (bfloat16 until a float32 leaf joins), then the root in
    that dtype. ``dp``: a leaf split over a mesh axis sums its part's
    squares over that axis's group before the rounding back; a whole leaf
    counts once; under ``pipe`` the other stages' blocks join with their
    stages' sums, each leaf once."""
    sums = dp.leaf_sums({k: (g * g).float().sum() for k, g in grads.items()})
    total = None
    for k in sorted(sums, key=tree_order):
        s = sums[k].to(grads[k].dtype) if k in grads else sums[k]
        total = s if total is None else total + s
    return torch.sqrt(total)


@functools.lru_cache(maxsize=1024)
def _weak(x: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX applies a weak-typed one to an array of
    `dtype`: rounded to that dtype first (torch would keep it in float32
    inside a bfloat16 op)."""
    return torch.tensor(x, dtype=dtype).item()


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule,
    weight_decay))`` with optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0), updating a dict of parameters in place, with optax's
    dtypes and rounding points in every parameter dtype (optax 0.2.6).

    Clip: g <- g / |g| * max_norm only where |g| >= max_norm (no epsilon, so
    ``clip_grad_norm_`` is not the same rule), |g| from ``global_norm``.
    Adam moments live in the parameters' dtype; bias corrections
    ``1 - b**count`` use the incremented count, in float32, rounded to the
    moment's dtype before the division; weight decay adds ``wd * p`` to the
    update; the step is ``-lr(count) * update`` at the count before the
    increment, lr rounded to the update's dtype. Every Python scalar is
    rounded to the tensor's dtype before its product, as JAX does with weak
    types, and every operation rounds its result to that dtype. The clip
    decision stays on the device (no host synchronisation).

    ``train.accum_steps`` = k > 1 wraps it in ``optax.MultiSteps``: each
    call adds the gradients to a running mean in their dtype, ``acc + (g -
    acc) / (n + 1)`` at micro-step n, and the k-th applies the clip and
    AdamW to that mean and resets it (``acc * 0``, as optax), so the
    schedule and the moments count emitted updates only. optax also
    computes the inner update on the other micro-steps and discards it
    (its state kept only on the k-th, the update multiplied by 0); that
    changes nothing for finite gradients, and is skipped here.

    On a mesh (``dp``) the parameters, moments and accumulator are this
    rank's parts of the split leaves, and the clip takes the whole tree's
    norm (``global_norm(dp=)``)."""

    b1, b2, eps, eps_root = 0.9, 0.999, 1e-8, 0.0

    def __init__(self, cfg: Config, params: dict[str, torch.Tensor],
                 learning_rate: float | None = None,
                 weight_decay: float | None = None,
                 dp: DataParallel = ONE_DEVICE):
        """The rate follows ``make_schedule(cfg)`` and the decay
        ``cfg.train.weight_decay``, unless given: a given `learning_rate` is
        constant, a Python float rounded to each update's dtype where it is
        applied, as optax applies a float rate (policy-gradient fine-tuning's
        ``optax.adamw(lr * 0.1)``, whose decay is optax's default 1e-4), and
        accumulates no gradients (that chain has no MultiSteps)."""
        self.dp = dp
        self.accum_steps = (max(cfg.train.accum_steps, 1)
                            if learning_rate is None else 1)
        self.max_norm = cfg.train.grad_clip
        self.weight_decay = (cfg.train.weight_decay if weight_decay is None
                             else weight_decay)
        self.schedule = (make_schedule(cfg) if learning_rate is None
                         else lambda count: learning_rate)
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0
        self.mini_step = 0
        self.acc = ({k: torch.zeros_like(p) for k, p in params.items()}
                    if self.accum_steps > 1 else None)

    def state_dict(self) -> dict:
        state = {"mu": self.mu, "nu": self.nu, "count": self.count}
        if self.acc is not None:
            state.update(mini_step=self.mini_step, acc_grads=self.acc)
        return state

    def load_state_dict(self, state: dict, device) -> None:
        def like(key, mine):
            return {k: state[key][k].to(device=device, dtype=v.dtype)
                    for k, v in mine.items()}

        self.mu, self.nu = like("mu", self.mu), like("nu", self.nu)
        self.count = int(state["count"])
        if self.acc is not None and "acc_grads" in state:
            self.acc = like("acc_grads", self.acc)
            self.mini_step = int(state["mini_step"])

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor],
               grads: dict[str, torch.Tensor]) -> None:
        if self.acc is not None:
            n, divisors = self.mini_step, {}
            for k, g in grads.items():
                a = self.acc[k]
                if (a.dtype, a.device) not in divisors:  # a device tensor,
                    # as the bias corrections below: a true division
                    divisors[a.dtype, a.device] = torch.full(
                        (), n + 1, dtype=a.dtype, device=a.device)
                self.acc[k] = a + (g - a) / divisors[a.dtype, a.device]
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                return
            grads, self.acc = self.acc, {k: a * 0 for k, a in self.acc.items()}
        self._step(params, grads)

    def _step(self, params, grads) -> None:
        g_norm = global_norm(grads, self.dp)
        keep = g_norm < _weak(self.max_norm, g_norm.dtype)
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - np.float32(self.b1) ** np.float32(self.count)
        bc2 = 1.0 - np.float32(self.b2) ** np.float32(self.count)
        corrections = {}
        for k, p in params.items():
            g, dt = grads[k], p.dtype
            if (dt, p.device) not in corrections:
                # device tensors: CUDA divides by a CPU scalar through its
                # reciprocal, which is not optax's division
                corrections[dt, p.device] = [
                    torch.full((), float(bc), dtype=dt, device=p.device)
                    for bc in (bc1, bc2)]
            c1, c2 = corrections[dt, p.device]
            g = torch.where(keep, g, g / g_norm.to(dt)
                            * _weak(self.max_norm, dt))
            mu = _weak(1 - self.b1, dt) * g + _weak(self.b1, dt) * self.mu[k]
            nu = (_weak(1 - self.b2, dt) * (g * g)
                  + _weak(self.b2, dt) * self.nu[k])
            self.mu[k], self.nu[k] = mu, nu
            u = mu / c1 / (torch.sqrt(nu / c2 + _weak(self.eps_root, dt))
                           + _weak(self.eps, dt))
            u = u + _weak(self.weight_decay, dt) * p
            p.add_(_weak(-lr, dt) * u)


@torch.no_grad()
def _ema_update(ema_params: dict[str, torch.Tensor],
                params: dict[str, torch.Tensor], decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place, with the JAX
    package's rounding points: each Python scalar rounded to the EMA's
    dtype (a weak type); in bfloat16 each product and the sum rounded (not
    ``torch.lerp``, which rounds once); in float32 XLA fuses ``decay * ema
    + q`` into one multiply-add (the product exact, the sum rounded once),
    which float64 reproduces here."""
    by_dtype: dict[torch.dtype, list[str]] = {}
    for k, e in ema_params.items():
        by_dtype.setdefault(e.dtype, []).append(k)
    for dt, keys in by_dtype.items():
        ema = [ema_params[k] for k in keys]
        new = torch._foreach_mul([params[k].to(dt) for k in keys],
                                 _weak(1.0 - decay, dt))
        if dt == torch.float32:
            for e, q in zip(ema, new):
                e.copy_(e.double().mul_(_weak(decay, dt)).add_(q.double()))
        else:
            torch._foreach_mul_(ema, _weak(decay, dt))
            torch._foreach_add_(ema, new)


def compute_loss(params, wave, num_samples, labels, label_lens, cfg: Config,
                 train: bool, generator: torch.Generator | None = None,
                 use_kernel: bool = True) -> torch.Tensor:
    """Scalar loss of one batch (the JAX package's ``compute_loss``):
    ``sum(num / max(den, 1))`` of ``loss_terms``."""
    num, den = loss_terms(params, wave, num_samples, labels, label_lens, cfg,
                          train, generator, use_kernel)
    return torch.sum(num / torch.clamp(den, min=1.0))


def loss_terms(params, wave, num_samples, labels, label_lens, cfg: Config,
               train: bool, generator: torch.Generator | None = None,
               use_kernel: bool = True, dp: DataParallel = ONE_DEVICE):
    """(numerator, denominator) tensors of one shape whose ``sum(num /
    max(den, 1))`` is the batch's loss, so that a data-parallel step can sum
    the denominators over the ranks first: CTC for the CTC families, for
    the switch-MoE transformer plus ``moe_aux_weight`` x the load-balance
    aux (``moe_loss_terms``, two stacked components); for the transducer
    the lattice loss, plus ``ctc_weight`` x the auxiliary head's CTC loss
    when that is above 0 (two stacked components); for the seq2seq family
    the teacher-forced per-step NLL (``losses.seq2seq_nll_terms``).
    Features carry no gradient. In training with a generator and
    ``augment.enabled``: the waveform options (when one is set) before the
    features and SpecAugment after them, their draws taken from the
    generator before the model's dropout draws. ``use_kernel`` picks the
    whole path: True, the kernels on CUDA tensors and ``F.ctc_loss``;
    False, the plain reference path on any device, the plain recurrences,
    joint and CTC recursion (augmentation is plain PyTorch in both).
    ``dp``: the MoE routes its experts' slots in the global token order of
    the ranks' batches (parallel/moe.py); a model axis's rank runs its part
    of the Megatron pairs (parallel/tensor.py) on the parameters that
    ``dp.forward_params`` gives."""
    aug = cfg.augment
    augment = train and aug.enabled and generator is not None
    with torch.no_grad():
        if augment and wave_augmented(aug):
            wave, num_samples = wave_augment(wave, num_samples, generator,
                                             aug)
        feats, mask, frame_lens = extract_features(wave, num_samples,
                                                   cfg.features)
        if augment:
            feats = spec_augment(feats, mask, generator, aug)
    if cfg.model.family == "seq2seq":
        log_probs = seq2seq.apply_teacher_forced(
            params, feats, mask, labels, cfg.model, use_kernel=use_kernel,
            train=train, generator=generator)
        return seq2seq_nll_terms(log_probs, labels, label_lens)
    ctc_terms = ctc_loss_terms_fused if use_kernel else ctc_loss_terms
    if cfg.model.family == "transducer":
        lam = cfg.transducer.ctc_weight
        out = transducer.apply_lattice(
            params, feats, mask, frame_lens, labels, label_lens, cfg,
            use_kernel=use_kernel, train=train, generator=generator,
            with_ctc=lam > 0.0, dp=dp)
        num, den = transducer_loss_terms(out[0], out[1], out[2], label_lens)
        if lam > 0.0:  # hybrid: L = L_rnnt + lam * L_ctc
            num_c, den_c = ctc_terms(out[3], out[2], labels, label_lens)
            return torch.stack([num, lam * num_c]), torch.stack([den, den_c])
        return num, den
    if (cfg.model.family == "transformer"
            and cfg.transformer.num_experts > 0):
        # the switch-MoE encoder: CTC + the load-balance aux, stacked
        # num/den components
        return moe_loss_terms(params, feats, mask, frame_lens, labels,
                              label_lens, cfg, train=train,
                              generator=generator, use_kernel=use_kernel,
                              dp=dp)
    log_probs, _, out_lens = acoustic_forward(
        params, feats, mask, frame_lens, cfg, use_kernel=use_kernel,
        train=train, generator=generator, dp=dp)
    return ctc_terms(log_probs, out_lens, labels, label_lens)


def value_and_grad(fn: Callable, params: dict[str, torch.Tensor]):
    """(fn(params), {name: d loss / d param}) for fn returning a scalar loss
    or (loss, aux); a parameter the loss does not reach gets a zero
    gradient, as in JAX. With NaN checks on (``--debug_nans``,
    utils/debug.py) a NaN loss raises FloatingPointError before the
    backward, as do NaN gradients after it and the anomaly mode's NaN in a
    backward function; an infinite loss or gradient passes, as under the
    JAX package's ``jax_debug_nans``."""
    names = list(params)
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    with torch.enable_grad():
        out = fn(dict(zip(names, leaves)))
        loss = out[0] if isinstance(out, tuple) else out
        debug.check_nans(loss.detach(), "the loss")
        try:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        except RuntimeError as e:
            if debug.nan_checks_enabled() and "nan values" in str(e):
                raise FloatingPointError(str(e)) from e
            raise
    grads = {k: torch.zeros_like(p) if g is None else g
             for k, p, g in zip(names, leaves, grads)}
    debug.check_nans(grads, "the gradients")
    return out, grads


def loss_and_grads(params: dict[str, torch.Tensor], batch_arrays, cfg: Config,
                   generator: torch.Generator | None = None,
                   use_kernel: bool = True):
    """(loss, {name: gradient}) of one training batch; ``use_kernel`` as in
    ``compute_loss``."""
    loss, grads = value_and_grad(
        lambda p: compute_loss(p, *batch_arrays, cfg, train=True,
                               generator=generator, use_kernel=use_kernel),
        params)
    return loss.detach(), grads


def make_train_step(cfg: Config, optimizer: AdamW,
                    dp: DataParallel = ONE_DEVICE) -> Callable:
    """step(params, generator, wave, num_samples, labels, label_lens) ->
    loss; updates params and the optimizer state in place.

    ``dp``: this rank's place on the data axis (the JAX package's
    ``shard_map`` step): the loss is the sum of this rank's numerators over
    the denominators summed over the ranks (clamped at 1), so that ragged
    and zero-padded rows reduce to the global batch's loss, not to a mean
    of the ranks' means; the gradients are summed over the ranks before
    the clip and AdamW, which then run identically on every rank. Under
    ``fsdp`` the forward and backward run on the whole tree gathered for
    the step (``dp.forward_params``), the gradients come back as this
    rank's parts, and the gathered copies are freed. The draws come from
    ``dp.step_generator(generator)``. Returns the global loss. On one
    device (``ONE_DEVICE``) every sum is the identity. Under ``pipe`` and
    ``seq`` the step is parallel/pipeline.py's GPipe schedule and
    parallel/sequence.py's time-split encoder, with this contract (the
    JAX package's ``ParallelPlan.make_train_step`` routes them so)."""
    if dp.strategy == "pipe":
        from .parallel import pipeline

        return pipeline.make_train_step(cfg, optimizer, dp)
    if dp.strategy == "seq":
        from .parallel import sequence

        return sequence.make_train_step(cfg, optimizer, dp)

    def train_step(params, generator, *batch_arrays):
        gen = dp.step_generator(generator)

        def loss_fn(p):
            num, den = loss_terms(p, *batch_arrays, cfg, train=True,
                                  generator=gen, dp=dp)
            return torch.sum(num / torch.clamp(dp.all_sum(den), min=1.0))

        loss, grads = value_and_grad(loss_fn, dp.forward_params(params))
        optimizer.update(params, dp.sum_grads(grads))
        return dp.all_sum(loss.detach())

    return train_step


def make_eval_step(cfg: Config, dp: DataParallel = ONE_DEVICE) -> Callable:
    """step(params, wave, num_samples, labels, label_lens) -> the global
    batch's loss without dropout, reduced as the train step's (on the
    parameters as this rank holds them: ``dp.forward_params``); under
    ``pipe`` and ``seq`` through their schedules."""
    if dp.strategy == "pipe":
        from .parallel import pipeline

        return pipeline.make_eval_step(cfg, dp)
    if dp.strategy == "seq":
        from .parallel import sequence

        return sequence.make_eval_step(cfg, dp)

    @torch.no_grad()
    def eval_step(params, *batch_arrays):
        num, den = loss_terms(dp.forward_params(params), *batch_arrays, cfg,
                              train=False, dp=dp)
        loss = dp.all_sum(torch.sum(
            num / torch.clamp(dp.all_sum(den), min=1.0)))
        debug.check_nans(loss, "the dev loss")
        return loss

    return eval_step


def batch_to_device(batch, device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(a).to(device, non_blocking=True) for a in
                 (batch.wave, batch.num_samples, batch.labels,
                  batch.label_lens))


@torch.no_grad()
def _batch_cer_counts(params, batch, cfg: Config,
                      alphabet) -> tuple[int, int]:
    """Greedy-decode one batch on the params' device and return the additive
    corpus-CER counts (edit-distance sum, reference-length sum), from the
    host ``metrics.edit_dist`` (the JAX package's counterpart)."""
    from .decoding.greedy import greedy_decode, ids_to_strings
    from .metrics import edit_dist
    from .predict import forward, forward_seq2seq, forward_transducer

    dev = next(iter(params.values())).device
    wave = torch.from_numpy(batch.wave).to(dev)
    ns = torch.from_numpy(batch.num_samples).to(dev)
    if cfg.model.family == "transducer":
        labels, lens = forward_transducer(params, wave, ns, cfg)
    elif cfg.model.family == "seq2seq":
        labels, lens = seq2seq.cut_at_eos(
            forward_seq2seq(params, wave, ns, cfg)[0])
    else:
        log_probs, mask, _ = forward(params, wave, ns, cfg)
        labels, lens = greedy_decode(log_probs, mask)
    d_sum = l_sum = 0
    for ref, hyp in zip(batch.texts, ids_to_strings(labels, lens, alphabet)):
        d, n = edit_dist(ref, hyp)
        d_sum += d
        l_sum += n
    return d_sum, l_sum


def corpus_cer(params, rows, alphabet, cfg: Config, batch_size: int,
               dp: DataParallel = ONE_DEVICE) -> float:
    """Greedy corpus CER (total edits / total reference characters) over a
    manifest's rows (the JAX package's ``sharded_corpus_cer``; policy-
    gradient fine-tuning selects its best checkpoint with it,
    ``val_metric="cer"`` sums the same counts in the dev pass). Each rank
    of ``dp`` decodes its slice of the rows at `batch_size` rows a batch,
    every rank the same number of batches (the shortest slice's), on the
    whole parameters (``dp.unshard``), and the counts are summed over the
    ranks that hold distinct rows."""
    params = dp.unshard(params)
    it = BatchIterator(rows, alphabet, batch_size, shuffle=False,
                       sample_rate=cfg.features.sample_rate,
                       shard_index=dp.rank, shard_count=dp.world)
    d_sum = l_sum = 0
    for batch in itertools.islice(it, rank_batches(len(rows), batch_size,
                                                   dp)):
        d, L = _batch_cer_counts(params, batch, cfg, alphabet)
        d_sum += d
        l_sum += L
    d_sum, l_sum = dp.sum_counts(d_sum, l_sum)
    return d_sum / max(l_sum, 1)


def rank_batches(n_rows: int, rank_bs: int, dp: DataParallel) -> int:
    """Batches every rank runs over a manifest of `n_rows`: the shortest
    slice's count, the same on every rank without communication, so that
    the ranks' collectives pair up (on one device, every batch)."""
    return -(-(n_rows // dp.world) // rank_bs)


def make_plan(cfg: Config, replicas: bool = False) -> ParallelPlan:
    """The config's mesh validated against its model (parallel/driver.py):
    refuses the family and mesh options that are not ported.
    ``replicas``: a policy-gradient step's plan (pipe and seq ranks run
    copies of the data step)."""
    t = cfg.train
    check_family(cfg.model.family)
    return ParallelPlan(cfg, t.mesh_shape, t.mesh_axes,
                        t.pipeline_microbatches, replicas)


def check_ported(cfg: Config) -> int:
    """Refuse the training options that are not ported; returns the number
    of rank processes of the config's mesh."""
    return make_plan(cfg).world


def _copy(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in params.items()}


def resume_config(cfg: Config, model_path: str,
                  say: Callable[[str], None] = print
                  ) -> tuple[Config, bool]:
    """The config a train run on `model_path` takes, and whether it resumes
    a checkpoint there (each change it makes reported through `say`). A
    directory holding only a JAX package run is refused."""
    # resuming keeps the architecture of the checkpoint's config.json: a
    # resume that omits --model (or names another family) must neither
    # build a wrong model nor overwrite config.json with it
    has_ckpt = any(os.path.exists(os.path.join(model_path, n))
                   for n in (BEST_NAME, LAST_NAME))
    if not has_ckpt and has_flax_checkpoints(model_path):
        # starting fresh would overwrite the JAX run's config.json
        raise not_ported("resuming a JAX package run (its optax state)")
    prev_cfg_path = os.path.join(model_path, "config.json")
    if os.path.exists(prev_cfg_path):
        with open(prev_cfg_path) as fo:
            prev = Config.from_json(fo.read())
        if prev.text.units != cfg.text.units:
            # the tokenizer the model directory was made with, whatever
            # --units says (a wrong vocabulary would not load)
            say(f"[train] resuming with text.units={prev.text.units!r} "
                "from the checkpoint's config.json")
            cfg = cfg.replace(text=dataclasses.replace(
                cfg.text, units=prev.text.units))
        if has_ckpt:
            if prev.model.family != cfg.model.family:
                say(f"[train] resuming with model family "
                    f"{prev.model.family!r} from the checkpoint's "
                    f"config.json (requested {cfg.model.family!r} ignored)")
            cfg = cfg.replace(model=prev.model, transformer=prev.transformer,
                              conformer=prev.conformer,
                              transducer=prev.transducer,
                              seq2seq=prev.seq2seq, features=prev.features,
                              text=prev.text)
        if cfg.train.ema_decay == 0.0 and prev.train.ema_decay > 0.0:
            # a resume without --ema_decay keeps the average the best
            # checkpoint was selected on
            say(f"[train] resuming with ema_decay={prev.train.ema_decay} "
                "from the checkpoint's config.json")
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, ema_decay=prev.train.ema_decay))
    return cfg, has_ckpt


def train(corpus_path: str, model_path: str, config: Config | None = None,
          device: str = "cuda", profile_steps: int = 0,
          fault_step: int | None = None) -> dict:
    """Train a model (BiLSTM-CTC, transformer-CTC, conformer-CTC, the
    switch-MoE transformer, the transducer or the attention seq2seq) on a
    corpus directory (train.tsv, dev.tsv, clips/, alphabet.txt), resuming
    from a checkpoint in model_path if there is one: at the next epoch, or
    mid-epoch at the next batch of the same shuffled order, with the step
    generator's state, so that a resumed run takes the steps of an
    uninterrupted one. SIGTERM saves model_last at the current batch and
    returns (``"interrupted": True``). ``profile_steps`` = N > 0 traces
    this process's steps 2..2+N into <model_path>/trace. ``fault_step`` =
    N ends the process with ``os._exit(utils.elastic.FAULT_EXIT)`` after
    global step N (after that step's mid-epoch save), once per model
    directory. Under ``--mesh`` this process is one rank of the joined
    process group (see the module's docstring). Returns a summary dict
    with the loss curves (and the whole parameters)."""
    cfg = config or Config()
    check_family(cfg.model.family)
    dev = resolve_device(device)

    cfg, has_ckpt = resume_config(cfg, model_path)
    alphabet = load_tokenizer(corpus_path, cfg.text.units)
    cfg = fit_vocab(cfg, alphabet.size)
    # the mesh, checked against the model the run trains
    dp = join_mesh(make_plan(cfg), dev)
    is_main, world = dp.is_main, dp.world

    aud_path = os.path.join(corpus_path, "clips")
    t = cfg.train
    # each rank of distinct rows takes its slice of the corpus at
    # batch_size // N rows a batch; every rank runs the same number of
    # steps, from the global manifest's size (no communication needed):
    # the caps
    rank_bs = max(1, t.batch_size // world)
    manifest = load_manifest(os.path.join(corpus_path, "train.tsv"), aud_path)
    train_it = BatchIterator(
        manifest, alphabet, rank_bs, sample_rate=cfg.features.sample_rate,
        seed=t.seed, cache_mb=t.cache_audio_mb, num_workers=t.loader_threads,
        shard_index=dp.rank, shard_count=dp.world)
    epoch_len = min(len(train_it), rank_batches(len(manifest), rank_bs, dp))
    dev_tsv = os.path.join(corpus_path, "dev.tsv")
    dev_it = dev_cap = None
    if os.path.exists(dev_tsv):
        dev_manifest = load_manifest(dev_tsv, aud_path)
        dev_cap = rank_batches(len(dev_manifest), rank_bs, dp)
        if dev_cap == 0 and dev_manifest:
            # fewer dev rows than ranks: no rank validates
            if is_main:
                print("[train] dev set smaller than the data axis - "
                      "skipping validation")
        else:
            dev_it = BatchIterator(dev_manifest, alphabet, rank_bs,
                                   shuffle=False,
                                   sample_rate=cfg.features.sample_rate,
                                   shard_index=dp.rank,
                                   shard_count=dp.world)
    select_on_cer = t.val_metric == "cer" and dev_it is not None
    if t.lr_schedule == "warmup_cosine" and t.decay_steps <= 0:
        # the cosine horizon from the run's length, as the JAX package
        cfg = cfg.replace(train=dataclasses.replace(
            t, decay_steps=max(t.num_epochs * -(-len(manifest)
                                                // (rank_bs * world)),
                               t.warmup_steps + 1)))
        t = cfg.train

    params = init_model_params(cfg, torch.Generator().manual_seed(t.seed),
                               dev)
    opt_state = None  # a restored optimizer state, in the full shapes
    use_ema = t.ema_decay > 0.0
    ema = None
    # the carried generator, the same on every rank: on the device, or on
    # the host when the ranks draw from generators of their own
    # (DataParallel.step_generator)
    generator = torch.Generator(
        device=dev if dp.n_ranks == 1 else "cpu").manual_seed(t.seed)
    start_epoch, step, best_val, skip = 1, 0, math.inf, 0
    train_losses: list[float] = []
    val_losses: list[float] = []
    if has_ckpt:
        which = "last" if os.path.exists(
            os.path.join(model_path, LAST_NAME)) else "best"
        state = load_checkpoint(checkpoint_path(model_path, which))
        dtype = bilstm_ctc.torch_dtype(cfg.model.dtype)
        params = cast_params(state["params"], dtype, dev)
        opt_state = state["opt_state"]
        if use_ema and "ema_params" in state:
            ema = cast_params(state["ema_params"], dtype, dev)
        elif use_ema:
            print("[train] checkpoint has no EMA state - initializing the "
                  "average from the restored params")
        rng = state.get("rng_state")
        if rng is not None and rng.numel() == generator.get_state().numel():
            # (a state of another device's generator is not restored)
            generator.set_state(rng)
        step = int(state["step"])
        best_val = float(state["best_val_loss"])
        done = int(state.get("batches_done", 0))
        if 0 < done < epoch_len:
            # saved mid-epoch: re-enter that epoch at the next batch
            start_epoch, skip = int(state["epoch"]), done
        else:
            # done == the epoch's length: its steps all ran and only the
            # epoch-end work was lost; a zero-batch epoch would log a 0.0
            # train loss
            start_epoch = int(state["epoch"]) + 1
        for name, dst in (("train_loss.npy", train_losses),
                          ("val_losses.npy", val_losses)):
            path = os.path.join(model_path, name)
            if os.path.exists(path):
                dst.extend(np.load(path).tolist())
        print(f"[train] resumed from epoch {state['epoch']}"
              + (f" batch {done}" if done > 0 else "")
              + f" (best val {best_val:.4f})")
        # the batch order an uninterrupted run would have
        train_it.skip_epochs(start_epoch - 1)
        train_it.skip_batches(skip)
    if t.init_from_torch and step == 0 and start_epoch == 1:
        # a warm start from a reference checkpoint; a restored checkpoint
        # of this package wins over it
        from .models.torch_import import init_from_torch_checkpoint

        params, report = init_from_torch_checkpoint(
            t.init_from_torch, params, cfg,
            allow_pickle=t.trust_torch_pickle)
        opt_state, ema = None, None
        print(f"[train] {report}")
    if use_ema and ema is None:
        ema = _copy(params)
    dp.broadcast_(params)  # every rank starts from rank 0's parameters
    if use_ema:
        dp.broadcast_(ema)
    # from here on each rank holds its parts of the mesh's split leaves
    params = dp.shard(params)
    ema = dp.shard(ema) if use_ema else None
    optimizer = AdamW(cfg, params, dp=dp)
    if opt_state is not None:
        optimizer.load_state_dict(_opt_layout(opt_state, dp.shard), dev)
    # written only after the restore attempt: a failed resume must not
    # leave config.json overwritten with a mismatched run's settings
    if is_main:
        cleanup_tmp(model_path)
        save_config(model_path, cfg)

    train_step = make_train_step(cfg, optimizer, dp)
    eval_step = make_eval_step(cfg, dp)
    logger = StepLogger(model_path) if is_main else None
    source = (PrefetchIterator(train_it, depth=t.prefetch_depth)
              if t.prefetch_depth > 0 else train_it)
    last_path = checkpoint_path(model_path, "last")

    def state_at(epoch: int, batches_done: int) -> dict:
        """The checkpoint's state in the full shapes (every rank takes
        part in the gathers; rank 0 writes it)."""
        state = {"params": dp.unshard(params),
                 "opt_state": _opt_layout(optimizer.state_dict(),
                                          dp.unshard),
                 "step": step, "epoch": epoch, "batches_done": batches_done,
                 "best_val_loss": best_val,
                 "rng_state": generator.get_state()}
        if use_ema:
            state["ema_params"] = dp.unshard(ema)
        return state

    def save_last(epoch: int, batches_done: int) -> None:
        state = state_at(epoch, batches_done)
        if is_main:
            save_checkpoint(last_path, state)

    def summary(**extra) -> dict:
        return {"train_losses": train_losses, "val_losses": val_losses,
                "steps": step, "config": cfg, "alphabet": alphabet,
                "params": dp.unshard(params),
                "ema_params": dp.unshard(ema) if use_ema else None,
                "best_path": checkpoint_path(model_path, "best"),
                "last_path": last_path, **extra}

    trace = None  # profile_steps: a trace of steps 2..2+N of this process
    trace_dir = os.path.join(model_path, "trace")
    run_steps = 0

    def end_trace() -> None:
        """Stop the trace after this process's step run_steps (global
        step `step`); it began before step 3."""
        nonlocal trace
        path = stop_trace(trace, trace_dir,
                          f"steps_{step - run_steps + 3}-{step}")
        trace = None
        print(f"[train] trace of {run_steps - 2} steps written to {path}")

    preempted, restore_sigterm = install_preemption_handler()
    try:
        for epoch in range(start_epoch, t.num_epochs + 1):
            # the epoch's loss sums on the device: one host read per epoch
            epoch_loss, n_batches = None, 0
            # the batch's place in the epoch (a mid-epoch resume starts at
            # the saved one; n_batches counts this process's batches)
            batch_pos, skip = skip, 0
            t0 = time.time()
            batches = iter(source)
            try:
                for batch in batches:
                    if batch_pos >= epoch_len:
                        break  # the ranks' step counts stay equal
                    if (profile_steps > 0 and run_steps == 2 and is_main
                            and trace is None):
                        trace = start_trace(dev)
                    loss = train_step(params, generator,
                                      *batch_to_device(batch, dev))
                    if use_ema:
                        _ema_update(ema, params, t.ema_decay)
                    step += 1
                    run_steps += 1
                    n_batches += 1
                    batch_pos += 1
                    if trace is not None and run_steps > 2 + profile_steps:
                        end_trace()
                    epoch_loss = loss if epoch_loss is None else epoch_loss + loss
                    if is_main and step % t.log_every == 0:
                        logger.log(step=step, epoch=epoch, loss=float(loss),
                                   utts_per_sec=batch.size * world * n_batches
                                   / (time.time() - t0))
                    if t.save_every_steps and batch_pos % t.save_every_steps == 0:
                        save_last(epoch, batch_pos)
                    if fault_step is not None and step == fault_step:
                        _inject_fault(model_path, step)
                    # one rank's SIGTERM stops every rank here: a rank that
                    # returned alone would leave its peers waiting in the
                    # next step's all-reduce
                    if dp.any(preempted.is_set()):
                        save_last(epoch, batch_pos)
                        if is_main:
                            print(f"[train] SIGTERM: saved model_last at "
                                  f"epoch {epoch} batch {batch_pos}; rerun "
                                  "to continue")
                        return summary(interrupted=True)
            finally:
                batches.close()  # ends the prefetch and decode threads
            if trace is not None:  # an epoch shorter than the window
                end_trace()
            mean_train = (float(epoch_loss) / max(n_batches, 1)
                          if epoch_loss is not None else 0.0)
            train_losses.append(mean_train)
            if is_main:
                np.save(os.path.join(model_path, "train_loss.npy"),
                        np.array(train_losses))

            cur_val = cur_cer = None
            eval_params = ema if use_ema else params
            if dev_it is not None and epoch % t.eval_every_epochs == 0:
                tot, n, d_sum, l_sum = None, 0, 0, 0
                # the greedy decode takes the whole parameters
                dec_params = dp.unshard(eval_params) if select_on_cer else None
                for batch in dev_it:
                    if n >= dev_cap:
                        break  # the ranks' collective counts stay equal
                    v = eval_step(eval_params, *batch_to_device(batch, dev))
                    tot = v if tot is None else tot + v
                    n += 1
                    if select_on_cer:  # greedy decode in the same pass
                        d, L = _batch_cer_counts(dec_params, batch, cfg,
                                                 alphabet)
                        d_sum, l_sum = d_sum + d, l_sum + L
                cur_val = float(tot) / max(n, 1) if tot is not None else 0.0
                val_losses.append(cur_val)
                if is_main:
                    np.save(os.path.join(model_path, "val_losses.npy"),
                            np.array(val_losses))
                if select_on_cer:  # over every rank's slice of the dev set
                    d_sum, l_sum = dp.sum_counts(d_sum, l_sum)
                    cur_cer = d_sum / max(l_sum, 1)
            if is_main:
                print(f"[train] epoch {epoch}/{t.num_epochs} "
                      f"train_loss={mean_train:.4f}"
                      + (f" val_loss={cur_val:.4f}" if cur_val is not None
                         else "")
                      + (f" val_cer={cur_cer:.4f}" if cur_cer is not None
                         else "")
                      + f" ({time.time() - t0:.1f}s, {n_batches} steps)")

            select = (cur_cer if cur_cer is not None else
                      cur_val if cur_val is not None else mean_train)
            is_best = select < best_val
            if is_best:
                best_val = select
            state = state_at(epoch, 0)
            if is_main:
                save_checkpoint(last_path, state)
                if is_best:
                    save_checkpoint(checkpoint_path(model_path, "best"),
                                    state)
                    print(f"[train] new best checkpoint "
                          f"({'cer' if cur_cer is not None else 'val'} "
                          f"{best_val:.4f})")
                if t.keep_ckpts > 0:  # for predict --ckpt avg
                    save_rolling(model_path, state, epoch, t.keep_ckpts)
        if is_main:
            print(f"[train] loader: {train_it.decoded['native']} batches by "
                  f"the native WAV decoder, {train_it.decoded['python']} by "
                  f"the Python one ({train_it.num_workers} decode threads, "
                  f"cache {t.cache_audio_mb:g} MiB)")
    finally:
        if trace is not None:
            end_trace()
        restore_sigterm()
    return summary()


def _opt_layout(state: dict, fn: Callable) -> dict:
    """An AdamW state with `fn` applied to its parameter-shaped dicts (the
    moments and the accumulator)."""
    return {k: fn(v) if isinstance(v, dict) else v for k, v in state.items()}


def _inject_fault(model_path: str, step: int) -> None:
    """--fault_step: end the process as an OOM kill would, with no handler
    and no flush, for the elastic supervisor to relaunch. Once per model
    directory: the marker, created by one process only (O_EXCL, so one
    rank of a data axis fires), holds the step; the relaunch replays the
    step from the last save and goes on."""
    from .utils.elastic import FAULT_EXIT

    try:
        fd = os.open(os.path.join(model_path, ".fault_injected"),
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return
    os.write(fd, str(step).encode())
    os.close(fd)
    os._exit(FAULT_EXIT)
