"""Supervised CTC training driver on one device (counterpart of
pg_asr_tpu/train.py).

Epoch loop with per-epoch validation on dev.tsv, best/last checkpoints
selected on validation loss, train_loss.npy / val_losses.npy, and resume
from model_last (with the model family and its config from the
checkpoint's config.json). One step: features (no gradient) -> a CTC
family's model with dropout (BiLSTM-CTC: the LSTM kernels under autograd;
transformer-CTC and conformer-CTC: with ``flash_attention`` the
flash-attention kernels under autograd, with ``model.remat`` each block
recomputed in the backward) -> CTC -> gradients -> clip by global norm ->
AdamW, with optax's rules (``AdamW`` below). Parameters stay in the
model's dtype, as the JAX package creates them (LayerNorm params in
float32); there is no master copy.

Not ported (each refused with a message, ROADMAP.md): the transducer and
seq2seq families, the switch-MoE transformer, device meshes and
multi-host, gradient accumulation, EMA, keep_ckpts, save_every_steps,
val_metric=cer, augmentation, init_from_torch, profiling, BPE units, the
built-batch cache.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable

import numpy as np
import torch

from . import not_ported, resolve_device
from .checkpoint import (BEST_NAME, LAST_NAME, checkpoint_path,
                         load_checkpoint, save_checkpoint, save_config)
from .config import Config
from .data import BatchIterator, PrefetchIterator, load_manifest
from .data.bpe import load_tokenizer
from .models import (acoustic_forward, bilstm_ctc, cast_params,
                     check_family, conformer_ctc, transformer_ctc)
from .ops.ctc import ctc_loss_terms, ctc_loss_terms_fused
from .ops.features import extract_features
from .utils.logging import StepLogger

_MOE = ("the switch-MoE transformer (transformer.num_experts > 0, --model "
        "moe; ROADMAP.md queue 1 item 14)")


def init_model_params(cfg: Config, generator: torch.Generator,
                      device: torch.device | str) -> dict[str, torch.Tensor]:
    """Family dispatch (the JAX package's ``init_model_params``): the
    initial parameters of the configured CTC family, drawn on the CPU from
    `generator`, then moved and cast."""
    family = cfg.model.family
    check_family(family)
    if family == "transformer":
        if cfg.transformer.num_experts > 0:
            raise not_ported(_MOE)
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


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule,
    weight_decay))`` with optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0), updating a dict of parameters in place.

    Clip: g <- g / |g| * max_norm only where |g| >= max_norm (no epsilon, so
    ``clip_grad_norm_`` is not the same rule). Adam moments live in the
    parameters' dtype; bias corrections use the incremented count; weight
    decay adds ``wd * p`` to the update; the step is ``-lr(count) * update``
    at the count before the increment. The clip decision stays on the
    device (no host synchronisation)."""

    b1, b2, eps, eps_root = 0.9, 0.999, 1e-8, 0.0

    def __init__(self, cfg: Config, params: dict[str, torch.Tensor]):
        if cfg.train.accum_steps > 1:
            raise not_ported("--accum_steps > 1 (optax.MultiSteps)")
        self.max_norm = cfg.train.grad_clip
        self.weight_decay = cfg.train.weight_decay
        self.schedule = make_schedule(cfg)
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, state: dict, device) -> None:
        for k in self.mu:
            self.mu[k] = state["mu"][k].to(device=device, dtype=self.mu[k].dtype)
            self.nu[k] = state["nu"][k].to(device=device, dtype=self.nu[k].dtype)
        self.count = int(state["count"])

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor],
               grads: dict[str, torch.Tensor]) -> None:
        g_norm = torch.sqrt(sum(g.float().square().sum()
                                for g in grads.values()))
        keep = g_norm < self.max_norm
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - np.float32(self.b1) ** np.float32(self.count)
        bc2 = 1.0 - np.float32(self.b2) ** np.float32(self.count)
        for k, p in params.items():
            g = grads[k]
            g = torch.where(keep, g, g / g_norm.to(g.dtype) * self.max_norm)
            mu = (1 - self.b1) * g + self.b1 * self.mu[k]
            nu = (1 - self.b2) * (g * g) + self.b2 * self.nu[k]
            self.mu[k], self.nu[k] = mu, nu
            mu_hat = mu / torch.tensor(float(bc1), dtype=mu.dtype)
            nu_hat = nu / torch.tensor(float(bc2), dtype=nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat + self.eps_root) + self.eps)
            u = u + self.weight_decay * p
            p.add_((-lr) * u)


def compute_loss(params, wave, num_samples, labels, label_lens, cfg: Config,
                 train: bool, generator: torch.Generator | None = None,
                 use_kernel: bool = True) -> torch.Tensor:
    """Scalar CTC loss of one batch (the JAX package's ``compute_loss`` for
    the CTC family). Features carry no gradient. ``use_kernel`` picks the
    whole path: True, the LSTM kernels on CUDA tensors and ``F.ctc_loss``;
    False, the plain reference path on any device, the plain LSTM
    recurrence and the plain CTC recursion."""
    with torch.no_grad():
        feats, mask, frame_lens = extract_features(wave, num_samples,
                                                   cfg.features)
    log_probs, _, out_lens = acoustic_forward(
        params, feats, mask, frame_lens, cfg, use_kernel=use_kernel,
        train=train, generator=generator)
    terms = ctc_loss_terms_fused if use_kernel else ctc_loss_terms
    num, den = terms(log_probs, out_lens, labels, label_lens)
    return num / torch.clamp(den, min=1.0)


def loss_and_grads(params: dict[str, torch.Tensor], batch_arrays, cfg: Config,
                   generator: torch.Generator | None = None,
                   use_kernel: bool = True):
    """(loss, {name: gradient}) of one training batch; ``use_kernel`` as in
    ``compute_loss``."""
    names = list(params)
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    with torch.enable_grad():
        loss = compute_loss(dict(zip(names, leaves)), *batch_arrays, cfg,
                            train=True, generator=generator,
                            use_kernel=use_kernel)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(names, grads))


def make_train_step(cfg: Config, optimizer: AdamW) -> Callable:
    """step(params, generator, wave, num_samples, labels, label_lens) ->
    loss; updates params and the optimizer state in place."""

    def train_step(params, generator, *batch_arrays):
        loss, grads = loss_and_grads(params, batch_arrays, cfg, generator)
        optimizer.update(params, grads)
        return loss

    return train_step


def make_eval_step(cfg: Config) -> Callable:
    @torch.no_grad()
    def eval_step(params, *batch_arrays):
        return compute_loss(params, *batch_arrays, cfg, train=False)

    return eval_step


def batch_to_device(batch, device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(a).to(device, non_blocking=True) for a in
                 (batch.wave, batch.num_samples, batch.labels,
                  batch.label_lens))


def check_ported(cfg: Config, profile_steps: int = 0) -> None:
    """Refuse the training options that are not ported."""
    t = cfg.train
    check_family(cfg.model.family)
    refused = [
        (cfg.model.family == "transformer" and cfg.transformer.num_experts > 0,
         _MOE),
        (t.mesh_shape != () or t.mesh_axes != ("data",), "device meshes"),
        (t.accum_steps > 1, "--accum_steps > 1"),
        (t.ema_decay > 0.0, "--ema_decay (EMA of the parameters)"),
        (t.keep_ckpts > 0, "--keep_ckpts"),
        (t.save_every_steps > 0, "--save_every_steps"),
        (t.val_metric == "cer", "--val_metric cer"),
        (cfg.augment.enabled, "augmentation (SpecAugment, wave augment)"),
        (bool(t.init_from_torch), "--init_from_torch"),
        (profile_steps > 0, "--profile_steps"),
        (t.cache_audio_mb > 0, "train.cache_audio_mb (built-batch cache)"),
    ]
    for bad, what in refused:
        if bad:
            raise not_ported(what)


def _state(params, optimizer, step, epoch, best_val) -> dict:
    return {"params": params, "opt_state": optimizer.state_dict(),
            "step": step, "epoch": epoch, "best_val_loss": best_val}


def train(corpus_path: str, model_path: str, config: Config | None = None,
          device: str = "cuda", profile_steps: int = 0) -> dict:
    """Train a CTC-family model (BiLSTM, transformer or conformer) on a
    corpus directory (train.tsv, dev.tsv, clips/, alphabet.txt), resuming
    from a checkpoint in model_path if there is one. Returns a summary
    dict with the loss curves."""
    cfg = config or Config()
    check_ported(cfg, profile_steps)
    dev = resolve_device(device)

    # resuming keeps the architecture of the checkpoint's config.json: a
    # resume that omits --model (or names another family) must neither
    # build a wrong model nor overwrite config.json with it
    has_ckpt = any(os.path.exists(os.path.join(model_path, n))
                   for n in (BEST_NAME, LAST_NAME))
    prev_cfg_path = os.path.join(model_path, "config.json")
    if has_ckpt and os.path.exists(prev_cfg_path):
        with open(prev_cfg_path) as fo:
            prev = Config.from_json(fo.read())
        if prev.model.family != cfg.model.family:
            print(f"[train] resuming with model family "
                  f"{prev.model.family!r} from the checkpoint's config.json "
                  f"(requested {cfg.model.family!r} ignored)")
        cfg = cfg.replace(model=prev.model, transformer=prev.transformer,
                          conformer=prev.conformer,
                          transducer=prev.transducer, seq2seq=prev.seq2seq,
                          features=prev.features, text=prev.text)
        check_ported(cfg, profile_steps)
    alphabet = load_tokenizer(corpus_path, cfg.text.units)
    if (cfg.model.vocab_size != alphabet.size
            or cfg.model.input_dim != cfg.features.feature_dim):
        cfg = cfg.replace(model=cfg.model.__class__(**{
            **cfg.model.__dict__, "vocab_size": alphabet.size,
            "input_dim": cfg.features.feature_dim}))

    aud_path = os.path.join(corpus_path, "clips")
    bs = cfg.train.batch_size
    train_manifest = load_manifest(os.path.join(corpus_path, "train.tsv"),
                                   aud_path)
    train_it = BatchIterator(train_manifest, alphabet, bs,
                             sample_rate=cfg.features.sample_rate,
                             seed=cfg.train.seed)
    dev_tsv = os.path.join(corpus_path, "dev.tsv")
    dev_it = None
    if os.path.exists(dev_tsv):
        dev_it = BatchIterator(load_manifest(dev_tsv, aud_path), alphabet, bs,
                               shuffle=False,
                               sample_rate=cfg.features.sample_rate)
    if (cfg.train.lr_schedule == "warmup_cosine"
            and cfg.train.decay_steps <= 0):
        # the cosine horizon from the run's length, as the JAX package
        cfg = cfg.replace(train=cfg.train.__class__(**{
            **cfg.train.__dict__,
            "decay_steps": max(cfg.train.num_epochs * len(train_it),
                               cfg.train.warmup_steps + 1)}))

    params = init_model_params(cfg, torch.Generator().manual_seed(
        cfg.train.seed), dev)
    optimizer = AdamW(cfg, params)
    generator = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    start_epoch, step, best_val = 1, 0, math.inf
    train_losses: list[float] = []
    val_losses: list[float] = []
    if has_ckpt:
        which = "last" if os.path.exists(
            os.path.join(model_path, LAST_NAME)) else "best"
        state = load_checkpoint(checkpoint_path(model_path, which))
        params = cast_params(state["params"],
                             bilstm_ctc.torch_dtype(cfg.model.dtype),
                             dev)
        optimizer.load_state_dict(state["opt_state"], dev)
        step = int(state["step"])
        start_epoch = int(state["epoch"]) + 1
        best_val = float(state["best_val_loss"])
        for name, dst in (("train_loss.npy", train_losses),
                          ("val_losses.npy", val_losses)):
            path = os.path.join(model_path, name)
            if os.path.exists(path):
                dst.extend(np.load(path).tolist())
        print(f"[train] resumed from epoch {state['epoch']} "
              f"(best val {best_val:.4f})")
        # the batch order an uninterrupted run would have
        train_it.skip_epochs(start_epoch - 1)
    # written only after the restore attempt: a failed resume must not
    # leave config.json overwritten with a mismatched run's settings
    save_config(model_path, cfg)

    train_step = make_train_step(cfg, optimizer)
    eval_step = make_eval_step(cfg)
    logger = StepLogger(model_path)
    source = (PrefetchIterator(train_it, depth=cfg.train.prefetch_depth)
              if cfg.train.prefetch_depth > 0 else train_it)
    for epoch in range(start_epoch, cfg.train.num_epochs + 1):
        # the epoch's loss sums on the device: one host read per epoch
        epoch_loss, n_batches = None, 0
        t0 = time.time()
        for batch in source:
            loss = train_step(params, generator, *batch_to_device(batch, dev))
            step += 1
            n_batches += 1
            epoch_loss = loss if epoch_loss is None else epoch_loss + loss
            if step % cfg.train.log_every == 0:
                logger.log(step=step, epoch=epoch, loss=float(loss),
                           utts_per_sec=batch.size * n_batches
                           / (time.time() - t0))
        mean_train = (float(epoch_loss) / max(n_batches, 1)
                      if epoch_loss is not None else 0.0)
        train_losses.append(mean_train)
        np.save(os.path.join(model_path, "train_loss.npy"),
                np.array(train_losses))

        cur_val = None
        if dev_it is not None and epoch % cfg.train.eval_every_epochs == 0:
            tot, n = None, 0
            for batch in dev_it:
                v = eval_step(params, *batch_to_device(batch, dev))
                tot = v if tot is None else tot + v
                n += 1
            cur_val = float(tot) / max(n, 1) if tot is not None else 0.0
            val_losses.append(cur_val)
            np.save(os.path.join(model_path, "val_losses.npy"),
                    np.array(val_losses))
        print(f"[train] epoch {epoch}/{cfg.train.num_epochs} "
              f"train_loss={mean_train:.4f}"
              + (f" val_loss={cur_val:.4f}" if cur_val is not None else "")
              + f" ({time.time() - t0:.1f}s, {n_batches} steps)")

        select = cur_val if cur_val is not None else mean_train
        is_best = select < best_val
        if is_best:
            best_val = select
        state = _state(params, optimizer, step, epoch, best_val)
        save_checkpoint(checkpoint_path(model_path, "last"), state)
        if is_best:
            save_checkpoint(checkpoint_path(model_path, "best"), state)
            print(f"[train] new best checkpoint (val {best_val:.4f})")
    return {"train_losses": train_losses, "val_losses": val_losses,
            "steps": step, "config": cfg, "alphabet": alphabet,
            "params": params,
            "best_path": checkpoint_path(model_path, "best"),
            "last_path": checkpoint_path(model_path, "last")}
