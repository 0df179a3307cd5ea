"""Supervised CTC training driver on one device (counterpart of
pg_asr_tpu/train.py).

Epoch loop with per-epoch validation on dev.tsv, best/last checkpoints
selected on validation loss, train_loss.npy / val_losses.npy, and resume
from model_last (with the model family and its config from the
checkpoint's config.json). One step: features (no gradient) -> the
family's model with dropout (BiLSTM-CTC: the LSTM kernels under autograd;
transformer-CTC and conformer-CTC: with ``flash_attention`` the
flash-attention kernels under autograd, with ``model.remat`` each block
recomputed in the backward; the transducer: one of those encoders, the
prediction network, and with ``transducer.fused_joint`` the fused joint
kernels under autograd) -> CTC or the transducer's lattice loss ->
gradients -> clip by global norm -> AdamW, with optax's rules and rounding
points (``AdamW`` below). Parameters stay in the model's dtype, as the JAX
package creates them (LayerNorm params in float32); there is no master
copy.

Also here for policy-gradient fine-tuning (rl/reinforce.py): ``AdamW``'s
constant-rate form and the greedy dev CER (``corpus_cer``).

Not ported (each refused with a message, ROADMAP.md): the seq2seq family,
the switch-MoE transformer, device meshes and multi-host, gradient
accumulation, EMA, keep_ckpts, save_every_steps, val_metric=cer,
augmentation, init_from_torch, profiling, BPE units, the built-batch
cache.
"""

from __future__ import annotations

import functools
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
                     check_family, conformer_ctc, transducer,
                     transformer_ctc)
from .ops.ctc import ctc_loss_terms, ctc_loss_terms_fused
from .ops.features import extract_features
from .ops.transducer import transducer_loss_terms
from .utils.logging import StepLogger

_MOE = ("the switch-MoE transformer (transformer.num_experts > 0, --model "
        "moe; ROADMAP.md queue 1 item 15)")


def init_model_params(cfg: Config, generator: torch.Generator,
                      device: torch.device | str) -> dict[str, torch.Tensor]:
    """Family dispatch (the JAX package's ``init_model_params``): the
    initial parameters of the configured family, drawn on the CPU from
    `generator`, then moved and cast."""
    family = cfg.model.family
    check_family(family)
    if family == "transducer":
        return transducer.init_params(cfg, generator, device)
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


def tree_order(name: str) -> list:
    """Sort key of a flat parameter name in the order ``jax.tree.leaves``
    walks the JAX package's tree: dict keys sorted, list items by index."""
    return [(0, int(s), "") if s.isdigit() else (1, 0, s)
            for s in name.split(".")]


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: per leaf the sum of its squares (each square
    rounded to the leaf's dtype, summed in float32 as ``jnp.sum`` does,
    rounded back), those sums added in tree order in the promoted dtype
    (bfloat16 until a float32 leaf joins), then the root in that dtype."""
    total = None
    for k in sorted(grads, key=tree_order):
        g = grads[k]
        s = (g * g).float().sum().to(g.dtype)
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
    decision stays on the device (no host synchronisation)."""

    b1, b2, eps, eps_root = 0.9, 0.999, 1e-8, 0.0

    def __init__(self, cfg: Config, params: dict[str, torch.Tensor],
                 learning_rate: float | None = None,
                 weight_decay: float | None = None):
        """The rate follows ``make_schedule(cfg)`` and the decay
        ``cfg.train.weight_decay``, unless given: a given `learning_rate` is
        constant, a Python float rounded to each update's dtype where it is
        applied, as optax applies a float rate (policy-gradient fine-tuning's
        ``optax.adamw(lr * 0.1)``, whose decay is optax's default 1e-4)."""
        if cfg.train.accum_steps > 1:
            raise not_ported("--accum_steps > 1 (optax.MultiSteps)")
        self.max_norm = cfg.train.grad_clip
        self.weight_decay = (cfg.train.weight_decay if weight_decay is None
                             else weight_decay)
        self.schedule = (make_schedule(cfg) if learning_rate is None
                         else lambda count: learning_rate)
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
        g_norm = global_norm(grads)
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


def compute_loss(params, wave, num_samples, labels, label_lens, cfg: Config,
                 train: bool, generator: torch.Generator | None = None,
                 use_kernel: bool = True) -> torch.Tensor:
    """Scalar loss of one batch (the JAX package's ``compute_loss``): CTC
    for the CTC families; for the transducer the lattice loss, plus
    ``ctc_weight`` x the auxiliary head's CTC loss when that is above 0.
    Features carry no gradient. ``use_kernel`` picks the whole path: True,
    the kernels on CUDA tensors and ``F.ctc_loss``; False, the plain
    reference path on any device, the plain recurrences, joint and CTC
    recursion."""
    with torch.no_grad():
        feats, mask, frame_lens = extract_features(wave, num_samples,
                                                   cfg.features)
    ctc_terms = ctc_loss_terms_fused if use_kernel else ctc_loss_terms
    if cfg.model.family == "transducer":
        lam = cfg.transducer.ctc_weight
        out = transducer.apply_lattice(
            params, feats, mask, frame_lens, labels, label_lens, cfg,
            use_kernel=use_kernel, train=train, generator=generator,
            with_ctc=lam > 0.0)
        num, den = transducer_loss_terms(out[0], out[1], out[2], label_lens)
        loss = num / torch.clamp(den, min=1.0)
        if lam > 0.0:  # hybrid: L = L_rnnt + lam * L_ctc
            num_c, den_c = ctc_terms(out[3], out[2], labels, label_lens)
            loss = loss + lam * num_c / torch.clamp(den_c, min=1.0)
        return loss
    log_probs, _, out_lens = acoustic_forward(
        params, feats, mask, frame_lens, cfg, use_kernel=use_kernel,
        train=train, generator=generator)
    num, den = ctc_terms(log_probs, out_lens, labels, label_lens)
    return num / torch.clamp(den, min=1.0)


def value_and_grad(fn: Callable, params: dict[str, torch.Tensor]):
    """(fn(params), {name: d loss / d param}) for fn returning a scalar loss
    or (loss, aux); a parameter the loss does not reach gets a zero
    gradient, as in JAX."""
    names = list(params)
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    with torch.enable_grad():
        out = fn(dict(zip(names, leaves)))
        loss = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for k, p, g in zip(names, leaves, grads)}
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


@torch.no_grad()
def _batch_cer_counts(params, batch, cfg: Config,
                      alphabet) -> tuple[int, int]:
    """Greedy-decode one batch on the params' device and return the additive
    corpus-CER counts (edit-distance sum, reference-length sum), from the
    host ``metrics.edit_dist`` (the JAX package's counterpart)."""
    from .decoding.greedy import greedy_decode, ids_to_strings
    from .metrics import edit_dist
    from .predict import forward, forward_transducer

    dev = next(iter(params.values())).device
    wave = torch.from_numpy(batch.wave).to(dev)
    ns = torch.from_numpy(batch.num_samples).to(dev)
    if cfg.model.family == "transducer":
        labels, lens = forward_transducer(params, wave, ns, cfg)
    else:
        log_probs, mask, _ = forward(params, wave, ns, cfg)
        labels, lens = greedy_decode(log_probs, mask)
    d_sum = l_sum = 0
    for ref, hyp in zip(batch.texts, ids_to_strings(labels, lens, alphabet)):
        d, n = edit_dist(ref, hyp)
        d_sum += d
        l_sum += n
    return d_sum, l_sum


def corpus_cer(params, rows, alphabet, cfg: Config, batch_size: int) -> float:
    """Greedy corpus CER (total edits / total reference characters) over a
    manifest's rows, on one host: the JAX package's ``sharded_corpus_cer``
    with one shard. ``--val_metric cer`` stays refused (``check_ported``);
    policy-gradient fine-tuning selects its best checkpoint with this."""
    it = BatchIterator(rows, alphabet, batch_size, shuffle=False,
                       sample_rate=cfg.features.sample_rate)
    d_sum = l_sum = 0
    for batch in it:
        d, n = _batch_cer_counts(params, batch, cfg, alphabet)
        d_sum += d
        l_sum += n
    return d_sum / max(l_sum, 1)


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
    """Train a model (BiLSTM-CTC, transformer-CTC, conformer-CTC or the
    transducer) on a corpus directory (train.tsv, dev.tsv, clips/,
    alphabet.txt), resuming
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
