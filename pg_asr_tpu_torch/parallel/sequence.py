"""Sequence parallelism for the transformer-CTC family: the ``seq`` mesh
axis (counterpart of pg_asr_tpu/parallel/sequence.py).

The encoder's time axis is split over the ranks of a seq group, which hold
the same rows and every parameter whole: each rank carries a (B, T'/S, d)
slice of the activations through the blocks.

  * The frontend runs on every rank with T' zero-padded up to a multiple
    of S (``transformer_ctc.frontend(pad_to_multiple=S)``), its dropout
    mask drawn from the step's generator, the same on every rank; each
    rank then takes its T'/S frames.
  * Each block's queries attend to the keys and values of every frame:
    this rank's k and v are all-gathered over the seq group (``gather``),
    the scores are (B, h, T'/S, T'). LayerNorms and FFNs are local; their
    dropout masks come from a generator of the rank's frames.
  * The final states are gathered, and the head and the CTC loss run once,
    on the group's first rank; the CTC denominators are summed over
    ``data x seq``.

``gather``'s backward is a reduce-scatter: the gradients of the gathered
tensor are summed over the group and each rank keeps its slice, the
transpose of the JAX package's ``all_gather``. Each rank's queries read
every rank's keys, so every rank holds a part of each key's gradient (and
only the first rank holds any of the final states'); taking a rank's own
slice of its own gradient, as ``parallel/tensor.gather_to`` does for a
tensor every rank uses alike, would lose the others' parts. The ranks that
run no head back-propagate zeros through the final gather, so that every
rank takes part in each reduce-scatter. Each parameter's gradient is then
this rank's part of the sum, which ``GroupRank.sum_grads`` completes over
the seq group. The attention is the dense one, as the JAX package's
``_mhsa_seq``: no flash kernel, whatever ``flash_attention`` says; no
``remat`` and no augmentation, as there.
"""

from __future__ import annotations

import torch

from ..models import transformer_ctc as tc
from ..models.bilstm_ctc import apply_dropout, dropout_bits
from ..ops.ctc import ctc_loss_terms, ctc_loss_terms_fused
from ..ops.features import extract_features
from ..utils import debug
from .pipeline import stream_generator


class _Gather(torch.autograd.Function):
    """The seq group's slices of `x` joined along `dim`; backward, the
    gradient summed over the group and this rank's slice kept (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dp, dim):
        ctx.dp, ctx.dim = dp, dim
        return dp.seq_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.dp.seq_reduce_scatter(g, ctx.dim), None, None


def gather(x: torch.Tensor, dp, dim: int) -> torch.Tensor:
    """The seq group's slices of `x` joined along `dim`, differentiable
    (the backward a reduce-scatter)."""
    return _Gather.apply(x, dp, dim % x.dim())


def _mhsa_seq(params: dict, pre: str, x: torch.Tensor, key_bias, num_heads,
              dp) -> torch.Tensor:
    """Block `pre`'s attention of this rank's queries x (B, T'/S, d) over
    the gathered keys and values of all T' frames; key_bias (B, 1, 1, T')
    float32 over every frame."""
    scale = 1.0 / (x.shape[-1] // num_heads) ** 0.5
    q, k, v = tc._qkv(params, pre, x, num_heads)
    k, v = gather(k, dp, 2), gather(v, dp, 2)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = torch.softmax(scores * scale + key_bias, dim=-1).to(x.dtype)
    return tc._attn_out(params, pre, torch.matmul(attn, v))


def sequence_loss(params: dict, wave, num_samples, labels, label_lens, cfg,
                  dp, train: bool, generator=None, use_kernel: bool = True,
                  grad: bool = False):
    """One batch on this rank of the seq group (see the module's
    docstring): (the global batch's loss, {name: this rank's part of the
    gradient}, or None without `grad`)."""
    tcfg = cfg.transformer
    S, s = dp.seq_size, dp.seq_index
    rate = tcfg.dropout if train else 0.0
    ctc_terms = ctc_loss_terms_fused if use_kernel else ctc_loss_terms
    leaves = {n: v.detach().requires_grad_(grad) for n, v in params.items()}
    blk_gen = (stream_generator(generator, s, wave.device)
               if train and rate > 0.0 else None)
    with torch.no_grad():
        feats, mask, frame_lens = extract_features(wave, num_samples,
                                                   cfg.features)
    with torch.set_grad_enabled(grad):
        x, out_mask, out_lens = tc.frontend(leaves, feats, mask, frame_lens,
                                            cfg.model, tcfg,
                                            pad_to_multiple=S)
        x = apply_dropout(x, rate, dropout_bits(x, rate, generator, train))
        t_loc = x.shape[1] // S
        x = x[:, s * t_loc:(s + 1) * t_loc]
        bias = tc.padding_bias(out_mask)
        for i in range(tcfg.num_layers):
            pre = f"blocks.{i}"
            h = _mhsa_seq(leaves, pre, tc._layer_norm(leaves, f"{pre}.ln1",
                                                      x),
                          bias, tcfg.num_heads, dp)
            x = x + apply_dropout(h, rate, dropout_bits(h, rate, blk_gen,
                                                        train))
            h = tc.ffn(leaves, pre, "ffn", tc._layer_norm(
                leaves, f"{pre}.ln2", x), tc._gelu, tcfg.ffn_dim)
            x = x + apply_dropout(h, rate, dropout_bits(h, rate, blk_gen,
                                                        train))
        x = gather(x, dp, 1)
        if s == 0:
            log_probs, _ = tc.ctc_head(
                leaves, tc._layer_norm(leaves, "ln_final", x), out_mask)
            num, den = ctc_terms(log_probs, out_lens, labels, label_lens)
        else:
            num = den = torch.zeros((), device=wave.device)
    den = torch.clamp(dp.group_sum(den.detach(), ("data", "seq")), min=1.0)
    loss = (num / den).sum()
    grads = None
    if grad:
        if s == 0:
            torch.autograd.backward(loss)
        else:  # every rank takes part in the reduce-scatters
            torch.autograd.backward(x, torch.zeros_like(x))
        grads = {n: torch.zeros_like(v) if v.grad is None else v.grad
                 for n, v in leaves.items()}
    return dp.group_sum(loss.detach(), ("data", "seq")), grads


def make_train_step(cfg, optimizer, dp):
    """train.make_train_step's contract under ``seq``."""

    def train_step(params, generator, *batch_arrays):
        gen = dp.step_generator(generator)
        loss, grads = sequence_loss(params, *batch_arrays, cfg, dp,
                                    train=True, generator=gen, grad=True)
        debug.check_nans(loss, "the loss")
        debug.check_nans(grads, "the gradients")
        optimizer.update(params, dp.sum_grads(grads))
        return loss

    return train_step


def make_eval_step(cfg, dp):
    """train.make_eval_step's contract under ``seq``."""

    @torch.no_grad()
    def eval_step(params, *batch_arrays):
        loss, _ = sequence_loss(params, *batch_arrays, cfg, dp, train=False)
        debug.check_nans(loss, "the dev loss")
        return loss

    return eval_step
