"""GPipe pipeline parallelism for the transformer-CTC family: the ``pipe``
mesh axis (counterpart of pg_asr_tpu/parallel/pipeline.py).

The JAX package stacks the encoder blocks into S stages on a ``pipe`` mesh
axis and runs the whole schedule, forward, loss and backward, as one
differentiated ``shard_map`` program: ``lax.ppermute`` moves a
microbatch's activations from stage s to s+1 each tick, and its transpose
runs the backward pipeline. The port runs one rank process a stage
(parallel/mesh.py), which holds only its stage's blocks
(``GroupRank.shard``; block i on stage i // (L / S)), and writes the same
schedule out, since autograd does not cross a send:

  * fill: the features and the frontend are computed on every stage (the
    masks, lengths and key bias of every microbatch; only stage 0's
    projection reaches the blocks). The rank's rows split into M
    contiguous microbatches; stage 0 injects them in order, every other
    stage receives each from the stage before (``pipe_send`` /
    ``pipe_recv``), runs its blocks on it and keeps its graph, and sends
    the result on. The last stage runs ``ln_final``, the CTC head and the
    CTC (numerator, denominator) of each microbatch.
  * the denominators are summed over ``data x pipe`` (only the last stage
    holds any), so that every rank divides by the global batch's count
    of finite NLLs before the first backward, as the JAX step's ``psum``
    does: the reason for GPipe's fill-then-drain order (a 1F1B order
    would start a backward before the count is known).
  * drain: each microbatch in reverse order, the last stage back-propagates
    its numerator over the global count, every other stage receives the
    gradient of its output from the stage after, back-propagates it
    through its kept graph, and sends its input's gradient to the stage
    before; stage 0 last back-propagates the joined input gradients
    through the frontend. Each stage's block gradients stay on its ranks;
    the gradients of the whole leaves (the frontend on stage 0, the head
    on the last stage, zero elsewhere) are summed over the pipe group by
    ``GroupRank.sum_grads``, as the JAX transpose sums them.

Under ``pipe x model`` each stage runs the model axis's Megatron pairs
(``transformer_ctc._block`` on the model group: ``attn_split`` / ``ffn``,
``copy_to`` / ``reduce_from``, ``qkv`` in ``tensor.to_run``'s layout), the
JAX package's ``_stage_apply(tp > 1)``. As in the JAX package, the stages
run the dense attention (no flash kernel, whatever ``flash_attention``
says), no ``remat`` and no augmentation. Dropout: the frontend's mask
from the step's generator on stage 0; each stage's blocks from a generator
of the stage seeded from it (the ranks of one model group draw the same
masks, as the JAX package never folds the model index).
"""

from __future__ import annotations

import torch

from ..models import transformer_ctc as tc
from ..models.bilstm_ctc import apply_dropout, dropout_bits, torch_dtype
from ..ops.ctc import ctc_loss_terms, ctc_loss_terms_fused
from ..ops.features import extract_features
from ..utils import debug

# a stage's generator: the step's seed plus this times (1 + stage)
_STREAM = 0x9E3779B97F4A7C15


def pad_rows(arrays, multiple: int):
    """Tensors' leading (batch) dim zero-padded to a multiple (zero rows
    carry no labels, which the losses leave out)."""
    rem = -arrays[0].shape[0] % multiple
    if not rem:
        return tuple(arrays)
    return tuple(torch.cat([a, a.new_zeros((rem,) + tuple(a.shape[1:]))])
                 for a in arrays)


def stream_generator(gen: torch.Generator, index: int,
                     device: torch.device) -> torch.Generator:
    """A generator on `device` for stream `index` of a step: seeded from one
    draw of the step's generator `gen` (every rank of a group draws the
    same) and the index."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen,
                             device=gen.device))
    return torch.Generator(device=device).manual_seed(
        (seed + (1 + index) * _STREAM) % 2 ** 63)


def _frames(feats: torch.Tensor, frame_lens: torch.Tensor, subsample: int):
    """The frontend's (out_mask (B, T') bool, out_lens (B,)) without its
    projection (the stages after the first need only these)."""
    out_lens = tc.subsampled_lens(frame_lens, subsample)
    To = -(-feats.shape[1] // subsample)
    mask = torch.arange(To, device=feats.device)[None, :] < out_lens[:, None]
    return mask, out_lens


def _stage(params: dict, x: torch.Tensor, bias: torch.Tensor, cfg, dp,
           blocks: range, generator, train: bool) -> torch.Tensor:
    """This stage's blocks on a microbatch x (mb, T', d): the dense
    attention, each block's two dropout sites drawn before it."""
    tcfg = cfg.transformer
    rate = tcfg.dropout
    for i in blocks:
        bits = [dropout_bits(x, rate, generator, train) for _ in range(2)]
        x = tc._block(params, f"blocks.{i}", x, *bits, key_bias=bias,
                      num_heads=tcfg.num_heads, flash_mask=None,
                      use_kernel=True, rate=rate, ffn_dim=tcfg.ffn_dim,
                      dp=dp)
    return x


def pipeline_loss(params: dict, wave, num_samples, labels, label_lens, cfg,
                  dp, train: bool, generator=None, use_kernel: bool = True,
                  grad: bool = False):
    """The GPipe schedule of one batch on this rank (see the module's
    docstring): (the global batch's loss, {name: gradient} of the leaves
    this rank holds, or None without `grad`). `params` are the leaves as
    the rank holds them (its stage's blocks, their model parts);
    ``use_kernel`` picks ``F.ctc_loss`` (True) or the plain recursion."""
    tcfg = cfg.transformer
    S, s, M = dp.pipe_size, dp.pipe_index, dp.microbatches
    last = s == S - 1
    wave, num_samples, labels, label_lens = pad_rows(
        (wave, num_samples, labels, label_lens), M)
    mb = wave.shape[0] // M
    k = tcfg.num_layers // S
    blocks = range(s * k, (s + 1) * k)
    ctc_terms = ctc_loss_terms_fused if use_kernel else ctc_loss_terms
    leaves = {n: v.detach().requires_grad_(grad) for n, v in params.items()}
    rate = tcfg.dropout if train else 0.0
    stage_gen = (stream_generator(generator, s, wave.device)
                 if train and rate > 0.0 else None)
    with torch.no_grad():
        feats, mask, frame_lens = extract_features(wave, num_samples,
                                                   cfg.features)
    x = None
    with torch.set_grad_enabled(grad):
        if s == 0:
            x, out_mask, out_lens = tc.frontend(leaves, feats, mask,
                                                frame_lens, cfg.model, tcfg)
            x = apply_dropout(x, rate, dropout_bits(x, rate, generator,
                                                    train))
        else:
            out_mask, out_lens = _frames(feats, frame_lens, tcfg.subsample)
    bias = tc.padding_bias(out_mask)
    shape = (mb, out_mask.shape[1], tcfg.d_model)
    dtype = torch_dtype(cfg.model.dtype)

    kept, sends, nums, dens = [], [], [], []
    for i in range(M):  # fill
        rows = slice(i * mb, (i + 1) * mb)
        x_in = (x[rows].detach() if s == 0
                else dp.pipe_recv(shape, dtype, s - 1, tag=i))
        x_in.requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            y = _stage(leaves, x_in, bias[rows], cfg, dp, blocks, stage_gen,
                       train)
            if last:
                log_probs, _ = tc.ctc_head(
                    leaves, tc._layer_norm(leaves, "ln_final", y),
                    out_mask[rows])
                num, den = ctc_terms(log_probs, out_lens[rows],
                                     labels[rows], label_lens[rows])
                nums.append(num)
                dens.append(den.detach())
        if not last:
            sends.append(dp.pipe_send(y, s + 1, tag=i))
        kept.append((x_in, y))
    den = (torch.stack(dens).sum(0) if last
           else torch.zeros((), device=wave.device))
    den = torch.clamp(dp.group_sum(den, ("data", "pipe")), min=1.0)
    loss = (torch.stack(nums).sum(0).detach() / den if last
            else torch.zeros((), device=wave.device)).sum()
    grads = None
    if grad:
        dx = [None] * M
        for i in reversed(range(M)):  # drain
            x_in, y = kept[i]
            if last:
                torch.autograd.backward((nums[i] / den).sum())
            else:
                torch.autograd.backward(y, dp.pipe_recv(
                    tuple(y.shape), y.dtype, s + 1, tag=M + i))
            if s == 0:
                dx[i] = x_in.grad
            else:
                sends.append(dp.pipe_send(x_in.grad, s - 1, tag=M + i))
            kept[i] = None
        if s == 0:
            torch.autograd.backward(x, torch.cat(dx))
        grads = {n: torch.zeros_like(v) if v.grad is None else v.grad
                 for n, v in leaves.items()}
    dp.wait_all(sends)
    return dp.group_sum(loss, ("data", "pipe")), grads


def make_train_step(cfg, optimizer, dp):
    """train.make_train_step's contract under ``pipe``: step(params,
    generator, wave, num_samples, labels, label_lens) -> the global loss,
    params and the optimizer state updated in place."""

    def train_step(params, generator, *batch_arrays):
        gen = dp.step_generator(generator)
        loss, grads = pipeline_loss(params, *batch_arrays, cfg, dp,
                                    train=True, generator=gen, grad=True)
        debug.check_nans(loss, "the loss")
        debug.check_nans(grads, "the gradients")
        optimizer.update(params, dp.sum_grads(grads))
        return loss

    return train_step


def make_eval_step(cfg, dp):
    """train.make_eval_step's contract under ``pipe``: the global batch's
    loss without dropout, through the same schedule."""

    @torch.no_grad()
    def eval_step(params, *batch_arrays):
        loss, _ = pipeline_loss(params, *batch_arrays, cfg, dp, train=False)
        debug.check_nans(loss, "the dev loss")
        return loss

    return eval_step
