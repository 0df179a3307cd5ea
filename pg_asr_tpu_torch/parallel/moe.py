"""The switch-MoE transformer encoder on one device (counterpart of
pg_asr_tpu/parallel/moe.py).

Each block of the transformer-CTC (models/transformer_ctc.py) keeps its
attention and replaces its dense FFN by E experts with top-1 switch
routing (Fedus et al. 2021):

  * router: (N, d) x (d, E) in the compute type, softmax in float32. A
    token's expert is the argmax (the first on ties, as ``jnp.argmax``),
    its gate the max probability (``torch.amax``: a tie splits the
    gradient evenly, as ``jnp.max``'s does; one expert has gate 1).
  * slots: each expert has C slots, and a token claims the next free slot
    of its expert in the flattened (B, T') row-major token order (an
    exclusive cumsum of the assignments). Padded frames neither route nor
    count. A token past its expert's C slots is dropped: its FFN output
    is exactly 0, so only its residual passes.
  * experts: the kept tokens are copied by index into an (E, C, d) buffer
    (empty slots 0), the experts run as two batched products with b1 / b2
    added to every slot and gelu (tanh form) between, and each used slot's
    output is copied back to its token (the others' 0), times the gate,
    in float32.
  * load balance: aux = E * sum_e(frac_e * mean_p_e) over the valid
    tokens, averaged over the blocks; ``moe_loss_terms`` returns it beside
    the CTC loss as a stacked num/den component.

The JAX package dispatches and combines through a one-hot (N, E, C) tensor
and einsums. Each row of those einsums is one product plus exact zeros, so
the index form here gives the same values bit for bit in float32, forward
and gradients (for finite inputs), without that tensor: at B=64 x 5 s it
would hold N = 12,864 tokens x 4 experts x C = 4,020 slots, 827 MB a block
in float32. The one-hot form is kept only in the tests, as the oracle of
that equality.

C = ceil(N / E * capacity_factor) with N = B x ceil(T / subsample) of the
PADDED batch (``moe_capacity``), so an utterance's output depends on its
batch's size and padding, as in the JAX package.

Over the ranks that hold distinct rows (``--mesh data=N``, or ``data x
fsdp``; ``dp``, parallel/mesh.py) each rank routes its own rows, but as
one device would route the ranks' batches concatenated, which is what the
JAX package's step does (it runs the MoE outside
``shard_map``, so that the slot cumsum sees the global token order): N is
the padded tokens of every rank, a token's slot counts its expert's
tokens on the ranks before this one (an all-reduce of each rank's
per-expert counts a block), and the aux takes the global counts and valid
tokens, each rank adding its share, E / Nv^2 x sum_e(count_e x sum_p_e).
With equal padded lengths on every rank the result is the one device's on
the concatenated batch (float32 up to summation order).

As the JAX package's ``moe_encode``, the encoder always takes the dense
attention and no recomputation: ``flash_attention`` and ``model.remat``
do not apply to it. No hand-written kernel runs here; the expert products
are ``torch.bmm`` (the JAX package's einsums run outside any Pallas kernel
too).

Parameters are the transformer-CTC's flat dict with each block's FFN
linears replaced: ``blocks.{i}.router.{w,b}`` (d, E) and (E,);
``blocks.{i}.w1`` (E, d, ffn), ``b1`` (E, ffn), ``w2`` (E, ffn, d), ``b2``
(E, d).

Under ``--mesh expert=X`` (``moe_param_specs``, ``shard_moe_params``: the
JAX package's placement) rank x of an expert group holds experts [x E/X,
(x+1) E/X) of every block's ``w1``, ``b1``, ``w2``, ``b2``, with their
AdamW moments, accumulator and EMA; the router and the dense leaves are
whole on every rank. The ranks of an expert group hold the same rows (the
batch splits over ``data`` only, as in the JAX package), so each routes
all of them exactly as one device would, fills and runs only its own
experts' slots, (E/X, C, d), and the partial combined outputs are summed
over the group before the gate multiplies them: with top-1 routing every
token has one nonzero term, so the sum is exact. Two autograd functions
carry it, parallel/tensor.py's Megatron pair over the expert group: the
combine (``reduce_from``: an all-reduce forward, the identity backward)
and the dispatch's input (``copy_to``: the identity forward, an
all-reduce of its gradient backward). The stacks' gradients are then
summed over the data group only; the dense ones over the data group too,
and averaged over the expert group, whose ranks each computed them whole
(parallel/mesh.py ``sum_grads``: on the card their copies differ in the
last bits, and the ranks of a group must keep equal weights to route
alike).

Under ``--mesh model=T,expert=X`` (the JAX package's ``moe_param_specs``
with a live model axis) each rank also holds its f/T columns of its
experts' ``w1`` and ``b1`` and rows of ``w2``: the experts' partial
products are summed over the model group before ``b2``, the combined
outputs over the expert group, and the dispatch's input gradient over
both. The router stays whole: its argmax must see all E logits. On
``model`` alone the stacks stay whole, as the JAX rules leave them, and
the router is split over its E columns and gathered for the forward.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import Config
from ..models import cast_params
from ..models.bilstm_ctc import (apply_dropout, dropout_bits, init_linear,
                                 linear, torch_dtype)
from ..models.transformer_ctc import (_init_ln, _layer_norm, _mhsa,
                                      ctc_head, frontend, num_blocks,
                                      padding_bias)
from ..ops.ctc import ctc_loss_terms, ctc_loss_terms_fused
from ..ops.features import extract_features
from . import tensor
from .mesh import ONE_DEVICE, DataParallel, shard_leaf

_DENSE_FFN = ("ffn_in.w", "ffn_in.b", "ffn_out.w", "ffn_out.b")
# each block's expert stacks, split on their leading (expert) dimension
_EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def init_moe_params(cfg: Config, num_experts: int,
                    generator: torch.Generator,
                    device: torch.device | str = "cpu") -> dict:
    """Transformer encoder params with a switch FFN per block: router (d, E)
    and expert stacks (E, d, ffn) / (E, ffn, d) ~ N(0, 2 / (d + ffn)),
    biases 0.1, as the JAX init; drawn on the CPU from `generator`, then
    moved and cast (LayerNorm params stay float32)."""
    mcfg, tcfg = cfg.model, cfg.transformer
    d, f = tcfg.d_model, tcfg.ffn_dim
    std = (2.0 / (d + f)) ** 0.5
    p: dict[str, torch.Tensor] = {}
    init_linear(p, "input_proj", tcfg.subsample * mcfg.input_dim, d,
                generator)
    for i in range(tcfg.num_layers):
        pre = f"blocks.{i}"
        _init_ln(p, f"{pre}.ln1", d)
        init_linear(p, f"{pre}.qkv", d, 3 * d, generator)
        init_linear(p, f"{pre}.attn_out", d, d, generator)
        _init_ln(p, f"{pre}.ln2", d)
        init_linear(p, f"{pre}.router", d, num_experts, generator)
        p[f"{pre}.w1"] = torch.randn(num_experts, d, f,
                                     generator=generator) * std
        p[f"{pre}.b1"] = torch.full((num_experts, f), 0.1)
        p[f"{pre}.w2"] = torch.randn(num_experts, f, d,
                                     generator=generator) * std
        p[f"{pre}.b2"] = torch.full((num_experts, d), 0.1)
    _init_ln(p, "ln_final", d)
    init_linear(p, "ctc_head", d, mcfg.vocab_size, generator)
    return cast_params(p, torch_dtype(mcfg.dtype), device)


def moe_params_from_dense(params: dict, num_experts: int,
                          generator: torch.Generator) -> dict:
    """A dense transformer's FFN weights tiled into every expert, with a
    new router per block from `generator` (the test anchor: with one expert
    and ample capacity this is the dense model exactly)."""
    out = {k: v for k, v in params.items()
           if not k.endswith(_DENSE_FFN)}
    for i in range(num_blocks(params)):
        pre = f"blocks.{i}"
        w_in = params[f"{pre}.ffn_in.w"]
        router: dict[str, torch.Tensor] = {}
        init_linear(router, "r", w_in.shape[0], num_experts, generator)
        out[f"{pre}.router.w"] = router["r.w"].to(w_in)
        out[f"{pre}.router.b"] = router["r.b"].to(w_in)
        for new, old in (("w1", "ffn_in.w"), ("b1", "ffn_in.b"),
                         ("w2", "ffn_out.w"), ("b2", "ffn_out.b")):
            v = params[f"{pre}.{old}"]
            out[f"{pre}.{new}"] = v.expand(num_experts, *v.shape).clone()
    return out


class Routing(NamedTuple):
    """One block's routing of N = B x T' tokens."""
    probs: torch.Tensor   # (N, E) float32 router probabilities
    expert: torch.Tensor  # (N,) int64, the argmax
    gate: torch.Tensor    # (N,) float32, the max probability
    assign: torch.Tensor  # (N, E) int64 one-hot of the valid tokens
    pos: torch.Tensor     # (N,) int64, the slot within the expert
    kept: torch.Tensor    # (N,) bool: valid and pos < capacity


def route(params: dict, pre: str, x: torch.Tensor, token_valid: torch.Tensor,
          capacity: int) -> Routing:
    """Top-1 routing of block `pre` for x (B, T, d), token_valid (B, T)."""
    B, T, d = x.shape
    logits = linear(params, f"{pre}.router", x.reshape(B * T, d)).float()
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = torch.amax(probs, dim=-1)
    valid = token_valid.reshape(B * T)
    assign = F.one_hot(expert, probs.shape[1]) * valid[:, None]
    # the slot: the expert's earlier valid tokens, an exclusive cumsum
    # along the contiguous token axis of the (E, N) assignments (on CUDA
    # PyTorch's scan over the outer axis of (N, E) runs a thread a column,
    # far slower: chip_smoke.py phase 17 times both)
    at = assign.t().contiguous()
    pos = ((torch.cumsum(at, dim=1) - at) * at).sum(dim=0)
    return Routing(probs, expert, gate, assign, pos,
                   valid & (pos < capacity))


def _moe_ffn(params: dict, pre: str, x: torch.Tensor,
             token_valid: torch.Tensor, capacity: int,
             dp: DataParallel = ONE_DEVICE, ffn_dim: int = 0):
    """Switch-routed FFN of block `pre`. x: (B, T, d) in the compute type,
    token_valid: (B, T) bool. Returns (out (B, T, d), aux float32: this
    rank's share of the aux over the ranks of ``dp``). The expert stacks
    may hold this rank's experts of an expert axis only (``dp``'s) and,
    under ``model x expert``, this rank's columns of their `ffn_dim`."""
    B, T, d = x.shape
    N = B * T
    r = route(params, pre, x, token_valid, capacity)
    # the slots continue those of the ranks before this one
    before, _ = dp.exclusive_offsets(r.assign.sum(dim=0))
    pos = r.pos + before[r.expert]
    r = r._replace(pos=pos, kept=token_valid.reshape(N) & (pos < capacity))
    E, C = r.probs.shape[1], capacity
    # this rank's experts [lo, lo + El): all of them on one device
    El = params[f"{pre}.w1"].shape[0]
    if El * dp.expert_size != E:
        raise ValueError(f"{pre}: the expert stacks hold {El} of {E} "
                         f"experts on an expert axis of {dp.expert_size}")
    lo = dp.expert_index * El
    mine = r.kept if El == E else r.kept & (r.expert >= lo) & (
        r.expert < lo + El)
    # each of its tokens' flat slot (e - lo) * C + pos (the others: a spare
    # slot El * C, cut off) and each slot's token (an empty slot: a spare
    # token N). Both directions are copies by index, whose gradients are
    # gathers: no two rows add into one, so nothing accumulates atomically
    slot = torch.where(mine, (r.expert - lo) * C + r.pos, El * C)
    token = torch.full((El * C + 1,), N, dtype=slot.dtype,
                       device=slot.device).index_copy(
        0, slot, torch.arange(N, device=slot.device))[:El * C]
    # the dispatch's input, whose gradient each rank forms from its own
    # experts' slots and its own ffn columns only, summed over the ranks
    # that hold the other experts and columns (the JAX package forms xin
    # in float32 and casts it back: the same values, since every row is a
    # copy of a row of x)
    cols = tensor.split(dp, params[f"{pre}.w2"].shape[1], ffn_dim)
    over = "+".join(a for a, on in (("model", cols), ("expert", El != E))
                    if on)
    xd = tensor.copy_to(x, dp, over) if over else x
    xin = x.new_zeros(El * C + 1, d).index_copy(
        0, slot, xd.reshape(N, d))[:El * C].reshape(El, C, d)
    h = F.gelu(torch.bmm(xin, params[f"{pre}.w1"])
               + params[f"{pre}.b1"][:, None, :], approximate="tanh")
    y = torch.bmm(h, params[f"{pre}.w2"])
    if cols:  # the ffn columns' partial products, before the bias
        y = tensor.reduce_from(y, dp, "model")
    y = y + params[f"{pre}.b2"][:, None, :]
    out = x.new_zeros(N + 1, d, dtype=torch.float32).index_copy(
        0, token, y.reshape(El * C, d).float())[:N]
    if El != E:  # every token's one output, from the rank of its expert
        out = tensor.reduce_from(out, dp, "expert")
    out = (out * r.gate[:, None]).to(x.dtype)

    # the load-balance loss over the valid tokens (uniform routing: 1.0)
    tv = token_valid.reshape(B * T).float()
    # the global counts; this rank's probabilities
    counts = dp.all_sum(r.assign.float().sum(dim=0))
    n_valid = torch.clamp(dp.all_sum(tv.sum()), min=1.0)
    frac = counts / n_valid
    mean_p = (r.probs * tv[:, None]).sum(dim=0) / n_valid
    aux = E * torch.sum(frac * mean_p)
    return out.reshape(B, T, d), aux


def moe_encode(params: dict, feats: torch.Tensor, frame_mask: torch.Tensor,
               frame_lens: torch.Tensor, cfg: Config, capacity: int,
               train: bool = False, generator: torch.Generator | None = None,
               dp: DataParallel = ONE_DEVICE):
    """The MoE encoder: transformer_ctc's frontend and dropout sites (1 +
    2L, their bits drawn from `generator` in the dense encoder's order),
    the dense attention, the switch FFN (routed over the ranks of ``dp``).
    Returns (x (B, T', d), out_mask (B, T') bool, out_lens (B,), the
    blocks' mean aux)."""
    tcfg = cfg.transformer
    x, out_mask, out_lens = frontend(params, feats, frame_mask, frame_lens,
                                     cfg.model, tcfg)
    rate = tcfg.dropout
    x = apply_dropout(x, rate, dropout_bits(x, rate, generator, train))
    bias = padding_bias(out_mask)
    n = num_blocks(params)
    aux_total = None
    for i in range(n):
        pre = f"blocks.{i}"
        bits = [dropout_bits(x, rate, generator, train) for _ in range(2)]
        h = _mhsa(params, pre, _layer_norm(params, f"{pre}.ln1", x), bias,
                  tcfg.num_heads, dp=dp)
        x = x + apply_dropout(h, rate, bits[0])
        h, aux = _moe_ffn(params, pre, _layer_norm(params, f"{pre}.ln2", x),
                          out_mask, capacity, dp, tcfg.ffn_dim)
        x = x + apply_dropout(h, rate, bits[1])
        aux_total = aux if aux_total is None else aux_total + aux
    return (_layer_norm(params, "ln_final", x), out_mask, out_lens,
            aux_total / n)


def moe_capacity(cfg: Config, batch: int, frames: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Slots per expert for a padded batch of `frames` feature frames."""
    n = batch * (-(-frames // cfg.transformer.subsample))
    return _slots(n, num_experts, capacity_factor)


def _slots(tokens: int, num_experts: int, capacity_factor: float) -> int:
    return max(int(math.ceil(tokens / num_experts * capacity_factor)), 1)


def _capacity(cfg: Config, feats: torch.Tensor, dp: DataParallel) -> int:
    """The capacity of every rank's padded tokens together."""
    tcfg = cfg.transformer
    B, T = feats.shape[:2]
    (tokens,) = dp.sum_counts(B * -(-T // tcfg.subsample))
    return _slots(tokens, tcfg.num_experts, tcfg.capacity_factor)


def moe_apply(params: dict, feats: torch.Tensor, frame_mask: torch.Tensor,
              frame_lens: torch.Tensor, cfg: Config, train: bool = False,
              generator: torch.Generator | None = None,
              dp: DataParallel = ONE_DEVICE):
    """(B, T, F) features -> ((B, T', A) CTC log-probs, out_mask (B, T')
    float32, out_lens (B,)): the CTC families' forward contract, so every
    decoder, the metrics and policy-gradient fine-tuning take the MoE
    family unchanged. No aux term."""
    x, out_mask, out_lens, _ = moe_encode(
        params, feats, frame_mask, frame_lens, cfg,
        _capacity(cfg, feats, dp), train=train, generator=generator, dp=dp)
    log_probs, omask_f = ctc_head(params, x, out_mask)
    return log_probs, omask_f, out_lens


def moe_loss_terms(params: dict, feats, mask, frame_lens, labels,
                   label_lens, cfg: Config, train: bool = False,
                   generator: torch.Generator | None = None,
                   use_kernel: bool = True, dp: DataParallel = ONE_DEVICE):
    """Stacked (num, den) components [ctc, aux]: sum(num / max(den, 1)) =
    ctc_mean + moe_aux_weight * aux_mean, the aux component weighted by the
    valid tokens. Takes features (after SpecAugment). ``use_kernel``:
    ``F.ctc_loss`` or the plain CTC recursion, as train.compute_loss.
    Over the ranks of ``dp`` the aux component's numerator is this rank's
    share of the global aux times the global valid tokens and its
    denominator this rank's valid tokens, so that the data-parallel step,
    which sums the denominators over the ranks, adds up the global aux."""
    x, out_mask, out_lens, aux = moe_encode(
        params, feats, mask, frame_lens, cfg, _capacity(cfg, feats, dp),
        train=train, generator=generator, dp=dp)
    log_probs, _ = ctc_head(params, x, out_mask)
    terms = ctc_loss_terms_fused if use_kernel else ctc_loss_terms
    num_c, den_c = terms(log_probs, out_lens, labels, label_lens)
    nv = out_mask.float().sum()
    weight = torch.clamp(dp.all_sum(nv), min=1.0)
    num = torch.stack([num_c, cfg.transformer.moe_aux_weight * aux * weight])
    return num, torch.stack([den_c, nv])


def make_moe_loss(cfg: Config, num_experts: int, capacity: int,
                  aux_weight: float = 0.01, use_kernel: bool = True):
    """loss_fn(params, wave, num_samples, labels, label_lens) -> ctc_mean +
    aux_weight x the blocks' mean aux, at a fixed `capacity`, without
    dropout (the JAX package's test anchor; `num_experts` is read from the
    params)."""
    def loss_fn(params, wave, num_samples, labels, label_lens):
        with torch.no_grad():
            feats, mask, frame_lens = extract_features(wave, num_samples,
                                                       cfg.features)
        x, out_mask, out_lens, aux = moe_encode(params, feats, mask,
                                                frame_lens, cfg, capacity)
        log_probs, _ = ctc_head(params, x, out_mask)
        terms = ctc_loss_terms_fused if use_kernel else ctc_loss_terms
        num, den = terms(log_probs, out_lens, labels, label_lens)
        return num / torch.clamp(den, min=1.0) + aux_weight * aux

    return loss_fn


def moe_leaf_dim(name: str) -> int | None:
    """The dimension an expert axis splits of the leaf `name`: 0 for an
    expert stack, None for the router and the dense leaves."""
    parts = name.split(".")
    if len(parts) == 3 and parts[0] == "blocks" and parts[2] in _EXPERT_LEAVES:
        return 0
    return None


def moe_param_specs(params: dict) -> dict[str, tuple]:
    """{name: partition spec} of an MoE parameter dict on an ``expert``
    axis, as the JAX package's rules write it: ``("expert",)`` for the
    expert stacks, ``()`` (replicated) for the router and the rest."""
    return {k: ("expert",) if moe_leaf_dim(k) == 0 else ()
            for k in params}


def shard_moe_params(params: dict[str, torch.Tensor], n: int, index: int
                     ) -> dict[str, torch.Tensor]:
    """The leaves that position `index` of an expert axis of `n` holds:
    its E/n experts of each stack, the other leaves whole."""
    return {k: v if moe_leaf_dim(k) is None else shard_leaf(v, 0, index, n)
            for k, v in params.items()}
