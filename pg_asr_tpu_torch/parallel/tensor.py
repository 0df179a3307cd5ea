"""Megatron tensor parallelism: the ``model`` mesh axis (counterpart of the
model half of pg_asr_tpu/parallel/mesh.py, ``param_sharding_rules``, and
of the model part of parallel/moe.py's ``moe_param_specs``).

The JAX package places each parameter leaf on the ``model`` axis by its
rules and lets GSPMD partition the one-device step around them. The port
makes the same placement (``spec_for``, ``moe_spec_for``: the JAX rules
over the port's flat leaf names) and runs each rank's part by hand:

  * Megatron pairs (``PAIRED``): the "expanding" product of a block split
    by its output columns, the "contracting" one that follows by its input
    rows. A rank computes its columns only (its h/T heads of the attention,
    its f/T columns of an FFN, its channels of the conformer's convolution
    module, its J/T of the transducer's joint), and the partial products
    of the second half are summed over the model group before its bias,
    which every rank holds whole. Two autograd functions carry a pair:
    ``copy_to`` on its input (the identity forward, a sum of the gradient
    over the group backward) and ``reduce_from`` on its output (the sum
    forward, the identity backward); the expert group's combine and
    dispatch of parallel/moe.py are the same two functions over the
    expert group.
  * The run layouts: a fused ``qkv`` holds its columns as [3][h][dh] and a
    conformer ``conv_in`` as [a | b] for its GLU; a contiguous 1/T of
    either would mix q with k or part a_i from b_i. Before the split their
    last dimension is permuted to [T][3][h/T][dh] (the JAX package's
    ``permute_qkv_for_tp``) and [T][2][d/T], and back when the parts are
    gathered, so checkpoints keep the canonical order.
  * Every other leaf the rules split (the LSTM ``W``, ``U`` and ``b``,
    ``input_proj``, ``ctc_head``, ``pred_embed``, the seq2seq ``output``,
    the router of a switch-MoE on ``model`` alone) is stored split and
    gathered whole within the model group for the step's forward
    (parallel/mesh.py ``forward_params``); the rank keeps its slice of the
    gradient. An LSTM's recurrence needs all four gates of a unit at every
    time step, so its weights are gathered once a step, not split.
  * Where the axis does not divide a leaf's split dimension (or, for the
    attention, the heads), the JAX package still runs (GSPMD pads); the
    port keeps that leaf, or its whole pair, whole on every rank.

The conformer's ``ln_mid`` normalizes all d channels between the
convolution's local channels and ``conv_out``: the rank's channels are
gathered (``gather_to``: the all-gather forward, the rank's slice of the
gradient backward), normalized whole, and split again (``split_to``: the
rank's slice forward, the all-gather of the gradient backward), so that
the statistics are the one device's and every rank's gradient of the
LayerNorm is the whole one.
"""

from __future__ import annotations

import torch

AXIS = "model"

# second matmul of a Megatron pair: input (contraction) dim sharded; its
# bias adds after the all-reduce, replicated
_ROW_SHARDED = {"attn_out", "ffn_out", "ffn1_out", "ffn2_out", "conv_out",
                "joint_out"}

# the owners of the leaves a rank computes as its part (the rest of a split
# leaf is gathered whole for the forward)
PAIRED = {"qkv", "attn_out", "ffn_in", "ffn_out", "ffn1_in", "ffn1_out",
          "ffn2_in", "ffn2_out", "conv_in", "conv_dw", "conv_out",
          "joint_enc", "joint_pred", "joint_out", "w1", "b1", "w2"}

# leaves whose last dimension is permuted into the run layout: the groups
# of their canonical columns
_PERMUTED = {"qkv": 3, "conv_in": 2}


def spec_for(path: tuple[str, ...]) -> tuple:
    """The JAX package's ``param_sharding_rules`` on a live model axis: the
    partition spec of the leaf at `path` (its flat name split on dots)."""
    leaf = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    if leaf in ("W", "U"):  # LSTM (I, 4H) / (H, 4H): the gate dim
        return (None, AXIS)
    if leaf == "conv_dw":  # depthwise (K, 1, d): the channels
        return (None, None, AXIS)
    if leaf == "pred_embed":  # (A, E): the embedding dim
        return (None, AXIS)
    if leaf == "w":
        return (AXIS, None) if parent in _ROW_SHARDED else (None, AXIS)
    if leaf == "b":
        return () if parent in _ROW_SHARDED else (AXIS,)
    return ()  # LayerNorm scale / bias and everything else


def moe_spec_for(path: tuple[str, ...]) -> tuple:
    """The JAX package's ``moe_param_specs`` on live expert and model axes:
    the expert stacks on both (``w1`` and ``b1`` by their ffn columns, ``w2``
    by its ffn rows), the router whole, the dense leaves as ``spec_for``."""
    stacks = {"w1": ("expert", None, AXIS), "b1": ("expert", AXIS),
              "w2": ("expert", AXIS, None), "b2": ("expert",)}
    if path[-1] in stacks:
        return stacks[path[-1]]
    if len(path) >= 2 and path[-2] == "router":
        return ()
    return spec_for(path)


def _owner(name: str) -> str:
    """The module a leaf belongs to: ``blocks.0.qkv.w`` -> ``qkv``, a
    leaf of its own (``blocks.0.conv_dw``, ``blocks.0.w1``) -> itself."""
    parts = name.split(".")
    if parts[-1] in ("w", "b", "W", "U"):
        return parts[-2] if len(parts) >= 2 else ""
    return parts[-1]


def model_leaf_dim(name: str, shape: tuple[int, ...], n: int,
                   num_heads: int = 0, moe: bool = False) -> int | None:
    """The dimension of leaf `name` (of `shape`) that a model axis of `n`
    splits: the JAX rule's (``moe_spec_for`` under a live expert axis,
    else ``spec_for``), or None where it splits none or `n` does not divide
    the part (the heads for an attention pair, the GLU's halves for
    ``conv_in``)."""
    path = tuple(name.split("."))
    spec = moe_spec_for(path) if moe else spec_for(path)
    if n <= 1 or AXIS not in spec:
        return None
    dim = spec.index(AXIS)
    owner = _owner(name)
    if owner in ("qkv", "attn_out"):
        ok = num_heads > 0 and num_heads % n == 0
    elif owner == "conv_in":
        ok = shape[dim] % (2 * n) == 0
    else:
        ok = shape[dim] % n == 0
    return dim if ok else None


def is_paired(name: str) -> bool:
    """Whether a rank computes leaf `name` as its part (a Megatron pair's
    leaf), rather than gathering it whole for the forward."""
    return _owner(name) in PAIRED


def to_run(name: str, v: torch.Tensor, n: int,
           inverse: bool = False) -> torch.Tensor:
    """Leaf `name` in the run layout of a model axis of `n` (``inverse``:
    back to the canonical one): a ``qkv`` leaf's last dimension [3][h][dh]
    <-> [n][3][h/n][dh], a ``conv_in`` leaf's [2][d] <-> [n][2][d/n]; any
    other leaf as it is."""
    groups = _PERMUTED.get(_owner(name))
    if groups is None or n <= 1:
        return v
    *lead, cols = v.shape
    a, b = (n, groups) if inverse else (groups, n)
    y = v.reshape(*lead, a, b, cols // (a * b)).transpose(-3, -2)
    return y.reshape(*lead, cols).contiguous()


def split(dp, local: int, whole: int) -> bool:
    """Whether a pair runs split on the model axis of ``dp``: its part holds
    `local` of the `whole` columns."""
    return dp.model_size > 1 and local != whole


class _Reduce(torch.autograd.Function):
    """The partial results summed over a group of ranks; the gradient passes
    unchanged (each rank's part reaches the sum once)."""

    @staticmethod
    def forward(ctx, t, dp, over):
        return dp.group_sum(t, over)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    """The input as it is; its gradient, which each rank forms from its own
    part only, summed over a group of ranks."""

    @staticmethod
    def forward(ctx, x, dp, over):
        ctx.dp, ctx.over = dp, over
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.dp.group_sum(g, ctx.over), None, None


class _Gather(torch.autograd.Function):
    """The ranks' parts of the model group joined along `dim`; the rank's
    slice of the gradient (every rank computes the same whole one)."""

    @staticmethod
    def forward(ctx, x, dp, dim):
        ctx.dp, ctx.dim = dp, dim
        return dp.model_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.dp.model_part(g, ctx.dim), None, None


class _Split(torch.autograd.Function):
    """The rank's part along `dim` of a tensor every rank of the model group
    holds whole; the ranks' gradients of the parts joined."""

    @staticmethod
    def forward(ctx, x, dp, dim):
        ctx.dp, ctx.dim = dp, dim
        return dp.model_part(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.dp.model_gather(g, ctx.dim), None, None


def reduce_from(t: torch.Tensor, dp, over: str = AXIS) -> torch.Tensor:
    """`t` summed over the group `over` of ``dp`` (in float32), the gradient
    unchanged."""
    return _Reduce.apply(t, dp, over)


def copy_to(x: torch.Tensor, dp, over: str = AXIS) -> torch.Tensor:
    """`x` unchanged, its gradient summed over the group `over` of ``dp``."""
    return _Copy.apply(x, dp, over)


def gather_to(x: torch.Tensor, dp, dim: int = -1) -> torch.Tensor:
    """The model group's parts of `x` joined along `dim`."""
    return _Gather.apply(x, dp, dim % x.dim())


def split_to(x: torch.Tensor, dp, dim: int = -1) -> torch.Tensor:
    """This rank's part along `dim` of `x`, whole on every rank."""
    return _Split.apply(x, dp, dim % x.dim())


def row_linear(params: dict, name: str, x: torch.Tensor, dp,
               is_split: bool) -> torch.Tensor:
    """The second half of a pair: ``x @ w + b``; split, the partial
    products summed over the model group before the bias."""
    y = torch.matmul(x, params[f"{name}.w"])
    if is_split:
        y = reduce_from(y, dp)
    return y + params[f"{name}.b"]
