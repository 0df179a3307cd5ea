"""RNN-T (transducer) model family: encoder + prediction network + joint
network (counterpart of pg_asr_tpu/models/transducer.py).

  * Encoder: the BiLSTM, transformer or conformer encoder of the CTC
    families (``transducer.encoder``), its parameters under ``encoder.``.
  * Prediction network: embedding (a row lookup, exact as the JAX
    package's one-hot product) + one LSTM over [blank, y_1 .. y_U], run by
    ``ops/lstm.lstm_scan_xla``: the JAX package's XLA scan numerics, carries
    in the compute dtype (no Pallas kernel lies under it).
  * Joint network: project encoder and prediction states to joint_dim,
    tanh of their broadcast sum over the (T', U+1) lattice, vocab head.
    Unfused, the (B, T', U+1, J) tanh and the head run in the compute
    dtype, then ``ops/transducer.joint_log_probs``; with
    ``transducer.fused_joint`` the fused joint (``ops/joint``: the
    hand-written kernels on CUDA tensors) computes the two emission tables
    in float32 without the 4-D tensor.

``fused_joint`` resolves as: "auto" -> fused iff the encoder states lie on
a CUDA device (the JAX package's "auto" means a single TPU); True -> fused
(the kernels on CUDA, their plain versions on the CPU); False -> unfused.

Parameters: a flat dict in the JAX package's layouts, ``encoder.*`` (the
encoder family's names), ``pred_embed`` (A, E), ``pred_lstm.{W, U, b}``,
``joint_enc.{w, b}``, ``joint_pred.{w, b}``, ``joint_out.{w, b}`` and, with
``ctc_weight > 0``, ``ctc_head.{w, b}``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import Config
from ..ops.joint import fused_joint
from ..ops.lstm import lstm_scan_xla
from ..ops.transducer import joint_log_probs
from ..parallel import tensor
from ..parallel.mesh import ONE_DEVICE, DataParallel
from . import bilstm_ctc, cast_params, conformer_ctc, transformer_ctc
from .bilstm_ctc import _dropout, init_linear, init_lstm, linear, torch_dtype

_ENCODERS = ("bilstm", "transformer", "conformer")


def _check_encoder(kind: str) -> None:
    if kind not in _ENCODERS:
        raise ValueError(f"unknown transducer encoder {kind!r}")


def enc_dim(cfg: Config) -> int:
    kind = cfg.transducer.encoder
    _check_encoder(kind)
    if kind == "bilstm":
        return 2 * cfg.model.hidden_size
    return getattr(cfg, kind).d_model


def init_params(cfg: Config, generator: torch.Generator,
                device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Same shapes and distributions as the JAX init, drawn on the CPU from
    `generator`, then moved and cast (LayerNorm params stay float32)."""
    tr, mcfg = cfg.transducer, cfg.model
    _check_encoder(tr.encoder)
    if tr.encoder == "bilstm":
        enc = bilstm_ctc.init_encoder_params(mcfg, generator)
    elif tr.encoder == "transformer":
        enc = transformer_ctc.init_encoder_params(mcfg, cfg.transformer,
                                                  generator)
    else:
        enc = conformer_ctc.init_encoder_params(mcfg, cfg.conformer,
                                                generator)
    p = {f"encoder.{k}": v for k, v in enc.items()}
    V, E = mcfg.vocab_size, tr.pred_embed_dim
    p["pred_embed"] = (torch.randn(V, E, generator=generator)
                       * (2.0 / (V + E)) ** 0.5)
    init_lstm(p, "pred_lstm", E, tr.pred_hidden, generator)
    init_linear(p, "joint_enc", enc_dim(cfg), tr.joint_dim, generator)
    init_linear(p, "joint_pred", tr.pred_hidden, tr.joint_dim, generator)
    init_linear(p, "joint_out", tr.joint_dim, V, generator)
    if tr.ctc_weight > 0.0:  # hybrid training: auxiliary CTC head
        init_linear(p, "ctc_head", enc_dim(cfg), V, generator)
    return cast_params(p, torch_dtype(mcfg.dtype), device)


def encode(params: dict, feats: torch.Tensor, frame_mask: torch.Tensor,
           frame_lens: torch.Tensor, cfg: Config, use_kernel: bool = True,
           train: bool = False, generator: torch.Generator | None = None,
           dp: DataParallel = ONE_DEVICE):
    """Encoder dispatch -> (enc (B, T', De), out_mask (B, T') bool,
    out_lens (B,)). ``dp``: a model axis's rank runs its part of an
    attention encoder's pairs."""
    kind = cfg.transducer.encoder
    _check_encoder(kind)
    enc = {k[len("encoder."):]: v for k, v in params.items()
           if k.startswith("encoder.")}
    if kind == "bilstm":
        x = bilstm_ctc.encode(enc, feats, frame_mask, cfg.model,
                              use_kernel=use_kernel, train=train,
                              generator=generator)
        return x, frame_mask.bool(), frame_lens
    mod = transformer_ctc if kind == "transformer" else conformer_ctc
    return mod.encode(enc, feats, frame_mask, frame_lens, cfg.model,
                      getattr(cfg, kind), use_kernel=use_kernel, train=train,
                      generator=generator, dp=dp)


def embed_labels(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """(...) int ids -> (..., E) embedding rows."""
    return params["pred_embed"][ids.long()]


def predict_states(params: dict, labels: torch.Tensor,
                   label_lens: torch.Tensor, cfg: Config, train: bool = False,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Prediction-network states g_u for u = 0 .. U -> (B, U+1, P): the LSTM
    reads [blank, y_1 .. y_U], so g_u conditions on labels[:u]; positions
    past label_lens keep the frozen carry's outputs (the loss never reads
    them)."""
    U = labels.shape[1]
    x = embed_labels(params, F.pad(labels.long(), (1, 0)))  # (B, U+1, E)
    x = _dropout(x, cfg.model.dropout, generator, train)
    # position u is valid iff u <= label_lens (position 0: empty history)
    umask = (torch.arange(U + 1, device=labels.device)[None, :]
             <= label_lens[:, None].long())
    xp = torch.matmul(x, params["pred_lstm.W"]) + params["pred_lstm.b"]
    return lstm_scan_xla(xp, params["pred_lstm.U"], umask)


def joint_logits(params: dict, enc: torch.Tensor, pred: torch.Tensor,
                 dp: DataParallel = ONE_DEVICE,
                 is_split: bool = False) -> torch.Tensor:
    """enc (B, T, De), pred (B, U+1, P) -> logits (B, T, U+1, A) through the
    (B, T, U+1, J) tanh joint, in the compute dtype. Split on the model
    axis of ``dp``: the rank's J/T columns of the projections and the tanh,
    its rows of ``joint_out``, the partial logits summed over the group."""
    if is_split:
        enc, pred = tensor.copy_to(enc, dp), tensor.copy_to(pred, dp)
    e = linear(params, "joint_enc", enc)
    g = linear(params, "joint_pred", pred)
    return tensor.row_linear(params, "joint_out",
                             torch.tanh(e[:, :, None, :] + g[:, None, :, :]),
                             dp, is_split)


def use_fused_joint(flag, enc: torch.Tensor) -> bool:
    """``transducer.fused_joint`` ("auto" | bool) for encoder states `enc`:
    "auto" is fused iff they lie on a CUDA device."""
    return enc.is_cuda if flag == "auto" else bool(flag)


def joint_lattice_log_probs(params: dict, enc: torch.Tensor,
                            pred: torch.Tensor, labels: torch.Tensor,
                            cfg: Config, use_kernel: bool = True,
                            dp: DataParallel = ONE_DEVICE):
    """enc/pred states + labels -> (lp_blank (B, T, U+1), lp_label (B, T,
    U)) float32 over the whole lattice: unfused (the 4-D tanh and the head
    in the compute dtype, then ``joint_log_probs``) or, with
    ``fused_joint``, the fused joint (kernels on CUDA tensors unless
    ``use_kernel`` is False). On the model axis of ``dp`` the unfused joint
    runs as a Megatron pair (``joint_logits``); the fused kernels reduce
    over J inside, so the rank's projections and rows of ``joint_out`` are
    gathered and the kernel runs whole."""
    is_split = tensor.split(dp, params["joint_out.w"].shape[0],
                            cfg.transducer.joint_dim)
    if not use_fused_joint(cfg.transducer.fused_joint, enc):
        return joint_log_probs(joint_logits(params, enc, pred, dp, is_split),
                               labels)
    w = params["joint_out.w"]
    if is_split:
        enc, pred = tensor.copy_to(enc, dp), tensor.copy_to(pred, dp)
    e = linear(params, "joint_enc", enc)
    g = linear(params, "joint_pred", pred)
    if is_split:
        e, g = tensor.gather_to(e, dp), tensor.gather_to(g, dp)
        w = tensor.gather_to(w, dp, 0)
    return fused_joint(e, g, w, params["joint_out.b"], labels,
                       use_kernel=use_kernel)


def apply_lattice(params: dict, feats: torch.Tensor, frame_mask: torch.Tensor,
                  frame_lens: torch.Tensor, labels: torch.Tensor,
                  label_lens: torch.Tensor, cfg: Config,
                  use_kernel: bool = True, train: bool = False,
                  generator: torch.Generator | None = None,
                  with_ctc: bool = False, dp: DataParallel = ONE_DEVICE):
    """Training forward: features + labels -> (lp_blank (B, T', U+1),
    lp_label (B, T', U), out_lens (B,)) for ops/transducer.transducer_loss;
    with ``with_ctc`` (hybrid training) also the auxiliary head's masked
    (B, T', A) float32 CTC log-probs. Dropout bits come from `generator`,
    the encoder's sites first. ``dp``: a model axis's rank runs its part of
    the encoder's and the joint's pairs."""
    enc, out_mask, out_lens = encode(params, feats, frame_mask, frame_lens,
                                     cfg, use_kernel=use_kernel, train=train,
                                     generator=generator, dp=dp)
    pred = predict_states(params, labels, label_lens, cfg, train=train,
                          generator=generator)
    lp_blank, lp_label = joint_lattice_log_probs(
        params, enc, pred, labels, cfg, use_kernel=use_kernel, dp=dp)
    if not with_ctc:
        return lp_blank, lp_label, out_lens
    ctc_lp = torch.log_softmax(linear(params, "ctc_head", enc).float(), -1)
    ctc_lp = ctc_lp * out_mask.float()[:, :, None]
    return lp_blank, lp_label, out_lens, ctc_lp
