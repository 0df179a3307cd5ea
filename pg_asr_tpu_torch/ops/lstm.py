"""LSTM layers over padded batches (counterpart of pg_asr_tpu/ops/lstm.py).

The input projection x@W + b for all timesteps is hoisted out of the
recurrence into one ``torch.matmul``; the recurrence itself (h@U + gates,
masked) runs the hand-written CUDA kernels (``ops/cuda_lstm``) on CUDA
tensors and the plain PyTorch versions below on CPU tensors, a choice made
here and nowhere else. ``use_kernel=False`` runs the plain versions on any
device: the reference a kernel run is held against. Under
autograd the recurrence is ``LSTMScan``, whose forward keeps the residuals
(h and c before every step) and whose backward is the reverse-time
gradient kernel; without autograd (inference, ``torch.no_grad``) the
forward runs in its inference form, which keeps no residuals.
``bilstm_layer(fuse_directions=True)`` runs both directions in one walk
(``BiLSTMScan``, the counterpart of ``pallas_bilstm_scan``): step s runs
forward time s and backward time T-1-s, on one launch of both directions
(bilstm_fwd in ``csrc/lstm_fwd.cu``, bilstm_bwd in ``csrc/lstm_bwd.cu``,
each direction with the single-direction kernel's bits) or on their plain
versions.

Gate order everywhere: i, f, g, o (sigmoid, sigmoid, tanh, sigmoid).
Parameters per direction: ``W`` (I, 4H), ``U`` (H, 4H), ``b`` (4H,), the JAX
package's layout.
"""

from __future__ import annotations

import torch

from . import cuda_lstm
from . import registry  # noqa: F401  (defines torch.ops.pgasr)


def _cell_fwd(xp_t, h, c, U, U32, m):
    """One masked step of the Pallas ``_kernel`` body for one direction:
    float32 carries h, c; h rounded to U's dtype for the product, which
    accumulates in float32; the carry frozen where ``m == 0`` -> (h, c,
    y_t = h_new * m in float32)."""
    H = h.shape[1]
    pre = xp_t.float() + h.to(U.dtype).float() @ U32
    i = torch.sigmoid(pre[:, :H])
    f = torch.sigmoid(pre[:, H:2 * H])
    g = torch.tanh(pre[:, 2 * H:3 * H])
    o = torch.sigmoid(pre[:, 3 * H:])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    valid = m > 0
    return torch.where(valid, h_new, h), torch.where(valid, c_new, c), \
        h_new * m


def lstm_scan_plain(xp: torch.Tensor, U: torch.Tensor, mask: torch.Tensor,
                    reverse: bool = False, residuals: bool = False):
    """Plain PyTorch version of the LSTM forward kernel.

    Follows the numerics of the Pallas kernel (pg_asr_tpu/ops/pallas_lstm.py
    ``_kernel``): carries in float32; h cast to U's dtype for the product,
    which accumulates in float32; output ``h_new * m`` in xp's dtype; the
    carry frozen where ``m == 0``; reverse walks t = T-1 .. 0.

    xp: (B, T, 4H), U: (H, 4H), mask: (B, T) -> out (B, T, H); with
    ``residuals`` -> (out, hprev, cprev): the carries before each step t,
    time-major (T, B, H), hprev in xp's dtype and cprev in float32 (the
    ``train=True`` form), padded steps included.
    """
    B, T, H4 = xp.shape
    H = H4 // 4
    h = torch.zeros(B, H, dtype=torch.float32, device=xp.device)
    c = torch.zeros_like(h)
    out = torch.empty(B, T, H, dtype=xp.dtype, device=xp.device)
    if residuals:
        hprev = torch.empty(T, B, H, dtype=xp.dtype, device=xp.device)
        cprev = torch.empty(T, B, H, dtype=torch.float32, device=xp.device)
    U32 = U.float()  # exact: a bf16 x bf16 product is exact in float32
    m_all = mask.to(torch.float32)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if residuals:
            hprev[t] = h.to(xp.dtype)
            cprev[t] = c
        h, c, y = _cell_fwd(xp[:, t], h, c, U, U32, m_all[:, t, None])
        out[:, t] = y.to(xp.dtype)
    if residuals:
        return out, hprev, cprev
    return out


def _cell_bwd(xp_t, U, U32, hp_t, cp_t, gy_t, m, dh, dc, du):
    """One step of the Pallas ``_kernel_bwd`` body for one direction ->
    (dxp_t in xp's dtype, dh, dc, du): the gates recomputed from ``xp_t +
    hprev_t @ U``; dpre rounded to U's dtype (``dpre_mx``) feeds both
    ``du += hprev^T @ dpre_mx`` and ``dh = (1-m)*dh + dpre_mx @ U^T``."""
    H = dh.shape[1]
    hp = hp_t.to(U.dtype).float()
    cp = cp_t.float()
    pre = xp_t.float() + hp @ U32
    i = torch.sigmoid(pre[:, :H])
    f = torch.sigmoid(pre[:, H:2 * H])
    g = torch.tanh(pre[:, 2 * H:3 * H])
    o = torch.sigmoid(pre[:, 3 * H:])
    c_new = f * cp + i * g
    th = torch.tanh(c_new)
    # y_t = h_new * m; carry h_t = m ? h_new : h_{t-1} (same for c)
    dhn = m * (dh + gy_t.float())
    dct = m * dc + dhn * o * (1.0 - th * th)
    dpre = torch.cat([dct * g * i * (1.0 - i),
                      dct * cp * f * (1.0 - f),
                      dct * i * (1.0 - g * g),
                      dhn * th * o * (1.0 - o)], dim=1)
    dpre_mx = dpre.to(U.dtype).float()
    du = du + hp.T @ dpre_mx
    dh = (1.0 - m) * dh + dpre_mx @ U32.T
    dc = (1.0 - m) * dc + dct * f
    return dpre.to(xp_t.dtype), dh, dc, du


def lstm_scan_bwd_plain(xp: torch.Tensor, U: torch.Tensor, mask: torch.Tensor,
                        hprev: torch.Tensor, cprev: torch.Tensor,
                        gy: torch.Tensor, reverse: bool = False):
    """Plain PyTorch version of the LSTM backward kernel: a step-by-step
    transcription of pg_asr_tpu/ops/pallas_lstm.py ``_kernel_bwd``.

    Walks time in the opposite order of the forward with float32 carries
    dh, dc and a float32 dU accumulator (``_cell_bwd``).

    xp (B,T,4H), U (H,4H), mask (B,T), hprev/cprev (T,B,H) from the
    residual forward, gy (B,T,H) -> (dxp (B,T,4H) in xp's dtype, dU (H,4H)
    in U's dtype).
    """
    B, T, H4 = xp.shape
    H = H4 // 4
    dh = torch.zeros(B, H, dtype=torch.float32, device=xp.device)
    dc = torch.zeros_like(dh)
    du = torch.zeros(H, H4, dtype=torch.float32, device=xp.device)
    dxp = torch.empty_like(xp)
    U32 = U.float()
    m_all = mask.to(torch.float32)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        dxp[:, t], dh, dc, du = _cell_bwd(xp[:, t], U, U32, hprev[t],
                                          cprev[t], gy[:, t],
                                          m_all[:, t, None], dh, dc, du)
    return dxp, du.to(U.dtype)


def bilstm_scan_plain(xpf: torch.Tensor, xpb: torch.Tensor, Uf: torch.Tensor,
                      Ub: torch.Tensor, mask: torch.Tensor,
                      residuals: bool = False):
    """Plain PyTorch version of the fused-direction forward kernel: a
    step-by-step transcription of pg_asr_tpu/ops/pallas_lstm.py
    ``_kernel_bi``. Step s runs forward time s and backward time T-1-s,
    each direction with ``_kernel``'s numerics (``_cell_fwd``).

    xpf, xpb (B, T, 4H), Uf, Ub (H, 4H), mask (B, T) -> y (B, T, 2H) =
    concat(forward, backward) in xp's dtype; with ``residuals`` -> (y, hpf,
    cpf, hpb, cpb), each direction's carries before each of its steps,
    (T, B, H) time-major, h in xp's dtype and c in float32.
    """
    B, T, H4 = xpf.shape
    H = H4 // 4
    dirs = ((xpf, Uf, Uf.float()), (xpb, Ub, Ub.float()))
    zeros = torch.zeros(B, H, dtype=torch.float32, device=xpf.device)
    carry = [(zeros, zeros), (zeros, zeros)]
    y = torch.empty(B, T, 2 * H, dtype=xpf.dtype, device=xpf.device)
    if residuals:
        hp = torch.empty(2, T, B, H, dtype=xpf.dtype, device=xpf.device)
        cp = torch.empty(2, T, B, H, dtype=torch.float32, device=xpf.device)
    m_all = mask.to(torch.float32)
    for s in range(T):
        for d, (xp, U, U32) in enumerate(dirs):
            t = T - 1 - s if d else s
            h, c = carry[d]
            if residuals:
                hp[d, t] = h.to(xp.dtype)
                cp[d, t] = c
            h, c, yt = _cell_fwd(xp[:, t], h, c, U, U32, m_all[:, t, None])
            carry[d] = (h, c)
            y[:, t, d * H:(d + 1) * H] = yt.to(xp.dtype)
    if residuals:
        return y, hp[0], cp[0], hp[1], cp[1]
    return y


def bilstm_scan_bwd_plain(xpf, xpb, Uf, Ub, mask, hpf, cpf, hpb, cpb, gy):
    """Plain PyTorch version of the fused-direction backward kernel: a
    step-by-step transcription of pg_asr_tpu/ops/pallas_lstm.py
    ``_kernel_bi_bwd``, the reverse of the forward's walk (direction f
    visits T-1 .. 0, direction b visits 0 .. T-1), each direction with
    ``_kernel_bwd``'s numerics (``_cell_bwd``: float32 dh, dc and dU
    accumulators, dpre rounded to U's dtype for both products).

    Residuals (T, B, H) from ``bilstm_scan_plain(residuals=True)``, gy
    (B, T, 2H) -> (dxpf, dxpb (B, T, 4H) in xp's dtype, dUf, dUb (H, 4H) in
    U's dtype).
    """
    B, T, H4 = xpf.shape
    H = H4 // 4
    dirs = ((xpf, Uf, Uf.float(), hpf, cpf, gy[:, :, :H]),
            (xpb, Ub, Ub.float(), hpb, cpb, gy[:, :, H:]))
    zeros = torch.zeros(B, H, dtype=torch.float32, device=xpf.device)
    du0 = torch.zeros(H, H4, dtype=torch.float32, device=xpf.device)
    carry = [(zeros, zeros, du0), (zeros, zeros, du0)]
    dxp = (torch.empty_like(xpf), torch.empty_like(xpb))
    m_all = mask.to(torch.float32)
    for s in range(T):
        for d, (xp, U, U32, hp, cp, g) in enumerate(dirs):
            t = s if d else T - 1 - s
            dxp[d][:, t], *carry[d] = _cell_bwd(
                xp[:, t], U, U32, hp[t], cp[t], g[:, t], m_all[:, t, None],
                *carry[d])
    return dxp[0], dxp[1], carry[0][2].to(Uf.dtype), carry[1][2].to(Ub.dtype)


def xla_gate_step(c: torch.Tensor, pre: torch.Tensor):
    """The JAX package's ``_gate_step`` (pg_asr_tpu/ops/lstm.py): the gates
    of pre-activations ``pre`` (B, 4H) and the cell update, every operation
    rounding to pre's dtype; the sigmoid is ``jax.nn.sigmoid``'s
    1 / (1 + exp(-x)), each operation rounded (torch.sigmoid rounds once).
    -> (h_new, c_new). The XLA scan and the transducer decoders' prediction
    step share it."""
    H = pre.shape[1] // 4
    # one sigmoid over all four gates (the g slice unused): elementwise, so
    # each element's bits are the per-slice ones, in a third of the launches
    sig = 1.0 / (1.0 + torch.exp(-pre))
    i, f, o = sig[:, :H], sig[:, H:2 * H], sig[:, 3 * H:]
    g = torch.tanh(pre[:, 2 * H:3 * H])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def lstm_scan_xla(xp: torch.Tensor, U: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """The JAX package's XLA scan (pg_asr_tpu/ops/lstm.py ``lstm_scan``,
    forward direction) under PyTorch autograd, on any device: carries h, c
    in xp's dtype, ``h @ U`` in that dtype (accumulated in float32 and
    rounded once), the gates by ``xla_gate_step``; the carry frozen where
    ``mask == 0`` and the output ``h_new * mask``. The transducer's
    prediction network runs it (no Pallas kernel lies under it); in float32
    it equals ``lstm_scan_plain`` up to float32 rounding, in bfloat16 the
    two round apart.

    xp (B, T, 4H), U (H, 4H), mask (B, T) -> (B, T, H) in xp's dtype."""
    B, T, H4 = xp.shape
    h = torch.zeros(B, H4 // 4, dtype=xp.dtype, device=xp.device)
    return lstm_scan_xla_from(xp, U, mask, h, torch.zeros_like(h))[0]


def lstm_scan_xla_from(xp: torch.Tensor, U: torch.Tensor, mask: torch.Tensor,
                       h0: torch.Tensor, c0: torch.Tensor):
    """``lstm_scan_xla`` from the carry (h0, c0) (B, H) in xp's dtype,
    returning the carry too: the counterpart of pg_asr_tpu/serving.py
    ``_fwd_scan_from``, the forward direction of a streamed window, which
    carries (h, c) across chunks. -> (ys (B, T, H), (h, c)), the carry
    frozen at masked steps."""
    h, c = h0, c0
    if xp.shape[1] == 0:  # a window with no lookahead frames
        return xp.new_zeros(*h.shape[:1], 0, h.shape[1]), (h, c)
    m_all = mask.to(xp.dtype)[:, :, None]
    valid = m_all > 0
    out = []
    for t in range(xp.shape[1]):
        h_new, c_new = xla_gate_step(c, xp[:, t] + torch.matmul(h, U))
        h = torch.where(valid[:, t], h_new, h)
        c = torch.where(valid[:, t], c_new, c)
        out.append(h_new)
    # h_new * m, one multiply for all steps (the same bits)
    return torch.stack(out, dim=1) * m_all, (h, c)


def lstm_scan(xp: torch.Tensor, U: torch.Tensor, mask: torch.Tensor,
              reverse: bool = False, use_kernel: bool = True) -> torch.Tensor:
    """Masked LSTM recurrence, inference form: (B, T, 4H) -> (B, T, H)."""
    if use_kernel and xp.is_cuda:
        return cuda_lstm.lstm_scan_cuda(xp, U, mask, reverse)
    return lstm_scan_plain(xp, U, mask, reverse)


class LSTMScan(torch.autograd.Function):
    """The recurrence under autograd (counterpart of the custom VJP of
    ``pallas_lstm_scan``). Forward: the residual form; backward: the
    reverse-time gradient. Kernels on CUDA tensors unless ``use_kernel`` is
    False, plain versions otherwise."""

    @staticmethod
    def forward(ctx, xp, U, mask, reverse: bool, use_kernel: bool):
        kernel = use_kernel and xp.is_cuda
        if kernel:
            out, hprev, cprev = cuda_lstm.lstm_scan_residual_cuda(
                xp, U, mask, reverse)
        else:
            out, hprev, cprev = lstm_scan_plain(xp, U, mask, reverse,
                                                residuals=True)
        ctx.save_for_backward(xp, U, mask, hprev, cprev)
        ctx.reverse, ctx.kernel = reverse, kernel
        return out

    @staticmethod
    def backward(ctx, gy):
        xp, U, mask, hprev, cprev = ctx.saved_tensors
        bwd = (cuda_lstm.lstm_scan_bwd_cuda if ctx.kernel
               else lstm_scan_bwd_plain)
        dxp, dU = bwd(xp, U, mask, hprev, cprev, gy.contiguous(), ctx.reverse)
        return dxp, dU, None, None, None


def lstm_layer(params: dict, x: torch.Tensor, mask: torch.Tensor,
               reverse: bool = False, use_kernel: bool = True) -> torch.Tensor:
    """Single-direction LSTM layer. x: (B, T, I) -> (B, T, H).

    Under autograd ``LSTMScan``; otherwise the inference form, which keeps
    no residuals.
    """
    xp = torch.matmul(x, params["W"]) + params["b"]
    U = params["U"]
    if torch.is_grad_enabled() and (xp.requires_grad or U.requires_grad):
        return LSTMScan.apply(xp, U, mask, reverse, use_kernel)
    return lstm_scan(xp, U, mask, reverse, use_kernel)


def bilstm_scan(xpf: torch.Tensor, xpb: torch.Tensor, Uf: torch.Tensor,
                Ub: torch.Tensor, mask: torch.Tensor,
                use_kernel: bool = True) -> torch.Tensor:
    """Fused-direction recurrence, inference form: -> (B, T, 2H). Through
    pgasr::bilstm_fwd (ops/registry.py: the kernel on CUDA tensors, the
    plain version on CPU ones), which torch.export keeps as one node;
    ``use_kernel=False`` calls the plain version directly."""
    if use_kernel:
        return torch.ops.pgasr.bilstm_fwd(xpf, xpb, Uf, Ub, mask)
    return bilstm_scan_plain(xpf, xpb, Uf, Ub, mask)


class BiLSTMScan(torch.autograd.Function):
    """The fused-direction recurrence under autograd (counterpart of the
    custom VJP of ``pallas_bilstm_scan``). Forward: the residual form;
    backward: the reverse walk of both directions. Kernels on CUDA tensors
    unless ``use_kernel`` is False, plain versions otherwise."""

    @staticmethod
    def forward(ctx, xpf, xpb, Uf, Ub, mask, use_kernel: bool):
        kernel = use_kernel and xpf.is_cuda
        if kernel:
            y, *res = cuda_lstm.bilstm_scan_residual_cuda(xpf, xpb, Uf, Ub,
                                                          mask)
        else:
            y, *res = bilstm_scan_plain(xpf, xpb, Uf, Ub, mask,
                                        residuals=True)
        ctx.save_for_backward(xpf, xpb, Uf, Ub, mask, *res)
        ctx.kernel = kernel
        return y

    @staticmethod
    def backward(ctx, gy):
        bwd = (cuda_lstm.bilstm_scan_bwd_cuda if ctx.kernel
               else bilstm_scan_bwd_plain)
        return (*bwd(*ctx.saved_tensors, gy.contiguous()), None, None)


def bilstm_layer(params: dict, x: torch.Tensor, mask: torch.Tensor,
                 use_kernel: bool = True,
                 fuse_directions: bool = False) -> torch.Tensor:
    """Bidirectional layer -> (B, T, 2H). The two directions run
    separately (two ``lstm_layer``s) or, with ``fuse_directions``, in one
    walk (``BiLSTMScan`` under autograd, ``bilstm_scan`` otherwise); the
    per-direction projections ``x @ W + b`` stay outside the recurrence,
    as in pg_asr_tpu/ops/lstm.py ``bilstm_layer``.

    params: {"fwd": {W, U, b}, "bwd": {W, U, b}}."""
    if fuse_directions:
        xpf = torch.matmul(x, params["fwd"]["W"]) + params["fwd"]["b"]
        xpb = torch.matmul(x, params["bwd"]["W"]) + params["bwd"]["b"]
        Uf, Ub = params["fwd"]["U"], params["bwd"]["U"]
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (xpf, xpb, Uf, Ub)):
            return BiLSTMScan.apply(xpf, xpb, Uf, Ub, mask, use_kernel)
        return bilstm_scan(xpf, xpb, Uf, Ub, mask, use_kernel)
    fwd = lstm_layer(params["fwd"], x, mask, reverse=False,
                     use_kernel=use_kernel)
    bwd = lstm_layer(params["bwd"], x, mask, reverse=True,
                     use_kernel=use_kernel)
    return torch.cat([fwd, bwd], dim=-1)
