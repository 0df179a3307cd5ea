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

Gate order everywhere: i, f, g, o (sigmoid, sigmoid, tanh, sigmoid).
Parameters per direction: ``W`` (I, 4H), ``U`` (H, 4H), ``b`` (4H,), the JAX
package's layout.
"""

from __future__ import annotations

import torch

from . import cuda_lstm


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
        pre = xp[:, t].float() + h.to(U.dtype).float() @ U32
        i = torch.sigmoid(pre[:, :H])
        f = torch.sigmoid(pre[:, H:2 * H])
        g = torch.tanh(pre[:, 2 * H:3 * H])
        o = torch.sigmoid(pre[:, 3 * H:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = m_all[:, t, None]
        valid = m > 0
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        out[:, t] = (h_new * m).to(xp.dtype)
    if residuals:
        return out, hprev, cprev
    return out


def lstm_scan_bwd_plain(xp: torch.Tensor, U: torch.Tensor, mask: torch.Tensor,
                        hprev: torch.Tensor, cprev: torch.Tensor,
                        gy: torch.Tensor, reverse: bool = False):
    """Plain PyTorch version of the LSTM backward kernel: a step-by-step
    transcription of pg_asr_tpu/ops/pallas_lstm.py ``_kernel_bwd``.

    Walks time in the opposite order of the forward with float32 carries
    dh, dc and a float32 dU accumulator; recomputes the gates from
    ``xp_t + hprev_t @ U``; dpre rounded to U's dtype (``dpre_mx``) feeds
    both ``dU += hprev^T @ dpre_mx`` and ``dh = (1-m)*dh + dpre_mx @ U^T``.

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
        hp = hprev[t].to(U.dtype).float()
        cp = cprev[t].float()
        pre = xp[:, t].float() + hp @ U32
        i = torch.sigmoid(pre[:, :H])
        f = torch.sigmoid(pre[:, H:2 * H])
        g = torch.tanh(pre[:, 2 * H:3 * H])
        o = torch.sigmoid(pre[:, 3 * H:])
        c_new = f * cp + i * g
        th = torch.tanh(c_new)
        m = m_all[:, t, None]
        # y_t = h_new * m; carry h_t = m ? h_new : h_{t-1} (same for c)
        dhn = m * (dh + gy[:, t].float())
        dct = m * dc + dhn * o * (1.0 - th * th)
        dpre = torch.cat([dct * g * i * (1.0 - i),
                          dct * cp * f * (1.0 - f),
                          dct * i * (1.0 - g * g),
                          dhn * th * o * (1.0 - o)], dim=1)
        dxp[:, t] = dpre.to(xp.dtype)
        dpre_mx = dpre.to(U.dtype).float()
        du = du + hp.T @ dpre_mx
        dh = (1.0 - m) * dh + dpre_mx @ U32.T
        dc = (1.0 - m) * dc + dct * f
    return dxp, du.to(U.dtype)


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


def bilstm_layer(params: dict, x: torch.Tensor, mask: torch.Tensor,
                 use_kernel: bool = True,
                 fuse_directions: bool = False) -> torch.Tensor:
    """Bidirectional layer -> (B, T, 2H), the two directions run separately.

    params: {"fwd": {W, U, b}, "bwd": {W, U, b}}."""
    if fuse_directions:
        raise NotImplementedError(
            "fuse_directions (pallas_bilstm_scan) is not yet ported to "
            "pg_asr_tpu_torch; see ROADMAP.md queue 2")
    fwd = lstm_layer(params["fwd"], x, mask, reverse=False,
                     use_kernel=use_kernel)
    bwd = lstm_layer(params["bwd"], x, mask, reverse=True,
                     use_kernel=use_kernel)
    return torch.cat([fwd, bwd], dim=-1)
