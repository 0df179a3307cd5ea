"""LSTM layers over padded batches (counterpart of pg_asr_tpu/ops/lstm.py).

The input projection x@W + b for all timesteps is hoisted out of the
recurrence into one ``torch.matmul``; the recurrence itself (h@U + gates,
masked) is ``ops/cuda_lstm.lstm_scan``: the hand-written CUDA kernel on CUDA
tensors, ``lstm_scan_plain`` below on CPU tensors.

Gate order everywhere: i, f, g, o (sigmoid, sigmoid, tanh, sigmoid).
Parameters per direction: ``W`` (I, 4H), ``U`` (H, 4H), ``b`` (4H,), the JAX
package's layout.
"""

from __future__ import annotations

import torch


def lstm_scan_plain(xp: torch.Tensor, U: torch.Tensor, mask: torch.Tensor,
                    reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the LSTM forward kernel.

    Follows the numerics of the Pallas kernel (pg_asr_tpu/ops/pallas_lstm.py
    ``_kernel``): carries in float32; h cast to U's dtype for the product,
    which accumulates in float32; output ``h_new * m`` in xp's dtype; the
    carry frozen where ``m == 0``; reverse walks t = T-1 .. 0.

    xp: (B, T, 4H), U: (H, 4H), mask: (B, T) -> (B, T, H).
    """
    B, T, H4 = xp.shape
    H = H4 // 4
    h = torch.zeros(B, H, dtype=torch.float32, device=xp.device)
    c = torch.zeros_like(h)
    out = torch.empty(B, T, H, dtype=xp.dtype, device=xp.device)
    U32 = U.float()  # exact: a bf16 x bf16 product is exact in float32
    m_all = mask.to(torch.float32)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
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
    return out


def lstm_layer(params: dict, x: torch.Tensor, mask: torch.Tensor,
               reverse: bool = False, use_kernel: bool = True) -> torch.Tensor:
    """Single-direction LSTM layer. x: (B, T, I) -> (B, T, H).

    use_kernel=False runs ``lstm_scan_plain`` on any device (the reference a
    kernel run is held against); the default goes by the tensor's device.
    """
    xp = torch.matmul(x, params["W"]) + params["b"]
    if not use_kernel:
        return lstm_scan_plain(xp, params["U"], mask, reverse)
    from .cuda_lstm import lstm_scan

    return lstm_scan(xp, params["U"], mask, reverse)


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
