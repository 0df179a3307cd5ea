"""Fused RNN-T joint: projections -> emission log-probs without the 4-D
joint tensor (counterpart of pg_asr_tpu/ops/pallas_joint.py).

Per lattice cell (b, t, u), all in float32 whatever the inputs' type:
    h    = tanh(e[b, t] + g[b, u])                      (J,)
    z    = h @ W + bias                                 (A,)
    lp_blank[b, t, u] = z[0]      - logsumexp(z)        u = 0 .. U
    lp_label[b, t, u] = z[y_u]    - logsumexp(z)        u = 0 .. U-1
Backward, with the output cotangents gb (B, T, U+1) and gy (B, T, U):
    dz   = gb * 1[a = 0] + gy * 1[a = y_u] - (gb + gy) * softmax(z)
           (u = U has no label cotangent)
    dpre = (dz @ W^T) * (1 - h^2)
    de = sum_u dpre, dg = sum_t dpre, dW = h^T dz, db = sum dz,
each cast to its input's dtype at the end.

On CUDA tensors the hand-written kernels run (``ops/cuda_joint``:
csrc/joint_fwd.cu, csrc/joint_bwd.cu), on CPU tensors the plain PyTorch
versions below, a choice made in ``FusedJoint`` and nowhere else;
``use_kernel=False`` runs the plain versions on any device. Labels enter
as int ids: the logit of y_u is gathered, which equals the Pallas kernel's
one-hot product. T needs no padding (the Pallas T_BLK tiling is a TPU
constraint).
"""

from __future__ import annotations

import torch

from . import cuda_joint

# lattice cells x J per chunk of the plain versions (bounds their memory:
# 2^24 float32 = 64 MB per live (cells, J) tensor)
_CHUNK = 1 << 24


def _t_chunk(B: int, U1: int, J: int) -> int:
    return max(1, _CHUNK // max(1, B * U1 * J))


def _head(h, W32, b32):
    return torch.matmul(h, W32) + b32


def fused_joint_plain(e: torch.Tensor, g: torch.Tensor, W: torch.Tensor,
                      bias: torch.Tensor, labels: torch.Tensor):
    """Plain version of the joint forward kernel: e (B, T, J), g (B, U+1,
    J), W (J, A), bias (A,), labels (B, U) int -> (lp_blank (B, T, U+1),
    lp_label (B, T, U)), float32; chunked over T."""
    B, T, J = e.shape
    U1 = g.shape[1]
    U = U1 - 1
    g32, W32, b32 = g.float(), W.float(), bias.float()
    idx = labels.long()[:, None, :, None]
    lpb = torch.empty(B, T, U1, dtype=torch.float32, device=e.device)
    lpy = torch.empty(B, T, U, dtype=torch.float32, device=e.device)
    step = _t_chunk(B, U1, J)
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        h = torch.tanh(e[:, t0:t1, None, :].float() + g32[:, None])
        z = _head(h, W32, b32)  # (B, tc, U+1, A)
        lse = torch.logsumexp(z, dim=-1)
        lpb[:, t0:t1] = z[..., 0] - lse
        zy = torch.gather(z[:, :, :U], -1,
                          idx.expand(B, t1 - t0, U, 1))[..., 0]
        lpy[:, t0:t1] = zy - lse[:, :, :U]
    return lpb, lpy


def fused_joint_bwd_plain(e: torch.Tensor, g: torch.Tensor, W: torch.Tensor,
                          bias: torch.Tensor, labels: torch.Tensor,
                          gb: torch.Tensor, gy: torch.Tensor):
    """Plain version of the joint backward kernel: the forward's inputs and
    the cotangents gb (B, T, U+1), gy (B, T, U) -> (de, dg, dW, db), summed
    in float32 and cast to e's, g's, W's and bias's dtypes."""
    B, T, J = e.shape
    U1 = g.shape[1]
    U = U1 - 1
    A = W.shape[1]
    g32, W32, b32 = g.float(), W.float(), bias.float()
    onehot = torch.zeros(B, U1, A, dtype=torch.float32, device=e.device)
    onehot[:, :U].scatter_(-1, labels.long()[..., None], 1.0)
    blank = torch.zeros(A, dtype=torch.float32, device=e.device)
    blank[0] = 1.0
    de = torch.empty(B, T, J, dtype=torch.float32, device=e.device)
    dg = torch.zeros(B, U1, J, dtype=torch.float32, device=e.device)
    dW = torch.zeros(J, A, dtype=torch.float32, device=e.device)
    db = torch.zeros(A, dtype=torch.float32, device=e.device)
    step = _t_chunk(B, U1, J)
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        h = torch.tanh(e[:, t0:t1, None, :].float() + g32[:, None])
        p = torch.softmax(_head(h, W32, b32), dim=-1)
        gbc = gb[:, t0:t1].float()
        gy1 = torch.nn.functional.pad(gy[:, t0:t1].float(), (0, 1))
        dz = (gbc[..., None] * blank + gy1[..., None] * onehot[:, None]
              - (gbc + gy1)[..., None] * p)  # (B, tc, U+1, A)
        dpre = torch.matmul(dz, W32.T) * (1.0 - h * h)
        de[:, t0:t1] = dpre.sum(dim=2)
        dg += dpre.sum(dim=1)
        dW += torch.einsum("btuj,btua->ja", h, dz)
        db += dz.sum(dim=(0, 1, 2))
    return (de.to(e.dtype), dg.to(g.dtype), dW.to(W.dtype),
            db.to(bias.dtype))


class FusedJoint(torch.autograd.Function):
    """The fused joint under autograd (counterpart of the custom VJP of
    ``fused_joint_log_probs``): the forward kernel, then the backward
    kernel, which recomputes h and softmax(z) per cell instead of keeping
    the (B, T, U+1, J) joint. Kernels on CUDA tensors unless
    ``use_kernel`` is False, plain versions otherwise."""

    @staticmethod
    def forward(ctx, e, g, W, bias, labels, use_kernel: bool):
        kernel = use_kernel and e.is_cuda
        fwd = cuda_joint.joint_fwd_cuda if kernel else fused_joint_plain
        lpb, lpy = fwd(e, g, W, bias, labels)
        ctx.save_for_backward(e, g, W, bias, labels)
        ctx.kernel = kernel
        return lpb, lpy

    @staticmethod
    def backward(ctx, gb, gy):
        e, g, W, bias, labels = ctx.saved_tensors
        bwd = cuda_joint.joint_bwd_cuda if ctx.kernel else fused_joint_bwd_plain
        de, dg, dW, db = bwd(e, g, W, bias, labels, gb.contiguous(),
                             gy.contiguous())
        return de, dg, dW, db, None, None


def fused_joint(e: torch.Tensor, g: torch.Tensor, W: torch.Tensor,
                bias: torch.Tensor, labels: torch.Tensor,
                use_kernel: bool = True):
    """(lp_blank (B, T, U+1), lp_label (B, T, U)) float32 of the joint
    tanh(e + g) @ W + bias over the whole lattice; see the module
    docstring."""
    return FusedJoint.apply(e, g, W, bias, labels, use_kernel)
