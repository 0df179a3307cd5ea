"""The port's fused RNN-T joint (pg_asr_tpu_torch/ops/joint.py: the plain
versions of the joint kernels and their autograd) vs the JAX package's
Pallas kernels (pg_asr_tpu/ops/pallas_joint.py) run in interpret mode on
the CPU, on the same seeded numpy inputs.

Sizes: B=3, J=32, A=8, U=6, T=11 and 16 (not a multiple and a multiple of
the Pallas T-tile). Tolerances, those of tests/test_pallas_joint.py: the
emission tables rtol 1e-5, atol 1e-5 (float32 math in both, summation
order only, whatever the inputs' type); the gradients rtol 2e-4, atol
2e-5 in float32. In bfloat16 the gradients are float32 sums rounded once
to bf16 in both, so they may land one bf16 ulp apart: atol 2^-7 x max|grad|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu.ops.pallas_joint import fused_joint_log_probs
from pg_asr_tpu_torch.ops import cuda_joint
from pg_asr_tpu_torch.ops.joint import (FusedJoint, fused_joint,
                                        fused_joint_bwd_plain,
                                        fused_joint_plain)
from pg_asr_tpu_torch.ops.transducer import joint_log_probs

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make(B=3, T=11, U=6, J=32, A=8, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((B, T, J)).astype(np.float32) * 0.5
    g = rng.standard_normal((B, U + 1, J)).astype(np.float32) * 0.5
    W = rng.standard_normal((J, A)).astype(np.float32) * 0.2
    b = rng.standard_normal((A,)).astype(np.float32) * 0.1
    labels = rng.integers(1, A, (B, U)).astype(np.int32)
    labels[1, 4:] = 0  # a padded label row
    gb = rng.standard_normal((B, T, U + 1)).astype(np.float32)
    gy = rng.standard_normal((B, T, U)).astype(np.float32)
    return (e, g, W, b), labels, gb, gy


def _jax_tables(arrays, labels, jdt):
    A = arrays[2].shape[1]
    onehot = jax.nn.one_hot(jnp.asarray(labels), A, dtype=jnp.float32)
    j = [jnp.asarray(x, jdt) for x in arrays]
    return [np.asarray(o) for o in fused_joint_log_probs(*j, onehot, True)]


def _jax_grads(arrays, labels, gb, gy, jdt):
    A = arrays[2].shape[1]
    onehot = jax.nn.one_hot(jnp.asarray(labels), A, dtype=jnp.float32)

    def obj(*p):
        lb, ly = fused_joint_log_probs(*p, onehot, True)
        return jnp.sum(lb * gb) + jnp.sum(ly * gy)

    grads = jax.grad(obj, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x, jdt) for x in arrays))
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [11, 16])
def test_plain_forward_matches_pallas_interpret(T, dtype):
    _, jdt, tdt = DTYPES[dtype]
    arrays, labels, _, _ = _make(T=T)
    ref_b, ref_y = _jax_tables(arrays, labels, jdt)
    got_b, got_y = fused_joint_plain(
        *(torch.from_numpy(x).to(tdt) for x in arrays),
        torch.from_numpy(labels))
    assert got_b.dtype == got_y.dtype == torch.float32
    np.testing.assert_allclose(got_b.numpy(), ref_b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_y.numpy(), ref_y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", [11, 16])
def test_plain_forward_matches_the_unfused_composition(T):
    """float32: the fused tables equal joint_log_probs of the 4-D logits."""
    arrays, labels, _, _ = _make(T=T)
    e, g, W, b = (torch.from_numpy(x) for x in arrays)
    lab = torch.from_numpy(labels)
    logits = torch.tanh(e[:, :, None] + g[:, None]) @ W + b
    ref_b, ref_y = joint_log_probs(logits, lab)
    got_b, got_y = fused_joint_plain(e, g, W, b, lab)
    torch.testing.assert_close(got_b, ref_b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_y, ref_y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [11, 16])
def test_plain_backward_matches_pallas_interpret(T, dtype):
    """fused_joint_bwd_plain, and the gradients of FusedJoint under
    autograd, vs jax.grad through the Pallas kernels' custom VJP."""
    _, jdt, tdt = DTYPES[dtype]
    arrays, labels, gb, gy = _make(T=T, seed=3)
    ref = _jax_grads(arrays, labels, gb, gy, jdt)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(True)
              for x in arrays]
    lab = torch.from_numpy(labels)
    direct = fused_joint_bwd_plain(*(x.detach() for x in leaves), lab,
                                   torch.from_numpy(gb), torch.from_numpy(gy))
    lb, ly = fused_joint(*leaves, lab)
    (lb * torch.from_numpy(gb)).sum().add((ly * torch.from_numpy(gy)).sum()
                                          ).backward()
    for name, d, leaf, r in zip(("de", "dg", "dW", "db"), direct, leaves,
                                ref):
        assert d.dtype == leaf.grad.dtype == tdt, name
        torch.testing.assert_close(leaf.grad, d, rtol=0, atol=0)
        if dtype == "float32":
            np.testing.assert_allclose(d.numpy(), r, rtol=2e-4, atol=2e-5,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(d.float().numpy(), r, rtol=0,
                                       atol=2.0 ** -7 * np.abs(r).max(),
                                       err_msg=name)


def test_no_label_rows():
    """U = 0: only the blank table; the backward gives dg for the one
    prediction row and no label cotangent (held against the unfused
    composition under autograd)."""
    arrays, _, gb, _ = _make(U=0)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in arrays]
    lab = torch.zeros(3, 0, dtype=torch.int32)
    lb, ly = fused_joint(*leaves, lab)
    assert lb.shape == (3, 11, 1) and ly.shape == (3, 11, 0)
    (lb * torch.from_numpy(gb)).sum().backward()
    ref_leaves = [torch.from_numpy(x).requires_grad_(True) for x in arrays]
    e, g, W, b = ref_leaves
    rb, _ = joint_log_probs(torch.tanh(e[:, :, None] + g[:, None]) @ W + b,
                            lab)
    torch.testing.assert_close(lb, rb, rtol=1e-5, atol=1e-5)
    (rb * torch.from_numpy(gb)).sum().backward()
    for leaf, ref in zip(leaves, ref_leaves):
        torch.testing.assert_close(leaf.grad, ref.grad, rtol=2e-4, atol=2e-5)


def test_cpu_tensors_run_the_plain_versions_and_never_launch():
    arrays, labels, _, _ = _make()
    before = (cuda_joint.FWD_LAUNCHES, cuda_joint.BWD_LAUNCHES)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in arrays]
    for use_kernel in (True, False):
        lb, ly = FusedJoint.apply(*leaves, torch.from_numpy(labels),
                                  use_kernel)
        (lb.sum() + ly.sum()).backward()
    assert (cuda_joint.FWD_LAUNCHES, cuda_joint.BWD_LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        cuda_joint.joint_fwd_cuda(*(torch.from_numpy(x) for x in arrays),
                                  torch.from_numpy(labels))


def test_plain_versions_chunk_over_t(monkeypatch):
    """A chunk of one frame gives the same tables and gradients as one
    chunk (the chunks split frames, never a sum)."""
    import pg_asr_tpu_torch.ops.joint as joint_mod

    arrays, labels, gb, gy = _make(T=5)
    args = [torch.from_numpy(x) for x in arrays] + [torch.from_numpy(labels)]
    cot = (torch.from_numpy(gb), torch.from_numpy(gy))
    whole = fused_joint_plain(*args), fused_joint_bwd_plain(*args, *cot)
    monkeypatch.setattr(joint_mod, "_CHUNK", 1)
    parts = fused_joint_plain(*args), fused_joint_bwd_plain(*args, *cot)
    for w, p in zip(whole[0] + whole[1][:1], parts[0] + parts[1][:1]):
        torch.testing.assert_close(p, w, rtol=0, atol=0)
    for w, p in zip(whole[1][1:], parts[1][1:]):  # sums over chunks
        torch.testing.assert_close(p, w, rtol=1e-6, atol=1e-6)


def _bwd_in_block_order(e, g, W, bias, labels, gb, gy, nc):
    """The joint backward with csrc/joint_bwd.cu's partition, float32: one
    block per (utterance, u-tile of 32 rows) walks the frames in tiles of
    ``nc`` cells (nc / 32 frames x 32 rows); z = h . W as the shuffle tree
    of 32 // (nc // 4) slices of j adds them, + bias; per tile dW += h^T
    dz and db += dz (in the block), de of a frame summed over the tile's
    rows (a partial per u-tile), dg of a row over the frames in order; the
    u-tiles' de partials and the blocks' dW, db partials added in order ->
    (de, dg, dW, db) in the inputs' types."""
    B, T, J = e.shape
    U1, A = g.shape[1], W.shape[1]
    U, frames = U1 - 1, nc // 32
    e32, g32, W32, b32 = e.float(), g.float(), W.float(), bias.float()
    nks = 32 // (nc // 4)
    jl = -(-J // nks)
    slices = [slice(min(J, k * jl), min(J, k * jl + jl)) for k in range(nks)]
    n_ut = -(-U1 // 32)
    de_part = torch.zeros(n_ut, B, T, J)
    dg = torch.zeros(B, U1, J)
    dW, db = torch.zeros(J, A), torch.zeros(A)
    for b in range(B):
        for ut in range(n_ut):
            us = torch.arange(ut * 32, min(U1, ut * 32 + 32))
            dw_blk, db_blk = torch.zeros(J, A), torch.zeros(A)
            for t0 in range(0, T, frames):
                ts = torch.arange(t0, min(T, t0 + frames))
                h = torch.tanh(e32[b, ts][:, None] + g32[b, us][None])
                parts = [h[..., s] @ W32[s] for s in slices]
                while len(parts) > 1:  # xor 16 first: slices k and k + n/2
                    half = len(parts) // 2
                    parts = [parts[k] + parts[k + half] for k in range(half)]
                z = parts[0] + b32
                p = torch.softmax(z, -1)
                gbc = gb[b][ts][:, us]
                gyc = torch.nn.functional.pad(gy[b][ts], (0, 1))[:, us]
                oh = torch.zeros(len(us), A)
                lab_rows = us[us < U]
                oh[:len(lab_rows)].scatter_(
                    -1, labels[b, lab_rows].long()[:, None], 1.0)
                dz = (gbc[..., None] * (torch.arange(A) == 0)
                      + gyc[..., None] * oh - (gbc + gyc)[..., None] * p)
                dw_blk = dw_blk + torch.einsum("fuj,fua->ja", h, dz)
                db_blk = db_blk + dz.sum((0, 1))
                dpre = (dz @ W32.T) * (1.0 - h * h)
                de_part[ut, b, ts] = dpre.sum(1)
                for f in range(len(ts)):
                    dg[b, us] += dpre[f]
            dW, db = dW + dw_blk, db + db_blk
    de = sum(de_part[k] for k in range(n_ut))
    return (de.to(e.dtype), dg.to(g.dtype), dW.to(W.dtype),
            db.to(bias.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# tiles of 128, 64 and 32 cells (4, 2 and 1 frames): z's j in 1, 2 and 4
# slices; T = 11 not a multiple of the tile's frames, U+1 = 41 two u-tiles
# (the second ragged), A = 9 a padded vocab group
@pytest.mark.parametrize("nc", [128, 64, 32])
def test_backward_in_the_block_kernels_order(nc, dtype):
    """The partition of csrc/joint_bwd.cu stays within the stated
    tolerances of jax.grad through the Pallas kernels (interpret mode) and
    of the plain backward: float32 rtol 2e-4, atol 2e-5 (summation order
    only); bfloat16 atol 2^-7 x max|grad| (each a float32 sum rounded once
    to bf16)."""
    _, jdt, tdt = DTYPES[dtype]
    arrays, labels, gb, gy = _make(T=11, U=40, J=32, A=9, seed=5)
    ref = _jax_grads(arrays, labels, gb, gy, jdt)
    args = [torch.from_numpy(x).to(tdt) for x in arrays]
    lab = torch.from_numpy(labels)
    cot = (torch.from_numpy(gb), torch.from_numpy(gy))
    got = _bwd_in_block_order(*args, lab, *cot, nc)
    plain = fused_joint_bwd_plain(*args, lab, *cot)
    for name, d, p, r in zip(("de", "dg", "dW", "db"), got, plain, ref):
        assert d.dtype == tdt, name
        d, p = d.float().numpy(), p.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(d, r, rtol=2e-4, atol=2e-5,
                                       err_msg=f"{name} vs Pallas")
            np.testing.assert_allclose(d, p, rtol=2e-4, atol=2e-5,
                                       err_msg=f"{name} vs plain")
        else:
            for want, what in ((r, "Pallas"), (p, "plain")):
                np.testing.assert_allclose(
                    d, want, rtol=0, atol=2.0 ** -7 * np.abs(want).max(),
                    err_msg=f"{name} vs {what}")


# --- vocabularies past one chunk of 32 columns and joint dims past one
# piece of 256: the kernels' chunked forms (csrc/joint.cuh)

def _lse_in_chunks(z):
    """The logsumexp of csrc/joint.cuh's CellPair: over vocab chunks of 32,
    a running max m and sum s, s = s exp(m - m') + sum exp(z - m')."""
    m = torch.full(z.shape[:-1], -float("inf"))
    s = torch.zeros(z.shape[:-1])
    for c0 in range(0, z.shape[-1], 32):
        zc = z[..., c0:c0 + 32]
        nm = torch.maximum(m, zc.amax(-1))
        s = s * torch.exp(m - nm) + torch.exp(zc - nm[..., None]).sum(-1)
        m = nm
    return m + torch.log(s)


def _fwd_in_chunk_order(e, g, W, bias, labels):
    """csrc/joint_fwd.cu's tables, float32: z summed over J piece by piece
    (256 columns each) in one running sum, + bias, the chunked lse."""
    e32, g32, W32 = e.float(), g.float(), W.float()
    h = torch.tanh(e32[:, :, None] + g32[:, None])
    z = torch.zeros(*h.shape[:-1], W.shape[1])
    for j0 in range(0, W.shape[0], 256):
        z = z + h[..., j0:j0 + 256] @ W32[j0:j0 + 256]
    z = z + bias.float()
    lse = _lse_in_chunks(z)
    U = labels.shape[1]
    zy = torch.gather(z[:, :, :U], -1,
                      labels.long()[:, None, :, None].expand(
                          -1, z.shape[1], -1, 1))[..., 0]
    return z[..., 0] - lse, zy - lse[..., :U]


def _bwd_in_chunk_order(e, g, W, bias, labels, gb, gy):
    """csrc/joint_bwd.cu's chunked form, float32: one block per (utterance,
    u-tile of 32 rows) walks the frames in tiles of 64 cells (2 frames);
    per tile the chunked lse, then per vocab chunk of 32 its dz, db += dz,
    dW[:, chunk] += h^T dz, and dpre_chunk = (dz . W_chunk^T)(1 - h^2)
    added to de (per frame: a partial per u-tile) and dg (per row) chunk
    by chunk; the partials added in order."""
    B, T, J = e.shape
    U1, A = g.shape[1], W.shape[1]
    U = U1 - 1
    e32, g32, W32, b32 = e.float(), g.float(), W.float(), bias.float()
    n_ut = -(-U1 // 32)
    de_part = torch.zeros(n_ut, B, T, J)
    dg = torch.zeros(B, U1, J)
    dW, db = torch.zeros(J, A), torch.zeros(A)
    for b in range(B):
        for ut in range(n_ut):
            us = torch.arange(ut * 32, min(U1, ut * 32 + 32))
            dw_blk, db_blk = torch.zeros(J, A), torch.zeros(A)
            for t0 in range(0, T, 2):
                ts = torch.arange(t0, min(T, t0 + 2))
                h = torch.tanh(e32[b, ts][:, None] + g32[b, us][None])
                z = h @ W32 + b32
                m_lse = _lse_in_chunks(z)
                gbc = gb[b][ts][:, us]
                gyc = torch.nn.functional.pad(gy[b][ts], (0, 1))[:, us]
                oh = torch.zeros(len(us), A)
                lab_rows = us[us < U]
                oh[:len(lab_rows)].scatter_(
                    -1, labels[b, lab_rows].long()[:, None], 1.0)
                for c0 in range(0, A, 32):
                    cs = slice(c0, c0 + 32)
                    p = torch.exp(z[..., cs] - m_lse[..., None])
                    dz = (gbc[..., None] * (torch.arange(A)[cs] == 0)
                          + gyc[..., None] * oh[:, cs]
                          - (gbc + gyc)[..., None] * p)
                    db_blk[cs] += dz.sum((0, 1))
                    dw_blk[:, cs] += torch.einsum("fuj,fua->ja", h, dz)
                    dpre = (dz @ W32[:, cs].T) * (1.0 - h * h)
                    de_part[ut, b, ts] += dpre.sum(1)
                    dg[b, us] += dpre.sum(0)
            dW, db = dW + dw_blk, db + db_blk
    de = sum(de_part[k] for k in range(n_ut))
    return (de.to(e.dtype), dg.to(g.dtype), dW.to(W.dtype),
            db.to(bias.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# vocabularies over one chunk (40: a ragged second chunk; 96: three)
@pytest.mark.parametrize("A", [40, 96])
def test_plain_wide_vocab_matches_pallas_interpret(A, dtype):
    """fused_joint_plain and fused_joint_bwd_plain at A past the first
    kernels' limit of 32 and J=72, vs the Pallas kernels in interpret mode,
    with the tolerances of the module docstring."""
    _, jdt, tdt = DTYPES[dtype]
    arrays, labels, gb, gy = _make(B=2, T=9, U=5, J=72, A=A, seed=A)
    args = [torch.from_numpy(x).to(tdt) for x in arrays]
    lab = torch.from_numpy(labels)
    for got, ref in zip(fused_joint_plain(*args, lab),
                        _jax_tables(arrays, labels, jdt)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    ref = _jax_grads(arrays, labels, gb, gy, jdt)
    got = fused_joint_bwd_plain(*args, lab, torch.from_numpy(gb),
                                torch.from_numpy(gy))
    for name, d, r in zip(("de", "dg", "dW", "db"), got, ref):
        d = d.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(d, r, rtol=2e-4, atol=2e-5,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(d, r, rtol=0,
                                       atol=2.0 ** -7 * np.abs(r).max(),
                                       err_msg=name)


# A = 9 inside one chunk; 40 and 96 over two and three; J = 300 two pieces
@pytest.mark.parametrize("A,J", [(9, 32), (40, 72), (96, 72), (40, 300)])
def test_forward_in_the_chunked_kernels_order(A, J):
    """csrc/joint_fwd.cu's order (J in pieces of 256, the logsumexp carried
    over vocab chunks of 32) within the stated tolerances (rtol 1e-5, atol
    1e-5) of the Pallas kernel in interpret mode and of the plain
    forward."""
    arrays, labels, _, _ = _make(B=2, T=5, U=4, J=J, A=A, seed=J + A)
    args = [torch.from_numpy(x) for x in arrays]
    lab = torch.from_numpy(labels)
    got = _fwd_in_chunk_order(*args, lab)
    for g, p, r in zip(got, fused_joint_plain(*args, lab),
                       _jax_tables(arrays, labels, jnp.float32)):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("A,J", [(40, 72), (96, 72), (40, 300)])
def test_backward_in_the_chunked_kernels_order(A, J, dtype):
    """The partition of csrc/joint_bwd.cu's chunked form (A > 32 or J >
    512) within the stated tolerances of jax.grad through the Pallas
    kernels (interpret mode) and of the plain backward: float32 rtol 2e-4,
    atol 2e-5; bfloat16 atol 2^-7 x max|grad|. T = 5 is not a multiple of
    the tile's 2 frames; U+1 = 34 is two u-tiles."""
    _, jdt, tdt = DTYPES[dtype]
    arrays, labels, gb, gy = _make(B=2, T=5, U=33, J=J, A=A, seed=7 + A)
    ref = _jax_grads(arrays, labels, gb, gy, jdt)
    args = [torch.from_numpy(x).to(tdt) for x in arrays]
    lab = torch.from_numpy(labels)
    cot = (torch.from_numpy(gb), torch.from_numpy(gy))
    got = _bwd_in_chunk_order(*args, lab, *cot)
    plain = fused_joint_bwd_plain(*args, lab, *cot)
    for name, d, p, r in zip(("de", "dg", "dW", "db"), got, plain, ref):
        assert d.dtype == tdt, name
        d, p = d.float().numpy(), p.float().numpy()
        for want, what in ((r, "Pallas"), (p, "plain")):
            if dtype == "float32":
                np.testing.assert_allclose(d, want, rtol=2e-4, atol=2e-5,
                                           err_msg=f"{name} vs {what}")
            else:
                np.testing.assert_allclose(
                    d, want, rtol=0, atol=2.0 ** -7 * np.abs(want).max(),
                    err_msg=f"{name} vs {what}")
