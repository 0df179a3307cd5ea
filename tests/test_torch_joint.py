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
