"""The port's flash-attention gradient (ops/flash_attn.py: the residual
form of ``mhsa_plain``, ``mhsa_bwd_plain`` and the ``FlashAttention``
autograd Function, plain versions on the CPU) vs the JAX side, on the same
numpy arrays.

- l and m of the residual form vs ``mha_reference_no_custom_vjp(...,
  save_residuals=True)``, the library's reference, with SegmentIds(seg,
  seg): rtol 1e-6 plus atol 1e-5 on l (a sum of up to T terms in [0, 1]
  in another order), m exact up to float32 rounding of the scores (atol
  1e-5).
- ``mhsa_bwd_plain`` vs the library's own Pallas backward kernels
  (``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq``), run by
  ``jax.vjp`` of ``flash_attention`` under Pallas TPU interpret mode (T a
  multiple of their 128-row blocks). float32: atol 1e-5 (the same
  operations, summation order only; ~4e-7 seen). bfloat16: the two
  forwards round o to bf16 from differently ordered float32 sums, so di
  and then dq, dk may land one bf16 ulp apart: atol 2^-7 x max|grad|.
- the Function's gradients at an odd T vs ``jax.grad`` of the reference,
  float32, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds, flash_attention, mha_reference_no_custom_vjp)

from pg_asr_tpu_torch.ops import cuda_flash_attn, flash_attn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, lens, H=2, dh=32):
    rng = np.random.default_rng(seed)
    B, T = len(lens), max(lens)
    q, k, v, do = (rng.standard_normal((B, H, T, dh)).astype(np.float32)
                   for _ in range(4))
    valid = np.arange(T)[None] < np.array(lens)[:, None]
    return q, k, v, do, valid


def _seg(valid):
    seg = jnp.asarray(valid.astype(np.int32))
    return SegmentIds(q=seg, kv=seg)


def _counts():
    return (cuda_flash_attn.LAUNCHES, cuda_flash_attn.RES_LAUNCHES,
            cuda_flash_attn.DKV_LAUNCHES, cuda_flash_attn.DQ_LAUNCHES)


@pytest.mark.parametrize("dh", [32, 64])
def test_residual_form_matches_the_reference_l_and_m(dh):
    q, k, v, _, valid = _case(dh, (37, 1, 20, 36), dh=dh)
    scale = dh ** -0.5
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o, l, m = flash_attn.mhsa_plain(*t, torch.from_numpy(valid), scale,
                                    residuals=True)
    assert l.dtype == m.dtype == torch.float32 and l.shape == m.shape == (
        4, 2, 37)
    torch.testing.assert_close(o, flash_attn.mhsa_plain(
        *t, torch.from_numpy(valid), scale), rtol=0, atol=0)
    r_o, r_l, r_m = mha_reference_no_custom_vjp(
        *(jnp.asarray(a) for a in (q, k, v)), segment_ids=_seg(valid),
        sm_scale=scale, save_residuals=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(r_o), rtol=0, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(r_l), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(r_m), rtol=0, atol=1e-5)
    # padded query rows are real rows: their max runs over the padded keys
    assert np.all(l.numpy() >= 1.0)


@pytest.mark.parametrize("dh,dtype", [(32, "float32"), (64, "float32"),
                                      (64, "bfloat16")])
def test_bwd_plain_matches_the_pallas_backward_kernels(dh, dtype):
    # T = 128, one block of the library kernels; a full row and a row of 1
    q, k, v, do, valid = _case(7 + dh, (128, 1), dh=dh)
    scale = dh ** -0.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    def f(q, k, v):
        return flash_attention(q, k, v, segment_ids=_seg(valid),
                               sm_scale=scale)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in (q, k, v)))
        ref = vjp(jnp.asarray(do, jdt))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    tvalid = torch.from_numpy(valid)
    o, l, m = flash_attn.mhsa_plain(tq, tk, tv, tvalid, scale,
                                    residuals=True)
    got = flash_attn.mhsa_bwd_plain(tq, tk, tv, tvalid, o, l, m, tdo, scale)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == tdt and g.shape == tq.shape, name
        r = np.asarray(r, np.float32)
        atol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(r).max()
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("dh", [32, 64])
def test_function_gradients_match_jax_grad_of_the_reference(dh):
    q, k, v, do, valid = _case(dh + 1, (37, 1, 20), dh=dh)
    scale = dh ** -0.5
    before = _counts()
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = flash_attn.mhsa(*leaves, torch.from_numpy(valid), scale)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    assert _counts() == before  # CPU tensors launch nothing

    def loss(q, k, v):
        out = mha_reference_no_custom_vjp(q, k, v, segment_ids=_seg(valid),
                                          sm_scale=scale)
        return jnp.sum(out * jnp.asarray(do))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(
        mha_reference_no_custom_vjp(*(jnp.asarray(a) for a in (q, k, v)),
                                    segment_ids=_seg(valid),
                                    sm_scale=scale)), rtol=0, atol=1e-5)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_mhsa_keeps_the_inference_form_without_grad():
    q, k, v, _, valid = _case(3, (9, 4))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    with torch.no_grad():
        out = flash_attn.mhsa(*t, torch.from_numpy(valid), 0.2)
    assert out.grad_fn is None
    out = flash_attn.mhsa(*(x.detach() for x in t), torch.from_numpy(valid),
                          0.2)
    assert out.grad_fn is None
    # use_kernel=False is the same plain path on the CPU
    a = flash_attn.mhsa(*t, torch.from_numpy(valid), 0.2, use_kernel=False)
    b = flash_attn.mhsa(*t, torch.from_numpy(valid), 0.2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_launchers_refuse_cpu_tensors():
    q, k, v, do, valid = (torch.from_numpy(a) for a in _case(0, (9, 4)))
    l = m = di = torch.ones(2, 2, 9)
    before = _counts()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash_attn.flash_attn_cuda(q, k, v, valid, 0.25, residuals=True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash_attn.flash_attn_bwd_dkv_cuda(q, k, v, valid, l, m, do, di,
                                                0.25)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash_attn.flash_attn_bwd_dq_cuda(q, k, v, valid, l, m, do, di,
                                               0.25)
    assert _counts() == before


def _segment_ids(kind, T, rng):
    """(B, T) int32 segment ids: ragged valid masks (lengths 1, 64, 65, 128
    and T beside random ones: whole 64-row tiles of padding), or runs of
    random int32 ids, sorted in one row (most tile pairs disjoint), in
    random order in another, and the extremes of int32 in a third."""
    if kind == "ragged":
        lens = np.array([1, 64, 65, 128, T, *rng.integers(1, T + 1, 3)])
        return torch.from_numpy(np.arange(T)[None] < lens[:, None]).to(
            torch.int32)
    info = np.iinfo(np.int32)
    rows = []
    for r in range(3):
        cuts = np.sort(rng.choice(np.arange(1, T), 7, replace=False))
        ids = rng.integers(info.min, info.max, 8, dtype=np.int64,
                           endpoint=True)
        if r == 0:
            ids = np.sort(ids)
        if r == 2:
            ids[:4] = (info.min, info.max, info.min, info.max)
        rows.append(np.repeat(ids, np.diff(np.r_[0, cuts, T])))
    return torch.from_numpy(np.stack(rows).astype(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["ragged", "random_int32"])
def test_skipped_tile_pairs_change_no_bit(kind, dtype):
    """ops/flash_attn.kept_tile_pairs, the rule by which the backward
    kernels skip (query tile, key tile) pairs at T = 201 with 64-row
    tiles: p and ds are exactly 0 on every skipped pair, and the plain
    backward restricted to the kept pairs equals the full one bit for
    bit."""
    T, H, dh, tile = 201, 2, 32, flash_attn.BWD_TILE
    rng = np.random.default_rng(11)
    seg = _segment_ids(kind, T, rng)
    B = seg.shape[0]
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, H, T, dh)).astype(np.float32)).to(dtype) for _ in range(4))
    kept = flash_attn.kept_tile_pairs(seg)
    n = -(-T // tile)
    assert kept.shape == (B, n, n) and kept.dtype == torch.bool
    # every tile meets itself; the cases skip some pairs
    assert kept.diagonal(dim1=1, dim2=2).all() and not kept.all()
    idx = torch.arange(T) // tile
    keep = kept[:, idx][:, :, idx][:, None]  # (B, 1, T, T) of (query, key)
    scale = dh ** -0.5
    o, l, m = flash_attn.mhsa_plain(q, k, v, seg, scale, residuals=True)
    p, ds = flash_attn.bwd_p_ds(q, k, v, seg, o, l, m, do, scale)
    skip = (~keep).expand_as(p)
    assert torch.all(p[skip] == 0) and torch.all(ds[skip] == 0)
    full = flash_attn.mhsa_bwd_plain(q, k, v, seg, o, l, m, do, scale)
    part = flash_attn.bwd_products(q, k, do, torch.where(keep, p, 0.0),
                                   torch.where(keep, ds, 0.0))
    for name, a, b in zip(("dq", "dk", "dv"), part, full):
        assert torch.equal(a, b), name
