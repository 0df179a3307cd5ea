"""The port's segment-masked attention (ops/flash_attn.py, plain version on
the CPU) vs the JAX side, on the same numpy arrays.

- ``mhsa_plain`` vs the pure-jnp reference of JAX's library Pallas flash
  attention (``mha_reference_no_custom_vjp`` with SegmentIds(seg, seg)), on
  every row, padded queries included. The Pallas kernel itself runs only
  on a TPU; this is its reference. float32: atol 1e-5 (the same softmax
  of the same float32 scores, summation order only). bfloat16: the
  reference is run on the bf16 inputs widened to float32 (in bf16 it would
  keep its scores in bf16, which is not the kernel's function); the port
  rounds p to bf16 before p . v and the output to bf16, two roundings of
  at most 2^-9 relative each, so atol 2^-7 x max|v|.
- the forward kernels' walk (csrc/flash_attn.cu), test-local in float32:
  the online softmax over 64 x 64 tiles that skips the tile pairs
  ``kept_tile_pairs`` drops equals the walk over every pair bit for bit
  (o, l, m), on ragged masks and random int32 segment ids; at T = 256 it
  matches the library's Pallas forward in TPU interpret mode, atol 1e-5
  (float32 summation order only).
- the port's ``_mhsa`` / ``_mhsa_rotary`` with the segment-masked path vs
  JAX's dense ``_mhsa`` / ``_mhsa_rotary`` (float32 softmax) on the valid
  query rows, atol 1e-5: the two differ only on padded rows (a padded query
  attends the padded keys in one and the valid keys in the other), which
  every consumer masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds, flash_attention, mha_reference_no_custom_vjp)

from pg_asr_tpu.config import ConformerConfig, ModelConfig, TransformerConfig
from pg_asr_tpu.models import conformer_ctc as jax_conformer
from pg_asr_tpu.models import transformer_ctc as jax_transformer
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.models import conformer_ctc, transformer_ctc
from pg_asr_tpu_torch.ops import cuda_flash_attn, flash_attn


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ragged: a full-length row, a length-1 row, two in between
LENS = (37, 1, 20, 36)


def _qkv(seed, B=4, H=2, T=37, dh=32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, T, dh)).astype(np.float32)
               for _ in range(3))
    valid = np.arange(T)[None] < np.array(LENS[:B])[:, None]
    return q, k, v, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64])
def test_mhsa_plain_matches_the_segment_id_reference(dtype, dh):
    q, k, v, valid = _qkv(dh, dh=dh)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    scale = 1.0 / dh ** 0.5
    got = flash_attn.mhsa_plain(tq, tk, tv, torch.from_numpy(valid), scale)
    assert got.dtype == dtype and got.shape == tq.shape
    seg = jnp.asarray(valid.astype(np.int32))
    ref = mha_reference_no_custom_vjp(
        *(jnp.asarray(t.float().numpy()) for t in (tq, tk, tv)),
        segment_ids=SegmentIds(q=seg, kv=seg), sm_scale=scale)
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * np.abs(v).max()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref), rtol=0,
                               atol=atol)
    # a padded query attends the padded keys only: row 1 (length 1), query
    # 5 is a softmax over keys 1.. of that row
    s = tq[1, :, 5:6].float() @ tk[1, :, 1:].float().transpose(-1, -2) * scale
    p = torch.softmax(s, dim=-1).to(dtype).float()
    torch.testing.assert_close(got[1, :, 5].float(),
                               (p @ tv[1, :, 1:].float())[:, 0].to(dtype)
                               .float(), rtol=0, atol=atol)


def test_mhsa_runs_the_plain_version_on_cpu_tensors():
    q, k, v, valid = (torch.from_numpy(a) for a in _qkv(0))
    before = cuda_flash_attn.LAUNCHES
    got = flash_attn.mhsa(q, k, v, valid, 0.25)
    assert cuda_flash_attn.LAUNCHES == before
    torch.testing.assert_close(got, flash_attn.mhsa_plain(q, k, v, valid,
                                                          0.25),
                               rtol=0, atol=0)


def test_launcher_refuses_cpu_tensors():
    q, k, v, valid = (torch.from_numpy(a) for a in _qkv(0))
    before = cuda_flash_attn.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash_attn.flash_attn_cuda(q, k, v, valid, 0.25)
    assert cuda_flash_attn.LAUNCHES == before


def _block_case(family, seed=0, B=3, T=29, d=64, heads=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    lens = np.array([T, 1, 17])
    valid = np.arange(T)[None] < lens[:, None]
    mcfg = ModelConfig(family=family, vocab_size=8, input_dim=16)
    if family == "transformer":
        cfg = TransformerConfig(num_layers=1, d_model=d, num_heads=heads,
                                ffn_dim=128)
        tree = jax_transformer.init_params(jax.random.PRNGKey(seed), mcfg,
                                           cfg)
    else:
        cfg = ConformerConfig(num_layers=1, d_model=d, num_heads=heads,
                              ffn_dim=128, conv_kernel=7)
        tree = jax_conformer.init_params(jax.random.PRNGKey(seed), mcfg, cfg)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return x, valid, tree


@pytest.mark.parametrize("family", ["transformer", "conformer"])
def test_segment_masked_mhsa_matches_dense_jax_on_valid_rows(family):
    x, valid, tree = _block_case(family)
    bias = jnp.where(jnp.asarray(valid), 0.0, -1e9)[:, None, None, :]
    blk = jax.tree_util.tree_map(jnp.asarray, tree["blocks"][0])
    params = params_from_jax(tree)
    tx, tvalid = torch.from_numpy(x), torch.from_numpy(valid)
    if family == "transformer":
        ref = jax_transformer._mhsa(blk, jnp.asarray(x), bias, 2)
        got = transformer_ctc._mhsa(params, "blocks.0", tx, None, 2,
                                    flash_mask=tvalid)
    else:
        ref = jax_conformer._mhsa_rotary(blk, jnp.asarray(x), bias, 2,
                                         softmax_bf16=False)
        got = conformer_ctc._mhsa_rotary(params, "blocks.0", tx, None, 2,
                                         flash_mask=tvalid)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(ref)[valid],
                               rtol=0, atol=1e-5)
    # and the port's dense path matches JAX's on every row
    dense = (transformer_ctc._mhsa(params, "blocks.0", tx,
                                   transformer_ctc.padding_bias(tvalid), 2)
             if family == "transformer" else
             conformer_ctc._mhsa_rotary(params, "blocks.0", tx,
                                        transformer_ctc.padding_bias(tvalid), 2))
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_rotary_rotates_the_halves_as_jax_does():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 11, 8)).astype(np.float32)
    ref = jax_conformer._rotary(jnp.asarray(x))
    got = conformer_ctc._rotary(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_posenc_concatenates_sin_and_cos_as_jax_does():
    ref = jax_transformer._posenc(23, 16, jnp.float32)
    got = transformer_ctc._posenc(23, 16, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def _segment_ids(kind, T, rng):
    """(B, T) int32 segment ids: ragged valid masks (lengths 1, 64, 65,
    128 and T beside random ones: whole 64-row tiles of padding), or runs
    of random int32 ids, sorted in one row (most tile pairs disjoint), in
    random order in another, the extremes of int32 in a third."""
    if kind == "ragged":
        lens = np.array([1, 64, 65, 128, T, *rng.integers(1, T + 1, 2)])
        return (np.arange(T)[None] < lens[:, None]).astype(np.int32)
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
    return np.stack(rows).astype(np.int32)


def _tile_walk(q, k, v, seg, scale, kept=None, tile=64):
    """The forward kernels' walk in float32: for each query tile, the key
    tiles in order (only those ``kept`` keeps, if given), each with the
    scores q . k * scale plus the additive mask, the running max m, alpha
    = exp(m_old - m_new), p = exp(s - m_new), l = alpha l + sum(p), acc =
    alpha acc + p . v; o = acc * (1 / l) -> (o, l, m)."""
    B, H, T, _ = q.shape
    n = -(-T // tile)
    o, l_out, m_out = torch.empty_like(q), torch.empty(B, H, T), \
        torch.empty(B, H, T)
    for b in range(B):
        for i in range(n):
            rows = slice(i * tile, min(T, (i + 1) * tile))
            qt = q[b, :, rows]
            m = torch.full(qt.shape[:2], -torch.inf)
            l = torch.zeros(qt.shape[:2])
            acc = torch.zeros_like(qt)
            for j in range(n):
                if kept is not None and not kept[b, i, j]:
                    continue
                keys = slice(j * tile, min(T, (j + 1) * tile))
                s = qt @ k[b, :, keys].transpose(-1, -2) * scale
                same = seg[b, rows, None] == seg[b, None, keys]
                s = s + torch.where(same, 0.0, flash_attn.DEFAULT_MASK_VALUE)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = alpha * l + p.sum(-1)
                acc = alpha[..., None] * acc + p @ v[b, :, keys]
                m = m_new
            o[b, :, rows] = acc * torch.where(l == 0, 1.0, 1.0 / l)[..., None]
            l_out[b, :, rows], m_out[b, :, rows] = l, m
    return o, l_out, m_out


@pytest.mark.parametrize("kind", ["ragged", "random_int32"])
@pytest.mark.parametrize("T", [201, 256])
def test_forward_skips_emptied_tile_pairs_without_a_change(kind, T):
    """The claim of csrc/flash_attn.cu: skipping the (query tile, key tile)
    pairs whose segment-id ranges are disjoint changes no bit of o, l and
    m. The walk stays within atol 1e-5 of mhsa_plain's residual form and,
    at T = 256 (the library's 128-row blocks), of the library's Pallas
    forward in interpret mode."""
    H, dh = 2, 32
    rng = np.random.default_rng(T)
    seg = _segment_ids(kind, T, rng)
    B = seg.shape[0]
    q, k, v = (rng.standard_normal((B, H, T, dh)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv, tseg = (torch.from_numpy(a) for a in (q, k, v, seg))
    scale = dh ** -0.5
    kept = flash_attn.kept_tile_pairs(tseg)
    assert not kept.all()  # the case skips some pairs
    full = _tile_walk(tq, tk, tv, tseg, scale)
    skip = _tile_walk(tq, tk, tv, tseg, scale, kept)
    for name, a, b in zip(("o", "l", "m"), skip, full):
        assert torch.equal(a, b), name
    for name, a, b in zip(("o", "l", "m"), skip, flash_attn.mhsa_plain(
            tq, tk, tv, tseg, scale, residuals=True)):
        torch.testing.assert_close(a, b, rtol=1e-5 if name == "l" else 0,
                                   atol=0 if name == "l" else 1e-5)
    if T % 128 == 0:
        with pltpu.force_tpu_interpret_mode():
            ref = flash_attention(
                *(jnp.asarray(a) for a in (q, k, v)),
                segment_ids=SegmentIds(q=jnp.asarray(seg),
                                       kv=jnp.asarray(seg)), sm_scale=scale)
        np.testing.assert_allclose(skip[0].numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("dh", [48, 128])
def test_mhsa_and_its_backward_match_the_library_kernel_at_head_dims(dh):
    """mhsa (the plain version on the CPU) and its gradient through
    FlashAttention at dh=128 (an instance of the kernels) and dh=48 (not
    one: it runs on the dh=64 instance), against JAX's library Pallas
    flash attention and its backward kernels in TPU interpret mode, float32:
    atol 1e-5 (summation order only). T = 128, one block of the library
    kernels; a full row and a row of 1."""
    rng = np.random.default_rng(dh)
    B, H, T = 2, 2, 128
    q, k, v, do = (rng.standard_normal((B, H, T, dh)).astype(np.float32)
                   for _ in range(4))
    valid = np.arange(T)[None] < np.array([T, 1])[:, None]
    seg = jnp.asarray(valid.astype(np.int32))
    scale = dh ** -0.5

    def f(q, k, v):
        return flash_attention(q, k, v, segment_ids=SegmentIds(q=seg, kv=seg),
                               sm_scale=scale)

    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
        ref_grads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = flash_attn.mhsa(*leaves, torch.from_numpy(valid), scale)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(do))
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dh,inst", [(48, 64), (20, 32), (80, 128)])
def test_zero_columns_past_dh_change_nothing(dh, inst):
    """The kernels' claim for a head dim between instances: q, k, v
    zero-filled from dh to the instance's width give the same scores, so
    the first dh output columns (and l, m) are those of dh, and the
    columns past dh are zero (the kernels do not write them)."""
    q, k, v, valid = (torch.from_numpy(a) for a in _qkv(dh, dh=dh))
    scale = dh ** -0.5
    pad = [torch.nn.functional.pad(t, (0, inst - dh)) for t in (q, k, v)]
    o, l, m = flash_attn.mhsa_plain(q, k, v, valid, scale, residuals=True)
    po, pl, pm = flash_attn.mhsa_plain(*pad, valid, scale, residuals=True)
    torch.testing.assert_close(po[..., :dh], o, rtol=0, atol=1e-6)
    assert torch.equal(po[..., dh:], torch.zeros_like(po[..., dh:]))
    torch.testing.assert_close(pl, l, rtol=1e-6, atol=0)
    torch.testing.assert_close(pm, m, rtol=0, atol=1e-6)
