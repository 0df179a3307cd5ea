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
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds, mha_reference_no_custom_vjp)

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
