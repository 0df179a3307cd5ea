"""Weight-only int8 quantization of the port (pg_asr_tpu_torch/ops/quant.py)
vs the JAX package's (pg_asr_tpu/ops/quant.py), and its leaf's bridge
(convert.py).

Tolerances: q8 and the scales are bit-equal to the JAX package's in
float32 and bfloat16, and so are the dequantized weights; tree_bytes
equal. The quantization error bound (|w - deq(q(w))| <= scale / 2) and
the quantized forward's distance to the float one (< 0.05 in log-probs, a
1-layer BiLSTM-CTC of hidden 16) are the JAX tests' own.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.ops import quant as jquant
from pg_asr_tpu.train import init_model_params as jax_init
from pg_asr_tpu_torch.config import Config, FeatureConfig, ModelConfig
from pg_asr_tpu_torch.convert import params_from_jax, params_to_jax
from pg_asr_tpu_torch.exporting import make_serving_fn
from pg_asr_tpu_torch.models import bilstm_ctc
from pg_asr_tpu_torch.ops.quant import (dequantize_array, dequantize_tree,
                                        is_quantized_leaf, quantize_array,
                                        quantize_tree, tree_bytes)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uneven(shape, seed=0):
    """Weights whose output channels span three decades (the case a
    per-tensor scale botches), with exact halves to exercise the rounding
    rule."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w *= np.geomspace(0.01, 10.0, shape[-1]).astype(np.float32)
    w.reshape(-1)[:8] = [0.5, -0.5, 1.5, -2.5, 0.0, 3.5, 126.5, -126.5]
    return w


def _to_np(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 32), (3, 5, 48)])
def test_quantize_array_bit_equal_to_jax(dtype, shape):
    tdt, jdt = DTYPES[dtype]
    w = _uneven(shape)
    jl = jquant.quantize_array(jnp.asarray(w, jdt))
    tl = quantize_array(torch.from_numpy(w).to(tdt))
    np.testing.assert_array_equal(tl["q8"].numpy(), np.asarray(jl["q8"]))
    assert tl["q8"].dtype == torch.int8 and tl["s"].dtype == torch.float32
    np.testing.assert_array_equal(tl["s"].numpy(), np.asarray(jl["s"]))
    assert tl["d"].dtype == tdt and tl["d"].numel() == 0
    for out in (None, "float32", "bfloat16"):
        got = dequantize_array(tl, None if out is None else DTYPES[out][0])
        want = jquant.dequantize_array(jl, None if out is None
                                       else DTYPES[out][1])
        assert got.dtype == (tdt if out is None else DTYPES[out][0])
        np.testing.assert_array_equal(
            _to_np(got), np.asarray(want.astype(jnp.float32)))


def test_quantize_error_bound():
    """|w - deq(q(w))| <= scale / 2 elementwise; the dequantized matmul is
    within 1 % of the float one."""
    rng = np.random.default_rng(0)
    w = _uneven((64, 32), seed=1)
    leaf = quantize_array(torch.from_numpy(w))
    deq = dequantize_array(leaf).numpy()
    assert np.all(np.abs(deq - w) <= leaf["s"].numpy() / 2 + 1e-7)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    err = np.linalg.norm(x @ deq - x @ w) / np.linalg.norm(x @ w)
    assert err < 0.01


def test_quantize_tree_selectivity():
    """2-D+ float tensors of >= min_size elements quantize; 1-D ones,
    small ones and integer ones stay as they are."""
    params = {
        "w": torch.ones(64, 64), "b": torch.ones(64),
        "tiny": torch.ones(2, 2), "ids": torch.ones(64, 64, dtype=torch.int32),
        "u": torch.ones(64, 64, dtype=torch.bfloat16),
    }
    q = quantize_tree(params, min_size=1024)
    assert is_quantized_leaf(q["w"]) and is_quantized_leaf(q["u"])
    for k in ("b", "tiny", "ids"):
        assert q[k] is params[k]
    d = dequantize_tree(q)
    assert d["w"].dtype == torch.float32 and d["u"].dtype == torch.bfloat16
    assert tree_bytes(q) < tree_bytes(params)
    w_bytes = q["w"]["q8"].numel() + q["w"]["s"].numel() * 4
    assert w_bytes < tree_bytes({"w": params["w"]}) / 3.5  # ~4x on f32


@pytest.mark.parametrize("family", ["ctc", "seq2seq"])
def test_model_tree_matches_jax(family):
    """A model's quantized tree: every leaf the JAX package quantizes is
    quantized here with the same bits (through convert.params_from_jax of
    the JAX tree), tree_bytes equal, and params_to_jax gives the JAX
    package's quantized tree back."""
    jcfg = JConfig.from_json(Config(
        features=FeatureConfig(kind="logmel", n_mels=16),
        model=ModelConfig(family=family, vocab_size=12, input_dim=16,
                          input_proj_dim=32, hidden_size=16, num_layers=1,
                          dropout=0.0)).to_json())
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_init(jax.random.PRNGKey(3), jcfg))
    jq = jquant.quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree),
                              min_size=256)
    tq = quantize_tree(params_from_jax(tree), min_size=256)
    assert tree_bytes(tq) == jquant.tree_bytes(jq)
    from_jax = params_from_jax(jq)
    assert set(from_jax) == set(tq)
    n_quantized = 0
    for name, leaf in tq.items():
        assert is_quantized_leaf(leaf) == is_quantized_leaf(from_jax[name])
        if is_quantized_leaf(leaf):
            n_quantized += 1
            for f in ("q8", "s", "d"):
                assert torch.equal(leaf[f], from_jax[name][f]), (name, f)
        else:
            assert torch.equal(leaf, from_jax[name]), name
    assert n_quantized >= 4
    back = params_to_jax(tq)
    for path, want in jax.tree_util.tree_leaves_with_path(jq):
        node = back
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_array_equal(node, np.asarray(want))


def test_quantized_forward_close_to_float():
    """Log-probs of a quantized BiLSTM-CTC forward stay close to float."""
    cfg = ModelConfig(family="ctc", vocab_size=8, input_dim=16,
                      input_proj_dim=32, hidden_size=16, num_layers=2,
                      dropout=0.0)
    params = bilstm_ctc.init_params(cfg, torch.Generator().manual_seed(0))
    deq = dequantize_tree(quantize_tree(params, min_size=16))
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.standard_normal((2, 20, 16)).astype(
        np.float32))
    mask = torch.ones(2, 20)
    with torch.inference_mode():
        lp = bilstm_ctc.apply(params, feats, mask, cfg)
        lp_q = bilstm_ctc.apply(deq, feats, mask, cfg)
    assert (lp - lp_q).abs().max().item() < 0.05


def test_unknown_quantize_mode_rejected():
    with pytest.raises(ValueError, match="unknown quantize"):
        make_serving_fn({}, Config(), quantize="int4")
