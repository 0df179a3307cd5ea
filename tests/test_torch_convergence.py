"""Convergence of the port against the JAX package on the learnable
phonetic corpus (``make_phonetic_corpus``: each character a tone).

The tests: the port's corpus writes the JAX package's bytes; both packages'
``train()`` (their own loops, loaders and optimizers) take the same
per-step losses, float32 rel 1e-4, over 2 epochs x 4 steps of a tiny
BiLSTM-CTC from the same weights with dropout 0 (the same batch order: one
numpy shuffle stream).

Run as a script, the file trains the JAX package on the CPU with the
recipe of examples/pg_improves_cer.py (logmel 40, projection 128, 2 x
BiLSTM 64, dropout 0.1, 16 epochs of batch 8, lr 3e-3, warmup 50, then 120
REINFORCE steps) from the port's initial weights for that seed, and prints
the test CER after training and after PG as one JSON line; chip_smoke.py
phase 11 runs the port's side of the same recipe on the card:

    PYTHONPATH=. JAX_PLATFORMS=cpu JAX_PLATFORM_NAME=cpu \
        JAX_DEFAULT_MATMUL_PRECISION=highest \
        python tests/test_torch_convergence.py WORKDIR
"""

import filecmp
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu import train as jax_train
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import FeatureConfig as JFeatureConfig
from pg_asr_tpu.config import ModelConfig as JModelConfig
from pg_asr_tpu.config import TrainConfig as JTrainConfig
from pg_asr_tpu.data.dataset import make_phonetic_corpus as jax_corpus
from pg_asr_tpu_torch import train as port_train
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_to_jax
from pg_asr_tpu_torch.data import make_phonetic_corpus


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_initial_params(jcfg: JConfig, corpus: str) -> dict:
    """The JAX tree of the port's initial weights for `jcfg` (the port's
    ``init_model_params`` from ``train.seed``), with vocab_size and
    input_dim set from the corpus as both trainers set them."""
    from pg_asr_tpu_torch.data import Alphabet

    cfg = Config.from_json(jcfg.to_json())
    size = Alphabet.load(os.path.join(corpus, "alphabet.txt")).size
    cfg = cfg.replace(model=cfg.model.__class__(**{
        **cfg.model.__dict__, "vocab_size": size,
        "input_dim": cfg.features.feature_dim}))
    params = port_train.init_model_params(
        cfg, torch.Generator().manual_seed(cfg.train.seed), "cpu")
    return jax.tree_util.tree_map(jnp.asarray, params_to_jax(params))


def jax_train_from(tree, corpus, model, jcfg, **kw):
    """The JAX package's train() with its initial weights replaced by
    `tree` (restored after)."""
    saved = jax_train.init_model_params
    jax_train.init_model_params = lambda rng, cfg: tree
    try:
        return jax_train.train(corpus, model, config=jcfg, resume=False, **kw)
    finally:
        jax_train.init_model_params = saved


def step_losses(model: str) -> list[float]:
    with open(os.path.join(model, "metrics.jsonl")) as fo:
        return [json.loads(line)["loss"] for line in fo]


def test_phonetic_corpus_writes_the_jax_bytes(tmp_path):
    make_phonetic_corpus(str(tmp_path / "port"), n_utts=10, seed=3)
    jax_corpus(str(tmp_path / "jax"), n_utts=10, seed=3)
    names = sorted(os.listdir(tmp_path / "jax" / "clips"))
    assert len(names) == 10
    for sub, files in (("", ["alphabet.txt", "train.tsv", "dev.tsv",
                             "test.tsv"]), ("clips", names)):
        match, mismatch, errors = filecmp.cmpfiles(
            tmp_path / "jax" / sub, tmp_path / "port" / sub, files,
            shallow=False)
        assert mismatch == errors == [] and len(match) == len(files)


def test_both_trainers_take_the_same_per_step_losses(tmp_path):
    """2 epochs x 4 steps (12 one-word utterances, batch 3: one padded
    shape, one JAX compile) of a BiLSTM-CTC with 1 layer of 16 units."""
    corpus, _ = make_phonetic_corpus(str(tmp_path / "corpus"), n_utts=16,
                                     seed=1, max_words=1)
    jcfg = JConfig(
        model=JModelConfig(input_proj_dim=32, hidden_size=16, num_layers=1,
                           dropout=0.0, use_pallas_lstm=False),
        train=JTrainConfig(num_epochs=2, batch_size=3, learning_rate=3e-3,
                           warmup_steps=2, log_every=1, prefetch_depth=0,
                           seed=4))
    tree = port_initial_params(jcfg, corpus)
    jax_out = jax_train_from(tree, corpus, str(tmp_path / "jax"), jcfg)
    port_out = port_train.train(corpus, str(tmp_path / "port"),
                                config=Config.from_json(jcfg.to_json()),
                                device="cpu")
    assert jax_out["steps"] == port_out["steps"] == 8
    j, p = step_losses(str(tmp_path / "jax")), step_losses(
        str(tmp_path / "port"))
    assert len(j) == len(p) == 8 and p[-1] < p[0]
    np.testing.assert_allclose(p, j, rtol=1e-4)
    np.testing.assert_allclose(port_out["val_losses"], jax_out["val_losses"],
                               rtol=1e-4)


def recipe_config() -> JConfig:
    """examples/pg_improves_cer.py's configuration."""
    return JConfig(
        features=JFeatureConfig(kind="logmel", n_mels=40, n_fft=256,
                                win_length=256, hop_length=128),
        model=JModelConfig(family="ctc", vocab_size=8, input_dim=40,
                           input_proj_dim=128, hidden_size=64, num_layers=2,
                           dropout=0.1),
        train=JTrainConfig(num_epochs=16, batch_size=8, learning_rate=3e-3,
                           warmup_steps=50, log_every=10000,
                           prefetch_depth=0))


def main(work: str) -> int:
    """The JAX package's run of the convergence recipe, on the CPU."""
    import time

    from pg_asr_tpu.predict import predict
    from pg_asr_tpu.rl.reinforce import finetune_pg

    corpus, model = os.path.join(work, "corpus"), os.path.join(work, "model")
    make_phonetic_corpus(corpus, n_utts=96, seed=0)
    jcfg = recipe_config()
    t0 = time.time()
    out = jax_train_from(port_initial_params(jcfg, corpus), corpus, model,
                         jcfg)
    t_train = time.time() - t0
    args = (os.path.join(corpus, "test.tsv"), os.path.join(corpus, "clips"),
            os.path.join(corpus, "alphabet.txt"), model)
    before = predict(*args, batch_size=8)
    t0 = time.time()
    finetune_pg(corpus, model, num_steps=120, batch_size=8, config=jcfg)
    t_pg = time.time() - t0
    after = predict(*args, batch_size=8, which_ckpt="last")
    print(json.dumps({
        "package": "pg_asr_tpu (JAX, CPU)", "jax": jax.__version__,
        "cer_train": before["cer"], "wer_train": before["wer"],
        "cer_pg": after["cer"], "wer_pg": after["wer"],
        "train_losses": out["train_losses"], "val_losses": out["val_losses"],
        "train_s": t_train, "pg_s": t_pg}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
