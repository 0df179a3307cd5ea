"""`--mode export` of the port (pg_asr_tpu_torch/exporting.py) vs the JAX
package's (pg_asr_tpu/exporting.py), on the same model directories.

One JAX model dir a family, written by the JAX package's CheckpointManager
at tests/test_export.py's tiny config (16 mels, projection 32, hidden 16,
one layer; the transducer on the BiLSTM encoder with a prediction net of
8/16, a joint of 16 and 2 labels a frame; the seq2seq decoder 8/32, its
output weights x8 so that its beam's best is not the empty hypothesis;
labels up to 24; the int8 case at hidden 64), is exported by both
packages at B=2 x 0.5 s and run on the same 0.4 s waves
(np.random.default_rng): the port's artifact gives ids and lens EQUAL to
the JAX artifact's and to the port's live serving function, for each
decoder of each family, float32 and int8. On the CPU the
``pgasr`` ops run their plain versions; the graph still holds them as
nodes, which is what these tests check of the ops' schemas and fake
functions.
"""

import json
import os

import numpy as np
import pytest
import torch

from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.exporting import ExportedModel as JaxExportedModel
from pg_asr_tpu.exporting import export_model as jax_export_model
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.config import (Config, ConformerConfig, DecodeConfig,
                                     FeatureConfig, ModelConfig,
                                     Seq2SeqConfig, TransducerConfig)
from pg_asr_tpu_torch.exporting import (ARTIFACT, EXPORT_DIR, MANIFEST,
                                        ExportedModel, export_model,
                                        graph_stats, make_serving_fn)
from pg_asr_tpu_torch.predict import load_model
from pg_asr_tpu_torch.data.bpe import load_tokenizer
from tests.test_export import _waves

B, SECONDS, BEAM = 2, 0.5, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(family: str, vocab: int, hidden: int = 16) -> Config:
    return Config(
        features=FeatureConfig(kind="logmel", n_mels=16),
        model=ModelConfig(family=family, vocab_size=vocab, input_dim=16,
                          input_proj_dim=32, hidden_size=hidden, num_layers=1,
                          dropout=0.0),
        seq2seq=Seq2SeqConfig(vocab_size=vocab, embed_dim=8, dec_hidden=32),
        transducer=TransducerConfig(encoder="bilstm", pred_embed_dim=8,
                                    pred_hidden=16, joint_dim=16,
                                    max_symbols_per_frame=2),
        conformer=ConformerConfig(num_layers=1, d_model=32, num_heads=2,
                                  ffn_dim=32, flash_attention=True),
        decode=DecodeConfig(max_label_len=24))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A corpus and one JAX model dir a family (the JAX package's init
    from a seed, saved by its CheckpointManager)."""
    import jax

    from pg_asr_tpu.checkpoint import CheckpointManager
    from pg_asr_tpu.data.dataset import make_synthetic_corpus
    from pg_asr_tpu.train import init_model_params

    root = tmp_path_factory.mktemp("export")
    corpus = str(root / "corpus")
    make_synthetic_corpus(corpus, n_utts=4, seed=11, min_dur=0.2, max_dur=0.3)
    vocab = load_tokenizer(corpus, "char").size
    out = {"corpus": corpus}
    for name, family, hidden in (("ctc", "ctc", 16), ("ctc_wide", "ctc", 64),
                                 ("seq2seq", "seq2seq", 16),
                                 ("transducer", "transducer", 16),
                                 ("conformer", "conformer", 16)):
        jcfg = JConfig.from_json(_config(family, vocab, hidden).to_json())
        params = init_model_params(jax.random.PRNGKey(3), jcfg)
        if family == "seq2seq":
            # a confident decoder, so that the beam's best is not the empty
            # hypothesis (EOS first) and its ids are a fair bar
            params["output"]["w"] = params["output"]["w"] * 8
        mgr = CheckpointManager(str(root / name))
        mgr.save_config(jcfg.to_json())
        mgr.save({"params": params}, val_loss=1.0)
        out[name] = str(root / name)
    return out


def _port(model_dir, corpus, **kw):
    manifest = export_model(model_dir, corpus_path=corpus, batch_size=B,
                            max_seconds=SECONDS, device="cpu", **kw)
    return manifest, ExportedModel(os.path.join(model_dir, EXPORT_DIR),
                                   device="cpu")


def _jax(model_dir, corpus, **kw):
    manifest = jax_export_model(model_dir, corpus_path=corpus, batch_size=B,
                                max_seconds=SECONDS, **kw)
    return manifest, JaxExportedModel(os.path.join(model_dir, EXPORT_DIR))


def _live(model_dir, corpus, manifest, wave, ns, **kw):
    """The port's live serving function on the padded static shape."""
    alphabet = load_tokenizer(corpus, "char")
    params, cfg = load_model(model_dir, alphabet, device="cpu")
    fn = make_serving_fn(params, cfg, **kw)
    buf = np.zeros((wave.shape[0], manifest["max_samples"]), np.float32)
    buf[:, :wave.shape[1]] = wave
    with torch.inference_mode():
        ids, lens = fn(torch.from_numpy(buf), torch.from_numpy(ns))
    return ids.numpy(), lens.numpy()


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32


@pytest.mark.parametrize("family,decoder", [
    ("ctc", "greedy"), ("ctc", "beam"), ("seq2seq", "greedy"),
    ("seq2seq", "beam"), ("transducer", "greedy"), ("transducer", "beam")])
def test_artifact_equals_jax_artifact_and_live(dirs, family, decoder):
    kw = dict(decoder=decoder, beam_size=BEAM if decoder == "beam" else 0)
    wave, ns = _waves(B, dur=0.4)
    jm, jex = _jax(dirs[family], dirs["corpus"], **kw)
    want = jex(wave, ns)
    manifest, ex = _port(dirs[family], dirs["corpus"], **kw)
    got = ex(wave, ns)
    assert np.asarray(want[1]).sum() > 0  # not an all-blank decode
    _assert_same(got, want)
    _assert_same(_live(dirs[family], dirs["corpus"], manifest, wave, ns,
                       **kw), want)
    assert manifest["family"] == family and manifest["decoder"] == decoder
    # the manifest holds the JAX package's keys, the contract's values equal
    assert set(jm) <= set(manifest)
    for key in set(jm) - {"artifact", "bytes"}:
        assert manifest[key] == jm[key], key
    assert manifest["requires"] == "pg_asr_tpu_torch ops"


def test_int8_artifact_equals_jax_int8_artifact(dirs):
    wave, ns = _waves(B, dur=0.4)
    # hidden 64: the weights outweigh the int8 program's extra nodes
    d, corpus = dirs["ctc_wide"], dirs["corpus"]
    m_f32, _ = _port(d, corpus)
    _, jex = _jax(d, corpus, quantize="int8")
    want = jex(wave, ns)
    m_q, ex = _port(d, corpus, quantize="int8")
    assert m_q["quantize"] == "int8"
    assert m_q["bytes"] < m_f32["bytes"]
    _assert_same(ex(wave, ns), want)
    _assert_same(_live(d, corpus, m_q, wave, ns, quantize="int8"), want)


def test_partial_batches_padded_and_larger_batch_refused(dirs):
    _, ex = _port(dirs["ctc"], dirs["corpus"])
    wave, ns = _waves(B, dur=0.3)
    full_ids, full_lens = ex(wave, ns)
    one_ids, one_lens = ex(wave[:1], ns[:1])
    assert one_ids.shape[0] == 1
    np.testing.assert_array_equal(one_ids[0], full_ids[0])
    assert one_lens[0] == full_lens[0]
    with pytest.raises(ValueError, match="exported batch"):
        ex(np.zeros((3, 100), np.float32), np.full((3,), 100, np.int32))


@pytest.mark.parametrize("family,decoder,ops", [
    ("ctc", "beam", {"pgasr::bilstm_fwd", "pgasr::ctc_beam"}),
    ("conformer", "greedy", {"pgasr::flash_attn"})])
def test_graph_holds_the_pgasr_ops(dirs, family, decoder, ops):
    wave, ns = _waves(B, dur=0.4)
    manifest, ex = _port(dirs[family], dirs["corpus"], decoder=decoder,
                         beam_size=BEAM if decoder == "beam" else 0)
    assert set(graph_stats(ex.program)["pgasr_ops"]) == ops
    assert set(manifest["pgasr_ops"]) == ops
    _assert_same(ex(wave, ns), _live(dirs[family], dirs["corpus"], manifest,
                                     wave, ns, decoder=decoder,
                                     beam_size=manifest["beam_size"]))


def test_transducer_program_does_not_grow_with_seconds(dirs):
    """The frame loop is one scan: the same node count at 0.5 s and 1 s."""
    nodes = [export_model(dirs["transducer"], corpus_path=dirs["corpus"],
                          batch_size=B, max_seconds=s, device="cpu")["nodes"]
             for s in (0.5, 1.0)]
    assert nodes[0] == nodes[1]


def test_cpu_cuda_artifact_is_stored_for_the_cpu(dirs):
    wave, ns = _waves(B, dur=0.4)
    manifest, ex = _port(dirs["ctc"], dirs["corpus"],
                         platforms=("cpu", "cuda"))
    assert manifest["platforms"] == ["cpu", "cuda"]
    assert manifest["stored_on"] == "cpu"
    _assert_same(ex(wave, ns), _live(dirs["ctc"], dirs["corpus"], manifest,
                                     wave, ns))


def test_missing_tokenizer_names_the_corpus_dir(dirs):
    with pytest.raises(FileNotFoundError, match="CORPUS dir"):
        export_model(dirs["ctc"], device="cpu")


def test_cli_export_writes_both_files(dirs):
    d = dirs["ctc"]
    rc = cli.main(["--mode", "export", "--corpus_path", dirs["corpus"],
                   "--model_path", d, "--export_batch", "2",
                   "--export_seconds", "0.5", "--device", "cpu"])
    assert rc == 0
    out = os.path.join(d, EXPORT_DIR)
    assert os.path.exists(os.path.join(out, ARTIFACT))
    with open(os.path.join(out, MANIFEST)) as fo:
        m = json.load(fo)
    assert m["batch_size"] == 2 and m["decoder"] == "greedy"
    assert m["platforms"] == ["cpu"] and m["checkpoint"] == "best"


@pytest.mark.parametrize("extra,message", [
    (["--export_platforms", "tpu"], "cpu, cuda"),
    (["--export_quantize", "int4"], None),  # argparse: not a choice
    # no refusal since the switch-MoE transformer is ported
    # (tests/test_torch_moe.py): the model dir's config.json decides the
    # family, as in the JAX CLI
    (["--model", "moe"], "")])
def test_cli_export_refusals(dirs, extra, message):
    argv = ["--mode", "export", "--corpus_path", dirs["corpus"],
            "--model_path", dirs["ctc"], "--export_batch", "2",
            "--export_seconds", "0.5", "--device", "cpu", *extra]
    if message == "":
        assert cli.main(argv) == 0
        with open(os.path.join(dirs["ctc"], EXPORT_DIR, MANIFEST)) as fo:
            assert json.load(fo)["family"] == "ctc"
        return
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    if message is None:
        assert e.value.code == 2
    else:
        assert message in str(e.value)
