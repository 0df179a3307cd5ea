"""The predict slice as a whole: the port's predict (on CPU) vs the JAX
package's predict, on one synthetic corpus with the same weights; plus the
port's import hygiene and CLI.

Parity bar: the same predicted.txt, byte for byte, and the same CER/WER.
With random weights an argmax near-tie could flip one symbol, so the seeds
are chosen such that every valid frame's top two log-probs lie more than
1e-4 apart (asserted below), well above the ~1e-5 log-prob difference the
model parity test allows.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from pg_asr_tpu.alignment import align_corpus as jax_align
from pg_asr_tpu.checkpoint import save_checkpoint
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import DecodeConfig as JDecodeConfig
from pg_asr_tpu.config import ModelConfig
from pg_asr_tpu.config import Seq2SeqConfig as JSeq2SeqConfig
from pg_asr_tpu.data.dataset import (BatchIterator, load_manifest,
                                     make_synthetic_corpus)
from pg_asr_tpu.data.text import Alphabet as JAlphabet
from pg_asr_tpu.models import bilstm_ctc as jax_model
from pg_asr_tpu.models import seq2seq as jax_seq2seq
from pg_asr_tpu.predict import load_model as jax_load_model
from pg_asr_tpu.predict import predict as jax_predict
from pg_asr_tpu.selftrain import pseudo_label as jax_pseudo_label
from pg_asr_tpu.serving import StreamingTranscriber as JStreamingTranscriber
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.checkpoint import load_checkpoint, save_model
from pg_asr_tpu_torch.checkpoint import save_checkpoint as save_checkpoint_pt
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.predict import forward, forward_seq2seq, load_model
from pg_asr_tpu_torch.predict import predict as torch_predict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test (the suite runs in several worker
    processes), restored afterwards: importing this module changes no
    process-wide state."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_SEED, MODEL_SEED, BATCH = 3, 4, 2


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    corpus, alphabet = make_synthetic_corpus(
        str(d / "corpus"), n_utts=32, seed=CORPUS_SEED, min_dur=0.3,
        max_dur=1.0)
    jcfg = JConfig(model=ModelConfig(vocab_size=alphabet.size,
                                     input_proj_dim=32, hidden_size=16,
                                     num_layers=2))
    cfg = Config.from_json(jcfg.to_json())  # the port's, from the same JSON
    tree = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(MODEL_SEED),
                                          jcfg.model))
    jax_dir, torch_dir = str(d / "jax_model"), str(d / "torch_model")
    os.makedirs(jax_dir)
    with open(os.path.join(jax_dir, "config.json"), "w") as fo:
        fo.write(jcfg.to_json())
    save_checkpoint(os.path.join(jax_dir, "model_best.ckpt"),
                    {"params": tree})
    save_model(torch_dir, params_from_jax(tree), cfg)
    paths = dict(test_path=os.path.join(corpus, "test.tsv"),
                 aud_path=os.path.join(corpus, "clips"),
                 alphabet_path=os.path.join(corpus, "alphabet.txt"))
    return paths, alphabet, cfg, jax_dir, torch_dir


def test_predict_matches_jax_package(slice_setup):
    paths, alphabet, cfg, jax_dir, torch_dir = slice_setup
    # the margin that makes exact text equality a fair bar
    params, cfg_t = load_model(torch_dir, alphabet, device="cpu")
    utts = load_manifest(paths["test_path"], paths["aud_path"])
    margin = np.inf
    for b in BatchIterator(utts, alphabet, BATCH, shuffle=False):
        lp, mask, _ = forward(params, torch.from_numpy(b.wave),
                              torch.from_numpy(b.num_samples), cfg_t)
        top2 = lp.topk(2, dim=-1).values
        margin = min(margin, (top2[..., 0] - top2[..., 1])[mask > 0].min()
                     .item())
    assert margin > 1e-4

    ref = jax_predict(**paths, model_path=jax_dir, batch_size=BATCH)
    got = torch_predict(**paths, model_path=torch_dir, batch_size=BATCH,
                        device="cpu")
    with open(os.path.join(jax_dir, "predicted.txt")) as fo:
        ref_txt = fo.read()
    with open(os.path.join(torch_dir, "predicted.txt")) as fo:
        got_txt = fo.read()
    assert got_txt == ref_txt
    assert len(got_txt.splitlines()) == len(utts) == got["num_utts"]
    # random weights still emit text, so the comparison is not vacuous
    assert any(line.split("|")[1] for line in got_txt.splitlines())
    assert got == ref


def test_checkpoint_round_trip(slice_setup, tmp_path):
    _, _, cfg, _, torch_dir = slice_setup
    state = load_checkpoint(os.path.join(torch_dir, "model_best.pt"))["params"]
    save_model(str(tmp_path), state, cfg, which=("last",))
    again = load_checkpoint(os.path.join(tmp_path, "model_last.pt"))["params"]
    assert set(again) == set(state)
    for k in state:
        torch.testing.assert_close(again[k], state[k], rtol=0, atol=0)
    with open(os.path.join(tmp_path, "config.json")) as fo:
        assert Config.from_json(fo.read()) == cfg


def test_cli_predict_cpu(slice_setup, capsys):
    paths, _, _, _, torch_dir = slice_setup
    rc = cli.main(["--mode", "predict", "--test_path", paths["test_path"],
                   "--aud_path", paths["aud_path"], "--alphabet",
                   paths["alphabet_path"], "--model_path", torch_dir,
                   "--batch_size", "3", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "CER:" in out and "WER:" in out


# the JAX CLI's flags that were not ported, each with a non-default value;
# the export flags are ported since --mode export is, the MoE flags since
# the switch-MoE transformer is, --debug_nans since its checks are and
# --microbatches since the pipe axis is:
# --mode predict runs with them and ignores them (the model's config.json
# decides), as the JAX CLI does
UNPORTED_FLAGS = [
    (["--export_batch", "4"], "export_batch"),
    (["--export_seconds", "5"], "export_seconds"),
    (["--export_platforms", "cpu"], "export_platforms"),
    (["--export_quantize", "int8"], "export_quantize"),
    (["--microbatches", "2"], "microbatches"),
    (["--moe_experts", "4"], "moe_experts"),
    (["--capacity_factor", "1.5"], "capacity_factor"),
    (["--debug_nans"], "debug_nans"),
]
PORTED_FLAGS = ("export_batch", "export_seconds", "export_platforms",
                "export_quantize", "moe_experts", "capacity_factor",
                "debug_nans", "microbatches")


@pytest.mark.parametrize("extra,message", UNPORTED_FLAGS)
def test_cli_unported_options_exit_with_message(slice_setup, extra, message):
    paths, _, _, _, torch_dir = slice_setup
    argv = ["--mode", "predict", "--test_path", paths["test_path"],
            "--aud_path", paths["aud_path"], "--alphabet",
            paths["alphabet_path"], "--model_path", torch_dir,
            "--device", "cpu", *extra]
    if message in PORTED_FLAGS:
        assert cli.main(argv) == 0
        return
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert "not yet ported" in str(e.value) and message in str(e.value)


# the LM flags, each with a non-default value: each runs (the JAX
# package's predicted.txt: the n-gram fused beam, or greedy, where the flag
# has nothing to act on without --lm_order) or exits with its ValueError
LM_FLAGS = [
    (["--decoder", "beam", "--lm_order", "2"],
     dict(decoder="beam", lm_order=2)),
    (["--lm_order", "2"], "LM shallow fusion needs --decoder beam"),
    (["--lm_weight", "0.5"], {}), (["--lm_type", "neural"], {}),
    (["--lm_steps", "10"], {}),
    (["--lm_pass", "rescore"], "--lm_pass rescore re-ranks the n-best"),
    (["--length_bonus", "0.1"], {}),
]


@pytest.mark.parametrize("extra,want", LM_FLAGS)
def test_cli_lm_options_match_jax(slice_setup, extra, want):
    """--lm_order and the other --lm_* flags and --length_bonus through the
    CLI with --corpus_path (the LM trains on its train.tsv), against the
    JAX package's predict with the same options: the same predicted.txt,
    or the same error."""
    paths, _, _, jax_dir, torch_dir = slice_setup
    corpus = os.path.dirname(paths["test_path"])
    train_tsv = os.path.join(corpus, "train.tsv")
    if isinstance(want, str):
        message = _jax_error(lambda: jax_predict(
            **paths, model_path=jax_dir, lm_order=2, lm_train_tsv=train_tsv,
            lm_pass="rescore" if "rescore" in extra else "fused"))
        assert message.startswith(want)
        with pytest.raises(SystemExit) as e:
            _predict_cli(paths, torch_dir, "--corpus_path", corpus, *extra)
        assert str(e.value) == message
        return
    lm = {"lm_train_tsv": train_tsv} if want else {}
    jax_predict(**paths, model_path=jax_dir, batch_size=3, **want, **lm)
    assert _predict_cli(paths, torch_dir, "--corpus_path", corpus,
                        *extra) == 0
    assert _predicted(torch_dir) == _predicted(jax_dir)
    assert any(line.split("|")[1] for line in
               _predicted(torch_dir).splitlines())


@pytest.fixture(scope="module")
def seq2seq_dirs(slice_setup, tmp_path_factory):
    """A tiny attention seq2seq from the JAX init, as a JAX package model
    directory (config.json + model_best.ckpt through its save_checkpoint)
    and as the port's (model_best.pt); greedy and beam run 16 steps."""
    paths, alphabet, _, _, _ = slice_setup
    d = tmp_path_factory.mktemp("seq2seq")
    jcfg = JConfig(
        model=ModelConfig(family="seq2seq", vocab_size=alphabet.size,
                          input_proj_dim=16, hidden_size=8, num_layers=1),
        seq2seq=JSeq2SeqConfig(vocab_size=alphabet.size, embed_dim=8,
                               dec_hidden=16),
        decode=JDecodeConfig(max_label_len=16))
    tree = jax.tree_util.tree_map(np.asarray, jax_seq2seq.init_params(
        jax.random.PRNGKey(MODEL_SEED), jcfg.model, jcfg.seq2seq))
    jax_dir, torch_dir = str(d / "jax"), str(d / "torch")
    os.makedirs(jax_dir)
    with open(os.path.join(jax_dir, "config.json"), "w") as fo:
        fo.write(jcfg.to_json())
    save_checkpoint(os.path.join(jax_dir, "model_best.ckpt"),
                    {"params": tree})
    save_model(torch_dir, params_from_jax(tree),
               Config.from_json(jcfg.to_json()))
    return jcfg, jax_dir, torch_dir


def _predict_cli(paths, model_dir, *extra):
    return cli.main(["--mode", "predict", "--test_path", paths["test_path"],
                     "--aud_path", paths["aud_path"], "--alphabet",
                     paths["alphabet_path"], "--model_path", model_dir,
                     "--batch_size", "3", "--device", "cpu", *extra])


def _predicted(model_dir):
    with open(os.path.join(model_dir, "predicted.txt")) as fo:
        return fo.read()


def test_cli_unported_family_exits_with_message(slice_setup, seq2seq_dirs):
    """The model family comes from the checkpoint's config.json: the
    seq2seq family, no longer refused, is served from the port's model
    directory and from the JAX package's (its .ckpt), greedy and with the
    decoder's beam (K=3), with the JAX package's predicted.txt. The
    greedy steps' top two log-probs lie more than 1e-4 apart (asserted),
    so that exact text equality is a fair bar."""
    paths, alphabet, _, _, _ = slice_setup
    jcfg, jax_dir, torch_dir = seq2seq_dirs
    params, cfg = load_model(torch_dir, alphabet, device="cpu")
    assert cfg.model.family == "seq2seq"
    utts = load_manifest(paths["test_path"], paths["aud_path"])
    margin = np.inf
    for b in BatchIterator(utts, alphabet, 3, shuffle=False):
        _, lp = forward_seq2seq(params, torch.from_numpy(b.wave),
                                torch.from_numpy(b.num_samples), cfg)
        top2 = lp.topk(2, dim=-1).values
        margin = min(margin, (top2[..., 0] - top2[..., 1]).min().item())
    assert margin > 1e-4
    for extra in ([], ["--decoder", "beam", "--beam_size", "3"]):
        beam = dict(decoder="beam", beam_size=3) if extra else {}
        ref = jax_predict(**paths, model_path=jax_dir, batch_size=3, **beam)
        want = _predicted(jax_dir)
        assert any(line.split("|")[1] for line in want.splitlines())
        for model_dir in (torch_dir, jax_dir):
            assert _predict_cli(paths, model_dir, *extra) == 0
            assert _predicted(model_dir) == want, (extra, model_dir)
        got = torch_predict(**paths, model_path=torch_dir, batch_size=3,
                            device="cpu", **beam)
        assert got == ref


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("what", ["stream", "align", "pseudolabel",
                                  "timestamps", "lm_order"])
def test_seq2seq_refusals_match_jax(slice_setup, seq2seq_dirs, what):
    """Streaming, forced alignment, pseudo-labels, --timestamps and LM
    fusion refuse the seq2seq family through the port's CLI with the JAX
    package's ValueError, word for word."""
    paths, alphabet, _, _, _ = slice_setup
    jcfg, jax_dir, torch_dir = seq2seq_dirs
    if what == "stream":
        jparams = jax_load_model(jax_dir, JAlphabet.load(
            paths["alphabet_path"]))[0]
        want = _jax_error(lambda: JStreamingTranscriber(
            jparams, jcfg, JAlphabet.load(paths["alphabet_path"])))
        argv = ["--mode", "stream", "--corpus_path",
                os.path.dirname(paths["test_path"]), "--wav",
                load_manifest(paths["test_path"],
                              paths["aud_path"])[0].audio_path]
    elif what == "align":
        want = _jax_error(lambda: jax_align(**paths, model_path=jax_dir))
        argv = ["--mode", "align", "--test_path", paths["test_path"]]
    elif what == "pseudolabel":
        want = _jax_error(lambda: jax_pseudo_label(
            paths["aud_path"], paths["alphabet_path"], jax_dir))
        argv = ["--mode", "pseudolabel"]
    elif what == "timestamps":
        want = _jax_error(lambda: jax_predict(**paths, model_path=jax_dir,
                                              timestamps=True))
        argv = ["--mode", "predict", "--timestamps", "--test_path",
                paths["test_path"]]
    else:
        want = _jax_error(lambda: jax_predict(**paths, model_path=jax_dir,
                                              decoder="beam", lm_order=2))
        argv = ["--mode", "predict", "--decoder", "beam", "--lm_order", "2",
                "--test_path", paths["test_path"]]
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, "--aud_path", paths["aud_path"], "--alphabet",
                  paths["alphabet_path"], "--model_path", torch_dir,
                  "--device", "cpu"])
    assert str(e.value) == want


def test_cli_other_modes_not_ported(tmp_path):
    # every mode is ported, the switch-MoE transformer's export too
    # (tests/test_torch_moe.py), its expert mesh too
    # (tests/test_torch_expert.py), its model x expert mesh too
    # (tests/test_torch_tensor.py), and a pipe mesh too
    # (tests/test_torch_pipeline.py): finetune_pg's ranks of a pipe group
    # are replicas of the model axis's step, as the JAX package's
    # replicated step, so the mesh takes the switch-MoE; training refuses it
    # before any rank starts, with the JAX package's message
    argv = ["--model", "moe", "--mesh", "pipe=2,model=2", "--corpus_path",
            str(tmp_path / "corpus"), "--model_path", str(tmp_path),
            "--device", "cpu"]
    args = cli.build_parser().parse_args(["--mode", "finetune_pg", *argv])
    assert cli._mesh_world(args) == 4
    with pytest.raises(SystemExit) as e:
        cli.main(["--mode", "train", *argv])
    assert "'pipe' axis requires the dense transformer family" in str(
        e.value)


def _run(code_or_args, **kw):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_VISIBLE_DEVICES",)}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, *code_or_args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120, **kw)


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import pg_asr_tpu_torch.predict, pg_asr_tpu_torch.cli\n"
            "import pg_asr_tpu_torch.ops.cuda_lstm, pg_asr_tpu_torch.convert\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_device_cuda_without_gpu_exits_nonzero(slice_setup):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    paths, _, _, _, torch_dir = slice_setup
    proc = _run(["-m", "pg_asr_tpu_torch", "--mode", "predict",
                 "--test_path", paths["test_path"], "--aud_path",
                 paths["aud_path"], "--alphabet", paths["alphabet_path"],
                 "--model_path", torch_dir, "--device", "cuda"])
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr


@pytest.mark.parametrize("ema_decay,with_ema,served", [
    (0.0, True, "params"), (0.999, True, "ema_params"),
    (0.999, False, "params")])
def test_load_model_serves_ema_params_as_the_jax_package(
        slice_setup, tmp_path, capsys, ema_decay, with_ema, served):
    """pg_asr_tpu/predict.py: with train.ema_decay > 0 the checkpoint's
    ema_params are served, else (or when it has none) its params."""
    _, alphabet, cfg, _, torch_dir = slice_setup
    params = load_checkpoint(os.path.join(torch_dir, "model_best.pt"))[
        "params"]
    state = {"params": params}
    if with_ema:
        state["ema_params"] = {k: v + 1.0 for k, v in params.items()}
    save_checkpoint_pt(os.path.join(tmp_path, "model_best.pt"), state)
    ecfg = cfg.replace(train=cfg.train.__class__(
        **{**cfg.train.__dict__, "ema_decay": ema_decay}))
    got, _ = load_model(str(tmp_path), alphabet, config=ecfg, device="cpu")
    want = state[served]
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k].to(got[k].dtype), rtol=0,
                                   atol=0)
    said = "predates EMA" in capsys.readouterr().out
    assert said == (ema_decay > 0 and not with_ema)
