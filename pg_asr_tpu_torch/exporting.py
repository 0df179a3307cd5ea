"""Ahead-of-time model export for deployment (`--mode export`, counterpart
of pg_asr_tpu/exporting.py).

Serializes the whole serving computation of a trained model dir, raw
waveform -> features -> encoder forward -> decode -> token ids, into one
``torch.export`` program (``torch.export.save``), with the trained weights
stored in it. A caller loads it with ``ExportedModel(export_dir,
device=...)`` and needs no model or config code.

Unlike the JAX package's StableHLO artifact, the program depends on this
package: the hand-written kernels of the serving path are the registered
operators ``pgasr::bilstm_fwd``, ``pgasr::ctc_beam`` and
``pgasr::flash_attn`` (ops/registry.py), which ``torch.export`` keeps as
single nodes, so they must be registered before the program loads.
``ExportedModel`` imports the registry; on a CUDA device the kernels build
from the package's sources at their first call (pg_asr_tpu_torch/_build.py)
and on the CPU their plain versions run. The manifest says so
(``"requires"``).

Artifacts written to `<model_path>/export/`:
  * `serving.pt2`   — the exported program, its weights included
  * `manifest.json` — the input/output contract: shapes, dtypes, family,
    decoder, sample rate, the device the program is stored for, its
    platforms and the id->piece alphabet, so that any consumer can map
    token ids to text

Shapes are static: the caller picks `--export_batch` and
`--export_seconds`; shorter utterances are zero-padded and pass their
true `num_samples`. The transducer decoders' frame loops are one ``scan``
each in the program (decoding/transducer.over_frames), so its size does
not grow with `--export_seconds`; the seq2seq decoders' steps
(``decode.max_label_len``) are unrolled. A program traced through the
``pgasr`` ops holds no device branch, so `--export_platforms cpu,cuda`
stores one program (for the CPU) that ``ExportedModel`` moves to either
device (``torch.export.passes.move_to_device_pass``).

On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 16, full-width
models at B=8 x 20 s) an export takes 1.4-22.9 s and gives a program of
127-1,238 nodes; an exported call launches the same kernels as the live
one and takes 1.0-1.8x its time, the excess being host time: the loaded
program runs each node from Python, and its scans store each step's
outputs (PERF.md).
"""

from __future__ import annotations

import io
import json
import os

import numpy as np
import torch

from . import resolve_device
from .config import Config
from .ops import registry  # noqa: F401  (registers the pgasr ops)
from .ops.quant import (LEAF_KEYS, dequantize_tree, is_quantized_leaf,
                        quantize_tree)
from .utils import debug

EXPORT_DIR = "export"
ARTIFACT = "serving.pt2"
MANIFEST = "manifest.json"
PLATFORMS = ("cpu", "cuda")
REQUIRES = "pg_asr_tpu_torch ops"


def make_serving_fn(params: dict, cfg: Config, decoder: str = "greedy",
                    beam_size: int = 0, quantize: str = ""):
    """The serving function (wave (B, N) float32, num_samples (B,) int32)
    -> (ids (B, L) int32 0-padded, lens (B,) int32), as a module holding
    `params` as buffers (what ``torch.export`` stores). Dispatches exactly
    like predict does.

    quantize="int8": weight-only per-channel int8 (ops/quant.py): the
    buffers are int8 and per-channel scales, dequantized in the program."""
    if quantize == "int8":
        return ServingModule(quantize_tree(params), cfg, decoder, beam_size)
    if quantize:
        raise ValueError(f"unknown quantize mode {quantize!r} "
                         "(supported: 'int8')")
    return ServingModule(params, cfg, decoder, beam_size)


def make_serving_fn_from(get_params, cfg: Config, decoder: str = "greedy",
                         beam_size: int = 0):
    """Serving fn where the parameter dict is produced by `get_params()`
    inside the traced call (the dict itself for float params; the
    dequantization for quantized ones)."""
    from .predict import (forward, forward_seq2seq, forward_seq2seq_beam,
                          forward_transducer)

    def int32(ids, lens):
        return ids.to(torch.int32), lens.to(torch.int32)

    family = cfg.model.family
    if family == "seq2seq":
        from .models.seq2seq import cut_at_eos

        if decoder == "beam" and beam_size > 1:
            def fn(wave, num_samples):
                return int32(*forward_seq2seq_beam(
                    get_params(), wave, num_samples, cfg,
                    beam_size=beam_size))
        else:
            def fn(wave, num_samples):
                tokens, _ = forward_seq2seq(get_params(), wave, num_samples,
                                            cfg)
                # cut at the first EOS (= pad id 0), on the device
                return int32(*cut_at_eos(tokens))
        return fn
    if family == "transducer":
        def fn(wave, num_samples):
            return int32(*forward_transducer(
                get_params(), wave, num_samples, cfg,
                beam_size=beam_size if decoder == "beam" else 0))
        return fn

    # the CTC families (ctc / transformer, dense or switch-MoE: its
    # capacity a constant of the static batch and length / conformer)
    from .decoding.beam import beam_decode
    from .decoding.greedy import greedy_decode

    def fn(wave, num_samples):
        log_probs, out_mask, out_lens = forward(get_params(), wave,
                                                num_samples, cfg)
        if decoder == "beam" and beam_size > 1:
            # the exact search (M = K + 2), not predict's decode.beam_prune
            ids, lens, _ = beam_decode(log_probs, out_lens,
                                       beam_size=beam_size,
                                       max_label_len=cfg.decode.max_label_len)
            return int32(ids, lens)
        return int32(*greedy_decode(log_probs, out_mask))
    return fn


class ServingModule(torch.nn.Module):
    """The serving function over a parameter dict held as buffers (a
    quantized leaf as its q8, s and d): the module ``torch.export``
    traces. Calling it runs the live path."""

    def __init__(self, params: dict, cfg: Config, decoder: str = "greedy",
                 beam_size: int = 0):
        super().__init__()
        self._names = []  # (parameter name, its buffer name(s))
        for i, (name, value) in enumerate(params.items()):
            if is_quantized_leaf(value):
                fields = {f: f"p{i}_{f}" for f in LEAF_KEYS}
                for f, buf in fields.items():
                    self.register_buffer(buf, value[f])
                self._names.append((name, fields))
            else:
                self.register_buffer(f"p{i}", value)
                self._names.append((name, f"p{i}"))
        self._fn = make_serving_fn_from(self.params, cfg, decoder, beam_size)

    def params(self) -> dict:
        """The parameter dict, quantized leaves dequantized."""
        tree = {name: ({f: getattr(self, b) for f, b in buf.items()}
                       if isinstance(buf, dict) else getattr(self, buf))
                for name, buf in self._names}
        return dequantize_tree(tree)

    def forward(self, wave: torch.Tensor, num_samples: torch.Tensor):
        return self._fn(wave, num_samples)


def graph_stats(ep) -> dict:
    """The program's node count (its scan bodies' included) and its
    ``pgasr::`` nodes by op name."""
    nodes, ops = 0, {}
    for gm in ep.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            nodes += 1
            name = getattr(node.target, "name", None)
            name = name() if callable(name) else None
            if name and name.startswith("pgasr::"):
                ops[name] = ops.get(name, 0) + 1
    return {"nodes": nodes, "pgasr_ops": ops}


def _check_platforms(platforms) -> tuple[str, ...]:
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(f"unknown export platform(s) {bad}: the port "
                         f"exports for {', '.join(PLATFORMS)}")
    return tuple(dict.fromkeys(platforms))


def export_model(model_path: str, corpus_path: str | None = None,
                 batch_size: int = 8, max_seconds: float = 20.0,
                 decoder: str = "greedy", beam_size: int = 0,
                 which: str = "best", platforms: tuple[str, ...] = (),
                 quantize: str = "", device: str = "cuda") -> dict:
    """Export a trained model dir (the port's or the JAX package's) for
    deployment, traced on `device`. Returns the manifest."""
    from .data.bpe import load_tokenizer
    from .predict import load_model, model_config

    platforms = _check_platforms(platforms)
    if quantize not in ("", "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r} "
                         "(supported: 'int8')")
    dev = resolve_device(device)
    cfg = model_config(model_path)
    tok_root = corpus_path or model_path
    try:
        alphabet = load_tokenizer(tok_root, cfg.text.units)
    except FileNotFoundError as e:
        if not corpus_path:
            raise FileNotFoundError(
                f"{e} — tokenizer artifacts (alphabet.txt / bpe.vocab) live "
                "in the CORPUS dir, not the model dir; pass --corpus_path")
        raise
    params, cfg = load_model(model_path, alphabet, config=cfg, which=which,
                             device=dev)
    if decoder == "beam" and beam_size <= 1:
        # predict's fallback, so that --decoder beam without --beam_size
        # exports a beam program, not a silent greedy one
        beam_size = cfg.decode.beam_size

    module = make_serving_fn(params, cfg, decoder=decoder,
                             beam_size=beam_size, quantize=quantize)
    n = int(max_seconds * cfg.features.sample_rate)
    example = (torch.zeros(batch_size, n, dtype=torch.float32, device=dev),
               torch.full((batch_size,), n, dtype=torch.int32, device=dev))
    with torch.no_grad():
        if debug.nan_checks_enabled():
            # --debug_nans: run the program once on its example input, with
            # its forward's outputs checked (nothing is read while tracing)
            module(*example)
        ep = torch.export.export(module, example)
    stats = graph_stats(ep)
    platforms = platforms or (dev.type,)
    # the device the program's tensors are on: the CPU where it may run
    # there (a CPU-only host can then load it), else the traced one
    stored_on = "cpu" if "cpu" in platforms else str(dev)
    if stored_on != str(dev):
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, stored_on)
    ep.example_inputs = None  # else saved with the program: B x N zeros
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = buf.getvalue()

    out_dir = os.path.join(model_path, EXPORT_DIR)
    os.makedirs(out_dir, exist_ok=True)
    art = os.path.join(out_dir, ARTIFACT)
    with open(art + ".tmp", "wb") as fo:
        fo.write(blob)
    os.replace(art + ".tmp", art)

    manifest = {
        "artifact": ARTIFACT,
        "family": cfg.model.family,
        "decoder": decoder,
        "beam_size": beam_size,
        "checkpoint": which,
        "sample_rate": cfg.features.sample_rate,
        "batch_size": batch_size,
        "max_samples": n,
        "inputs": {"wave": ["float32", [batch_size, n]],
                   "num_samples": ["int32", [batch_size]]},
        "outputs": {"ids": "int32 (B, L) 0-padded", "lens": "int32 (B,)"},
        "platforms": list(platforms),
        "quantize": quantize or "none",
        "blank_id": 0,
        "units": cfg.text.units,
        "alphabet": [alphabet.piece(i) for i in range(alphabet.size)],
        "bytes": len(blob),
        "requires": REQUIRES,
        "traced_on": dev.type,
        "stored_on": stored_on,
        "nodes": stats["nodes"],
        "pgasr_ops": stats["pgasr_ops"],
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as fo:
        json.dump(manifest, fo, indent=2)
    print(f"[export] wrote {art} ({len(blob) / 1e6:.1f} MB, "
          f"platforms={list(platforms)}, {stats['nodes']} nodes, "
          f"ops {stats['pgasr_ops']}) + {MANIFEST}")
    return manifest


class ExportedModel:
    """Load and run an exported artifact on `device` (one of the
    manifest's platforms): no model or config code needed, only the
    ``pgasr`` ops, which this module registers (ops/registry.py)."""

    def __init__(self, export_dir: str, device: str = "cuda"):
        with open(os.path.join(export_dir, MANIFEST)) as fo:
            self.manifest = json.load(fo)
        self.device = resolve_device(device)
        if self.device.type not in self.manifest["platforms"]:
            raise ValueError(
                f"the artifact in {export_dir} was exported for "
                f"{self.manifest['platforms']}, not {self.device.type} "
                "(export with --export_platforms cpu,cuda for both)")
        ep = torch.export.load(os.path.join(export_dir,
                                            self.manifest["artifact"]))
        if self.device != torch.device(self.manifest["stored_on"]):
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, self.device)
        self.program = ep
        self._fn = ep.module()

    def run(self, wave: torch.Tensor, num_samples: torch.Tensor):
        """The program on tensors of the exported shape, on this device
        -> (ids, lens) on the device. The features' convolution runs in
        full float32 as in the live path (ops/features.full_f32_conv)."""
        from .ops.features import full_f32_conv

        with torch.no_grad(), full_f32_conv():
            return self._fn(wave, num_samples)

    def __call__(self, wave: np.ndarray, num_samples: np.ndarray):
        """Pads/crops wave rows to the exported static shape and decodes.
        Returns (ids (B, L) int32, lens (B,) int32)."""
        B, N = self.manifest["batch_size"], self.manifest["max_samples"]
        if wave.shape[0] > B:
            raise ValueError(f"batch {wave.shape[0]} > exported batch {B}")
        buf = np.zeros((B, N), np.float32)
        m = min(N, wave.shape[1])
        buf[:wave.shape[0], :m] = wave[:, :m]
        ns = np.zeros((B,), np.int32)
        ns[:wave.shape[0]] = np.minimum(num_samples, m)
        ids, lens = self.run(torch.from_numpy(buf).to(self.device),
                             torch.from_numpy(ns).to(self.device))
        return (ids.cpu().numpy()[:wave.shape[0]],
                lens.cpu().numpy()[:wave.shape[0]])

    def decode_text(self, ids: np.ndarray, lens: np.ndarray) -> list[str]:
        pieces = self.manifest["alphabet"]
        return ["".join(pieces[t] for t in row[:n] if t != 0)
                for row, n in zip(ids, lens)]
