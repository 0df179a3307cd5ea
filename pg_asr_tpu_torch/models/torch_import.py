"""Import the reference repository's PyTorch checkpoints (`model_best.pth`)
into the port's state dicts (counterpart of
pg_asr_tpu/models/torch_import.py), the migration path of ``--init_from_torch``.

The reference model is ``Seq2Seq(encoder=Encoder(), decoder=Decoder(A,
512))``, whose trainable tensors are

  encoder.input_layer.{weight,bias}          Linear(120 -> 512)
  encoder.blstm.weight_ih_l{k}[_reverse]     (4H, in)  k = 0..2, H = 256
  encoder.blstm.weight_hh_l{k}[_reverse]     (4H, H)
  encoder.blstm.bias_ih_l{k}[_reverse]       (4H,)
  encoder.blstm.bias_hh_l{k}[_reverse]       (4H,)
  decoder.embed_layer.weight, decoder.lstm.*  (the seq2seq decoder)

torch packs LSTM gates [i, f, g, o] in row blocks, the order of the port's
columns, so ``W = weight_ih.T``, ``U = weight_hh.T``, ``b = bias_ih +
bias_hh``; a bidirectional output is [forward | backward], as the port's;
``input_layer.weight`` is (out, in) and the port's linears (in, out). A
``nn.DataParallel`` checkpoint's ``module.`` prefix is stripped. The CTC
head (for the transducer the prediction network and joint, for the
seq2seq family its output linear, which the reference's active decoder
never built) keep their fresh initialisation; the report says so.
"""

from __future__ import annotations

import torch


def load_torch_state_dict(path: str, allow_pickle: bool = False
                          ) -> dict[str, torch.Tensor]:
    """A reference checkpoint as {name: float32 tensor}: a state dict, or
    (only with allow_pickle) a pickled nn.Module. Loads with
    ``weights_only=True``; full unpickling runs code embedded in the file,
    so it is for trusted files only (``train.trust_torch_pickle``)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        if not allow_pickle:
            raise ValueError(
                f"{path!r} is not a plain-tensor checkpoint "
                "(weights_only load failed). If it is a pickled nn.Module "
                "from a TRUSTED source, re-run with allow_pickle=True "
                "(CLI: --trust_torch_pickle); unpickling an untrusted file "
                f"executes arbitrary code. Original error: {e}") from e
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict") and callable(obj.state_dict):
        obj = obj.state_dict()
    if not isinstance(obj, dict):
        raise ValueError(
            f"{path!r} does not contain a state dict or module "
            f"(got {type(obj).__name__})")
    return {k.removeprefix("module."): v.detach().float()
            for k, v in obj.items() if isinstance(v, torch.Tensor)}


def _take(sd: dict, key: str, want_shape: tuple, used: set) -> torch.Tensor:
    if key not in sd:
        raise KeyError(f"torch checkpoint is missing {key!r}")
    v = sd[key]
    if tuple(v.shape) != tuple(want_shape):
        hint = ""
        if key.endswith("input_layer.weight"):
            hint = (" — the reference consumes 120-dim MFCC+deltas features;"
                    " train with --features mfcc so input_dim matches")
        raise ValueError(
            f"shape mismatch for {key!r}: checkpoint {tuple(v.shape)} vs "
            f"model {tuple(want_shape)}{hint}")
    used.add(key)
    return v


def import_encoder(sd: dict, params: dict, used: set, dst: str = "",
                   prefix: str = "encoder.") -> dict[str, torch.Tensor]:
    """The reference Encoder mapped onto the port's BiLSTM encoder names
    (``{dst}input_proj.{w,b}``, ``{dst}lstm.{k}.{fwd,bwd}.{W,U,b}``), each
    cast to the dtype and device of the tensor it replaces."""
    out = {}

    def put(name: str, value: torch.Tensor) -> None:
        old = params[dst + name]
        out[dst + name] = value.to(dtype=old.dtype, device=old.device)

    w = params[dst + "input_proj.w"]
    put("input_proj.w", _take(sd, f"{prefix}input_layer.weight",
                              tuple(w.shape[::-1]), used).T)
    put("input_proj.b", _take(sd, f"{prefix}input_layer.bias",
                              tuple(params[dst + "input_proj.b"].shape), used))
    k = 0
    while f"{dst}lstm.{k}.fwd.W" in params:
        for d, sfx in (("fwd", f"_l{k}"), ("bwd", f"_l{k}_reverse")):
            out.update(import_lstm(sd, params, used, f"{dst}lstm.{k}.{d}",
                                   f"{prefix}blstm.", sfx))
        k += 1
    return out


def import_lstm(sd: dict, params: dict, used: set, name: str, prefix: str,
                sfx: str = "_l0") -> dict[str, torch.Tensor]:
    """One direction of one layer of a torch LSTM (``{prefix}weight_ih{sfx}``
    ...) onto ``{name}.{W,U,b}``, each cast to the dtype and device of the
    tensor it replaces."""
    W, U, b = (params[f"{name}.{x}"] for x in "WUb")
    out = {
        "W": _take(sd, f"{prefix}weight_ih{sfx}", tuple(W.shape[::-1]),
                   used).T,
        "U": _take(sd, f"{prefix}weight_hh{sfx}", tuple(U.shape[::-1]),
                   used).T,
        "b": (_take(sd, f"{prefix}bias_ih{sfx}", tuple(b.shape), used)
              + _take(sd, f"{prefix}bias_hh{sfx}", tuple(b.shape), used)),
    }
    return {f"{name}.{k}": v.to(dtype=params[f"{name}.{k}"].dtype,
                                device=params[f"{name}.{k}"].device)
            for k, v in out.items()}


def init_from_torch_checkpoint(path: str, params: dict, cfg,
                               allow_pickle: bool = False
                               ) -> tuple[dict, str]:
    """Warm-start `params` (a fresh init of cfg.model.family) from a
    reference checkpoint. Returns (new params, report). Families: "ctc"
    (the encoder; the CTC head stays fresh), "transducer" with the bilstm
    encoder (the encoder; prediction network and joint stay fresh) and
    "seq2seq" (the encoder, the decoder's embedding and LSTM; the output
    linear stays fresh). The attention families have no counterpart in the
    reference."""
    family = cfg.model.family
    if family == "transducer" and cfg.transducer.encoder != "bilstm":
        raise ValueError("--init_from_torch supports the transducer family "
                         "only with the bilstm encoder backbone")
    if family not in ("ctc", "transducer", "seq2seq"):
        raise ValueError(
            f"--init_from_torch: no reference torch counterpart for model "
            f"family {family!r} (supported: ctc, transducer, seq2seq)")
    sd = load_torch_state_dict(path, allow_pickle=allow_pickle)
    used: set[str] = set()
    dst = "" if family == "ctc" else "encoder."
    new = {**params, **import_encoder(sd, params, used, dst)}
    imported = ("input_proj.", "lstm.", "encoder.")
    if family == "seq2seq":
        emb = params["embed"]
        new["embed"] = _take(sd, "decoder.embed_layer.weight",
                             tuple(emb.shape), used).to(dtype=emb.dtype,
                                                        device=emb.device)
        new.update(import_lstm(sd, params, used, "dec_lstm",
                               "decoder.lstm."))
        imported += ("embed", "dec_lstm.")
    fresh = list(dict.fromkeys(k.split(".")[0] for k in params
                               if not k.startswith(imported)))
    unused = sorted(set(sd) - used)
    report = (f"imported {len(used)} tensors from {path}"
              + (f"; fresh (no torch source): {', '.join(fresh)}" if fresh
                 else "")
              + (f"; unused torch keys: {', '.join(unused)}" if unused
                 else ""))
    return new, report
