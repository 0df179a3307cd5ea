"""PyTorch / CUDA port of pg_asr_tpu (the JAX package stays the reference).

The port follows the JAX package's module layout so that every module's
counterpart is easy to find (``pg_asr_tpu/ops/lstm.py`` <->
``pg_asr_tpu_torch/ops/lstm.py``). It imports ``torch`` and never ``jax``;
it imports nothing of the JAX package either, not even its modules that do
not import JAX: what it needs of them (``config``, ``data``, ``metrics``,
the CLI's flags) it keeps as its own copies.

Ported so far: training (``--mode train``) and batch transcription
(``--mode predict``) of the BiLSTM-CTC, transformer-CTC and conformer-CTC
families (greedy or CTC prefix beam) and of the RNN-T transducer (greedy or
its own beam search, ``decoding/transducer.py``; any of the three
encoders). On CUDA tensors the LSTM recurrence runs in hand-written kernels
(``csrc/lstm_fwd.cu``, forward in its inference and residual forms;
``csrc/lstm_bwd.cu``, its gradient; each launches one direction or, for
``bilstm_layer(fuse_directions=True)``, both directions of a layer at
once), as do the CTC beam
search (``csrc/ctc_beam.cu``), with ``flash_attention`` the attention
(``csrc/flash_attn.cu``, forward in its inference and residual forms;
``csrc/flash_attn_bwd.cu``, its gradient) and, with the transducer's
``fused_joint``, its joint network and loss tables (``csrc/joint_fwd.cu``,
``csrc/joint_bwd.cu``); on CPU tensors the plain PyTorch versions of the
same functions run.
"""

import torch


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to pg_asr_tpu_torch (see ROADMAP.md); "
        "use the JAX package (main.py) for it")


def resolve_device(name: str) -> torch.device:
    """Parse a device string (``cuda``, ``cuda:N`` or ``cpu``). Asking for
    CUDA on a host without a usable GPU raises instead of running on CPU."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {name}: no CUDA device is available on this host "
                "(pass --device cpu to run the plain PyTorch path)")
        index = device.index if device.index is not None else 0
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"--device {name}: only {torch.cuda.device_count()} CUDA "
                "device(s) visible")
        return torch.device("cuda", index)
    if device.type != "cpu":
        raise RuntimeError(f"--device {name}: expected cuda, cuda:N or cpu")
    return device
