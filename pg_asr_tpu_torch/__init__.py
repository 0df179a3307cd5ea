"""PyTorch / CUDA port of pg_asr_tpu (the JAX package stays the reference).

The port follows the JAX package's module layout so that every module's
counterpart is easy to find (``pg_asr_tpu/ops/lstm.py`` <->
``pg_asr_tpu_torch/ops/lstm.py``). It imports ``torch`` and never ``jax``;
the JAX package's jax-free modules (``config``, ``data.*``, ``metrics``,
``cli.build_parser``) are reused by import, the config and data ones through
this package's ``config`` and ``data`` modules.

Ported so far: batch transcription (``--mode predict``) of the BiLSTM-CTC
family with greedy decoding. The LSTM recurrence on CUDA tensors runs in a
hand-written kernel (``csrc/lstm_fwd.cu``); on CPU tensors it runs the plain
PyTorch version of the same function.
"""

import torch


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
