"""PyTorch / CUDA port of pg_asr_tpu (the JAX package stays the reference).

The port follows the JAX package's module layout so that every module's
counterpart is easy to find (``pg_asr_tpu/ops/lstm.py`` <->
``pg_asr_tpu_torch/ops/lstm.py``). It imports ``torch`` and never ``jax``;
it imports nothing of the JAX package either, not even its modules that do
not import JAX: what it needs of them (``config``, ``data``, ``metrics``,
the CLI's flags) it keeps as its own copies.

Ported so far: training (``--mode train``), batch transcription
(``--mode predict``) and policy-gradient fine-tuning (``--mode
finetune_pg``, ``rl/``) of the BiLSTM-CTC, transformer-CTC and
conformer-CTC families and the switch-MoE transformer (``--model moe``,
``parallel/moe.py``) (greedy or CTC prefix beam; REINFORCE or MWER), of
the RNN-T transducer (greedy or its own beam search,
``decoding/transducer.py``; MWER; any of the three encoders) and of the
attention seq2seq (``models/seq2seq.py``: greedy or the decoder's beam
search; SCST or MWER); the corpus
tools: ``--mode preproc`` (text normalisation, LibriSpeech trees, BPE
units with the native segmenter, ``data/``), ``--mode align``
(``alignment.py``, ``ops/align.py``), ``--mode pseudolabel``
(``selftrain.py``) and ``--timestamps``; streaming transcription
(``serving.py``, ``--mode stream``: single streams and S streams in
lockstep); LM fusion into the CTC beam (``--lm_order``: an n-gram table,
``decoding/lm.py``, or an LSTM LM, ``decoding/neural_lm.py``, fused in
the search, offline and streamed, or re-ranking the n-best,
``decoding/rescore.py``); the JAX package's flax ``.ckpt`` model
directories and neural LMs, read without flax or msgpack
(``checkpoint.read_flax_checkpoint``); and ``--mode export``
(``exporting.py``): the serving program of any ported family as one
``torch.export`` artifact, float32 or weight-only int8 (``ops/quant.py``),
its kernels the registered ``pgasr`` operators (``ops/registry.py``);
``--debug_nans`` (``utils/debug.py``); every mesh axis of the JAX CLI
(``--mesh data=N``, ``model=T``, ``pipe=S`` with ``--microbatches``,
``seq=Q``, ``expert=X``, ``fsdp=F``, ``data`` with one of the others,
``model=T`` with ``expert=X`` or ``pipe=S``, for train and finetune_pg:
a rank process a mesh position over torch.distributed,
``parallel/mesh.py``; Megatron tensor parallelism over ``model``,
``parallel/tensor.py``; GPipe pipeline stages of the transformer-CTC's
blocks over ``pipe``, ``parallel/pipeline.py``; its frames over ``seq``,
``parallel/sequence.py``; the switch-MoE's experts split over ``expert``,
the parameters and the AdamW state over ``fsdp``, ``parallel/moe.py``,
``parallel/fsdp.py``; the CLI starts the ranks, or the user does with
``PGASR_DISTRIBUTED=1``) and the elastic supervisor (``--max_restarts``,
``--fault_step``, ``utils/elastic.py``).
Their CPU tests
hold each against the JAX package (``tests/test_torch_*.py``);
``chip_smoke.py`` phases 12, 13, 15, 16 and 18-21 run them on the
card. On CUDA tensors the LSTM recurrence runs in hand-written kernels
(``csrc/lstm_fwd.cu``, forward in its inference and residual forms;
``csrc/lstm_bwd.cu``, its gradient; each launches one direction, as for
the seq2seq decoder's and the neural LM's teacher-forced passes, or, for
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
