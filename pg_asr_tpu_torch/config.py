"""Configuration dataclasses (counterpart of pg_asr_tpu/config.py).

A copy of the JAX package's schema, field for field, so that one
``config.json`` reads in both packages (tests/test_torch_imports.py round-trips
a file written by each package through the other). The port reads only the
fields of what it has ported; the rest are carried so that nothing is lost
when a config written by the JAX package is loaded and written again.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class FeatureConfig:
    """On-device feature frontend (ops/features.py)."""

    kind: str = "logmel"  # "logmel" (north star) | "mfcc" (reference parity, 120-dim)
    sample_rate: int = 16000
    n_fft: int = 400
    win_length: int = 400
    hop_length: int = 200
    n_mels: int = 80
    n_mfcc: int = 40  # per-block coeffs for mfcc mode (x3 with deltas = 120)
    fmin: float = 0.0
    fmax: float | None = None  # None -> sample_rate / 2
    mel_scale: str = "htk"  # "htk" | "slaney"
    log_floor: float = 1e-10
    add_deltas: bool = True  # mfcc mode: append delta + delta-delta (120-dim parity)
    delta_window: int = 2  # ComputeDeltas win_length=5 <-> n=2

    @property
    def feature_dim(self) -> int:
        if self.kind == "mfcc":
            return self.n_mfcc * (3 if self.add_deltas else 1)
        return self.n_mels


@dataclass(frozen=True)
class TextConfig:
    """Label units (data/bpe.py). "char" = reference parity (alphabet.txt);
    "bpe" = subword units trained by `--mode preproc --units bpe` — shorter
    label sequences (smaller CTC/transducer lattices) and better rare-word
    generalization."""

    units: str = "char"  # "char" | "bpe"
    bpe_vocab_size: int = 256  # preproc: target vocabulary incl. pad


@dataclass(frozen=True)
class ModelConfig:
    """BiLSTM-CTC acoustic model (models/bilstm_ctc.py).

    Defaults mirror the reference encoder (reference model.py:34-56):
    feature norm -> Linear(F->512) -> leaky_relu -> dropout ->
    3x BiLSTM(hidden 256/dir) -> Linear(512 -> alphabet) -> log_softmax.
    """

    family: str = "ctc"  # "ctc" (flagship) | "transformer" | "conformer" (non-recurrent CTC families) | "transducer" (RNN-T) | "seq2seq" (attention decoder family)
    vocab_size: int = 32  # alphabet incl. blank/pad at index 0
    input_dim: int = 80
    input_proj_dim: int = 512
    hidden_size: int = 256  # per direction
    num_layers: int = 3
    dropout: float = 0.3
    # Pallas fused-gate LSTM kernels (fwd + bwd). "auto" = on for
    # single-device TPU (measured 1.77x over the XLA scan at the bench
    # shape); multi-device SPMD and CPU use the lax.scan path (pallas_call
    # needs shard_map integration to partition — future work).
    use_pallas_lstm: bool | str = "auto"
    dtype: str = "float32"  # compute dtype for activations ("bfloat16" on TPU)
    # rematerialize each attention-family encoder block in the backward
    # pass (jax.checkpoint): activation memory drops from O(layers) to
    # O(1) blocks at ~1/3 extra FLOPs — the standard TPU memory/compute
    # trade for long utterances / big batches
    remat: bool = False


@dataclass(frozen=True)
class SpecAugmentConfig:
    """Train-time SpecAugment (ops/augment.py) — beyond-reference, off by
    default; masks are filled with the utterance mean on device."""

    enabled: bool = False
    time_masks: int = 2
    time_width: int = 40  # max frames per time mask
    freq_masks: int = 2
    freq_width: int = 15  # max channels per frequency mask
    # waveform-level augmentation (ops/augment.wave_augment, applied before
    # the on-device frontend when `enabled`); all off at these defaults
    speed_min: float = 1.0  # per-utterance resample factor ~ U[min, max]
    speed_max: float = 1.0  # Kaldi-style 0.9/1.1 typical
    noise_std: float = 0.0  # additive white noise, std relative to RMS
    gain_db: float = 0.0  # per-utterance gain ~ U[-g, +g] dB


@dataclass(frozen=True)
class TransformerConfig:
    """Transformer-CTC acoustic model (models/transformer_ctc.py).

    A TPU-first alternative encoder family with no recurrence: the BiLSTM's
    sequential dependency chain is the measured throughput floor of the
    flagship model (docs/PERF.md), and a self-attention encoder replaces it
    with pure batched MXU matmuls. Frame-stacking subsampling (reshape +
    one matmul — no convs/gathers) shrinks T by `subsample` before the
    blocks. Same CTC head/loss/decoders as the flagship family.
    """

    num_layers: int = 6
    d_model: int = 256
    num_heads: int = 4
    ffn_dim: int = 1024
    dropout: float = 0.1
    # char-level CTC needs T' >= 2*label_len+1; at 12.5ms/frame (hop 200)
    # subsample=2 keeps ~40 output frames/sec — safe for character targets
    subsample: int = 2
    # MHSA via the Pallas TPU flash kernel (ops/flash_attn.py): tiled
    # online softmax, never materializes (B,H,T,T) scores in HBM. T' pads
    # up to the 128-frame block. Off-TPU (CPU tests/dryruns) and at
    # non-aligned T the dense einsum path is used automatically.
    flash_attention: bool = False
    # > 0: replace every block's dense FFN with a switch-routed
    # Mixture-of-Experts FFN of this many experts (parallel/moe.py); the
    # expert axis shards over an ('expert',) mesh axis (--mesh)
    num_experts: int = 0
    capacity_factor: float = 1.25  # expert capacity = tokens/E * factor
    moe_aux_weight: float = 0.01  # load-balance auxiliary loss weight


@dataclass(frozen=True)
class ConformerConfig:
    """Conformer-CTC acoustic model (models/conformer_ctc.py).

    Convolution-augmented attention encoder (Gulati et al. 2020) — the
    standard high-accuracy ASR encoder; attention for global context plus a
    depthwise-conv module for local context. TPU-first deviations from the
    paper (rotary positions instead of rel-pos attention, LayerNorm instead
    of BatchNorm in the conv module, frame-stacking subsampling) are
    documented in the model file.
    """

    num_layers: int = 6
    d_model: int = 256
    num_heads: int = 4
    ffn_dim: int = 1024
    conv_kernel: int = 15
    dropout: float = 0.1
    subsample: int = 2  # same T'>=2*label_len+1 consideration as transformer
    # same semantics as TransformerConfig.flash_attention (rotary q/k are
    # rotated BEFORE the kernel — rotary composes with any attention impl)
    flash_attention: bool = False
    # Attention scores + softmax in the compute dtype (bf16) instead of
    # f32. Measured 5.7%/step faster on the conformer at bench shapes
    # (13.72 -> 12.94 ms, benchmarks/attn_softmax_ab.py) with identical
    # convergence on the synthetic-corpus CER check (docs/PERF.md r5);
    # max-subtraction keeps the exp stable and the sum spans <= a few
    # hundred keys, so the attention-weight error is ~1e-2 relative.
    # Set False for bit-level f32-softmax parity with r4 checkpoints'
    # training curves (eval/decode outputs are unaffected either way
    # beyond normal bf16 noise). The transformer family measured a WASH
    # (9.50 vs 9.47 ms) and keeps f32 softmax unconditionally.
    attn_softmax_bf16: bool = True


@dataclass(frozen=True)
class TransducerConfig:
    """RNN-T transducer model family (models/transducer.py).

    Beyond-reference: the standard streaming-ASR objective/architecture
    (Graves 2012) — encoder backbone (reusing any acoustic encoder family)
    + label-history prediction network + joint network, trained with the
    on-chip lattice loss (ops/transducer.py)."""

    encoder: str = "conformer"  # "bilstm" | "transformer" | "conformer"
    pred_embed_dim: int = 128
    pred_hidden: int = 256
    joint_dim: int = 256
    max_symbols_per_frame: int = 4  # greedy-decode expansion cap per frame
    # > 0: hybrid training L = L_rnnt + ctc_weight * L_ctc through an
    # auxiliary CTC head on the encoder (standard convergence aid; adds the
    # head's params, so it round-trips through config.json)
    ctc_weight: float = 0.0
    # Pallas fused joint-lattice kernel (ops/pallas_joint.py): computes the
    # (B,T,U+1)/(B,T,U) emission tables straight from the e/g projections,
    # never materializing the 4-D tanh joint in HBM. MEASURED SLOWER than
    # the unfused XLA path at bench shapes (19.2 vs 3.9 ms fwd+bwd, v5e,
    # B=64 T=201 U=64 J=256 A=32 bf16): XLA's operand fusion + bf16 already
    # handle the 4-D joint near its compute floor, while the kernel pays
    # f32 VPU tanh and 32/128 lane padding on the head matmul. Kept as an
    # opt-in for other shapes (docs/PERF.md "RNN-T joint" section).
    fused_joint: bool | str = False


@dataclass(frozen=True)
class Seq2SeqConfig:
    """Attention seq2seq model family (models/seq2seq.py).

    The reference's intended-but-unfinished decoder contract
    (reference model.py:123-173, dead v1): embed(A,128) -> LSTM(128->512)
    teacher-forced, dot attention over encoder states, Linear(2*512 -> A),
    log_softmax, output (T_dec, B, A).
    """

    vocab_size: int = 32
    embed_dim: int = 128
    dec_hidden: int = 512
    dropout: float = 0.3


@dataclass(frozen=True)
class DecodeConfig:
    beam_size: int = 16  # reference eval used 5 (reference model.py:324)
    blank: int = 0
    max_label_len: int = 256
    # Per-frame top-M symbol cap for the fused CTC beam search
    # (decoding/beam.py). Measured LOSSLESS at >= 4 on trained posteriors
    # (identical CER/WER to the exact search on both a converged and an
    # undertrained checkpoint — docs/PERF.md beam-prune table); 6 keeps a
    # 50% margin and is ~1.25x faster end to end. 0 = exact search
    # (keeps all beam_size+2 per-frame candidates).
    beam_prune: int = 6


@dataclass(frozen=True)
class RLConfig:
    """REINFORCE fine-tune (rl/reinforce.py) — the loop the reference only
    sketched via its orphaned reward() (reference policy_grad.py:4-16)."""

    num_samples: int = 4  # sampled alignment paths per utterance
    temperature: float = 1.0
    baseline: str = "greedy"  # "greedy" | "mean" | "none"
    entropy_weight: float = 0.01
    ctc_mix_weight: float = 0.1  # supervised CTC anchor mixed into the PG loss
    reward: str = "neg_cer"  # "neg_cer" | "neg_wer" | "stepwise_ed" (reference parity)
    # alphabet id of " " — required by reward="neg_wer" (word segmentation
    # on-chip); finetune_pg resolves it from the loaded alphabet
    space_id: int = -1
    # "reinforce" (sampled alignment paths, the reference's sketched loop) |
    # "mwer" (expected CER over the on-device K-best list, renormalized
    # posteriors — the standard production discriminative objective)
    objective: str = "reinforce"
    mwer_beam: int = 4  # K of the n-best list when objective="mwer"


@dataclass(frozen=True)
class TrainConfig:
    num_epochs: int = 10  # reference default (reference main.py:22)
    batch_size: int = 32  # reference default (reference main.py:23)
    learning_rate: float = 5e-4  # reference (commented) Adam lr (reference model.py:207)
    weight_decay: float = 0.0
    grad_clip: float = 5.0
    warmup_steps: int = 500
    # "warmup_constant" (reference-like fixed lr after warmup) |
    # "warmup_cosine" (cosine decay over decay_steps; train() derives
    # decay_steps from the manifest when left at 0)
    lr_schedule: str = "warmup_constant"
    decay_steps: int = 0
    lr_end_factor: float = 0.01  # cosine floor as a fraction of peak lr
    # >1: accumulate gradients over N micro-batches before each optimizer
    # update (optax.MultiSteps) — large effective batches without the memory
    accum_steps: int = 1
    # "loss" (reference parity: best checkpoint on val loss) | "cer" (decode
    # the dev set each validation pass and select on corpus CER)
    val_metric: str = "loss"
    # > 0: also save model_last every N steps WITHIN an epoch, recording the
    # batch position; resume replays the interrupted epoch's exact batch
    # order and continues from the next batch (preemption safety for long
    # epochs — the reference loses the whole run, SURVEY §5)
    save_every_steps: int = 0
    # > 0: also retain a rolling window of the newest K per-epoch
    # snapshots (model_epochNNNN.ckpt) for checkpoint averaging at
    # predict time (--ckpt avg)
    keep_ckpts: int = 0
    # > 0: maintain an exponential moving average of the parameters
    # (ema = d*ema + (1-d)*params after every step); validation, best-
    # checkpoint selection, and predict then use the EMA weights
    ema_decay: float = 0.0
    seed: int = 0
    # path to a reference torch checkpoint (model_best.pth) to warm-start
    # from when no pg_asr_tpu checkpoint exists (models/torch_import.py) —
    # the migration path for reference users' trained models
    init_from_torch: str = ""
    # allow full (arbitrary-code) unpickling of init_from_torch when the
    # safe weights_only load fails — ONLY for checkpoints from trusted
    # sources (torch.save(model, ...) pickles whole modules)
    trust_torch_pickle: bool = False
    max_frames: int = 1600  # padded-length cap (frames)
    max_label_len: int = 256
    bucket_frame_quantum: int = 128  # pad T up to a multiple -> few jit shapes
    log_every: int = 10
    eval_every_epochs: int = 1
    prefetch_depth: int = 2  # host batches built ahead of the device (0 = off)
    # decode workers building batches ahead of the prefetch/staging thread
    # (data/dataset.BatchIterator num_workers; 0 = inline). The native WAV
    # decoder releases the GIL, so workers scale with host cores; the
    # prefetch producer is then free to spend its time on device staging.
    # -1 = auto: 2 on hosts with >= 4 cores, 0 otherwise — on a 1-core
    # host extra threads only thrash the GIL (measured: 5.1k -> 3.5k
    # utts/s uncached e2e, docs/PERF.md r3)
    loader_threads: int = -1
    # built-batch RAM cache budget (MB, 0 = off): bucketed batch composition
    # is identical across epochs, so corpora that fit the budget pay disk
    # read + WAV decode + padding only in epoch 1 — steady-state epochs
    # stream straight from memory (data/dataset.BatchIterator)
    cache_audio_mb: float = 0.0
    # device mesh for the training step; the CLI surfaces this as
    # --mesh data=2,pipe=2 (parallel/driver.py routes the step through the
    # data/model/pipe/seq/expert strategy libraries per the live axes)
    mesh_shape: tuple[int, ...] = ()  # () -> all devices on 'data'
    mesh_axes: tuple[str, ...] = ("data",)
    # pipeline parallelism: microbatches per global batch (0 -> the pipe
    # axis size; the GPipe bubble fraction is (S-1)/(M+S-1))
    pipeline_microbatches: int = 0


@dataclass(frozen=True)
class Config:
    features: FeatureConfig = field(default_factory=FeatureConfig)
    text: TextConfig = field(default_factory=TextConfig)
    augment: SpecAugmentConfig = field(default_factory=SpecAugmentConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    conformer: ConformerConfig = field(default_factory=ConformerConfig)
    transducer: TransducerConfig = field(default_factory=TransducerConfig)
    seq2seq: Seq2SeqConfig = field(default_factory=Seq2SeqConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    rl: RLConfig = field(default_factory=RLConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s: str) -> "Config":
        raw = json.loads(s)

        def build(cls, d):
            kw = {}
            for f in dataclasses.fields(cls):
                if f.name not in d:
                    continue
                v = d[f.name]
                if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
                    v = build(f.type, v)
                kw[f.name] = v
            return cls(**kw)

        sub = {
            "features": FeatureConfig,
            "text": TextConfig,
            "augment": SpecAugmentConfig,
            "model": ModelConfig,
            "transformer": TransformerConfig,
            "conformer": ConformerConfig,
            "transducer": TransducerConfig,
            "seq2seq": Seq2SeqConfig,
            "decode": DecodeConfig,
            "rl": RLConfig,
            "train": TrainConfig,
        }
        kw = {}
        for name, cls in sub.items():
            if name in raw:
                d = dict(raw[name])
                for f in dataclasses.fields(cls):
                    if f.name in d and isinstance(d[f.name], list):
                        d[f.name] = tuple(d[f.name])
                kw[name] = cls(**{k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}})
        return Config(**kw)
