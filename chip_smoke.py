#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pg_asr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; nothing falls back to
the CPU or to a kernel's plain version):
  1. device: needs CUDA; prints the card's name and power limit.
  2. build: compiles the hand-written kernels from pg_asr_tpu_torch/csrc
     (one nvcc per source, started together), then the native WAV decoder
     (native/pgasr_io.cpp, host g++) that the loader uses and the native
     BPE segmenter (native/pgasr_bpe.cpp) that encodes BPE transcripts.
  3. kernels: each kernel vs its plain PyTorch version on the card at
     B=64, T=401, H=256 (5 s of audio, the default hidden size), float32
     and bfloat16, forward and reverse: lstm_fwd in its inference and
     residual forms, lstm_bwd with a random output gradient. Max and mean
     abs errors against stated bounds, each kernel's second launch equal
     bit for bit to its first, CUDA-event times (kernel and plain
     in turns), the time of cuDNN's nn.LSTM at the same shape as a
     yardstick, and the least time the card could take (bound).
  3b. beam kernel: ctc_beam vs the plain hash scan on the card at the
     beam's default batch and width (B=128, T=401, A=28, K=16) on sharp
     posteriors from a seed with ragged frame lengths, for the default
     prune (M=6 symbols per frame) and the exact search (M=18): labels,
     lens, parents and syms identical, nll within a stated bound; the
     n-best mode likewise; CUDA-event times in turns and the bound.
  3c. flash-attention kernel: flash_attn in its inference and residual
     forms vs its plain version (ops/flash_attn.mhsa_plain, with
     residuals=True for o, l and m) on the card at the conformer's
     attention shape at B=64 x 5 s (H=4, T'=201, dh=64), q, k, v read in
     place from a fused (B, T', 3, H, dh) projection, float32 and
     bfloat16, ragged lengths: max abs errors against stated bounds, the
     share of 64 x 64 tile pairs the kernel skips, times in turns with the
     kernels' launches queued behind a sleep kernel (device_ms, so that
     the card's time is measured, not the host's launches), the bound over
     the pairs the segment mask leaves, and F.scaled_dot_product_attention
     with the same boolean mask (without and with inputs that require
     grad), timed the same way.
  3d. flash-attention backward: at phase 3c's shape and inputs, float32
     and bfloat16, flash_attn_bwd_dkv and flash_attn_bwd_dq against
     mhsa_bwd_plain on the plain forward's l, m and a random output
     gradient: max and mean abs errors relative to max|grad|
     against stated bounds (in bf16 a control without the rounding of p
     and ds must exceed the mean bound), CUDA-event times in turns (the
     backward kernels' launches queued behind a sleep kernel, so that the
     card's time is measured, not the host's launches), each kernel's
     bound, the share of 64 x 64 tile pairs the kernels skip, and the
     backward as FlashAttention runs it (di, dkv, dq) beside that of
     F.scaled_dot_product_attention (its autograd.grad minus its forward).
  3e. fused RNN-T joint: joint_fwd and joint_bwd vs their plain versions
     (ops/joint.fused_joint_plain, fused_joint_bwd_plain) at the
     transducer's train shape at B=64 x 5 s (T'=201, U+1=61, J=256, A=28),
     float32 and bfloat16 inputs, ragged frame and label lengths, random
     cotangents on the cells the loss reads: errors against stated bounds
     (the tables absolute, the gradients relative to max|grad|), the
     backward run twice with equal bits, CUDA-event times in turns, each
     kernel's bound, and the port's unfused composition (forward, forward
     + backward) as the yardstick.
  3g. shapes past the first kernels' limits, each launched on its kernel
     (its counter rises by one a call) and held against its plain version
     within the bounds above: lstm_fwd (both forms) and lstm_bwd at phase
     3's B and T with H=512 float32, H=1024 bfloat16 and H=2048 in both
     (U's columns read from L2), timed; bilstm_fwd (both forms) and
     bilstm_bwd at H=1024, both types, each direction equal bit for bit
     to the single-direction kernels, timed in turns beside them;
     joint_fwd / joint_bwd at A=256, J=640 (B=4, T'=51, U=20, both types);
     flash_attn and its backward at dh=128, 256 and 512 (the wide kernels
     in two pieces) at phase 3c's shape, device-timed beside SDPA;
     ctc_beam over A=5000 at K=64 (the block form) and K=16 (the warp
     form), M=6 and exact, best and n-best (B=8, T=101).
  3f. fused-direction BiLSTM: bilstm_fwd (inference and residual forms)
     and bilstm_bwd vs their plain versions on the card at phase 3's shape
     (B=64, T=401, H=256 per direction), float32 and bfloat16, ragged
     lengths, against the phase 3 bounds; each direction equal bit for
     bit to a single-direction launch (lstm_fwd, lstm_bwd), the backward
     run twice (equal bits); CUDA-event times in turns (A, B, .., B, A) of
     the fused kernel, 2 x lstm_fwd / lstm_bwd on one stream, cuDNN's
     bidirectional nn.LSTM and the plain version; the bound. Then
     bilstm_layer(fuse_directions=True) at the flagship's first layer
     (input 512) under autograd (one residual bilstm_fwd and one
     bilstm_bwd launch, no single-direction launch) and without (one
     bilstm_fwd), its output (equal bits) and gradients against
     fuse_directions=False (which launches 2 lstm_fwd without grad, 2
     residual lstm_fwd and 2 lstm_bwd under autograd).
  4. predict slice: batch transcription through the port's CLI
     (`--mode predict --device cuda`, default batch 32) of 96 synthetic
     utterances of 1-5 s with the full-width default BiLSTM-CTC (random
     weights from a seed); checks predicted.txt, CER/WER, that every
     layer of every batch went through the LSTM kernels of the encoder's
     route (models/bilstm_ctc.py fuse_directions: one bilstm_fwd a layer,
     or lstm_fwd a direction), and one batch's log-probs against the
     plain recurrence; times the forward at B=64 x 5 s. Then `--decoder
     beam` (default batch 128, K=16, prune 6: one batch): the same
     checks, one ctc_beam launch per batch, and the kernel against the
     plain scan on that batch's log-probs.
  5. train slice: `--mode train --device cuda` through the CLI, one epoch
     of the synthetic train split (576 utterances, 18 steps at the default
     batch 32) with validation on dev; checks the launch counts of the
     route's residual forward and backward (per layer, or per direction,
     each step) and of its inference forward (each dev batch), the
     artifacts and finite losses, a resumed
     second epoch, and `--mode predict` on the trained model, greedy and
     beam; then one
     batch's loss and every parameter gradient, kernel path vs plain path,
     with dropout 0; then times one full train step at B=64 x 5 s in
     float32 and bfloat16.
  6. attention slices: for the conformer-CTC and the transformer-CTC at
     their full default width (6 layers, d_model 256, 4 heads, random
     weights from a seed) with flash_attention in config.json, `--mode
     predict` through the CLI, greedy (batch 32, 3 batches) and beam
     (batch 128, 1 batch): outputs checked and 6 flash_attn launches per
     batch (and 0 with flash_attention false); one batch's log-probs, the
     kernel against the plain attention; the forward at B=64 x 5 s with
     flash_attention on and off, float32 and bfloat16.
  7. attention training slices: for the conformer-CTC and the
     transformer-CTC at full default width, `--mode train --model F
     --flash_attention` through the CLI, one epoch (18 steps at batch 32,
     3 dev batches): exactly 6 residual flash_attn, 6 flash_attn_bwd_dkv
     and 6 flash_attn_bwd_dq launches per step and 6 inference-form
     launches per dev batch, finite losses, the artifacts; a resumed second
     epoch that omits --model and --flash_attention and keeps the family
     and its config; `--mode predict` on the trained model, greedy and
     beam. Then one batch's loss and every parameter gradient, kernel path
     vs plain path (dropout 0); one --remat step (12 residual forwards, the
     same gradients as without remat at dropout 0.1); the train step at
     B=64 x 5 s in float32 and bfloat16, flash_attention on and off in
     turns, with a profiler breakdown by kernel group.
  8. transducer training slice: the RNN-T at full default width
     (conformer encoder, 6 blocks, d_model 256, flash_attention;
     prediction net 128/256, joint 256, vocab 28, random weights from a
     seed): one epoch through the CLI (`--mode train --model transducer
     --flash_attention`, the default unfused joint: no joint launch), one
     through train(config=...) with fused_joint (exactly one joint_fwd and
     one joint_bwd launch per step, one joint_fwd per dev batch), a CLI
     resume that keeps fused_joint from config.json; one batch's loss and
     every gradient, kernel vs plain path (dropout 0); one kernel-path step
     with the BiLSTM and the transformer encoders; the train step at
     B=64 x 5 s, fused and unfused joint in turns, float32 and bfloat16,
     with a profiler breakdown (the joint kernels a group of their own) and
     the lattice loss timed alone.
  9. transducer transcription: `--mode predict` through the CLI on the
     transducer phase 8 trained, greedy (batch 32, 3 batches) and beam
     (batch 128, K=16, 1 batch): predicted.txt, a finite CER/WER, 6
     flash_attn launches per batch and no other kernel (the decoders run
     the unfused joint per frame); one batch's greedy labels, beam labels
     and nll, kernel path vs plain path; the encoder and the decoders
     timed apart, greedy at B=64 x 5 s and beam at B=128 x 5 s (host
     clock and profiler device time).
 10. policy-gradient slice: `--mode finetune_pg --device cuda` through
     the CLI on the BiLSTM-CTC phase 5 trained, REINFORCE for 20 steps at
     the default batch 32 with the dev CER every 10 (exactly 3 residual
     bilstm_fwd and 3 bilstm_bwd launches a step, 3 bilstm_fwd a dev batch;
     20 finite rewards, two dev CERs, model_last with epoch -1), a rerun to
     30 that resumes at 20, `--mode predict` on the result; MWER with K=4 on
     a copy of the supervised model (one ctc_beam launch a step as well);
     one batch's PG loss and every parameter gradient, kernel path vs plain
     path, for both objectives on the same paths and the same n-best (the
     n-best of ctc_beam identical to the plain scan's); the PG step at B=64
     x 5 s, both objectives, float32 and bfloat16, beside phase 5's
     supervised step, with the LSTM kernels at phase 3f's times, a profiler
     breakdown and the idle share, and the reward DP's host ms and device
     ops and the n-best launch timed alone. Then MWER through the CLI on
     the transducer phase 8 trained (fused_joint): a joint_fwd and a
     joint_bwd launch each for the n-best re-scoring and for the anchor, a
     step, and finite rewards.
 11. the supervised training recipe: `--mode train --device cuda` through
     the CLI for the full-width BiLSTM-CTC with every option (SpecAugment,
     speed 0.9-1.1, noise 0.1, gain 3 dB, --accum_steps 2, --ema_decay
     0.999, --keep_ckpts 2, --save_every_steps 5, --val_metric cer,
     --loader_threads 2, --cache_audio_mb 64, --profile_steps 2, 3
     epochs): 3 residual bilstm_fwd + 3 bilstm_bwd a micro-batch, 3 + 3
     bilstm_fwd a dev batch (loss and greedy CER), finite losses,
     ema_params in model_best and model_last, two rolling snapshots, the
     trace, the native WAV decoder; the same command in a subprocess
     (`python3 chip_smoke.py --recipe-worker ...`) stopped by SIGTERM after
     its first mid-epoch save (model_last with batches_done, exit 0), then
     resumed: the uninterrupted run's batches and step count, epoch losses
     within RESUME_LOSS_REL; `--mode predict --ckpt avg`, greedy and beam;
     one emit of 2 augmented micro-batches with EMA, kernel vs plain path;
     wave_augment, spec_augment, the EMA update and the recipe's
     micro-step timed at B=64 x 5 s, float32 and bfloat16, and the
     loader's host ms per batch (Python or native decode, 0 or 2 threads,
     the cache); examples/pg_improves_cer.py's recipe on the port's
     phonetic corpus (16 epochs, then 120 REINFORCE steps) with its test
     CERs.
 12. corpus tools: the smoke corpus's WAVs laid out as a LibriSpeech
     tree (train-clean-100, dev-clean, test-clean; upper-case
     *.trans.txt) through `--mode preproc --librispeech_root --units bpe
     --bpe_vocab_size 256` (the native segmenter's ids equal the Python
     tokenizer's); one epoch of `--mode train --units bpe` on the
     full-width BiLSTM-CTC (3 residual bilstm_fwd + 3 bilstm_bwd a step,
     every batch encoded by the native segmenter, finite losses); `--mode
     predict --decoder beam` (one ctc_beam launch at A = the learned
     vocabulary) and greedy `--timestamps` (word onsets in order inside
     their utterances), on the trained model and on random weights;
     `--mode align` (every test utterance aligned, word spans in order
     inside it; one batch's spans on the card equal the CPU's on the same
     log-probs); `--mode pseudolabel` on the clips directory; ctc_beam vs
     its plain scan at B=128, T=401, A=256, K=16, M=6 and exact, timed with
     its bound; the Viterbi (ops/align.py) at B=32 x 5 s: device busy time
     (profiler), wall and device operations; the train step at B=64 x 5 s
     with the BPE head beside the character head, in turns; the committed flax fixture (a JAX-trained
     model_best.ckpt with ema_params) served on the card: its log-probs
     against the JAX package's stored ones within LOGPROB_BOUND, `--mode
     predict` and `--mode align` through the CLI. Prints its wall time.
 13. streaming transcription (serving.py) at the full width of Config():
     lstm_fwd's reverse form (the LC-BLSTM window's backward direction)
     vs its plain version at B=1 and B=8 (an idle slot's all-zero mask, a
     flushed slot's partial window), T = C + R = 96, float32 and
     bfloat16, and flash_attn at the streamed attention windows (B=1,
     T'=16-304), device-timed with their bounds; on the longest test clip
     with its own fixed norm and lookahead to the end, phase 5's
     BiLSTM-CTC (3 lstm_fwd launches a chunk) and phase 7's conformer
     (flash attention, the whole utterance as left context: 6 flash_attn
     launches a chunk) streamed against their offline forward (log-probs
     within a bound, ids equal); `--mode stream --wav` through the CLI on
     phase 5's model, the random-weight model and phase 12's BPE model,
     with and without --timestamps; the batched transcriber at S=8 over 8
     clips opened one a round and closed as they end (3 lstm_fwd launches
     a tick), every slot's text equal to its single stream; per-chunk
     host ms (p50, p95), the real-time factor and the profiler's device
     busy time and idle share for greedy, beam K=8, the conformer at left
     context 512 and batched greedy at S=8 and S=32.
 14. the attention seq2seq (models/seq2seq.py) at its full default width
     (the flagship's encoder; decoder embed 128, LSTM 512, dot attention,
     output 1024 -> 28), random weights from a seed: `--mode train --model
     seq2seq` through the CLI for one epoch (3 residual bilstm_fwd + 3
     bilstm_bwd and one residual lstm_fwd + one lstm_bwd, the decoder's
     teacher-forced pass, a step; 3 bilstm_fwd + 1 lstm_fwd a dev batch),
     `--mode predict` greedy and `--decoder beam` (3 bilstm_fwd a batch:
     the decoder loops run no kernel), `--mode finetune_pg` SCST and MWER
     (K=4; two teacher-forced passes a step), each run's launches exact;
     the decoder route, LSTMScan (lstm_fwd residual + lstm_bwd) against
     ops/lstm.lstm_scan_xla in turns at B=64, Td=60, I=128, H=512, float32
     and bfloat16, and lstm_fwd (both forms) / lstm_bwd at that shape
     against their plain versions within phase 3's bounds; one batch's
     loss and every gradient, kernel vs plain path; the train step
     (float32, bfloat16), the SCST and MWER steps at B=64 x 5 s and greedy
     and beam (K=16) transcription of a batch of 32, each with its
     launches, CUDA-event or host ms and the profiler's device time and
     idle share.
 15. LM fusion (decoding/lm.py, neural_lm.py, rescore.py) at the
     flagship's width: `--mode predict --decoder beam` through the CLI
     with --lm_order 2 and 3 on phase 5's BiLSTM-CTC and 3 on phase 12's
     BPE model (3 bilstm_fwd a batch, no other launch: the fused search
     has no kernel), --lm_type neural (embed 48, hidden 160, 2 layers)
     trained for the default 300 steps on the card (2 residual lstm_fwd +
     2 lstm_bwd a step), reused by a second run (no training launch), and
     --lm_pass rescore (1 ctc_beam + 2 lstm_fwd a batch), each run's
     launches exact; the n-gram (orders 2, 3) and neural fused searches on
     phase 3b's inputs (B=128, T=401, A=28, K=16) on the card against the
     CPU (labels and lens equal, nll within LM_NLL_REL) with host ms,
     device busy time, idle share and device operations a batch; lstm_fwd
     (both forms) and lstm_bwd at the LM's training batch (B=32, T=128,
     H=160) and at the rescoring rows (B*K=2048, T=60) against their plain
     versions; one LM training step, loss and every gradient kernel vs
     plain, timed; the rescoring pass card vs CPU, timed; `--mode stream
     --decoder beam --lm_order 3` through the CLI on phase 5's model (3
     lstm_fwd a chunk), its text the offline fused search's on the
     streamed log-probs, and the streamed beam's chunk times and real-time
     factor with and without the LM.
 16. export (exporting.py) at the CLI's defaults (B=8 x 20 s): `--mode
     export --device cuda` through the CLI on phase 5's BiLSTM-CTC (greedy,
     --decoder beam K=16, --export_quantize int8, --export_platforms
     cpu,cuda), phase 7's conformer (flash_attention), phase 8's
     transducer (conformer encoder, flash_attention; greedy) and phase
     14's seq2seq (greedy): each export's seconds, node count, pgasr::
     nodes and MB; the artifact loaded by ExportedModel on the card, its
     ids and lens on 8 test clips equal to the live serving function's,
     its kernel launches a call equal to its pgasr:: nodes and to the live
     call's, the exported call's ms against the live one's in turns (CUDA
     events), the profiler's device busy time, idle share and device
     operations a call (not for the transducer's frame loop, whose 132 K
     launches the profiler takes tens of seconds to trace); the int8
     artifact smaller than the float32 one;
     the cpu,cuda artifact also loaded on the CPU (no launch), its ids
     equal to the card's. Each registered op (ops/registry.py) must be
     reached by some export.
 17. the switch-MoE transformer (parallel/moe.py) at the full width of
     Config()'s transformer with the CLI's --model moe (6 blocks, d_model
     256, 4 experts, capacity factor 1.25), random weights from a seed:
     `--mode train --model moe` through the CLI for one epoch (18 steps),
     a resume for a second, `--mode predict` greedy and `--decoder beam`,
     `--mode finetune_pg` REINFORCE and MWER (3 steps each), each run's
     launches exact (no kernel but ctc_beam: one a beam batch, one an MWER
     step; the MoE encoder takes the dense attention, as the JAX
     package's); `--mode export` greedy, beam (K=16) and int8 of a
     random-weight MoE model at the CLI's defaults (B=8 x 20 s), each
     artifact's ids on 8 test clips equal to the live serving function's
     and its ctc_beam launches to its pgasr:: nodes; card vs CPU on one
     B=64 x 5 s batch of the trained model in float32 with dropout 0: the
     routing of every block on every valid token (a flip allowed only at
     a router top-2 margin within MOE_ROUTE_MARGIN, printed), the loss
     and every gradient within the train step's bounds; the share of valid
     tokens capacity drops; the slot cumsum in moe.route's layout
     beside one along the outer axis; the MoE train step beside the dense
     transformer's (dense attention both), float32 and bfloat16, in
     turns, with the profiler's device time by group, the idle share and
     the step's peak device memory.
 18. the data mesh axis and the elastic supervisor (parallel/mesh.py,
     utils/elastic.py) on the full-width BiLSTM-CTC at B=64 x 5 s: (a)
     `--mode train --mesh data=1` through the CLI (an NCCL group of one),
     one epoch against the same epoch without a mesh, run twice (the
     float32 noise of F.ctc_loss's atomic backward is the yardstick): the
     same launches (3 residual bilstm_fwd + 3 bilstm_bwd a step, 3
     bilstm_fwd a dev batch), the losses and parameters within stated
     bounds; then, in a group of one here, one step with and without the
     mesh from the same state (the losses equal bit for bit, the gradient
     all-reduce the identity), the all-reduce and both steps timed; (b) two
     rank processes on the one card (`python3 chip_smoke.py --mesh-worker
     ...`, gloo: NCCL takes one rank a device), 32 rows each, 3 steps
     against the one-process steps on the same global batches (the CPU
     tests' tolerances), each rank's launches and step time; (c) `--mode
     train --max_restarts 1 --fault_step 4` through the CLI in a
     subprocess: the child's exit 17, one relaunch, the resume at batch 4,
     the result against (a)'s, the relaunch's seconds; (d) 3 MWER `--mode
     finetune_pg` steps under `--mesh data=1` against the same steps
     without a mesh (one ctc_beam launch a step).
 19. the expert and fsdp mesh axes (phase_shard): four gloo rank
     processes on the one card (`python3 chip_smoke.py --shard-worker
     ...`) against the one-process steps on the global B=64 x 5 s batch:
     `expert=2` and `data=2,expert=2` on the full-width switch-MoE,
     `fsdp=2` on the BiLSTM-CTC (train steps, MWER steps, and an epoch
     whose checkpoint predict serves and a run without a mesh resumes).
 20. the model mesh axis (phase_tensor, Megatron tensor parallelism), the
     same four processes: `model=2` on the full-width conformer with
     flash_attention (the kernels on 2 of its 4 heads a rank), on the
     BiLSTM-CTC (rows 3r and 4 on the gathered W and U), on the
     transducer with the transformer encoder (joint unfused, and fused:
     rows 5 and 6 on the gathered projections), 2 MWER steps;
     `model=2,expert=2` on the switch-MoE; and a `model=2` epoch of the
     conformer whose checkpoint predict serves on one device and a run
     without a mesh resumes. Each case against the one-process steps:
     losses, the first step's reduced gradients, the parameters, each
     rank's resident bytes (equal to the share its splits give), peak
     memory, step ms, the collectives alone and the launches.
 21. the pipe and seq mesh axes (phase_pipeseq: GPipe pipeline stages
     and sequence parallelism), the same four processes on the full-width
     transformer-CTC with flash_attention (which neither axis takes, as
     the JAX package's): `pipe=2` at 2 and 4 microbatches, `pipe=3` at 3
     (three ranks), `data=2,pipe=2`, `pipe=2,model=2`, `seq=2`, `seq=4`
     (T'=201 padded to 204), `data=2,seq=2`, and a `data=2,pipe=2`
     epoch (2 microbatches) whose checkpoint predict serves on one device
     and a run without a mesh resumes. Each case against the one-process
     steps of the dense model: losses within 1e-6 relative, the first
     step's reduced gradients, the parameters, each rank's resident bytes
     (a stage's share of the blocks under pipe), peak memory, step ms, one
     send / recv or one key gather and reduce-scatter alone, and no launch.
 22. prints its total wall time, a JSON line of kernel results (with each
     kernel's launches on the policy-gradient, recipe, corpus-tool,
     streaming, seq2seq, LM, export, MoE and mesh paths, those of the
     model axis under model_*, the pipe and seq axes' under pipeseq_*,
     ctc_beam's cases
     at A=256,
     lstm_fwd's and flash_attn's at the streamed windows, lstm_fwd_residual's and
     lstm_bwd's at the seq2seq decoder's and the LM's shapes), then as the
     last line {"ok": true, "device": {...}}.

It imports only the port (pg_asr_tpu_torch) and fails if any module of jax,
flax, msgpack, ml_dtypes or the JAX package (pg_asr_tpu) was imported.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
# transcripts drawn from a pangram's words: all 26 letters + space, so the
# CTC head has the width of an English character alphabet (28 with blank)
WORDS = ("the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog")
# the synthetic corpus splits n_utts into 3/4 train, 1/8 dev, 1/8 test:
# 576 / 96 / 96 utterances, i.e. 18 train steps and 3 dev and 3 test
# batches at the CLI's default batch size of 32
N_UTTS = 768
B, T, H = 64, 401, 256  # 5 s at hop 200, the default hidden size
WAVE_SAMPLES = 80000  # 5 s at 16 kHz: T = 80000 // 200 + 1 = 401 frames
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and FLOP/s by
# operand type (float32 outside the tensor cores, bfloat16 on them)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# kernel vs plain bounds at B=64, T=401, H=256 (max and mean abs error).
# float32 differs only in summation order (max ~1.5e-7 forward).
# bfloat16: both round their output to bf16, so a slightly different sum can
# land one ulp away; 4e-3 is one ulp in [0.5, 1). The max cannot tell whether
# the kernel rounds h to bf16 before the product as the Pallas kernel does;
# the mean can (~3e-7 with the rounding, ~1.2e-5 without), and its bound lies
# between. The script checks that a control run without that rounding
# exceeds the mean bound. out and hprev are h values and share the bounds.
BOUNDS = {"float32": {"max": 1e-5, "mean": 1e-7},
          "bfloat16": {"max": 4e-3, "mean": 1e-6}}
# cprev (the float32 c carry): float32 as out; in bf16 the carries differ
# where a bf16-rounded h differed by an ulp, by ~1e-4 at most, ~1e-6 on mean
CPREV_BOUNDS = {"float32": {"max": 1e-5, "mean": 1e-7},
                "bfloat16": {"max": 1e-3, "mean": 1e-5}}
# backward, given the plain forward's residuals. dxp: float32 summation
# order only. bfloat16: dxp is dpre rounded to bf16, so a different f32 sum
# can round one ulp away; relative to max|dxp| one ulp of the largest value
# is at most 2^-7. The mean tells apart a backward that skips the
# dpre_mx rounding before dU and dh: ~9e-7 with the rounding, ~9.1e-6 for a
# plain control run without it (CPU estimate at this shape), and the bound
# lies between; the script checks the control exceeds it. dU is a float32
# sum of B*T = 25 664
# products rounded once at the end: bounded relative to max|dU|, float32
# by summation order (~3e-6 measured in development), bfloat16 by one ulp
# of the largest entry (2^-7).
BWD_BOUNDS = {"float32": {"dxp_max": 1e-5, "dxp_mean": 1e-7,
                          "du_rel": 2e-5},
              "bfloat16": {"dxp_rel": 2.0 ** -7, "dxp_mean": 3e-6,
                           "du_rel": 2.0 ** -7}}
# end-to-end log-probs (3 BiLSTM layers + head + log-softmax, float32)
LOGPROB_BOUND = 1e-3
# one train batch, kernel path vs plain path, float32, dropout 0: loss
# relative 1e-4; each parameter gradient max abs error relative to its
# max |grad| 1e-3 (float32 sums in other orders through 3 layers, the head,
# and two CTC implementations: F.ctc_loss vs the plain alpha recursion)
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-4, 1e-3
# one PG batch (phase 10), kernel path vs plain path, float32, on the same
# sampled paths and the same n-best (fixed from the kernel path's
# log-probs, so the integer rewards and risks are equal): the train step's
# bounds. REINFORCE adds per-path sums of the same log-probs; MWER
# re-scores the n-best with F.ctc_loss against the plain recursion, which
# moves each hypothesis's weight by float32 rounding only
PG_LOSS_REL, PG_GRAD_REL = TRAIN_LOSS_REL, TRAIN_GRAD_REL
# beam search, kernel vs plain scan: the two run the same float32
# operations in the same order (logaddexp as max + log1p(exp(min - max)),
# the merge as max + log(sum exp)), so only expf/log1pf of nvcc's and of
# torch's CUDA build could round apart, by an ulp per operation; over 401
# frames that bounds the nll's relative error by ~1e-6. Labels, lens,
# parents and syms must be identical.
BEAM_NLL_REL = 1e-6
BEAM_B, BEAM_A, BEAM_K = 128, 28, 16  # the CLI's beam batch, vocab, width
# the attention of the conformer and transformer defaults (d_model 256, 4
# heads) at B=64 x 5 s: T' = ceil(401 / 2) frames after frame stacking
ATTN_H, ATTN_T, ATTN_DH = 4, 201, 64
# flash_attn vs its plain version, max abs error. float32: the online
# softmax over 64-key tiles and another summation order move the outputs
# (convex mixes of v, |v| < ~5) by float32 rounding only. bfloat16, relative
# to max|v|: p is rounded to bf16 against its tile's running max (the plain
# version against the row's max) and the output to bf16, at most 2^-9
# relative each, so the two may differ by a few ulps: 2^-6.
FLASH_BOUNDS = {"float32": 2e-5, "bfloat16": 2.0 ** -6}
# the residual form's l (a float32 sum of up to T' terms in [0, 1], online
# against tile maxima): relative 1e-5; m (the row max of the same float32
# scores summed in another order): abs 1e-5
FLASH_L_REL, FLASH_M_ABS = 1e-5, 1e-5
# flash_attn_bwd_dkv / _dq vs mhsa_bwd_plain on the same l, m, do: abs
# errors relative to max|grad| of each of dq, dk, dv. float32: summation
# order only; max 2e-5, mean 2e-7 (a CPU estimate at this shape, float64
# vs float32 sums: max 8e-7, mean 1.3e-8). bfloat16: p and ds are rounded
# to bf16 at the library's points in both, from scores summed in another
# order, and each output is rounded to bf16, so the max may reach two ulps
# of the largest value (2^-7). The mean tells apart a backward that skips
# the rounding of p and ds (CPU estimate: ~6e-5 relative for a control
# without it, ~2e-8 with it); its bound 1e-6 lies between, and the script
# checks that the control exceeds it.
FLASH_BWD_BOUNDS = {"float32": {"max": 2e-5, "mean": 2e-7},
                    "bfloat16": {"max": 2.0 ** -7, "mean": 1e-6}}
# transducer decoding, kernel path vs plain path on one batch of the
# trained model (conformer encoder, flash attention vs plain attention,
# float32): the encoder states differ by float32 summation order only, so
# labels must be equal; the beam's nll (a sum over ~200 frames of
# log-probs) within relative 1e-4
TRANSDUCER_NLL_REL = 1e-4
# the transducer's joint at B=64 x 5 s: T'=201 frames, labels of 60
# symbols, the default joint_dim 256 and vocab 28
JOINT_U, JOINT_J, JOINT_A = 60, 256, 28
# joint_fwd / joint_bwd vs their plain versions. Both compute in float32
# whatever the inputs' type (bf16 inputs widen exactly), so the tables
# differ only by float32 summation order (the head's 256 products: the
# kernel sums them in order, the plain version through cuBLAS) and the
# expf/logf/tanhf of nvcc vs torch: max 2e-5, mean 1e-6 absolute (log-probs
# of magnitude ~3). The gradients, relative to max|grad| of each: float32
# by summation order over up to B*T'*(U+1) = 784 704 cells (dW, db), max
# 2e-5, mean 1e-6; bfloat16: each is a float32 sum rounded once to bf16 in
# both, so the two may round one ulp apart, which relative to the largest
# value is at most 2^-7; such splits are rare, mean 1e-4.
JOINT_BOUNDS = {
    "float32": {"lp_max": 2e-5, "lp_mean": 1e-6, "grad_max": 2e-5,
                "grad_mean": 1e-6},
    "bfloat16": {"lp_max": 2e-5, "lp_mean": 1e-6, "grad_max": 2.0 ** -7,
                 "grad_mean": 1e-4}}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def once_ms(fn, reps: int = 1) -> float:
    """CUDA-event ms of `reps` calls of fn, without time_ms's warm-up call
    (for calls of seconds that have run before)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_ms(fn, reps: int) -> float:
    fn()  # warm-up
    return once_ms(fn, reps)


def device_ms(fn, reps: int) -> float:
    """As time_ms, but the launches queue behind a sleep kernel long enough
    for the host to enqueue all of them: the events then time the card's
    work back to back, not the rate at which Python launches kernels of
    tens of microseconds."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 100000)  # > 2 x host_s at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(plain, kernel, plain_reps: int, kernel_reps: int,
             kernel_timer=time_ms):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = time_ms(plain, plain_reps)
    k1 = kernel_timer(kernel, kernel_reps)
    k2 = kernel_timer(kernel, kernel_reps)
    p2 = time_ms(plain, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound_ms(flops: float, nbytes: float, dtype: str):
    """Least time for the work: the larger of bytes over the HBM rate and
    operations over the peak rate of the operand type -> (ms, bound_by)."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device():
    import torch

    check(torch.cuda.is_available(), "no CUDA device available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # the plain references run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def phase_build():
    from pg_asr_tpu_torch import _build
    from pg_asr_tpu_torch.data import native_bpe, native_io

    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    print(f"[build] {os.path.relpath(path)} in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check(native_io.native_available(), "the native WAV decoder did not "
          f"build from {native_io.SOURCE}")
    print(f"[build] {os.path.relpath(native_io.library_path())} (host C++, "
          f"the native WAV decoder) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check(native_bpe.native_available(), "the native BPE segmenter did not "
          f"build from {native_bpe.SOURCE}")
    lib = native_io.library_path(native_bpe.SOURCE)
    print(f"[build] {os.path.relpath(lib)} (host C++, the native BPE "
          f"segmenter) in {time.perf_counter() - t0:.1f} s")


def kernel_inputs(dev):
    import torch

    g = torch.Generator().manual_seed(SEED)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[0], lens[1] = T, 1
    mask = (torch.arange(T)[None] < lens[:, None]).to(dev, torch.float32)
    xp = (0.5 * torch.randn(B, T, 4 * H, generator=g)).to(dev)
    U = ((torch.rand(H, 4 * H, generator=g) * 2 - 1) / math.sqrt(H)).to(dev)
    gy = torch.randn(B, T, H, generator=g).to(dev)
    return mask, xp, U, gy, int(lens.sum())


def _errs(got, ref):
    d = (got.float() - ref.float()).abs()
    return d.max().item(), d.mean().item()


def phase_kernels(dev):
    """lstm_fwd (both forms) and lstm_bwd vs their plain versions."""
    import torch

    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.ops.lstm import lstm_scan_bwd_plain, lstm_scan_plain

    mask, xp32, U32, gy32, valid = kernel_inputs(dev)
    fwd, res, bwd = [], [], []
    for dtype in (torch.float32, torch.bfloat16):
        xp, U, gy = xp32.to(dtype), U32.to(dtype), gy32.to(dtype)
        name = str(dtype).split(".")[1]
        s = xp.element_size()
        # bytes: the function needs the per-step inputs (xp; in the
        # backward also hprev, cprev, gy) on the valid steps only, since a
        # padded step freezes the carry and writes zeros; it reads U and the
        # whole mask and writes its outputs at every step (out; hprev, cprev
        # in the residual form; dxp, dU in the backward)
        io_fwd = ((valid * 4 * H + H * 4 * H + B * T * H) * s + B * T * 4)
        io_res = io_fwd + B * T * H * (s + 4)
        io_bwd = (valid * H * (4 * s + s + 4 + s) + 2 * H * 4 * H * s
                  + B * T * 4 + B * T * 4 * H * s)
        # operations on the valid steps: the (B,H)x(H,4H) product (2 flops
        # per multiply-add) and ~30 elementwise ops per unit; the backward
        # does three products and ~60 elementwise ops
        f_fwd = valid * (2 * H * 4 * H + 30 * H)
        f_bwd = valid * (3 * 2 * H * 4 * H + 60 * H)
        for reverse in (False, True):
            d = "reverse" if reverse else "forward"
            tag = f"B={B} T={T} H={H} {name} {d}"
            # --- inference form
            bound = BOUNDS[name]
            got = cuda_lstm.lstm_scan_cuda(xp, U, mask, reverse)
            again = cuda_lstm.lstm_scan_cuda(xp, U, mask, reverse)
            ref_out, ref_h, ref_c = lstm_scan_plain(xp, U, mask, reverse,
                                                    residuals=True)
            torch.cuda.synchronize()
            err, mean_err = _errs(got, ref_out)
            check(got.dtype == dtype and got.shape == (B, T, H),
                  "kernel output dtype/shape")
            check(bool(torch.equal(got, again)),
                  f"lstm_fwd {name} reverse={reverse}: two launches differ")
            check(bool(torch.all(got[mask == 0] == 0)),
                  "kernel output not zero at padded steps")
            k_ms, p_ms = in_turns(
                lambda: lstm_scan_plain(xp, U, mask, reverse),
                lambda: cuda_lstm.lstm_scan_cuda(xp, U, mask, reverse), 3, 20)
            b_ms, b_by = bound_ms(f_fwd, io_fwd, name)
            case = {"dtype": name, "reverse": reverse, "max_abs_err": err,
                    "mean_abs_err": mean_err, "bound": bound, "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
            ctrl = ""
            if dtype == torch.bfloat16:
                # control: the plain version with h kept in float32
                skip = lstm_scan_plain(xp, U.float(), mask, reverse)
                case["control_mean_abs_err"] = _errs(skip, ref_out)[1]
                ctrl = (f", control without h rounding: mean "
                        f"{case['control_mean_abs_err']:.3e}")
            print(f"[kernel] lstm_fwd {tag}: max_abs_err {err:.3e} (bound "
                  f"{bound['max']:.0e}), mean_abs_err {mean_err:.3e} (bound "
                  f"{bound['mean']:.0e}){ctrl}; kernel {k_ms:.3f} ms, plain "
                  f"{p_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
            check(err <= bound["max"] and mean_err <= bound["mean"],
                  f"lstm_fwd {name} reverse={reverse} disagrees with the "
                  f"plain version: max {err}, mean {mean_err} > {bound}")
            check(case.get("control_mean_abs_err", math.inf) > bound["mean"],
                  f"the {name} mean bound does not tell apart a recurrence "
                  "that skips the rounding of h")
            fwd.append(case)

            # --- residual form
            out, hprev, cprev = cuda_lstm.lstm_scan_residual_cuda(
                xp, U, mask, reverse)
            torch.cuda.synchronize()
            check(hprev.dtype == dtype and cprev.dtype == torch.float32
                  and hprev.shape == cprev.shape == (T, B, H),
                  "residual dtypes/shapes")
            check(bool(torch.equal(out, got)),
                  "the residual form's out differs from the inference form's")
            errs = {"out": _errs(out, ref_out), "hprev": _errs(hprev, ref_h),
                    "cprev": _errs(cprev, ref_c)}
            k_ms, p_ms = in_turns(
                lambda: lstm_scan_plain(xp, U, mask, reverse,
                                        residuals=True),
                lambda: cuda_lstm.lstm_scan_residual_cuda(xp, U, mask,
                                                          reverse), 3, 20)
            b_ms, b_by = bound_ms(f_fwd, io_res, name)
            res.append({"dtype": name, "reverse": reverse, "errors": errs,
                        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": b_by})
            print(f"[kernel] lstm_fwd residual {tag}: " + ", ".join(
                f"{k} max {v[0]:.3e} mean {v[1]:.3e}" for k, v in errs.items())
                + f"; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
                f"{b_ms:.3f} ms ({b_by})")
            for k in ("out", "hprev", "cprev"):
                bd = CPREV_BOUNDS[name] if k == "cprev" else bound
                check(errs[k][0] <= bd["max"] and errs[k][1] <= bd["mean"],
                      f"lstm_fwd residual {name} {d}: {k} {errs[k]} > {bd}")

            # --- backward, on the plain forward's residuals
            bb = BWD_BOUNDS[name]
            dxp, dU = cuda_lstm.lstm_scan_bwd_cuda(xp, U, mask, ref_h, ref_c,
                                                   gy, reverse)
            r_dxp, r_dU = lstm_scan_bwd_plain(xp, U, mask, ref_h, ref_c, gy,
                                              reverse)
            torch.cuda.synchronize()
            check(dxp.dtype == dU.dtype == dtype, "backward dtypes")
            check(bool(torch.all(dxp[mask == 0] == 0)),
                  "dxp not zero at padded steps")
            e_dxp, e_du = _errs(dxp, r_dxp), _errs(dU, r_dU)
            dxp_ref_max = r_dxp.float().abs().max().item()
            du_ref_max = r_dU.float().abs().max().item()
            k_ms, p_ms = in_turns(
                lambda: lstm_scan_bwd_plain(xp, U, mask, ref_h, ref_c, gy,
                                            reverse),
                lambda: cuda_lstm.lstm_scan_bwd_cuda(xp, U, mask, ref_h,
                                                     ref_c, gy, reverse),
                2, 10)
            b_ms, b_by = bound_ms(f_bwd, io_bwd, name)
            case = {"dtype": name, "reverse": reverse,
                    "dxp_max_abs_err": e_dxp[0], "dxp_mean_abs_err": e_dxp[1],
                    "dxp_ref_max": dxp_ref_max, "du_max_abs_err": e_du[0],
                    "du_mean_abs_err": e_du[1], "du_ref_max": du_ref_max,
                    "bound": bb, "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": b_by}
            dxp_max = bb.get("dxp_max", bb.get("dxp_rel", 0) * dxp_ref_max)
            ctrl = ""
            if dtype == torch.bfloat16:
                # control: the plain backward without the dpre_mx rounding
                # (U widened to float32, so dpre stays float32 for dU, dh)
                c_dxp, _ = lstm_scan_bwd_plain(xp, U.float(), mask, ref_h,
                                               ref_c, gy, reverse)
                case["control_dxp_mean_abs_err"] = _errs(c_dxp, r_dxp)[1]
                ctrl = (f", control without dpre_mx rounding: mean "
                        f"{case['control_dxp_mean_abs_err']:.3e}")
            print(f"[kernel] lstm_bwd {tag}: dxp max {e_dxp[0]:.3e} (bound "
                  f"{dxp_max:.3e}) mean {e_dxp[1]:.3e} (bound "
                  f"{bb['dxp_mean']:.0e}){ctrl}; dU max {e_du[0]:.3e} (bound "
                  f"{bb['du_rel'] * du_ref_max:.3e} = {bb['du_rel']:.1e} x "
                  f"max|dU| {du_ref_max:.3e}) mean {e_du[1]:.3e}; kernel "
                  f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.3f} ms "
                  f"({b_by})")
            check(e_dxp[0] <= dxp_max and e_dxp[1] <= bb["dxp_mean"],
                  f"lstm_bwd {name} {d}: dxp {e_dxp} out of bounds")
            check(e_du[0] <= bb["du_rel"] * du_ref_max,
                  f"lstm_bwd {name} {d}: dU {e_du} out of bounds")
            check(case.get("control_dxp_mean_abs_err", math.inf)
                  > bb["dxp_mean"],
                  f"the {name} dxp mean bound does not tell apart a backward "
                  "that skips the dpre_mx rounding")
            bwd.append(case)
    return {"fwd": fwd, "res": res, "bwd": bwd}


def cudnn_lstm(dev, bidirectional: bool = False):
    """cuDNN nn.LSTM at the kernels' shape, float32, full-length batch, one
    direction or both: the one PyTorch call that computes the same
    recurrence (it also does the x@W input projection, from a 512-wide
    input, which the kernels receive precomputed). A yardstick only; the
    port never calls it. -> {"fwd_ms": no grad, "train_fwd_ms": the
    training forward, "bwd_ms": the backward}: callables to time."""
    import torch

    lstm = torch.nn.LSTM(512, H, batch_first=True,
                         bidirectional=bidirectional).to(dev)
    n_dir = 2 if bidirectional else 1
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn(B, T, 512, generator=g).to(dev).requires_grad_(True)
    gy = torch.randn(B, T, n_dir * H, generator=g).to(dev)

    def infer():
        with torch.no_grad():
            lstm(x)

    def train_fwd():
        lstm(x)

    out, _ = lstm(x)
    params = [x, *lstm.parameters()]

    def backward():
        torch.autograd.grad(out, params, gy, retain_graph=True)

    return {"fwd_ms": infer, "train_fwd_ms": train_fwd, "bwd_ms": backward}


def phase_library(dev):
    """cuDNN's one-direction nn.LSTM timed: the yardstick of lstm_fwd /
    lstm_bwd (phase 3f times the bidirectional one in turns with the fused
    kernels)."""
    lib = {k: time_ms(f, 20) for k, f in cudnn_lstm(dev).items()}
    print(f"[library] cuDNN nn.LSTM(512, {H}) B={B} T={T} float32, one "
          f"direction: forward {lib['fwd_ms']:.3f} ms (no grad), "
          f"{lib['train_fwd_ms']:.3f} ms (training), backward "
          f"{lib['bwd_ms']:.3f} ms")
    return lib


def turns(fns: dict, reps: dict) -> dict:
    """{name: ms}: each callable timed in the order given, then in the
    reverse order (A, B, .., B, A), the two readings averaged."""
    got = {k: [] for k in fns}
    for k in [*fns, *reversed(fns)]:
        got[k].append(time_ms(fns[k], reps[k]))
    return {k: sum(v) / 2 for k, v in got.items()}


def bi_inputs(dev):
    """Phase 3's inputs as the forward direction, a second draw as the
    backward one: mask, xpf, xpb, Uf, Ub, gy (B, T, 2H), valid steps."""
    import torch

    mask, xpf, Uf, gyf, valid = kernel_inputs(dev)
    g = torch.Generator().manual_seed(SEED + 1)
    xpb = (0.5 * torch.randn(B, T, 4 * H, generator=g)).to(dev)
    Ub = ((torch.rand(H, 4 * H, generator=g) * 2 - 1) / math.sqrt(H)).to(dev)
    gy = torch.cat([gyf, torch.randn(B, T, H, generator=g).to(dev)], -1)
    return mask, xpf, xpb, Uf, Ub, gy, valid


def lstm_counts() -> dict:
    from pg_asr_tpu_torch.ops import cuda_lstm as c

    return {"lstm_fwd": c.LAUNCHES, "lstm_fwd_residual": c.RES_LAUNCHES,
            "lstm_bwd": c.BWD_LAUNCHES, "bilstm_fwd": c.BI_LAUNCHES,
            "bilstm_fwd_residual": c.BI_RES_LAUNCHES,
            "bilstm_bwd": c.BI_BWD_LAUNCHES}


def route_counters():
    """The counters the BiLSTM encoder (models/bilstm_ctc.py encode: both
    directions of a layer in one walk) moves, and the launches of each in
    one forward of the default model: (inference, residual, backward, per
    forward)."""
    from pg_asr_tpu_torch.config import Config

    return ("bilstm_fwd", "bilstm_fwd_residual", "bilstm_bwd",
            Config().model.num_layers)


def phase_bilstm(dev):
    """3f: bilstm_fwd (both forms) and bilstm_bwd vs their plain versions,
    each direction vs a single-direction launch (equal bits), the backward
    twice (equal bits); the fused kernel, two single-direction launches,
    cuDNN's bidirectional nn.LSTM and the plain version timed in turns;
    the bound. Then bilstm_layer(fuse_directions=True) at the flagship's
    first layer, under autograd and without, against
    fuse_directions=False."""
    import torch

    from pg_asr_tpu_torch.ops import cuda_lstm as cl
    from pg_asr_tpu_torch.ops.lstm import (bilstm_layer,
                                           bilstm_scan_bwd_plain,
                                           bilstm_scan_plain)

    mask, *inputs32, valid = bi_inputs(dev)
    lib = cudnn_lstm(dev, bidirectional=True)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        xpf, xpb, Uf, Ub, gy = (t.to(dtype) for t in inputs32)
        args = (xpf, xpb, Uf, Ub, mask)
        name = str(dtype).split(".")[1]
        s = xpf.element_size()
        tag = f"B={B} T={T} H={H} x 2 directions {name}"
        # twice phase 3's work and bytes; the mask is read once
        io_fwd = 2 * (valid * 4 * H + H * 4 * H + B * T * H) * s + B * T * 4
        io_res = io_fwd + 2 * B * T * H * (s + 4)
        io_bwd = (2 * (valid * H * (4 * s + s + 4 + s) + 2 * H * 4 * H * s
                       + B * T * 4 * H * s) + B * T * 4)
        f_fwd = 2 * valid * (2 * H * 4 * H + 30 * H)
        f_bwd = 2 * valid * (3 * 2 * H * 4 * H + 60 * H)
        case = {"dtype": name}

        # --- forward, both forms
        y = cl.bilstm_scan_cuda(*args)
        res = cl.bilstm_scan_residual_cuda(*args)
        ref = bilstm_scan_plain(*args, residuals=True)
        sf = cl.lstm_scan_residual_cuda(xpf, Uf, mask, False)
        sb = cl.lstm_scan_residual_cuda(xpb, Ub, mask, True)
        torch.cuda.synchronize()
        check(y.dtype == dtype and y.shape == (B, T, 2 * H)
              and torch.equal(res[0], y),
              "bilstm_fwd: output dtype/shape, or the forms' y differ")
        errs = {k: _errs(g, r) for k, g, r in
                zip(("y", "hpf", "cpf", "hpb", "cpb"), res, ref)}
        for k, (mx, mean) in errs.items():
            bd = CPREV_BOUNDS[name] if k.startswith("c") else BOUNDS[name]
            check(mx <= bd["max"] and mean <= bd["mean"],
                  f"bilstm_fwd {name}: {k} max {mx} mean {mean} > {bd}")
        # each direction equals a single-direction launch bit for bit
        single = (torch.cat([sf[0], sb[0]], -1), sf[1], sf[2], sb[1], sb[2])
        equal = {k: torch.equal(g, r) for k, g, r in
                 zip(("y", "hpf", "cpf", "hpb", "cpb"), res, single)}
        check(all(equal.values()),
              f"bilstm_fwd {name}: bits differ from two lstm_fwd launches: "
              f"{equal}")
        fwd_t = turns({
            "kernel": lambda: cl.bilstm_scan_cuda(*args),
            "two": lambda: (cl.lstm_scan_cuda(xpf, Uf, mask, False),
                            cl.lstm_scan_cuda(xpb, Ub, mask, True)),
            "cudnn": lib["fwd_ms"],
            "plain": lambda: bilstm_scan_plain(*args)},
            {"kernel": 20, "two": 20, "cudnn": 10, "plain": 1})
        res_t = turns({
            "kernel": lambda: cl.bilstm_scan_residual_cuda(*args),
            "two": lambda: (cl.lstm_scan_residual_cuda(xpf, Uf, mask, False),
                            cl.lstm_scan_residual_cuda(xpb, Ub, mask, True)),
            "cudnn": lib["train_fwd_ms"],
            "plain": lambda: bilstm_scan_plain(*args, residuals=True)},
            {"kernel": 20, "two": 20, "cudnn": 10, "plain": 1})
        b_ms, b_by = bound_ms(f_fwd, io_fwd, name)
        br_ms, br_by = bound_ms(f_fwd, io_res, name)
        case.update(fwd_errors=errs, fwd_equal_to_lstm_fwd=equal,
                    fwd_ms=fwd_t["kernel"], fwd_plain_ms=fwd_t["plain"],
                    two_lstm_fwd_ms=fwd_t["two"], fwd_cudnn_ms=fwd_t["cudnn"],
                    fwd_bound_ms=b_ms, fwd_bound_by=b_by,
                    res_ms=res_t["kernel"], res_plain_ms=res_t["plain"],
                    two_lstm_fwd_residual_ms=res_t["two"],
                    res_cudnn_ms=res_t["cudnn"], res_bound_ms=br_ms,
                    res_bound_by=br_by)
        print(f"[kernel] bilstm_fwd {tag}: " + ", ".join(
            f"{k} max {v[0]:.3e} mean {v[1]:.3e}" for k, v in errs.items())
            + f" (bounds {BOUNDS[name]}, c {CPREV_BOUNDS[name]}); each "
            "direction equal bit for bit to lstm_fwd; in turns: inference "
            f"form {fwd_t['kernel']:.3f} ms (2 x lstm_fwd {fwd_t['two']:.3f}, "
            f"cuDNN bidirectional {fwd_t['cudnn']:.3f} (f32), plain "
            f"{fwd_t['plain']:.3f}, bound {b_ms:.3f} {b_by}); residual form "
            f"{res_t['kernel']:.3f} ms (2 x lstm_fwd residual "
            f"{res_t['two']:.3f}, cuDNN training forward "
            f"{res_t['cudnn']:.3f}, plain {res_t['plain']:.3f}, bound "
            f"{br_ms:.3f} {br_by})")

        # --- backward, on the plain forward's residuals
        bwd = cl.bilstm_scan_bwd_cuda(*args, *ref[1:], gy)
        again = cl.bilstm_scan_bwd_cuda(*args, *ref[1:], gy)
        r_bwd = bilstm_scan_bwd_plain(*args, *ref[1:], gy)
        gyf, gyb = gy[..., :H].contiguous(), gy[..., H:].contiguous()
        s_f = cl.lstm_scan_bwd_cuda(xpf, Uf, mask, ref[1], ref[2], gyf, False)
        s_b = cl.lstm_scan_bwd_cuda(xpb, Ub, mask, ref[3], ref[4], gyb, True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(bwd, again)),
              f"bilstm_bwd {name}: two runs differ")
        bequal = {k: torch.equal(g_, r_) for k, g_, r_ in zip(
            ("dxpf", "dxpb", "dUf", "dUb"), bwd, (s_f[0], s_b[0], s_f[1],
                                                  s_b[1]))}
        check(all(bequal.values()),
              f"bilstm_bwd {name}: bits differ from two lstm_bwd launches: "
              f"{bequal}")
        bb = BWD_BOUNDS[name]
        berrs = {}
        for k, g_, r_ in zip(("dxpf", "dxpb", "dUf", "dUb"), bwd, r_bwd):
            ref_max = r_.float().abs().max().item()
            mx, mean = _errs(g_, r_)
            if k.startswith("dxp"):
                lim = bb.get("dxp_max", bb.get("dxp_rel", 0) * ref_max)
                ok = mx <= lim and mean <= bb["dxp_mean"]
            else:
                lim = bb["du_rel"] * ref_max
                ok = mx <= lim
            berrs[k] = (mx, mean, lim)
            check(ok, f"bilstm_bwd {name}: {k} max {mx} mean {mean} out of "
                      f"bounds ({lim}, {bb}) against the plain version")
        bwd_t = turns({
            "kernel": lambda: cl.bilstm_scan_bwd_cuda(*args, *ref[1:], gy),
            "two": lambda: (
                cl.lstm_scan_bwd_cuda(xpf, Uf, mask, ref[1], ref[2], gyf,
                                      False),
                cl.lstm_scan_bwd_cuda(xpb, Ub, mask, ref[3], ref[4], gyb,
                                      True)),
            "cudnn": lib["bwd_ms"],
            "plain": lambda: bilstm_scan_bwd_plain(*args, *ref[1:], gy)},
            {"kernel": 10, "two": 10, "cudnn": 10, "plain": 1})
        bb_ms, bb_by = bound_ms(f_bwd, io_bwd, name)
        case.update(bwd_errors=berrs, bwd_equal_to_lstm_bwd=bequal,
                    bwd_ms=bwd_t["kernel"], bwd_plain_ms=bwd_t["plain"],
                    two_lstm_bwd_ms=bwd_t["two"], bwd_cudnn_ms=bwd_t["cudnn"],
                    bwd_bound_ms=bb_ms, bwd_bound_by=bb_by)
        print(f"[kernel] bilstm_bwd {tag}: " + ", ".join(
            f"{k} max {v[0]:.3e} (bound {v[2]:.3e}) mean {v[1]:.3e}"
            for k, v in berrs.items()) + "; equal bits run to run and to two "
            f"lstm_bwd calls; in turns: kernel {bwd_t['kernel']:.3f} ms (2 x "
            f"lstm_bwd {bwd_t['two']:.3f}, cuDNN bidirectional backward "
            f"{bwd_t['cudnn']:.3f} (f32), plain {bwd_t['plain']:.3f}, bound "
            f"{bb_ms:.3f} {bb_by})")
        train_gain = (res_t["two"] + bwd_t["two"]) - (res_t["kernel"]
                                                      + bwd_t["kernel"])
        print(f"[kernel] fused directions {name} (the encoder's route, "
              f"models/bilstm_ctc.py): fused inference form faster by "
              f"{fwd_t['two'] - fwd_t['kernel']:.3f} ms than 2 x lstm_fwd, "
              f"fused residual form + backward faster by {train_gain:.3f} "
              f"ms than 2 x lstm_fwd residual + 2 x lstm_bwd")
        cases.append(case)

    # the layer at the flagship's first layer (input 512), float32
    I = 512
    g = torch.Generator().manual_seed(SEED + 2)
    x0 = torch.randn(B, T, I, generator=g).to(dev)
    p0 = {d: {"W": (torch.rand(I, 4 * H, generator=g) * 2 - 1) / math.sqrt(I),
              "U": (torch.rand(H, 4 * H, generator=g) * 2 - 1) / math.sqrt(H),
              "b": torch.randn(4 * H, generator=g) * 0.1}
          for d in ("fwd", "bwd")}
    gy = torch.randn(B, T, 2 * H, generator=g).to(dev)
    grads, launches = {}, {}
    for fuse in (True, False):
        x = x0.clone().requires_grad_(True)
        p = {d: {k: v.to(dev).requires_grad_(True) for k, v in q.items()}
             for d, q in p0.items()}
        reset_counts()
        y = bilstm_layer(p, x, mask, fuse_directions=fuse)
        y.backward(gy)
        torch.cuda.synchronize()
        launches[fuse] = lstm_counts()
        grads[fuse] = [y, x.grad] + [p[d][k].grad for d in ("fwd", "bwd")
                                     for k in ("W", "U", "b")]
    reset_counts()
    with torch.no_grad():
        bilstm_layer(p, x0, mask, fuse_directions=False)
    torch.cuda.synchronize()
    launches["unfused_no_grad"] = lstm_counts()
    reset_counts()
    with torch.no_grad():
        y_inf = bilstm_layer(p, x0, mask, fuse_directions=True)
    torch.cuda.synchronize()
    launches["no_grad"] = lstm_counts()
    zero = dict.fromkeys(lstm_counts(), 0)
    check(launches["unfused_no_grad"] == {**zero, "lstm_fwd": 2},
          f"unfused layer without grad launched "
          f"{launches['unfused_no_grad']}")
    check(launches[True] == {**zero, "bilstm_fwd_residual": 1,
                             "bilstm_bwd": 1},
          f"fused layer under autograd launched {launches[True]}")
    check(launches[False] == {**zero, "lstm_fwd_residual": 2,
                              "lstm_bwd": 2},
          f"unfused layer under autograd launched {launches[False]}")
    check(launches["no_grad"] == {**zero, "bilstm_fwd": 1},
          f"fused layer without grad launched {launches['no_grad']}")
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(grads[True], grads[False])]
    equal = [torch.equal(a, b) for a, b in zip(grads[True], grads[False])]
    inf_equal = torch.equal(y_inf, grads[True][0])
    print(f"[kernel] bilstm_layer(fuse_directions=True) B={B} T={T} I={I} "
          f"H={H} float32 vs fuse_directions=False: output and 8 gradients "
          f"equal bits {equal}, worst max|diff|/max {max(rel):.2e} (bound "
          f"{TRAIN_GRAD_REL:.0e}); inference form equal bits {inf_equal}; "
          f"launches under autograd {launches[True]} (unfused "
          f"{launches[False]}), without {launches['no_grad']}")
    check(equal[0] and max(rel) <= TRAIN_GRAD_REL and inf_equal,
          f"fused layer disagrees with the unfused one: {equal} {rel}")
    return {"cases": cases, "layer_launches": {
        "autograd": launches[True], "unfused_autograd": launches[False],
        "no_grad": launches["no_grad"],
        "unfused_no_grad": launches["unfused_no_grad"]},
        "layer_worst_rel": max(rel), "layer_equal_bits": equal}


def beam_inputs(dev):
    """Sharp posteriors (logits x 2) for B=128 utterances of T=401 frames
    and ragged frame lengths (1, 2 and T among them), from a numpy seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((BEAM_B, T, BEAM_A)) * 2.0
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    fl = rng.integers(1, T + 1, BEAM_B).astype(np.int32)
    fl[:3] = [T, 1, 2]
    return torch.from_numpy(lp).to(dev), torch.from_numpy(fl).to(dev)


def beam_vs_plain(lp, fl, M: int, Lmax: int, K: int = BEAM_K):
    """ctc_beam and the plain scan + backtrack on the same inputs: checks
    labels, lens, parents and syms identical and the nll; returns the
    kernel's output and the worst nll relative error."""
    import torch

    from pg_asr_tpu_torch.decoding import beam, cuda_beam

    A = lp.shape[-1]
    prune = None if M == beam._prune_m(A, K, None) else M
    out = cuda_beam.ctc_beam_cuda(lp, fl, K=K, M=M, Lmax=Lmax)
    lens, scores, parents, syms = beam._scan_hash(
        lp, fl, K=K, A=A, Lmax=Lmax, blank=0, prune=prune)
    labels, blens, nll = beam._backtrack_batch(parents, syms, lens, scores,
                                               Lmax)
    torch.cuda.synchronize()
    for name, got, want in (("parents", out.parents, parents),
                            ("syms", out.syms, syms), ("lens", out.lens, lens),
                            ("labels", out.labels[:, 0], labels),
                            ("best lens", out.nb_lens[:, 0], blens)):
        check(torch.equal(got, want),
              f"ctc_beam M={M}: {name} differ from the plain scan")
    err = (out.nll[:, 0] - nll).abs()
    rel = (err / nll.abs().clamp(min=1)).max().item()
    check(rel <= BEAM_NLL_REL, f"ctc_beam M={M}: nll rel error {rel}")
    return out, rel, err.max().item()


def phase_beam(dev):
    """ctc_beam vs the plain hash scan at the beam's default batch and
    width, M=6 (the default prune) and M=18 (the exact search)."""
    import torch

    from pg_asr_tpu_torch.decoding import beam, cuda_beam

    lp, fl = beam_inputs(dev)
    A, valid = BEAM_A, int(fl.sum())
    cases = []
    for M in (6, beam._prune_m(A, BEAM_K, None)):
        prune = None if M == beam._prune_m(A, BEAM_K, None) else M
        out, rel, abs_err = beam_vs_plain(lp, fl, M, T)
        k_ms, p_ms = in_turns(
            lambda: beam.beam_decode(lp, fl, max_label_len=T, prune=prune,
                                     use_kernel=False),
            lambda: cuda_beam.ctc_beam_cuda(lp, fl, K=BEAM_K, M=M, Lmax=T),
            1, 20)
        # bytes: the log-prob rows of the valid frames, the frame lengths,
        # and every output once: (T, B, K) parents and syms, (B, K) lens and
        # scores, the (B, Lmax) labels, best lens and nll. Operations per
        # valid frame of an utterance: the top-M rank over A symbols, the
        # K x K merge, ~4 per candidate (score, masks) and a top-K pass
        # over the C = K(1+M) candidates, ~20 per slot for the logaddexps
        C = BEAM_K * (1 + M)
        nbytes = (valid * A * 4 + BEAM_B * 4 + 2 * T * BEAM_B * BEAM_K * 4
                  + 2 * BEAM_B * BEAM_K * 4 + BEAM_B * T * 4 + 2 * BEAM_B * 4)
        flops = valid * (A * M + BEAM_K * BEAM_K + 5 * C + 20 * BEAM_K)
        b_ms, b_by = bound_ms(flops, nbytes, "float32")
        case = {"M": M, "B": BEAM_B, "T": T, "A": A, "K": BEAM_K,
                "valid_frames": valid, "max_frames": int(fl.max()),
                "nll_max_rel_err": rel, "nll_max_abs_err": abs_err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "us_per_frame": k_ms * 1e3 / int(fl.max())}
        cases.append(case)
        print(f"[kernel] ctc_beam B={BEAM_B} T={T} A={A} K={BEAM_K} M={M}: "
              f"labels, lens, parents, syms identical to the plain scan; nll "
              f"rel err {rel:.1e} (bound {BEAM_NLL_REL:.0e}); kernel "
              f"{k_ms:.3f} ms ({case['us_per_frame']:.2f} us per frame of "
              f"the longest utterance), plain {p_ms:.3f} ms, bound "
              f"{b_ms * 1e3:.2f} us ({b_by})")
    # the n-best mode (all K slots, sorted), exact search
    got = beam.beam_decode_nbest(lp, fl, beam_size=BEAM_K)
    want = beam.beam_decode_nbest(lp, fl, beam_size=BEAM_K, use_kernel=False)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "ctc_beam n-best differs from the plain version")
    rel = ((got[2] - want[2]).abs() / want[2].abs().clamp(min=1)).max().item()
    check(rel <= BEAM_NLL_REL, f"ctc_beam n-best nll rel error {rel}")
    print(f"[kernel] ctc_beam n-best B={BEAM_B} K={BEAM_K}: labels and lens "
          f"identical, nll rel err {rel:.1e}")
    return cases


def attn_inputs(dev, dtype, dh: int = ATTN_DH):
    """q, k, v as (B, H, T', dh) views of one fused (B, T', 3, H, dh)
    projection (the layout the models hand over) and a ragged (B, T')
    validity mask with lengths T' and 1 among them, from a seed."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    qkv = torch.randn(B, ATTN_T, 3, ATTN_H, dh, generator=g)
    lens = torch.randint(1, ATTN_T + 1, (B,), generator=g)
    lens[0], lens[1] = ATTN_T, 1
    valid = (torch.arange(ATTN_T)[None] < lens[:, None]).to(dev)
    qkv = qkv.to(dev, dtype)
    return (*(qkv[:, :, i].transpose(1, 2) for i in range(3)), valid,
            lens.tolist())


def phase_flash(dev):
    """flash_attn in both forms vs mhsa_plain at the conformer's attention
    shape, float32 and bfloat16; the bounds and F.scaled_dot_product_attention
    beside, all device-timed."""
    import torch
    import torch.nn.functional as F

    from pg_asr_tpu_torch.ops import cuda_flash_attn
    from pg_asr_tpu_torch.ops.flash_attn import kept_tile_pairs, mhsa_plain

    scale = ATTN_DH ** -0.5
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v, valid, lens = attn_inputs(dev, dtype)
        # the (query tile, key tile) pairs the kernel skips
        skipped = 1.0 - kept_tile_pairs(valid).float().mean().item()
        got = cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale)
        ref, r_l, r_m = mhsa_plain(q, k, v, valid, scale, residuals=True)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == q.shape,
              "flash_attn output dtype/shape")
        err = (got.float() - ref.float()).abs()
        v_max = v.float().abs().max().item()
        bound = FLASH_BOUNDS[name] * (v_max if name == "bfloat16" else 1.0)
        # every row, padded queries (which attend the padded keys) included
        check(err.max().item() <= bound,
              f"flash_attn {name} disagrees with the plain version: max "
              f"{err.max().item()} > {bound}")
        # --- the residual form: o, l and m against mhsa_plain(residuals)
        o, l, m = cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale,
                                                  residuals=True)
        torch.cuda.synchronize()
        check(l.dtype == m.dtype == torch.float32
              and l.shape == m.shape == q.shape[:3], "l, m dtype/shape")
        check(torch.equal(o, got), "the residual form's o differs from the "
              "inference form's")
        l_rel = ((l - r_l).abs() / r_l).max().item()
        m_err = (m - r_m).abs().max().item()
        print(f"[kernel] flash_attn residual {name}: o max abs err "
              f"{err.max().item():.3e} (the inference form's bits), l max rel "
              f"err {l_rel:.2e} (bound {FLASH_L_REL:.0e}), m max abs err "
              f"{m_err:.2e} (bound {FLASH_M_ABS:.0e})")
        check(l_rel <= FLASH_L_REL and m_err <= FLASH_M_ABS,
              f"flash_attn residual {name}: l {l_rel}, m {m_err}")
        # kernels of tens of microseconds: device_ms, so that the host's
        # launches do not set the pace
        k_ms, p_ms = in_turns(
            lambda: mhsa_plain(q, k, v, valid, scale),
            lambda: cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale),
            10, 50, device_ms)
        r_ms, rp_ms = in_turns(
            lambda: mhsa_plain(q, k, v, valid, scale, residuals=True),
            lambda: cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale,
                                                    residuals=True),
            10, 50, device_ms)
        same = valid[:, None, :, None] == valid[:, None, None, :]
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=same, scale=scale), 50)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        sdpa_train = device_ms(lambda: F.scaled_dot_product_attention(
            *leaves, attn_mask=same, scale=scale), 50)  # row 8r's yardstick
        lib_err = (F.scaled_dot_product_attention(
            q, k, v, attn_mask=same, scale=scale).float()
            - ref.float()).abs().max().item()
        # operations on the (query, key) pairs the segment mask leaves: a
        # valid query meets the len valid keys, a padded one the T' - len
        # padded keys; q . k and p . v are 2 flops per multiply-add each.
        # Bytes: q, k, v read once, the output written once, the int32
        # mask; the residual form also writes l and m
        pairs = sum(n * n + (ATTN_T - n) ** 2 for n in lens)
        flops = 4 * ATTN_H * ATTN_DH * pairs
        nbytes = (4 * B * ATTN_H * ATTN_T * ATTN_DH * q.element_size()
                  + B * ATTN_T * 4)
        b_ms, b_by = bound_ms(flops, nbytes, name)
        b_res = bound_ms(flops, nbytes + 2 * B * ATTN_H * ATTN_T * 4, name)
        case = {"dtype": name, "B": B, "H": ATTN_H, "T": ATTN_T,
                "dh": ATTN_DH, "pairs_per_head": pairs,
                "skipped_tile_pairs": skipped,
                "max_abs_err": err.max().item(),
                "mean_abs_err": err.mean().item(), "bound": bound,
                "l_max_rel_err": l_rel, "m_max_abs_err": m_err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms,
                "library_max_abs_err": lib_err, "res_ms": r_ms,
                "res_plain_ms": rp_ms, "res_bound_ms": b_res[0],
                "res_bound_by": b_res[1], "sdpa_train_fwd_ms": sdpa_train}
        cases.append(case)
        print(f"[kernel] flash_attn B={B} H={ATTN_H} T'={ATTN_T} "
              f"dh={ATTN_DH} {name} (q, k, v views of the fused qkv; "
              f"{skipped:.4f} of the 64 x 64 tile pairs skipped): "
              f"max_abs_err {case['max_abs_err']:.3e} (bound {bound:.3e}), "
              f"mean {case['mean_abs_err']:.3e}; device-timed: kernel "
              f"{k_ms:.4f} ms, residual form {r_ms:.4f} ms, plain {p_ms:.4f}"
              f" / {rp_ms:.4f} ms, bound {b_ms:.4f} / {b_res[0]:.4f} ms "
              f"({b_by}, {flops / 1e9:.3f} GFLOP on {pairs} pairs x "
              f"{ATTN_H} heads, {nbytes / 1e6:.1f} MB); "
              f"F.scaled_dot_product_attention {lib_ms:.4f} ms, its training "
              f"forward {sdpa_train:.4f} ms (max diff to plain "
              f"{lib_err:.1e})")
    return cases


def _rel_errs(got, ref):
    """(max, mean) abs error of got relative to max|ref|."""
    top = ref.float().abs().max().item()
    d = (got.float() - ref.float()).abs()
    return d.max().item() / top, d.mean().item() / top


def phase_flash_bwd(dev):
    """flash_attn_bwd_dkv / _dq vs their plain versions at phase 3c's
    shape, float32 and bfloat16, on the plain forward's residuals; the
    bounds and the backward of F.scaled_dot_product_attention beside."""
    import torch
    import torch.nn.functional as F

    from pg_asr_tpu_torch.ops import cuda_flash_attn
    from pg_asr_tpu_torch.ops.flash_attn import (kept_tile_pairs,
                                                 mhsa_bwd_cuda,
                                                 mhsa_bwd_plain, mhsa_plain)

    scale = ATTN_DH ** -0.5
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v, valid, lens = attn_inputs(dev, dtype)
        # the (query tile, key tile) pairs the kernels skip
        skipped = 1.0 - kept_tile_pairs(valid).float().mean().item()
        s = q.element_size()
        r_o, r_l, r_m = mhsa_plain(q, k, v, valid, scale, residuals=True)
        pairs = sum(n * n + (ATTN_T - n) ** 2 for n in lens)
        bht = B * ATTN_H * ATTN_T
        tensor = bht * ATTN_DH * s  # bytes of one (B, H, T', dh) tensor
        same = valid[:, None, :, None] == valid[:, None, None, :]
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def sdpa():
            return F.scaled_dot_product_attention(*leaves, attn_mask=same,
                                                  scale=scale)

        # --- the backward, on the plain forward's residuals
        g = torch.Generator().manual_seed(SEED + 1)
        do = torch.randn(B, ATTN_T, ATTN_H, ATTN_DH, generator=g).to(
            dev, dtype).transpose(1, 2)  # as autograd hands it over
        di = (r_o.float() * do.float()).sum(-1).contiguous()
        args = (q, k, v, valid, r_l, r_m, do, di, scale)
        dk, dv = cuda_flash_attn.flash_attn_bwd_dkv_cuda(*args)
        dq = cuda_flash_attn.flash_attn_bwd_dq_cuda(*args)
        want = mhsa_bwd_plain(q, k, v, valid, r_o, r_l, r_m, do, scale)
        torch.cuda.synchronize()
        errs = {n: _rel_errs(got, w) for n, got, w in
                zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
        bd = FLASH_BWD_BOUNDS[name]
        ctrl = None
        if dtype == torch.bfloat16:
            # control: the plain backward without rounding p and ds (do and
            # k widened to float32, exactly, so they round to float32)
            c = mhsa_bwd_plain(q, k.float(), v, valid, r_o, r_l, r_m,
                               do.float(), scale)
            ctrl = min(_rel_errs(a, w)[1] for a, w in zip(c, want))
        # kernels of tens of microseconds: device_ms, so that the host's
        # launches do not set the pace
        dkv_ms, dkv_plain = in_turns(
            lambda: mhsa_bwd_plain(*args[:4], r_o, r_l, r_m, do, scale),
            lambda: cuda_flash_attn.flash_attn_bwd_dkv_cuda(*args), 10, 50,
            device_ms)
        dq_ms, dq_plain = in_turns(
            lambda: mhsa_bwd_plain(*args[:4], r_o, r_l, r_m, do, scale),
            lambda: cuda_flash_attn.flash_attn_bwd_dq_cuda(*args), 10, 50,
            device_ms)
        # the backward as FlashAttention runs it (di, dkv, dq) against
        # SDPA's, which also computes its own di
        bwd_ms = device_ms(lambda: mhsa_bwd_cuda(*args[:4], r_o, r_l, r_m,
                                                 do, scale), 50)
        sdpa_bwd = (device_ms(lambda: torch.autograd.grad(sdpa(), leaves, do),
                              50) - device_ms(sdpa, 50))
        # operations on the pairs the segment mask leaves: dkv computes s,
        # dp and its shares of dv and dk (4 dot products of dh, 8 dh
        # flops), dq s, dp and dq (6 dh). Bytes: q, k, v, do, l, m, di and
        # the mask read once, the outputs written once
        common = 4 * tensor + 3 * bht * 4 + B * ATTN_T * 4
        b_dkv = bound_ms(8 * ATTN_H * ATTN_DH * pairs, common + 2 * tensor,
                         name)
        b_dq = bound_ms(6 * ATTN_H * ATTN_DH * pairs, common + tensor, name)
        case = {"dtype": name, "B": B, "H": ATTN_H, "T": ATTN_T,
                "dh": ATTN_DH, "pairs_per_head": pairs,
                "errors_rel_to_max": errs, "bound": bd,
                "control_mean_rel_err": ctrl, "dkv_ms": dkv_ms,
                "dq_ms": dq_ms, "bwd_ms": bwd_ms,
                "skipped_tile_pairs": skipped,
                "plain_bwd_ms": (dkv_plain + dq_plain) / 2,
                "dkv_bound_ms": b_dkv[0], "dkv_bound_by": b_dkv[1],
                "dq_bound_ms": b_dq[0], "dq_bound_by": b_dq[1],
                "sdpa_bwd_ms": sdpa_bwd}
        cases.append(case)
        print(f"[kernel] flash_attn_bwd B={B} H={ATTN_H} T'={ATTN_T} "
              f"dh={ATTN_DH} {name}: max/mean abs err rel to max|grad| "
              + ", ".join(f"{n} {e[0]:.2e}/{e[1]:.2e}" for n, e in
                          errs.items())
              + f" (bounds {bd['max']:.1e}/{bd['mean']:.0e})"
              + (f", control without p/ds rounding: mean {ctrl:.2e}"
                 if ctrl is not None else "")
              + f"; dkv {dkv_ms:.4f} ms (bound {b_dkv[0]:.4f}, "
              f"{b_dkv[1]}), dq {dq_ms:.4f} ms (bound {b_dq[0]:.4f}, "
              f"{b_dq[1]}), plain backward (all three) "
              f"{case['plain_bwd_ms']:.4f} ms; di + dkv + dq "
              f"(FlashAttention.backward) {bwd_ms:.4f} ms; "
              f"F.scaled_dot_product_attention backward {sdpa_bwd:.4f} ms; "
              f"{skipped:.4f} of the 64 x 64 tile pairs skipped")
        for n, (mx, mean) in errs.items():
            check(mx <= bd["max"] and mean <= bd["mean"],
                  f"flash_attn_bwd {name}: {n} max {mx}, mean {mean} > {bd}")
        check(ctrl is None or ctrl > bd["mean"],
              f"the {name} mean bound does not tell apart a backward that "
              "skips the rounding of p and ds")
    return cases


def joint_inputs(dev, dtype):
    """The fused joint's inputs at the transducer's train shape (B=64 x 5
    s: T'=201 frames, labels of 60 symbols, J=256, A=28) from a seed: e and
    g as the projections hand them over (~N(0, 1/4)), W Xavier-normal, a
    small bias; ragged frame and label lengths (the full lengths and 1
    among them), labels 0-padded; cotangents gb, gy ~ N(0, 1) on the cells
    the loss reads and 0 elsewhere, as the lattice loss gives them. ->
    (e, g, W, b, labels), gb, gy, (frame_lens, label_lens)"""
    import torch

    g_ = torch.Generator().manual_seed(SEED)
    U, A, J = JOINT_U, JOINT_A, JOINT_J
    e = torch.randn(B, ATTN_T, J, generator=g_) * 0.5
    g = torch.randn(B, U + 1, J, generator=g_) * 0.5
    W = torch.randn(J, A, generator=g_) * (2.0 / (J + A)) ** 0.5
    b = torch.randn(A, generator=g_) * 0.1
    fl = torch.randint(1, ATTN_T + 1, (B,), generator=g_)
    ll = torch.randint(1, U + 1, (B,), generator=g_)
    fl[0], fl[1], ll[0], ll[1] = ATTN_T, 1, U, 1
    labels = torch.randint(1, A, (B, U), generator=g_)
    labels[torch.arange(U)[None] >= ll[:, None]] = 0
    t_ok = torch.arange(ATTN_T)[None, :, None] < fl[:, None, None]
    u_ok = torch.arange(U + 1)[None, None, :] <= ll[:, None, None]
    gb = torch.randn(B, ATTN_T, U + 1, generator=g_) * (t_ok & u_ok)
    gy = torch.randn(B, ATTN_T, U, generator=g_) * (t_ok & u_ok)[..., :U]
    args = tuple(t.to(dev, dtype) for t in (e, g, W, b)) + (labels.to(dev),)
    return args, gb.to(dev), gy.to(dev), (fl, ll)


def unfused_joint(e, g, W, b, labels):
    """The port's unfused composition at the inputs' dtype (the default
    path, fused_joint False): the (B, T, U+1, J) tanh, the head, then
    joint_log_probs in float32."""
    import torch

    from pg_asr_tpu_torch.ops.transducer import joint_log_probs

    return joint_log_probs(torch.tanh(e[:, :, None] + g[:, None]) @ W + b,
                           labels)


def phase_joint(dev):
    """joint_fwd and joint_bwd vs their plain versions at the transducer's
    train shape, float32 and bfloat16: errors against stated bounds,
    CUDA-event times in turns, each kernel's bound, and the port's unfused
    composition (forward, forward + backward) as the yardstick."""
    import torch

    from pg_asr_tpu_torch.ops import cuda_joint
    from pg_asr_tpu_torch.ops.joint import (fused_joint_bwd_plain,
                                            fused_joint_plain)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        args, gb, gy, (fl, ll) = joint_inputs(dev, dtype)
        U, A, J = JOINT_U, JOINT_A, JOINT_J
        s = args[0].element_size()
        lpb, lpy = cuda_joint.joint_fwd_cuda(*args)
        rb, ry = fused_joint_plain(*args)
        grads = cuda_joint.joint_bwd_cuda(*args, gb, gy)
        want = fused_joint_bwd_plain(*args, gb, gy)
        torch.cuda.synchronize()
        check(lpb.dtype == lpy.dtype == torch.float32
              and lpb.shape == (B, ATTN_T, U + 1)
              and lpy.shape == (B, ATTN_T, U), "joint_fwd dtype/shape")
        check(all(g.dtype == dtype for g in grads), "joint_bwd dtypes")
        check(all(torch.equal(g, a) for g, a in zip(
            grads, cuda_joint.joint_bwd_cuda(*args, gb, gy))),
            "joint_bwd is not deterministic")
        lp_err = {"lp_blank": _errs(lpb, rb), "lp_label": _errs(lpy, ry)}
        g_err = {n: _rel_errs(g, w) for n, g, w in
                 zip(("de", "dg", "dW", "db"), grads, want)}
        bd = JOINT_BOUNDS[name]
        # the work: per lattice cell J adds and J tanh (one operation
        # each), the head's J x A multiply-adds (2 flops each) and ~4 A for
        # the log-sum-exp; the backward recomputes the head and adds the
        # products dz . W^T and h^T dz, ~7 J elementwise ops and ~8 A.
        # Float32 math on CUDA cores in both types: the float32 peak.
        # Bytes: each input read once, each output written once (the
        # backward's scratch is not the function's)
        cells = B * ATTN_T * (U + 1)
        f_fwd = cells * (2 * J * A + 2 * J + 4 * A)
        f_bwd = cells * (3 * 2 * J * A + 7 * J + 8 * A)
        ins = (B * ATTN_T * J + B * (U + 1) * J + J * A + A) * s + B * U * 4
        outs = B * ATTN_T * (2 * U + 1) * 4
        b_fwd = bound_ms(f_fwd, ins + outs, "float32")
        b_bwd = bound_ms(f_bwd, ins + outs + ins - B * U * 4, "float32")
        fwd_ms, fwd_plain = in_turns(
            lambda: fused_joint_plain(*args),
            lambda: cuda_joint.joint_fwd_cuda(*args), 3, 20)
        bwd_ms, bwd_plain = in_turns(
            lambda: fused_joint_bwd_plain(*args, gb, gy),
            lambda: cuda_joint.joint_bwd_cuda(*args, gb, gy), 3, 20)

        # the yardstick: the port's unfused composition in this dtype
        leaves = [a.detach().requires_grad_(True) for a in args[:4]]

        def unfused_train():
            lb, ly = unfused_joint(*leaves, args[4])
            torch.autograd.grad((lb * gb).sum() + (ly * gy).sum(), leaves)

        def fused_train():
            cuda_joint.joint_fwd_cuda(*args)
            cuda_joint.joint_bwd_cuda(*args, gb, gy)

        with torch.no_grad():
            unf_ms = time_ms(lambda: unfused_joint(*args), 10)
        # in_turns(plain, kernel) returns (kernel ms, plain ms)
        fused_train_ms, unf_train_ms = in_turns(unfused_train, fused_train,
                                                5, 5)
        ub, uy = unfused_joint(*args)
        unf_err = max(_errs(ub, rb)[0], _errs(uy, ry)[0])
        case = {"dtype": name, "B": B, "T": ATTN_T, "U": U, "J": J, "A": A,
                "cells": cells, "valid_cells": int(
                    (fl * (ll + 1)).sum()), "lp_errors": lp_err,
                "grad_errors_rel_to_max": g_err, "bound": bd,
                "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain,
                "fwd_bound_ms": b_fwd[0], "fwd_bound_by": b_fwd[1],
                "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain,
                "bwd_bound_ms": b_bwd[0], "bwd_bound_by": b_bwd[1],
                "fwd_gflop": f_fwd / 1e9, "bwd_gflop": f_bwd / 1e9,
                "unfused_fwd_ms": unf_ms,
                "unfused_fwd_bwd_ms": unf_train_ms,
                "fused_fwd_bwd_ms": fused_train_ms,
                "unfused_max_abs_err_to_plain": unf_err}
        cases.append(case)
        print(f"[kernel] joint_fwd B={B} T'={ATTN_T} U+1={U + 1} J={J} "
              f"A={A} {name}: " + ", ".join(
                  f"{k} max {v[0]:.2e} mean {v[1]:.2e}" for k, v in
                  lp_err.items())
              + f" (bounds {bd['lp_max']:.0e} / {bd['lp_mean']:.0e}); "
              f"kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, bound "
              f"{b_fwd[0]:.4f} ms ({b_fwd[1]}, {f_fwd / 1e9:.2f} GFLOP); "
              f"unfused composition ({name}) {unf_ms:.4f} ms (max diff to "
              f"plain {unf_err:.1e})")
        print(f"[kernel] joint_bwd {name}: max/mean abs err rel to "
              f"max|grad| " + ", ".join(
                  f"{n} {e[0]:.2e}/{e[1]:.2e}" for n, e in g_err.items())
              + f" (bounds {bd['grad_max']:.1e}/{bd['grad_mean']:.0e}); "
              f"kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, bound "
              f"{b_bwd[0]:.4f} ms ({b_bwd[1]}, {f_bwd / 1e9:.2f} GFLOP); "
              f"forward + backward: fused kernels {fused_train_ms:.4f} ms, "
              f"unfused composition {unf_train_ms:.4f} ms")
        for k, (mx, mean) in lp_err.items():
            check(mx <= bd["lp_max"] and mean <= bd["lp_mean"],
                  f"joint_fwd {name}: {k} max {mx}, mean {mean} > {bd}")
        for k, (mx, mean) in g_err.items():
            check(mx <= bd["grad_max"] and mean <= bd["grad_mean"],
                  f"joint_bwd {name}: {k} max {mx}, mean {mean} > {bd}")
    return cases


def lstm_shape_case(dev, dtype, lH: int, lens, g_, tag: str,
                    note: str) -> dict:
    """lstm_fwd (both forms) and lstm_bwd at B = len(lens), T = max(lens),
    H = lH against their plain versions within phase 3's bounds (the bf16
    means against a control without the bf16 roundings), each launched
    once; the inputs drawn from the CPU generator g_; times in turns."""
    import torch

    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.ops.lstm import lstm_scan_bwd_plain, lstm_scan_plain

    name = str(dtype).split(".")[1]
    nB, nT = len(lens), int(lens.max())
    mask = (torch.arange(nT)[None] < lens[:, None]).to(dev, torch.float32)
    xp = (0.5 * torch.randn(nB, nT, 4 * lH, generator=g_)).to(dev, dtype)
    U = ((torch.rand(lH, 4 * lH, generator=g_) * 2 - 1)
         / math.sqrt(lH)).to(dev, dtype)
    gy = torch.randn(nB, nT, lH, generator=g_).to(dev, dtype)
    c0 = (cuda_lstm.LAUNCHES, cuda_lstm.RES_LAUNCHES,
          cuda_lstm.BWD_LAUNCHES)
    got = cuda_lstm.lstm_scan_cuda(xp, U, mask, False)
    o_r, h_r, c_r = cuda_lstm.lstm_scan_residual_cuda(xp, U, mask, False)
    ref = lstm_scan_plain(xp, U, mask, False, residuals=True)
    dxp, dU = cuda_lstm.lstm_scan_bwd_cuda(xp, U, mask, ref[1], ref[2],
                                           gy, False)
    r_dxp, r_dU = lstm_scan_bwd_plain(xp, U, mask, ref[1], ref[2], gy,
                                      False)
    torch.cuda.synchronize()
    check((cuda_lstm.LAUNCHES, cuda_lstm.RES_LAUNCHES,
           cuda_lstm.BWD_LAUNCHES) == (c0[0] + 1, c0[1] + 1, c0[2] + 1),
          f"lstm H={lH}: launches")
    check(torch.equal(o_r, got), f"lstm H={lH}: the residual form's out")
    errs = {"out": _errs(got, ref[0]), "hprev": _errs(h_r, ref[1]),
            "cprev": _errs(c_r, ref[2])}
    bb = BWD_BOUNDS[name]
    e_dxp, e_du = _errs(dxp, r_dxp), _errs(dU, r_dU)
    dxp_max = bb.get("dxp_max", bb.get("dxp_rel", 0)
                     * r_dxp.float().abs().max().item())
    # phase 3's max bounds hold at any H. Its bf16 mean bounds were set
    # from readings at H=256, and more products per sum move more
    # bf16 roundings of h by an ulp (out mean 2.1e-6 at H=1024 against
    # 3.7e-7 at 256); what the mean must show, that h and dpre round
    # to bf16 where the Pallas body rounds them, is held here against
    # a control of the plain version without those roundings (U
    # widened to float32): the kernel's mean at most a third of it
    means = {k: v[1] for k, v in errs.items()}
    means["dxp"] = e_dxp[1]
    if dtype == torch.bfloat16:
        c_ref = lstm_scan_plain(xp, U.float(), mask, False,
                                residuals=True)
        c_dxp, _ = lstm_scan_bwd_plain(xp, U.float(), mask, ref[1],
                                       ref[2], gy, False)
        ctrl = {k: _errs(c, r)[1] for k, c, r in zip(
            ("out", "hprev", "cprev"), c_ref, ref)}
        ctrl["dxp"] = _errs(c_dxp, r_dxp)[1]
        mean_ok = {k: means[k] <= ctrl[k] / 3 for k in means}
    else:
        ctrl = None
        mean_ok = {k: means[k] <= (CPREV_BOUNDS if k == "cprev"
                                   else BOUNDS)[name]["mean"]
                   for k in errs}
        mean_ok["dxp"] = means["dxp"] <= bb["dxp_mean"]
    for k, (mx, mean) in errs.items():
        bd = CPREV_BOUNDS[name] if k == "cprev" else BOUNDS[name]
        check(mx <= bd["max"] and mean_ok[k],
              f"lstm_fwd H={lH} {name}: {k} max {mx}, mean {mean} "
              f"(bounds {bd}, control {ctrl})")
    check(e_dxp[0] <= dxp_max and mean_ok["dxp"],
          f"lstm_bwd H={lH} {name}: dxp {e_dxp} out of bounds (control "
          f"{ctrl})")
    check(e_du[0] <= bb["du_rel"] * r_dU.float().abs().max().item(),
          f"lstm_bwd H={lH} {name}: dU {e_du} out of bounds")
    fwd_ms, fwd_plain = in_turns(
        lambda: lstm_scan_plain(xp, U, mask, False),
        lambda: cuda_lstm.lstm_scan_cuda(xp, U, mask, False), 1, 5)
    bwd_ms = time_ms(lambda: cuda_lstm.lstm_scan_bwd_cuda(
        xp, U, mask, ref[1], ref[2], gy, False), 3)
    print(f"[{tag}] lstm B={nB} T={nT} H={lH} {name} {note}: "
          f"lstm_fwd, its residual form and lstm_bwd launched once each; "
          + ", ".join(f"{k} max {v[0]:.2e} mean {v[1]:.2e}"
                      for k, v in errs.items())
          + (f" (controls without the bf16 roundings: {ctrl})" if ctrl
             else "")
          + f"; dxp max {e_dxp[0]:.2e} mean {e_dxp[1]:.2e}, dU max "
          f"{e_du[0]:.2e}; lstm_fwd {fwd_ms:.3f} ms (plain "
          f"{fwd_plain:.3f} ms), lstm_bwd {bwd_ms:.3f} ms")
    return {"dtype": name, "B": nB, "T": nT, "H": lH, "errors": errs,
            "control_means": ctrl, "dxp_errors": e_dxp, "du_errors": e_du,
            "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain, "bwd_ms": bwd_ms}


def phase_shapes(dev):
    """The shapes past the first kernels' limits, each on its kernel (its
    launch counter rises by one a call, nothing falls back) against its
    plain version within the bounds of phases 3b-3e: the LSTM at H=512
    float32 and 1024 bfloat16; the joint at A=256, J=640 (a BPE
    vocabulary, joint_dim 640); flash attention at dh=128 (d_model 512
    with 4 heads) and 256 (the wide kernels) at phase 3c's shape, forward
    and backward, device-timed beside SDPA; the beam at K=64 over A=5000 (the block
    form) and at K=16 over A=5000 (the warp form), M=6 and exact, best
    and n-best. -> {"lstm": [...], "joint": [...], "flash": [...],
    "beam": [...]}"""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from pg_asr_tpu_torch.decoding import beam, cuda_beam
    from pg_asr_tpu_torch.ops import cuda_flash_attn, cuda_joint
    from pg_asr_tpu_torch.ops.flash_attn import mhsa_bwd_plain, mhsa_plain
    from pg_asr_tpu_torch.ops.joint import (fused_joint_bwd_plain,
                                            fused_joint_plain)

    from pg_asr_tpu_torch.ops import cuda_lstm

    out = {"lstm": [], "bilstm": [], "joint": [], "flash": [], "beam": []}
    # --- the LSTM at phase 3's B and T past 512 units (U's columns from L2):
    # H=512 float32, H=1024 bfloat16 and H=2048 (fewer rows a cluster, a
    # thread looping over units) in both, forward scan, both forms and the
    # backward on the plain forward's residuals, within phase 3's bounds
    for dtype, lH in ((torch.float32, 512), (torch.bfloat16, 1024),
                      (torch.float32, 2048), (torch.bfloat16, 2048)):
        g_ = torch.Generator().manual_seed(SEED)
        lens = torch.randint(1, T + 1, (B,), generator=g_)
        lens[0], lens[1] = T, 1
        out["lstm"].append(lstm_shape_case(dev, dtype, lH, lens, g_,
                                           "shapes", "(U from L2)"))

    # --- the fused directions at phase 3's B and T and H=1024 (refused by
    # the first fused kernels): bilstm_fwd (both forms) and bilstm_bwd, each
    # direction equal bit for bit to lstm_fwd / lstm_bwd, against the plain
    # versions within phase 3's max bounds; timed beside two single-direction
    # launches
    from pg_asr_tpu_torch.ops.lstm import (bilstm_scan_bwd_plain,
                                           bilstm_scan_plain)
    for dtype in (torch.float32, torch.bfloat16):
        lH, name = 1024, str(dtype).split(".")[1]
        g_ = torch.Generator().manual_seed(SEED + 3)
        lens = torch.randint(1, T + 1, (B,), generator=g_)
        lens[0], lens[1] = T, 1
        mask = (torch.arange(T)[None] < lens[:, None]).to(dev, torch.float32)
        xpf, xpb = ((0.5 * torch.randn(B, T, 4 * lH, generator=g_)).to(
            dev, dtype) for _ in range(2))
        Uf, Ub = (((torch.rand(lH, 4 * lH, generator=g_) * 2 - 1)
                   / math.sqrt(lH)).to(dev, dtype) for _ in range(2))
        gy = torch.randn(B, T, 2 * lH, generator=g_).to(dev, dtype)
        args = (xpf, xpb, Uf, Ub, mask)
        c0 = lstm_counts()
        res = cuda_lstm.bilstm_scan_residual_cuda(*args)
        y = cuda_lstm.bilstm_scan_cuda(*args)
        ref = bilstm_scan_plain(*args, residuals=True)
        bwd = cuda_lstm.bilstm_scan_bwd_cuda(*args, *ref[1:], gy)
        c1 = lstm_counts()
        r_bwd = bilstm_scan_bwd_plain(*args, *ref[1:], gy)
        sf = cuda_lstm.lstm_scan_residual_cuda(xpf, Uf, mask, False)
        sb = cuda_lstm.lstm_scan_residual_cuda(xpb, Ub, mask, True)
        gyf, gyb = gy[..., :lH].contiguous(), gy[..., lH:].contiguous()
        s_f = cuda_lstm.lstm_scan_bwd_cuda(xpf, Uf, mask, ref[1], ref[2], gyf,
                                           False)
        s_b = cuda_lstm.lstm_scan_bwd_cuda(xpb, Ub, mask, ref[3], ref[4], gyb,
                                           True)
        torch.cuda.synchronize()
        check({k: c1[k] - c0[k] for k in c0} == {
            **dict.fromkeys(c0, 0), "bilstm_fwd": 1, "bilstm_fwd_residual": 1,
            "bilstm_bwd": 1}, f"bilstm H={lH}: launches")
        check(torch.equal(y, res[0]), f"bilstm H={lH}: the forms' y differ")
        equal = all(torch.equal(a, b) for a, b in zip(
            (*res, *bwd), (torch.cat([sf[0], sb[0]], -1), sf[1], sf[2],
                           sb[1], sb[2], s_f[0], s_b[0], s_f[1], s_b[1])))
        check(equal, f"bilstm H={lH} {name}: bits differ from two "
                     "single-direction launches")
        errs = {k: _errs(g, r)[0] for k, g, r in zip(
            ("y", "hpf", "cpf", "hpb", "cpb"), res, ref)}
        for k, mx in errs.items():
            bd = CPREV_BOUNDS[name] if k.startswith("c") else BOUNDS[name]
            check(mx <= bd["max"], f"bilstm_fwd H={lH} {name}: {k} {mx}")
        bb = BWD_BOUNDS[name]
        for k, g_b, r_b in zip(("dxpf", "dxpb", "dUf", "dUb"), bwd, r_bwd):
            ref_max = r_b.float().abs().max().item()
            lim = (bb["du_rel"] * ref_max if k.startswith("dU")
                   else bb.get("dxp_max", bb.get("dxp_rel", 0) * ref_max))
            errs[k] = _errs(g_b, r_b)[0]
            check(errs[k] <= lim, f"bilstm_bwd H={lH} {name}: {k} "
                                  f"{errs[k]} > {lim}")
        t = turns({
            "fwd": lambda: cuda_lstm.bilstm_scan_cuda(*args),
            "two_fwd": lambda: (cuda_lstm.lstm_scan_cuda(xpf, Uf, mask, False),
                                cuda_lstm.lstm_scan_cuda(xpb, Ub, mask, True)),
            "bwd": lambda: cuda_lstm.bilstm_scan_bwd_cuda(*args, *ref[1:], gy),
            "two_bwd": lambda: (
                cuda_lstm.lstm_scan_bwd_cuda(xpf, Uf, mask, ref[1], ref[2],
                                             gyf, False),
                cuda_lstm.lstm_scan_bwd_cuda(xpb, Ub, mask, ref[3], ref[4],
                                             gyb, True))},
            dict.fromkeys(("fwd", "two_fwd", "bwd", "two_bwd"), 2))
        out["bilstm"].append({"dtype": name, "B": B, "T": T, "H": lH,
                              "max_abs_errors": errs, **{
                                  f"{k}_ms": v for k, v in t.items()}})
        print(f"[shapes] bilstm B={B} T={T} H={lH} {name}: bilstm_fwd (both "
              f"forms) and bilstm_bwd launched once each, each direction "
              f"equal bit for bit to lstm_fwd / lstm_bwd; max abs errors "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; in turns: bilstm_fwd {t['fwd']:.3f} ms (2 x lstm_fwd "
              f"{t['two_fwd']:.3f}), bilstm_bwd {t['bwd']:.3f} ms (2 x "
              f"lstm_bwd {t['two_bwd']:.3f})")

    # --- the joint: a few utterances at A=256, J=640
    jB, jT, jU, jJ, jA = 4, 51, 20, 640, 256
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        g_ = torch.Generator().manual_seed(SEED)
        e, g, W, b = (torch.randn(*sh, generator=g_) * sc for sh, sc in (
            ((jB, jT, jJ), 0.5), ((jB, jU + 1, jJ), 0.5),
            ((jJ, jA), (2.0 / (jJ + jA)) ** 0.5), ((jA,), 0.1)))
        labels = torch.randint(1, jA, (jB, jU), generator=g_)
        gb = torch.randn(jB, jT, jU + 1, generator=g_).to(dev)
        gy = torch.randn(jB, jT, jU, generator=g_).to(dev)
        args = tuple(t.to(dev, dtype) for t in (e, g, W, b)) + (
            labels.to(dev),)
        c0 = (cuda_joint.FWD_LAUNCHES, cuda_joint.BWD_LAUNCHES)
        lpb, lpy = cuda_joint.joint_fwd_cuda(*args)
        grads = cuda_joint.joint_bwd_cuda(*args, gb, gy)
        torch.cuda.synchronize()
        check((cuda_joint.FWD_LAUNCHES, cuda_joint.BWD_LAUNCHES)
              == (c0[0] + 1, c0[1] + 1), "joint A=256 J=640: launches")
        bd = JOINT_BOUNDS[name]
        lp_err = {k: _errs(got, ref) for k, got, ref in zip(
            ("lp_blank", "lp_label"), (lpb, lpy), fused_joint_plain(*args))}
        g_err = {n: _rel_errs(gr, w) for n, gr, w in zip(
            ("de", "dg", "dW", "db"), grads,
            fused_joint_bwd_plain(*args, gb, gy))}
        for k, (mx, mean) in lp_err.items():
            check(mx <= bd["lp_max"] and mean <= bd["lp_mean"],
                  f"joint_fwd A={jA} J={jJ} {name}: {k} {mx}, {mean}")
        for k, (mx, mean) in g_err.items():
            check(mx <= bd["grad_max"] and mean <= bd["grad_mean"],
                  f"joint_bwd A={jA} J={jJ} {name}: {k} {mx}, {mean}")
        check(all(torch.equal(gr, a) for gr, a in zip(
            grads, cuda_joint.joint_bwd_cuda(*args, gb, gy))),
            "joint_bwd A=256 J=640 is not deterministic")
        fwd_ms = time_ms(lambda: cuda_joint.joint_fwd_cuda(*args), 5)
        bwd_ms = time_ms(lambda: cuda_joint.joint_bwd_cuda(*args, gb, gy), 5)
        out["joint"].append({"dtype": name, "B": jB, "T": jT, "U": jU,
                             "J": jJ, "A": jA, "lp_errors": lp_err,
                             "grad_errors_rel_to_max": g_err,
                             "fwd_ms": fwd_ms, "bwd_ms": bwd_ms})
        print(f"[shapes] joint B={jB} T'={jT} U+1={jU + 1} J={jJ} A={jA} "
              f"{name}: joint_fwd and joint_bwd launched once each; "
              + ", ".join(f"{k} {v[0]:.2e}" for k, v in lp_err.items())
              + ", " + ", ".join(f"{n} {e[0]:.2e}" for n, e in g_err.items())
              + f" (max, grads rel to max|grad|); repeats its bits; "
              f"joint_fwd {fwd_ms:.4f} ms, joint_bwd {bwd_ms:.4f} ms")

    # --- flash attention at dh=128 (an instance), 256 (the wide kernels)
    # and 512 (the wide kernels in two pieces), phase 3c's shape
    for dh, dtype in ((128, torch.float32), (128, torch.bfloat16),
                      (256, torch.float32), (256, torch.bfloat16),
                      (512, torch.float32), (512, torch.bfloat16)):
        scale = dh ** -0.5
        name = str(dtype).split(".")[1]
        q, k, v, valid, lens = attn_inputs(dev, dtype, dh)
        c0 = flash_counts()
        got = cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale)
        ref, r_l, r_m = mhsa_plain(q, k, v, valid, scale, residuals=True)
        do = torch.randn(q.shape, generator=torch.Generator().manual_seed(
            SEED)).to(dev, dtype)
        di = (ref.float() * do.float()).sum(-1).contiguous()
        dk, dv = cuda_flash_attn.flash_attn_bwd_dkv_cuda(
            q, k, v, valid, r_l, r_m, do, di, scale)
        dq = cuda_flash_attn.flash_attn_bwd_dq_cuda(q, k, v, valid, r_l, r_m,
                                                    do, di, scale)
        torch.cuda.synchronize()
        c1 = flash_counts()
        check((c1["flash_attn"], c1["flash_attn_bwd_dkv"],
               c1["flash_attn_bwd_dq"]) == (
            c0["flash_attn"] + 1, c0["flash_attn_bwd_dkv"] + 1,
            c0["flash_attn_bwd_dq"] + 1), f"flash dh={dh}: launches")
        err = (got.float() - ref.float()).abs().max().item()
        bound = FLASH_BOUNDS[name] * (v.float().abs().max().item()
                                      if name == "bfloat16" else 1.0)
        check(err <= bound, f"flash_attn dh={dh} {name}: {err} > {bound}")
        bwd_err = {n: _rel_errs(gr, w) for n, gr, w in zip(
            ("dq", "dk", "dv"), (dq, dk, dv),
            mhsa_bwd_plain(q, k, v, valid, ref, r_l, r_m, do, scale))}
        for n, (mx, _) in bwd_err.items():
            check(mx <= FLASH_BWD_BOUNDS[name]["max"],
                  f"flash_attn_bwd dh={dh} {name}: {n} {mx}")
        k_ms, p_ms = in_turns(
            lambda: mhsa_plain(q, k, v, valid, scale),
            lambda: cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale),
            5, 50, device_ms)
        same = valid[:, None, :, None] == valid[:, None, None, :]
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=same, scale=scale), 50)
        dkv_ms = device_ms(lambda: cuda_flash_attn.flash_attn_bwd_dkv_cuda(
            q, k, v, valid, r_l, r_m, do, di, scale), 50)
        dq_ms = device_ms(lambda: cuda_flash_attn.flash_attn_bwd_dq_cuda(
            q, k, v, valid, r_l, r_m, do, di, scale), 50)
        pairs = sum(n * n + (ATTN_T - n) ** 2 for n in lens)
        flops = 4 * ATTN_H * dh * pairs
        nbytes = 4 * B * ATTN_H * ATTN_T * dh * q.element_size() + B * ATTN_T * 4
        b_ms, b_by = bound_ms(flops, nbytes, name)
        out["flash"].append({"dtype": name, "B": B, "H": ATTN_H, "T": ATTN_T,
                             "dh": dh, "max_abs_err": err, "bound": bound,
                             "bwd_errors_rel_to_max": bwd_err, "ms": k_ms,
                             "plain_ms": p_ms, "library_ms": lib_ms,
                             "bound_ms": b_ms, "bound_by": b_by,
                             "dkv_ms": dkv_ms, "dq_ms": dq_ms})
        print(f"[shapes] flash_attn B={B} H={ATTN_H} T'={ATTN_T} dh={dh} "
              f"{name}: flash_attn, dkv, dq launched once each; o max abs "
              f"err {err:.2e} (bound {bound:.2e}), " + ", ".join(
                  f"{n} {e[0]:.2e}" for n, e in bwd_err.items())
              + f" (rel to max|grad|); device-timed: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); dkv {dkv_ms:.4f} ms, dq "
              f"{dq_ms:.4f} ms")

    # --- the beam over A=5000: K=64 (the block form), K=16 (the warp form)
    rng = np.random.default_rng(SEED)
    bB, bT, bA = 8, 101, 5000
    x = rng.standard_normal((bB, bT, bA)) * 2.0
    lp = torch.from_numpy((x - np.log(np.exp(x).sum(-1, keepdims=True)))
                          .astype(np.float32)).to(dev)
    fl_np = rng.integers(1, bT + 1, bB).astype(np.int32)
    fl_np[:3] = [bT, 1, 2]
    fl = torch.from_numpy(fl_np).to(dev)
    for K in (64, 16):
        for M in (6, beam._prune_m(bA, K, None)):
            c0 = cuda_beam.LAUNCHES
            _, rel, _ = beam_vs_plain(lp, fl, M, bT, K=K)
            check(cuda_beam.LAUNCHES == c0 + 1, f"ctc_beam K={K}: launches")
            ms = time_ms(lambda: cuda_beam.ctc_beam_cuda(lp, fl, K=K, M=M,
                                                         Lmax=bT), 3)
            out["beam"].append({"B": bB, "T": bT, "A": bA, "K": K, "M": M,
                                "nll_max_rel_err": rel, "ms": ms})
            print(f"[shapes] ctc_beam B={bB} T={bT} A={bA} K={K} M={M}: "
                  f"launched once; labels, lens, parents, syms identical to "
                  f"the plain scan, nll rel err {rel:.1e}; kernel {ms:.3f} ms")
        got = beam.beam_decode_nbest(lp, fl, beam_size=K, max_label_len=bT)
        want = beam.beam_decode_nbest(lp, fl, beam_size=K, max_label_len=bT,
                                      use_kernel=False)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"ctc_beam n-best K={K} A={bA} differs from the plain version")
        rel = ((got[2] - want[2]).abs() / want[2].abs().clamp(min=1)).max()
        check(rel.item() <= BEAM_NLL_REL, f"ctc_beam n-best K={K}: nll {rel}")
        print(f"[shapes] ctc_beam n-best B={bB} A={bA} K={K}: identical, nll "
              f"rel err {rel.item():.1e}")
    return out


def make_corpus(d):
    from pg_asr_tpu_torch.data import make_synthetic_corpus

    t0 = time.perf_counter()
    corpus, alphabet = make_synthetic_corpus(
        os.path.join(d, "corpus"), n_utts=N_UTTS, seed=SEED, min_dur=1.0,
        max_dur=5.0, words=WORDS)
    print(f"[corpus] {N_UTTS} synthetic utterances of 1-5 s in "
          f"{time.perf_counter() - t0:.1f} s")
    return corpus, alphabet


def run_cli(argv):
    """cli.main(argv) with its stdout captured; returns (rc, stdout)."""
    from pg_asr_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    print(out.getvalue().rstrip())
    return rc, out.getvalue()


def phase_predict(dev, corpus, alphabet, d, bi):
    import torch

    from pg_asr_tpu_torch.checkpoint import save_model
    from pg_asr_tpu_torch.config import Config, ModelConfig
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.models import bilstm_ctc
    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.predict import forward, load_model

    bs = 32  # the CLI's default, which the run below does not override
    cfg = Config(model=ModelConfig(vocab_size=alphabet.size))
    params = bilstm_ctc.init_params(cfg.model,
                                    torch.Generator().manual_seed(SEED))
    model_dir = os.path.join(d, "model")
    save_model(model_dir, params, cfg)
    n_params = sum(p.numel() for p in params.values())
    utts = load_manifest(os.path.join(corpus, "test.tsv"),
                         os.path.join(corpus, "clips"))
    n_batches = -(-len(utts) // bs)
    print(f"[predict] BiLSTM-CTC {cfg.model.num_layers}x"
          f"{cfg.model.hidden_size}/dir, proj {cfg.model.input_proj_dim}, "
          f"vocab {alphabet.size}, {n_params} params; {len(utts)} test "
          f"utterances in {n_batches} batches of <= {bs}")

    inf, _, _, per_batch = route_counters()
    reset_counts()
    t0 = time.perf_counter()
    rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                       "--model_path", model_dir, "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lstm_counts()
    print(f"[predict] rc={rc} in {wall:.2f} s (host clock, first run: "
          f"includes data loading and warm-up); LSTM launches {launches}")
    check(rc == 0, "predict failed")
    check("CER:" in out and "WER:" in out, "CER/WER not printed")
    with open(os.path.join(model_dir, "predicted.txt")) as fo:
        rows = fo.read().splitlines()
    check(len(rows) == len(utts) and all("|" in r for r in rows),
          f"predicted.txt has {len(rows)} rows for {len(utts)} utts")
    check(launches == {**dict.fromkeys(launches, 0),
                       inf: per_batch * n_batches},
          f"LSTM launches {launches}, expected {per_batch} {inf} x "
          f"{n_batches} batches")

    # one batch: the forward with the kernel vs with the plain recurrence
    params_d, cfg_d = load_model(model_dir, alphabet, device=dev)
    batch = next(iter(BatchIterator(utts, alphabet, bs, shuffle=False)))
    wave = torch.from_numpy(batch.wave).to(dev)
    ns = torch.from_numpy(batch.num_samples).to(dev)
    lp_k, _, _ = forward(params_d, wave, ns, cfg_d)
    lp_p, _, _ = forward(params_d, wave, ns, cfg_d, use_kernel=False)
    torch.cuda.synchronize()
    T_b = batch.wave.shape[1] // cfg.features.hop_length + 1
    check(tuple(lp_k.shape) == (len(batch.texts), T_b, alphabet.size),
          f"log-probs shape {tuple(lp_k.shape)}")
    check(bool(torch.isfinite(lp_k).all()), "non-finite log-probs")
    err = (lp_k - lp_p).abs().max().item()
    print(f"[predict] batch log-probs {tuple(lp_k.shape)}: kernel vs plain "
          f"max_abs_err {err:.3e} (bound {LOGPROB_BOUND:.0e})")
    check(err <= LOGPROB_BOUND, f"log-probs disagree: {err}")

    # the forward (features + model) at the kernel phase's batch shape
    wave64, ns64 = flagship_batch(dev)[:2]
    for dtype in ("float32", "bfloat16"):
        p_d, c_d = load_model(model_dir, alphabet, device=dev, dtype=dtype)
        f_k = time_ms(lambda: forward(p_d, wave64, ns64, c_d), 5)
        fused = next(c for c in bi["cases"] if c["dtype"] == dtype)
        lstm = per_batch * fused["fwd_ms"]
        print(f"[predict] forward B={B} x 5 s (T={T}), {dtype}: with kernel "
              f"{f_k:.2f} ms; the {per_batch} {inf} launches at phase 3f's "
              f"time: {lstm:.2f} ms ({lstm / f_k:.0%})")

    beam_launches = run_beam_predict(dev, corpus, model_dir, len(utts))
    # the beam batch's log-probs: ctc_beam vs the plain scan. Random weights
    # give nearly flat posteriors, so near-ties abound; the two compute the
    # same float32 operations in the same order, so they must still agree
    # exactly on labels, lens, parents and syms.
    batch = next(iter(BatchIterator(utts, alphabet, BEAM_B, shuffle=False)))
    lp, _, fl = forward(params_d, torch.from_numpy(batch.wave).to(dev),
                        torch.from_numpy(batch.num_samples).to(dev), cfg_d)
    Lmax = min(cfg_d.decode.max_label_len, lp.shape[1])
    out, rel, _ = beam_vs_plain(lp, fl.to(torch.int32).contiguous(),
                                cfg_d.decode.beam_prune, Lmax)
    print(f"[predict] beam batch {tuple(lp.shape)}: ctc_beam (M="
          f"{cfg_d.decode.beam_prune}) identical to the plain scan, nll rel "
          f"err {rel:.1e}; mean label length "
          f"{out.nb_lens.float().mean().item():.1f}")
    return launches, beam_launches


def run_beam_predict(dev, corpus, model_dir, n_utts: int) -> int:
    """`--mode predict --decoder beam` through the CLI (default batch 128,
    K=16, prune 6); checks its outputs and that each batch launched ctc_beam
    once and the encoder's route its LSTM kernels (route_counters). Returns
    the ctc_beam launches."""
    import torch

    from pg_asr_tpu_torch.config import Config
    from pg_asr_tpu_torch.decoding import cuda_beam
    from pg_asr_tpu_torch.ops import cuda_lstm

    n_batches = -(-n_utts // BEAM_B)
    inf, _, _, per_batch = route_counters()
    reset_counts()
    t0 = time.perf_counter()
    rc, out = run_cli(["--mode", "predict", "--decoder", "beam",
                       "--corpus_path", corpus, "--model_path", model_dir,
                       "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, lstm = cuda_beam.LAUNCHES, lstm_counts()
    print(f"[predict] --decoder beam: rc={rc} in {wall:.2f} s (host clock); "
          f"{n_utts} utterances in {n_batches} batch(es) of <= {BEAM_B}; "
          f"ctc_beam launches {launches}, LSTM launches {lstm}")
    check(rc == 0, "beam predict failed")
    check("CER:" in out and "WER:" in out, "beam predict: CER/WER not printed")
    with open(os.path.join(model_dir, "predicted.txt")) as fo:
        rows = fo.read().splitlines()
    check(len(rows) == n_utts and all("|" in r for r in rows),
          f"beam predict: predicted.txt has {len(rows)} rows for {n_utts}")
    check(launches == n_batches,
          f"ctc_beam launched {launches} times for {n_batches} batches")
    check(lstm == {**dict.fromkeys(lstm, 0), inf: per_batch * n_batches},
          f"beam predict: LSTM launches {lstm}, expected {per_batch} {inf} "
          f"x {n_batches}")
    return launches


def flagship_batch(dev, label_len: int = 60, vocab: int = 28,
                   batch: int = B):
    """`batch` (default B=64) utterances of 5 s (WAVE_SAMPLES, T=401
    frames) with random labels of 60 symbols (the length of 5 s of read
    English): int16 waves, lengths, labels, label lengths on the device."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    wave = (torch.randn(batch, WAVE_SAMPLES, generator=g) * 3000).to(
        torch.int16)
    ns = torch.full((batch,), WAVE_SAMPLES, dtype=torch.int32)
    labels = torch.randint(1, vocab, (batch, label_len), generator=g,
                           dtype=torch.int32)
    lens = torch.full((batch,), label_len, dtype=torch.int32)
    return tuple(a.to(dev) for a in (wave, ns, labels, lens))


def phase_train(dev, corpus, alphabet, d, bi):
    import numpy as np
    import torch

    from pg_asr_tpu_torch.config import Config, ModelConfig
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.predict import load_model
    from pg_asr_tpu_torch.train import (AdamW, batch_to_device,
                                        loss_and_grads)

    bs = 32  # the CLI's default
    clips = os.path.join(corpus, "clips")
    n_train = len(load_manifest(os.path.join(corpus, "train.tsv"), clips))
    dev_utts = load_manifest(os.path.join(corpus, "dev.tsv"), clips)
    n_test = len(load_manifest(os.path.join(corpus, "test.tsv"), clips))
    steps, n_dev = -(-n_train // bs), -(-len(dev_utts) // bs)
    model_dir = os.path.join(d, "trained")
    argv = ["--mode", "train", "--corpus_path", corpus, "--model_path",
            model_dir, "--device", str(dev), "--seed", str(SEED)]

    inf, res, bwd, per = route_counters()  # launches per forward
    reset_counts()
    t0 = time.perf_counter()
    rc, out = run_cli(argv + ["--num_epochs", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = lstm_counts()
    print(f"[train] rc={rc}, 1 epoch of {n_train} utterances ({steps} "
          f"steps of <= {bs}) + validation on {len(dev_utts)} in {wall:.2f} "
          f"s (host clock, includes WAV decode); launches {counts}")
    check(rc == 0, "train failed")
    check(counts == {**dict.fromkeys(counts, 0), res: per * steps,
                     bwd: per * steps, inf: per * n_dev},
          f"LSTM launches {counts}, expected {per} {res} and {per} {bwd} x "
          f"{steps} steps, {per} {inf} x {n_dev} dev batches")
    for name in ("model_best.pt", "model_last.pt", "train_loss.npy",
                 "val_losses.npy", "config.json"):
        check(os.path.exists(os.path.join(model_dir, name)), f"no {name}")
    tl = np.load(os.path.join(model_dir, "train_loss.npy"))
    vl = np.load(os.path.join(model_dir, "val_losses.npy"))
    check(tl.shape == vl.shape == (1,) and np.isfinite(tl).all()
          and np.isfinite(vl).all(), f"losses {tl} {vl}")

    rc, out = run_cli(argv + ["--num_epochs", "2"])
    tl = np.load(os.path.join(model_dir, "train_loss.npy"))
    check(rc == 0 and "resumed from epoch 1" in out and tl.shape == (2,)
          and np.isfinite(tl).all(), f"resume failed: {tl}")
    reset_counts()
    rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                       "--model_path", model_dir, "--device", str(dev)])
    check(rc == 0 and "CER:" in out and "WER:" in out,
          "predict on the trained model failed")
    got = lstm_counts()
    check(got == {**dict.fromkeys(got, 0), inf: per * -(-n_test // bs)},
          f"predict on the trained model: LSTM launches {got}")
    counts["ctc_beam"] = run_beam_predict(dev, corpus, model_dir, n_test)

    # one batch: loss and every parameter gradient, kernel vs plain path
    params, cfg = load_model(model_dir, alphabet, device=dev)
    cfg = cfg.replace(model=ModelConfig(**{**cfg.model.__dict__,
                                           "dropout": 0.0}))
    utts = load_manifest(os.path.join(corpus, "train.tsv"), clips)
    batch = next(iter(BatchIterator(utts, alphabet, bs, shuffle=False)))
    arrays = batch_to_device(batch, dev)
    loss_k, g_k = loss_and_grads(params, arrays, cfg)
    loss_p, g_p = loss_and_grads(params, arrays, cfg, use_kernel=False)
    torch.cuda.synchronize()
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_rel = {k: ((g_k[k] - g_p[k]).abs().max()
                    / g_p[k].abs().max()).item() for k in g_p}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"[train] one batch {tuple(batch.wave.shape)}, kernel vs plain "
          f"path (float32, dropout 0): loss {loss_k.item():.6f} vs "
          f"{loss_p.item():.6f} (rel {loss_rel:.2e}, bound "
          f"{TRAIN_LOSS_REL:.0e}); {len(grad_rel)} gradients, worst "
          f"max|diff|/max|grad| {grad_rel[worst]:.2e} ({worst}; bound "
          f"{TRAIN_GRAD_REL:.0e})")
    check(math.isfinite(loss_k.item()) and loss_rel <= TRAIN_LOSS_REL,
          f"train loss disagrees: {loss_k.item()} vs {loss_p.item()}")
    check(all(math.isfinite(v) and v <= TRAIN_GRAD_REL
              for v in grad_rel.values()), f"gradients disagree: {grad_rel}")

    # one full train step at B=64 x 5 s, both dtypes
    arrays64 = flagship_batch(dev, vocab=alphabet.size)
    steps_ms = {}
    for dtype in ("float32", "bfloat16"):
        p_d, c_d = load_model(model_dir, alphabet, device=dev, dtype=dtype)
        opt = AdamW(c_d, p_d)
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def step():
            _, grads = loss_and_grads(p_d, arrays64, c_d, gen)
            opt.update(p_d, grads)

        ms = time_ms(step, 5)
        steps_ms[dtype] = ms
        fused = next(c for c in bi["cases"] if c["dtype"] == dtype)
        f, b = per * fused["res_ms"], per * fused["bwd_ms"]
        print(f"[train] step B={B} x 5 s (T={T}, labels 60), {dtype}: "
              f"{ms:.2f} ms; at phase 3f's times the {per} {res} launches "
              f"{f:.2f} ms ({f / ms:.0%}) and the {per} {bwd} launches "
              f"{b:.2f} ms ({b / ms:.0%})")
    return counts, steps_ms


def phase_attention(dev, corpus, alphabet, d, family, flash_cases):
    """One attention family at its full default width, flash_attention in
    config.json: `--mode predict` through the CLI, greedy and beam, with
    the flash_attn launch counts; the same weights with flash_attention
    false (no launch); kernel vs plain log-probs on one batch; the forward
    at B=64 x 5 s with and without the kernel, float32 and bfloat16."""
    import dataclasses

    import torch

    from pg_asr_tpu_torch.checkpoint import save_model
    from pg_asr_tpu_torch.config import Config, ModelConfig
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.decoding import cuda_beam
    from pg_asr_tpu_torch.models import conformer_ctc, transformer_ctc
    from pg_asr_tpu_torch.ops import cuda_flash_attn, cuda_lstm
    from pg_asr_tpu_torch.predict import forward, load_model

    mod = conformer_ctc if family == "conformer" else transformer_ctc
    base = Config(model=ModelConfig(family=family, vocab_size=alphabet.size))
    sub = getattr(base, family)
    cfgs = {flash: base.replace(**{family: dataclasses.replace(
        sub, flash_attention=flash)}) for flash in (True, False)}
    params = mod.init_params(base.model, sub,
                             torch.Generator().manual_seed(SEED))
    dirs = {flash: os.path.join(d, f"{family}_{'flash' if flash else 'dense'}")
            for flash in (True, False)}
    for flash in (True, False):
        save_model(dirs[flash], params, cfgs[flash])
    n_params = sum(p.numel() for p in params.values())
    utts = load_manifest(os.path.join(corpus, "test.tsv"),
                         os.path.join(corpus, "clips"))
    per = sub.num_layers  # one attention per block
    print(f"[{family}] {sub.num_layers} blocks, d_model {sub.d_model}, "
          f"{sub.num_heads} heads, ffn {sub.ffn_dim}, vocab {alphabet.size}, "
          f"{n_params} params")

    counts = {}
    for name, flash, extra, bs in (("greedy", True, [], 32),
                                   ("beam", True, ["--decoder", "beam"],
                                    BEAM_B),
                                   ("greedy_dense", False, [], 32)):
        n_batches = -(-len(utts) // bs)
        reset_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                           "--model_path", dirs[flash], "--device", str(dev),
                           *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, beams = cuda_flash_attn.LAUNCHES, cuda_beam.LAUNCHES
        print(f"[{family}] predict {name} (flash_attention {flash}): rc={rc} "
              f"in {wall:.2f} s (host clock); {len(utts)} utterances in "
              f"{n_batches} batch(es) of <= {bs}; flash_attn launches "
              f"{launches}, ctc_beam launches {beams}")
        check(rc == 0 and "CER:" in out and "WER:" in out,
              f"{family} predict {name} failed")
        with open(os.path.join(dirs[flash], "predicted.txt")) as fo:
            rows = fo.read().splitlines()
        check(len(rows) == len(utts) and all("|" in r for r in rows),
              f"{family} {name}: predicted.txt has {len(rows)} rows")
        want = per * n_batches if flash else 0
        check(launches == want, f"{family} {name}: flash_attn launched "
              f"{launches} times, expected {want}")
        check(beams == (n_batches if extra else 0)
              and not any(lstm_counts().values()),
              f"{family} {name}: ctc_beam {beams}, LSTM {lstm_counts()} "
              "launches")
        counts[name] = launches

    # one batch: the forward with the kernel vs with the plain attention
    params_d, cfg_d = load_model(dirs[True], alphabet, device=dev)
    batch = next(iter(BatchIterator(utts, alphabet, 32, shuffle=False)))
    wave = torch.from_numpy(batch.wave).to(dev)
    ns = torch.from_numpy(batch.num_samples).to(dev)
    lp_k, mask_k, lens_k = forward(params_d, wave, ns, cfg_d)
    lp_p, _, _ = forward(params_d, wave, ns, cfg_d, use_kernel=False)
    torch.cuda.synchronize()
    T_b = batch.wave.shape[1] // cfg_d.features.hop_length + 1
    To = -(-T_b // sub.subsample)
    check(tuple(lp_k.shape) == (len(batch.texts), To, alphabet.size)
          and bool(torch.isfinite(lp_k).all()),
          f"{family} log-probs {tuple(lp_k.shape)}")
    check(int(lens_k.max()) <= To and bool((mask_k.sum(1) == lens_k).all()),
          f"{family} out_lens / out_mask disagree")
    err = (lp_k - lp_p).abs().max().item()
    print(f"[{family}] batch log-probs {tuple(lp_k.shape)}: kernel vs plain "
          f"attention max_abs_err {err:.3e} (bound {LOGPROB_BOUND:.0e})")
    check(err <= LOGPROB_BOUND, f"{family} log-probs disagree: {err}")

    # the forward (features + model) at B=64 x 5 s, dense and flash in
    # turns, then where its device time goes
    wave64, ns64 = flagship_batch(dev)[:2]
    fwd_ms, breakdown = {}, {}
    for dtype in ("float32", "bfloat16"):
        run = {}
        for flash in (True, False):
            p_d, c_d = load_model(dirs[flash], alphabet, device=dev,
                                  dtype=dtype)
            run[flash] = (lambda p_d=p_d, c_d=c_d:
                          forward(p_d, wave64, ns64, c_d))
        ms = dict(zip((True, False), in_turns(run[False], run[True], 10, 10)))
        for flash in (True, False):
            key = f"{dtype}_{'flash' if flash else 'dense'}"
            fwd_ms[key] = ms[flash]
            breakdown[key] = device_breakdown(run[flash])
            busy = sum(breakdown[key].values())
            print(f"[{family}] forward B={B} x 5 s (T={T}, T'={ATTN_T}), "
                  f"{dtype}, flash_attention {flash}: {ms[flash]:.2f} ms "
                  f"(in turns); device time per forward {busy:.2f} ms: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in
                              breakdown[key].items())
                  + f"; device idle {max(0.0, 1 - busy / ms[flash]):.0%}")
    return {"launches": counts, "logprob_max_abs_err": err,
            "forward_ms": fwd_ms, "device_ms": breakdown}


def flash_counts() -> dict:
    from pg_asr_tpu_torch.ops import cuda_flash_attn as c

    return {"flash_attn": c.LAUNCHES, "flash_attn_residual": c.RES_LAUNCHES,
            "flash_attn_bwd_dkv": c.DKV_LAUNCHES,
            "flash_attn_bwd_dq": c.DQ_LAUNCHES}


def reset_counts() -> None:
    from pg_asr_tpu_torch.decoding import cuda_beam
    from pg_asr_tpu_torch.ops import cuda_flash_attn as c
    from pg_asr_tpu_torch.ops import cuda_joint, cuda_lstm

    c.LAUNCHES = c.RES_LAUNCHES = c.DKV_LAUNCHES = c.DQ_LAUNCHES = 0
    cuda_lstm.LAUNCHES = cuda_lstm.RES_LAUNCHES = cuda_lstm.BWD_LAUNCHES = 0
    cuda_lstm.BI_LAUNCHES = cuda_lstm.BI_RES_LAUNCHES = 0
    cuda_lstm.BI_BWD_LAUNCHES = 0
    cuda_beam.LAUNCHES = 0
    cuda_joint.FWD_LAUNCHES = cuda_joint.BWD_LAUNCHES = 0


def phase_attention_train(dev, corpus, alphabet, d, family):
    """Training one attention family at its full default width with
    flash_attention through the CLI: launch counts, artifacts, a resume
    that omits --model and --flash_attention, predict on the trained model;
    kernel vs plain gradients; a --remat step; the train step at B=64 x 5 s
    in turns with flash_attention on and off, and its device breakdown."""
    import dataclasses

    import numpy as np
    import torch

    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.decoding import cuda_beam
    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.predict import load_model
    from pg_asr_tpu_torch.train import AdamW, batch_to_device, loss_and_grads

    bs = 32  # the CLI's default
    clips = os.path.join(corpus, "clips")
    train_utts = load_manifest(os.path.join(corpus, "train.tsv"), clips)
    n_dev = -(-len(load_manifest(os.path.join(corpus, "dev.tsv"), clips))
              // bs)
    n_test = len(load_manifest(os.path.join(corpus, "test.tsv"), clips))
    steps = -(-len(train_utts) // bs)
    model_dir = os.path.join(d, f"{family}_trained")
    argv = ["--mode", "train", "--corpus_path", corpus, "--model_path",
            model_dir, "--device", str(dev), "--seed", str(SEED)]
    per = 6  # attention blocks of the default width
    want = {"flash_attn": per * n_dev, "flash_attn_residual": per * steps,
            "flash_attn_bwd_dkv": per * steps,
            "flash_attn_bwd_dq": per * steps}

    def no_lstm_or_beam():
        return sum(lstm_counts().values()) + cuda_beam.LAUNCHES == 0

    counts = {}
    for epochs, extra in ((1, ["--model", family, "--flash_attention"]),
                          (2, [])):
        reset_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(argv + ["--num_epochs", str(epochs), *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = flash_counts()
        print(f"[{family} train] epoch {epochs}: rc={rc} in {wall:.2f} s "
              f"(host clock, includes WAV decode); {steps} steps of <= {bs} "
              f"+ {n_dev} dev batches; launches {got}")
        check(rc == 0, f"{family} train epoch {epochs} failed")
        check(got == want and no_lstm_or_beam(),
              f"{family} train epoch {epochs}: launches {got}, expected "
              f"{want} and no lstm or beam launch")
        counts[f"epoch{epochs}"] = got
    check("resumed from epoch 1" in out
          and f"resuming with model family '{family}'" in out,
          f"{family}: the second run did not resume the family")
    with open(os.path.join(model_dir, "config.json")) as fo:
        saved = json.load(fo)
    check(saved["model"]["family"] == family
          and saved[family]["flash_attention"] is True,
          f"{family}: the resume lost the family's config")
    for name in ("model_best.pt", "model_last.pt", "val_losses.npy"):
        check(os.path.exists(os.path.join(model_dir, name)), f"no {name}")
    tl = np.load(os.path.join(model_dir, "train_loss.npy"))
    vl = np.load(os.path.join(model_dir, "val_losses.npy"))
    check(tl.shape == vl.shape == (2,) and np.isfinite(tl).all()
          and np.isfinite(vl).all(), f"{family} losses {tl} {vl}")
    print(f"[{family} train] train losses {tl.tolist()}, val losses "
          f"{vl.tolist()}")

    for decoder, n_batches in (("greedy", -(-n_test // bs)),
                               ("beam", -(-n_test // BEAM_B))):
        reset_counts()
        rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                           "--model_path", model_dir, "--device", str(dev),
                           "--decoder", decoder])
        got = flash_counts()
        check(rc == 0 and "CER:" in out and "WER:" in out,
              f"{family} predict {decoder} on the trained model failed")
        check(got["flash_attn"] == per * n_batches
              and got["flash_attn_residual"] == got["flash_attn_bwd_dkv"]
              == got["flash_attn_bwd_dq"] == 0
              and cuda_beam.LAUNCHES == (n_batches if decoder == "beam"
                                         else 0),
              f"{family} predict {decoder}: launches {got}, ctc_beam "
              f"{cuda_beam.LAUNCHES}")
        counts[f"predict_{decoder}"] = got

    # one batch: loss and every parameter gradient, kernel vs plain path
    params, cfg = load_model(model_dir, alphabet, device=dev)
    sub = getattr(cfg, family)
    cfg0 = cfg.replace(**{family: dataclasses.replace(sub, dropout=0.0)})
    batch = next(iter(BatchIterator(train_utts, alphabet, bs,
                                    shuffle=False)))
    arrays = batch_to_device(batch, dev)
    loss_k, g_k = loss_and_grads(params, arrays, cfg0)
    loss_p, g_p = loss_and_grads(params, arrays, cfg0, use_kernel=False)
    torch.cuda.synchronize()
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_rel = {k: ((g_k[k] - g_p[k]).abs().max()
                    / g_p[k].abs().max()).item() for k in g_p}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"[{family} train] one batch {tuple(batch.wave.shape)}, kernel vs "
          f"plain path (float32, dropout 0): loss {loss_k.item():.6f} vs "
          f"{loss_p.item():.6f} (rel {loss_rel:.2e}, bound "
          f"{TRAIN_LOSS_REL:.0e}); {len(grad_rel)} gradients, worst "
          f"max|diff|/max|grad| {grad_rel[worst]:.2e} ({worst}; bound "
          f"{TRAIN_GRAD_REL:.0e})")
    check(math.isfinite(loss_k.item()) and loss_rel <= TRAIN_LOSS_REL,
          f"{family} train loss disagrees: {loss_k.item()} vs "
          f"{loss_p.item()}")
    check(all(math.isfinite(v) and v <= TRAIN_GRAD_REL
              for v in grad_rel.values()),
          f"{family} gradients disagree: {grad_rel}")

    # one --remat step at the trained config's dropout: the forward kernel
    # runs twice per block, and the gradients equal those without remat
    remat = {}
    for on in (False, True):
        c = cfg.replace(model=dataclasses.replace(cfg.model, remat=on))
        reset_counts()
        remat[on] = loss_and_grads(params, arrays, c, torch.Generator(
            device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        counts["remat_step" if on else "step"] = flash_counts()
    r_rel = max(((remat[True][1][k] - remat[False][1][k]).abs().max()
                 / remat[False][1][k].abs().max()).item() for k in g_p)
    print(f"[{family} train] --remat step (dropout {sub.dropout}): launches "
          f"{counts['remat_step']} (without: {counts['step']}); gradients vs "
          f"without remat: worst max|diff|/max|grad| {r_rel:.2e} (bound "
          f"{TRAIN_GRAD_REL:.0e})")
    check(counts["remat_step"] == {
        "flash_attn": 0, "flash_attn_residual": 2 * per,
        "flash_attn_bwd_dkv": per, "flash_attn_bwd_dq": per},
        f"{family} --remat step launches {counts['remat_step']}")
    check(r_rel <= TRAIN_GRAD_REL, f"{family} --remat gradients differ")

    # the train step at B=64 x 5 s, flash on and off in turns, both dtypes
    arrays64 = flagship_batch(dev, vocab=alphabet.size)
    step_ms, breakdown = {}, {}
    for dtype in ("float32", "bfloat16"):
        run = {}
        for flash in (True, False):
            p_d, c_d = load_model(model_dir, alphabet, device=dev,
                                  dtype=dtype)
            c_d = c_d.replace(**{family: dataclasses.replace(
                getattr(c_d, family), flash_attention=flash)})
            opt = AdamW(c_d, p_d)
            gen = torch.Generator(device=dev).manual_seed(SEED)

            def step(p_d=p_d, c_d=c_d, opt=opt, gen=gen):
                _, grads = loss_and_grads(p_d, arrays64, c_d, gen)
                opt.update(p_d, grads)

            run[flash] = step
        ms = dict(zip((True, False), in_turns(run[False], run[True], 5, 5)))
        for flash in (True, False):
            key = f"{dtype}_{'flash' if flash else 'dense'}"
            step_ms[key] = ms[flash]
            breakdown[key] = device_breakdown(run[flash])
            busy = sum(breakdown[key].values())
            print(f"[{family} train] step B={B} x 5 s (T={T}, T'={ATTN_T}, "
                  f"labels 60), {dtype}, flash_attention {flash}: "
                  f"{ms[flash]:.2f} ms (in turns); device time per step "
                  f"{busy:.2f} ms: " + ", ".join(
                      f"{k} {v:.2f}" for k, v in breakdown[key].items())
                  + f"; device idle {max(0.0, 1 - busy / ms[flash]):.0%}")
    return {"launches": counts, "loss_rel": loss_rel,
            "worst_grad_rel": grad_rel[worst], "remat_grad_rel": r_rel,
            "step_ms": step_ms, "device_ms": breakdown}


def joint_counts() -> dict:
    from pg_asr_tpu_torch.ops import cuda_joint as j

    return {"joint_fwd": j.FWD_LAUNCHES, "joint_bwd": j.BWD_LAUNCHES}


def load_trained(model_dir, dev, dtype=None, **changes):
    """A trained model's params (LayerNorm float32) and config, with the
    compute dtype and any config sections replaced by `changes`."""
    import dataclasses

    from pg_asr_tpu_torch.checkpoint import checkpoint_path, load_checkpoint
    from pg_asr_tpu_torch.config import Config
    from pg_asr_tpu_torch.models import cast_params
    from pg_asr_tpu_torch.models.bilstm_ctc import torch_dtype

    with open(os.path.join(model_dir, "config.json")) as fo:
        cfg = Config.from_json(fo.read())
    if dtype:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype=dtype))
    cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                         for k, v in changes.items()})
    state = load_checkpoint(checkpoint_path(model_dir, "last"))["params"]
    return cast_params(state, torch_dtype(cfg.model.dtype), dev), cfg


def phase_transducer_train(dev, corpus, alphabet, d, joint_cases):
    """Training the RNN-T transducer at full default width (conformer
    encoder, 6 blocks, d_model 256, flash_attention; prediction net
    128/256, joint 256): the CLI (unfused joint: no joint launch), then
    train(config=...) with fused_joint (one joint_fwd and one joint_bwd
    per step, one joint_fwd per dev batch), a CLI resume that keeps it;
    kernel vs plain gradients; one step with the BiLSTM
    and the transformer encoders; the train step at B=64 x 5 s fused and
    unfused, float32 and bfloat16, in turns, with a device breakdown and
    the lattice loss timed alone."""
    import numpy as np
    import torch

    from pg_asr_tpu_torch.config import (Config, ConformerConfig,
                                         ModelConfig, TrainConfig,
                                         TransducerConfig, TransformerConfig)
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.decoding import cuda_beam
    from pg_asr_tpu_torch.models import transducer
    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.ops.transducer import transducer_loss_mean
    from pg_asr_tpu_torch.train import (AdamW, batch_to_device,
                                        init_model_params, loss_and_grads,
                                        train)

    bs = 32  # the CLI's default
    clips = os.path.join(corpus, "clips")
    train_utts = load_manifest(os.path.join(corpus, "train.tsv"), clips)
    n_dev = -(-len(load_manifest(os.path.join(corpus, "dev.tsv"), clips))
              // bs)
    steps = -(-len(train_utts) // bs)
    per = 6  # conformer blocks of the default width
    flash_want = {"flash_attn": per * n_dev, "flash_attn_residual": per * steps,
                  "flash_attn_bwd_dkv": per * steps,
                  "flash_attn_bwd_dq": per * steps}

    def no_lstm_or_beam():
        return sum(lstm_counts().values()) + cuda_beam.LAUNCHES == 0

    def check_run(tag, model_dir, n_epochs, joint_want):
        got = {**flash_counts(), **joint_counts()}
        want = {**flash_want, **joint_want}
        check(got == want and no_lstm_or_beam(),
              f"transducer {tag}: launches {got}, expected {want} and no "
              "lstm or beam launch")
        for name in ("model_best.pt", "model_last.pt", "config.json"):
            check(os.path.exists(os.path.join(model_dir, name)),
                  f"transducer {tag}: no {name}")
        tl = np.load(os.path.join(model_dir, "train_loss.npy"))
        vl = np.load(os.path.join(model_dir, "val_losses.npy"))
        check(tl.shape == vl.shape == (n_epochs,) and np.isfinite(tl).all()
              and np.isfinite(vl).all(), f"transducer {tag}: losses {tl} {vl}")
        return got, tl.tolist(), vl.tolist()

    counts, losses = {}, {}
    # 1. the CLI: the default unfused joint
    cli_dir = os.path.join(d, "transducer_cli")
    reset_counts()
    t0 = time.perf_counter()
    rc, _ = run_cli(["--mode", "train", "--corpus_path", corpus,
                     "--model_path", cli_dir, "--device", str(dev), "--seed",
                     str(SEED), "--num_epochs", "1", "--model", "transducer",
                     "--flash_attention"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, "transducer CLI train failed")
    counts["cli_unfused"], tl, vl = check_run(
        "CLI epoch (unfused)", cli_dir, 1, {"joint_fwd": 0, "joint_bwd": 0})
    print(f"[transducer train] CLI epoch (fused_joint false): {wall:.2f} s "
          f"(host clock, includes WAV decode); {steps} steps of <= {bs} + "
          f"{n_dev} dev batches; launches {counts['cli_unfused']}; train "
          f"loss {tl}, val loss {vl}")

    # 2. train(config=...) with fused_joint, then 3. a CLI resume
    fused_dir = os.path.join(d, "transducer_fused")
    cfg = Config(model=ModelConfig(family="transducer",
                                   vocab_size=alphabet.size),
                 conformer=ConformerConfig(flash_attention=True),
                 transducer=TransducerConfig(fused_joint=True),
                 train=TrainConfig(num_epochs=1, seed=SEED))
    joint_want = {"joint_fwd": steps + n_dev, "joint_bwd": steps}
    reset_counts()
    t0 = time.perf_counter()
    train(corpus, fused_dir, config=cfg, device=str(dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["train_fused"], tl, vl = check_run("train(config=...) epoch",
                                              fused_dir, 1, joint_want)
    print(f"[transducer train] train(config=...) epoch, fused_joint true: "
          f"{wall:.2f} s; launches {counts['train_fused']}; train loss {tl}, "
          f"val loss {vl}")
    reset_counts()
    rc, out = run_cli(["--mode", "train", "--corpus_path", corpus,
                       "--model_path", fused_dir, "--device", str(dev),
                       "--num_epochs", "2"])
    check(rc == 0 and "resumed from epoch 1" in out
          and "resuming with model family 'transducer'" in out,
          "transducer: the CLI resume failed")
    counts["resume_fused"], tl, vl = check_run("resumed epoch", fused_dir,
                                               2, joint_want)
    with open(os.path.join(fused_dir, "config.json")) as fo:
        saved = json.load(fo)
    check(saved["transducer"]["fused_joint"] is True
          and saved["conformer"]["flash_attention"] is True,
          "transducer: the resume lost fused_joint or flash_attention")
    losses.update(train_losses=tl, val_losses=vl)
    print(f"[transducer train] resumed epoch 2 (CLI, no --model): launches "
          f"{counts['resume_fused']}; train losses {tl}, val losses {vl}")

    # 5. one batch: loss and every parameter gradient, kernel vs plain path
    params, cfg0 = load_trained(fused_dir, dev, model={"dropout": 0.0},
                                conformer={"dropout": 0.0})
    batch = next(iter(BatchIterator(train_utts, alphabet, bs,
                                    shuffle=False)))
    arrays = batch_to_device(batch, dev)
    reset_counts()
    loss_k, g_k = loss_and_grads(params, arrays, cfg0)
    torch.cuda.synchronize()
    counts["step"] = {**flash_counts(), **joint_counts()}
    loss_p, g_p = loss_and_grads(params, arrays, cfg0, use_kernel=False)
    torch.cuda.synchronize()
    check(counts["step"] == {**{k: per for k in flash_want}, "flash_attn": 0,
                             "joint_fwd": 1, "joint_bwd": 1},
          f"transducer step launches {counts['step']}")
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_rel = {k: ((g_k[k] - g_p[k]).abs().max()
                    / g_p[k].abs().max()).item() for k in g_p}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"[transducer train] one batch {tuple(batch.wave.shape)}, kernel "
          f"vs plain path (float32, dropout 0): loss {loss_k.item():.6f} vs "
          f"{loss_p.item():.6f} (rel {loss_rel:.2e}, bound "
          f"{TRAIN_LOSS_REL:.0e}); {len(grad_rel)} gradients, worst "
          f"max|diff|/max|grad| {grad_rel[worst]:.2e} ({worst}; bound "
          f"{TRAIN_GRAD_REL:.0e})")
    check(math.isfinite(loss_k.item()) and loss_rel <= TRAIN_LOSS_REL,
          f"transducer loss disagrees: {loss_k.item()} vs {loss_p.item()}")
    check(all(math.isfinite(v) and v <= TRAIN_GRAD_REL
              for v in grad_rel.values()),
          f"transducer gradients disagree: {grad_rel}")

    # 6. one kernel-path step with the BiLSTM and the transformer encoders
    _, res, bwd, per = route_counters()
    want_by_enc = {
        "bilstm": {res: per, bwd: per},
        "transformer": {"flash_attn_residual": 6, "flash_attn_bwd_dkv": 6,
                        "flash_attn_bwd_dq": 6}}
    for enc, want in want_by_enc.items():
        c = Config(model=ModelConfig(family="transducer",
                                     vocab_size=alphabet.size),
                   transformer=TransformerConfig(flash_attention=True),
                   transducer=TransducerConfig(encoder=enc,
                                               fused_joint=True))
        p = init_model_params(c, torch.Generator().manual_seed(SEED), dev)
        reset_counts()
        loss, g = loss_and_grads(p, arrays, c, torch.Generator(
            device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        got = {**{k: v for k, v in flash_counts().items() if v},
               **{k: v for k, v in lstm_counts().items() if v},
               **joint_counts()}
        counts[f"step_{enc}"] = got
        print(f"[transducer train] one step, {enc} encoder (default width, "
              f"dropout on): loss {loss.item():.4f}, launches {got}")
        check(math.isfinite(loss.item()) and all(
            bool(torch.isfinite(v).all()) for v in g.values()),
            f"transducer {enc}: non-finite loss or gradient")
        check(got == {**want, "joint_fwd": 1, "joint_bwd": 1},
              f"transducer {enc} step launches {got}")

    # 7. the train step at B=64 x 5 s, fused and unfused in turns
    arrays64 = flagship_batch(dev, vocab=alphabet.size)
    step_ms, breakdown = {}, {}
    for dtype in ("float32", "bfloat16"):
        run = {}
        for fused in (True, False):
            p_d, c_d = load_trained(fused_dir, dev, dtype,
                                    transducer={"fused_joint": fused})
            opt = AdamW(c_d, p_d)
            gen = torch.Generator(device=dev).manual_seed(SEED)

            def step(p_d=p_d, c_d=c_d, opt=opt, gen=gen):
                _, grads = loss_and_grads(p_d, arrays64, c_d, gen)
                opt.update(p_d, grads)

            run[fused] = step
        torch.cuda.reset_peak_memory_stats()
        ms = dict(zip((True, False), in_turns(run[False], run[True], 3, 3)))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for fused in (True, False):
            key = f"{dtype}_{'fused' if fused else 'unfused'}"
            step_ms[key] = ms[fused]
            breakdown[key] = device_breakdown(run[fused])
            busy = sum(breakdown[key].values())
            kern = ""
            if fused:
                jk = next(c for c in joint_cases if c["dtype"] == dtype)
                jms = jk["fwd_ms"] + jk["bwd_ms"]
                kern = (f"; joint_fwd + joint_bwd at phase 3e's times "
                        f"{jms:.2f} ms ({jms / ms[fused]:.0%})")
            print(f"[transducer train] step B={B} x 5 s (T'={ATTN_T}, "
                  f"labels 60), {dtype}, fused_joint {fused}: "
                  f"{ms[fused]:.2f} ms (in turns); device time per step "
                  f"{busy:.2f} ms: " + ", ".join(
                      f"{k} {v:.2f}" for k, v in breakdown[key].items())
                  + f"; device idle {max(0.0, 1 - busy / ms[fused]):.0%}"
                  + kern)
        print(f"[transducer train] {dtype}: peak device memory over both "
              f"steps {peak_gb:.2f} GB")

    # the lattice loss alone, forward + backward, on the step's tables
    p_d, c_d = load_trained(fused_dir, dev, "float32")
    with torch.no_grad():
        from pg_asr_tpu_torch.ops.features import extract_features

        feats, mask, flens = extract_features(*arrays64[:2], c_d.features)
        out = transducer.apply_lattice(p_d, feats, mask, flens,
                                       *arrays64[2:], c_d)
    lb, ly = (t.detach().requires_grad_(True) for t in out[:2])

    def lattice_loss():
        loss = transducer_loss_mean(lb, ly, out[2], arrays64[3])
        torch.autograd.grad(loss, (lb, ly))

    loss_ms = time_ms(lattice_loss, 5)
    loss_dev = sum(device_breakdown(lattice_loss).values())
    print(f"[transducer train] lattice loss alone (T'+U = {ATTN_T + 60} "
          f"diagonals), forward + backward: {loss_ms:.2f} ms, device time "
          f"{loss_dev:.2f} ms")
    return {"launches": counts, "losses": losses, "loss_rel": loss_rel,
            "worst_grad_rel": grad_rel[worst], "step_ms": step_ms,
            "device_ms": breakdown, "lattice_loss_ms": loss_ms,
            "lattice_loss_device_ms": loss_dev}


def phase_transducer_predict(dev, corpus, alphabet, model_dir):
    """Transcription with the transducer phase 8 trained (conformer encoder,
    flash_attention): `--mode predict` through the CLI, greedy (batch 32)
    and beam (batch 128, K=16), with 6 flash_attn launches per batch and no
    other kernel; one batch's labels on the kernel path against the plain
    path; the encoder and each decoder timed apart at B=64 x 5 s (greedy)
    and B=128 x 5 s (beam), host clock and device time."""
    import re

    import torch

    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.decoding import cuda_beam
    from pg_asr_tpu_torch.decoding.transducer import (
        transducer_beam_decode, transducer_greedy_decode)
    from pg_asr_tpu_torch.models import transducer
    from pg_asr_tpu_torch.ops.features import extract_features

    utts = load_manifest(os.path.join(corpus, "test.tsv"),
                         os.path.join(corpus, "clips"))
    per, K = 6, 16  # conformer blocks of the default width; the beam width

    def others_zero():
        return (sum(lstm_counts().values()) + cuda_beam.LAUNCHES
                + sum(joint_counts().values())) == 0

    counts, stats = {}, {}
    for decoder, bs in (("greedy", 32), ("beam", 128)):
        extra = ["--decoder", "beam"] if decoder == "beam" else []
        n_batches = -(-len(utts) // bs)
        path = os.path.join(model_dir, "predicted.txt")
        if os.path.exists(path):
            os.remove(path)
        reset_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                           "--model_path", model_dir, "--device", str(dev),
                           *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[decoder] = flash_counts()["flash_attn"]
        m = re.search(r"CER: (\S+) WER: (\S+)", out)
        check(rc == 0 and m is not None, f"transducer predict {decoder} failed")
        cer, wer = float(m.group(1)), float(m.group(2))
        with open(path) as fo:
            lines = fo.read().splitlines()
        check(len(lines) == len(utts) and all("|" in ln for ln in lines)
              and math.isfinite(cer) and math.isfinite(wer),
              f"transducer predict {decoder}: {len(lines)} lines, CER {cer}, "
              f"WER {wer}")
        check(counts[decoder] == per * n_batches and others_zero()
              and flash_counts()["flash_attn_residual"] == 0,
              f"transducer predict {decoder}: flash_attn launches "
              f"{counts[decoder]}, expected {per * n_batches} and no other "
              "kernel")
        stats[decoder] = {"cer": cer, "wer": wer, "wall_s": wall,
                          "batches": n_batches}
        print(f"[transducer predict] CLI --decoder {decoder}: {wall:.2f} s "
              f"(host clock, includes WAV decode), {len(utts)} utterances in "
              f"{n_batches} batches of <= {bs}; {counts[decoder]} flash_attn "
              f"launches; CER {cer:.4f} WER {wer:.4f}")

    # one batch: the kernel path against the plain path (use_kernel=False)
    params, cfg = load_trained(model_dir, dev)
    L = cfg.decode.max_label_len
    batch = next(iter(BatchIterator(utts, alphabet, 32, shuffle=False)))
    wave = torch.from_numpy(batch.wave).to(dev)
    ns = torch.from_numpy(batch.num_samples).to(dev)
    res = {}
    with torch.inference_mode():
        feats, mask, flens = extract_features(wave, ns, cfg.features)
        for use_kernel in (True, False):
            reset_counts()
            enc, _, olens = transducer.encode(params, feats, mask, flens, cfg,
                                              use_kernel=use_kernel)
            res[use_kernel] = (
                enc, transducer_greedy_decode(params, enc, olens, cfg,
                                              max_label_len=L),
                transducer_beam_decode(params, enc, olens, cfg, beam_size=K,
                                       max_label_len=L),
                flash_counts()["flash_attn"])
    torch.cuda.synchronize()
    (enc_k, g_k, b_k, n_k), (enc_p, g_p, b_p, n_p) = res[True], res[False]
    enc_err = _errs(enc_k, enc_p)[0]
    nll_rel = ((b_k[2] - b_p[2]).abs() / b_p[2].abs()).max().item()
    print(f"[transducer predict] one batch of {wave.shape[0]}, kernel vs "
          f"plain path (float32): encoder states max abs diff {enc_err:.2e}; "
          f"greedy labels equal {torch.equal(g_k[0], g_p[0])}, beam labels "
          f"equal {torch.equal(b_k[0], b_p[0])}, beam nll rel diff "
          f"{nll_rel:.2e} (bound {TRANSDUCER_NLL_REL:.0e}); flash_attn "
          f"launches {n_k} / {n_p}")
    check(n_k == per and n_p == 0, f"flash_attn launches {n_k} / {n_p}")
    check(all(torch.equal(a, b) for a, b in zip(g_k, g_p))
          and torch.equal(b_k[0], b_p[0]) and torch.equal(b_k[1], b_p[1])
          and nll_rel <= TRANSDUCER_NLL_REL,
          "transducer decode: kernel path and plain path disagree")

    # the encoder and each decoder apart: CUDA events for the encoder, host
    # clock around a synchronised decode, device time from a profiler trace
    timing = {}
    for decoder, nb in (("greedy", B), ("beam", BEAM_B)):
        wave, ns = flagship_batch(dev, vocab=alphabet.size, batch=nb)[:2]
        with torch.inference_mode():
            feats, mask, flens = extract_features(wave, ns, cfg.features)

            def encode():
                with torch.inference_mode():
                    return transducer.encode(params, feats, mask, flens, cfg)

            enc, _, olens = encode()

            def decode():
                with torch.inference_mode():
                    if decoder == "beam":
                        return transducer_beam_decode(
                            params, enc, olens, cfg, beam_size=K,
                            max_label_len=L)[:2]
                    return transducer_greedy_decode(params, enc, olens, cfg,
                                                    max_label_len=L)

            enc_ms = time_ms(encode, 3)
            decode()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels, lens = decode()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            dev_ms = sum(device_breakdown(decode, reps=1).values())
        check(bool((lens >= 0).all()) and labels.shape == (nb, L),
              f"transducer {decoder} decode output")
        timing[decoder] = {"batch": nb, "encoder_ms": enc_ms,
                           "decode_host_ms": host_ms,
                           "decode_device_ms": dev_ms,
                           "mean_labels": lens.float().mean().item()}
        print(f"[transducer predict] {decoder} at B={nb} x 5 s (T'="
              f"{ATTN_T}, K={K if decoder == 'beam' else 1}, float32): "
              f"encoder {enc_ms:.2f} ms (CUDA events); decode {host_ms:.2f} "
              f"ms host clock, {dev_ms:.2f} ms device time "
              f"({1 - dev_ms / host_ms:.0%} idle); "
              f"{timing[decoder]['mean_labels']:.1f} labels per utterance")
    return {"launches": counts, "stats": stats, "enc_max_abs_diff": enc_err,
            "beam_nll_rel": nll_rel, "timing": timing}


def all_counts() -> dict:
    """Every launch counter of the port, by kernel row name."""
    from pg_asr_tpu_torch.decoding import cuda_beam

    return {**lstm_counts(), **flash_counts(), **joint_counts(),
            "ctc_beam": cuda_beam.LAUNCHES}


@contextlib.contextmanager
def fixed_draws(paths, nbest):
    """rl/reinforce.py's loss takes these sampled paths and this n-best in
    place of its sampler's and its beam's (both restored after), so that
    the kernel path and the plain path score the same hypotheses."""
    from pg_asr_tpu_torch.rl import reinforce as rl

    saved = rl._sample_paths, rl.beam_decode_nbest
    rl._sample_paths = lambda generator, lp, S, temperature: paths
    rl.beam_decode_nbest = lambda *args, **kwargs: nbest
    try:
        yield
    finally:
        rl._sample_paths, rl.beam_decode_nbest = saved


def phase_pg(dev, corpus, alphabet, d, bi, beam_cases, train_steps_ms):
    """10. Policy-gradient fine-tuning (`--mode finetune_pg`) of the
    BiLSTM-CTC phase 5 trained and of the transducer phase 8 trained, through
    the CLI: launch counts per step and per dev batch, the artifacts, a
    resumed run, predict on the result; kernel vs plain path on one batch;
    the PG step at B=64 x 5 s timed with its breakdown."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from pg_asr_tpu_torch.checkpoint import load_checkpoint
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.decoding.beam import beam_decode_nbest
    from pg_asr_tpu_torch.decoding.greedy import greedy_decode
    from pg_asr_tpu_torch.ops.edit_distance import cer_from_ids
    from pg_asr_tpu_torch.predict import forward, load_model
    from pg_asr_tpu_torch.rl import reinforce as rl
    from pg_asr_tpu_torch.rl.reward import sequence_reward
    from pg_asr_tpu_torch.train import (AdamW, batch_to_device,
                                        value_and_grad)

    bs = 32  # the CLI's default
    clips = os.path.join(corpus, "clips")
    n_dev = -(-len(load_manifest(os.path.join(corpus, "dev.tsv"), clips))
              // bs)
    n_test = -(-len(load_manifest(os.path.join(corpus, "test.tsv"), clips))
               // bs)
    inf, res, bwd, per = route_counters()
    src = os.path.join(d, "trained")  # phase 5's BiLSTM-CTC
    space = alphabet.char2ind.get(" ", -1)
    out_counts = {}

    def run_pg(model_dir, steps, every, *extra):
        reset_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(["--mode", "finetune_pg", "--corpus_path", corpus,
                           "--model_path", model_dir, "--device", str(dev),
                           "--pg_steps", str(steps), "--pg_eval_every",
                           str(every), *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"finetune_pg {extra} failed")
        return out, wall, all_counts()

    def want(steps, evals, beams=0):
        w = dict.fromkeys(all_counts(), 0)
        w.update({res: per * steps, bwd: per * steps,
                  inf: per * n_dev * evals, "ctc_beam": beams})
        return w

    def rewards_of(model_dir, n):
        r = np.load(os.path.join(model_dir, "pg_rewards.npy"))
        check(r.shape == (n,) and np.isfinite(r).all(),
              f"pg_rewards.npy: {r}")
        return r

    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}

    # 1. REINFORCE through the CLI, 20 steps and dev CER every 10, resumed
    model = os.path.join(d, "pg_reinforce")
    shutil.copytree(src, model)
    out, wall, counts = run_pg(model, 20, 10)
    print(f"[pg] REINFORCE: 20 steps of {bs} + 2 x {n_dev} dev batches in "
          f"{wall:.2f} s (host clock, includes WAV decode); launches "
          f"{nonzero(counts)}")
    check(counts == want(20, 2),
          f"REINFORCE launches {counts}, expected {per} {res} and {per} "
          f"{bwd} a step, {per} {inf} a dev batch")
    out_counts["finetune_pg_reinforce"] = counts
    r = rewards_of(model, 20)
    cer = np.load(os.path.join(model, "pg_dev_cer.npy"))
    check(cer.shape == (2, 2) and cer[:, 0].tolist() == [10, 20]
          and np.isfinite(cer).all(), f"pg_dev_cer.npy: {cer}")
    last = load_checkpoint(os.path.join(model, "model_last.pt"))
    check(last["epoch"] == -1 and last["step"] == 20,
          f"model_last: epoch {last['epoch']}, step {last['step']}")
    print(f"[pg] rewards {r[0]:.4f} .. {r[-1]:.4f}, dev CER "
          f"{cer[:, 1].tolist()}")
    out, wall, counts = run_pg(model, 30, 10)
    check("[pg] resumed from model_last at step 20" in out
          and "[pg] 30 steps" in out, "REINFORCE: the resume failed")
    check(counts == want(10, 1), f"resumed run's launches {counts}")
    rewards_of(model, 10)
    check(load_checkpoint(os.path.join(model, "model_last.pt"))["step"]
          == 30, "the resumed run did not end at step 30")
    print(f"[pg] resumed at step 20, ended at 30 in {wall:.2f} s; launches "
          f"{nonzero(counts)}")
    reset_counts()
    rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                       "--model_path", model, "--device", str(dev)])
    got = lstm_counts()
    check(rc == 0 and "CER:" in out and got == {
        **dict.fromkeys(got, 0), inf: per * n_test},
        f"predict on the fine-tuned model: rc {rc}, launches {got}")

    # 2. MWER through the CLI (K=4): one ctc_beam launch a step
    model = os.path.join(d, "pg_mwer")
    shutil.copytree(src, model)
    out, wall, counts = run_pg(model, 4, 4, "--pg_objective", "mwer",
                               "--mwer_beam", "4")
    print(f"[pg] MWER (K=4): 4 steps + {n_dev} dev batches in {wall:.2f} s; "
          f"launches {nonzero(counts)}")
    check(counts == want(4, 1, beams=4), f"MWER launches {counts}")
    out_counts["finetune_pg_mwer"] = counts
    rewards_of(model, 4)

    # 3. one batch, kernel path vs plain path: the same paths and n-best
    params, cfg = load_model(src, alphabet, device=dev)
    utts = load_manifest(os.path.join(corpus, "train.tsv"), clips)
    batch = next(iter(BatchIterator(utts, alphabet, bs, shuffle=False)))
    arrays = batch_to_device(batch, dev)
    lp, _, fl = forward(params, arrays[0], arrays[1], cfg)
    L = arrays[2].shape[1]
    paths = rl._sample_paths(torch.Generator(device=dev).manual_seed(SEED),
                             lp, cfg.rl.num_samples, cfg.rl.temperature)
    nbest = beam_decode_nbest(lp, fl, beam_size=4, max_label_len=L)
    plain = beam_decode_nbest(lp, fl, beam_size=4, max_label_len=L,
                              use_kernel=False)
    check(torch.equal(nbest[0], plain[0]) and torch.equal(nbest[1], plain[1]),
          "the n-best of ctc_beam differs from the plain scan's")
    nll_rel = ((nbest[2] - plain[2]).abs() / plain[2].abs().clamp(min=1))
    nll_rel = nll_rel[plain[2] < 1e29].max().item()
    check(nll_rel <= BEAM_NLL_REL, f"n-best nll rel error {nll_rel}")
    compare = {"nbest_nll_rel": nll_rel}
    for objective in ("reinforce", "mwer"):
        c = cfg.replace(rl=dataclasses.replace(
            cfg.rl, objective=objective, baseline="mean", mwer_beam=4,
            space_id=space))
        got = {}
        with fixed_draws(paths, nbest):
            for use_kernel in (True, False):
                (loss, _), grads = value_and_grad(
                    lambda p: rl.pg_loss_fn(p, *arrays, None, c, use_kernel),
                    params)
                got[use_kernel] = loss.item(), grads
        (loss_k, g_k), (loss_p, g_p) = got[True], got[False]
        loss_rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-6)
        grad_rel = {k: ((g_k[k] - g_p[k]).abs().max()
                        / g_p[k].abs().max().clamp(min=1e-30)).item()
                    for k in g_p}
        worst = max(grad_rel, key=grad_rel.get)
        print(f"[pg] {objective}, one batch {tuple(batch.wave.shape)}, "
              f"kernel vs plain path (float32, same paths / n-best): loss "
              f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}, bound "
              f"{PG_LOSS_REL:.0e}); {len(grad_rel)} gradients, worst "
              f"max|diff|/max|grad| {grad_rel[worst]:.2e} ({worst}; bound "
              f"{PG_GRAD_REL:.0e})")
        check(math.isfinite(loss_k) and loss_rel <= PG_LOSS_REL,
              f"{objective}: PG loss disagrees: {loss_k} vs {loss_p}")
        check(all(math.isfinite(v) and v <= PG_GRAD_REL
                  for v in grad_rel.values()),
              f"{objective}: gradients disagree: {grad_rel}")
        compare[objective] = {"loss_rel": loss_rel,
                              "grad_rel_worst": grad_rel[worst]}

    # 4. the PG step at B=64 x 5 s, both objectives, float32 and bfloat16
    wave64, ns64, labels64, lens64 = arrays64 = flagship_batch(
        dev, vocab=alphabet.size)
    timing = {}
    for dtype in ("float32", "bfloat16"):
        fused = next(c for c in bi["cases"] if c["dtype"] == dtype)
        for objective in ("reinforce", "mwer"):
            p_d, c_d = load_model(src, alphabet, device=dev, dtype=dtype)
            c_d = c_d.replace(rl=dataclasses.replace(
                c_d.rl, objective=objective, space_id=space))
            opt = AdamW(c_d, p_d, learning_rate=c_d.train.learning_rate * 0.1,
                        weight_decay=1e-4)
            step = rl.make_pg_step(c_d, opt)
            gen = torch.Generator(device=dev).manual_seed(SEED)

            def run():
                return step(p_d, gen, *arrays64)

            reset_counts()
            run()
            torch.cuda.synchronize()
            counts = all_counts()
            check(counts == want(1, 0, beams=int(objective == "mwer")),
                  f"PG step launches {counts}")
            ms = time_ms(run, 5)
            groups = device_breakdown(run, 3, PG_GROUPS, pg_group)
            dev_ms = sum(groups.values())
            kern = per * (fused["res_ms"] + fused["bwd_ms"])
            timing[f"{objective}_{dtype}"] = {
                "ms": ms, "device_ms": dev_ms, "idle": 1 - dev_ms / ms,
                "groups": groups, "lstm_at_phase_3f_ms": kern}
            print(f"[pg] {objective} step B={B} x 5 s (T={T}, labels 60), "
                  f"{dtype}: {ms:.2f} ms (supervised step, phase 5: "
                  f"{train_steps_ms[dtype]:.2f}); at phase 3f's times the "
                  f"{per} {res} + {per} {bwd} launches {kern:.2f} ms; device "
                  f"{dev_ms:.2f} ms ({1 - dev_ms / ms:.0%} idle): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in groups.items()))

    # the reward DP and the n-best alone, on the float32 model's log-probs
    p32, c32 = load_model(src, alphabet, device=dev)
    lp64, mask64, fl64 = forward(p32, wave64, ns64, c32)
    S, K = c32.rl.num_samples, 4
    paths64 = rl._sample_paths(torch.Generator(device=dev).manual_seed(SEED),
                               lp64, S, c32.rl.temperature)

    def reinforce_rewards():
        R, _, _ = rl._path_rewards(paths64, mask64, labels64, lens64,
                                   "neg_cer")
        ids, n = greedy_decode(lp64, mask64)
        return R, sequence_reward(labels64, lens64, ids, n)

    hyp = beam_decode_nbest(lp64, fl64, beam_size=K, max_label_len=60)

    def mwer_risk():
        return cer_from_ids(labels64.repeat_interleave(K, 0),
                            lens64.repeat_interleave(K),
                            hyp[0].flatten(0, 1), hyp[1].flatten())

    dp = {"reinforce_rewards": {"host_ms": host_ms(reinforce_rewards, 5),
                                "device_ops": device_ops(reinforce_rewards)},
          "mwer_risk": {"host_ms": host_ms(mwer_risk, 5),
                        "device_ops": device_ops(mwer_risk)},
          "nbest_ms": time_ms(lambda: beam_decode_nbest(
              lp64, fl64, beam_size=K, max_label_len=60), 5)}
    print(f"[pg] B={B} x 5 s, float32: REINFORCE rewards (S={S} paths of "
          f"{T} frames against 60 labels, + the greedy baseline) "
          f"{dp['reinforce_rewards']['host_ms']:.2f} ms host, "
          f"{dp['reinforce_rewards']['device_ops']} device ops; MWER risk "
          f"(B x K = {B * K} rows) {dp['mwer_risk']['host_ms']:.2f} ms, "
          f"{dp['mwer_risk']['device_ops']} device ops; the n-best (one "
          f"ctc_beam launch, K={K}, exact) {dp['nbest_ms']:.3f} ms "
          f"(phase 3b, K=16 at B=128: {beam_cases[0]['ms']:.3f} ms at M=6)")

    # 5. the transducer phase 8 trained (fused_joint, conformer encoder with
    # flash attention): MWER through the CLI
    tdir = os.path.join(d, "pg_transducer")
    shutil.copytree(os.path.join(d, "transducer_fused"), tdir)
    out, wall, counts = run_pg(tdir, 2, 0, "--mwer_beam", "4")
    blocks = 6  # conformer blocks of the default width
    tr_want = {**dict.fromkeys(counts, 0), "joint_fwd": 4, "joint_bwd": 4,
               "flash_attn_residual": 2 * blocks,
               "flash_attn_bwd_dkv": 2 * blocks,
               "flash_attn_bwd_dq": 2 * blocks}
    print(f"[pg] transducer MWER (K=4, fused joint): 2 steps of {bs} in "
          f"{wall:.2f} s; launches {nonzero(counts)}")
    check("[pg] transducer family: using the MWER objective" in out,
          "the transducer did not switch to MWER")
    check(counts == tr_want, f"transducer PG launches {counts}, expected "
          "a joint_fwd and a joint_bwd for the n-best and for the anchor "
          "each step")
    out_counts["finetune_pg_transducer"] = counts
    rewards_of(tdir, 2)
    return {"launches": out_counts, "compare": compare, "timing": timing,
            "reward_dp": dp}


# phase 11: the supervised training recipe through the CLI
RECIPE = ["--specaugment", "--speed_perturb", "0.9,1.1", "--wave_noise",
          "0.1", "--wave_gain_db", "3", "--accum_steps", "2", "--ema_decay",
          "0.999", "--keep_ckpts", "2", "--save_every_steps", "5",
          "--val_metric", "cer", "--loader_threads", "2", "--cache_audio_mb",
          "64", "--profile_steps", "2", "--num_epochs", "3"]
# an interrupted-and-resumed run vs an uninterrupted one on the card: the
# batches, the steps and every draw are the same (the step generator's
# state is in the checkpoint), and only F.ctc_loss's CUDA backward (atomic
# adds) sums in another order, so the epochs after the resume may differ by
# float32 rounding carried through a few dozen AdamW steps at a warmup rate
RESUME_LOSS_REL = 5e-3


@contextlib.contextmanager
def recorded_batches():
    """Every batch the trainer moves to the device (train and dev), as
    (texts, total samples), in order."""
    from pg_asr_tpu_torch import train as train_mod

    seen, inner = [], train_mod.batch_to_device

    def record(batch, dev):
        seen.append([list(batch.texts), int(batch.num_samples.sum())])
        return inner(batch, dev)

    train_mod.batch_to_device = record
    try:
        yield seen
    finally:
        train_mod.batch_to_device = inner


def recipe_worker(record_path: str, argv: list[str]) -> int:
    """`python3 chip_smoke.py --recipe-worker OUT ARGV...`: cli.main(ARGV),
    then the batches it trained on into OUT (phase 11's interrupted run)."""
    from pg_asr_tpu_torch import cli

    with recorded_batches() as seen:
        rc = cli.main(argv)
    with open(record_path, "w") as fo:
        json.dump(seen, fo)
    return rc


def phase_recipe(dev, corpus, alphabet, d, bi, train_steps_ms):
    """11. The supervised training recipe (every option of `--mode train`
    on one device) on the full-width BiLSTM-CTC: the CLI run with its
    launches and artifacts, a SIGTERM mid-epoch in a subprocess and the
    resumed run against the uninterrupted one, `--ckpt avg` predict, one
    emit of two micro-batches kernel vs plain path, the options' timings,
    and the convergence recipe of examples/pg_improves_cer.py."""
    import signal

    import numpy as np
    import torch

    from pg_asr_tpu_torch.checkpoint import load_checkpoint
    from pg_asr_tpu_torch.data import load_manifest

    bs = 32
    clips = os.path.join(corpus, "clips")
    steps = -(-len(load_manifest(os.path.join(corpus, "train.tsv"), clips))
              // bs)
    n_dev = -(-len(load_manifest(os.path.join(corpus, "dev.tsv"), clips))
              // bs)
    n_test = len(load_manifest(os.path.join(corpus, "test.tsv"), clips))
    epochs = 3
    inf, res, bwd, per = route_counters()
    out_counts, result = {}, {}

    def argv_for(model):
        return ["--mode", "train", "--corpus_path", corpus, "--model_path",
                model, "--device", str(dev), "--seed", str(SEED), *RECIPE]

    # 1. the recipe through the CLI: per micro-batch 3 residual bilstm_fwd
    # + 3 bilstm_bwd; per dev batch 3 bilstm_fwd for the loss and 3 for the
    # greedy CER (--val_metric cer), on the EMA weights
    model = os.path.join(d, "recipe")
    reset_counts()
    t0 = time.perf_counter()
    with recorded_batches() as full_seen:
        rc, out = run_cli(argv_for(model))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = all_counts()
    want = {**dict.fromkeys(counts, 0), res: per * steps * epochs,
            bwd: per * steps * epochs, inf: 2 * per * n_dev * epochs}
    print(f"[recipe] rc={rc}: {epochs} epochs of {steps} micro-batches of "
          f"{bs} (accumulation 2) + {n_dev} dev batches (loss and CER) in "
          f"{wall:.2f} s; launches { {k: v for k, v in counts.items() if v} }")
    check(rc == 0, "the recipe's train run failed")
    check(counts == want, f"recipe launches {counts}, expected {want}")
    out_counts["recipe_train"] = counts
    tl = np.load(os.path.join(model, "train_loss.npy"))
    vl = np.load(os.path.join(model, "val_losses.npy"))
    check(tl.shape == vl.shape == (epochs,) and np.isfinite(tl).all()
          and np.isfinite(vl).all(), f"losses {tl} {vl}")
    check(out.count("val_cer=") == epochs, "no dev CER per epoch")
    for name in ("model_best.pt", "model_last.pt"):
        state = load_checkpoint(os.path.join(model, name))
        check(set(state.get("ema_params", {})) == set(state["params"]),
              f"{name} holds no ema_params")
    last = load_checkpoint(os.path.join(model, "model_last.pt"))
    check(last["step"] == steps * epochs
          and last["opt_state"]["count"] == steps * epochs // 2,
          f"model_last step {last['step']}, count "
          f"{last['opt_state']['count']}")
    snaps = sorted(n for n in os.listdir(model) if n.startswith("model_epoch"))
    check(snaps == ["model_epoch0002.pt", "model_epoch0003.pt"],
          f"rolling snapshots {snaps}")
    traces = os.listdir(os.path.join(model, "trace"))
    check(traces == ["steps_3-5.pt.trace.json"], f"trace {traces}")
    line = next(x for x in out.splitlines() if x.startswith("[train] loader"))
    check(" 0 by the Python one" in line and "by the native" in line
          and not line.startswith("[train] loader: 0 "),
          f"the native WAV decoder did not run: {line}")
    result["train"] = {"wall_s": wall, "train_losses": tl.tolist(),
                       "val_losses": vl.tolist(), "loader": line}

    # 2. the same command in a subprocess, SIGTERM after its first
    # mid-epoch save (batch 5), then resumed here
    model2 = os.path.join(d, "recipe_sigterm")
    record = os.path.join(d, "recipe_worker.json")
    log = os.path.join(d, "recipe_worker.log")
    t0 = time.perf_counter()
    with open(log, "w") as fo:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--recipe-worker",
             record, *argv_for(model2)], stdout=fo, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            last_path = os.path.join(model2, "model_last.pt")
            while not os.path.exists(last_path) and proc.poll() is None:
                time.sleep(0.02)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log) as fo:
        worker_out = fo.read()
    saved = load_checkpoint(os.path.join(model2, "model_last.pt"))
    done = int(saved["batches_done"])
    print(f"[recipe] SIGTERM in a subprocess: rc={rc} after "
          f"{time.perf_counter() - t0:.1f} s, model_last at epoch "
          f"{saved['epoch']} batch {done}")
    check(rc == 0 and f"SIGTERM: saved model_last at epoch 1 batch {done}"
          in worker_out, f"the interrupted run: rc {rc}\n{worker_out[-3000:]}")
    check(saved["epoch"] == 1 and 0 < done < steps,
          f"not a mid-epoch save: epoch {saved['epoch']} batch {done}")
    reset_counts()
    with recorded_batches() as resumed_seen:
        rc, out = run_cli(argv_for(model2))
    counts = all_counts()
    out_counts["recipe_resume"] = counts
    with open(record) as fo:
        worker_seen = json.load(fo)
    last2 = load_checkpoint(os.path.join(model2, "model_last.pt"))
    tl2 = np.load(os.path.join(model2, "train_loss.npy"))
    rel = [abs(a - b) / abs(b) for a, b in zip(tl2[1:], tl[1:])]
    drift = max((last2["params"][k] - last["params"][k]).abs().max().item()
                / last["params"][k].abs().max().item() for k in last["params"])
    print(f"[recipe] resumed at epoch 1 batch {done}: rc={rc}, step "
          f"{last2['step']} (uninterrupted {last['step']}); batch order "
          f"{'the same' if worker_seen + resumed_seen == full_seen else 'DIFFERS'}"
          f"; epoch 2-3 train losses {tl2[1:].tolist()} vs "
          f"{tl[1:].tolist()} (rel {max(rel):.2e}, bound "
          f"{RESUME_LOSS_REL:.0e}); final params max|diff|/max|p| "
          f"{drift:.2e}")
    check(rc == 0 and f"resumed from epoch 1 batch {done}" in out,
          "the resumed run failed")
    check(last2["step"] == last["step"], "the resumed run's step count")
    check(worker_seen + resumed_seen == full_seen,
          "the resumed run's batches are not the uninterrupted run's")
    check(counts[res] == per * (steps * epochs - done),
          f"resumed run launches {counts}")
    check(len(tl2) == epochs and all(r <= RESUME_LOSS_REL for r in rel),
          f"resumed losses {tl2} vs {tl}")
    result["resume"] = {"batches_done": done, "loss_rel": max(rel),
                        "params_drift": drift}

    # 3. predict on the average of the two snapshots' EMA weights
    n_batches = -(-n_test // bs)
    for decoder, want_counts in (
            ("greedy", {inf: per * n_batches}),
            ("beam", {inf: per * -(-n_test // BEAM_B), "ctc_beam": 1})):
        reset_counts()
        rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                           "--model_path", model, "--device", str(dev),
                           "--ckpt", "avg", "--decoder", decoder])
        counts = all_counts()
        with open(os.path.join(model, "predicted.txt")) as fo:
            rows = fo.read().splitlines()
        cer = float(out.split("CER: ")[1].split()[0]) if "CER: " in out \
            else math.nan
        check(rc == 0 and "averaged 2 epoch snapshots" in out
              and len(rows) == n_test and math.isfinite(cer),
              f"--ckpt avg --decoder {decoder}: rc {rc}, CER {cer}")
        check(counts == {**dict.fromkeys(counts, 0), **want_counts},
              f"--ckpt avg {decoder} launches {counts}")
        out_counts[f"recipe_predict_avg_{decoder}"] = counts
        result[f"predict_avg_{decoder}_cer"] = cer

    result["compare"] = recipe_step_vs_plain(dev, alphabet, model, corpus)
    result["timing"] = recipe_timing(dev, alphabet, model, corpus, bi,
                                     train_steps_ms)
    result["convergence"] = recipe_convergence(dev, d)
    return {"launches": out_counts, **result}


def recipe_step_vs_plain(dev, alphabet, model, corpus):
    """One emit (2 micro-batches of 32) with every augmentation, from the
    recipe's model_last (its params, AdamW state and EMA), dropout 0, the
    same draws (a CUDA generator of one seed each): kernel vs plain path,
    phase 5's bounds on the losses and on the change of every parameter and
    of the EMA (plus 4 float32 ulps of the value the change is added to)."""
    import dataclasses

    import torch

    from pg_asr_tpu_torch.checkpoint import load_checkpoint
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.models import cast_params
    from pg_asr_tpu_torch.predict import load_model
    from pg_asr_tpu_torch.train import (AdamW, _copy, _ema_update,
                                        batch_to_device, loss_and_grads)

    _, cfg = load_model(model, alphabet, device=dev)
    # the full rate (no warmup): the change then stands well above the
    # float32 rounding of the values it is added to
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0),
                      train=dataclasses.replace(cfg.train, warmup_steps=0))
    state = load_checkpoint(os.path.join(model, "model_last.pt"))
    it = BatchIterator(load_manifest(os.path.join(corpus, "train.tsv"),
                                     os.path.join(corpus, "clips")),
                       alphabet, 32, shuffle=False)
    batches = []
    for batch in it:
        batches.append(batch_to_device(batch, dev))
        if len(batches) == 2:
            break
    start = cast_params(state["params"], torch.float32, dev)
    start_ema = cast_params(state["ema_params"], torch.float32, dev)
    got = {}
    for use_kernel in (True, False):
        # copies: the optimizer and the EMA update in place
        params, ema = _copy(start), _copy(start_ema)
        opt = AdamW(cfg, params)
        opt.load_state_dict(state["opt_state"], dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        losses = []
        for arrays in batches:
            loss, grads = loss_and_grads(params, arrays, cfg, gen,
                                         use_kernel=use_kernel)
            opt.update(params, grads)
            _ema_update(ema, params, cfg.train.ema_decay)
            losses.append(loss.item())
        got[use_kernel] = losses, params, ema
    (lk, pk, ek), (lp, pp, ep) = got[True], got[False]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    eps = torch.finfo(torch.float32).eps
    worst, raw = {}, {}
    for name, k_, p_, s_ in (("params", pk, pp, start),
                             ("ema", ek, ep, start_ema)):
        for k in p_:
            change = max((p_[k] - s_[k]).abs().max().item(), 1e-30)
            diff = (k_[k] - p_[k]).abs().max().item()
            excess = diff - 4 * eps * p_[k].abs().max().item()
            worst[f"{name}:{k}"] = max(excess, 0.0) / change
            raw[f"{name}:{k}"] = diff / change
    key, key_raw = max(worst, key=worst.get), max(raw, key=raw.get)
    print(f"[recipe] one emit of 2 micro-batches of 32 (augmented, EMA, "
          f"full rate), kernel vs plain path: losses {lk} vs {lp} (rel "
          f"{loss_rel:.2e}, bound {TRAIN_LOSS_REL:.0e}); worst change error "
          f"beyond 4 ulps {worst[key]:.2e} of the change ({key}; bound "
          f"{TRAIN_GRAD_REL:.0e}), max|diff|/change {raw[key_raw]:.2e} "
          f"({key_raw})")
    check(all(math.isfinite(x) for x in lk) and loss_rel <= TRAIN_LOSS_REL,
          f"recipe losses disagree: {lk} vs {lp}")
    check(all(v <= TRAIN_GRAD_REL for v in worst.values()),
          f"recipe params / EMA disagree: {key} {worst[key]}")
    return {"loss_rel": loss_rel, "change_rel_worst": worst[key],
            "diff_over_change_max": raw[key_raw]}


def recipe_timing(dev, alphabet, model, corpus, bi, train_steps_ms):
    """The recipe's options at B=64 x 5 s: wave_augment and spec_augment
    (float32 whatever the model's type), the EMA update and the train
    micro-step with every option, float32 and bfloat16, beside phase 5's
    plain step; the loader's host ms per batch."""
    import numpy as np
    import torch

    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.ops.augment import spec_augment, wave_augment
    from pg_asr_tpu_torch.ops.features import extract_features
    from pg_asr_tpu_torch.predict import load_model
    from pg_asr_tpu_torch.train import (AdamW, _copy, _ema_update,
                                        make_train_step)
    from pg_asr_tpu_torch.utils.profiling import memory_stats

    arrays64 = flagship_batch(dev, vocab=alphabet.size)
    _, cfg = load_model(model, alphabet, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    feats, mask, _ = extract_features(arrays64[0], arrays64[1], cfg.features)
    out = {"wave_augment_ms": device_ms(lambda: wave_augment(
               arrays64[0], arrays64[1], gen, cfg.augment), 20),
           "spec_augment_ms": device_ms(lambda: spec_augment(
               feats, mask, gen, cfg.augment), 20)}
    for dtype in ("float32", "bfloat16"):
        params, c = load_model(model, alphabet, device=dev, dtype=dtype)
        ema = _copy(params)
        out[f"ema_ms_{dtype}"] = time_ms(
            lambda: _ema_update(ema, params, c.train.ema_decay), 10)
        opt = AdamW(c, params)
        step = make_train_step(c, opt)

        def micro_step():
            step(params, gen, *arrays64)
            _ema_update(ema, params, c.train.ema_decay)

        torch.cuda.reset_peak_memory_stats()
        out[f"step_ms_{dtype}"] = time_ms(micro_step, 6)  # 3 emits
        peak = memory_stats()[str(dev)]["peak_bytes_in_use"] / 2 ** 30
        out[f"step_peak_gib_{dtype}"] = peak
        print(f"[recipe] B={B} x 5 s, {dtype}: micro-step with every "
              f"augmentation, accumulation 2 and EMA "
              f"{out[f'step_ms_{dtype}']:.2f} ms (phase 5's plain step "
              f"{train_steps_ms[dtype]:.2f} ms), peak {peak:.2f} GiB "
              f"allocated; EMA update {out[f'ema_ms_{dtype}']:.3f} ms")
    print(f"[recipe] B={B} x 5 s: wave_augment (speed, noise, gain) "
          f"{out['wave_augment_ms']:.3f} ms, spec_augment (2 + 2 masks) "
          f"{out['spec_augment_ms']:.3f} ms (device time)")

    utts = load_manifest(os.path.join(corpus, "train.tsv"),
                         os.path.join(corpus, "clips"))
    loader = {}
    for name, kw in (("python_0", dict(decoder="python")),
                     ("native_0", dict(decoder="native")),
                     ("native_2", dict(decoder="native", num_workers=2)),
                     ("native_2_cache", dict(decoder="native", num_workers=2,
                                             cache_mb=4096))):
        it = BatchIterator(utts, alphabet, 32, seed=SEED, **kw)
        n = sum(1 for _ in it)  # lengths known (and the cache filled)
        t0 = time.perf_counter()
        check(sum(1 for _ in it) == n, "loader epoch length")
        loader[name] = (time.perf_counter() - t0) * 1e3 / n
    print(f"[recipe] loader host ms per batch of 32 (1-5 s, second epoch): "
          + ", ".join(f"{k} {v:.2f}" for k, v in loader.items()))
    out["loader_ms_per_batch"] = loader
    return out


def recipe_convergence(dev, d):
    """examples/pg_improves_cer.py's recipe on the port's phonetic corpus
    (96 utterances, seed 0): logmel 40, projection 128, 2 x BiLSTM 64,
    dropout 0.1, 16 epochs of batch 8, lr 3e-3, warmup 50, then 120
    REINFORCE steps; the test CER after each. The JAX package's run of the
    same recipe from the same initial weights: tests/test_torch_convergence.py
    run as a script, on a CPU."""
    from pg_asr_tpu_torch.config import (Config, FeatureConfig, ModelConfig,
                                         TrainConfig)
    from pg_asr_tpu_torch.data import make_phonetic_corpus
    from pg_asr_tpu_torch.predict import predict
    from pg_asr_tpu_torch.rl.reinforce import finetune_pg
    from pg_asr_tpu_torch.train import train

    corpus, _ = make_phonetic_corpus(os.path.join(d, "phonetic"), n_utts=96,
                                     seed=0)
    model = os.path.join(d, "phonetic_model")
    cfg = Config(
        features=FeatureConfig(kind="logmel", n_mels=40, n_fft=256,
                               win_length=256, hop_length=128),
        model=ModelConfig(family="ctc", vocab_size=8, input_dim=40,
                          input_proj_dim=128, hidden_size=64, num_layers=2,
                          dropout=0.1),
        train=TrainConfig(num_epochs=16, batch_size=8, learning_rate=3e-3,
                          warmup_steps=50, log_every=10000, prefetch_depth=0))
    args = (os.path.join(corpus, "test.tsv"), os.path.join(corpus, "clips"),
            os.path.join(corpus, "alphabet.txt"), model)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = train(corpus, model, config=cfg, device=str(dev))
        t_train = time.perf_counter() - t0
        before = predict(*args, batch_size=8, device=str(dev))
        t0 = time.perf_counter()
        finetune_pg(corpus, model, num_steps=120, batch_size=8, config=cfg,
                    device=str(dev))
        t_pg = time.perf_counter() - t0
        after = predict(*args, batch_size=8, which_ckpt="last",
                        device=str(dev))
    res = {"cer_train": before["cer"], "wer_train": before["wer"],
           "cer_pg": after["cer"], "wer_pg": after["wer"],
           "train_losses": out["train_losses"],
           "val_losses": out["val_losses"], "train_s": t_train, "pg_s": t_pg}
    print(f"[recipe] convergence (phonetic corpus, 96 utterances): test CER "
          f"{before['cer']:.4f} after 16 epochs ({t_train:.1f} s), "
          f"{after['cer']:.4f} after 120 REINFORCE steps ({t_pg:.1f} s); "
          f"train losses {[round(x, 4) for x in out['train_losses']]}")
    check(all(math.isfinite(res[k]) for k in ("cer_train", "cer_pg")),
          f"convergence CER {res}")
    return res


FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "pg_asr_tpu_torch", "testdata", "flax_bilstm_tiny")
VITERBI_B, VITERBI_L = 32, 32  # utterances of 5 s, labels (a batch's pad)


def librispeech_tree(corpus, root):
    """The smoke corpus's WAVs as a LibriSpeech tree: train-clean-100/,
    dev-clean/, test-clean/, speaker/chapter dirs of 16 utterances each
    (symlinks to the clips), upper-case <spk>-<chap>.trans.txt."""
    from pg_asr_tpu_torch.data.text import read_tsv

    for split, name in (("train", "train-clean-100"), ("dev", "dev-clean"),
                        ("test", "test-clean")):
        _, rows = read_tsv(os.path.join(corpus, f"{split}.tsv"))
        for k in range(0, len(rows), 16):
            spk, chap = 100 + k // 16, 1000 + k // 16
            d = os.path.join(root, name, str(spk), str(chap))
            os.makedirs(d)
            lines = []
            for j, r in enumerate(rows[k: k + 16]):
                uid = f"{spk}-{chap}-{j:04d}"
                os.symlink(os.path.join(corpus, "clips", r["path"]),
                           os.path.join(d, uid + ".wav"))
                lines.append(f"{uid} {r['sentence'].upper()}")
            with open(os.path.join(d, f"{spk}-{chap}.trans.txt"), "w") as fo:
                fo.write("\n".join(lines) + "\n")


def durations_in_batch_order(tsv, aud, alphabet, bs):
    """Seconds of each utterance of a manifest, in the order the drivers
    write their rows (length-sorted batches, shuffle off)."""
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest

    return [float(n) / 16000 for b in BatchIterator(
        load_manifest(tsv, aud), alphabet, bs, shuffle=False)
        for n in b.num_samples]


def check_word_times(rows, durations, what):
    """Each row's words: start <= end, in order, inside the utterance
    (times are rounded to ms). Returns the number of words."""
    check(len(rows) == len(durations), f"{what}: {len(rows)} rows for "
          f"{len(durations)} utterances")
    n = 0
    for row, dur in zip(rows, durations):
        prev = 0.0
        for w in row["words"]:
            check(prev - 1e-3 <= w["start"] <= w["end"] <= dur + 1e-3
                  and 0.0 <= w["conf"] <= 1.0,
                  f"{what}: word {w} of a {dur:.3f} s utterance")
            prev = w["start"] if what == "timestamps" else w["end"]
            n += 1
    return n


def phase_corpus_tools(dev, corpus, d):
    """12. The corpus tools on the full-width BiLSTM-CTC with BPE units:
    preproc of a LibriSpeech tree, one training epoch, beam and greedy
    --timestamps transcription, forced alignment, pseudo-labels; ctc_beam
    at A=256 against its plain scan; the Viterbi timed at B=32 x 5 s; the
    JAX package's flax checkpoint fixture served on the card."""
    import shutil

    import numpy as np
    import torch

    from pg_asr_tpu_torch.checkpoint import save_model
    from pg_asr_tpu_torch.config import Config, ModelConfig
    from pg_asr_tpu_torch.data import Alphabet, BatchIterator, load_manifest
    from pg_asr_tpu_torch.data import bpe, native_bpe
    from pg_asr_tpu_torch.decoding import beam, cuda_beam
    from pg_asr_tpu_torch.models import bilstm_ctc, cast_params
    from pg_asr_tpu_torch.models.bilstm_ctc import torch_dtype
    from pg_asr_tpu_torch.ops import align
    from pg_asr_tpu_torch.predict import forward, load_model
    from pg_asr_tpu_torch.train import AdamW, loss_and_grads

    t_start = time.perf_counter()
    inf, res, bwd, per = route_counters()
    bs, out_counts, result = 32, {}, {}

    def jsonl(path):
        with open(path) as fo:
            return [json.loads(ln) for ln in fo]

    # 1. preproc of a LibriSpeech tree with BPE units
    root, bcorpus = os.path.join(d, "LibriSpeech"), os.path.join(d, "bpe")
    librispeech_tree(corpus, root)
    t0 = time.perf_counter()
    rc, out = run_cli(["--mode", "preproc", "--librispeech_root", root,
                       "--corpus_path", bcorpus, "--units", "bpe",
                       "--bpe_vocab_size", "256"])
    check(rc == 0 and "[preproc] BPE vocabulary" in out, "preproc failed")
    tok = bpe.load_tokenizer(bcorpus, "bpe")
    n = {s: len(load_manifest(os.path.join(bcorpus, f"{s}.tsv"), None))
         for s in ("train", "dev", "test")}
    check(n == {s: len(load_manifest(os.path.join(corpus, f"{s}.tsv")))
                for s in n}, f"splits {n}")
    texts = [u.text for u in load_manifest(
        os.path.join(bcorpus, "train.tsv"), None)]
    check(all(t == t.lower() for t in texts), "transcripts not lower-cased")
    check(native_bpe.native_available(), "the native BPE segmenter did not "
          f"build from {native_bpe.SOURCE}")
    check(native_bpe.NativeBpe(tok.symbols, tok.merges).encode_batch(texts)
          == [tok.encode(t) for t in texts],
          "the native segmenter's ids differ from the Python tokenizer's")
    result["preproc"] = {"s": time.perf_counter() - t0, "vocab": tok.size,
                         "merges": len(tok.merges), "splits": n}
    print(f"[tools] preproc: LibriSpeech tree {n} -> BPE vocabulary of "
          f"{tok.size} tokens ({len(tok.merges)} merges) in "
          f"{result['preproc']['s']:.1f} s; native segmenter ids equal the "
          "Python tokenizer's")

    # 2. one epoch of training on the BPE units
    model = os.path.join(d, "bpe_model")
    steps, n_dev, n_test = (-(-n["train"] // bs), -(-n["dev"] // bs),
                            n["test"])
    reset_counts()
    for k in bpe.SEGMENTED:
        bpe.SEGMENTED[k] = 0
    t0 = time.perf_counter()
    rc, out = run_cli(["--mode", "train", "--corpus_path", bcorpus,
                       "--model_path", model, "--device", str(dev),
                       "--units", "bpe", "--num_epochs", "1", "--seed",
                       str(SEED)])
    torch.cuda.synchronize()
    counts = all_counts()
    tl = np.load(os.path.join(model, "train_loss.npy"))
    vl = np.load(os.path.join(model, "val_losses.npy"))
    check(rc == 0 and np.isfinite(tl).all() and np.isfinite(vl).all(),
          f"BPE train: rc {rc}, losses {tl} {vl}")
    check(counts == {**dict.fromkeys(counts, 0), res: per * steps,
                     bwd: per * steps, inf: per * n_dev},
          f"BPE train launches {counts}")
    seg = dict(bpe.SEGMENTED)
    check(seg["native"] >= steps + n_dev and seg["python"] == 0,
          f"segmenter batches {seg}: the native one must encode them all")
    with open(os.path.join(model, "config.json")) as fo:
        cfg = Config.from_json(fo.read())
    check(cfg.text.units == "bpe" and cfg.model.vocab_size == tok.size,
          f"config {cfg.text} vocab {cfg.model.vocab_size}")
    out_counts["corpus_tools_train"] = counts
    result["train"] = {"s": time.perf_counter() - t0, "steps": steps,
                       "train_loss": float(tl[0]), "val_loss": float(vl[0]),
                       "segmented": seg}
    print(f"[tools] train --units bpe: {steps} steps, {per} + {per} "
          f"residual / backward launches a step, loss {tl[0]:.4f} val "
          f"{vl[0]:.4f}, segmenter batches {seg}, "
          f"{result['train']['s']:.1f} s")

    # 3. beam (one ctc_beam launch at A = the vocabulary) and greedy
    # --timestamps, on the trained model and on random weights (which
    # emit words where one epoch may not yet)
    rand = os.path.join(d, "bpe_random")
    save_model(rand, bilstm_ctc.init_params(
        ModelConfig(vocab_size=tok.size), torch.Generator().manual_seed(SEED)),
        cfg)
    test_tsv = os.path.join(bcorpus, "test.tsv")
    durs = durations_in_batch_order(test_tsv, None, tok, bs)
    for name, m in (("trained", model), ("random", rand)):
        reset_counts()
        rc, out = run_cli(["--mode", "predict", "--corpus_path", bcorpus,
                           "--model_path", m, "--device", str(dev),
                           "--decoder", "beam"])
        counts = all_counts()
        check(rc == 0 and "CER:" in out, f"{name} beam predict: rc {rc}")
        check(counts == {**dict.fromkeys(counts, 0), "ctc_beam": 1,
                         inf: per}, f"{name} beam launches {counts}")
        out_counts[f"corpus_tools_{name}_beam"] = counts
        reset_counts()
        rc, out = run_cli(["--mode", "predict", "--corpus_path", bcorpus,
                           "--model_path", m, "--device", str(dev),
                           "--timestamps"])
        counts = all_counts()
        check(rc == 0 and counts == {**dict.fromkeys(counts, 0),
                                     inf: per * -(-n_test // bs)},
              f"{name} --timestamps: rc {rc}, launches {counts}")
        out_counts[f"corpus_tools_{name}_timestamps"] = counts
        rows = jsonl(os.path.join(m, "timestamps.jsonl"))
        words = check_word_times(rows, durs, "timestamps")
        result[f"{name}_timestamps_words"] = words
        print(f"[tools] {name} BPE model: beam 1 ctc_beam launch at A="
              f"{tok.size}; --timestamps {len(rows)} rows, {words} words, "
              "onsets in order inside their utterances")
    check(result["random_timestamps_words"] > 0, "no word timed")

    # 4. forced alignment, and one batch's spans on the card vs the CPU
    reset_counts()
    rc, out = run_cli(["--mode", "align", "--corpus_path", bcorpus,
                       "--model_path", model, "--device", str(dev)])
    counts = all_counts()
    check(rc == 0 and counts == {**dict.fromkeys(counts, 0),
                                 inf: per * -(-n_test // bs)},
          f"align: rc {rc}, launches {counts}")
    out_counts["corpus_tools_align"] = counts
    rows = jsonl(os.path.join(model, "alignments.jsonl"))
    words = check_word_times(rows, durs, "alignments")
    check(all(r["aligned"] for r in rows) and words >= n_test,
          f"align: {sum(r['aligned'] for r in rows)} of {len(rows)} aligned,"
          f" {words} words")
    params, cfg_m = load_model(model, tok, device=dev)
    batch = next(iter(BatchIterator(load_manifest(test_tsv, None), tok, bs,
                                    shuffle=False)))
    lp, _, lens = forward(params, torch.from_numpy(batch.wave).to(dev),
                          torch.from_numpy(batch.num_samples).to(dev), cfg_m)
    labels = torch.from_numpy(batch.labels)
    llens = torch.from_numpy(batch.label_lens)
    on_card = align.ctc_forced_align(lp, lens, labels.to(dev),
                                     llens.to(dev))
    check(on_card == align.ctc_forced_align(lp.cpu(), lens.cpu(), labels,
                                            llens),
          "the card's alignment spans differ from the CPU's")
    result["align"] = {"rows": len(rows), "words": words}
    print(f"[tools] align: {len(rows)} of {len(rows)} aligned, {words} word "
          "spans in order inside their utterances; one batch's spans on the "
          "card equal the CPU's on the same log-probs")

    # 5. pseudo-labels of the clips directory
    clips = os.path.join(corpus, "clips")
    for name, m in (("trained", model), ("random", rand)):
        reset_counts()
        rc, out = run_cli(["--mode", "pseudolabel", "--corpus_path", bcorpus,
                           "--aud_path", clips, "--model_path", m,
                           "--device", str(dev), "--min_conf", "0"])
        counts = all_counts()
        n_clips = len([f for f in os.listdir(clips) if f.endswith(".wav")])
        check(rc == 0 and counts == {**dict.fromkeys(counts, 0),
                                     inf: per * -(-n_clips // bs)},
              f"{name} pseudolabel: rc {rc}, launches {counts}")
        out_counts[f"corpus_tools_{name}_pseudolabel"] = counts
        with open(os.path.join(m, "pseudo.tsv")) as fo:
            lines = fo.read().splitlines()
        check(lines[0] == "path\tsentence\tconfidence"
              and all(ln.split("\t")[0].startswith(clips)
                      and ln.split("\t")[1].strip()
                      and 0.0 <= float(ln.split("\t")[2]) <= 1.0
                      for ln in lines[1:]), f"{name} pseudo.tsv rows")
        result[f"{name}_pseudolabel_kept"] = len(lines) - 1
        print(f"[tools] {name} pseudolabel: kept {len(lines) - 1} of "
              f"{n_clips} clips (min_conf 0)")
    check(result["random_pseudolabel_kept"] > 0, "no pseudo-label kept")

    # 6. ctc_beam at a BPE vocabulary, A=256, the beam's default batch
    rng = np.random.default_rng(SEED + 1)
    A = 256
    x = rng.standard_normal((BEAM_B, T, A)) * 2.0
    blp = torch.from_numpy((x - np.log(np.exp(x).sum(-1, keepdims=True)))
                           .astype(np.float32)).to(dev)
    fl = rng.integers(1, T + 1, BEAM_B).astype(np.int32)
    fl[:3] = [T, 1, 2]
    valid = int(fl.sum())
    fl = torch.from_numpy(fl).to(dev)
    cases = []
    for M in (6, beam._prune_m(A, BEAM_K, None)):
        prune = None if M == beam._prune_m(A, BEAM_K, None) else M
        _, rel, abs_err = beam_vs_plain(blp, fl, M, T)
        k_ms, p_ms = in_turns(
            lambda: beam.beam_decode(blp, fl, max_label_len=T, prune=prune,
                                     use_kernel=False),
            lambda: cuda_beam.ctc_beam_cuda(blp, fl, K=BEAM_K, M=M, Lmax=T),
            1, 20)
        C = BEAM_K * (1 + M)  # phase 3b's count at this A
        nbytes = (valid * A * 4 + BEAM_B * 4 + 2 * T * BEAM_B * BEAM_K * 4
                  + 2 * BEAM_B * BEAM_K * 4 + BEAM_B * T * 4 + 2 * BEAM_B * 4)
        flops = valid * (A * M + BEAM_K * BEAM_K + 5 * C + 20 * BEAM_K)
        b_ms, b_by = bound_ms(flops, nbytes, "float32")
        cases.append({"M": M, "B": BEAM_B, "T": T, "A": A, "K": BEAM_K,
                      "valid_frames": valid, "nll_max_rel_err": rel,
                      "nll_max_abs_err": abs_err, "ms": k_ms,
                      "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by})
        print(f"[tools] ctc_beam B={BEAM_B} T={T} A={A} K={BEAM_K} M={M}: "
              f"labels, lens, parents, syms identical to the plain scan; nll "
              f"rel err {rel:.1e}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms,"
              f" bound {b_ms * 1e3:.2f} us ({b_by})")
    result["beam_a256"] = cases

    # 7. the Viterbi at B=32 x 5 s over the learned vocabulary
    vlp = torch.log_softmax(torch.randn(
        VITERBI_B, T, tok.size, generator=torch.Generator().manual_seed(SEED)),
        -1).to(dev)
    vlab = torch.randint(1, tok.size, (VITERBI_B, VITERBI_L),
                         generator=torch.Generator().manual_seed(SEED))
    vll = torch.full((VITERBI_B,), VITERBI_L, dtype=torch.int64)
    vfl = torch.full((VITERBI_B,), T, dtype=torch.int64)
    vargs = (vlp, vfl.to(dev), vlab.to(dev), vll.to(dev))

    def viterbi():
        return align.ctc_viterbi_backpointers(*vargs)

    def forced():
        return align.ctc_forced_align(*vargs)

    back = viterbi()[0]
    check(torch.equal(back.cpu(), align.ctc_viterbi_backpointers(
        vlp.cpu(), vfl, vlab, vll)[0]), "Viterbi backpointers: card vs CPU")
    # its thousands of launches overfill the launch queue, so CUDA events
    # would time the host: the device's busy time comes from the profiler
    busy = device_breakdown(viterbi, groups=("all",),
                            classify=lambda name: "all")["all"]
    vit = {"B": VITERBI_B, "T": T, "A": tok.size, "S": 2 * VITERBI_L + 1,
           "device_busy_ms": busy, "host_ms": host_ms(viterbi, 5),
           "forced_align_host_ms": host_ms(forced, 3),
           "device_ops": device_ops(viterbi)}
    result["viterbi"] = vit
    print(f"[tools] Viterbi B={VITERBI_B} T={T} S={vit['S']}: device busy "
          f"{busy:.2f} ms (profiler), wall {vit['host_ms']:.2f} ms (host "
          f"clock, synchronised; {vit['device_ops']} device operations); "
          f"with the D2H copy and the backtrace "
          f"{vit['forced_align_host_ms']:.2f} ms")

    # the train step at B=64 x 5 s with the BPE head beside the character
    # head (A=28), random weights, in turns (char, bpe, bpe, char)
    steps = {}
    for dtype in ("float32", "bfloat16"):
        fns = {}
        for name, vocab in (("char", 28), ("bpe", tok.size)):
            mcfg = Config(model=ModelConfig(vocab_size=vocab, dtype=dtype))
            p_d = cast_params(bilstm_ctc.init_params(
                mcfg.model, torch.Generator().manual_seed(SEED)),
                torch_dtype(dtype), dev)
            opt = AdamW(mcfg, p_d)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            arrays = flagship_batch(dev, vocab=vocab)

            def step(p_d=p_d, opt=opt, gen=gen, arrays=arrays, mcfg=mcfg):
                _, grads = loss_and_grads(p_d, arrays, mcfg, gen)
                opt.update(p_d, grads)

            fns[name] = step
        c1, b1 = time_ms(fns["char"], 5), time_ms(fns["bpe"], 5)
        b2, c2 = time_ms(fns["bpe"], 5), time_ms(fns["char"], 5)
        steps[dtype] = {"char_ms": (c1 + c2) / 2, "bpe_ms": (b1 + b2) / 2}
        print(f"[tools] train step B={B} x 5 s, {dtype}: A={tok.size} "
              f"{steps[dtype]['bpe_ms']:.2f} ms, A=28 "
              f"{steps[dtype]['char_ms']:.2f} ms (in turns)")
    result["train_step"] = steps

    # 8. the JAX package's flax checkpoint (committed fixture) on the card
    flax_dir = os.path.join(d, "flax_model")
    shutil.copytree(FIXTURE, flax_dir)
    with np.load(os.path.join(flax_dir, "reference.npz")) as z:
        ref = {k: z[k] for k in z.files}
    falpha = Alphabet.load(os.path.join(flax_dir, "alphabet.txt"))
    reset_counts()
    fparams, fcfg = load_model(flax_dir, falpha, device=dev)
    flp, _, flens = forward(fparams, torch.from_numpy(ref["wave"]).to(dev),
                            torch.from_numpy(ref["num_samples"]).to(dev),
                            fcfg)
    counts = all_counts()
    err = (flp.cpu() - torch.from_numpy(ref["log_probs"])).abs().max().item()
    check(flens.cpu().tolist() == ref["out_lens"].tolist()
          and err <= LOGPROB_BOUND, f"flax fixture log-probs: err {err}")
    check(counts[inf] == fcfg.model.num_layers and sum(counts.values())
          == counts[inf], f"flax fixture forward launches {counts}")
    n_flax = -(-n_test // bs)
    for mode in ("predict", "align"):
        reset_counts()
        rc, out = run_cli(["--mode", mode, "--corpus_path", corpus,
                           "--model_path", flax_dir, "--alphabet",
                           os.path.join(flax_dir, "alphabet.txt"),
                           "--device", str(dev)])
        counts = all_counts()
        check(rc == 0 and counts == {
            **dict.fromkeys(counts, 0),
            inf: fcfg.model.num_layers * n_flax},
            f"flax fixture --mode {mode}: rc {rc}, launches {counts}")
        out_counts[f"corpus_tools_flax_{mode}"] = counts
    rows = jsonl(os.path.join(flax_dir, "alignments.jsonl"))
    check(len(rows) == n_test, "flax fixture alignments")
    result["flax"] = {"max_abs_err": err, "bound": LOGPROB_BOUND,
                      "served": sorted(os.listdir(flax_dir))}
    print(f"[tools] flax fixture (JAX-trained, model_best.ckpt with "
          f"ema_params): log-probs on the card vs the JAX package's max abs "
          f"err {err:.2e} (bound {LOGPROB_BOUND:.0e}); predict and align "
          "through the CLI")
    result["wall_s"] = time.perf_counter() - t_start
    print(f"[tools] phase 12 wall time {result['wall_s']:.1f} s")
    return {"launches": out_counts, **result}



# the streamed window (serving.py): C committed + R lookahead frames, the
# StreamingTranscriber's defaults
STREAM_C, STREAM_R = 64, 32
# lstm_fwd vs its plain version at the window's shapes (B=1 and 8, T=96):
# tests/test_torch_cuda.py's bounds, float32 by summation order, bfloat16
# one ulp of an output in [0.5, 1)
STREAM_KERNEL_BOUNDS = {"float32": 1e-5, "bfloat16": 4e-3}
# the streamed log-probs vs the offline forward on one utterance, float32
# (fixed norm, lookahead to the stream end): the same model through other
# kernels (the window's backward direction on lstm_fwd from a zero state,
# the forward direction on the carried plain scan, whose sigmoid rounds per
# operation; offline bilstm_fwd; for the conformer, windows of growing
# length through flash_attn): phase 4's end-to-end bound
STREAM_LOGPROB_BOUND = LOGPROB_BOUND
# the flash kernel at the streamed attention windows: B=1, the default
# conformer's 4 heads of 64, T' = (n_ctx + C + R) / 2 from the first
# window's 48 up to the full left context's 304, and 16 (a flushed chunk)
STREAM_FLASH_T = (16, 48, 176, 304)
# seconds of audio a timed stream carries; chunks (ticks) profiled
STREAM_TIMING_S = 12
STREAM_PROFILED = 3


def stream_lstm_cases(dev):
    """lstm_fwd's reverse form (the window's backward direction) vs its
    plain version at B=1 and B=8 (a batched tick: row 3 an idle slot with
    an all-zero mask, row 5 a flushed slot's partial window), T = C + R,
    H=256, float32 and bfloat16: errors, equal bits on a second launch,
    zeros where masked, device-timed in turns, the bound."""
    import torch

    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.ops.lstm import lstm_scan_plain

    Tw = STREAM_C + STREAM_R
    cases = []
    for Bs in (1, 8):
        g = torch.Generator().manual_seed(SEED + Bs)
        lens = torch.full((Bs,), Tw)
        if Bs > 1:
            lens[3], lens[5] = 0, 37
        mask = (torch.arange(Tw)[None] < lens[:, None]).to(dev, torch.float32)
        xp32 = (0.5 * torch.randn(Bs, Tw, 4 * H, generator=g)).to(dev)
        U32 = ((torch.rand(H, 4 * H, generator=g) * 2 - 1)
               / math.sqrt(H)).to(dev)
        valid = int(lens.sum())
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            xp, U = xp32.to(dtype), U32.to(dtype)
            got = cuda_lstm.lstm_scan_cuda(xp, U, mask, True)
            again = cuda_lstm.lstm_scan_cuda(xp, U, mask, True)
            ref = lstm_scan_plain(xp, U, mask, True)
            torch.cuda.synchronize()
            err, mean_err = _errs(got, ref)
            bound = STREAM_KERNEL_BOUNDS[name]
            check(torch.equal(got, again), f"lstm_fwd B={Bs} {name}: two "
                  "launches differ")
            check(bool(torch.all(got[mask == 0] == 0)),
                  f"lstm_fwd B={Bs} {name}: not zero where masked")
            check(err <= bound, f"lstm_fwd at the streamed window B={Bs} "
                  f"{name}: max abs err {err} > {bound}")
            k_ms, p_ms = in_turns(
                lambda: lstm_scan_plain(xp, U, mask, True),
                lambda: cuda_lstm.lstm_scan_cuda(xp, U, mask, True), 3, 20,
                device_ms)
            s = xp.element_size()
            # phase 3's counts: xp on the valid steps, U, the output and
            # the mask; the product and ~30 elementwise ops a valid step
            io = (valid * 4 * H + H * 4 * H + Bs * Tw * H) * s + Bs * Tw * 4
            b_ms, b_by = bound_ms(valid * (2 * H * 4 * H + 30 * H), io, name)
            case = {"B": Bs, "T": Tw, "H": H, "dtype": name,
                    "reverse": True, "row_lens": lens.tolist(),
                    "max_abs_err": err, "mean_abs_err": mean_err,
                    "bound": bound, "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": b_by}
            cases.append(case)
            print(f"[stream] lstm_fwd reverse B={Bs} T={Tw} H={H} {name} "
                  f"(row lens {lens.tolist()}): max_abs_err {err:.3e} "
                  f"(bound {bound:.0e}), mean {mean_err:.3e}; "
                  f"device-timed kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})")
    return cases


def stream_flash_cases(dev):
    """flash_attn vs its plain version at the streamed attention windows
    (B=1, 4 heads of 64, T' as STREAM_FLASH_T, the last quarter of the
    longest window masked as past the stream end), float32 and bfloat16,
    device-timed in turns."""
    import torch

    from pg_asr_tpu_torch.ops import cuda_flash_attn
    from pg_asr_tpu_torch.ops.flash_attn import mhsa_plain

    scale = ATTN_DH ** -0.5
    cases = []
    for Tq in STREAM_FLASH_T:
        g = torch.Generator().manual_seed(SEED + Tq)
        qkv = torch.randn(1, Tq, 3, ATTN_H, ATTN_DH, generator=g)
        n = Tq - Tq // 4 if Tq == max(STREAM_FLASH_T) else Tq
        valid = (torch.arange(Tq)[None] < n).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            q, k, v = (qkv.to(dev, dtype)[:, :, i].transpose(1, 2)
                       for i in range(3))
            got = cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale)
            ref = mhsa_plain(q, k, v, valid, scale)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            bound = FLASH_BOUNDS[name] * (v.float().abs().max().item()
                                          if name == "bfloat16" else 1.0)
            check(err <= bound, f"flash_attn T'={Tq} {name}: {err} > "
                  f"{bound}")
            k_ms, p_ms = in_turns(
                lambda: mhsa_plain(q, k, v, valid, scale),
                lambda: cuda_flash_attn.flash_attn_cuda(q, k, v, valid,
                                                        scale), 10, 50,
                device_ms)
            pairs = n * n + (Tq - n) ** 2
            b_ms, b_by = bound_ms(4 * ATTN_H * ATTN_DH * pairs,
                                  4 * ATTN_H * Tq * ATTN_DH
                                  * q.element_size() + Tq * 4, name)
            cases.append({"B": 1, "H": ATTN_H, "T": Tq, "valid": n,
                          "dh": ATTN_DH, "dtype": name, "max_abs_err": err,
                          "bound": bound, "ms": k_ms, "plain_ms": p_ms,
                          "bound_ms": b_ms, "bound_by": b_by})
            print(f"[stream] flash_attn B=1 H={ATTN_H} T'={Tq} ({n} valid) "
                  f"dh={ATTN_DH} {name}: max_abs_err {err:.3e} (bound "
                  f"{bound:.3e}); device-timed kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return cases


@contextlib.contextmanager
def recorded(module, name: str, rec: list):
    """module.name wrapped so that each call's result is appended to
    rec (restored after)."""
    orig = getattr(module, name)

    def wrapper(*args, **kw):
        out = orig(*args, **kw)
        rec.append(out)
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def replayed(module, name: str, rec: list):
    """module.name replaced by one that returns rec's results in turn (a
    list that ``recorded`` filled; restored after)."""
    orig, it = getattr(module, name), iter(rec)
    setattr(module, name, lambda *args, **kw: next(it))
    try:
        yield
    finally:
        setattr(module, name, orig)


def offline_utterance(dev, cfg, wave):
    """One utterance the way batched predict sees it (zeros past its end):
    (wave (1, N) on dev, num_samples, valid frames, its fixed norm: the
    (mean, var) of its valid feature cells)."""
    import numpy as np
    import torch

    from pg_asr_tpu_torch.ops.features import extract_features

    w = torch.from_numpy(np.pad(wave, (0, cfg.features.n_fft)))[None].to(dev)
    ns = torch.tensor([len(wave)], device=dev)
    feats, _, flens = extract_features(w, ns, cfg.features)
    n = int(flens[0])
    cells = feats[0, :n].double()
    return w, ns, n, (cells.mean().item(), cells.var(unbiased=False).item())


def stream_vs_offline(dev, alphabet, model_dir, wave, attention: bool):
    """Fixed norm (the utterance's own), lookahead to the stream end and,
    for an attention family, left context over the whole utterance: the
    streamed per-frame log-probs (BiLSTM-CTC; the max log-prob for the
    attention families) and ids against the offline predict.forward.
    Counts the launches of the streamed run."""
    import torch

    from pg_asr_tpu_torch import serving
    from pg_asr_tpu_torch.predict import forward, load_model

    params, cfg = load_model(model_dir, alphabet, device=dev)
    w, ns, n, norm = offline_utterance(dev, cfg, wave)
    lp_off, _, out_lens = forward(params, w, ns, cfg)
    n_out = int(out_lens[0])
    lp_off = lp_off[0, :n_out]
    st = serving.StreamingTranscriber(params, cfg, alphabet,
                                      chunk_frames=STREAM_C, right_context=n,
                                      left_context=n, norm=norm, device=dev)
    rec = []
    reset_counts()
    if attention:
        with recorded(serving, "_chunk_step_attention", rec):
            text = st.push(wave) + st.flush()
        ids = torch.cat([r[0][0] for r in rec])[:n_out]
        lp_max = torch.cat([r[1][0] for r in rec])[:n_out]
        err = (lp_max - lp_off.amax(-1)).abs().max().item()
    else:
        with recorded(serving, "_ctc_log_probs", rec):
            text = st.push(wave) + st.flush()
        lp = torch.cat([r[0] for r in rec])[:n_out]
        ids = lp.argmax(-1)
        err = (lp - lp_off).abs().max().item()
    counts = all_counts()
    n_chunks = len(rec)
    top2 = lp_off.topk(2, dim=-1).values
    # where the top two lie further apart than twice the bound, the
    # agreement of the log-probs within it forbids another argmax
    clear = (top2[:, 0] - top2[:, 1]) > 2 * STREAM_LOGPROB_BOUND
    diff = int(((ids != lp_off.argmax(-1)) & clear).sum())
    check(n_chunks == -(-n // STREAM_C), f"{n_chunks} chunks for {n} frames")
    check(err <= STREAM_LOGPROB_BOUND and diff == 0,
          f"streamed vs offline ({cfg.model.family}): log-prob err {err}, "
          f"{diff} ids differ")
    return {"family": cfg.model.family, "frames": n, "out_frames": n_out,
            "chunks": n_chunks, "max_abs_err": err,
            "bound": STREAM_LOGPROB_BOUND,
            "near_tie_frames": int((~clear).sum()), "text": text,
            "launches": counts}


def stream_clips(corpus):
    """The test split's clips, longest first: (path, samples)."""
    from pg_asr_tpu_torch.data import load_manifest
    from pg_asr_tpu_torch.data.audio import load_audio

    clips = [(u.audio_path, load_audio(u.audio_path)[0])
             for u in load_manifest(os.path.join(corpus, "test.tsv"),
                                    os.path.join(corpus, "clips"))]
    return sorted(clips, key=lambda c: -len(c[1]))


def chunk_times(st, audio, block: int):
    """Push audio in blocks of `block` samples and flush, timing each
    chunk step on the host clock (each ends with its ids on the host) ->
    (text, [ms per chunk], wall s)."""
    times = []
    run = st._run_chunk

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = run(*args, **kw)
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    st._run_chunk = timed
    t0 = time.perf_counter()
    text = "".join(st.push(audio[i:i + block])
                   for i in range(0, len(audio), block)) + st.flush()
    wall = time.perf_counter() - t0
    del st._run_chunk
    return text, times, wall


# torch.profiler on the H100 (CUPTI) drops kernel records at both ends of
# a trace while it keeps their launch records: a trace's first few
# launches (more often the longer the process has run) and, in long
# traces, thousands of its last ones. Each trace therefore opens with
# PROFILE_PAD spin kernels and closes with PROFILE_TAIL, which take the
# loss, and is refused unless every launch of fn has its kernel record
# (taken again up to PROFILE_TRIES times where fn may run twice)
PROFILE_PAD, PROFILE_TAIL, PROFILE_TRIES = 1024, 16384, 3


def device_trace(fn, reps: int = 1, warm: bool = True,
                 again: bool = True) -> tuple[list, float]:
    """The device records (kernels and copies) of `reps` calls of fn in one
    torch.profiler trace, as (name, ms) pairs, and the calls' host wall ms.
    warm: one untimed call first; again: fn may be called again, so a trace
    that lost a kernel record is taken anew (else it fails at once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    if warm:
        fn()
    for _ in range(PROFILE_TRIES if again else 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            for _ in range(PROFILE_TAIL):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        # the trace's raw events: parsing them into FunctionEvents takes
        # seconds for the pads' ~17 K records
        events = prof.profiler.kineto_results.events()
        launches = sum(e.device_type() != cuda and ("LaunchKernel" in e.name()
                                                    or "cuLaunch" in e.name())
                       for e in events) - PROFILE_PAD - PROFILE_TAIL
        records = [(e.name(), e.duration_ns() / 1e6) for e in events
                   if e.device_type() == cuda
                   and "spin_kernel" not in e.name()]
        kernels = sum(not n.startswith(("Memcpy", "Memset"))
                      for n, _ in records)
        if kernels == launches:
            return records, wall
    check(False, f"the profiler lost kernel records: {kernels} of "
          f"{launches} launches traced")


def device_busy(fn, again: bool = True) -> tuple[float, float, int]:
    """(device busy ms, host wall ms, device operations) of one call of fn:
    the kernels' and copies' time and count from a torch.profiler trace,
    the wall on the host clock. No warm-up call: fn may hold state (a
    stream's push; then again=False)."""
    records, wall = device_trace(fn, warm=False, again=again)
    busy = sum(ms for _, ms in records)
    check(busy > 0, "the profiler saw no kernel time")
    return busy, wall, len(records)


def _pcts(times):
    import numpy as np

    return {"p50_ms": float(np.percentile(times, 50)),
            "p95_ms": float(np.percentile(times, 95)), "n": len(times)}


def phase_stream(dev, corpus, alphabet, ctc_dir, random_dir, conformer_dir,
                 bpe_corpus, bpe_dir):
    """13. Streaming transcription (serving.py) at the full width of
    Config(): the kernels at the window's shapes; the streamed BiLSTM-CTC
    (phase 5's) and conformer (phase 7's, flash attention) against their
    offline forward; --mode stream through the CLI; the batched
    transcriber at S=8 against single streams; the launches per chunk;
    per-chunk times, the real-time factor and the device's idle share."""
    import json as _json

    import numpy as np

    from pg_asr_tpu_torch import serving
    from pg_asr_tpu_torch.config import Config
    from pg_asr_tpu_torch.predict import load_model

    t_start = time.perf_counter()
    inf = "lstm_fwd"
    result, out_counts = {}, {}
    result["lstm_fwd_cases"] = stream_lstm_cases(dev)
    result["flash_attn_cases"] = stream_flash_cases(dev)
    clips = stream_clips(corpus)
    path, wave = clips[0]
    sr, hop = Config().features.sample_rate, Config().features.hop_length

    # offline equality on the longest test clip
    result["offline"] = {}
    for key, mdir, attention in (("ctc", ctc_dir, False),
                                 ("conformer", conformer_dir, True)):
        r = stream_vs_offline(dev, alphabet, mdir, wave, attention)
        layers = 6 if attention else 3
        want = ({"flash_attn": layers * r["chunks"]} if attention
                else {inf: layers * r["chunks"]})
        check(r["launches"] == {**dict.fromkeys(r["launches"], 0), **want},
              f"streamed {key}: launches {r['launches']}, expected {want}")
        result["offline"][key] = r
        out_counts[f"stream_offline_{key}"] = r["launches"]
        print(f"[stream] {key} on a {len(wave) / sr:.2f} s test clip "
              f"({r['frames']} frames, {r['chunks']} chunks of "
              f"{STREAM_C}, fixed norm, lookahead to the end): log-probs vs "
              f"the offline forward max abs err {r['max_abs_err']:.3e} "
              f"(bound {STREAM_LOGPROB_BOUND:.0e}), ids equal "
              f"({r['near_tie_frames']} near-tie frames exempt); launches "
              f"{want} ({layers} a chunk)")

    # --mode stream through the CLI: phase 5's model, random weights, BPE
    result["cli"] = {}
    n_frames = len(wave) // hop + 1
    n_chunks = -(-n_frames // STREAM_C)
    for key, cdir, mdir in (("ctc", corpus, ctc_dir),
                            ("ctc_random", corpus, random_dir),
                            ("bpe", bpe_corpus, bpe_dir)):
        base = ["--mode", "stream", "--corpus_path", cdir, "--model_path",
                mdir, "--wav", path, "--device", str(dev)]
        reset_counts()
        rc, out = run_cli(base)
        counts = all_counts()
        check(rc == 0 and out.endswith("\n"), f"stream CLI {key}: rc {rc}")
        check(counts == {**dict.fromkeys(counts, 0), inf: 3 * n_chunks},
              f"stream CLI {key}: launches {counts}, expected "
              f"{3 * n_chunks} lstm_fwd")
        out_counts[f"stream_cli_{key}"] = counts
        rc, out_ts = run_cli([*base, "--timestamps"])
        lines = out_ts.splitlines()
        words = [_json.loads(ln) for ln in lines[1:]]
        check(rc == 0 and lines[0] == out.splitlines()[0],
              f"stream CLI {key} --timestamps: rc {rc}, another text")
        check([w["word"] for w in words] == lines[0].split()
              and all(0 <= w["start"] < w["end"] for w in words),
              f"stream CLI {key}: words {words[:3]} vs {lines[0]!r}")
        result["cli"][key] = {"text": lines[0], "words": len(words)}
        print(f"[stream] --mode stream {key}: {len(lines[0])} characters, "
              f"{len(words)} JSON words with --timestamps; {3 * n_chunks} "
              f"lstm_fwd launches ({n_chunks} chunks)")
    check(any(r["words"] for r in result["cli"].values()),
          "no model printed a word")

    # the batched transcriber at S=8, staggered, against single streams
    result["batched"] = {}
    eight = clips[:8]
    for key, mdir in (("ctc", ctc_dir), ("ctc_random", random_dir)):
        params, cfg = load_model(mdir, alphabet, device=dev)
        single = []
        for _, w in eight:
            st = serving.StreamingTranscriber(params, cfg, alphabet,
                                              device=dev)
            single.append(st.push(w) + st.flush())
        srv = serving.BatchedStreamingTranscriber(params, cfg, alphabet,
                                                  slots=8, device=dev)
        ticks = []

        def counted(work, run=srv._run):
            if work:  # a tick with no ready slot runs nothing
                ticks.append(len(work))
            return run(work)

        srv._run = counted
        reset_counts()
        slot, cursor, texts = {}, {}, {}
        block, rnd = sr // 2, 0
        while len(texts) < len(eight):
            if rnd < len(eight):  # one stream opens a round
                slot[rnd], cursor[rnd] = srv.open(), 0
            for k in sorted(cursor):
                srv.push(slot[k], eight[k][1][cursor[k]:cursor[k] + block])
                cursor[k] += block
            srv.step()
            for k in sorted(cursor):
                if cursor[k] >= len(eight[k][1]):
                    srv.flush(slot[k])
                    texts[k] = srv.text(slot[k])
                    srv.close(slot[k])
                    del cursor[k]
            rnd += 1
        counts = all_counts()
        got = [texts[k] for k in range(len(eight))]
        check(got == single, f"batched {key}: {got} vs single {single}")
        check(counts == {**dict.fromkeys(counts, 0), inf: 3 * len(ticks)},
              f"batched {key}: launches {counts} for {len(ticks)} ticks")
        out_counts[f"stream_batched_s8_{key}"] = counts
        result["batched"][key] = {"ticks": len(ticks),
                                  "rows_per_tick": ticks,
                                  "chars": sum(map(len, got))}
        print(f"[stream] batched S=8 {key}: 8 clips opened one a round and "
              f"closed as they end, every slot's text equal to its single "
              f"stream ({sum(map(len, got))} characters); {len(ticks)} "
              f"ticks (rows {ticks}), 3 lstm_fwd launches each")
    check(any(r["chars"] for r in result["batched"].values()),
          "the batched runs emitted nothing")

    # timing: a STREAM_TIMING_S stream of test clips in 100 ms blocks;
    # the profiler over STREAM_PROFILED chunks (or ticks) after it
    audio = np.concatenate([w for _, w in clips])[:STREAM_TIMING_S * sr]
    secs = len(audio) / sr
    chunk_s = STREAM_C * hop / sr
    timing = {}
    p_ctc, c_ctc = load_model(ctc_dir, alphabet, device=dev)
    p_conf, c_conf = load_model(conformer_dir, alphabet, device=dev)
    runs = {"greedy": (p_ctc, c_ctc, {}),
            "beam_k8": (p_ctc, c_ctc, {"decoder": "beam", "beam_size": 8}),
            "conformer_left512": (p_conf, c_conf, {"left_context": 512})}
    for key, (p, c, kw) in runs.items():
        st = serving.StreamingTranscriber(p, c, alphabet, device=dev, **kw)
        chunk_times(st, audio[:2 * sr], sr // 10)  # warm-up
        st.reset()
        _, times, wall = chunk_times(st, audio, sr // 10)
        # the profiled chunks: the stream's next ones, mid-stream
        st.reset()
        st.push(audio[:4 * sr])
        f0 = st._frames_done
        busy, bwall, _ = device_busy(lambda: st.push(
            audio[4 * sr:4 * sr + STREAM_PROFILED * STREAM_C * hop]),
            again=False)
        n_prof = (st._frames_done - f0) // STREAM_C
        check(n_prof == STREAM_PROFILED, f"{n_prof} chunks profiled")
        timing[key] = {**_pcts(times), "rtf": secs / wall,
                       "device_busy_ms_per_chunk": busy / n_prof,
                       "idle_share": 1 - busy / bwall}
        t = timing[key]
        print(f"[stream] {key} C={STREAM_C} R={STREAM_R} on {secs:.1f} s: "
              f"chunk p50 {t['p50_ms']:.2f} ms p95 {t['p95_ms']:.2f} ms "
              f"(host clock, {t['n']} chunks of {chunk_s:.2f} s audio), "
              f"real-time factor {t['rtf']:.1f} (audio s per wall s); "
              f"device busy {t['device_busy_ms_per_chunk']:.3f} ms a chunk "
              f"over {n_prof} chunks (profiler), idle share "
              f"{t['idle_share']:.3f}")
    for S in (8, 32):
        srv = serving.BatchedStreamingTranscriber(p_ctc, c_ctc, alphabet,
                                                  slots=S, device=dev)
        slots = [srv.open() for _ in range(S)]
        for k, s_ in enumerate(slots):  # each slot its own offset
            srv.push(s_, np.roll(audio, k * sr // 3))
        srv.step()  # warm-up
        times = []
        # the stream's ticks but the warm-up's, the profiled ones and the
        # last, whose window runs past the audio
        for _ in range(STREAM_TIMING_S * sr // (STREAM_C * hop)
                       - 2 - STREAM_PROFILED):
            t0 = time.perf_counter()
            check(len(srv.step()) == S, "a tick without every slot")
            times.append((time.perf_counter() - t0) * 1e3)
        busy, bwall, _ = device_busy(lambda: [
            check(len(srv.step()) == S, "a profiled tick without every slot")
            for _ in range(STREAM_PROFILED)], again=False)
        timing[f"batched_s{S}"] = {
            **_pcts(times),
            "rtf": S * chunk_s * len(times) / (sum(times) / 1e3),
            "device_busy_ms_per_tick": busy / STREAM_PROFILED,
            "idle_share": 1 - busy / bwall}
        t = timing[f"batched_s{S}"]
        print(f"[stream] batched greedy S={S}: tick p50 {t['p50_ms']:.2f} "
              f"ms p95 {t['p95_ms']:.2f} ms ({t['n']} ticks, {S} x "
              f"{chunk_s:.2f} s of audio each), real-time factor "
              f"{t['rtf']:.1f} (all streams' audio s per wall s of the "
              f"ticks); device busy {t['device_busy_ms_per_tick']:.3f} ms a "
              f"tick over {STREAM_PROFILED} ticks (profiler), idle share "
              f"{t['idle_share']:.3f}")
    result["timing"] = timing
    result["wall_s"] = time.perf_counter() - t_start
    print(f"[stream] phase 13 wall time {result['wall_s']:.1f} s")
    return {"launches": out_counts, **result}


# phase 14: the attention seq2seq family at its full default width. The
# decoder's teacher-forced recurrence at the train step's shape: 64
# utterances of 60 labels (5 s of read English), Seq2SeqConfig()'s embed
# 128 and LSTM 512
S2S_TD, S2S_E, S2S_H = 60, 128, 512
# the same recurrence through the two routes (LSTMScan: lstm_fwd's
# residual form + lstm_bwd; ops/lstm.lstm_scan_xla: the JAX scan's
# numerics, a Python loop of small ops) in float32: the same function in
# float32 sums of another order, max abs error of the outputs
S2S_ROUTE_BOUND = 1e-5
# MWER's n-best width in phase 14's steps
S2S_MWER_K = 4
# a beam hypothesis's normalized score against its teacher-forced
# re-scoring, relative: float32 sums over up to 256 steps of a score near
# -900 round by at most ~1e-5 of it
S2S_RESCORE_REL = 1e-4


def phase_seq2seq(dev, corpus, alphabet, d):
    """14. The attention seq2seq (models/seq2seq.py) at its full default
    width (encoder 80 -> 512, 3 x BiLSTM 256; decoder embed 128, LSTM 512,
    dot attention, output 1024 -> 28), random weights from a seed: one
    epoch of `--mode train --model seq2seq` through the CLI, `--mode
    predict` greedy and beam, `--mode finetune_pg` SCST and MWER (K=4),
    each with its launch counts; the decoder route (LSTMScan against
    lstm_scan_xla, in turns) and lstm_fwd / lstm_bwd at the decoder's shape
    against their plain versions; one batch's loss and gradients, kernel
    vs plain path; the train, SCST and MWER steps at B=64 x 5 s and greedy
    and beam transcription of a batch of 32, each timed with its device
    busy time and idle share."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from pg_asr_tpu_torch.checkpoint import save_model
    from pg_asr_tpu_torch.config import Config, fit_vocab
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.models import seq2seq
    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.ops.features import extract_features
    from pg_asr_tpu_torch.ops.lstm import LSTMScan, lstm_scan_xla
    from pg_asr_tpu_torch.predict import (forward_seq2seq,
                                          forward_seq2seq_beam, load_model)
    from pg_asr_tpu_torch.rl import reinforce as rl
    from pg_asr_tpu_torch.train import (AdamW, batch_to_device,
                                        loss_and_grads, value_and_grad)

    t_start = time.perf_counter()
    bs = 32  # the CLI's default
    clips = os.path.join(corpus, "clips")
    sizes = {s: len(load_manifest(os.path.join(corpus, f"{s}.tsv"), clips))
             for s in ("train", "dev", "test")}
    steps, n_dev, n_test = (-(-sizes[s] // bs)
                            for s in ("train", "dev", "test"))
    n_beam = -(-sizes["test"] // 128)  # the CLI's beam batch
    L = Config().model.num_layers
    model_dir = os.path.join(d, "seq2seq")
    out_counts = {}
    result = {"launches": out_counts}

    def expect(**kw):
        return {**dict.fromkeys(all_counts(), 0), **kw}

    def step_launches(k, passes=1):
        """k train or PG steps: the encoder's residual bilstm_fwd and
        bilstm_bwd per layer, `passes` teacher-forced decoder passes
        (lstm_fwd residual + lstm_bwd each)."""
        return {"bilstm_fwd_residual": L * k, "bilstm_bwd": L * k,
                "lstm_fwd_residual": passes * k, "lstm_bwd": passes * k}

    def predicted_rows(mdir, out, key):
        """predicted.txt's rows checked; -> the count of non-empty
        transcripts."""
        with open(os.path.join(mdir, "predicted.txt")) as fo:
            rows = fo.read().splitlines()
        check("CER:" in out and len(rows) == sizes["test"]
              and all("|" in r for r in rows),
              f"seq2seq {key}: predicted.txt has {len(rows)} rows")
        return sum(bool(r.split("|", 1)[1]) for r in rows)

    def cli_run(key, argv, want):
        reset_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(argv + ["--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_counts()
        print(f"[seq2seq] {key}: rc={rc} in {wall:.2f} s (host clock, "
              f"includes WAV decode); launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        check(rc == 0, f"seq2seq {key} failed")
        check(counts == want, f"seq2seq {key}: launches {counts}, "
              f"expected {want}")
        out_counts[f"seq2seq_{key}"] = counts
        return out, wall

    # 1. one epoch through the CLI (dev: the teacher-forced loss, one
    # lstm_fwd inference launch a batch), then predict, greedy and beam
    out, wall = cli_run("train", [
        "--mode", "train", "--corpus_path", corpus, "--model_path",
        model_dir, "--model", "seq2seq", "--num_epochs", "1", "--seed",
        str(SEED)], expect(**step_launches(steps), bilstm_fwd=L * n_dev,
                           lstm_fwd=n_dev))
    tl = np.load(os.path.join(model_dir, "train_loss.npy"))
    vl = np.load(os.path.join(model_dir, "val_losses.npy"))
    check(tl.shape == vl.shape == (1,) and np.isfinite(tl).all()
          and np.isfinite(vl).all(), f"seq2seq losses {tl} {vl}")
    result["train_epoch"] = {"wall_s": wall, "train_loss": float(tl[0]),
                             "val_loss": float(vl[0])}
    for key, extra, batches in (("predict_greedy", [], n_test),
                                ("predict_beam", ["--decoder", "beam"],
                                 n_beam)):
        out, wall = cli_run(key, ["--mode", "predict", "--corpus_path",
                                  corpus, "--model_path", model_dir, *extra],
                            expect(bilstm_fwd=L * batches))
        result[key] = {"wall_s": wall,
                       "nonempty": predicted_rows(model_dir, out, key)}
    # random weights emit text greedily (one epoch may not), so the
    # transcripts' checks are not vacuous. The beam's length penalty
    # favours the EOS-first hypothesis of a near-uniform model, so the
    # beam runs on random weights with the EOS logit's bias lowered by
    # 30: no hypothesis ends, and every best one is max_label_len long
    cfg0 = fit_vocab(Config().replace(model=dataclasses.replace(
        Config().model, family="seq2seq")), alphabet.size)
    p0 = seq2seq.init_params(cfg0.model, cfg0.seq2seq,
                             torch.Generator().manual_seed(SEED))
    random_dir = os.path.join(d, "seq2seq_random")
    save_model(random_dir, p0, cfg0)
    no_eos_dir = os.path.join(d, "seq2seq_random_no_eos")
    p0["output.b"][0] -= 30.0
    save_model(no_eos_dir, p0, cfg0)
    for key, mdir, extra, batches in (
            ("predict_greedy_random", random_dir, [], n_test),
            ("predict_beam_random_no_eos", no_eos_dir,
             ["--decoder", "beam"], n_beam)):
        out, wall = cli_run(key, ["--mode", "predict", "--corpus_path",
                                  corpus, "--model_path", mdir, *extra],
                            expect(bilstm_fwd=L * batches))
        nonempty = predicted_rows(mdir, out, key)
        check(nonempty > 0, f"seq2seq {key}: no text")
        result[key] = {"wall_s": wall, "nonempty": nonempty}

    # 2. finetune_pg through the CLI: SCST (greedy baseline) and MWER, 3
    # steps each and a dev CER at the end (greedy: bilstm_fwd only)
    for key, extra, passes in (("finetune_pg_scst", [], 1),
                               ("finetune_pg_mwer", [
                                   "--pg_objective", "mwer", "--mwer_beam",
                                   "4"], 2)):
        pg_dir = os.path.join(d, key)
        shutil.copytree(model_dir, pg_dir)
        out, wall = cli_run(key, [
            "--mode", "finetune_pg", "--corpus_path", corpus,
            "--model_path", pg_dir, "--pg_steps", "3", "--pg_eval_every",
            "3", *extra], expect(**step_launches(3, passes),
                                 bilstm_fwd=L * n_dev))
        r = np.load(os.path.join(pg_dir, "pg_rewards.npy"))
        cer = np.load(os.path.join(pg_dir, "pg_dev_cer.npy"))
        check(r.shape == (3,) and np.isfinite(r).all() and cer.shape == (1, 2)
              and np.isfinite(cer).all(), f"seq2seq {key}: {r} {cer}")
        result[key] = {"wall_s": wall, "rewards": r.tolist(),
                       "dev_cer": float(cer[0, 1])}

    # 3. the decoder route: LSTMScan (1 + 3 launches) vs lstm_scan_xla, the
    # projection, the recurrence and its gradient at B=64, Td=60, I=128,
    # H=512, in turns; then the kernels at that shape vs their plain
    # versions
    route = {}
    g_ = torch.Generator().manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        x = torch.randn(B, S2S_TD, S2S_E, generator=g_).to(dev, dtype)
        W = ((torch.rand(S2S_E, 4 * S2S_H, generator=g_) * 2 - 1)
             / math.sqrt(S2S_H)).to(dev, dtype)
        U = ((torch.rand(S2S_H, 4 * S2S_H, generator=g_) * 2 - 1)
             / math.sqrt(S2S_H)).to(dev, dtype)
        bias = torch.zeros(4 * S2S_H, device=dev, dtype=dtype)
        gy = torch.randn(B, S2S_TD, S2S_H, generator=g_).to(dev, dtype)
        ones = torch.ones(B, S2S_TD, device=dev, dtype=dtype)
        leaves = [t.requires_grad_(True) for t in (x, W, U, bias)]

        def through(recurrence):
            def run():
                y = recurrence(x @ W + bias)
                return y, torch.autograd.grad(y, leaves, gy)
            return run

        kern = through(lambda xp: LSTMScan.apply(xp, U, ones, False, True))
        xla = through(lambda xp: lstm_scan_xla(xp, U, ones))
        c0 = (cuda_lstm.RES_LAUNCHES, cuda_lstm.BWD_LAUNCHES)
        y_k, _ = kern()
        torch.cuda.synchronize()
        check((cuda_lstm.RES_LAUNCHES, cuda_lstm.BWD_LAUNCHES)
              == (c0[0] + 1, c0[1] + 1), "the decoder route's launches")
        y_x, _ = xla()
        err = (y_k.float() - y_x.float()).abs().max().item()
        if dtype == torch.float32:
            check(err <= S2S_ROUTE_BOUND, f"decoder route: LSTMScan vs "
                  f"lstm_scan_xla max abs err {err}")
        k_ms, x_ms = in_turns(xla, kern, 3, 10)
        route[name] = {"lstm_scan_kernels_ms": k_ms, "lstm_scan_xla_ms": x_ms,
                       "max_abs_diff": err}
        print(f"[seq2seq] decoder route B={B} Td={S2S_TD} I={S2S_E} "
              f"H={S2S_H} {name}, projection + recurrence + gradient: "
              f"LSTMScan (lstm_fwd residual + lstm_bwd) {k_ms:.3f} ms, "
              f"lstm_scan_xla {x_ms:.3f} ms, in turns (outputs differ by "
              f"{err:.2e})")
    result["decoder_route"] = route
    # the teacher-forced pass over B rows, and MWER's re-scoring of the
    # n-best over B x K rows (a plan of more rows and clusters)
    result["lstm_cases"] = [
        lstm_shape_case(dev, dtype, S2S_H, torch.full((rows,), S2S_TD), g_,
                        "seq2seq", note)
        for rows, note in ((B, "(the decoder's teacher-forced pass)"),
                           (B * S2S_MWER_K, "(MWER's n-best re-scored)"))
        for dtype in (torch.float32, torch.bfloat16)]

    # 4. one train batch of 8, kernel vs plain path (float32, dropout 0)
    params, cfg = load_model(model_dir, alphabet, device=dev)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0))
    utts = load_manifest(os.path.join(corpus, "train.tsv"), clips)
    batch = next(iter(BatchIterator(utts[:8], alphabet, 8, shuffle=False)))
    arrays = batch_to_device(batch, dev)
    loss_k, g_k = loss_and_grads(params, arrays, cfg)
    loss_p, g_p = loss_and_grads(params, arrays, cfg, use_kernel=False)
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_rel = {k: ((g_k[k] - g_p[k]).abs().max()
                    / g_p[k].abs().max().clamp(min=1e-30)).item()
                for k in g_p}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"[seq2seq] one batch {tuple(batch.wave.shape)}, kernel vs plain "
          f"path (float32, dropout 0): loss {loss_k.item():.6f} vs "
          f"{loss_p.item():.6f} (rel {loss_rel:.2e}, bound "
          f"{TRAIN_LOSS_REL:.0e}); {len(grad_rel)} gradients, worst "
          f"max|diff|/max|grad| {grad_rel[worst]:.2e} ({worst}; bound "
          f"{TRAIN_GRAD_REL:.0e})")
    check(math.isfinite(loss_k.item()) and loss_rel <= TRAIN_LOSS_REL,
          f"seq2seq loss disagrees: {loss_k.item()} vs {loss_p.item()}")
    check(all(math.isfinite(v) and v <= TRAIN_GRAD_REL
              for v in grad_rel.values()),
          f"seq2seq gradients disagree: {grad_rel}")
    result["compare"] = {"loss_rel": loss_rel,
                         "grad_rel_worst": grad_rel[worst]}

    # 5. one SCST and one MWER (K=4) step's loss and gradients at B=64 x
    # 5 s, kernel vs plain path (float32): the plain pass replays the
    # kernel pass's draws, greedy baseline and n-best, so that both score
    # the same hypotheses
    arrays64 = flagship_batch(dev, vocab=alphabet.size)
    space = alphabet.char2ind.get(" ", -1)
    p32, c32 = load_model(model_dir, alphabet, device=dev)
    for objective in ("reinforce", "mwer"):
        c_o = c32.replace(rl=dataclasses.replace(
            c32.rl, objective=objective, mwer_beam=S2S_MWER_K,
            space_id=space))
        got, recs = {}, ([], [], [])
        names = ("draw_tokens", "greedy_from_encoder",
                 "beam_scan_from_encoder")
        for use_kernel in (True, False):
            hooks = (recorded if use_kernel else replayed)
            with contextlib.ExitStack() as stack:
                for name, rec in zip(names, recs):
                    stack.enter_context(hooks(seq2seq, name, rec))
                (loss, _), grads = value_and_grad(
                    lambda p: rl.pg_loss_fn(
                        p, *arrays64, torch.Generator(device=dev).manual_seed(
                            SEED), c_o, use_kernel), p32)
            got[use_kernel] = loss.item(), grads
        (loss_k, g_k), (loss_p, g_p) = got[True], got[False]
        loss_rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-6)
        grad_rel = {k: ((g_k[k] - g_p[k]).abs().max()
                        / g_p[k].abs().max().clamp(min=1e-30)).item()
                    for k in g_p}
        worst = max(grad_rel, key=grad_rel.get)
        key = "scst" if objective == "reinforce" else f"mwer K={S2S_MWER_K}"
        print(f"[seq2seq] {key} step B={B} x 5 s, kernel vs plain path "
              f"(float32, the same draws, baseline and n-best; "
              f"{[len(r) for r in recs]} calls replayed): loss "
              f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}, bound "
              f"{PG_LOSS_REL:.0e}); {len(grad_rel)} gradients, worst "
              f"max|diff|/max|grad| {grad_rel[worst]:.2e} ({worst}; bound "
              f"{PG_GRAD_REL:.0e})")
        check(math.isfinite(loss_k) and loss_rel <= PG_LOSS_REL,
              f"seq2seq {key}: loss disagrees: {loss_k} vs {loss_p}")
        check(all(math.isfinite(v) and v <= PG_GRAD_REL
                  for v in grad_rel.values()),
              f"seq2seq {key}: gradients disagree: {grad_rel}")
        result["compare"][objective] = {"loss_rel": loss_rel,
                                  "grad_rel_worst": grad_rel[worst]}

    # 6. the train, SCST and MWER steps at B=64 x 5 s (labels of 60)
    timing = {}

    def timed(key, run, want):
        reset_counts()
        run()
        torch.cuda.synchronize()
        counts = all_counts()
        check(counts == want, f"seq2seq {key}: launches {counts}")
        ms = time_ms(run, 3)
        groups = device_breakdown(run, 2, PG_GROUPS, pg_group)
        dev_ms = sum(groups.values())
        timing[key] = {"ms": ms, "device_ms": dev_ms,
                       "idle": 1 - dev_ms / ms, "groups": groups,
                       "launches": {k: v for k, v in counts.items() if v}}
        print(f"[seq2seq] {key} B={B} x 5 s (T={T}, labels {S2S_TD}): "
              f"{ms:.2f} ms; device {dev_ms:.2f} ms "
              f"({1 - dev_ms / ms:.0%} idle): "
              + ", ".join(f"{k} {v:.2f}" for k, v in groups.items()))

    for dtype in ("float32", "bfloat16"):
        p_d, c_d = load_model(model_dir, alphabet, device=dev, dtype=dtype)
        opt = AdamW(c_d, p_d)
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def train_step():
            _, grads = loss_and_grads(p_d, arrays64, c_d, gen)
            opt.update(p_d, grads)

        timed(f"train_step_{dtype}", train_step, expect(**step_launches(1)))
    for objective, passes in (("reinforce", 1), ("mwer", 2)):
        c_o = c32.replace(rl=dataclasses.replace(
            c32.rl, objective=objective, mwer_beam=S2S_MWER_K,
            space_id=space))
        opt = AdamW(c_o, p32, learning_rate=c_o.train.learning_rate * 0.1,
                    weight_decay=1e-4)
        pg_step = rl.make_pg_step(c_o, opt)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        timed("scst_step" if objective == "reinforce" else "mwer_step",
              lambda: pg_step(p32, gen, *arrays64),
              expect(**step_launches(1, passes)))

    # 7. greedy and beam (K=16) transcription of one test batch of 32 over
    # decode.max_label_len steps by the trained model: host ms, device busy
    # time, launches
    p32, c32 = load_model(model_dir, alphabet, device=dev)
    test = load_manifest(os.path.join(corpus, "test.tsv"), clips)
    tb = next(iter(BatchIterator(test, alphabet, bs, shuffle=False)))
    wave, ns = (torch.from_numpy(a).to(dev) for a in (tb.wave,
                                                      tb.num_samples))
    for key, fn in (
            ("greedy_batch", lambda: seq2seq.cut_at_eos(forward_seq2seq(
                p32, wave, ns, c32)[0])),
            ("beam_batch", lambda: forward_seq2seq_beam(
                p32, wave, ns, c32, beam_size=c32.decode.beam_size))):
        reset_counts()
        labels, lens = fn()
        torch.cuda.synchronize()
        counts = all_counts()
        check(counts == expect(bilstm_fwd=L), f"seq2seq {key}: {counts}")
        check(labels.shape[0] == tb.size and bool((lens >= 0).all()),
              f"seq2seq {key}: lens {lens}")
        ms = host_ms(fn, 3)
        busy, wall, _ = device_busy(fn)
        timing[key] = {"host_ms": ms, "device_ms": busy,
                       "idle": 1 - busy / wall, "mean_len": lens.float()
                       .mean().item(),
                       "launches": {k: v for k, v in counts.items() if v}}
        ids, freq = labels[labels > 0].unique(return_counts=True)
        top = [(alphabet.piece(int(i)), int(n)) for n, i in sorted(
            zip(freq.tolist(), ids.tolist()), reverse=True)[:3]]
        timing[key]["top_tokens"] = top
        print(f"[seq2seq] {key} ({tb.size} utterances of 1-5 s, "
              f"{c32.decode.max_label_len} steps): {ms:.2f} ms host; "
              f"device busy {busy:.2f} of {wall:.2f} ms "
              f"({1 - busy / wall:.0%} idle); mean length "
              f"{timing[key]['mean_len']:.1f}, most emitted {top}")
    result["timing"] = timing

    # 8. the full-width beam (K=16, A=28) on random weights, whose n-best
    # holds the EOS-first hypothesis, others that end early and long
    # ones: every live hypothesis re-scored by the teacher-forced decoder
    # (plain path, B x K rows) must carry the beam's normalized score,
    # which holds the top-K, parent gather and buffer path to the tokens
    # it returns
    p_r, c_r = load_model(random_dir, alphabet, device=dev)
    K = c_r.decode.beam_size
    with torch.inference_mode():
        feats, fmask, _ = extract_features(wave, ns, c_r.features)
        enc = seq2seq.encode(p_r, feats, fmask, c_r.model)
        buf, lens, normed = seq2seq.beam_scan_from_encoder(
            p_r, enc, fmask, K, c_r.decode.max_label_len)
        flat, flen = buf.reshape(-1, buf.shape[-1]), lens.reshape(-1)
        lp = seq2seq.decode_teacher_forced(p_r, enc, fmask, flat,
                                           use_kernel=False)
        raw = rl._hyp_log_lik_seq2seq(lp, flat, flen).reshape(lens.shape)
        penalty = ((5.0 + lens.float()) / 6.0) ** 0.6
        live = normed > -1e29
        rel = ((raw / penalty - normed).abs() / normed.abs())[live].max()
    full = c_r.decode.max_label_len
    kinds = {"live": int(live.sum()),
             "empty": int((live & (lens == 0)).sum()),
             "ended_early": int((live & (lens > 0) & (lens < full)).sum()),
             "full_length": int((live & (lens == full)).sum())}
    print(f"[seq2seq] beam on random weights (B={tb.size}, K={K}): "
          f"n-best {kinds} re-scored, max rel diff {rel.item():.2e} "
          f"(bound {S2S_RESCORE_REL:.0e})")
    check(rel.item() <= S2S_RESCORE_REL, f"seq2seq beam scores {rel}")
    check(kinds["ended_early"] + kinds["full_length"] > 0,
          "seq2seq beam on random weights: no non-empty hypothesis")
    result["beam_random"] = {"rescore_rel": rel.item(), **kinds}
    result["wall_s"] = time.perf_counter() - t_start
    print(f"[seq2seq] phase wall time {result['wall_s']:.1f} s")
    return result


# phase 15: LM fusion. The fused search on the card against the same
# search on the CPU, relative on nll: both run the same float32 operations
# (the fused key's multiply-adds through float64 in both) but expf, log1pf
# and logf of nvcc's and of the CPU's libraries, and in the neural LM's
# products float32 sums in other orders, ~1e-6 of an LM score
LM_NLL_REL = 1e-5
# the fusion coefficients of the card runs: the CLI's --lm_weight, and a
# --length_bonus so that every term of the fused key is exercised
LM_WEIGHT, LM_BONUS = 0.3, 0.2
# the neural LM's training batch (train_neural_lm's defaults: 32
# transcripts of up to 128 units), hidden size (init_lm_params's) and the
# CLI's default --lm_steps
LM_B, LM_T, LM_H, LM_STEPS = 32, 128, 160, 300
# the rescoring pass's rows: the beam's K-best of a batch of 128, each of
# 60 labels (5 s of read English, as the seq2seq decoder's S2S_TD)
LM_RESCORE_T = 60
# the CPU holds the card's searches on the batch's first rows (each row's
# search is its own)
LM_CPU_ROWS = 16
# the streamed beam with and without the LM, in turns (A, B, B, A), each
# turn over LM_STREAM_S s of the test clips
LM_STREAM_S = 6


def phase_lm(dev, corpus, alphabet, d):
    """15. LM fusion at the flagship's width: `--mode predict --decoder
    beam` through the CLI with --lm_order 2 and 3 on phase 5's BiLSTM-CTC
    and 3 on phase 12's BPE model, --lm_type neural (300 steps of LM
    training on the card, then reused) fused and --lm_pass rescore, each
    run's launches exact; the fused searches (n-gram orders 2 and 3,
    neural) on the card against the CPU on phase 3b's inputs, with host
    ms, device busy time, idle share and device operations a batch; the
    teacher-forced LM pass's kernels at the LM's shapes against their plain
    versions and one LM training step kernel vs plain; the rescoring pass
    card vs CPU; `--mode stream --decoder beam --lm_order 3` through the
    CLI, its text equal to the offline fused search's on the streamed
    log-probs, and its chunk times and real-time factor."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from pg_asr_tpu_torch import serving
    from pg_asr_tpu_torch.config import Config
    from pg_asr_tpu_torch.data import load_manifest
    from pg_asr_tpu_torch.decoding import beam, neural_lm
    from pg_asr_tpu_torch.decoding.greedy import ids_to_strings
    from pg_asr_tpu_torch.decoding.lm import lm_from_manifest
    from pg_asr_tpu_torch.decoding.rescore import rescore_nbest
    from pg_asr_tpu_torch.predict import load_model
    from pg_asr_tpu_torch.train import AdamW, value_and_grad

    t_start = time.perf_counter()
    L = Config().model.num_layers
    trained = os.path.join(d, "trained")
    bpe_corpus, bpe_dir = os.path.join(d, "bpe"), os.path.join(d, "bpe_model")
    lm_dir = os.path.join(d, "lm_trained")  # the neural LM's cache lives here
    shutil.copytree(trained, lm_dir)
    clips = os.path.join(corpus, "clips")
    train_utts = load_manifest(os.path.join(corpus, "train.tsv"), clips)
    result, out_counts = {"predict": {}}, {}

    def expect(**kw):
        return {**dict.fromkeys(all_counts(), 0), **kw}

    def n_beam(cdir):  # the CLI's beam batches of 128
        return -(-len(load_manifest(os.path.join(cdir, "test.tsv"))) // 128)

    # 1. --mode predict --decoder beam through the CLI
    t_sec = time.perf_counter()
    nb, nb_bpe = n_beam(corpus), n_beam(bpe_corpus)
    neural = ["--lm_order", "2", "--lm_type", "neural"]
    runs = (
        ("ngram2", corpus, trained, ["--lm_order", "2"],
         expect(bilstm_fwd=L * nb)),
        ("ngram3", corpus, trained, ["--lm_order", "3"],
         expect(bilstm_fwd=L * nb)),
        ("bpe_ngram3", bpe_corpus, bpe_dir, ["--lm_order", "3"],
         expect(bilstm_fwd=L * nb_bpe)),
        ("neural_train", corpus, lm_dir, neural,
         expect(bilstm_fwd=L * nb, lstm_fwd_residual=2 * LM_STEPS,
                lstm_bwd=2 * LM_STEPS)),
        ("neural_reused", corpus, lm_dir, neural, expect(bilstm_fwd=L * nb)),
        ("neural_rescore", corpus, lm_dir, [*neural, "--lm_pass", "rescore"],
         expect(bilstm_fwd=L * nb, ctc_beam=nb, lstm_fwd=2 * nb)))
    for key, cdir, mdir, extra, want in runs:
        reset_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(["--mode", "predict", "--corpus_path", cdir,
                           "--model_path", mdir, "--decoder", "beam",
                           *extra, "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_counts()
        check(rc == 0 and "CER:" in out, f"lm predict {key}: rc {rc}")
        check(counts == want, f"lm predict {key}: launches {counts}, "
              f"expected {want}")
        if key.startswith("neural"):
            said = ("trained (300 steps)" if key == "neural_train"
                    else "reused from")
            check(f"neural LM {said}" in out, f"lm predict {key}: {out}")
        with open(os.path.join(mdir, "predicted.txt")) as fo:
            rows = fo.read().splitlines()
        n_test = len(load_manifest(os.path.join(cdir, "test.tsv")))
        check(len(rows) == n_test and all("|" in r for r in rows),
              f"lm predict {key}: {len(rows)} rows")
        cer = float(out.split("CER: ")[1].split()[0])
        out_counts[f"lm_predict_{key}"] = counts
        result["predict"][key] = {
            "wall_s": wall, "cer": cer,
            "nonempty": sum(bool(r.split("|", 1)[1]) for r in rows),
            "launches": {k: v for k, v in counts.items() if v}}
        print(f"[lm] predict --decoder beam {' '.join(extra)} ({key}): rc 0 "
              f"in {wall:.2f} s (host clock, WAV decode included), CER "
              f"{cer:.4f}, {result['predict'][key]['nonempty']}/{n_test} "
              f"non-empty; launches "
              f"{result['predict'][key]['launches']}")

    predict_s = time.perf_counter() - t_sec

    # 2. the fused searches at the beam's batch (B=128, T=401, A=28, K=16)
    # on phase 3b's inputs, card vs CPU
    lp, fl = beam_inputs(dev)
    tabs = {o: lm_from_manifest(train_utts, alphabet, order=o)
            for o in (2, 3)}
    nlm = neural_lm.load_lm(os.path.join(lm_dir, neural_lm.LM_FILE),
                            alphabet.size, device=dev)
    result["fused"], searches = {}, {}
    rows = slice(0, LM_CPU_ROWS)
    t_sec = time.perf_counter()
    for key, kw in (("ngram2", {"lm": tabs[2]}), ("ngram3", {"lm": tabs[3]}),
                    ("neural", {"neural_lm": nlm})):
        def search(x=lp, f=fl, kw=kw):
            return beam.beam_decode(x, f, beam_size=BEAM_K,
                                    lm_weight=LM_WEIGHT,
                                    length_bonus=LM_BONUS, **kw)

        reset_counts()
        got = search()
        torch.cuda.synchronize()
        counts = all_counts()
        check(counts == expect(), f"fused {key}: launches {counts}")
        t0 = time.perf_counter()
        want = search(lp[rows].cpu(), fl[rows].cpu())
        cpu_ms = (time.perf_counter() - t0) * 1e3
        same = [torch.equal(g[rows].cpu(), w)
                for g, w in zip(got[:2], want[:2])]
        rel = ((got[2][rows].cpu() - want[2]).abs()
               / want[2].abs().clamp(min=1)).max().item()
        check(all(same) and rel <= LM_NLL_REL,
              f"fused {key}: card vs CPU labels/lens equal {same}, nll rel "
              f"{rel} (bound {LM_NLL_REL})")
        searches[key] = search
        # the whole batch in one trace (phase 15's first call warmed it)
        busy, _, ops = device_busy(search)
        result["fused"][key] = {
            "device_busy_ms": busy, "device_ops": ops,
            "ops_per_frame": ops / T, "cpu_ms_rows": cpu_ms,
            "nll_rel_err": rel, "mean_len": got[1].float().mean().item()}
        print(f"[lm] fused {key} B={BEAM_B} T={T} A={BEAM_A} K={BEAM_K} "
              f"(phase 3b's inputs, lm_weight {LM_WEIGHT}, length_bonus "
              f"{LM_BONUS}; mean length {got[1].float().mean():.1f}): no "
              f"kernel launch; rows 0-{LM_CPU_ROWS - 1} equal to the CPU's "
              f"(labels, lens), nll rel err {rel:.2e} (bound "
              f"{LM_NLL_REL:.0e}); device busy {busy:.1f} ms and {ops} "
              f"device operations a batch ({ops / T:.1f} a frame), one "
              f"profiler trace of the whole batch; the CPU's {LM_CPU_ROWS} "
              f"rows {cpu_ms:.0f} ms")
    # host ms a batch, one call each in turns (order 2, 3, neural, neural,
    # 3, 2): the host's clock, which other tenants of the machine move
    times = {k: [] for k in searches}
    for key in [*searches, *reversed(searches)]:
        t0 = time.perf_counter()
        searches[key]()
        torch.cuda.synchronize()
        times[key].append((time.perf_counter() - t0) * 1e3)
    for key, r in result["fused"].items():
        r["host_ms"] = sum(times[key]) / 2
        r["host_ms_turns"] = times[key]
        r["idle"] = 1 - r["device_busy_ms"] / r["host_ms"]
        print(f"[lm] fused {key}: {r['host_ms']:.1f} ms host a batch (turns "
              f"{times[key][0]:.1f}, {times[key][1]:.1f}), "
              f"{r['idle']:.0%} idle")
    result["section_s"] = {"predict": predict_s,
                           "fused": time.perf_counter() - t_sec}

    # 3. the teacher-forced LM pass: the kernels at the LM's shapes against
    # their plain versions (phase 3's bounds), then one LM training step
    t_sec = time.perf_counter()
    g_ = torch.Generator().manual_seed(SEED)
    result["lstm_cases"] = [
        lstm_shape_case(dev, torch.float32, LM_H, torch.full((rows, ), t),
                        g_, "lm", note)
        for rows, t, note in (
            (LM_B, LM_T, "(the LM's training batch)"),
            (BEAM_B * BEAM_K, LM_RESCORE_T, "(the rescoring pass's rows)"))]
    # the first batch train_neural_lm draws: 32 transcripts, padded to the
    # longest of the split
    enc = [alphabet.encode(u.text)[:LM_T] for u in train_utts if u.text]
    pick = np.random.default_rng(0).integers(0, len(enc), LM_B)
    ids = torch.zeros(LM_B, max(map(len, enc)), dtype=torch.long)
    for i, j in enumerate(pick):
        ids[i, :len(enc[j])] = torch.tensor(enc[j])
    lens = torch.tensor([len(enc[j]) for j in pick])
    ids, lens = ids.to(dev), lens.to(dev)

    def lm_loss(p, use_kernel=True):
        return (-neural_lm.lm_sequence_logp(p, ids, lens, use_kernel).sum()
                / lens.sum().clamp(min=1))

    reset_counts()
    loss_k, g_k = value_and_grad(lm_loss, nlm)
    torch.cuda.synchronize()
    counts = all_counts()
    check(counts == expect(lstm_fwd_residual=2, lstm_bwd=2),
          f"LM step: launches {counts}")
    loss_p, g_p = value_and_grad(lambda p: lm_loss(p, False), nlm)
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_rel = {k: ((g_k[k] - g_p[k]).abs().max()
                    / g_p[k].abs().max().clamp(min=1e-30)).item()
                for k in g_p}
    worst = max(grad_rel, key=grad_rel.get)
    check(math.isfinite(loss_k.item()) and loss_rel <= TRAIN_LOSS_REL
          and all(v <= TRAIN_GRAD_REL for v in grad_rel.values()),
          f"LM step kernel vs plain: loss rel {loss_rel}, gradients "
          f"{grad_rel}")
    p_step = {k: v.clone() for k, v in nlm.items()}
    opt = AdamW(Config().replace(train=dataclasses.replace(
        Config().train, grad_clip=math.inf)), p_step, learning_rate=3e-3,
        weight_decay=0.0)

    def lm_step(use_kernel=True):
        _, grads = value_and_grad(lambda p: lm_loss(p, use_kernel), p_step)
        opt.update(p_step, grads)

    step_ms = time_ms(lm_step, 5)
    step_plain_ms = time_ms(lambda: lm_step(False), 2)
    busy, wall, _ = device_busy(lm_step)
    result["train_step"] = {
        "loss_rel": loss_rel, "grad_rel_worst": grad_rel[worst],
        "ms": step_ms, "plain_ms": step_plain_ms, "device_busy_ms": busy,
        "idle": 1 - busy / wall, "T": int(ids.shape[1])}
    print(f"[lm] one LM training step (B={LM_B}, T={ids.shape[1]}, embed "
          f"48, hidden {LM_H}, 2 layers), kernel vs plain path: loss "
          f"{loss_k.item():.6f} vs {loss_p.item():.6f} (rel {loss_rel:.2e}, "
          f"bound {TRAIN_LOSS_REL:.0e}); {len(grad_rel)} gradients, worst "
          f"max|diff|/max|grad| {grad_rel[worst]:.2e} ({worst}; bound "
          f"{TRAIN_GRAD_REL:.0e}); the step (with Adam) {step_ms:.2f} ms "
          f"(plain recurrence {step_plain_ms:.2f} ms), device busy "
          f"{busy:.2f} of {wall:.2f} ms")

    result["section_s"]["teacher_forced"] = time.perf_counter() - t_sec

    # 4. the rescoring pass on phase 3b's inputs, the kernels against the
    # plain path (the plain beam and recurrence) on the card, all B rows
    t_sec = time.perf_counter()

    def rescore(use_kernel=True):
        return rescore_nbest(lp, fl, nlm, beam_size=BEAM_K,
                             lm_weight=LM_WEIGHT, length_bonus=LM_BONUS,
                             use_kernel=use_kernel)

    reset_counts()
    got = rescore()
    torch.cuda.synchronize()
    counts = all_counts()
    check(counts == expect(ctc_beam=1, lstm_fwd=2),
          f"rescore: launches {counts}")
    want = rescore(use_kernel=False)
    check(all_counts() == counts, "rescore's plain path launched a kernel")
    same = [torch.equal(g, w) for g, w in zip(got[:2], want[:2])]
    rel = ((got[2] - want[2]).abs()
           / want[2].abs().clamp(min=1)).max().item()
    check(all(same) and rel <= LM_NLL_REL,
          f"rescore kernels vs plain path: labels/lens equal {same}, score "
          f"rel {rel}")
    ms = host_ms(rescore, 3)
    busy, wall, _ = device_busy(rescore)
    result["rescore"] = {"host_ms": ms, "device_busy_ms": busy,
                         "idle": 1 - busy / wall, "score_rel_err": rel,
                         "rows_T": int(got[1].max())}
    print(f"[lm] rescore B={BEAM_B} T={T} K={BEAM_K} (1 ctc_beam, 2 "
          f"lstm_fwd over {BEAM_B * BEAM_K} rows of {int(got[1].max())} "
          f"labels), kernels vs the plain path on the card: all {BEAM_B} "
          f"rows' labels and lens equal, score rel err "
          f"{rel:.2e}; {ms:.2f} ms host a batch, device busy {busy:.2f} of "
          f"{wall:.2f} ms")

    result["section_s"]["rescore"] = time.perf_counter() - t_sec

    # 5. --mode stream --decoder beam --lm_order 3 through the CLI on the
    # longest test clip: its text is the offline fused search's on the
    # streamed log-probs; then chunk times with and without the LM
    t_sec = time.perf_counter()
    clips = stream_clips(corpus)
    path, wave = clips[0]
    hop, sr = Config().features.hop_length, Config().features.sample_rate
    n_frames = len(wave) // hop + 1
    n_chunks = -(-n_frames // STREAM_C)
    rec = []
    reset_counts()
    with recorded(serving, "_ctc_log_probs", rec):
        rc, out = run_cli(["--mode", "stream", "--corpus_path", corpus,
                           "--model_path", trained, "--wav", path,
                           "--decoder", "beam", "--lm_order", "3",
                           "--device", str(dev)])
    counts = all_counts()
    check(rc == 0 and counts == expect(lstm_fwd=L * n_chunks),
          f"stream --lm_order 3: rc {rc}, launches {counts}")
    lp_s = torch.cat(rec, dim=1)[:, :n_frames]
    labels, lens, _ = beam.beam_decode(
        lp_s, torch.tensor([n_frames], device=dev), beam_size=8,
        max_label_len=Config().decode.max_label_len, lm=tabs[3])
    offline = ids_to_strings(labels, lens, alphabet)[0]
    check(out == offline + "\n", f"stream --lm_order 3: {out!r} vs the "
          f"offline fused search's {offline!r}")
    out_counts["lm_stream_cli"] = counts
    print(f"[lm] --mode stream --decoder beam --lm_order 3 on a "
          f"{len(wave) / sr:.2f} s clip: {L * n_chunks} lstm_fwd launches "
          f"({n_chunks} chunks), text equal to the offline fused search on "
          f"the streamed log-probs ({len(offline)} characters)")
    params, cfg = load_model(trained, alphabet, device=dev)
    audio = np.concatenate([w for _, w in clips])[:LM_STREAM_S * sr]
    kws = {"beam_k8": {}, "beam_k8_lm3": {"lm": tabs[3]}}
    sts = {k: serving.StreamingTranscriber(params, cfg, alphabet, device=dev,
                                           decoder="beam", beam_size=8, **kw)
           for k, kw in kws.items()}
    for st in sts.values():  # warm-up
        chunk_times(st, audio[:sr], sr // 10)
    times, walls = {k: [] for k in sts}, {k: 0.0 for k in sts}
    for key in [*sts, *reversed(sts)]:
        sts[key].reset()
        _, t_, w_ = chunk_times(sts[key], audio, sr // 10)
        times[key] += t_
        walls[key] += w_
    timing = {}
    for key, st in sts.items():
        st.reset()
        st.push(audio[:2 * sr])
        f0 = st._frames_done
        busy, bwall, _ = device_busy(lambda: st.push(
            audio[2 * sr:2 * sr + STREAM_PROFILED * STREAM_C * hop]),
            again=False)
        n_prof = (st._frames_done - f0) // STREAM_C
        check(n_prof == STREAM_PROFILED, f"{n_prof} chunks profiled")
        timing[key] = {**_pcts(times[key]),
                       "rtf": 2 * len(audio) / sr / walls[key],
                       "device_busy_ms_per_chunk": busy / n_prof,
                       "idle_share": 1 - busy / bwall}
        t = timing[key]
        print(f"[lm] stream {key} C={STREAM_C} R={STREAM_R}, two turns of "
              f"{len(audio) / sr:.1f} s (in turns with the other): chunk "
              f"p50 {t['p50_ms']:.2f} ms p95 {t['p95_ms']:.2f} ms (host "
              f"clock, {t['n']} chunks), real-time factor {t['rtf']:.1f}; "
              f"device busy {t['device_busy_ms_per_chunk']:.3f} ms a chunk, "
              f"idle share {t['idle_share']:.3f}")
    result["stream"] = {"text": out.rstrip("\n"), "chunks": n_chunks,
                        "timing": timing}
    result["section_s"]["stream"] = time.perf_counter() - t_sec
    result["wall_s"] = time.perf_counter() - t_start
    print(f"[lm] phase 15 wall time {result['wall_s']:.1f} s (sections, s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in result["section_s"].items())
          + ")")
    return {"launches": out_counts, **result}

EXPORT_B, EXPORT_S = 8, 20.0  # the CLI's --export_batch, --export_seconds
# timed calls a turn (live, exported, exported, live); 1 for a call of
# over 0.5 s (the transducer's frame loop)
EXPORT_REPS = 3


def phase_export(dev, corpus, alphabet, d):
    """16. `--mode export` through the CLI at its defaults (B=8 x 20 s) on
    full-width models with random weights from a seed (the BiLSTM-CTC
    greedy, beam K=16, int8 and cpu,cuda; the conformer with
    flash_attention; the transducer, conformer encoder with
    flash_attention, greedy; the seq2seq greedy): random weights emit text
    in every family, where the earlier phases' one-epoch models emit
    little or none greedily, so that equal ids are a fair bar. Each
    export's seconds, node count, pgasr:: nodes and MB; the artifact
    loaded by ExportedModel on the card, its ids and lens equal to the
    live serving function's on 8 test clips (some labels emitted), its
    kernel launches a call (counts set to
    0 before it: each pgasr node launches its kernel once) equal to the
    live call's, the exported call's ms against the live one's in turns
    (CUDA events), the profiler's device busy time, idle share and device
    operations a call (for calls under 0.5 s); the cpu,cuda artifact also
    loaded on the CPU, its
    ids equal to the card's. A registered op that no export reaches fails
    the phase."""
    import dataclasses

    import numpy as np
    import torch

    from pg_asr_tpu_torch.checkpoint import save_model
    from pg_asr_tpu_torch.config import Config, fit_vocab
    from pg_asr_tpu_torch.data import load_manifest
    from pg_asr_tpu_torch.data.audio import load_audio
    from pg_asr_tpu_torch.exporting import (EXPORT_DIR, ExportedModel,
                                            make_serving_fn)
    from pg_asr_tpu_torch.ops import registry
    from pg_asr_tpu_torch.predict import load_model
    from pg_asr_tpu_torch.train import init_model_params

    t_start = time.perf_counter()
    clips = os.path.join(corpus, "clips")
    utts = load_manifest(os.path.join(corpus, "test.tsv"), clips)[:EXPORT_B]
    n = int(EXPORT_S * 16000)
    wave = np.zeros((EXPORT_B, n), np.float32)
    ns = np.zeros((EXPORT_B,), np.int32)
    for i, u in enumerate(utts):
        audio, sr = load_audio(u.audio_path)
        check(sr == 16000, f"{u.audio_path}: {sr} Hz")
        wave[i, :len(audio)], ns[i] = audio, len(audio)
    wave_t, ns_t = torch.from_numpy(wave).to(dev), torch.from_numpy(ns).to(dev)
    row = {"pgasr::bilstm_fwd": "bilstm_fwd", "pgasr::ctc_beam": "ctc_beam",
           "pgasr::flash_attn": "flash_attn"}
    base = Config()
    flash = {"conformer": dataclasses.replace(base.conformer,
                                              flash_attention=True)}
    families = {"ctc": {}, "conformer": flash, "transducer": flash,
                "seq2seq": {}}
    runs = (  # key, family, CLI flags
        ("ctc_greedy", "ctc", []),
        ("ctc_beam", "ctc", ["--decoder", "beam", "--beam_size", "16"]),
        ("ctc_int8", "ctc", ["--export_quantize", "int8"]),
        ("ctc_cpu_cuda", "ctc", ["--export_platforms", "cpu,cuda"]),
        ("conformer_greedy", "conformer", []),
        ("transducer_greedy", "transducer", []),
        ("seq2seq_greedy", "seq2seq", []))
    cases, out_counts, reached = {}, {}, set()
    for key, family, flags in runs:
        model_dir = os.path.join(d, f"export_{key}")
        cfg = fit_vocab(base.replace(model=dataclasses.replace(
            base.model, family=family), **families[family]), alphabet.size)
        save_model(model_dir, init_model_params(
            cfg, torch.Generator().manual_seed(SEED), "cpu"), cfg)
        t0 = time.perf_counter()
        rc, _ = run_cli(["--mode", "export", "--corpus_path", corpus,
                         "--model_path", model_dir, *flags,
                         "--device", str(dev)])
        export_s = time.perf_counter() - t0
        check(rc == 0, f"export {key}: rc {rc}")
        export_dir = os.path.join(model_dir, EXPORT_DIR)
        with open(os.path.join(export_dir, "manifest.json")) as fo:
            m = json.load(fo)
        check(m["batch_size"] == EXPORT_B and m["max_samples"] == n,
              f"export {key}: manifest {m['batch_size']} x {m['max_samples']}")
        ops = m["pgasr_ops"]
        check(ops, f"export {key}: no pgasr:: node in the program")
        ex = ExportedModel(export_dir, device=str(dev))
        params, cfg = load_model(model_dir, alphabet, device=dev)
        live = make_serving_fn(params, cfg, decoder=m["decoder"],
                               beam_size=m["beam_size"],
                               quantize="" if m["quantize"] == "none"
                               else m["quantize"])

        def live_call():
            with torch.inference_mode():
                return live(wave_t, ns_t)

        def exported_call():
            return ex.run(wave_t, ns_t)

        want = {**dict.fromkeys(all_counts(), 0),
                **{row[op]: k for op, k in ops.items()}}
        reset_counts()
        t0 = time.perf_counter()
        ids, lens = exported_call()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        got = all_counts()
        check(got == want, f"export {key}: the exported call launched {got}, "
              f"its pgasr:: nodes {ops}")
        out_counts[f"export_{key}"] = got
        reached |= set(ops)
        reset_counts()
        want_ids, want_lens = live_call()
        torch.cuda.synchronize()
        check(all_counts() == want, f"export {key}: the live call launched "
              f"{all_counts()}, not {want}")
        check(torch.equal(ids, want_ids) and torch.equal(lens, want_lens),
              f"export {key}: the exported ids differ from the live ones")
        check(ids.dtype == torch.int32 and lens.dtype == torch.int32
              and int(lens.sum()) > 0, f"export {key}: ids {ids.dtype}, "
              f"lens {lens.dtype} {lens.tolist()}")
        # the decoder loops' calls of seconds: one call a side, no warm-up
        # call (the launch check above warmed both paths), to keep the
        # smoke inside its time limit (the exported transducer's call took
        # 14-67 s late in a whole run, 2-3 s in this phase alone)
        reps = EXPORT_REPS if first_ms < 500 else 1
        if reps > 1:
            turns = [time_ms(live_call, reps), time_ms(exported_call, reps),
                     time_ms(exported_call, reps), time_ms(live_call, reps)]
            live_ms, exported_ms = ((turns[0] + turns[3]) / 2,
                                    (turns[1] + turns[2]) / 2)
        else:
            turns = [once_ms(live_call), once_ms(exported_call)]
            live_ms, exported_ms = turns
        case = {"flags": flags, "export_s": export_s, "nodes": m["nodes"],
                "pgasr_ops": ops, "mb": m["bytes"] / 1e6,
                "exported_ms": exported_ms, "live_ms": live_ms,
                "turns_ms": turns, "reps": reps, "launches": got,
                "lens": lens.tolist()}
        profile = ""
        if reps > 1:
            # not the decoder loops: tracing their 100 K+ launches takes
            # the profiler tens of seconds and stretches the call's wall
            busy, wall, n_ops = device_busy(exported_call)
            case.update(device_busy_ms=busy, idle_share=1 - busy / wall,
                        device_ops=n_ops)
            profile = (f"; device busy {busy:.2f} ms, idle share "
                       f"{case['idle_share']:.3f}, {n_ops} device ops a "
                       "call")
        if key == "ctc_cpu_cuda":
            check(m["stored_on"] == "cpu", f"stored on {m['stored_on']}")
            cpu_ex = ExportedModel(export_dir, device="cpu")
            reset_counts()
            cpu_ids, cpu_lens = cpu_ex(wave, ns)
            check(not any(all_counts().values()), "the CPU program launched "
                  f"{all_counts()}")
            check(np.array_equal(cpu_ids, ids.cpu().numpy())
                  and np.array_equal(cpu_lens, lens.cpu().numpy()),
                  "export ctc_cpu_cuda: the CPU's ids differ from the card's")
            case["cpu_ids_equal"] = True
        if key == "ctc_int8":
            f32 = cases["ctc_greedy"]
            check(case["mb"] < f32["mb"], f"int8 {case['mb']:.1f} MB >= "
                  f"float32 {f32['mb']:.1f} MB")
            case["mb_float32"] = f32["mb"]
        cases[key] = case
        print(f"[export] {key}: export {export_s:.1f} s, {m['nodes']} nodes, "
              f"pgasr {ops}, {case['mb']:.1f} MB; exported "
              f"{case['exported_ms']:.2f} ms vs live {case['live_ms']:.2f} ms "
              f"a call (turns, CUDA events: "
              + ", ".join(f"{t:.2f}" for t in case["turns_ms"])
              + f"){profile}; launches "
              f"{dict((k, v) for k, v in got.items() if v)}")
        del ex, live, params
    missing = set(registry.OPS) - reached
    check(not missing, f"registered ops no export reached: {missing}")
    wall_s = time.perf_counter() - t_start
    print(f"[export] phase 16 wall time {wall_s:.1f} s")
    return {"launches": out_counts, "cases": cases, "wall_s": wall_s}


# phase 17: the switch-MoE transformer (parallel/moe.py) at the full width
# of Config()'s transformer with the CLI's --model moe (4 experts, capacity
# factor 1.25, aux weight 0.01): finetune_pg steps of each objective
MOE_PG_STEPS = 3
# card vs CPU at B=64 x 5 s in float32: a valid token's expert may differ
# only where the router's top-2 probabilities lie within this margin (the
# two devices' float32 sums round apart); a flip at a larger margin is a
# fault, not rounding
MOE_ROUTE_MARGIN = 1e-5


def moe_group(name: str) -> str:
    """The kernel group of an MoE train step: GEMMs (the projections, the
    dense attention's batched products, the experts' bmm), the routing and
    dispatch (index copies and gathers, the slot cumsum), the CTC loss,
    LayerNorm, and the rest (softmax, elementwise, reductions, the
    optimizer)."""
    return ("gemm" if any(w in name for w in ("gemm", "nvjet", "xmma"))
            else "ctc_loss" if "ctc" in name else
            "dispatch" if any(w in name for w in ("index", "scatter",
                                                  "gather", "scan"))
            else "layer_norm" if "layer_norm" in name else "other")


MOE_GROUPS = ("gemm", "dispatch", "ctc_loss", "layer_norm", "other")


def phase_moe(dev, corpus, alphabet, d):
    """17. The switch-MoE transformer at full width: `--mode train --model
    moe` through the CLI (an epoch, then a resume), `--mode predict`
    greedy and beam, `--mode finetune_pg` REINFORCE and MWER, each run's
    launches exact (no kernel but ctc_beam: one a beam batch and one an
    MWER step); `--mode export` greedy, beam and int8 of a random-weight
    MoE model (random weights emit text), each artifact's ids equal to the
    live serving function's on 8 test clips and its ctc_beam launches to
    its pgasr:: nodes; card vs CPU on one B=64 x 5 s batch of the trained
    model in float32, dropout 0: the routing of every block on every valid
    token, the loss and every gradient; the share of valid tokens capacity
    drops; the slot cumsum's two layouts, device-timed; the MoE train step
    beside the dense transformer's, float32 and bfloat16, in turns, with
    the profiler's device time, idle share and the step's peak device
    memory."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from pg_asr_tpu_torch.checkpoint import save_model
    from pg_asr_tpu_torch.config import Config, fit_vocab
    from pg_asr_tpu_torch.data import load_manifest
    from pg_asr_tpu_torch.data.audio import load_audio
    from pg_asr_tpu_torch.exporting import (EXPORT_DIR, ExportedModel,
                                            make_serving_fn)
    from pg_asr_tpu_torch.parallel import moe
    from pg_asr_tpu_torch.predict import load_model
    from pg_asr_tpu_torch.train import AdamW, init_model_params, loss_and_grads

    t_start = time.perf_counter()
    bs = 32  # the CLI's default
    clips = os.path.join(corpus, "clips")

    def n_rows(split):
        return len(load_manifest(os.path.join(corpus, f"{split}.tsv"), clips))

    n_test = n_rows("test")
    model_dir = os.path.join(d, "moe_trained")
    zero = dict.fromkeys(all_counts(), 0)
    launches = {}

    def run(key, argv, beams):
        """The CLI run, its launches: `beams` ctc_beam and nothing else."""
        reset_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(argv)
        torch.cuda.synchronize()
        got = all_counts()
        print(f"[moe] {key}: rc={rc} in {time.perf_counter() - t0:.2f} s "
              f"(host clock); launches "
              f"{dict((k, v) for k, v in got.items() if v)}")
        check(rc == 0, f"moe {key}: rc {rc}")
        check(got == {**zero, "ctc_beam": beams}, f"moe {key}: launches "
              f"{got}, expected {beams} ctc_beam and nothing else")
        launches[f"moe_{key}"] = got
        return out

    argv = ["--mode", "train", "--corpus_path", corpus, "--model_path",
            model_dir, "--device", str(dev), "--seed", str(SEED)]
    run("train_epoch1", argv + ["--num_epochs", "1", "--model", "moe"], 0)
    out = run("train_epoch2", argv + ["--num_epochs", "2"], 0)
    check("resumed from epoch 1" in out
          and "resuming with model family 'transformer'" in out,
          "moe: the second run did not resume the family")
    with open(os.path.join(model_dir, "config.json")) as fo:
        saved = json.load(fo)["transformer"]
    check(saved["num_experts"] == 4 and saved["capacity_factor"] == 1.25
          and saved["num_layers"] == 6 and saved["d_model"] == 256,
          f"moe config.json {saved}")
    tl = np.load(os.path.join(model_dir, "train_loss.npy"))
    vl = np.load(os.path.join(model_dir, "val_losses.npy"))
    check(tl.shape == vl.shape == (2,) and np.isfinite(tl).all()
          and np.isfinite(vl).all(), f"moe losses {tl} {vl}")
    print(f"[moe] train losses {tl.tolist()}, val losses {vl.tolist()}")
    for decoder, beams in (("greedy", 0), ("beam", -(-n_test // BEAM_B))):
        out = run(f"predict_{decoder}",
                  ["--mode", "predict", "--corpus_path", corpus,
                   "--model_path", model_dir, "--device", str(dev),
                   "--decoder", decoder], beams)
        check("CER:" in out and "WER:" in out, f"moe predict {decoder}")
    for objective in ("reinforce", "mwer"):
        pg_dir = os.path.join(d, f"moe_pg_{objective}")
        os.makedirs(pg_dir)
        for name in ("config.json", "model_best.pt"):
            shutil.copy(os.path.join(model_dir, name), pg_dir)
        run(f"finetune_pg_{objective}",
            ["--mode", "finetune_pg", "--corpus_path", corpus,
             "--model_path", pg_dir, "--device", str(dev), "--pg_steps",
             str(MOE_PG_STEPS), "--pg_eval_every", "0", "--pg_objective",
             objective], MOE_PG_STEPS if objective == "mwer" else 0)
        rewards = np.load(os.path.join(pg_dir, "pg_rewards.npy"))
        check(rewards.shape == (MOE_PG_STEPS,) and np.isfinite(rewards).all(),
              f"moe finetune_pg {objective}: rewards {rewards}")
        print(f"[moe] finetune_pg {objective}: rewards {rewards.tolist()}")

    # export of a random-weight MoE model at the CLI's defaults
    utts = load_manifest(os.path.join(corpus, "test.tsv"), clips)[:EXPORT_B]
    n = int(EXPORT_S * 16000)
    wave = np.zeros((EXPORT_B, n), np.float32)
    ns = np.zeros((EXPORT_B,), np.int32)
    for i, u in enumerate(utts):
        audio, _ = load_audio(u.audio_path)
        wave[i, :len(audio)], ns[i] = audio, len(audio)
    wave_t, ns_t = torch.from_numpy(wave).to(dev), torch.from_numpy(ns).to(dev)
    base = Config()
    cfg_r = fit_vocab(base.replace(
        model=dataclasses.replace(base.model, family="transformer"),
        transformer=dataclasses.replace(base.transformer, num_experts=4)),
        alphabet.size)
    random_dir = os.path.join(d, "moe_random")
    save_model(random_dir, init_model_params(
        cfg_r, torch.Generator().manual_seed(SEED), "cpu"), cfg_r)
    export = {}
    for key, flags in (("greedy", []),
                       ("beam", ["--decoder", "beam", "--beam_size",
                                 str(BEAM_K)]),
                       ("int8", ["--export_quantize", "int8"])):
        t0 = time.perf_counter()
        rc, _ = run_cli(["--mode", "export", "--corpus_path", corpus,
                         "--model_path", random_dir, *flags,
                         "--device", str(dev)])
        export_s = time.perf_counter() - t0
        check(rc == 0, f"moe export {key}: rc {rc}")
        export_dir = os.path.join(random_dir, EXPORT_DIR)
        ex = ExportedModel(export_dir, device=str(dev))
        m = ex.manifest
        ops = m["pgasr_ops"]
        check(ops == ({"pgasr::ctc_beam": 1} if key == "beam" else {}),
              f"moe export {key}: pgasr nodes {ops}")
        want = {**zero, "ctc_beam": ops.get("pgasr::ctc_beam", 0)}
        reset_counts()
        ids, lens = ex.run(wave_t, ns_t)
        torch.cuda.synchronize()
        got = all_counts()
        check(got == want, f"moe export {key}: the exported call launched "
              f"{got}, its pgasr nodes {ops}")
        launches[f"moe_export_{key}"] = got
        params, cfg = load_model(random_dir, alphabet, device=dev)
        live = make_serving_fn(params, cfg, decoder=m["decoder"],
                               beam_size=m["beam_size"],
                               quantize="" if m["quantize"] == "none"
                               else m["quantize"])
        reset_counts()
        with torch.inference_mode():
            want_ids, want_lens = live(wave_t, ns_t)
        torch.cuda.synchronize()
        check(all_counts() == want, f"moe export {key}: the live call "
              f"launched {all_counts()}")
        check(torch.equal(ids, want_ids) and torch.equal(lens, want_lens)
              and int(lens.sum()) > 0,
              f"moe export {key}: ids differ from the live ones or are "
              f"empty (lens {lens.tolist()})")
        export[key] = {"export_s": export_s, "nodes": m["nodes"],
                       "pgasr_ops": ops, "mb": m["bytes"] / 1e6,
                       "lens": lens.tolist()}
        print(f"[moe] export {key}: {export_s:.1f} s, {m['nodes']} nodes, "
              f"pgasr {ops}, {m['bytes'] / 1e6:.1f} MB; ids equal to the "
              f"live call's on {EXPORT_B} clips (lens {lens.tolist()})")
        del ex, live, params

    # card vs CPU: one B=64 x 5 s batch of the trained model, float32
    params, cfg = load_model(model_dir, alphabet, device=dev)
    cfg0 = cfg.replace(transformer=dataclasses.replace(cfg.transformer,
                                                       dropout=0.0))
    arrays = flagship_batch(dev, vocab=alphabet.size)
    routes = {"cuda": [], "cpu": []}
    real_route = moe.route

    def recording(tag):
        def route(params, pre, x, token_valid, capacity):
            r = real_route(params, pre, x, token_valid, capacity)
            routes[tag].append((r, token_valid.reshape(-1)))
            return r
        return route

    try:
        moe.route = recording("cuda")
        loss_g, g_g = loss_and_grads(params, arrays, cfg0)
        moe.route = recording("cpu")
        t0 = time.perf_counter()
        loss_c, g_c = loss_and_grads({k: v.cpu() for k, v in params.items()},
                                     [a.cpu() for a in arrays], cfg0)
        cpu_s = time.perf_counter() - t0
    finally:
        moe.route = real_route
    check(len(routes["cuda"]) == len(routes["cpu"]) == 6,
          f"moe: {len(routes['cuda'])} routed blocks")
    flips, drop = [], []
    for i, ((rg, vg), (rc, vc)) in enumerate(zip(routes["cuda"],
                                                 routes["cpu"])):
        v = vc
        check(torch.equal(vg.cpu(), v), f"moe block {i}: valid tokens differ")
        differ = (rg.expert.cpu() != rc.expert) & v
        top2 = rc.probs.detach().topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        for n_ in differ.nonzero().flatten().tolist():
            flips.append({"block": i, "token": n_,
                          "margin": margin[n_].item()})
            print(f"[moe] block {i} token {n_}: expert "
                  f"{rg.expert[n_].item()} on the card, {rc.expert[n_].item()}"
                  f" on the CPU, router top-2 margin {margin[n_].item():.2e}")
        if not differ.any():
            check(torch.equal(rg.pos.cpu()[v], rc.pos[v])
                  and torch.equal(rg.kept.cpu()[v], rc.kept[v]),
                  f"moe block {i}: equal experts but other slots")
        drop.append(((v & ~rg.kept.cpu()).sum() / v.sum()).item())
    check(all(f["margin"] <= MOE_ROUTE_MARGIN for f in flips),
          f"moe: routing flips at a margin above {MOE_ROUTE_MARGIN}: {flips}")
    loss_rel = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    # (a gradient that is 0 on both devices counts as agreeing)
    grad_rel = {k: ((g_g[k].cpu() - g_c[k]).abs().max()
                    / g_c[k].abs().max().clamp(min=1e-30)).item()
                for k in g_c}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"[moe] card vs CPU, B={B} x 5 s, float32, dropout 0: routing of "
          f"{len(routes['cpu'])} blocks x {arrays[0].shape[0] * ATTN_T} "
          f"tokens, {len(flips)} flips; loss {loss_g.item():.6f} vs "
          f"{loss_c.item():.6f} (rel {loss_rel:.2e}, bound "
          f"{TRAIN_LOSS_REL:.0e}); {len(grad_rel)} gradients, worst "
          f"max|diff|/max|grad| {grad_rel[worst]:.2e} ({worst}; bound "
          f"{TRAIN_GRAD_REL:.0e}); the CPU's step {cpu_s:.1f} s; capacity "
          f"drops {np.mean(drop):.4f} of the valid tokens (by block "
          + ", ".join(f"{x:.4f}" for x in drop) + ")")
    check(math.isfinite(loss_g.item()) and loss_rel <= TRAIN_LOSS_REL,
          f"moe loss card {loss_g.item()} vs CPU {loss_c.item()}")
    check(all(math.isfinite(x) and x <= TRAIN_GRAD_REL
              for x in grad_rel.values()),
          f"moe gradients card vs CPU: {grad_rel}")
    del g_g, g_c
    # the slot cumsum of one block's (N, E) assignments: along the outer
    # axis (a thread a column) and, as moe.route takes it, along the
    # contiguous token axis of the transpose
    assign = routes["cuda"][0][0].assign
    cumsum_ms = {
        "outer_axis": device_ms(lambda: torch.cumsum(assign, dim=0), 20),
        "route": device_ms(lambda: torch.cumsum(assign.t().contiguous(),
                                                dim=1), 20)}
    print(f"[moe] the slot cumsum of {tuple(assign.shape)} int64 "
          f"assignments (device-timed): along the outer axis "
          f"{cumsum_ms['outer_axis']:.4f} ms, along the transpose's "
          f"contiguous axis (moe.route) {cumsum_ms['route']:.4f} ms")

    # the train step at B=64 x 5 s beside the dense transformer's
    dense_cfg = fit_vocab(base.replace(model=dataclasses.replace(
        base.model, family="transformer")), alphabet.size)
    step_ms, breakdown, idle, peak_mb = {}, {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        steps = {}
        p_m, c_m = load_model(model_dir, alphabet, device=dev, dtype=dtype)
        c_d = dense_cfg.replace(model=dataclasses.replace(dense_cfg.model,
                                                          dtype=dtype))
        p_d = init_model_params(c_d, torch.Generator().manual_seed(SEED), dev)
        for name, (p, c) in (("moe", (p_m, c_m)), ("dense", (p_d, c_d))):
            opt = AdamW(c, p)
            gen = torch.Generator(device=dev).manual_seed(SEED)

            def step(p=p, c=c, opt=opt, gen=gen):
                _, grads = loss_and_grads(p, arrays, c, gen)
                opt.update(p, grads)

            steps[name] = step
        ms = dict(zip(("moe", "dense"), in_turns(steps["dense"], steps["moe"],
                                                 3, 3)))
        for name, step in steps.items():
            key = f"{dtype}_{name}"
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            peak_mb[key] = (torch.cuda.max_memory_allocated() - before) / 1e6
            breakdown[key] = device_breakdown(step, reps=2, groups=MOE_GROUPS,
                                              classify=moe_group)
            busy = sum(breakdown[key].values())
            step_ms[key] = ms[name]
            idle[key] = max(0.0, 1 - busy / ms[name])
            print(f"[moe] train step B={B} x 5 s, {dtype}, {name}: "
                  f"{ms[name]:.2f} ms (in turns); device time {busy:.2f} ms: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in
                              breakdown[key].items())
                  + f"; device idle {idle[key]:.0%}; the step's peak "
                  f"device memory {peak_mb[key]:.0f} MB above its "
                  "params and optimizer state")
        del p_m, p_d, steps
    wall_s = time.perf_counter() - t_start
    print(f"[moe] phase 17 wall time {wall_s:.1f} s")
    return {"launches": launches, "export": export, "routing_flips": flips,
            "loss_rel": loss_rel, "worst_grad_rel": grad_rel[worst],
            "drop_share_by_block": drop, "cpu_step_s": cpu_s,
            "slot_cumsum_ms": cumsum_ms,
            "step_ms": step_ms, "device_ms": breakdown, "idle_share": idle,
            "step_peak_mb": peak_mb, "wall_s": wall_s}


MESH_BS = 64  # phase 18's batch: the flagship's B=64
MESH_STEPS = 3  # the two-rank steps (b) and the MWER steps (d)
MESH_FAULT_STEP = 4  # (c): epoch 1, batch 4 of 9
# (a), (c) and (d) against the run without a mesh: bit for bit where two
# runs without a mesh agree bit for bit (a); where the card's float32
# sums do not repeat (F.ctc_loss's CUDA backward adds atomically: phase
# 11), the losses within RESUME_LOSS_REL and the parameters within
# MESH_PARAM_REL of their largest value, the largest difference printed
MESH_PARAM_REL = 1e-3
# (b) two ranks vs one process, at the CPU tests' rtol / atol: the losses;
# the first step's all-reduced gradients against the gradients of the
# whole batch, every element, atol of the tensor's largest (a wrong
# reduction's scale, a mean for the sum or a rank counted twice, moves
# every element by half or more); and, as the CPU tests, every parameter
# element whose gradient exceeds MESH_GRAD_FLOOR at every step: AdamW
# moves a parameter by about lr * g / (|g| + 1e-8) over the moments, so
# where |g| is near the float32 rounding of the batch's two splits (GEMMs
# of 32 and 64 rows, F.ctc_loss's atomic backward) the update's direction
# is noise; the count left out is printed
MESH_RTOL, MESH_ATOL, MESH_GRAD_FLOOR = 1e-4, 1e-5, 1e-6


def mesh_spec(alphabet):
    """Phase 18 (b)'s inputs: the full-width BiLSTM-CTC (random weights from
    the seed, dropout 0), float32, with a constant rate so that the steps
    move it, and the global B=64 x 5 s batch, on the host."""
    import dataclasses

    import torch

    from pg_asr_tpu_torch.config import Config, fit_vocab
    from pg_asr_tpu_torch.train import init_model_params

    cfg = fit_vocab(Config(), alphabet.size)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dropout=0.0),
        train=dataclasses.replace(cfg.train, warmup_steps=0,
                                  learning_rate=1e-3))
    params = init_model_params(cfg, torch.Generator().manual_seed(SEED),
                               "cpu")
    batch = flagship_batch("cpu", vocab=alphabet.size)
    return cfg, params, tuple(a.numpy() for a in batch)


def mesh_worker(spec_path: str, out_path: str, rank: int, port: int) -> int:
    """`python3 chip_smoke.py --mesh-worker SPEC OUT RANK PORT`: rank RANK
    of two on the spec's device (the card) over gloo (NCCL takes one rank a
    device): its 32 rows of the spec's global batch, MESH_STEPS
    data-parallel train steps, its launches, losses, step times, the first
    step's all-reduced gradients and the parameters into OUT."""
    import torch

    from pg_asr_tpu_torch.config import Config
    from pg_asr_tpu_torch.parallel import mesh
    from pg_asr_tpu_torch.train import AdamW, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(spec_path, weights_only=False)
    dev = torch.device(spec["device"])
    mesh.init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                          device=dev)
    summed = []

    class Recorded(mesh.GroupRank):
        def sum_grads(self, grads):
            out = super().sum_grads(grads)
            if not summed:
                summed.append({k: v.cpu() for k, v in out.items()})
            return out

    try:
        dp = Recorded(dev)
        cfg = Config.from_json(spec["config"])
        params = {k: v.to(dev) for k, v in spec["params"].items()}
        arrays = [torch.from_numpy(a).to(dev) for a in
                  mesh.local_rows(spec["batch"], dp.rank, dp.world)]
        step = make_train_step(cfg, AdamW(cfg, params), dp)
        gen = torch.Generator().manual_seed(SEED)  # world 2: on the host
        reset_counts()
        losses, ms = [], []
        for _ in range(MESH_STEPS):
            t0 = time.perf_counter()
            losses.append(step(params, gen, *arrays).item())  # synchronizes
            ms.append((time.perf_counter() - t0) * 1e3)
        torch.save({"losses": losses, "ms": ms, "counts": all_counts(),
                    "rows": int(arrays[0].shape[0]), "grads": summed[0],
                    "params": {k: v.cpu() for k, v in params.items()}},
                   out_path)
    finally:
        mesh.destroy_distributed()
    return 0


def _drift(got: dict, want: dict) -> float:
    """max over the parameters of max|got - want| / max|want|."""
    return max((got[k].float() - want[k].float()).abs().max().item()
               / want[k].float().abs().max().item() for k in want)


def phase_mesh(dev, corpus, alphabet, d):
    """18. The data mesh axis and the elastic supervisor on the full-width
    BiLSTM-CTC at B=64: (a) `--mode train --mesh data=1` through the CLI
    (an NCCL group of one) against the same epoch without a mesh; in a group
    of one in this process, one step with and without the mesh from the
    same state (the losses equal bit for bit, the gradient all-reduce the
    identity), the all-reduce and both steps timed; (b) two rank processes
    on the one card over gloo, 32 rows each, MESH_STEPS steps against the
    one-process steps on the same global batches, each rank's launches;
    (c) `--max_restarts 1 --fault_step MESH_FAULT_STEP` through the CLI:
    the child's exit 17, one relaunch, the resumed run against (a)'s, the
    relaunch's cost; (d) MESH_STEPS MWER `--mode finetune_pg` steps under
    `--mesh data=1` against the same steps without a mesh."""
    import shutil

    import numpy as np
    import torch

    from pg_asr_tpu_torch.checkpoint import load_checkpoint
    from pg_asr_tpu_torch.data import load_manifest
    from pg_asr_tpu_torch.parallel import mesh
    from pg_asr_tpu_torch.train import (AdamW, loss_and_grads,
                                        make_train_step)

    t_phase = time.perf_counter()
    result, launches = {}, {}
    clips = os.path.join(corpus, "clips")
    n_train = len(load_manifest(os.path.join(corpus, "train.tsv"), clips))
    n_dev = len(load_manifest(os.path.join(corpus, "dev.tsv"), clips))
    steps, dev_batches = -(-n_train // MESH_BS), -(-n_dev // MESH_BS)
    inf, res, bwd, per = route_counters()
    want_counts = {res: per * steps, bwd: per * steps,
                   inf: per * dev_batches}
    base = ["--mode", "train", "--corpus_path", corpus, "--device", str(dev),
            "--seed", str(SEED), "--num_epochs", "1", "--batch_size",
            str(MESH_BS)]

    # (a) one epoch without a mesh and under --mesh data=1
    runs = {}
    for name, extra in (("plain", []), ("data1", ["--mesh", "data=1"])):
        model = os.path.join(d, f"mesh_{name}")
        reset_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(base + ["--model_path", model, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_counts()
        got = {k: counts[k] for k in want_counts}
        check(rc == 0, f"(a) {name}: rc {rc}")
        check(got == want_counts and sum(counts.values()) == sum(
            want_counts.values()), f"(a) {name}: launches {counts}, "
            f"expected {want_counts}")
        if name == "data1":
            backend = "nccl" if dev.type == "cuda" else "gloo"
            check(f"torch.distributed initialized (process 0/1, {backend})"
                  in out, f"(a) --mesh data=1 did not form a {backend} group")
            launches["mesh_data1_train"] = counts
        runs[name] = {
            "params": load_checkpoint(os.path.join(
                model, "model_last.pt"))["params"],
            "train": np.load(os.path.join(model, "train_loss.npy")),
            "val": np.load(os.path.join(model, "val_losses.npy")),
            "wall_s": wall}
    ref = runs["plain"]
    cmp_a = {}
    for name in ("data1",):
        r = runs[name]
        loss_rel = max(abs(float(r[k][0]) - float(ref[k][0]))
                       / abs(float(ref[k][0])) for k in ("train", "val"))
        cmp_a[name] = {"loss_rel": loss_rel,
                       "params_drift": _drift(r["params"], ref["params"]),
                       "bit_equal": all(torch.equal(r["params"][k],
                                                    ref["params"][k])
                                        for k in ref["params"])}
    print(f"[mesh] (a) 1 epoch, {steps} steps at B={MESH_BS} + {dev_batches}"
          f" dev batches, launches {want_counts} in each run; --mesh data=1 "
          f"(a group of one) vs no mesh: {cmp_a['data1']}; wall s "
          + ", ".join(f"{k} {v['wall_s']:.2f}" for k, v in runs.items()))
    # (two runs without a mesh agreed bit for bit in PR 21's runs, as did
    # the world-1 run; the card's F.ctc_loss backward adds atomically, so
    # bit equality is printed, the bounds are checked)
    for name, c in cmp_a.items():
        check(c["loss_rel"] <= RESUME_LOSS_REL
              and c["params_drift"] <= MESH_PARAM_REL,
              f"(a) {name} vs the run without a mesh: {c}")
    result["a"] = {"compare": cmp_a, "launches": want_counts,
                   "wall_s": {k: v["wall_s"] for k, v in runs.items()}}

    # (a) in a group of one here: one step with and without the mesh from
    # the same parameters and generator state, and the times
    cfg_b, params0, batch = mesh_spec(alphabet)
    arrays = [torch.from_numpy(a).to(dev) for a in batch]
    mesh.init_distributed(f"127.0.0.1:{mesh.free_port()}", 1, 0,
                          device=dev)
    try:
        dp = mesh.GroupRank(dev)
        p_plain = {k: v.to(dev) for k, v in params0.items()}
        p_mesh = {k: v.clone() for k, v in p_plain.items()}
        steps_fn = {
            "plain": make_train_step(cfg_b, AdamW(cfg_b, p_plain)),
            "data1": make_train_step(cfg_b, AdamW(cfg_b, p_mesh), dp)}
        gens = {k: torch.Generator(device=dev).manual_seed(SEED)
                for k in steps_fn}
        loss_plain = steps_fn["plain"](p_plain, gens["plain"], *arrays)
        loss_mesh = steps_fn["data1"](p_mesh, gens["data1"], *arrays)
        _, grads = loss_and_grads(p_plain, arrays, cfg_b)
        summed = dp.sum_grads(grads)
        identity = all(torch.equal(summed[k], grads[k]) for k in grads)
        check(torch.equal(loss_plain, loss_mesh) and identity,
              f"(a) world-1 step: loss {loss_mesh.item()!r} vs "
              f"{loss_plain.item()!r}, all-reduce identity {identity}")
        nbytes = sum(g.numel() * g.element_size() for g in grads.values())
        allreduce_ms = time_ms(lambda: dp.sum_grads(grads), 20)
        step_ms, plain_ms = in_turns(
            lambda: steps_fn["plain"](p_plain, gens["plain"], *arrays),
            lambda: steps_fn["data1"](p_mesh, gens["data1"], *arrays), 5, 5)
    finally:
        mesh.destroy_distributed()
    print(f"[mesh] (a) world-1 NCCL step at B={MESH_BS} x 5 s, float32: loss "
          f"{loss_mesh.item():.6f} equal bit for bit to the step without a "
          f"mesh, the gradient all-reduce the identity; the all-reduce of "
          f"the {len(grads)} gradients ({nbytes / 1e6:.2f} MB, one buffer) "
          f"{allreduce_ms:.3f} ms; the step {step_ms:.2f} ms with the mesh, "
          f"{plain_ms:.2f} ms without (in turns)")
    result["a"].update(allreduce_ms=allreduce_ms, grads_mb=nbytes / 1e6,
                       step_ms=step_ms, plain_step_ms=plain_ms)

    # (b) two ranks on the one card over gloo vs the one-process steps
    spec_path = os.path.join(d, "mesh_spec.pt")
    torch.save({"config": cfg_b.to_json(), "params": params0,
                "batch": batch, "device": str(dev)}, spec_path)
    port = mesh.free_port()
    outs = [os.path.join(d, f"mesh_rank{r}.pt") for r in range(2)]
    logs = [os.path.join(d, f"mesh_rank{r}.log") for r in range(2)]
    t0 = time.perf_counter()
    procs = []
    for r in range(2):
        with open(logs[r], "w") as fo:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-worker",
                 spec_path, outs[r], str(r), str(port)], stdout=fo,
                stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__))))
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_b = time.perf_counter() - t0
    for r, rc in enumerate(rcs):
        with open(logs[r]) as fo:
            log = fo.read()
        check(rc == 0, f"(b) rank {r}: rc {rc}\n{log[-3000:]}")
    ranks = [torch.load(o, weights_only=False) for o in outs]
    p_ref = {k: v.to(dev) for k, v in params0.items()}
    opt = AdamW(cfg_b, p_ref)
    ref_losses, ref_grads = [], None
    sure = {k: torch.ones_like(v, dtype=torch.bool) for k, v in p_ref.items()}
    for _ in range(MESH_STEPS):
        loss, grads = loss_and_grads(p_ref, arrays, cfg_b)
        ref_losses.append(loss.item())
        if ref_grads is None:
            ref_grads = {k: g.cpu() for k, g in grads.items()}
        sure = {k: sure[k] & (grads[k].abs() > MESH_GRAD_FLOOR)
                for k in sure}
        opt.update(p_ref, grads)
    p_ref = {k: v.cpu() for k, v in p_ref.items()}
    sure = {k: v.cpu() for k, v in sure.items()}
    left_out = sum(int((~v).sum()) for v in sure.values())
    worst = {"loss": 0.0, "param": 0.0, "grad": 0.0}
    for rk in ranks:
        for k, g in ref_grads.items():  # every element, no mask
            diff = (rk["grads"][k] - g).abs()
            bound = MESH_ATOL * g.abs().max() + MESH_RTOL * g.abs()
            worst["grad"] = max(worst["grad"], (diff.max()
                                                / g.abs().max()).item())
            check(bool((diff <= bound).all()), f"(b) the all-reduced "
                  f"gradient of {k}: max|diff| {diff.max().item():.3e}, "
                  f"max|g| {g.abs().max().item():.3e}")
        for a, b in zip(rk["losses"], ref_losses):
            worst["loss"] = max(worst["loss"], abs(a - b) / max(abs(b),
                                                                1e-30))
            check(abs(a - b) <= MESH_ATOL + MESH_RTOL * abs(b),
                  f"(b) losses {rk['losses']} vs {ref_losses}")
        for k, v in p_ref.items():
            diff = (rk["params"][k] - v).abs()[sure[k]]
            bound = MESH_ATOL + MESH_RTOL * v.abs()[sure[k]]
            if diff.numel():
                worst["param"] = max(worst["param"], diff.max().item())
            check(bool((diff <= bound).all()), f"(b) {k}: max|diff| "
                  f"{diff.max().item():.3e}")
        check(rk["counts"][res] == per * MESH_STEPS
              and rk["counts"][bwd] == per * MESH_STEPS
              and sum(rk["counts"].values()) == 2 * per * MESH_STEPS,
              f"(b) rank launches {rk['counts']}")
    same = all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in p_ref)
    check(same, "(b) the two ranks' parameters differ")
    for r, rk in enumerate(ranks):
        launches[f"mesh_2rank_r{r}_train"] = rk["counts"]
    rank_ms = [float(np.mean(rk["ms"][1:])) for rk in ranks]
    print(f"[mesh] (b) 2 ranks on cuda:0 over gloo, {ranks[0]['rows']} rows "
          f"each of the B={MESH_BS} x 5 s batch, {MESH_STEPS} steps: losses "
          f"{ranks[0]['losses']} vs one process {ref_losses} (worst rel "
          f"{worst['loss']:.2e}); parameters equal on both ranks and within "
          f"rtol {MESH_RTOL:g} / atol {MESH_ATOL:g} of one process's (worst "
          f"max|diff| {worst['param']:.2e}; {left_out} of "
          f"{sum(v.numel() for v in sure.values())} elements with |g| <= "
          f"{MESH_GRAD_FLOOR:g} at some step left out, as the CPU tests); "
          "the first step's all-reduced gradients against the "
          f"whole batch's, every element: worst max|diff| / max|g| "
          f"{worst['grad']:.2e} (atol {MESH_ATOL:g} of it, rtol "
          f"{MESH_RTOL:g}); launches a rank "
          f"{ranks[0]['counts']}; step ms a rank (steps 2-{MESH_STEPS}, "
          f"host clock) {[round(m, 2) for m in rank_ms]}; {wall_b:.1f} s "
          "with the processes' start")
    result["b"] = {"losses": [rk["losses"] for rk in ranks],
                   "one_process_losses": ref_losses, "worst": worst,
                   "left_out": left_out, "step_ms": rank_ms,
                   "wall_s": wall_b}

    # (c) --max_restarts 1 --fault_step N through the CLI, a subprocess
    model_c = os.path.join(d, "mesh_fault")
    cmd = [sys.executable, "-m", "pg_asr_tpu_torch", *base, "--model_path",
           model_c, "--save_every_steps", "1", "--max_restarts", "1",
           "--fault_step", str(MESH_FAULT_STEP)]
    t0 = time.perf_counter()
    stamped = []
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        for line in proc.stdout:
            stamped.append((time.perf_counter(), line.rstrip()))
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall_c = time.perf_counter() - t0
    text = "\n".join(line for _, line in stamped)
    exits = [(t, line) for t, line in stamped
             if line.startswith("[elastic] child exited")]
    resumed = [(t, line) for t, line in stamped if "resumed from" in line]
    with open(os.path.join(model_c, ".fault_injected")) as fo:
        marker = fo.read()
    check(rc == 0 and len(exits) == 1 and "rc=17" in exits[0][1]
          and marker == str(MESH_FAULT_STEP) and len(resumed) == 1
          and f"batch {MESH_FAULT_STEP}" in resumed[0][1],
          f"(c) rc {rc}, marker {marker!r}\n{text[-3000:]}")
    last_c = load_checkpoint(os.path.join(model_c, "model_last.pt"))
    val_c = np.load(os.path.join(model_c, "val_losses.npy"))
    val_rel = abs(float(val_c[0]) - float(ref["val"][0])) / abs(
        float(ref["val"][0]))
    drift_c = _drift(last_c["params"], ref["params"])
    relaunch_s = resumed[0][0] - exits[0][0]
    print(f"[mesh] (c) --max_restarts 1 --fault_step {MESH_FAULT_STEP}: the "
          f"child exited 17 at step {marker}, one relaunch ({exits[0][1]}), "
          f"{resumed[0][1]}; rc {rc}; step {last_c['step']} (uninterrupted "
          f"{steps}); val loss rel {val_rel:.2e} (bound "
          f"{RESUME_LOSS_REL:.0e}), params max|diff|/max|p| {drift_c:.2e} "
          f"vs (a)'s run without a mesh (bound {MESH_PARAM_REL:.0e}); the "
          f"relaunch {relaunch_s:.2f} s from the exit to the resume (1 s "
          f"backoff, process start, CUDA init, restore); {wall_c:.1f} s in "
          "all")
    check(last_c["step"] == steps and val_rel <= RESUME_LOSS_REL
          and drift_c <= MESH_PARAM_REL, "(c) the resumed run vs (a)")
    result["c"] = {"fault_step": MESH_FAULT_STEP, "relaunch_s": relaunch_s,
                   "wall_s": wall_c, "val_rel": val_rel,
                   "params_drift": drift_c}

    # (d) MESH_STEPS MWER steps under --mesh data=1 vs without a mesh
    pg = {}
    for name, extra in (("plain", []), ("data1", ["--mesh", "data=1"])):
        model = os.path.join(d, f"mesh_pg_{name}")
        shutil.copytree(os.path.join(d, "mesh_plain"), model)
        reset_counts()
        rc, out = run_cli(["--mode", "finetune_pg", "--corpus_path", corpus,
                           "--model_path", model, "--device", str(dev),
                           "--pg_objective", "mwer", "--pg_steps",
                           str(MESH_STEPS), "--pg_eval_every", "0",
                           "--batch_size", str(MESH_BS), *extra])
        counts = all_counts()
        check(rc == 0, f"(d) {name}: rc {rc}")
        check(counts["ctc_beam"] == MESH_STEPS
              and counts[res] == per * MESH_STEPS
              and counts[bwd] == per * MESH_STEPS, f"(d) {name}: {counts}")
        if name == "data1":
            launches["mesh_data1_pg_mwer"] = counts
        pg[name] = {"rewards": np.load(os.path.join(model, "pg_rewards.npy")),
                    "params": load_checkpoint(os.path.join(
                        model, "model_last.pt"))["params"]}
    rew_diff = float(np.abs(pg["data1"]["rewards"]
                            - pg["plain"]["rewards"]).max())
    drift_d = _drift(pg["data1"]["params"], pg["plain"]["params"])
    print(f"[mesh] (d) {MESH_STEPS} MWER steps at B={MESH_BS} under --mesh "
          f"data=1: rewards {pg['data1']['rewards'].tolist()} vs "
          f"{pg['plain']['rewards'].tolist()} without a mesh (max|diff| "
          f"{rew_diff:.2e}), params max|diff|/max|p| {drift_d:.2e} (bound "
          f"{MESH_PARAM_REL:.0e}); {MESH_STEPS} ctc_beam launches each")
    check(pg["data1"]["rewards"][0] == pg["plain"]["rewards"][0]
          and rew_diff <= RESUME_LOSS_REL and drift_d <= MESH_PARAM_REL,
          "(d) the MWER steps under --mesh data=1")
    result["d"] = {"reward_max_diff": rew_diff, "params_drift": drift_d}
    result["wall_s"] = time.perf_counter() - t_phase
    print(f"[mesh] phase 18 in {result['wall_s']:.1f} s")
    result["launches"] = launches
    return result


SHARD_STEPS = 3  # phase 19's steps under expert=2 (a) and fsdp=2 (c)
SHARD_STEPS_B = 2  # data=2,expert=2 (b): four ranks on the one card
SHARD_PLAIN_REPS = 3  # the one-process step's timed reps, each turn
# every sharded run against the one-process steps at the CPU tests' rtol /
# atol (MESH_RTOL, MESH_ATOL): the losses; the first step's reduced
# gradients (this rank's parts) against the same slices of the whole
# batch's, every element, atol of the tensor's largest; the gathered
# parameters where every step's gradient exceeds MESH_GRAD_FLOOR and
# SHARD_GRAD_REL of its tensor's largest. AdamW's first steps move a
# parameter by about lr * g / |g|, so where |g| is within the two runs'
# gradient difference (up to ~1e-6 of the tensor's largest: 32-row and
# 64-row products round apart) the update's sign is noise (one element
# of 1.05 M in phase 19 (b)'s first run, |g| 2.8e-6 of a largest 5.5e-2);
# the count left out is printed. Of the elements checked, at most
# SHARD_OUTLIERS (a fraction) may lie outside the tolerance, each within
# two AdamW steps of lr a step: the card's one-process run differs from
# itself in the last bits (F.ctc_loss's backward adds atomically), and
# where a moment nearly cancels between steps AdamW magnifies that (one
# element of 9.5 M in (a)'s second run, |g| 5.8e-4 of its tensor's
# largest); a wrong reduction moves most elements, and the first step's
# gradients are held on every element. The MoE's top-1 routing is an
# argmax: at a near-tie the ranks (whose activations differ from one
# process's in the last bits) may send a token to another expert, and every
# parameter then takes another path (673 of 7.1 M elements outside the
# tolerance in one run of (a)). So the one-process steps of a MoE case run
# after its ranks and take the ranks' experts call by call
# (`routes_replayed`), and wherever their own argmax differs from the
# ranks' choice the top probability may lead the ranks' expert's by at
# most ROUTE_TIE
SHARD_GRAD_REL = 1e-4
SHARD_OUTLIERS = 1e-5
ROUTE_TIE = 1e-4


@contextlib.contextmanager
def routes_recorded(store: list):
    """While open, moe.route appends each call's top-1 experts (int8, on
    their device: no synchronization) to `store`."""
    import torch

    from pg_asr_tpu_torch.parallel import moe

    route = moe.route

    def recording(*args, **kwargs):
        r = route(*args, **kwargs)
        store.append(r.expert.to(torch.int8))
        return r

    moe.route = recording
    try:
        yield store
    finally:
        moe.route = route


@contextlib.contextmanager
def routes_replayed(routes: list, leads: list):
    """While open, moe.route takes the experts of `routes`, call by call,
    in place of its own argmax: the gate is the taken expert's
    probability, the slots and the capacity follow from the taken experts
    as moe.route computes them. Where its own argmax differs, the top
    probability's lead over the taken expert's is appended to `leads`.
    Every call of `routes` must be taken."""
    import torch
    import torch.nn.functional as F

    from pg_asr_tpu_torch.parallel import moe

    route = moe.route
    calls = iter(enumerate(routes))

    def replaying(params, pre, x, token_valid, capacity):
        r = route(params, pre, x, token_valid, capacity)
        i, taken = next(calls, (None, None))
        check(taken is not None and taken.shape == r.expert.shape,
              f"{pre}: {len(routes)} recorded routes, call "
              f"{i} of shape {None if taken is None else tuple(taken.shape)}"
              f" for {tuple(r.expert.shape)} tokens")
        taken = taken.to(r.expert.device, torch.long)
        gate = r.probs.gather(1, taken[:, None])[:, 0]
        differ = taken != r.expert
        if bool(differ.any()):
            leads.extend((r.gate - gate)[differ].tolist())
        valid = token_valid.reshape(-1)
        assign = F.one_hot(taken, r.probs.shape[1]) * valid[:, None]
        at = assign.t().contiguous()
        pos = ((torch.cumsum(at, dim=1) - at) * at).sum(dim=0)
        return moe.Routing(r.probs, taken, gate, assign, pos,
                           valid & (pos < capacity))

    moe.route = replaying
    try:
        yield leads
    finally:
        moe.route = route
    check(next(calls, None) is None,
          f"{len(routes)} recorded routes, fewer calls replayed them")


def ranks_routes(got: list, ranks: list, plan, key: str) -> list:
    """The experts the ranks of case `key` took, call by call, over the
    global batch: the data ranks' tokens in row order (the first rank of
    each (model, expert) group records them)."""
    import torch

    parts = sorted(((plan.coords(i)["data"], got[r][key]["routes"])
                    for i, r in enumerate(ranks)
                    if "routes" in got[r][key]), key=lambda p: p[0])
    check([p[0] for p in parts] == list(range(plan.sizes["data"]))
          and len({len(p[1]) for p in parts}) == 1,
          f"({key}) routes of data ranks {[p[0] for p in parts]}, "
          f"{[len(p[1]) for p in parts]} calls")
    return [torch.cat([p[1][j] for p in parts])
            for j in range(len(parts[0][1]))]


def shard_specs(alphabet):
    """Phase 19's models, float32, dropout 0, a constant rate of 1e-3,
    their weights from the seed on the host: the full-width switch-MoE
    (phase 17's: 6 blocks, d 256, 4 experts, capacity 1.25) and the
    flagship BiLSTM-CTC (phase 18's `mesh_spec`), also with the MWER
    objective (K=4); and phase 18's global B=64 x 5 s batch."""
    import dataclasses

    import torch

    from pg_asr_tpu_torch.config import Config, fit_vocab
    from pg_asr_tpu_torch.train import init_model_params

    cfg_c, params_c, batch = mesh_spec(alphabet)
    base = Config()
    cfg_m = fit_vocab(base.replace(
        model=dataclasses.replace(base.model, family="transformer",
                                  dropout=0.0),
        transformer=dataclasses.replace(base.transformer, num_experts=4,
                                        dropout=0.0),
        train=cfg_c.train), alphabet.size)
    check(cfg_m.transformer.capacity_factor == 1.25,
          f"moe capacity {cfg_m.transformer.capacity_factor}")
    params_m = init_model_params(cfg_m, torch.Generator().manual_seed(SEED),
                                 "cpu")
    cfg_pg = cfg_c.replace(rl=dataclasses.replace(cfg_c.rl, objective="mwer"))
    return {"moe": (cfg_m, params_m), "ctc": (cfg_c, params_c),
            "ctc_mwer": (cfg_pg, params_c)}, batch


def _meshed(cfg, spec: str, microbatches: int = 0):
    import dataclasses

    from pg_asr_tpu_torch.parallel.driver import parse_mesh_spec

    shape, axes = parse_mesh_spec(spec)
    return cfg.replace(train=dataclasses.replace(
        cfg.train, mesh_shape=shape, mesh_axes=axes,
        pipeline_microbatches=microbatches))


def _tree_bytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree.values())


def shard_case(case: dict, spec: dict, dev) -> dict:
    """One case of phase 19 or 20 on this rank of the joined group: `steps`
    steps of the model on the case's mesh from the spec's weights, its rows
    of the global batch; the losses, step ms, launches, resident bytes,
    peak memory, the first step's reduced gradients, the heads each
    flash-attention call took, the collectives alone timed, the gathered
    parameters. A "run" case is one epoch of train() on the mesh into its
    model directory."""
    import torch

    from pg_asr_tpu_torch.config import Config
    from pg_asr_tpu_torch.ops import flash_attn
    from pg_asr_tpu_torch.parallel import mesh
    from pg_asr_tpu_torch.rl.reinforce import make_pg_step
    from pg_asr_tpu_torch.train import (AdamW, make_plan, make_train_step,
                                        train)

    cfg = _meshed(Config.from_json(spec["configs"][case["model"]]),
                  case["mesh"], case.get("microbatches", 0))
    if case["kind"] == "run":
        import dataclasses

        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, num_epochs=1, batch_size=MESH_BS))
        reset_counts()
        t0 = time.perf_counter()
        train(spec["corpus"], case["model_dir"], config=cfg, device=str(dev))
        torch.cuda.synchronize()
        return {"counts": all_counts(), "wall_s": time.perf_counter() - t0}
    summed = []

    class Recorded(mesh.GroupRank):
        def sum_grads(self, grads):
            out = super().sum_grads(grads)
            if not summed:
                summed.append({k: v.cpu() for k, v in out.items()})
            return out

    dp = Recorded(dev, make_plan(cfg))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    params = dp.shard({k: v.to(dev, copy=True) for k, v in
                       spec["params"][case["model"]].items()})
    arrays = [torch.from_numpy(a).to(dev) for a in
              mesh.local_rows(spec["batch"], dp.rank, dp.world)]
    if case["kind"] == "pg":  # finetune_pg's optimizer and step
        opt = AdamW(cfg, params, learning_rate=cfg.train.learning_rate * 0.1,
                    weight_decay=1e-4, dp=dp)
        pg_step = make_pg_step(cfg, opt, dp=dp)

        def step(*args):
            return pg_step(*args)[0]
    else:
        opt = AdamW(cfg, params, dp=dp)
        step = make_train_step(cfg, opt, dp)
    gen = torch.Generator().manual_seed(SEED)  # several ranks: the host
    heads = set()  # the heads of each flash-attention call
    mhsa = flash_attn.mhsa

    def counted(q, *args, **kwargs):
        heads.add(int(q.shape[1]))
        return mhsa(q, *args, **kwargs)

    flash_attn.mhsa = counted
    # a MoE case's experts, from the first rank of each (model, expert)
    # group: the one-process steps replay them (routes_replayed)
    routes = []
    record = (routes_recorded(routes) if case.get("routes")
              and dp.model_index == 0 and dp.expert_index == 0
              else contextlib.nullcontext())
    reset_counts()
    losses, ms = [], []
    try:
        with record:
            for _ in range(case["steps"]):
                t0 = time.perf_counter()
                losses.append(step(params, gen, *arrays).item())  # syncs
                ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        flash_attn.mhsa = mhsa
    counts = all_counts()
    res = {"losses": losses, "ms": ms, "counts": counts,
           "rows": int(arrays[0].shape[0]), "grads": summed[0],
           "resident": _tree_bytes(params, opt.mu, opt.nu),
           "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
           "flash_heads": sorted(heads),
           "shapes": {k: tuple(v.shape) for k, v in params.items()}}
    if routes:
        res["routes"] = [t.cpu() for t in routes]
    if dp.fsdp_size > 1:  # the step's gather and its reduce-scatter alone
        res["all_gather_ms"] = time_ms(lambda: dp.unshard(params), 5)
        full = dp.unshard(params)
        res["reduce_scatter_ms"] = time_ms(lambda: dp.sum_grads(full), 5)
    if dp.expert_size > 1:  # one block's combine: (rows x T') x d float32
        t_out = -(-(WAVE_SAMPLES // cfg.features.hop_length + 1)
                  // cfg.transformer.subsample)
        out = torch.ones(res["rows"] * t_out, cfg.transformer.d_model,
                         device=dev)
        res["combine_ms"] = time_ms(lambda: dp.group_sum(out, "expert"), 5)
        res["combine_mb"] = out.numel() * 4 / 1e6
    if dp.model_size > 1:
        # the step's gathers of the leaves no pair computes in parts, and
        # one pair's sum of the partial outputs, (rows x T') x d float32
        gathered = [k for k, v in dp.forward_params(params).items()
                    if v.shape != params[k].shape]
        res["gather_ms"] = time_ms(lambda: dp.forward_params(params), 5)
        res["gather_mb"] = sum(spec["params"][case["model"]][k].numel() * 4
                               for k in gathered) / 1e6
        enc = (cfg.transducer.encoder if cfg.model.family == "transducer"
               else cfg.model.family)
        if enc in ("transformer", "conformer"):
            sub = getattr(cfg, enc)
            t_out = -(-(WAVE_SAMPLES // cfg.features.hop_length + 1)
                      // sub.subsample)
            out = torch.ones(res["rows"] * t_out, sub.d_model, device=dev)
            res["model_sum_ms"] = time_ms(lambda: dp.group_sum(out, "model"),
                                          5)
            res["model_sum_mb"] = out.numel() * 4 / 1e6
    tcfg = cfg.transformer
    t_out = -(-(WAVE_SAMPLES // cfg.features.hop_length + 1)
              // tcfg.subsample)
    if dp.pipe_size > 1:
        # one microbatch's activations passed one stage on (float32)
        act = torch.ones(-(-res["rows"] // dp.microbatches), t_out,
                         tcfg.d_model, device=dev)
        s, last = dp.pipe_index, dp.pipe_size - 1

        def hop():
            sends = [dp.pipe_send(act, s + 1)] if s < last else []
            if s > 0:
                dp.pipe_recv(tuple(act.shape), act.dtype, s - 1)
            dp.wait_all(sends)

        res["send_recv_ms"] = time_ms(hop, 5)
        res["send_recv_mb"] = act.numel() * 4 / 1e6
    if dp.seq_size > 1:
        # one block's keys gathered over the seq group, and the
        # reduce-scatter of their gradient
        S, h = dp.seq_size, tcfg.num_heads
        whole = torch.ones(res["rows"], h, -(-t_out // S) * S,
                           tcfg.d_model // h, device=dev)
        part = whole[:, :, :whole.shape[2] // S].contiguous()
        res["seq_gather_ms"] = time_ms(lambda: dp.seq_gather(part, 2), 5)
        res["seq_reduce_scatter_ms"] = time_ms(
            lambda: dp.seq_reduce_scatter(whole, 2), 5)
        res["seq_gather_mb"] = whole.numel() * 4 / 1e6
    res["params"] = {k: v.cpu() for k, v in dp.unshard(params).items()}
    return res


def shard_worker(spec_path: str, rank: int) -> int:
    """`python3 chip_smoke.py --shard-worker SPEC RANK`: process RANK of
    phase 19's four, on the spec's device (the card) over gloo: each group
    of the spec it belongs to joined in turn (a case may wait for another
    group's marker file, so that two groups never time the card at once),
    its cases run, the results into the spec's directory."""
    import torch

    from pg_asr_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(spec_path, weights_only=False)
    dev = torch.device(spec["device"])
    out = {}
    for group in spec["groups"]:
        if rank not in group["ranks"]:
            continue
        me = group["ranks"].index(rank)
        mesh.init_distributed(f"127.0.0.1:{group['port']}",
                              len(group["ranks"]), me, backend="gloo",
                              device=dev)
        try:
            for case in group["cases"]:
                if case.get("after"):
                    end = time.monotonic() + 600
                    while not os.path.exists(case["after"]):
                        check(time.monotonic() < end,
                              f"{case['name']}: no {case['after']}")
                        time.sleep(0.05)
                out[case["name"]] = shard_case(case, spec, dev)
                if case.get("done") and me == 0:
                    with open(case["done"], "w") as fo:
                        fo.write("done")
        finally:
            mesh.destroy_distributed()
    torch.save(out, os.path.join(spec["dir"], f"shard_rank{rank}.pt"))
    return 0


def phase_shard(dev, corpus, alphabet, d):
    """19. The expert and fsdp mesh axes, four rank processes on the one
    card over gloo (NCCL takes one rank a device) against the one-process
    steps on the same global B=64 x 5 s batch from the same weights: (a)
    `expert=2` on the full-width switch-MoE, SHARD_STEPS steps, ranks 0-1;
    (b) `data=2,expert=2`, SHARD_STEPS_B steps, all four; (c) `fsdp=2` on
    the flagship BiLSTM-CTC, SHARD_STEPS steps, ranks 2-3, then (e)
    SHARD_STEPS_B MWER policy-gradient steps under `fsdp=2` (the n-best on
    `ctc_beam`), and (d) one epoch of train() under `fsdp=2` whose
    checkpoint (in the one-device shapes) `--mode predict` serves and
    `--mode train` resumes for one epoch without a mesh. Each case prints its losses, the
    gradients' and parameters' largest difference relative to each
    tensor's largest, each rank's resident bytes of parameters and AdamW
    moments against one process's, the step ms beside the one-process
    step's (timed before and after the ranks), the collectives alone, and
    each rank's launches (rows 3r and 4 under (c))."""
    import numpy as np
    import torch

    from pg_asr_tpu_torch.checkpoint import load_checkpoint
    from pg_asr_tpu_torch.parallel import mesh
    from pg_asr_tpu_torch.parallel.driver import ParallelPlan
    from pg_asr_tpu_torch.rl.reinforce import make_pg_step
    from pg_asr_tpu_torch.train import AdamW, loss_and_grads, make_train_step

    t_phase = time.perf_counter()
    specs, batch = shard_specs(alphabet)
    arrays = [torch.from_numpy(a).to(dev) for a in batch]
    _, res, bwd, per = route_counters()

    def pg_reference() -> list:
        """SHARD_STEPS_B one-process MWER steps' losses."""
        cfg, params0 = specs["ctc_mwer"]
        p = {k: v.to(dev, copy=True) for k, v in params0.items()}
        step = make_pg_step(cfg, AdamW(
            cfg, p, learning_rate=cfg.train.learning_rate * 0.1,
            weight_decay=1e-4))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return [step(p, gen, *arrays)[0].item()
                for _ in range(SHARD_STEPS_B)]

    def reference(model: str, n: int = SHARD_STEPS,
                  routes: list | None = None) -> dict:
        """n one-process steps (the experts of `routes` replayed, the
        leads of the replayed experts' near-ties kept): the losses, the
        first step's gradients, the parameters after each step, the mask,
        the resident bytes."""
        cfg, params0 = specs[model]
        p = {k: v.to(dev, copy=True) for k, v in params0.items()}
        opt = AdamW(cfg, p)
        out = {"losses": [], "after": [], "grads": None, "leads": []}
        sure = {k: torch.ones_like(v, dtype=torch.bool) for k, v in p.items()}
        replay = (routes_replayed(routes, out["leads"]) if routes is not None
                  else contextlib.nullcontext())
        with replay:
            for _ in range(n):
                loss, grads = loss_and_grads(p, arrays, cfg)
                out["losses"].append(loss.item())
                if out["grads"] is None:
                    out["grads"] = {k: g.cpu() for k, g in grads.items()}
                sure = {k: sure[k] & (grads[k].abs() > max(
                    MESH_GRAD_FLOOR,
                    SHARD_GRAD_REL * grads[k].abs().max().item()))
                        for k in sure}
                opt.update(p, grads)
                out["after"].append({k: v.to("cpu", copy=True)
                                     for k, v in p.items()})
                out.setdefault("sure", []).append(
                    {k: v.to("cpu", copy=True) for k, v in sure.items()})
        out["resident"] = _tree_bytes(p, opt.mu, opt.nu)
        return out

    def outside(params: dict, want: dict, sure: dict) -> int:
        """The checked elements of `params` outside the tolerance."""
        return sum(int(((params[k] - v).abs() > MESH_ATOL + MESH_RTOL
                        * v.abs())[sure[k]].sum()) for k, v in want.items())

    def plain_ms(model: str) -> float:
        cfg, params0 = specs[model]
        p = {k: v.to(dev, copy=True) for k, v in params0.items()}
        step = make_train_step(cfg, AdamW(cfg, p))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return time_ms(lambda: step(p, gen, *arrays), SHARD_PLAIN_REPS)

    # the MoE's steps on its own routing, printed beside the checks' (on
    # the ranks' routing, after them)
    own_routes = []
    with routes_recorded(own_routes):
        refs = {"moe": reference("moe")}
    refs["ctc"] = reference("ctc")
    turns = {m: [plain_ms(m)] for m in ("moe", "ctc")}
    pg_losses = pg_reference()

    # the four processes: (b) in a group of 4, then (a) on ranks 0-1 and,
    # after it, (c) and (d) on ranks 2-3
    marker = os.path.join(d, "shard_a_done")
    run_dir = os.path.join(d, "shard_fsdp2")
    cases = {
        "b": {"name": "b", "model": "moe", "mesh": "data=2,expert=2",
              "kind": "steps", "steps": SHARD_STEPS_B, "routes": True},
        "a": {"name": "a", "model": "moe", "mesh": "expert=2",
              "kind": "steps", "steps": SHARD_STEPS, "done": marker,
              "routes": True},
        "c": {"name": "c", "model": "ctc", "mesh": "fsdp=2",
              "kind": "steps", "steps": SHARD_STEPS, "after": marker},
        "e": {"name": "e", "model": "ctc_mwer", "mesh": "fsdp=2",
              "kind": "pg", "steps": SHARD_STEPS_B},
        "d": {"name": "d", "model": "ctc", "mesh": "fsdp=2", "kind": "run",
              "model_dir": run_dir},
    }
    spec_path = os.path.join(d, "shard_spec.pt")
    torch.save({"device": str(dev), "dir": d, "corpus": corpus,
                "batch": batch,
                "configs": {m: c.to_json() for m, (c, _) in specs.items()},
                "params": {m: p for m, (_, p) in specs.items()},
                "groups": [
                    {"ranks": [0, 1, 2, 3], "port": mesh.free_port(),
                     "cases": [cases["b"]]},
                    {"ranks": [0, 1], "port": mesh.free_port(),
                     "cases": [cases["a"]]},
                    {"ranks": [2, 3], "port": mesh.free_port(),
                     "cases": [cases["c"], cases["e"], cases["d"]]}]},
               spec_path)
    logs = [os.path.join(d, f"shard_rank{r}.log") for r in range(4)]
    t0 = time.perf_counter()
    procs = []
    for r in range(4):
        with open(logs[r], "w") as fo:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--shard-worker",
                 spec_path, str(r)], stdout=fo, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__))))
    try:
        rcs = [p.wait(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_ranks = time.perf_counter() - t0
    for r, rc in enumerate(rcs):
        with open(logs[r]) as fo:
            log = fo.read()
        check(rc == 0, f"phase 19 rank {r}: rc {rc}\n{log[-3000:]}")
    got = [torch.load(os.path.join(d, f"shard_rank{r}.pt"),
                      weights_only=False) for r in range(4)]
    for m in turns:
        turns[m].append(plain_ms(m))
    # the MoE cases' one-process steps on the experts their ranks took
    replayed, own = {}, {}
    for key, ranks in (("b", [0, 1, 2, 3]), ("a", [0, 1])):
        cfg = _meshed(specs["moe"][0], cases[key]["mesh"])
        plan = ParallelPlan(cfg, cfg.train.mesh_shape, cfg.train.mesh_axes)
        taken = ranks_routes(got, ranks, plan, key)
        replayed[key] = reference("moe", cases[key]["steps"], taken)
        n = cases[key]["steps"]
        own[key] = {"tokens_differ": sum(
            int((t != o.cpu()).sum()) for t, o in zip(taken, own_routes)),
            "outliers": outside(got[ranks[0]][key]["params"],
                                refs["moe"]["after"][n - 1],
                                refs["moe"]["sure"][n - 1])}

    result, launches = {}, {}
    for key, ranks in (("b", [0, 1, 2, 3]), ("a", [0, 1]), ("c", [2, 3])):
        case = cases[key]
        cfg = _meshed(specs[case["model"]][0], case["mesh"])
        plan = ParallelPlan(cfg, cfg.train.mesh_shape, cfg.train.mesh_axes)
        ref = replayed[key] if key in replayed else refs[case["model"]]
        n = case["steps"]
        worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
        leads = ref["leads"]
        check(max(leads, default=0.0) <= ROUTE_TIE,
              f"({key}) at {len(leads)} tokens one process's top-1 expert "
              f"is not the ranks', its lead up to {max(leads, default=0):.3e}")
        for i, r in enumerate(ranks):
            rk = got[r][key]
            coords = plan.coords(i)
            for a, b in zip(rk["losses"], ref["losses"][:n]):
                worst["loss"] = max(worst["loss"], abs(a - b) / abs(b))
                check(abs(a - b) <= MESH_ATOL + MESH_RTOL * abs(b),
                      f"({key}) rank {r} losses {rk['losses']} vs "
                      f"{ref['losses'][:n]}")
            for k, g in ref["grads"].items():
                where = plan.placement(k, tuple(g.shape))
                if where is not None:
                    axis, dim = where
                    g = mesh.shard_leaf(g, dim, coords[axis],
                                        plan.sizes[axis])
                diff = (rk["grads"][k] - g).abs()
                top = g.abs().max()
                worst["grad"] = max(worst["grad"], (diff.max() / top).item())
                check(bool((diff <= MESH_ATOL * top
                            + MESH_RTOL * g.abs()).all()),
                      f"({key}) rank {r} the reduced gradient of {k}: "
                      f"max|diff| {diff.max().item():.3e}, max|g| "
                      f"{top.item():.3e}")
            want, sure = ref["after"][n - 1], ref["sure"][n - 1]
            outliers, checked, far = [], 0, 0.0
            for k, v in want.items():
                diff = (rk["params"][k] - v).abs()
                worst["param"] = max(worst["param"], (
                    diff.max() / v.abs().max()).item())
                bad = (diff > MESH_ATOL + MESH_RTOL * v.abs()) & sure[k]
                checked += int(sure[k].sum())
                if bad.any():
                    far = max(far, diff[bad].max().item())
                    outliers.append(
                        f"{k}: {int(bad.sum())} of {bad.numel()}, max|diff| "
                        f"{diff[bad].max().item():.3e}, first-step |g| <= "
                        f"{ref['grads'][k].abs()[bad].max():.3e} (max|g| "
                        f"{ref['grads'][k].abs().max():.3e})")
            n_out = sum(int(o.split(": ")[1].split(" of")[0])
                        for o in outliers)
            worst["outliers"] = max(worst.get("outliers", 0), n_out)
            if outliers:
                print(f"[shard] ({key}) rank {r} parameters outside the "
                      f"tolerance: " + "; ".join(outliers))
            check(n_out <= SHARD_OUTLIERS * checked
                  and far <= 2 * n * cfg.train.learning_rate,
                  f"({key}) rank {r}: {n_out} of {checked} parameters "
                  f"outside the tolerance, the farthest {far:.3e}")
            if key == "c":
                check(rk["counts"][res] == per * n
                      and rk["counts"][bwd] == per * n
                      and sum(rk["counts"].values()) == 2 * per * n,
                      f"(c) rank {r} launches {rk['counts']}")
            else:  # the MoE launches no kernel of the port
                check(sum(rk["counts"].values()) == 0,
                      f"({key}) rank {r} launches {rk['counts']}")
            launches[f"shard_{key}_r{r}_train"] = rk["counts"]
        same = all(torch.equal(got[ranks[0]][key]["params"][k],
                               got[r][key]["params"][k])
                   for r in ranks[1:] for k in ref["grads"])
        check(same, f"({key}) the ranks' gathered parameters differ")
        rank_ms = [float(np.mean(got[r][key]["ms"][1:])) for r in ranks]
        resident = [got[r][key]["resident"] for r in ranks]
        sure = ref["sure"][n - 1]
        left_out = sum(int((~v).sum()) for v in sure.values())
        extra = {k: [got[r][key][k] for r in ranks]
                 for k in ("all_gather_ms", "reduce_scatter_ms",
                           "combine_ms", "combine_mb")
                 if k in got[ranks[0]][key]}
        result[key] = {"mesh": case["mesh"], "model": case["model"],
                       "rows": got[ranks[0]][key]["rows"],
                       "losses": [got[r][key]["losses"] for r in ranks],
                       "one_process_losses": ref["losses"][:n],
                       "worst": worst, "left_out": left_out,
                       "routes_differ": len(leads),
                       "routes_lead": max(leads, default=0.0),
                       "own_routing": own.get(key),
                       "step_ms": rank_ms,
                       "one_process_step_ms": turns[case["model"]],
                       "resident_bytes": resident,
                       "one_process_resident_bytes": ref["resident"],
                       "launches": [got[r][key]["counts"] for r in ranks],
                       **extra}
        print(f"[shard] ({key}) --mesh {case['mesh']} on the "
              f"{case['model']} at B={MESH_BS} x 5 s, {len(ranks)} gloo "
              f"ranks on cuda:0, {result[key]['rows']} rows each, {n} "
              f"steps: losses {got[ranks[0]][key]['losses']} vs one "
              f"process {ref['losses'][:n]} (worst rel "
              f"{worst['loss']:.2e}); the first step's reduced gradients, "
              f"every element: worst max|diff| / max|g| {worst['grad']:.2e}"
              f"; parameters gathered, equal on every rank: worst max|diff|"
              f" / max|p| {worst['param']:.2e} (rtol {MESH_RTOL:g} / atol "
              f"{MESH_ATOL:g} where every step's |g| > {MESH_GRAD_FLOOR:g} "
              f"and {SHARD_GRAD_REL:g} of its tensor's largest: {left_out} "
              f"of {sum(v.numel() for v in sure.values())} left out, "
              f"{worst.get('outliers', 0)} outside the tolerance at most on "
              f"a rank); "
              + (f"one process on the ranks' experts (at {len(leads)} "
                 f"tokens its own top-1 differs, leading by at most "
                 f"{max(leads, default=0.0):.2e}; on its own routing, not "
                 f"held: {own[key]['tokens_differ']} tokens of the ranks' "
                 f"took another expert, {own[key]['outliers']} parameters "
                 f"of rank {ranks[0]} outside the tolerance); "
                 if key in replayed else "")
              + f"resident parameters + AdamW moments a rank "
              f"{[round(b / 1e6, 2) for b in resident]} MB vs one process "
              f"{ref['resident'] / 1e6:.2f} MB; step ms a rank (steps "
              f"2-{n}, host clock) {[round(m, 2) for m in rank_ms]}, one "
              f"process before / after {[round(m, 2) for m in turns[case['model']]]}"
              + "".join(f"; {k} {[round(v, 3) for v in vs]}"
                        for k, vs in extra.items())
              + f"; launches a rank {got[ranks[0]][key]['counts']}")
        if key != "c":
            stacks = [s for k, s in got[ranks[0]][key]["shapes"].items()
                      if k.endswith(".w1")]
            check(all(s[0] == 2 for s in stacks),
                  f"({key}) expert stacks {stacks}")

    # (e) MWER steps under fsdp=2: the losses, each rank's launches (its
    # n-best on ctc_beam, its rows through rows 3r and 4)
    for r in (2, 3):
        rk = got[r]["e"]
        for a, b in zip(rk["losses"], pg_losses):
            check(abs(a - b) <= MESH_ATOL + MESH_RTOL * abs(b),
                  f"(e) rank {r} MWER losses {rk['losses']} vs {pg_losses}")
        n = SHARD_STEPS_B
        check(rk["counts"]["ctc_beam"] == n and rk["counts"][res] == per * n
              and rk["counts"][bwd] == per * n
              and sum(rk["counts"].values()) == (2 * per + 1) * n,
              f"(e) rank {r} launches {rk['counts']}")
        launches[f"shard_e_r{r}_pg_mwer"] = rk["counts"]
    result["e"] = {"losses": [got[r]["e"]["losses"] for r in (2, 3)],
                   "one_process_losses": pg_losses,
                   "step_ms": [float(np.mean(got[r]["e"]["ms"][1:]))
                               for r in (2, 3)]}
    print(f"[shard] (e) --mesh fsdp=2, {SHARD_STEPS_B} MWER steps (K=4) on "
          f"the BiLSTM-CTC, ranks 2-3, {MESH_BS // 2} rows each: losses "
          f"{result['e']['losses'][0]} vs one process {pg_losses}; step ms "
          f"a rank {[round(m, 2) for m in result['e']['step_ms']]}; "
          f"launches a rank {got[2]['e']['counts']}")

    # (d) the fsdp=2 epoch's checkpoint in the one-device shapes, served
    # by predict on one device and resumed for an epoch without a mesh
    last = load_checkpoint(os.path.join(run_dir, "model_last.pt"))
    shapes = {k: v.shape for k, v in specs["ctc"][1].items()}
    check({k: v.shape for k, v in last["params"].items()} == shapes
          and {k: v.shape for k, v in last["opt_state"]["mu"].items()}
          == shapes, "(d) the checkpoint's shapes are not one device's")
    epoch = {k: np.load(os.path.join(run_dir, f"{k}.npy")).tolist()
             for k in ("train_loss", "val_losses")}
    d_counts = [got[r]["d"]["counts"] for r in (2, 3)]
    rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                       "--model_path", run_dir, "--device", str(dev)])
    check(rc == 0 and "CER:" in out, f"(d) predict: rc {rc}")
    reset_counts()
    rc, out = run_cli(["--mode", "train", "--corpus_path", corpus,
                       "--model_path", run_dir, "--device", str(dev),
                       "--num_epochs", "2", "--batch_size", str(MESH_BS)])
    resume_counts = all_counts()
    tl = np.load(os.path.join(run_dir, "train_loss.npy"))
    check(rc == 0 and "resumed from epoch 1" in out and len(tl) == 2
          and np.isfinite(tl).all(), f"(d) the resume: rc {rc}, {tl}")
    check(resume_counts[res] == resume_counts[bwd] > 0,
          f"(d) resumed launches {resume_counts}")
    launches["shard_d_fsdp2_epoch_r2"] = d_counts[0]
    launches["shard_d_fsdp2_epoch_r3"] = d_counts[1]
    launches["shard_d_resume_no_mesh"] = resume_counts
    print(f"[shard] (d) one epoch of train() under --mesh fsdp=2 (ranks 2-3,"
          f" {MESH_BS // 2} rows each, {[round(got[r]['d']['wall_s'], 1) for r in (2, 3)]} s): "
          f"train / val loss {epoch['train_loss']} / {epoch['val_losses']}; "
          f"its checkpoint in the one-device shapes (parameters and AdamW "
          f"moments); launches a rank {d_counts}; --mode predict on one "
          f"device served it; --mode train resumed it for an epoch without "
          f"a mesh (train losses {tl.tolist()}, launches {resume_counts})")
    result["d"] = {"epoch": epoch, "wall_s": [got[r]["d"]["wall_s"]
                                              for r in (2, 3)],
                   "resumed_train_losses": tl.tolist()}
    result["ranks_wall_s"] = wall_ranks
    result["wall_s"] = time.perf_counter() - t_phase
    print(f"[shard] phase 19 in {result['wall_s']:.1f} s (the four rank "
          f"processes {wall_ranks:.1f} s)")
    result["launches"] = launches
    return result


TENSOR_STEPS = 2  # phase 20's steps a case
# the first step's reduced gradients of a model axis's rank against the
# same parts of the one-process gradients, max|diff| / max|g| a leaf: the
# ranks sum the partial products of every pair in another order than one
# GEMM does, block after block, and a leaf that sums over the batch's
# 12.9 K tokens cancels (the worst seen, 3.4e-5 of its largest, is the
# third block's switch router under model=2,expert=2; the conformer's
# head 1.3e-5; the BiLSTM-CTC's 1.9e-7); a wrong reduction's scale or a
# part counted twice moves every element by half or more
TENSOR_GRAD_REL = 1e-4


def tensor_specs(alphabet):
    """Phase 20's models, float32, dropout 0, a constant rate of 1e-3,
    their weights from the seed on the host: phase 19's switch-MoE,
    BiLSTM-CTC and its MWER objective; the full-width conformer-CTC with
    flash_attention; the transducer with the full-width transformer
    encoder, its joint unfused and fused (one set of weights); and phase
    18's global B=64 x 5 s batch."""
    import dataclasses

    import torch

    from pg_asr_tpu_torch.config import Config, fit_vocab
    from pg_asr_tpu_torch.train import init_model_params

    specs, batch = shard_specs(alphabet)
    base, train_cfg = Config(), specs["ctc"][0].train
    conf = fit_vocab(base.replace(
        model=dataclasses.replace(base.model, family="conformer",
                                  dropout=0.0),
        conformer=dataclasses.replace(base.conformer, dropout=0.0,
                                      flash_attention=True),
        train=train_cfg), alphabet.size)
    rnnt = fit_vocab(base.replace(
        model=dataclasses.replace(base.model, family="transducer",
                                  dropout=0.0),
        transformer=dataclasses.replace(base.transformer, dropout=0.0),
        transducer=dataclasses.replace(base.transducer,
                                       encoder="transformer",
                                       fused_joint=False),
        train=train_cfg), alphabet.size)
    fused = rnnt.replace(transducer=dataclasses.replace(rnnt.transducer,
                                                        fused_joint=True))
    for name, cfg in (("conformer", conf), ("transducer", rnnt)):
        specs[name] = (cfg, init_model_params(
            cfg, torch.Generator().manual_seed(SEED), "cpu"))
    specs["transducer_fused"] = (fused, specs["transducer"][1])
    return specs, batch


def model_part(plan, k: str, v, coords: dict):
    """The part of full-shape leaf `k` that the rank at `coords` of `plan`
    holds: put in the model axis's run layout, then each split taken."""
    from pg_asr_tpu_torch.parallel import mesh, tensor

    for axis, dim in plan.splits(k, tuple(v.shape)):
        if axis == "model":
            v = tensor.to_run(k, v, plan.sizes["model"])
        v = mesh.shard_leaf(v, dim, coords[axis], plan.sizes[axis])
    return v


def predicted_bytes(plan, params: dict, coords: dict | None = None) -> int:
    """A rank's parameters and AdamW moments (three float32 copies of each
    leaf's part), from the shapes and the plan's splits alone; with the
    rank's `coords`, only the leaves its pipeline stage holds."""
    total = 0
    for k, v in params.items():
        if coords is not None and plan.stage(k) not in (None,
                                                        coords["pipe"]):
            continue
        n = v.numel()
        for axis, _ in plan.splits(k, tuple(v.shape)):
            n //= plan.sizes[axis]
        total += 3 * n * v.element_size()
    return total


def phase_tensor(dev, corpus, alphabet, d):
    """20. The model mesh axis (Megatron tensor parallelism), gloo rank
    processes on the one card against the one-process steps on the same
    global B=64 x 5 s batch from the same weights: (a) `model=2` on the
    full-width conformer with flash_attention (the kernels on 2 heads a
    rank); (b) `model=2` on the flagship BiLSTM-CTC (rows 3r and 4 on the
    gathered W and U); (c) `model=2,expert=2` on the full-width switch-MoE,
    four ranks; (d) `model=2` on the transducer with the transformer
    encoder, its joint unfused and fused (rows 5 and 6 on the gathered
    projections); (e) TENSOR_STEPS MWER steps under `model=2`; (f) one
    epoch of train() under `model=2` on the conformer, whose checkpoint
    (full shapes, canonical layout) `--mode predict` serves on one device
    and `--mode train` resumes without a mesh. Each case prints its losses,
    the gradients' and parameters' largest difference relative to each
    tensor's largest, each rank's resident bytes of parameters and AdamW
    moments beside the share its splits predict and one process's, each
    rank's peak memory beside one process's, the step ms beside one
    process's, the collectives alone, and each rank's launches."""
    import numpy as np
    import torch

    from pg_asr_tpu_torch.checkpoint import load_checkpoint
    from pg_asr_tpu_torch.parallel import mesh
    from pg_asr_tpu_torch.parallel.driver import ParallelPlan
    from pg_asr_tpu_torch.rl.reinforce import make_pg_step
    from pg_asr_tpu_torch.train import AdamW, loss_and_grads

    t_phase = time.perf_counter()
    specs, batch = tensor_specs(alphabet)
    arrays = [torch.from_numpy(a).to(dev) for a in batch]
    _, res, bwd, per = route_counters()
    n = TENSOR_STEPS

    def reference(model: str, routes: list | None = None) -> dict:
        """n one-process steps (the experts of `routes` replayed, the
        leads of the replayed experts' near-ties kept): the losses, the
        first step's gradients, the parameters after, the mask, the
        resident and peak bytes, the step ms (host clock, synchronized)."""
        cfg, params0 = specs[model]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        p = {k: v.to(dev, copy=True) for k, v in params0.items()}
        opt = AdamW(cfg, p)
        out = {"losses": [], "grads": None, "ms": [], "leads": []}
        sure = {k: torch.ones_like(v, dtype=torch.bool) for k, v in p.items()}
        replay = (routes_replayed(routes, out["leads"]) if routes is not None
                  else contextlib.nullcontext())
        with replay:
            for _ in range(n):
                t0 = time.perf_counter()
                loss, grads = loss_and_grads(p, arrays, cfg)
                out["losses"].append(loss.item())
                if out["grads"] is None:
                    out["grads"] = {k: g.cpu() for k, g in grads.items()}
                sure = {k: sure[k] & (grads[k].abs() > max(
                    MESH_GRAD_FLOOR,
                    SHARD_GRAD_REL * grads[k].abs().max().item()))
                        for k in sure}
                opt.update(p, grads)
                torch.cuda.synchronize()
                out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["after"] = {k: v.cpu() for k, v in p.items()}
        out["sure"] = {k: v.cpu() for k, v in sure.items()}
        out["resident"] = _tree_bytes(p, opt.mu, opt.nu)
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
        del p, opt, grads
        torch.cuda.empty_cache()
        return out

    def pg_reference() -> list:
        cfg, params0 = specs["ctc_mwer"]
        p = {k: v.to(dev, copy=True) for k, v in params0.items()}
        step = make_pg_step(cfg, AdamW(
            cfg, p, learning_rate=cfg.train.learning_rate * 0.1,
            weight_decay=1e-4))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return [step(p, gen, *arrays)[0].item() for _ in range(n)]

    models = ("conformer", "ctc", "moe", "transducer", "transducer_fused")
    refs = {m: reference(m) for m in models}
    pg_losses = pg_reference()

    # the four processes: (c) in a group of 4; then ranks 0-1 run (a), (d)
    # and (f), and after them ranks 2-3 run (b) and (e), so that no two
    # groups time the card at once
    marker = os.path.join(d, "tensor_01_done")
    run_dir = os.path.join(d, "tensor_model2")
    cases = {
        "c": {"name": "c", "model": "moe", "mesh": "model=2,expert=2",
              "kind": "steps", "steps": n, "routes": True},
        "a": {"name": "a", "model": "conformer", "mesh": "model=2",
              "kind": "steps", "steps": n},
        "d": {"name": "d", "model": "transducer", "mesh": "model=2",
              "kind": "steps", "steps": n},
        "d_fused": {"name": "d_fused", "model": "transducer_fused",
                    "mesh": "model=2", "kind": "steps", "steps": n},
        "f": {"name": "f", "model": "conformer", "mesh": "model=2",
              "kind": "run", "model_dir": run_dir, "done": marker},
        "b": {"name": "b", "model": "ctc", "mesh": "model=2",
              "kind": "steps", "steps": n, "after": marker},
        "e": {"name": "e", "model": "ctc_mwer", "mesh": "model=2",
              "kind": "pg", "steps": n},
    }
    spec_path = os.path.join(d, "tensor_spec.pt")
    torch.save({"device": str(dev), "dir": d, "corpus": corpus,
                "batch": batch,
                "configs": {m: c.to_json() for m, (c, _) in specs.items()},
                "params": {m: p for m, (_, p) in specs.items()},
                "groups": [
                    {"ranks": [0, 1, 2, 3], "port": mesh.free_port(),
                     "cases": [cases["c"]]},
                    {"ranks": [0, 1], "port": mesh.free_port(),
                     "cases": [cases[k] for k in ("a", "d", "d_fused",
                                                  "f")]},
                    {"ranks": [2, 3], "port": mesh.free_port(),
                     "cases": [cases["b"], cases["e"]]}]},
               spec_path)
    logs = [os.path.join(d, f"tensor_rank{r}.log") for r in range(4)]
    t0 = time.perf_counter()
    procs = []
    for r in range(4):
        with open(logs[r], "w") as fo:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--shard-worker",
                 spec_path, str(r)], stdout=fo, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__))))
    try:
        rcs = [p.wait(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_ranks = time.perf_counter() - t0
    for r, rc in enumerate(rcs):
        with open(logs[r]) as fo:
            log = fo.read()
        check(rc == 0, f"phase 20 rank {r}: rc {rc}\n{log[-3000:]}")
    got = [torch.load(os.path.join(d, f"shard_rank{r}.pt"),
                      weights_only=False) for r in range(4)]
    # (c)'s one-process steps on the experts its ranks took (the checks'
    # reference; refs["moe"] stays the timed one)
    cfg = _meshed(specs["moe"][0], cases["c"]["mesh"])
    replayed = {"c": reference("moe", ranks_routes(
        got, [0, 1, 2, 3], ParallelPlan(cfg, cfg.train.mesh_shape,
                                        cfg.train.mesh_axes), "c"))}

    # each case's launches a rank in its n steps: the conformer's flash
    # forward (residual form) and backward per block, the BiLSTM's rows 3r
    # and 4 per layer, the fused joint's rows 5 and 6, nothing of the
    # port's kernels for the MoE and the unfused transducer
    blocks = specs["conformer"][0].conformer.num_layers
    want_counts = {
        "a": {"flash_attn_residual": blocks * n, "flash_attn_bwd_dkv":
              blocks * n, "flash_attn_bwd_dq": blocks * n},
        "b": {res: per * n, bwd: per * n},
        "c": {}, "d": {},
        "d_fused": {"joint_fwd": n, "joint_bwd": n},
    }
    result, launches = {}, {}
    for key, ranks in (("c", [0, 1, 2, 3]), ("a", [0, 1]), ("d", [0, 1]),
                       ("d_fused", [0, 1]), ("b", [2, 3])):
        case = cases[key]
        cfg = _meshed(specs[case["model"]][0], case["mesh"])
        plan = ParallelPlan(cfg, cfg.train.mesh_shape, cfg.train.mesh_axes)
        timed_ref = refs[case["model"]]
        ref = replayed.get(key, timed_ref)
        predicted = predicted_bytes(plan, specs[case["model"]][1])
        worst = {"loss": 0.0, "grad": 0.0, "param": 0.0, "outliers": 0}
        leads = ref["leads"]
        check(max(leads, default=0.0) <= ROUTE_TIE,
              f"({key}) at {len(leads)} tokens one process's top-1 expert "
              f"is not the ranks', its lead up to {max(leads, default=0):.3e}")
        for i, r in enumerate(ranks):
            rk = got[r][key]
            coords = plan.coords(i)
            for a, b in zip(rk["losses"], ref["losses"]):
                worst["loss"] = max(worst["loss"], abs(a - b) / abs(b))
                check(abs(a - b) <= MESH_ATOL + MESH_RTOL * abs(b),
                      f"({key}) rank {r} losses {rk['losses']} vs "
                      f"{ref['losses']}")
            for k, g in ref["grads"].items():
                g = model_part(plan, k, g, coords)
                diff = (rk["grads"][k] - g).abs()
                top = g.abs().max()
                rel = (diff.max() / top).item()
                if rel > worst["grad"]:
                    worst["grad"], worst["grad_leaf"] = rel, k
                check(rel <= TENSOR_GRAD_REL,
                      f"({key}) rank {r} the reduced gradient of {k}: "
                      f"max|diff| {diff.max().item():.3e}, max|g| "
                      f"{top.item():.3e}")
            outliers, checked, far = 0, 0, 0.0
            for k, v in ref["after"].items():
                diff = (rk["params"][k] - v).abs()
                worst["param"] = max(worst["param"], (
                    diff.max() / v.abs().max()).item())
                bad = (diff > MESH_ATOL + MESH_RTOL * v.abs()) & ref["sure"][k]
                checked += int(ref["sure"][k].sum())
                if bad.any():
                    far = max(far, diff[bad].max().item())
                    outliers += int(bad.sum())
            worst["outliers"] = max(worst["outliers"], outliers)
            check(outliers <= SHARD_OUTLIERS * checked
                  and far <= 2 * n * cfg.train.learning_rate,
                  f"({key}) rank {r}: {outliers} of {checked} parameters "
                  f"outside the tolerance, the farthest {far:.3e}")
            check(rk["resident"] == predicted,
                  f"({key}) rank {r} holds {rk['resident']} bytes, its "
                  f"splits give {predicted}")
            counts = {k: v for k, v in rk["counts"].items() if v}
            check(counts == want_counts[key],
                  f"({key}) rank {r} launches {rk['counts']}")
            launches[f"model_{key}_r{r}_train"] = rk["counts"]
        if key == "a":  # the flash kernels ran on h / T heads a rank
            heads = cfg.conformer.num_heads // plan.sizes["model"]
            seen = [got[r][key]["flash_heads"] for r in ranks]
            check(all(h == [heads] for h in seen), f"(a) flash heads {seen}")
        same = all(torch.equal(got[ranks[0]][key]["params"][k],
                               got[r][key]["params"][k])
                   for r in ranks[1:] for k in ref["grads"])
        check(same, f"({key}) the ranks' gathered parameters differ")
        rank_ms = [float(np.mean(got[r][key]["ms"][1:])) for r in ranks]
        resident = [got[r][key]["resident"] for r in ranks]
        peak = [got[r][key]["peak_bytes"] for r in ranks]
        sure = ref["sure"]
        left_out = sum(int((~v).sum()) for v in sure.values())
        extra = {k: [got[r][key][k] for r in ranks]
                 for k in ("gather_ms", "gather_mb", "model_sum_ms",
                           "model_sum_mb", "combine_ms", "combine_mb")
                 if k in got[ranks[0]][key]}
        result[key] = {"mesh": case["mesh"], "model": case["model"],
                       "rows": got[ranks[0]][key]["rows"],
                       "losses": [got[r][key]["losses"] for r in ranks],
                       "one_process_losses": ref["losses"],
                       "worst": worst, "left_out": left_out,
                       "step_ms": rank_ms,
                       "routes_differ": len(leads),
                       "routes_lead": max(leads, default=0.0),
                       "one_process_step_ms": timed_ref["ms"][1:],
                       "resident_bytes": resident,
                       "predicted_resident_bytes": predicted,
                       "one_process_resident_bytes": timed_ref["resident"],
                       "peak_bytes": peak,
                       "one_process_peak_bytes": timed_ref["peak_bytes"],
                       "flash_heads": got[ranks[0]][key]["flash_heads"],
                       "launches": [got[r][key]["counts"] for r in ranks],
                       **extra}
        print(f"[tensor] ({key}) --mesh {case['mesh']} on the "
              f"{case['model']} at B={MESH_BS} x 5 s, {len(ranks)} gloo "
              f"ranks on cuda:0, {result[key]['rows']} rows each, {n} "
              f"steps: losses {got[ranks[0]][key]['losses']} vs one "
              f"process {ref['losses']} (worst rel {worst['loss']:.2e}); "
              f"the first step's reduced gradients, every element: worst "
              f"max|diff| / max|g| {worst['grad']:.2e} "
              f"({worst.get('grad_leaf')}); parameters "
              f"gathered, equal on every rank: worst max|diff| / max|p| "
              f"{worst['param']:.2e} ({left_out} of "
              f"{sum(v.numel() for v in sure.values())} left out, "
              f"{worst['outliers']} outside the tolerance at most on a "
              f"rank); "
              + (f"one process on the ranks' experts (at {len(leads)} "
                 f"tokens its own top-1 differs, leading by at most "
                 f"{max(leads, default=0.0):.2e}); " if key in replayed
                 else "")
              + f"resident parameters + AdamW moments a rank "
              f"{[round(b / 1e6, 2) for b in resident]} MB (its splits "
              f"predict {predicted / 1e6:.2f}) vs one process "
              f"{timed_ref['resident'] / 1e6:.2f} MB; peak a rank "
              f"{[round(b / 1e6, 1) for b in peak]} MB vs one process "
              f"{timed_ref['peak_bytes'] / 1e6:.1f} MB; step ms a rank "
              f"(steps "
              f"2-{n}, host clock) {[round(m, 2) for m in rank_ms]}, one "
              f"process {[round(m, 2) for m in timed_ref['ms'][1:]]}"
              + "".join(f"; {k} {[round(v, 3) for v in vs]}"
                        for k, vs in extra.items())
              + f"; flash heads a call {result[key]['flash_heads']}"
              f"; launches a rank {got[ranks[0]][key]['counts']}")

    # (e) MWER steps under model=2: the losses, each rank's launches (its
    # n-best on ctc_beam, rows 3r and 4 on the gathered weights)
    for r in (2, 3):
        rk = got[r]["e"]
        for a, b in zip(rk["losses"], pg_losses):
            check(abs(a - b) <= MESH_ATOL + MESH_RTOL * abs(b),
                  f"(e) rank {r} MWER losses {rk['losses']} vs {pg_losses}")
        check({k: v for k, v in rk["counts"].items() if v}
              == {"ctc_beam": n, res: per * n, bwd: per * n},
              f"(e) rank {r} launches {rk['counts']}")
        launches[f"model_e_r{r}_pg_mwer"] = rk["counts"]
    result["e"] = {"losses": [got[r]["e"]["losses"] for r in (2, 3)],
                   "one_process_losses": pg_losses,
                   "step_ms": [float(np.mean(got[r]["e"]["ms"][1:]))
                               for r in (2, 3)]}
    print(f"[tensor] (e) --mesh model=2, {n} MWER steps (K=4) on the "
          f"BiLSTM-CTC, ranks 2-3, {MESH_BS} rows each: losses "
          f"{result['e']['losses'][0]} vs one process {pg_losses}; step ms "
          f"a rank {[round(m, 2) for m in result['e']['step_ms']]}; "
          f"launches a rank {got[2]['e']['counts']}")

    # (f) the model=2 epoch's checkpoint: the one-device shapes, served by
    # predict on one device and resumed for an epoch without a mesh
    last = load_checkpoint(os.path.join(run_dir, "model_last.pt"))
    shapes = {k: v.shape for k, v in specs["conformer"][1].items()}
    check({k: v.shape for k, v in last["params"].items()} == shapes
          and {k: v.shape for k, v in last["opt_state"]["mu"].items()}
          == shapes, "(f) the checkpoint's shapes are not one device's")
    epoch = {k: np.load(os.path.join(run_dir, f"{k}.npy")).tolist()
             for k in ("train_loss", "val_losses")}
    f_counts = [got[r]["f"]["counts"] for r in (0, 1)]
    check(all(c["flash_attn_residual"] > 0 for c in f_counts),
          f"(f) launches {f_counts}")
    reset_counts()
    rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                       "--model_path", run_dir, "--device", str(dev)])
    predict_counts = all_counts()
    check(rc == 0 and "CER:" in out and predict_counts["flash_attn"] > 0,
          f"(f) predict: rc {rc}, launches {predict_counts}")
    reset_counts()
    rc, out = run_cli(["--mode", "train", "--corpus_path", corpus,
                       "--model_path", run_dir, "--device", str(dev),
                       "--num_epochs", "2", "--batch_size", str(MESH_BS)])
    resume_counts = all_counts()
    tl = np.load(os.path.join(run_dir, "train_loss.npy"))
    check(rc == 0 and "resumed from epoch 1" in out and len(tl) == 2
          and np.isfinite(tl).all() and tl[1] < tl[0],
          f"(f) the resume: rc {rc}, {tl}")
    check(resume_counts["flash_attn_residual"] > 0,
          f"(f) resumed launches {resume_counts}")
    launches["model_f_epoch_r0"] = f_counts[0]
    launches["model_f_epoch_r1"] = f_counts[1]
    launches["model_f_predict_one_device"] = predict_counts
    launches["model_f_resume_no_mesh"] = resume_counts
    print(f"[tensor] (f) one epoch of train() under --mesh model=2 on the "
          f"conformer (ranks 0-1, {MESH_BS} rows each, "
          f"{[round(got[r]['f']['wall_s'], 1) for r in (0, 1)]} s): train "
          f"/ val loss {epoch['train_loss']} / {epoch['val_losses']}; its "
          f"checkpoint in the one-device shapes; launches a rank "
          f"{f_counts}; --mode predict on one device served it (launches "
          f"{predict_counts}); --mode train resumed it for an epoch without "
          f"a mesh (train losses {tl.tolist()}, launches {resume_counts})")
    result["f"] = {"epoch": epoch, "wall_s": [got[r]["f"]["wall_s"]
                                              for r in (0, 1)],
                   "resumed_train_losses": tl.tolist()}
    result["ranks_wall_s"] = wall_ranks
    result["wall_s"] = time.perf_counter() - t_phase
    print(f"[tensor] phase 20 in {result['wall_s']:.1f} s (the four rank "
          f"processes {wall_ranks:.1f} s)")
    result["launches"] = launches
    return result


PIPESEQ_STEPS = 2  # phase 21's steps a case
# the steps' clip and rate: as the CPU tests, the clip engages at every step
# and leaves every clipped gradient below AdamW's epsilon, where an update
# is linear in the gradient. Unclipped, AdamW's first step moves each
# element by the rate times the sign of its gradient, and where that
# gradient lies within the runs' rounding apart the sign flips: the second
# loss then differs by ~5e-6 relative at a rate of 1e-3 (the first run,
# with the pipe=2 microbatches' sums in another order); linear, a
# gradient's last bits move its update by as little. At this rate the
# largest gradient's element moves by up to a hundredth.
PIPESEQ_CLIP, PIPESEQ_LR = 1e-8, 0.02


def pipeseq_specs(alphabet):
    """Phase 21's model: the full-width transformer-CTC of Config() (6
    blocks, d 256, 4 heads, FFN 1024), float32, dropout 0, its weights from
    the seed on the host, with flash_attention (which the pipe and seq
    steps do not take, as the JAX package's) and, for the one-process
    reference, the same model without it (the dense attention the meshes
    run); the steps' clip at PIPESEQ_CLIP and rate PIPESEQ_LR, the epoch's
    phase 18's (a constant rate of 1e-3); and phase 18's global B=64 x 5 s
    batch."""
    import dataclasses

    import torch

    from pg_asr_tpu_torch.config import Config, fit_vocab
    from pg_asr_tpu_torch.train import init_model_params

    cfg_c, _, batch = mesh_spec(alphabet)
    base = Config()
    dense = fit_vocab(base.replace(
        model=dataclasses.replace(base.model, family="transformer",
                                  dropout=0.0),
        transformer=dataclasses.replace(base.transformer, dropout=0.0,
                                        flash_attention=False),
        train=cfg_c.train), alphabet.size)
    run = dense.replace(transformer=dataclasses.replace(
        dense.transformer, flash_attention=True))
    dense = dense.replace(train=dataclasses.replace(
        dense.train, grad_clip=PIPESEQ_CLIP, learning_rate=PIPESEQ_LR))
    flash = dense.replace(transformer=run.transformer)
    params = init_model_params(dense, torch.Generator().manual_seed(SEED),
                               "cpu")
    return {"dense": (dense, params), "flash": (flash, params),
            "flash_run": (run, params)}, batch


def phase_pipeseq(dev, corpus, alphabet, d):
    """21. The pipe and seq mesh axes, gloo rank processes on the one card
    (`python3 chip_smoke.py --shard-worker ...`) against the one-process
    steps on the same global B=64 x 5 s batch from the same weights, on
    the full-width transformer-CTC with flash_attention (no flash launch
    under either axis): (a) `pipe=2` at M=2, (b) at M=4, (c) `pipe=3` at
    M=3 (three ranks), (d) `data=2,pipe=2` (M=2), (e) `pipe=2,model=2`
    (M=2), (f) `seq=2`, (g) `seq=4` (T'=201 padded to 204), (h)
    `data=2,seq=2`; (i) one epoch of train() under `data=2,pipe=2` with 2
    microbatches in the four ranks (the CLI's launcher puts rank r on
    cuda:r, so on one card the ranks run through the worker), whose
    checkpoint `--mode predict` serves on one device and `--mode train`
    resumes without a mesh. Each case prints its losses, the first step's
    reduced gradients' largest difference relative to each tensor's
    largest, the parameters', each rank's resident bytes of parameters and
    AdamW moments (its stage's blocks under pipe: predicted from the
    shapes) beside one process's, each rank's peak memory beside one
    process's, the step ms beside one process's, one send / recv of a
    microbatch's activations or one block's key gather and reduce-scatter
    alone, and each rank's launches (none)."""
    import numpy as np
    import torch

    from pg_asr_tpu_torch.checkpoint import load_checkpoint
    from pg_asr_tpu_torch.parallel import mesh
    from pg_asr_tpu_torch.parallel.driver import ParallelPlan
    from pg_asr_tpu_torch.train import AdamW, loss_and_grads

    t_phase = time.perf_counter()
    specs, batch = pipeseq_specs(alphabet)
    arrays = [torch.from_numpy(a).to(dev) for a in batch]
    n = PIPESEQ_STEPS

    # n one-process steps of the dense model: the losses, the first step's
    # gradients, the parameters after, the mask, resident and peak bytes
    cfg, params0 = specs["dense"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    p = {k: v.to(dev, copy=True) for k, v in params0.items()}
    opt = AdamW(cfg, p)
    ref = {"losses": [], "grads": None, "ms": []}
    sure = {k: torch.ones_like(v, dtype=torch.bool) for k, v in p.items()}
    for _ in range(n + 1):  # the last step only timed
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(p, arrays, cfg)
        if len(ref["losses"]) < n:
            ref["losses"].append(loss.item())
            if ref["grads"] is None:
                ref["grads"] = {k: g.cpu() for k, g in grads.items()}
            sure = {k: sure[k] & (grads[k].abs() > max(
                MESH_GRAD_FLOOR, SHARD_GRAD_REL * grads[k].abs().max().item()))
                    for k in sure}
            opt.update(p, grads)
            ref["after"] = {k: v.cpu() for k, v in p.items()}
        torch.cuda.synchronize()
        ref["ms"].append((time.perf_counter() - t0) * 1e3)
    ref["resident"] = _tree_bytes(p, opt.mu, opt.nu)
    ref["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    blocks_bytes = 3 * sum(v.numel() * 4 for k, v in params0.items()
                           if k.startswith("blocks."))
    del p, opt, grads
    torch.cuda.empty_cache()

    run_dir = os.path.join(d, "pipeseq_d2p2")
    cases = {
        "d": dict(mesh="data=2,pipe=2", microbatches=2),
        "e": dict(mesh="pipe=2,model=2", microbatches=2),
        "g": dict(mesh="seq=4"), "h": dict(mesh="data=2,seq=2"),
        "i": dict(mesh="data=2,pipe=2", microbatches=2, kind="run",
                  model_dir=run_dir, model="flash_run"),
        "c": dict(mesh="pipe=3", microbatches=3),
        "a": dict(mesh="pipe=2", microbatches=2),
        "b": dict(mesh="pipe=2", microbatches=4),
        "f": dict(mesh="seq=2"),
    }
    for key, case in cases.items():
        case.update(name=key, steps=n)
        case.setdefault("kind", "steps")
        case.setdefault("model", "flash")
    spec_path = os.path.join(d, "pipeseq_spec.pt")
    torch.save({"device": str(dev), "dir": d, "corpus": corpus,
                "batch": batch,
                "configs": {m: c.to_json() for m, (c, _) in specs.items()},
                "params": {m: p for m, (_, p) in specs.items()},
                "groups": [
                    {"ranks": [0, 1, 2, 3], "port": mesh.free_port(),
                     "cases": [cases[k] for k in "deghi"]},
                    {"ranks": [0, 1, 2], "port": mesh.free_port(),
                     "cases": [cases["c"]]},
                    {"ranks": [0, 1], "port": mesh.free_port(),
                     "cases": [cases[k] for k in "abf"]}]},
               spec_path)
    logs = [os.path.join(d, f"pipeseq_rank{r}.log") for r in range(4)]
    t0 = time.perf_counter()
    procs = []
    for r in range(4):
        with open(logs[r], "w") as fo:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--shard-worker",
                 spec_path, str(r)], stdout=fo, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__))))
    try:
        rcs = [p.wait(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_ranks = time.perf_counter() - t0
    for r, rc in enumerate(rcs):
        with open(logs[r]) as fo:
            log = fo.read()
        check(rc == 0, f"phase 21 rank {r}: rc {rc}\n{log[-3000:]}")
    got = [torch.load(os.path.join(d, f"shard_rank{r}.pt"),
                      weights_only=False) for r in range(4)]

    result, launches = {}, {}
    for key in "abcdefgh":
        case = cases[key]
        cfg = _meshed(specs["flash"][0], case["mesh"],
                      case.get("microbatches", 0))
        plan = ParallelPlan(cfg, cfg.train.mesh_shape, cfg.train.mesh_axes,
                            cfg.train.pipeline_microbatches)
        ranks = list(range(plan.world))
        worst = {"loss": 0.0, "grad": 0.0, "param": 0.0, "outliers": 0}
        predicted, block_share = [], []
        for i in ranks:
            rk = got[i][key]
            coords = plan.coords(i)
            for a, b in zip(rk["losses"], ref["losses"]):
                worst["loss"] = max(worst["loss"], abs(a - b) / abs(b))
                check(abs(a - b) <= 1e-6 * abs(b),
                      f"({key}) rank {i} losses {rk['losses']} vs "
                      f"{ref['losses']}")
            check(set(rk["grads"]) == {
                k for k in ref["grads"]
                if plan.stage(k) in (None, coords["pipe"])},
                f"({key}) rank {i} holds {sorted(rk['grads'])}")
            for k, g in rk["grads"].items():
                g_ref = model_part(plan, k, ref["grads"][k], coords)
                diff = (g - g_ref).abs()
                top = g_ref.abs().max()
                rel = (diff.max() / top).item()
                if rel > worst["grad"]:
                    worst["grad"], worst["grad_leaf"] = rel, k
                check(rel <= TENSOR_GRAD_REL,
                      f"({key}) rank {i} the reduced gradient of {k}: "
                      f"max|diff| {diff.max().item():.3e}, max|g| "
                      f"{top.item():.3e}")
            outliers, checked, far = 0, 0, 0.0
            for k, v in ref["after"].items():
                diff = (rk["params"][k] - v).abs()
                worst["param"] = max(worst["param"], (
                    diff.max() / v.abs().max()).item())
                bad = (diff > MESH_ATOL + MESH_RTOL * v.abs()) & sure[k].cpu()
                checked += int(sure[k].sum())
                if bad.any():
                    far = max(far, diff[bad].max().item())
                    outliers += int(bad.sum())
            worst["outliers"] = max(worst["outliers"], outliers)
            check(outliers <= SHARD_OUTLIERS * checked
                  and far <= 2 * n * cfg.train.learning_rate,
                  f"({key}) rank {i}: {outliers} of {checked} parameters "
                  f"outside the tolerance, the farthest {far:.3e}")
            predicted.append(predicted_bytes(plan, specs["flash"][1],
                                             coords))
            check(rk["resident"] == predicted[-1],
                  f"({key}) rank {i} holds {rk['resident']} bytes, its "
                  f"stage and splits give {predicted[-1]}")
            held_blocks = predicted[-1] - (ref["resident"] - blocks_bytes)
            block_share.append(held_blocks / blocks_bytes)
            counts = {k: v for k, v in rk["counts"].items() if v}
            check(counts == {} and rk["flash_heads"] == [],
                  f"({key}) rank {i} launches {rk['counts']}, flash heads "
                  f"{rk['flash_heads']}")
            launches[f"pipeseq_{key}_r{i}_train"] = rk["counts"]
        if plan.strategy == "pipe" and not plan.tp:
            check(all(abs(b - 1 / plan.sizes["pipe"]) < 1e-12
                      for b in block_share),
                  f"({key}) block shares {block_share}")
        same = all(torch.equal(got[0][key]["params"][k],
                               got[i][key]["params"][k])
                   for i in ranks[1:] for k in ref["grads"])
        check(same, f"({key}) the ranks' gathered parameters differ")
        rank_ms = [float(np.mean(got[i][key]["ms"][1:])) for i in ranks]
        extra = {k: [got[i][key][k] for i in ranks]
                 for k in ("send_recv_ms", "send_recv_mb", "seq_gather_ms",
                           "seq_reduce_scatter_ms", "seq_gather_mb",
                           "model_sum_ms", "model_sum_mb")
                 if k in got[0][key]}
        result[key] = {
            "mesh": case["mesh"], "microbatches": plan.microbatches,
            "rows": got[0][key]["rows"],
            "losses": [got[i][key]["losses"] for i in ranks],
            "one_process_losses": ref["losses"], "worst": worst,
            "step_ms": rank_ms, "one_process_step_ms": ref["ms"][1:],
            "resident_bytes": [got[i][key]["resident"] for i in ranks],
            "predicted_resident_bytes": predicted,
            "block_share": block_share,
            "one_process_resident_bytes": ref["resident"],
            "peak_bytes": [got[i][key]["peak_bytes"] for i in ranks],
            "one_process_peak_bytes": ref["peak_bytes"], **extra}
        print(f"[pipeseq] ({key}) --mesh {case['mesh']}"
              + (f" --microbatches {plan.microbatches}"
                 if plan.microbatches else "")
              + f" on the transformer at B={MESH_BS} x 5 s, {plan.world} "
              f"gloo ranks on cuda:0, {result[key]['rows']} rows each, {n} "
              f"steps: losses {got[0][key]['losses']} vs one process "
              f"{ref['losses']} (worst rel {worst['loss']:.2e}); the first "
              f"step's reduced gradients, every element: worst max|diff| / "
              f"max|g| {worst['grad']:.2e} ({worst.get('grad_leaf')}); "
              f"parameters gathered, equal on every rank: worst max|diff| "
              f"/ max|p| {worst['param']:.2e} ({worst['outliers']} outside "
              f"the tolerance at most on a rank); resident parameters + "
              f"AdamW moments a rank "
              f"{[round(b / 1e6, 2) for b in result[key]['resident_bytes']]}"
              f" MB (predicted {[round(b / 1e6, 2) for b in predicted]}; "
              f"the blocks' share {[round(b, 4) for b in block_share]}) vs "
              f"one process {ref['resident'] / 1e6:.2f} MB; peak a rank "
              f"{[round(b / 1e6, 1) for b in result[key]['peak_bytes']]} MB"
              f" vs one process {ref['peak_bytes'] / 1e6:.1f} MB; step ms a "
              f"rank (steps 2-{n}, host clock) "
              f"{[round(m, 2) for m in rank_ms]}, one process "
              f"{[round(m, 2) for m in ref['ms'][1:]]}"
              + "".join(f"; {k} {[round(v, 3) for v in vs]}"
                        for k, vs in extra.items())
              + f"; launches a rank {got[0][key]['counts']}")

    # (i) the data=2,pipe=2 epoch's checkpoint: the one-device tree, served
    # by predict on one device and resumed for an epoch without a mesh
    last = load_checkpoint(os.path.join(run_dir, "model_last.pt"))
    shapes = {k: v.shape for k, v in specs["flash"][1].items()}
    check({k: v.shape for k, v in last["params"].items()} == shapes
          and {k: v.shape for k, v in last["opt_state"]["mu"].items()}
          == shapes, "(i) the checkpoint's tree is not one device's")
    epoch = {k: np.load(os.path.join(run_dir, f"{k}.npy")).tolist()
             for k in ("train_loss", "val_losses")}
    i_counts = [got[r]["i"]["counts"] for r in range(4)]
    check(all(not any(c.values()) for c in i_counts),
          f"(i) launches {i_counts}")
    reset_counts()
    rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                       "--model_path", run_dir, "--device", str(dev)])
    predict_counts = all_counts()
    check(rc == 0 and "CER:" in out and predict_counts["flash_attn"] > 0,
          f"(i) predict: rc {rc}, launches {predict_counts}")
    reset_counts()
    rc, out = run_cli(["--mode", "train", "--corpus_path", corpus,
                       "--model_path", run_dir, "--device", str(dev),
                       "--num_epochs", "2", "--batch_size", str(MESH_BS)])
    resume_counts = all_counts()
    tl = np.load(os.path.join(run_dir, "train_loss.npy"))
    check(rc == 0 and "resumed from epoch 1" in out and len(tl) == 2
          and np.isfinite(tl).all() and tl[1] < tl[0],
          f"(i) the resume: rc {rc}, {tl}")
    check(resume_counts["flash_attn_residual"] > 0,
          f"(i) resumed launches {resume_counts}")
    for r in range(4):
        launches[f"pipeseq_i_epoch_r{r}"] = i_counts[r]
    launches["pipeseq_i_predict_one_device"] = predict_counts
    launches["pipeseq_i_resume_no_mesh"] = resume_counts
    print(f"[pipeseq] (i) one epoch of train() under --mesh data=2,pipe=2 "
          f"--microbatches 2 (four ranks, {MESH_BS // 2} rows each, "
          f"{[round(got[r]['i']['wall_s'], 1) for r in range(4)]} s): train "
          f"/ val loss {epoch['train_loss']} / {epoch['val_losses']}; its "
          f"checkpoint the one-device tree; launches a rank {i_counts[0]}; "
          f"--mode predict on one device served it (launches "
          f"{predict_counts}); --mode train resumed it for an epoch without "
          f"a mesh (train losses {tl.tolist()}, launches {resume_counts})")
    result["i"] = {"epoch": epoch,
                   "wall_s": [got[r]["i"]["wall_s"] for r in range(4)],
                   "resumed_train_losses": tl.tolist()}
    result["ranks_wall_s"] = wall_ranks
    result["wall_s"] = time.perf_counter() - t_phase
    print(f"[pipeseq] phase 21 in {result['wall_s']:.1f} s (the four rank "
          f"processes {wall_ranks:.1f} s)")
    result["launches"] = launches
    return result


def attention_group(name: str) -> str:
    """The kernel group of a device_breakdown: flash_attn (the forward in
    either form), flash_bwd (dkv and dq), joint (joint_fwd, joint_bwd and
    its reduction passes), GEMMs, convolutions (the STFT and the depthwise
    conv), LayerNorm, and the rest (elementwise, softmax, copies, the CTC
    and lattice losses, the optimizer)."""
    # a convolution first: cuDNN names some of its kernels "...gemm"
    return ("flash_bwd" if "flash_attn_bwd" in name else
            "flash_attn" if "flash_attn" in name else
            "joint" if "joint_" in name else
            "conv" if "conv" in name else
            "gemm" if any(w in name for w in ("gemm", "nvjet", "xmma"))
            else "layer_norm" if "layer_norm" in name else "other")


ATTENTION_GROUPS = ("flash_attn", "flash_bwd", "joint", "gemm", "conv",
                    "layer_norm", "other")


def pg_group(name: str) -> str:
    """The kernel group of a PG step: the LSTM kernels (bilstm_fwd's walk,
    bilstm_bwd's three launches), ctc_beam, the CTC loss (F.ctc_loss's
    kernels), GEMMs, and the rest (the edit-distance DP, sampling, the
    entropy, elementwise passes, the optimizer)."""
    return ("lstm" if "lstm" in name else
            "ctc_beam" if "ctc_beam" in name else
            "ctc_loss" if "ctc_loss" in name else
            "gemm" if any(w in name for w in ("gemm", "nvjet", "xmma"))
            else "other")


PG_GROUPS = ("lstm", "ctc_beam", "ctc_loss", "gemm", "other")


def device_breakdown(fn, reps: int = 3, groups=ATTENTION_GROUPS,
                     classify=attention_group) -> dict:
    """Kernel time per call of fn on the card, by group (`classify` maps a
    kernel's name to one of `groups`), from a torch.profiler trace of `reps`
    calls after one untimed."""
    records, _ = device_trace(fn, reps)
    out = dict.fromkeys(groups, 0.0)
    for name, ms in records:
        out[classify(name.lower())] += ms / reps
    check(sum(out.values()) > 0, "the profiler saw no kernel time")
    return out


def device_ops(fn) -> int:
    """Device operations (kernel launches and copies) of one call of fn,
    counted by torch.profiler after one untimed call."""
    return len(device_trace(fn)[0])


def host_ms(fn, reps: int) -> float:
    """Host-clock ms per call of fn, synchronised at the end (for work
    whose time is its launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def kernels_line(cases, lib, predict_launches, train_counts, attention,
                 attention_train, tr, bi):
    def head(rows):
        return next(c for c in rows if c["dtype"] == "float32"
                    and not c["reverse"])

    f, r, b = head(cases["fwd"]), head(cases["res"]), head(cases["bwd"])
    beam = cases["beam"][0]  # M=6, the default prune
    flash = next(c for c in cases["flash"] if c["dtype"] == "float32")
    fb = next(c for c in cases["flash_bwd"] if c["dtype"] == "float32")
    src = "pg_asr_tpu_torch/csrc/"
    lib_fa = "jax/experimental/pallas/ops/tpu/flash_attention.py"

    def train_launches(name):
        return {f"{fam}_{path}": n[name] for fam, r in attention_train.items()
                for path, n in r["launches"].items()}

    conformer_epoch = attention_train["conformer"]["launches"]["epoch1"]
    jf = next(c for c in cases["joint"] if c["dtype"] == "float32")
    # the BiLSTM-CTC's model paths (predict, train), counts set to 0 before
    # each; where the encoder's route fuses the directions, the
    # single-direction kernels run on bilstm_layer(fuse_directions=False),
    # the JAX package's default of that entry point (phase 3f)
    route = {"predict": predict_launches[0],
             "train": {k: train_counts[k] for k in predict_launches[0]}}

    def launches(name, layer):
        by_path = {path: n[name] for path, n in route.items()}
        own = bi["layer_launches"][layer][name]
        return {"launches": sum(by_path.values()) or own,
                "launches_by_path": {**by_path, (
                    "bilstm_layer(fuse_directions=False)"): own}}

    return [{
        "name": "lstm_fwd", "route": "cuda", "source": src + "lstm_fwd.cu",
        "replaces": "pg_asr_tpu/ops/pallas_lstm.py:80",
        **launches("lstm_fwd", "unfused_no_grad"),
        "max_abs_err": max(c["max_abs_err"] for c in cases["fwd"]
                           if c["dtype"] == "float32"),
        "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
        "bound_by": f["bound_by"], "library_ms": lib["fwd_ms"],
        "cases": cases["fwd"], "shapes": cases["shapes"]["lstm"],
    }, {
        "name": "lstm_fwd_residual", "route": "cuda",
        "source": src + "lstm_fwd.cu",
        "replaces": "pg_asr_tpu/ops/pallas_lstm.py:80",
        **launches("lstm_fwd_residual", "unfused_autograd"),
        "max_abs_err": max(max(v[0] for v in c["errors"].values())
                           for c in cases["res"] if c["dtype"] == "float32"),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": lib["train_fwd_ms"],
        "cases": cases["res"],
    }, {
        "name": "lstm_bwd", "route": "cuda", "source": src + "lstm_bwd.cu",
        "replaces": "pg_asr_tpu/ops/pallas_lstm.py:122",
        **launches("lstm_bwd", "unfused_autograd"),
        "max_abs_err": max(c["dxp_max_abs_err"] for c in cases["bwd"]
                           if c["dtype"] == "float32"),
        "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"], "library_ms": lib["bwd_ms"],
        "cases": cases["bwd"],
    }, *bilstm_rows(bi, src, route), {
        "name": "ctc_beam", "route": "cuda", "source": src + "ctc_beam.cu",
        "replaces": "pg_asr_tpu/decoding/pallas_beam.py:67",
        "launches": predict_launches[1],
        "launches_by_path": {"predict": predict_launches[1],
                             "train_then_predict": train_counts["ctc_beam"]},
        "max_abs_err": max(c["nll_max_abs_err"] for c in cases["beam"]),
        "ms": beam["ms"], "plain_ms": beam["plain_ms"],
        "bound_ms": beam["bound_ms"], "bound_by": beam["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a CTC prefix beam "
                        "search",
        "cases": cases["beam"], "shapes": cases["shapes"]["beam"],
    }, {
        "name": "flash_attn", "route": "cuda", "source": src + "flash_attn.cu",
        "replaces": "pg_asr_tpu/ops/flash_attn.py:62",
        "launches": attention["conformer"]["launches"]["greedy"],
        "launches_by_path": {
            **{f"{fam}_{path}": n for fam, r in attention.items()
               for path, n in r["launches"].items()},
            **train_launches("flash_attn")},
        "max_abs_err": flash["max_abs_err"], "ms": flash["ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "library_note": "F.scaled_dot_product_attention with the boolean "
                        "segment-equality mask",
        "cases": cases["flash"], "models": attention,
        "shapes": cases["shapes"]["flash"],
    }, {
        "name": "flash_attn_residual", "route": "cuda",
        "source": src + "flash_attn.cu",
        "replaces": "pg_asr_tpu/ops/flash_attn.py:62 (" + lib_fa
                    + " _flash_attention_fwd, save_residuals)",
        "launches": conformer_epoch["flash_attn_residual"],
        "launches_by_path": train_launches("flash_attn_residual"),
        "max_abs_err": max(c["m_max_abs_err"] for c in cases["flash"]
                           if c["dtype"] == "float32"),
        "ms": flash["res_ms"], "plain_ms": flash["res_plain_ms"],
        "bound_ms": flash["res_bound_ms"], "bound_by": flash["res_bound_by"],
        "library_ms": flash["sdpa_train_fwd_ms"],
        "library_note": "F.scaled_dot_product_attention forward on inputs "
                        "that require grad",
    }, {
        "name": "flash_attn_bwd_dkv", "route": "cuda",
        "source": src + "flash_attn_bwd.cu",
        "replaces": lib_fa + ":941 (_flash_attention_bwd_dkv, pallas_call "
                    ":1121, kernel :796)",
        "launches": conformer_epoch["flash_attn_bwd_dkv"],
        "launches_by_path": train_launches("flash_attn_bwd_dkv"),
        "max_abs_err": max(c["errors_rel_to_max"][n][0]
                           for c in cases["flash_bwd"] for n in ("dk", "dv")
                           if c["dtype"] == "float32"),
        "max_abs_err_note": "relative to max|grad|",
        "ms": fb["dkv_ms"], "plain_ms": fb["plain_bwd_ms"],
        "bound_ms": fb["dkv_bound_ms"], "bound_by": fb["dkv_bound_by"],
        "library_ms": fb["sdpa_bwd_ms"],
        "library_note": "the backward of F.scaled_dot_product_attention "
                        "(dq, dk and dv together); plain_ms is "
                        "mhsa_bwd_plain, all three",
        "cases": cases["flash_bwd"], "models": attention_train,
    }, {
        "name": "flash_attn_bwd_dq", "route": "cuda",
        "source": src + "flash_attn_bwd.cu",
        "replaces": lib_fa + ":1287 (_flash_attention_bwd_dq, pallas_call "
                    ":1456, kernel :1146)",
        "launches": conformer_epoch["flash_attn_bwd_dq"],
        "launches_by_path": train_launches("flash_attn_bwd_dq"),
        "max_abs_err": max(c["errors_rel_to_max"]["dq"][0]
                           for c in cases["flash_bwd"]
                           if c["dtype"] == "float32"),
        "max_abs_err_note": "relative to max|grad|",
        "ms": fb["dq_ms"], "plain_ms": fb["plain_bwd_ms"],
        "bound_ms": fb["dq_bound_ms"], "bound_by": fb["dq_bound_by"],
        "library_ms": fb["sdpa_bwd_ms"],
        "library_note": "the backward of F.scaled_dot_product_attention "
                        "(dq, dk and dv together); plain_ms is "
                        "mhsa_bwd_plain, all three",
    }, {
        "name": "joint_fwd", "route": "cuda", "source": src + "joint_fwd.cu",
        "replaces": "pg_asr_tpu/ops/pallas_joint.py:69",
        "launches": tr["launches"]["train_fused"]["joint_fwd"],
        "launches_by_path": {path: n["joint_fwd"] for path, n in
                             tr["launches"].items()},
        "max_abs_err": max(v[0] for c in cases["joint"]
                           for v in c["lp_errors"].values()),
        "ms": jf["fwd_ms"], "plain_ms": jf["fwd_plain_ms"],
        "bound_ms": jf["fwd_bound_ms"], "bound_by": jf["fwd_bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused joint; "
                        "unfused_ms is the port's unfused composition (the "
                        "4-D tanh, the head, joint_log_probs)",
        "unfused_ms": jf["unfused_fwd_ms"], "cases": cases["joint"],
        "models": {"transducer": tr}, "shapes": cases["shapes"]["joint"],
    }, {
        "name": "joint_bwd", "route": "cuda", "source": src + "joint_bwd.cu",
        "replaces": "pg_asr_tpu/ops/pallas_joint.py:92",
        "launches": tr["launches"]["train_fused"]["joint_bwd"],
        "launches_by_path": {path: n["joint_bwd"] for path, n in
                             tr["launches"].items()},
        "max_abs_err": max(c["grad_errors_rel_to_max"][n][0]
                           for c in cases["joint"] for n in
                           ("de", "dg", "dW", "db")
                           if c["dtype"] == "float32"),
        "max_abs_err_note": "relative to max|grad|, float32",
        "ms": jf["bwd_ms"], "plain_ms": jf["bwd_plain_ms"],
        "bound_ms": jf["bwd_bound_ms"], "bound_by": jf["bwd_bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused joint's "
                        "gradient; unfused_fwd_bwd_ms is the unfused "
                        "composition forward + backward, fused_fwd_bwd_ms "
                        "joint_fwd + joint_bwd",
        "unfused_fwd_bwd_ms": jf["unfused_fwd_bwd_ms"],
        "fused_fwd_bwd_ms": jf["fused_fwd_bwd_ms"],
    }]


def bilstm_rows(bi, src, route_counts):
    """The kernels line's rows 3 (both forms) and 4, float32 times:
    launches from the model paths the encoder's route takes through them
    (route_counts: {path: {counter: launches}}, counts set to 0 before each
    path), beside the fused layer's own runs in phase 3f."""
    c = next(c for c in bi["cases"] if c["dtype"] == "float32")
    note = ("cuDNN nn.LSTM(512, 256, bidirectional=True), which also does "
            "the input projection, timed in turns with the kernel")
    rows = []
    for name, key, layer in (
            ("bilstm_fwd", "fwd", bi["layer_launches"]["no_grad"]),
            ("bilstm_fwd_residual", "res", bi["layer_launches"]["autograd"]),
            ("bilstm_bwd", "bwd", bi["layer_launches"]["autograd"])):
        errs = c["bwd_errors" if key == "bwd" else "fwd_errors"]
        two = {"fwd": "two_lstm_fwd_ms", "res": "two_lstm_fwd_residual_ms",
               "bwd": "two_lstm_bwd_ms"}[key]
        by_path = {path: n.get(name, 0) for path, n in route_counts.items()}
        rows.append({
            "name": name, "route": "cuda",
            "source": src + ("lstm_bwd.cu" if key == "bwd"
                             else "lstm_fwd.cu"),
            "replaces": "pg_asr_tpu/ops/pallas_lstm.py:"
                        + ("357" if key == "bwd" else "318"),
            "launches": sum(by_path.values()) or layer[name],
            "launches_by_path": {**by_path,
                                 "bilstm_layer(fuse_directions=True)":
                                     layer[name]},
            "max_abs_err": max(v[0] for k, v in errs.items()
                               if k.startswith(("y", "h", "c", "dxp"))),
            "ms": c[f"{key}_ms"], "plain_ms": c[f"{key}_plain_ms"],
            "bound_ms": c[f"{key}_bound_ms"],
            "bound_by": c[f"{key}_bound_by"],
            "library_ms": c[f"{key}_cudnn_ms"],
            "library_note": note, two: c[two],
            "cases": bi["cases"] if key == "fwd" else None,
        })
    return rows


def main() -> int:
    if sys.argv[1:2] == ["--recipe-worker"]:
        return recipe_worker(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--mesh-worker"]:
        return mesh_worker(sys.argv[2], sys.argv[3], int(sys.argv[4]),
                           int(sys.argv[5]))
    if sys.argv[1:2] == ["--shard-worker"]:
        return shard_worker(sys.argv[2], int(sys.argv[3]))
    t_start = time.perf_counter()
    walls = {}

    def timed(name, fn, *args):
        """fn(*args), its wall time kept under `name` and printed."""
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        print(f"[smoke] {name}: {walls[name]:.1f} s")
        return out

    dev = phase_device()
    timed("build", phase_build)
    cases = timed("3 kernels", phase_kernels, dev)
    cases["beam"] = timed("3b beam", phase_beam, dev)
    cases["flash"] = timed("3c flash", phase_flash, dev)
    cases["flash_bwd"] = timed("3d flash_bwd", phase_flash_bwd, dev)
    cases["joint"] = timed("3e joint", phase_joint, dev)
    cases["shapes"] = timed("3g shapes", phase_shapes, dev)
    bi = timed("3f bilstm", phase_bilstm, dev)
    lib = timed("3 library", phase_library, dev)
    with tempfile.TemporaryDirectory() as d:
        corpus, alphabet = make_corpus(d)
        predict_launches = timed("4 predict", phase_predict, dev, corpus,
                                 alphabet, d, bi)
        train_counts, train_steps_ms = timed("5 train", phase_train, dev,
                                             corpus, alphabet, d, bi)
        attention = {family: timed(f"6 {family}", phase_attention, dev,
                                   corpus, alphabet, d, family,
                                   cases["flash"])
                     for family in ("conformer", "transformer")}
        attention_train = {family: timed(f"7 {family} train",
                                         phase_attention_train, dev, corpus,
                                         alphabet, d, family)
                           for family in ("conformer", "transformer")}
        tr = timed("8 transducer train", phase_transducer_train, dev, corpus,
                   alphabet, d, cases["joint"])
        tr["predict"] = timed("9 transducer predict",
                              phase_transducer_predict, dev, corpus,
                              alphabet, os.path.join(d, "transducer_fused"))
        pg = timed("10 finetune_pg", phase_pg, dev, corpus, alphabet, d, bi,
                   cases["beam"], train_steps_ms)
        recipe = timed("11 recipe", phase_recipe, dev, corpus, alphabet, d,
                       bi, train_steps_ms)
        tools = timed("12 corpus tools", phase_corpus_tools, dev, corpus, d)
        stream = timed("13 stream", phase_stream, dev, corpus, alphabet,
                       os.path.join(d, "trained"), os.path.join(d, "model"),
                       os.path.join(d, "conformer_trained"),
                       os.path.join(d, "bpe"), os.path.join(d, "bpe_model"))
        s2s = timed("14 seq2seq", phase_seq2seq, dev, corpus, alphabet, d)
        lm = timed("15 lm", phase_lm, dev, corpus, alphabet, d)
        export = timed("16 export", phase_export, dev, corpus, alphabet, d)
        moe_res = timed("17 moe", phase_moe, dev, corpus, alphabet, d)
        mesh_res = timed("18 mesh", phase_mesh, dev, corpus, alphabet, d)
        shard_res = timed("19 shard", phase_shard, dev, corpus, alphabet, d)
        tensor_res = timed("20 tensor", phase_tensor, dev, corpus, alphabet,
                           d)
        pipeseq_res = timed("21 pipe/seq", phase_pipeseq, dev, corpus,
                            alphabet, d)

    import torch

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "pg_asr_tpu",
                                        "msgpack", "ml_dtypes"))
    check(not bad, f"the port imported {bad}")
    print(json.dumps({"finetune_pg": pg}))
    print(json.dumps({"recipe": recipe}))
    print(json.dumps({"corpus_tools": tools}))
    print(json.dumps({"stream": stream}))
    print(json.dumps({"seq2seq": s2s}))
    print(json.dumps({"lm": lm}))
    print(json.dumps({"export": export}))
    print(json.dumps({"moe": moe_res}))
    print(json.dumps({"mesh": mesh_res}))
    print(json.dumps({"shard": shard_res}))
    print(json.dumps({"tensor": tensor_res}))
    print(json.dumps({"pipeseq": pipeseq_res}))
    print(json.dumps({"phase_wall_s": walls}))
    print(f"[smoke] total wall time {time.perf_counter() - t_start:.1f} s")
    rows = kernels_line(cases, lib, predict_launches, train_counts, attention,
                        attention_train, tr, bi)
    for row in rows:  # the PG, recipe, corpus-tool, streaming, seq2seq,
        row["launches_by_path"].update(  # LM, export, MoE and mesh paths
            # (the model axis's under model_*, the pipe and seq axes' under
            # pipeseq_*)
            {path: n[row["name"]] for path, n in
             {**pg["launches"], **recipe["launches"], **tools["launches"],
              **stream["launches"], **s2s["launches"],
              **lm["launches"], **export["launches"],
              **moe_res["launches"], **mesh_res["launches"],
              **shard_res["launches"], **tensor_res["launches"],
              **pipeseq_res["launches"]}.items()})
        if row["name"] == "ctc_beam":
            row["cases_bpe_vocab"] = tools["beam_a256"]
        if row["name"] in ("lstm_fwd", "flash_attn"):
            row["cases_stream"] = stream[f"{row['name']}_cases"]
        if row["name"] == "lstm_fwd":  # the streamed window's backward
            row["launches"] = stream["launches"]["stream_cli_ctc"][
                "lstm_fwd"]
        if row["name"] in ("lstm_fwd_residual", "lstm_bwd"):
            # the seq2seq decoder's teacher-forced pass under autograd
            row["launches"] = s2s["launches"]["seq2seq_train"][row["name"]]
            row["cases_seq2seq"] = s2s["lstm_cases"]
        if row["name"] in ("lstm_fwd", "lstm_fwd_residual", "lstm_bwd"):
            row["cases_lm"] = lm["lstm_cases"]  # the LM's shapes
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
