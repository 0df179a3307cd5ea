"""CTC forced alignment: Viterbi over the CTC lattice on the tensors'
device (counterpart of pg_asr_tpu/ops/align.py).

Given a reference transcript and the model's frame posteriors, find the
most likely frame-level alignment: which frames each label token spans.
The DP is one loop over frames for the whole batch: a (B, S) row over the
blank-interleaved states z = [blank l1 blank l2 ... lL blank], S = 2L+1,
takes the best of stay, diagonal and skip (skip only into a non-blank
state that differs from the state two back). Backpointers are packed as
int8 (0 stay, 1 diagonal, 2 skip), (T, B, S), and are what the host
copies; the O(T) backtrace runs in numpy.

Ties follow the JAX package: skip, then diagonal, then stay; frames past
an utterance's end freeze its row and point "stay"; the end state prefers
the final blank over the last label. It is a ``lax.scan`` there, not a
Pallas kernel, so here it is plain PyTorch: T steps of a few small
operations each.

Inputs are those of the CTC loss (ops/ctc.py): (log_probs, frame_lens,
labels, label_lens), blank id 0.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30


def ctc_viterbi_backpointers(log_probs: torch.Tensor, frame_lens, labels,
                             label_lens):
    """Forward Viterbi pass over the CTC lattice on log_probs' device.

    Args:
      log_probs: (B, T, A) log-softmax outputs.
      frame_lens: (B,) valid frame counts.
      labels: (B, L) 0-padded label ids (no blanks).
      label_lens: (B,) label counts.
    Returns (on log_probs' device):
      back: (T, B, S) int8 backpointers (0 stay, 1 from s-1, 2 from s-2).
      end_state: (B,) int64 best final state (last blank vs last label).
      score: (B,) float32 log-prob of the best alignment path.
    """
    dev = log_probs.device
    B, T, _ = log_probs.shape
    labels = torch.as_tensor(labels, device=dev).long()
    frame_lens = torch.as_tensor(frame_lens, device=dev).long()
    label_lens = torch.as_tensor(label_lens, device=dev).long()
    L = labels.shape[1]
    S = 2 * L + 1

    s_idx = torch.arange(S, device=dev)
    is_label = (s_idx % 2) == 1
    lab_pos = torch.clamp(s_idx // 2, max=L - 1)
    z = torch.where(is_label[None, :], labels[:, lab_pos], 0)  # (B, S)
    # skip into state s iff z_s is a label and differs from z_{s-2}
    z_m2 = F.pad(z[:, :-2], (2, 0), value=-1)
    can_skip = is_label[None, :] & (z != z_m2)
    # states past this utterance's 2 * label_len + 1 are dead
    live_state = s_idx[None, :] <= 2 * label_lens[:, None]

    # (B, T, S) emission log-probs per state
    emit = torch.gather(log_probs.float(), 2,
                        z[:, None, :].expand(B, T, S))

    delta = torch.full((B, S), NEG, device=dev)
    delta[:, 0] = emit[:, 0, 0]
    delta[:, 1] = torch.where(label_lens > 0, emit[:, 0, 1],
                              torch.full_like(emit[:, 0, 1], NEG))
    delta = torch.where(live_state, delta, NEG)

    neg = torch.full((B, 2), NEG, device=dev)
    back = torch.zeros(T, B, S, dtype=torch.int8, device=dev)
    two = torch.tensor(2, dtype=torch.int8, device=dev)
    one = torch.tensor(1, dtype=torch.int8, device=dev)
    zero = torch.tensor(0, dtype=torch.int8, device=dev)
    for t in range(1, T):  # t = 0 is the initial row (all "stay")
        diag = torch.cat([neg[:, :1], delta[:, :-1]], dim=1)
        skip = torch.where(can_skip, torch.cat([neg, delta[:, :-2]], dim=1),
                           NEG)
        best = torch.maximum(delta, torch.maximum(diag, skip))
        choice = torch.where(best == skip, two,
                             torch.where(best == diag, one, zero))
        new = torch.where(live_state, best + emit[:, t], NEG)
        # frames past the utterance's end freeze the row (and point stay)
        valid_t = (t < frame_lens)[:, None]
        delta = torch.where(valid_t, new, delta)
        back[t] = torch.where(valid_t, choice, zero)

    last_blank = 2 * label_lens
    last_label = torch.clamp(2 * label_lens - 1, min=0)
    d_blank = delta.gather(1, last_blank[:, None])[:, 0]
    d_label = delta.gather(1, last_label[:, None])[:, 0]
    end_state = torch.where(d_blank >= d_label, last_blank, last_label)
    score = delta.gather(1, end_state[:, None])[:, 0]
    return back, end_state, score


def ctc_forced_align(log_probs, frame_lens, labels, label_lens):
    """Viterbi on the device, then the backtrace on the host.

    Returns B alignments, each a list of (label_position, start_frame,
    end_frame_exclusive) spans, one per reference token, in order. An
    utterance whose lattice is infeasible (fewer frames than the CTC
    topology needs) or that has no frames or labels gets []."""
    back, end_state, score = ctc_viterbi_backpointers(
        log_probs, frame_lens, labels, label_lens)
    back = back.cpu().numpy()  # (T, B, S)
    end_state = end_state.cpu().numpy()
    score = score.cpu().numpy()
    frame_lens = np.asarray(torch.as_tensor(frame_lens).cpu())
    label_lens = np.asarray(torch.as_tensor(label_lens).cpu())

    out = []
    for b in range(back.shape[1]):
        Tn = int(frame_lens[b])
        Ln = int(label_lens[b])
        if Tn <= 0 or Ln <= 0 or not np.isfinite(score[b]) \
                or score[b] <= NEG / 2:
            out.append([])
            continue
        s = int(end_state[b])
        states = np.empty(Tn, np.int32)
        for t in range(Tn - 1, -1, -1):
            states[t] = s
            s -= int(back[t, b, s])
        spans = []
        for t in range(Tn):
            st = int(states[t])
            if st % 2 == 1:  # a label state; blanks extend nothing
                pos = st // 2
                if spans and spans[-1][0] == pos:
                    spans[-1][2] = t + 1
                else:
                    spans.append([pos, t, t + 1])
        out.append([tuple(sp) for sp in spans])
    return out
