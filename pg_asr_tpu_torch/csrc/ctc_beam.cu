// CTC prefix beam search for Hopper (sm_90a): a warp per utterance (K <=
// 32), or a block per utterance for wider beams.
//
// Replaces the TPU kernel pg_asr_tpu/decoding/pallas_beam.py:_beam_kernel
// (beam_scan_pallas): the whole frame loop of the hash-impl search of
// pg_asr_tpu/decoding/beam.py (_step_hash in _scan_hash). Here the kernel
// also selects each frame's top-M symbols and backtracks the answer (both
// outside the Pallas kernel). Its plain version is
// pg_asr_tpu_torch/decoding/beam.py _scan_hash + _backtrack_batch. Contract:
//   log_probs  (B, T, A) float32
//   frame_lens (B,) int32; frames t >= frame_len keep the state and record
//              identity parents with sym -1
//   parents, syms (T, B, K) int32 backpointers, sym -1 = stay
//   lens (B, K) int32, scores (B, K) float32: the final slots
//   labels (B, NB, Lmax) int32 0-padded, nb_lens (B, NB) int32, nll (B, NB)
//              float32: NB = 1 the best slot; NB = K every slot by score
//              descending, ties in slot order (the n-best)
// Range: any K >= 1, any A, 1 <= M <= A; the block form's candidate lists
// (K (1 + M) of them) must fit its shared memory, else kErrBeamRange.
//
// Numerics and order, as the plain version: logaddexp is
// max + log1pf(expf(min - max)), NEG (-1e30) where max <= NEG/2; the merge
// is max + logf(sum expf(C - max)) over the slots in slot order; the int32
// rolling hash h * 1000003 + (s + 1) is computed in uint32, whose wrap is
// defined (signed overflow is not); the per-frame top-M over A symbols and
// the top-K over [K stays, then K x M extends row-major] both rank
// descending with ties toward the lower index, as lax.top_k.
//
// What bounds it on this card: the bytes are few (the log-prob rows of
// the valid frames and the (T, B, K) backpointers written once: ~10 MB per
// batch at B=128, T=401, K=16, ~3 us at 3.35 TB/s). The limit is the chain
// of T dependent frames: a frame cannot start before the previous one's
// new state exists. The first kernel (one block per utterance) spent ~3 us
// a frame in six phases separated by block barriers, each a few dependent
// shared-memory round trips.
//
// The warp form (K <= 32 and M <= 34, which holds the exact M = K + 2) has
// no block barrier: a warp owns an utterance (4 a block), a lane a beam
// slot, its state in registers. Per frame:
//   (1) the top-M symbols: where A <= 32 each lane ranks its symbol
//       against the row (32 broadcast loads, rank < M places it); else M
//       rounds of a warp argmax (redux.sync max over order-preserving
//       keys, then min over the indices at the max) over the symbols
//       ranked after the previous round's pick, the lane's symbols
//       (lane-strided) in registers where A <= 128;
//   (2) the K x K merge relation E: each lane its row against every slot's
//       (hash, length, validity) read from the warp's shared memory, the
//       columns by __ballot_sync (the loop over the slots unrolled to a
//       bound of 16 or 32, so that its loads issue back to back); the
//       stays with their merges, in slot order;
//   (3) the lane's M extends in registers, killed by the set bits of its
//       column of E;
//   (4) tau, the K-th largest of the slots' two best candidates (at least K
//       candidates reach it), the candidates at or above tau compacted by a
//       warp prefix sum into a list, ranked among themselves; rank < K
//       places a candidate;
//   (5) the new state from the parents' registers by __shfl_sync.
// The next frame's log-prob row is copied by cp.async into the warp's own
// buffer while the frame computes (rows of any A; where the rows of a
// block's warps do not fit its shared memory they are read from L2).
// With one warp per scheduler nothing hides a dependent instruction's
// latency: clock64() counters (PERF.md) put a frame at ~5.8 K cycles at
// M=6, spread over every phase (the tau / list / prefix-sum phase the
// largest, ~1.7 K), and the M loops over each slot's extends at ~140
// cycles an iteration, so the exact search (M=18) runs slower than the
// block-per-utterance kernel it replaced.
// The block form (K > 32, or M > 34) keeps the first kernel's phases with
// masks of ceil(K / 32) words and the top-M by rounds of a block argmax.
// After the loop, each backtracked slot's lane (thread) walks the
// backpointers its warp (block) wrote; a live slot's length is its number
// of emissions, so the walk writes each label in place.

#include <cuda_pipeline.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace pgasr {
namespace {

constexpr int kWarpMaxK = 32;
constexpr int kWarpMaxM = 34;   // K + 2 at K = 32: the exact search
constexpr int kRegMaxA = 128;   // rows a lane holds in registers (4 values)
constexpr int kBeamWarps = 4;   // utterances of a warp-form block
constexpr int kMaxThreads = 1024;
constexpr float kNeg = -1.0e30f;
constexpr float kHalfNeg = 0.5f * kNeg;
constexpr uint32_t kHashM = 1000003u;
constexpr unsigned kFull = 0xffffffffu;

struct BeamArgs {
  const float* log_probs;
  const int* frame_lens;
  int *parents, *syms, *lens_out;
  float* scores_out;
  int *labels, *nb_lens;
  float* nll;
  int B, T, A, K, M, Lmax, blank, NB;
};

__device__ __forceinline__ float lae(float a, float b) {
  const float mx = fmaxf(a, b);
  return mx <= kHalfNeg ? kNeg : mx + log1pf(expf(fminf(a, b) - mx));
}

// u (at index i) ranks before v (at index c): larger, or equal and earlier
__device__ __forceinline__ int beats(float u, int i, float v, int c) {
  return (u > v) | ((u == v) & (i < c));
}

// a key whose unsigned order is the float order (-0 taken as +0)
__device__ __forceinline__ unsigned fkey(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}

// the best (value, index) after (pv, pa) in the rank order among the
// lane's candidates, joined over the warp: ties toward the lower index.
// Returns the index (INT_MAX past the last)
__device__ __forceinline__ int warp_argmax(float bv, int ba) {
  const unsigned key = ba == INT_MAX ? 0u : fkey(bv);
  const unsigned kmax = __reduce_max_sync(kFull, key);
  return (int)__reduce_min_sync(kFull, key == kmax ? (unsigned)ba
                                                   : (unsigned)INT_MAX);
}

// the backpointers of the frozen frames t >= flen and the zeroed
// labels, by the `nt` threads numbered `i0` of the utterance's group
__device__ void beam_prologue(const BeamArgs& a, int b, int flen, int i0,
                              int nt) {
  int* lab = a.labels + (size_t)b * a.NB * a.Lmax;
  for (int i = i0; i < a.NB * a.Lmax; i += nt) lab[i] = 0;
  for (int i = i0; i < (a.T - flen) * a.K; i += nt) {
    const size_t o = ((size_t)(flen + i / a.K) * a.B + b) * a.K + i % a.K;
    a.parents[o] = i % a.K;
    a.syms[o] = -1;
  }
}

// the final slot `k` (score v, length len, rank among the K by score):
// outputs, and its backtrack if rank < NB. The backpointers of this
// utterance must be visible to the caller.
__device__ void beam_final(const BeamArgs& a, int b, int flen, int k, float v,
                           int len, int rank) {
  a.lens_out[b * a.K + k] = len;
  a.scores_out[b * a.K + k] = v;
  if (rank >= a.NB) return;
  a.nb_lens[b * a.NB + rank] = len;
  a.nll[b * a.NB + rank] = -v;
  int* row = a.labels + ((size_t)b * a.NB + rank) * a.Lmax;
  int n = len;
  if (v <= kHalfNeg) {  // a dead slot's path: count its emissions first
    n = 0;
    for (int t = flen - 1, slot = k; t >= 0; --t) {
      const size_t o = ((size_t)t * a.B + b) * a.K + slot;
      n += a.syms[o] >= 0;
      slot = a.parents[o];
    }
  }
  for (int t = flen - 1, slot = k; t >= 0 && n > 0; --t) {
    const size_t o = ((size_t)t * a.B + b) * a.K + slot;
    const int s = a.syms[o];
    if (s >= 0 && --n < a.Lmax) row[n] = s;
    slot = a.parents[o];
  }
}

// cp.async of row t of lp_b into buf (A floats), 16 bytes a copy where the
// row and the buffer are 16-byte aligned
__device__ __forceinline__ void fetch_row(float* buf, const float* lp_b,
                                          int t, int A, int i0, int nt) {
  const float* src = lp_b + (size_t)t * A;
  if ((A & 3) == 0 && ((reinterpret_cast<uintptr_t>(src) |
                        reinterpret_cast<uintptr_t>(buf)) & 15) == 0) {
    for (int a = 4 * i0; a < A; a += 4 * nt)
      __pipeline_memcpy_async(buf + a, src + a, 16);
  } else {
    for (int a = i0; a < A; a += nt)
      __pipeline_memcpy_async(buf + a, src + a, sizeof(float));
  }
  __pipeline_commit();
}

// ---------------------------------------------------------------------------
// The warp form.
// ---------------------------------------------------------------------------

// a warp's shared memory: the slots' (hash, last, length, alive) and (p_b,
// total), the two best candidates of each slot (every lane: -inf past K),
// the frame's top-M, each slot's extends [r][slot], the list of
// candidates at or above tau and the top K; then, where staged, the two
// row buffers (of 32 floats at least, -inf past A)
struct WarpSmem {
  int4 st[kWarpMaxK];
  float2 sp[kWarpMaxK];
  float best[2 * kWarpMaxK];
  float tlp[kWarpMaxM];
  int tsym[kWarpMaxM];
  float ext[kWarpMaxM][kWarpMaxK];
  float lscore[kWarpMaxK * (1 + kWarpMaxM)];
  int lidx[kWarpMaxK * (1 + kWarpMaxM)];
  int top[kWarpMaxK];
  float top_score[kWarpMaxK];
};

// the warp form's ways to a frame's top-M symbols: A <= 32, each lane
// ranks its symbol among all A (one pass, no chain of rounds); A <= 128,
// rounds of a warp argmax over the lane's 4 symbols in registers; else
// rounds over the row, lane-strided
enum { kTopRank, kTopRegs, kTopRow };

// KB: a bound on K (16 or 32), so that the loops over the slots unroll
// and their loads issue back to back
template <int KB, int kTop>
__global__ void __launch_bounds__(32 * kBeamWarps)
ctc_beam_warp(const BeamArgs a, int staged, int a4) {
  extern __shared__ float4 smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kBeamWarps + warp;
  if (b >= a.B) return;  // whole warps leave; no block barrier follows
  WarpSmem& S = reinterpret_cast<WarpSmem*>(smem_raw)[warp];
  float* rows = reinterpret_cast<float*>(
                    reinterpret_cast<WarpSmem*>(smem_raw) + kBeamWarps) +
                (size_t)warp * 2 * a4;
  const int K = a.K, M = a.M, A = a.A;
  const int flen = min(max(a.frame_lens[b], 0), a.T);
  const float* lp_b = a.log_probs + (size_t)b * a.T * A;
  beam_prologue(a, b, flen, lane, 32);

  // slot `lane`: slot 0 holds the empty prefix; lanes >= K are dead
  uint32_t h = 0u;
  int last = -1, len = 0;
  float pb = lane == 0 ? 0.0f : kNeg, pnb = kNeg;
  float total = lae(pb, pnb);
  if constexpr (kTop == kTopRank) {  // the rows' pads past A rank nothing
    if (lane >= A) rows[lane] = rows[a4 + lane] = -INFINITY;
  }
  if (staged && flen > 0) fetch_row(rows, lp_b, 0, A, lane, 32);

  for (int t = 0; t < flen; ++t) {
    const float* row = staged ? rows + (t & 1) * a4 : lp_b + (size_t)t * A;
    if (staged) {
      __pipeline_wait_prior(0);
      __syncwarp();  // every lane's copies of row t landed
      if (t + 1 < flen) fetch_row(rows + ((t + 1) & 1) * a4, lp_b, t + 1, A,
                                  lane, 32);
    }
    // (1) the top-M symbols into the warp's shared memory
    if constexpr (kTop == kTopRank) {  // the row staged, 32 floats
      const float v = row[lane];
      int rank = 0;
#pragma unroll
      for (int q = 0; q < 32; q += 4) {
        const float4 u = *reinterpret_cast<const float4*>(row + q);
        rank += beats(u.x, q, v, lane) + beats(u.y, q + 1, v, lane)
                + beats(u.z, q + 2, v, lane) + beats(u.w, q + 3, v, lane);
      }
      if (lane < A && rank < M) {
        S.tlp[rank] = v;
        S.tsym[rank] = lane;
      }
    } else {
      float v[4];
      if constexpr (kTop == kTopRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = lane + 32 * i < A ? row[lane + 32 * i] : -INFINITY;
      }
      float pv = INFINITY;
      int pa = -1;
      for (int r = 0; r < M; ++r) {
        float bv = -INFINITY;
        int ba = INT_MAX;
        if constexpr (kTop == kTopRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = lane + 32 * i;
            if (s < A && beats(pv, pa, v[i], s) && beats(v[i], s, bv, ba)) {
              bv = v[i];
              ba = s;
            }
          }
        } else {
          for (int s = lane; s < A; s += 32) {
            const float x = row[s];
            if (beats(pv, pa, x, s) && beats(x, s, bv, ba)) {
              bv = x;
              ba = s;
            }
          }
        }
        pa = warp_argmax(bv, ba);
        pv = row[pa];
        if (lane == (r & 31)) {
          S.tlp[r] = pv;
          S.tsym[r] = pa;
        }
      }
    }
    // (2) the slots' state for the others, then E and the stays
    const bool valid = total > kHalfNeg;
    S.st[lane] = make_int4((int)h, last, len, valid);
    S.sp[lane] = make_float2(pb, total);
    __syncwarp();
    const float lp_last = row[max(last, 0)];
    const float lp_blank = row[a.blank];
    unsigned erow = 0u, ecol = 0u;
    const uint32_t hx = h;  // prefix_j == prefix_k + last_j
#pragma unroll
    for (int k = 0; k < KB; ++k) {  // slots past K are dead: no E
      const int4 sk = S.st[k];
      const bool e = valid && last >= 0 && len == sk.z + 1 && sk.w &&
                     hx == (uint32_t)sk.x * kHashM + (uint32_t)max(last, 0)
                               + 1u;
      erow |= (unsigned)e << k;
      const unsigned col = __ballot_sync(kFull, e);
      ecol = lane == k ? col : ecol;
    }
    const float stay_pb = valid ? total + lp_blank : kNeg;
    float stay_pnb = (valid && last >= 0) ? pnb + lp_last : kNeg;
    {
      float cmax = kNeg;
      for (unsigned m = erow; m; m &= m - 1u) {
        const int k = __ffs(m) - 1;
        const float2 q = S.sp[k];
        cmax = fmaxf(cmax, (last == S.st[k].y ? q.x : q.y) + lp_last);
      }
      float merged = kNeg;
      if (cmax > kHalfNeg) {
        float sum = 0.0f;
        for (unsigned m = erow; m; m &= m - 1u) {
          const int k = __ffs(m) - 1;
          const float2 q = S.sp[k];
          sum += expf((last == S.st[k].y ? q.x : q.y) + lp_last - cmax);
        }
        merged = fmaxf(cmax + logf(sum), kNeg);
      }
      stay_pnb = lae(stay_pnb, merged);
    }
    const float stay = lane < K ? lae(stay_pb, stay_pnb) : -INFINITY;
    // (3) the lane's extends (-inf past K), and its two best candidates
    float b1 = stay, b2 = -INFINITY;
    for (int r = 0; r < M; ++r) {
      const int sym = S.tsym[r];
      bool dead = sym == a.blank || !valid || len >= a.Lmax;
      // killed: prefix + sym is already slot j of E's column (merged into
      // j's stay)
      for (unsigned m = ecol; m && !dead; m &= m - 1u)
        dead = S.st[__ffs(m) - 1].y == sym;
      const float x = lane >= K ? -INFINITY
                      : dead    ? kNeg
                                : (sym == last ? pb : total) + S.tlp[r];
      S.ext[r][lane] = x;
      b2 = fmaxf(b2, fminf(b1, x));
      b1 = fmaxf(b1, x);
    }
    // (4) tau, the list at or above it, the ranks
    S.best[2 * lane] = b1;
    S.best[2 * lane + 1] = b2;
    __syncwarp();
    float tau = -INFINITY;
    {
      int ge1 = 0, ge2 = 0;  // the -inf past 2K reach no slot's b1, b2
#pragma unroll
      for (int i = 0; i < 2 * KB; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(&S.best[i]);
        ge1 += (x.x >= b1) + (x.y >= b1) + (x.z >= b1) + (x.w >= b1);
        ge2 += (x.x >= b2) + (x.y >= b2) + (x.z >= b2) + (x.w >= b2);
      }
      if (lane < K) {
        if (ge1 >= K) tau = b1;
        if (ge2 >= K) tau = fmaxf(tau, b2);
      }
    }
    {
      const unsigned tk = __reduce_max_sync(kFull, fkey(tau));
      tau = __uint_as_float((tk & 0x80000000u) ? tk & 0x7fffffffu : ~tk);
    }
    int n = lane < K && stay >= tau;
    for (int r = 0; r < M; ++r) n += S.ext[r][lane] >= tau;
    int off = n;  // inclusive prefix sum over the lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(kFull, off, d);
      if (lane >= d) off += x;
    }
    const int np = __shfl_sync(kFull, off, 31);
    off -= n;
    if (lane < K) {
      if (stay >= tau) {
        S.lscore[off] = stay;
        S.lidx[off++] = lane;
      }
      for (int r = 0; r < M; ++r) {
        const float x = S.ext[r][lane];
        if (x >= tau) {
          S.lscore[off] = x;
          S.lidx[off++] = K + lane * M + r;
        }
      }
    }
    __syncwarp();
    for (int p = lane; p < np; p += 32) {
      const float x = S.lscore[p];
      const int c = S.lidx[p];
      int rank = 0;
#pragma unroll 8
      for (int q = 0; q < np; ++q) rank += beats(S.lscore[q], S.lidx[q], x, c);
      if (rank < K) {
        S.top[rank] = c;
        S.top_score[rank] = x;
      }
    }
    __syncwarp();
    // (5) the new state, from the parents' registers
    const int idx = lane < K ? S.top[lane] : 0;
    const float ts = lane < K ? S.top_score[lane] : kNeg;
    const bool is_stay = idx < K;
    const int parent = is_stay ? idx : (idx - K) / M;
    const int sym = is_stay ? -1 : S.tsym[(idx - K) - parent * M];
    const uint32_t ph = __shfl_sync(kFull, h, parent);
    const int plast = __shfl_sync(kFull, last, parent);
    const int plen = __shfl_sync(kFull, len, parent);
    const float spb = __shfl_sync(kFull, stay_pb, parent);
    const float spnb = __shfl_sync(kFull, stay_pnb, parent);
    if (lane < K) {
      const size_t o = ((size_t)t * a.B + b) * K + lane;
      a.parents[o] = parent;
      a.syms[o] = sym;
      if (ts <= kHalfNeg) {  // dead slots stay dead
        h = 0u;
        last = -1;
        len = 0;
        pb = kNeg;
        pnb = kNeg;
      } else {
        h = is_stay ? ph : ph * kHashM + (uint32_t)(sym + 1);
        last = is_stay ? plast : sym;
        len = plen + (is_stay ? 0 : 1);
        pb = is_stay ? spb : kNeg;
        pnb = is_stay ? spnb : ts;
      }
      total = lae(pb, pnb);
    }
    __syncwarp();  // the frame's shared memory read before the next's writes
  }

  // the final slots, ranked by score; the backtracks
  S.sp[lane] = make_float2(0.0f, total);
  __syncwarp();  // and every lane's backpointers written
  if (lane < K) {
    int rank = 0;
    for (int k = 0; k < K; ++k) rank += beats(S.sp[k].y, k, total, lane);
    beam_final(a, b, flen, lane, total, len, rank);
  }
}

// ---------------------------------------------------------------------------
// The block form: one block per utterance, slot masks of W words.
// ---------------------------------------------------------------------------

// shared memory of the block form, in 4-byte words
struct BlockSmem {
  int W;
  size_t tlp, tsym, h, last, lens, pb, pnb, total, spb, spnb, erow, ecol,
      score, pscore, pidx, best, top, topsc, red, misc, rows, total_words;
  __host__ __device__ BlockSmem(int K, int M, int a4, bool staged) {
    const size_t C = (size_t)K * (1 + M);
    W = (K + 31) / 32;
    size_t o = 0;
    tlp = o; o += M;
    tsym = o; o += M;
    h = o; o += K;
    last = o; o += K;
    lens = o; o += K;
    pb = o; o += K;
    pnb = o; o += K;
    total = o; o += K;
    spb = o; o += K;
    spnb = o; o += K;
    erow = o; o += (size_t)K * W;
    ecol = o; o += (size_t)K * W;
    score = o; o += C;
    pscore = o; o += C;
    pidx = o; o += C;
    best = o; o += 2 * K;
    top = o; o += K;
    topsc = o; o += K;
    red = o; o += 2 * (kMaxThreads / 32);
    misc = o; o += 4;               // tau, np
    rows = (o + 3) & ~(size_t)3;    // 16-byte aligned
    total_words = rows + (staged ? 2 * (size_t)a4 : 0);
  }
};

__global__ void __launch_bounds__(kMaxThreads)
ctc_beam_block(const BeamArgs a, int staged, int a4) {
  extern __shared__ float4 smem_raw[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int K = a.K, M = a.M, A = a.A;
  const BlockSmem L(K, M, a4, staged != 0);
  const int W = L.W;
  float* f = reinterpret_cast<float*>(smem_raw);
  int* n = reinterpret_cast<int*>(smem_raw);
  uint32_t* u = reinterpret_cast<uint32_t*>(smem_raw);
  float *s_tlp = f + L.tlp, *s_pb = f + L.pb, *s_pnb = f + L.pnb,
        *s_total = f + L.total, *s_spb = f + L.spb, *s_spnb = f + L.spnb,
        *s_score = f + L.score, *s_pscore = f + L.pscore,
        *s_best = f + L.best, *s_topsc = f + L.topsc, *s_rows = f + L.rows;
  int *s_tsym = n + L.tsym, *s_last = n + L.last, *s_lens = n + L.lens,
      *s_pidx = n + L.pidx, *s_top = n + L.top;
  uint32_t *s_h = u + L.h, *s_erow = u + L.erow, *s_ecol = u + L.ecol,
           *s_red = u + L.red;
  float* s_tau = f + L.misc;
  int* s_np = n + L.misc + 1;
  const int C = K * (1 + M);
  const int flen = min(max(a.frame_lens[b], 0), a.T);
  const float* lp_b = a.log_probs + (size_t)b * a.T * A;
  beam_prologue(a, b, flen, tid, nt);
  for (int k = tid; k < K; k += nt) {  // slot 0 holds the empty prefix
    s_h[k] = 0u;
    s_last[k] = -1;
    s_lens[k] = 0;
    s_pb[k] = k == 0 ? 0.0f : kNeg;
    s_pnb[k] = kNeg;
    s_total[k] = lae(s_pb[k], kNeg);
  }
  for (int i = tid; i < K * W; i += nt) s_erow[i] = s_ecol[i] = 0u;
  if (staged && flen > 0) fetch_row(s_rows, lp_b, 0, A, tid, nt);
  __syncthreads();

  for (int t = 0; t < flen; ++t) {
    const float* lp =
        staged ? s_rows + (t & 1) * a4 : lp_b + (size_t)t * A;
    if (staged) {
      __pipeline_wait_prior(0);
      __syncthreads();
      if (t + 1 < flen)
        fetch_row(s_rows + ((t + 1) & 1) * a4, lp_b, t + 1, A, tid, nt);
    }
    // ---- E pairs (bit k of row j, bit j of column k) ----
    for (int i = tid; i < K * K; i += nt) {
      const int j = i / K, k = i - j * K;
      const int last = s_last[j];
      const bool e = (s_total[j] > kHalfNeg) & (last >= 0)
                     & (s_lens[j] == s_lens[k] + 1) & (s_total[k] > kHalfNeg)
                     & (s_h[j] == s_h[k] * kHashM + (uint32_t)max(last, 0) + 1u);
      if (e) {
        atomicOr(&s_erow[j * W + (k >> 5)], 1u << (k & 31));
        atomicOr(&s_ecol[k * W + (j >> 5)], 1u << (j & 31));
      }
    }
    // ---- the top-M symbols: M rounds of a block argmax ----
    {
      float pv = INFINITY;
      int pa = -1;
      for (int r = 0; r < M; ++r) {
        float bv = -INFINITY;
        int ba = INT_MAX;
        for (int s = tid; s < A; s += nt) {
          const float x = lp[s];
          if (beats(pv, pa, x, s) && beats(x, s, bv, ba)) {
            bv = x;
            ba = s;
          }
        }
        const unsigned key = ba == INT_MAX ? 0u : fkey(bv);
        const unsigned kmax = __reduce_max_sync(kFull, key);
        const unsigned amin = __reduce_min_sync(
            kFull, key == kmax ? (unsigned)ba : (unsigned)INT_MAX);
        if (lane == 0) {
          s_red[2 * warp] = kmax;
          s_red[2 * warp + 1] = amin;
        }
        __syncthreads();
        unsigned bk = 0u, bi = (unsigned)INT_MAX;
        for (int w = 0; w < nw; ++w) {
          const unsigned k2 = s_red[2 * w], i2 = s_red[2 * w + 1];
          if (k2 > bk || (k2 == bk && i2 < bi)) {
            bk = k2;
            bi = i2;
          }
        }
        pa = (int)bi;
        pv = lp[pa];
        if (tid == 0) {
          s_tlp[r] = pv;
          s_tsym[r] = pa;
        }
        __syncthreads();  // s_red read before the next round's writes
      }
    }

    // ---- candidate scores: K stays, then the K x M extends row-major ----
    for (int c = tid; c < C; c += nt) {
      float score;
      if (c < K) {  // stay of slot j, with the merge of E row j
        const int j = c;
        const float total = s_total[j];
        const bool valid = total > kHalfNeg;
        const int last = s_last[j];
        const float lp_last = lp[max(last, 0)];
        const float stay_pb = valid ? total + lp[a.blank] : kNeg;
        const float stay_pnb0 =
            (valid && last >= 0) ? s_pnb[j] + lp_last : kNeg;
        float cmax = kNeg;
        for (int w = 0; w < W; ++w)
          for (uint32_t m = s_erow[j * W + w]; m; m &= m - 1u) {
            const int k = 32 * w + __ffs(m) - 1;
            cmax = fmaxf(cmax,
                         (last == s_last[k] ? s_pb[k] : s_total[k]) + lp_last);
          }
        float merged = kNeg;
        if (cmax > kHalfNeg) {
          float sum = 0.0f;
          for (int w = 0; w < W; ++w)
            for (uint32_t m = s_erow[j * W + w]; m; m &= m - 1u) {
              const int k = 32 * w + __ffs(m) - 1;
              sum += expf((last == s_last[k] ? s_pb[k] : s_total[k])
                          + lp_last - cmax);
            }
          merged = fmaxf(cmax + logf(sum), kNeg);
        }
        const float stay_pnb = lae(stay_pnb0, merged);
        s_spb[j] = stay_pb;
        s_spnb[j] = stay_pnb;
        score = lae(stay_pb, stay_pnb);
      } else {
        const int k = (c - K) / M, r = (c - K) - k * M;
        const int sym = s_tsym[r];
        const float total = s_total[k];
        const float src = sym == s_last[k] ? s_pb[k] : total;
        bool dead = sym == a.blank || total <= kHalfNeg || s_lens[k] >= a.Lmax;
        // killed: prefix_k + sym is already slot j (merged into its stay)
        for (int w = 0; w < W && !dead; ++w)
          for (uint32_t m = s_ecol[k * W + w]; m && !dead; m &= m - 1u)
            dead = s_last[32 * w + __ffs(m) - 1] == sym;
        score = dead ? kNeg : src + s_tlp[r];
      }
      s_score[c] = score;
    }
    __syncthreads();

    // ---- top-K: tau, the candidates at or above it, their ranks ----
    if (tid < 32) {
      for (int j = tid; j < K; j += 32) {
        float b1 = s_score[j], b2 = -INFINITY;
        const float* row = &s_score[K + j * M];
        for (int r = 0; r < M; ++r) {
          const float v = row[r];
          b2 = fmaxf(b2, fminf(b1, v));
          b1 = fmaxf(b1, v);
        }
        s_best[2 * j] = b1;
        s_best[2 * j + 1] = b2;
      }
      __syncwarp();
      float tau = -INFINITY;
      for (int i = tid; i < 2 * K; i += 32) {
        const float v = s_best[i];
        int ge = 0;
        for (int q = 0; q < 2 * K; ++q) ge += s_best[q] >= v;
        if (ge >= K) tau = fmaxf(tau, v);
      }
      for (int o = 16; o; o >>= 1)
        tau = fmaxf(tau, __shfl_xor_sync(kFull, tau, o));
      if (tid == 0) {
        *s_tau = tau;
        *s_np = 0;
      }
    }
    __syncthreads();
    {
      const float tau = *s_tau;
      for (int c = tid; c < C; c += nt) {
        const float v = s_score[c];
        if (v >= tau) {
          const int p = atomicAdd(s_np, 1);
          s_pscore[p] = v;
          s_pidx[p] = c;
        }
      }
    }
    __syncthreads();
    {
      const int np = *s_np;
      for (int p = tid; p < np; p += nt) {
        const float v = s_pscore[p];
        const int c = s_pidx[p];
        int rank = 0;
        for (int q = 0; q < np; ++q)
          rank += beats(s_pscore[q], s_pidx[q], v, c);
        if (rank < K) {
          s_top[rank] = c;
          s_topsc[rank] = v;
        }
      }
    }
    __syncthreads();

    // ---- new state and backpointers ----
    uint32_t nh = 0u;
    int nlast = -1, nlens = 0;
    float npb = kNeg, npnb = kNeg;
    if (tid < K) {
      const int idx = s_top[tid];
      const float ts = s_topsc[tid];
      const bool stay = idx < K;
      const int parent = stay ? idx : (idx - K) / M;
      const int sym = stay ? -1 : s_tsym[(idx - K) - parent * M];
      const size_t o = ((size_t)t * a.B + b) * K + tid;
      a.parents[o] = parent;
      a.syms[o] = sym;
      if (ts > kHalfNeg) {  // dead slots stay dead
        const uint32_t ph = s_h[parent];
        nh = stay ? ph : ph * kHashM + (uint32_t)(sym + 1);
        nlast = stay ? s_last[parent] : sym;
        nlens = s_lens[parent] + (stay ? 0 : 1);
        npb = stay ? s_spb[parent] : kNeg;
        npnb = stay ? s_spnb[parent] : ts;
      }
    }
    __syncthreads();  // every slot has read the old state
    if (tid < K) {
      s_h[tid] = nh;
      s_last[tid] = nlast;
      s_lens[tid] = nlens;
      s_pb[tid] = npb;
      s_pnb[tid] = npnb;
      s_total[tid] = lae(npb, npnb);
    }
    for (int i = tid; i < K * W; i += nt) s_erow[i] = s_ecol[i] = 0u;
    __syncthreads();
  }

  // ---- final slots; the backtrack of the best one (NB = 1) or of all ----
  for (int k = tid; k < K; k += nt) {
    const float v = s_total[k];
    int rank = 0;
    for (int q = 0; q < K; ++q) rank += beats(s_total[q], q, v, k);
    beam_final(a, b, flen, k, v, s_lens[k], rank);
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
}  // namespace pgasr

extern "C" {

// Pointers as in the contract above; NB = 1 (best) or K (n-best). Returns
// 0, kErrBeamRange, or a cudaError_t.
int pgasr_ctc_beam(const float* log_probs, const int* frame_lens, int* parents,
                   int* syms, int* lens, float* scores, int* labels,
                   int* nb_lens, float* nll, int B, int T, int A, int K, int M,
                   int Lmax, int blank, int NB, cudaStream_t stream) {
  using namespace pgasr;
  if (B < 1 || T < 1 || K < 1 || M < 1 || M > A || Lmax < 1 || Lmax > T
      || blank < 0 || blank >= A || (NB != 1 && NB != K))
    return kErrBeamRange;
  const BeamArgs a{log_probs, frame_lens, parents, syms, lens, scores,
                   labels, nb_lens, nll, B, T, A, K, M, Lmax, blank, NB};
  int smem_max = 0;
  int e = smem_optin(&smem_max);
  if (e != 0) return e;
  const int a4 = (A + 3) & ~3;
  if (K <= kWarpMaxK && M <= kWarpMaxM) {
    const int rs = A <= 32 ? 32 : a4;  // a row buffer's floats
    const size_t base = kBeamWarps * sizeof(WarpSmem);
    const size_t rows = (size_t)kBeamWarps * 2 * rs * sizeof(float);
    const int staged = base + rows <= (size_t)smem_max;
    const size_t smem = base + (staged ? rows : 0);
    const unsigned grid = (unsigned)((B + kBeamWarps - 1) / kBeamWarps);
    using Kernel = void (*)(BeamArgs, int, int);
    const Kernel kernels[2][3] = {
        {ctc_beam_warp<16, kTopRank>, ctc_beam_warp<16, kTopRegs>,
         ctc_beam_warp<16, kTopRow>},
        {ctc_beam_warp<32, kTopRank>, ctc_beam_warp<32, kTopRegs>,
         ctc_beam_warp<32, kTopRow>}};
    // the one-pass rank reads the staged row (always staged at A <= 32)
    const Kernel kernel =
        kernels[K > 16][A <= 32 && staged ? kTopRank
                        : A <= kRegMaxA   ? kTopRegs
                                          : kTopRow];
    e = set_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<grid, 32 * kBeamWarps, smem, stream>>>(a, staged, rs);
    return cudaGetLastError();
  }
  // one thread per candidate, at least 256
  const int C = K * (1 + M);
  const int threads = std::min(kMaxThreads, (std::max(C, 256) + 31) / 32 * 32);
  const size_t bare = BlockSmem(K, M, a4, false).total_words * 4;
  const size_t full = BlockSmem(K, M, a4, true).total_words * 4;
  if (bare > (size_t)smem_max) return kErrBeamRange;
  const int staged = full <= (size_t)smem_max;
  const size_t smem = staged ? full : bare;
  e = set_smem(ctc_beam_block, smem);
  if (e != 0) return e;
  ctc_beam_block<<<B, threads, smem, stream>>>(a, staged, a4);
  return cudaGetLastError();
}

}  // extern "C"
