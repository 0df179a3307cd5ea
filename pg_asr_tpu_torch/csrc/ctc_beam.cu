// CTC prefix beam search for Hopper (sm_90a), one block per utterance.
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
// Range: K <= 32 (a slot is a bit of a 32-bit mask), 2 <= M <= min(A, 64),
// A <= 1024 (log-prob rows and candidates live in static shared memory);
// the entry point returns kErrBeamRange outside it.
//
// Numerics and order, as the plain version: logaddexp is
// max + log1pf(expf(min - max)), NEG (-1e30) where max <= NEG/2; the merge
// is max + logf(sum expf(C - max)) over the slots in slot order; the int32
// rolling hash h * 1000003 + (s + 1) is computed in uint32, whose wrap is
// defined (signed overflow is not); the per-frame top-M over A symbols and
// the top-K over [K stays, then K x M extends row-major] both rank
// descending with ties toward the lower index, as lax.top_k: a candidate's
// rank is #{better} + #{equal with a lower index}, a permutation, so
// rank < K places it directly.
//
// What bounds it on this card: the bytes are few (the log-prob rows of
// the valid frames and the (T, B, K) backpointers written once: ~10 MB per
// batch at B=128, T=401, K=16, ~3 us at 3.35 TB/s). The limit is the chain
// of T dependent frames, each a few phases separated by block barriers,
// every phase a few dependent shared-memory round trips.
//
// What the design does about it: one launch for the batch and one block
// per utterance (128 blocks at the beam's default batch fill 128 of 132
// SMs); the beam state lives in shared memory for all T frames, and the
// next frame's log-prob row is copied in by cp.async while the current
// frame computes, so no HBM latency sits on the chain. A frame is six
// barriers, each phase parallel over threads: (1) the K x K merge relation
// E, one pair per thread, and each symbol's rank among A; (2) one thread
// per candidate: its score, the stays with their merge; (3) a threshold
// tau, the K-th best of each slot's two best candidates, which at least K
// candidates reach; (4) the candidates at or above tau into a list; (5)
// their ranks among themselves (a candidate below tau has K better ones),
// a few dozen instead of all C = K(1+M); (6) the new state and the
// backpointers. No one-hot contractions: a thread indexes. After the loop
// the best slot's (or each slot's) thread walks the backpointers this
// block wrote; a live slot's length is its number of emissions, so the
// walk writes each label in place and stops at the first.

#include <cuda_pipeline.h>
#include <math.h>
#include <algorithm>
#include <stdint.h>

#include "common.cuh"

namespace pgasr {
namespace {

constexpr int kMaxK = 32;
constexpr int kMaxM = 64;
constexpr int kMaxA = 1024;
constexpr int kMaxC = kMaxK * (1 + kMaxM);
constexpr int kMaxThreads = 1024;
constexpr float kNeg = -1.0e30f;
constexpr float kHalfNeg = 0.5f * kNeg;
constexpr uint32_t kHashM = 1000003u;

__device__ __forceinline__ float lae(float a, float b) {
  const float mx = fmaxf(a, b);
  return mx <= kHalfNeg ? kNeg : mx + log1pf(expf(fminf(a, b) - mx));
}

// u (at index i) ranks before v (at index c): larger, or equal and earlier
__device__ __forceinline__ int beats(float u, int i, float v, int c) {
  return (u > v) | ((u == v) & (i < c));
}

__global__ void __launch_bounds__(kMaxThreads)
ctc_beam_kernel(const float* __restrict__ log_probs,
                const int* __restrict__ frame_lens, int* parents, int* syms,
                int* __restrict__ lens_out, float* __restrict__ scores_out,
                int* __restrict__ labels, int* __restrict__ nb_lens,
                float* __restrict__ nll, int B, int T, int A, int K, int M,
                int Lmax, int blank, int NB) {
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int C = K * (1 + M);
  const int A4 = (A + 3) & ~3;
  const int flen = min(max(frame_lens[b], 0), T);
  const float* lp_b = log_probs + (size_t)b * T * A;
  int* lab = labels + (size_t)b * NB * Lmax;

  // this frame's log-prob row and the next one's, -inf past A
  __shared__ __align__(16) float s_lp[2][kMaxA + 4];
  __shared__ float s_tlp[kMaxM];     // the frame's top-M log-probs, ranked
  __shared__ int s_tsym[kMaxM];      // and their symbols
  // beam state, slot k: hash, last symbol (-1 empty), length, p_b, p_nb,
  // and total = logaddexp(p_b, p_nb)
  __shared__ uint32_t s_h[kMaxK];
  __shared__ int s_last[kMaxK], s_lens[kMaxK];
  __shared__ float s_pb[kMaxK], s_pnb[kMaxK], s_total[kMaxK];
  // per frame: stay candidates (p_nb after the merge); E by rows (bit k of
  // s_Erow[j]: prefix_j == prefix_k + last_j) and by columns; candidate
  // scores; each slot's two best; tau; the list at or above tau; the top K
  __shared__ float s_stay_pb[kMaxK], s_stay_pnb[kMaxK];
  __shared__ uint32_t s_Erow[kMaxK], s_Ecol[kMaxK];
  __shared__ float s_score[kMaxC];
  __shared__ float s_pscore[kMaxC];
  __shared__ int s_pidx[kMaxC];
  __shared__ __align__(16) float s_best[2 * kMaxK + 4];
  __shared__ float s_tau;
  __shared__ int s_np;
  __shared__ int s_top[kMaxK];
  __shared__ float s_top_score[kMaxK];

  for (int i = tid; i < NB * Lmax; i += nt) lab[i] = 0;
  for (int i = tid; i < (T - flen) * K; i += nt) {  // frozen frames
    const size_t o = ((size_t)(flen + i / K) * B + b) * K + i % K;
    parents[o] = i % K;
    syms[o] = -1;
  }
  if (tid < K) {  // slot 0 holds the empty prefix
    s_h[tid] = 0u;
    s_last[tid] = -1;
    s_lens[tid] = 0;
    s_pb[tid] = tid == 0 ? 0.0f : kNeg;
    s_pnb[tid] = kNeg;
    s_total[tid] = lae(s_pb[tid], kNeg);
    s_Erow[tid] = s_Ecol[tid] = 0u;
  }
  // pads past A and 2K rank nothing: -inf is never >= a finite value
  for (int a = A + tid; a < A4; a += nt) s_lp[0][a] = s_lp[1][a] = -INFINITY;
  for (int i = 2 * K + tid; i < 2 * K + 4; i += nt) s_best[i] = -INFINITY;
  if (flen > 0)
    for (int a = tid; a < A; a += nt) s_lp[0][a] = lp_b[a];
  __syncthreads();

  const unsigned kmask = K == 32 ? 0xffffffffu : (1u << K) - 1u;
  for (int t = 0; t < flen; ++t) {
    const float* lp = s_lp[t & 1];
    if (t + 1 < flen) {
      for (int a = tid; a < A; a += nt)
        __pipeline_memcpy_async(&s_lp[(t + 1) & 1][a],
                                lp_b + (size_t)(t + 1) * A + a, sizeof(float));
      __pipeline_commit();
    }

    // ---- E pairs and the top-M symbols, one item per thread ----
    // E[j][k] (prefix_j == prefix_k + last_j, by the wrapping hash) sets
    // bit k of s_Erow[j] and bit j of s_Ecol[k]; symbol a's rank among the
    // frame's A log-probs places it in the top M
    for (int i = tid; i < K * K + A; i += nt) {
      if (i < K * K) {
        const int j = i / K, k = i - j * K;
        const int last = s_last[j];
        const bool e = (s_total[j] > kHalfNeg) & (last >= 0)
                       & (s_lens[j] == s_lens[k] + 1) & (s_total[k] > kHalfNeg)
                       & (s_h[j]
                          == s_h[k] * kHashM + (uint32_t)max(last, 0) + 1u);
        if (e) {
          atomicOr(&s_Erow[j], 1u << k);
          atomicOr(&s_Ecol[k], 1u << j);
        }
      } else {
        const int a = i - K * K;
        const float v = lp[a];
        int rank = 0;
#pragma unroll 4
        for (int a2 = 0; a2 < A4; a2 += 4) {
          const float4 u = *reinterpret_cast<const float4*>(&lp[a2]);
          rank += beats(u.x, a2, v, a) + beats(u.y, a2 + 1, v, a)
                  + beats(u.z, a2 + 2, v, a) + beats(u.w, a2 + 3, v, a);
        }
        if (rank < M) {
          s_tlp[rank] = v;
          s_tsym[rank] = a;
        }
      }
    }
    __syncthreads();

    // ---- candidate scores: K stays, then the K x M extends row-major ----
    for (int c = tid; c < C; c += nt) {
      float score;
      if (c < K) {  // stay of slot j, with the merge of E row j
        const int j = c;
        const float total = s_total[j];
        const bool valid = total > kHalfNeg;
        const int last = s_last[j];
        const float lp_last = lp[max(last, 0)];
        const float stay_pb = valid ? total + lp[blank] : kNeg;
        const float stay_pnb0 =
            (valid && last >= 0) ? s_pnb[j] + lp_last : kNeg;
        // max + log(sum exp) over the row's E entries, in slot order;
        // entries off E are NEG and add exp(NEG - max) = 0 to the sum
        // unless every entry is ~NEG, and then the result is NEG either way
        const uint32_t row = s_Erow[j];
        float cmax = kNeg;
        for (uint32_t m = row; m; m &= m - 1u) {
          const int k = __ffs(m) - 1;
          cmax = fmaxf(cmax,
                       (last == s_last[k] ? s_pb[k] : s_total[k]) + lp_last);
        }
        float merged = kNeg;
        if (cmax > kHalfNeg) {
          float sum = 0.0f;
          for (uint32_t m = row; m; m &= m - 1u) {
            const int k = __ffs(m) - 1;
            sum += expf((last == s_last[k] ? s_pb[k] : s_total[k]) + lp_last
                        - cmax);
          }
          merged = fmaxf(cmax + logf(sum), kNeg);
        }
        const float stay_pnb = lae(stay_pnb0, merged);
        s_stay_pb[j] = stay_pb;
        s_stay_pnb[j] = stay_pnb;
        score = lae(stay_pb, stay_pnb);
      } else {
        const int k = (c - K) / M, r = (c - K) - k * M;
        const int sym = s_tsym[r];
        const float total = s_total[k];
        const float src = sym == s_last[k] ? s_pb[k] : total;
        bool dead = sym == blank || total <= kHalfNeg || s_lens[k] >= Lmax;
        // killed: prefix_k + sym is already slot j (merged into its stay)
        for (uint32_t m = s_Ecol[k]; m && !dead; m &= m - 1u)
          dead = s_last[__ffs(m) - 1] == sym;
        score = dead ? kNeg : src + s_tlp[r];
      }
      s_score[c] = score;
    }
    __syncthreads();

    // ---- top-K: a threshold, the candidates above it, their ranks ----
    // tau = the K-th largest of each slot's two best candidates (2K
    // distinct candidates): at least K candidates score >= tau, so one
    // below tau has K better ones and rank >= K. Only the candidates at or
    // above tau are ranked, among themselves.
    if (tid < 32) {
      if (tid < K) {
        float b1 = s_score[tid], b2 = -INFINITY;
        const float* row = &s_score[K + tid * M];
        for (int r = 0; r < M; ++r) {
          const float v = row[r];
          b2 = fmaxf(b2, fminf(b1, v));
          b1 = fmaxf(b1, v);
        }
        s_best[2 * tid] = b1;
        s_best[2 * tid + 1] = b2;
      }
      __syncwarp();
      float tau = -INFINITY;
      for (int i = tid; i < 2 * K; i += 32) {
        const float v = s_best[i];
        int ge = 0;
#pragma unroll 4
        for (int q = 0; q < 2 * K; q += 4) {
          const float4 u = *reinterpret_cast<const float4*>(&s_best[q]);
          ge += (u.x >= v) + (u.y >= v) + (u.z >= v) + (u.w >= v);
        }
        if (ge >= K) tau = fmaxf(tau, v);
      }
      for (int o = 16; o; o >>= 1)
        tau = fmaxf(tau, __shfl_xor_sync(0xffffffffu, tau, o));
      if (tid == 0) {
        s_tau = tau;
        s_np = 0;
      }
    }
    __syncthreads();
    {
      const float tau = s_tau;
      for (int c = tid; c < C; c += nt) {
        const float v = s_score[c];
        if (v >= tau) {
          const int p = atomicAdd(&s_np, 1);
          s_pscore[p] = v;
          s_pidx[p] = c;
        }
      }
    }
    __syncthreads();
    {
      const int np = s_np;
      for (int p = tid; p < np; p += nt) {
        const float v = s_pscore[p];
        const int c = s_pidx[p];
        int rank = 0;
#pragma unroll 4
        for (int q = 0; q < np; ++q)
          rank += beats(s_pscore[q], s_pidx[q], v, c);
        if (rank < K) {
          s_top[rank] = c;
          s_top_score[rank] = v;
        }
      }
    }
    __syncthreads();

    // ---- new state and backpointers (warp 0) ----
    if (tid < K) {
      const int idx = s_top[tid];
      const float ts = s_top_score[tid];
      const bool stay = idx < K;
      const int parent = stay ? idx : (idx - K) / M;
      const int sym = stay ? -1 : s_tsym[(idx - K) - parent * M];
      const uint32_t ph = s_h[parent];
      uint32_t nh = stay ? ph : ph * kHashM + (uint32_t)(sym + 1);
      int nlast = stay ? s_last[parent] : sym;
      int nlens = s_lens[parent] + (stay ? 0 : 1);
      float npb = stay ? s_stay_pb[parent] : kNeg;
      float npnb = stay ? s_stay_pnb[parent] : ts;
      if (ts <= kHalfNeg) {  // dead slots stay dead
        nh = 0u;
        nlast = -1;
        nlens = 0;
        npb = kNeg;
        npnb = kNeg;
      }
      const size_t o = ((size_t)t * B + b) * K + tid;
      parents[o] = parent;
      syms[o] = sym;
      __syncwarp(kmask);  // every slot has read the old state
      s_h[tid] = nh;
      s_last[tid] = nlast;
      s_lens[tid] = nlens;
      s_pb[tid] = npb;
      s_pnb[tid] = npnb;
      s_total[tid] = lae(npb, npnb);
      s_Erow[tid] = s_Ecol[tid] = 0u;
    }
    __pipeline_wait_prior(0);
    __syncthreads();
  }

  // ---- final slots; the backtrack of the best one (NB = 1) or of all ----
  if (tid < K) {
    const float v = s_total[tid];
    lens_out[b * K + tid] = s_lens[tid];
    scores_out[b * K + tid] = v;
    int rank = 0;
    for (int k = 0; k < K; ++k) rank += beats(s_total[k], k, v, tid);
    if (rank < NB) {
      nb_lens[b * NB + rank] = s_lens[tid];
      nll[b * NB + rank] = -v;
      int* row = lab + rank * Lmax;
      int n = s_lens[tid];
      if (v <= kHalfNeg) {  // a dead slot's path: count its emissions first
        n = 0;
        for (int t = flen - 1, slot = tid; t >= 0; --t) {
          const size_t o = ((size_t)t * B + b) * K + slot;
          n += syms[o] >= 0;
          slot = parents[o];
        }
      }
      for (int t = flen - 1, slot = tid; t >= 0 && n > 0; --t) {
        const size_t o = ((size_t)t * B + b) * K + slot;
        const int s = syms[o];
        if (s >= 0 && --n < Lmax) row[n] = s;
        slot = parents[o];
      }
    }
  }
}

}  // namespace
}  // namespace pgasr

extern "C" {

// Pointers as in the contract above; NB = 1 (best) or K (n-best). Returns
// 0, kErrBeamRange, or the launch's cudaError_t.
int pgasr_ctc_beam(const float* log_probs, const int* frame_lens, int* parents,
                   int* syms, int* lens, float* scores, int* labels,
                   int* nb_lens, float* nll, int B, int T, int A, int K, int M,
                   int Lmax, int blank, int NB, cudaStream_t stream) {
  using namespace pgasr;
  if (B < 1 || T < 1 || K < 1 || K > kMaxK || M < 2 || M > kMaxM || M > A
      || A > kMaxA || Lmax < 1 || Lmax > T || blank < 0 || blank >= A
      || (NB != 1 && NB != K))
    return kErrBeamRange;
  // one thread per candidate, and at least 256 for the K x K + A items of
  // the first phase
  const int C = K * (1 + M);
  const int threads = std::min(kMaxThreads, (std::max(C, 256) + 31) / 32 * 32);
  ctc_beam_kernel<<<B, threads, 0, stream>>>(log_probs, frame_lens, parents,
                                             syms, lens, scores, labels,
                                             nb_lens, nll, B, T, A, K, M, Lmax,
                                             blank, NB);
  return cudaGetLastError();
}

}  // extern "C"
