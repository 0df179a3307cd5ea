// Masked LSTM backward (reverse-time gradient) of one direction, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pg_asr_tpu/ops/pallas_lstm.py:_kernel_bwd (via
// _pallas_backward, the backward of the custom VJP of pallas_lstm_scan).
// Same contract and numerics:
//   xp    (B, T, 4H)  the forward's x@W + b, float32 or bfloat16, gates i,f,g,o
//   U     (H, 4H)     recurrent weights, same type as xp
//   mask  (B, T)      float32, > 0 at valid steps
//   hprev (T, B, H)   the forward's carry h before step t, xp's type
//   cprev (T, B, H)   the forward's carry c before step t, float32
//   gy    (B, T, H)   gradient of the forward's output, xp's type
//   dxp   (B, T, 4H)  out: dpre in xp's type
//   dU    (H, 4H)     out: sum over steps of hprev^T @ dpre_mx, in U's type
// It walks time in the opposite order of the forward (t = T-1 .. 0 for a
// forward scan, 0 .. T-1 for a reverse one) with float32 carries dh, dc and
// float32 dU sums. Each step recomputes the gates from xp_t + hprev_t @ U
// (float32 accumulation), then
//   dhn = m*(dh + gy); dct = m*dc + dhn*o*(1 - th^2)
//   dpre = [dct*g*i*(1-i), dct*cprev*f*(1-f), dct*i*(1-g^2), dhn*th*o*(1-o)]
//   dxp_t = dpre (xp's type); dpre_mx = dpre rounded to U's type
//   dU += hprev_t^T @ dpre_mx; dh = (1-m)*dh + dpre_mx @ U^T
//   dc = (1-m)*dc + dct*f
// Padded steps (m == 0) pass dh and dc through and contribute nothing.
// Only summation orders differ from the plain version: dh's sum over the
// 4H gate columns comes as per-block partial sums added in a fixed order,
// the gate recompute's sum over k is a tiled product's, and dU's sum over
// the (b, t) pairs comes as partial sums over ranges of them, added in a
// fixed order (both products on the tensor cores for bfloat16 inputs,
// whose float32 accumulation orders its own additions); the result is the
// same from run to run.
//
// What bounds it on this card: a chain of T dependent steps, each three
// small products ((B,H)x(H,4H), (B,4H)x(4H,H) and (H,B)x(B,4H), ~100 MFLOP
// at B=64, H=256), far too little per step to fill 132 SMs; the bytes and
// operations of the whole call are far below what the chain's latency
// costs. The first kernel (one cooperative grid of H/2 blocks) spent most
// of a step's ~10.6 us on its exchange: a grid barrier, and every block
// reading the whole previous (B, 4H) dpre_mx through L2 (32 MB a step).
//
// Design. Of a step's three products only one, dpre_mx @ U^T, lies on the
// chain from step to step: the gate recompute reads only the forward's
// residual hprev, and dU only hprev and dpre_mx, which is dxp (xp and U
// share the type). So the call runs three kernels on one stream:
//   the gates: G = hprev @ U for every (t, b), float32, one tiled product
//     over all steps before the walk (lstm_bwd_gemm on the CUDA cores for
//     float32 inputs, lstm_bwd_gemm_mma on the tensor cores for bfloat16:
//     bf16 products are exact, the sums float32);
//   lstm_bwd_kernel: the walk. Batch rows are independent in it, so the
//     batch is split over thread-block clusters that never wait on each
//     other, and the hidden units over the CS blocks of a cluster (CS = 8,
//     or 16 where U's slice would not fit; cudaLaunchKernelEx with a
//     cluster dimension, no cooperative launch, no grid barrier). Block q
//     owns units u0 .. u0 + NJ - 1 (ragged: NJ = H / CS or one more) and
//     keeps U's 4 NJ gate columns of them, H x 4 NJ, in shared memory as
//     float32, unit-major (column 4 jj + g is U[:, g H + u0 + jj]). Per
//     step, on the cluster's rows (at most 8): the cell backward, one
//     thread per (row, unit), from xp + G, carries dh, dc in its registers,
//     dpre_mx of the block's columns into shared memory; then a partial dh
//     for all H units, dpre_mx[:, own] @ U[:, own]^T, into the block's own
//     double-buffered shared memory (thread (k, half) sums half of the
//     block's columns); then one cluster barrier (barrier.cluster
//     arrive.release, and wait.acquire at the next step's start, so that
//     the step's dxp stores and the next step's loads overlap it). Each
//     block then sums its own units' slices of the 2 CS partials through
//     distributed shared memory (cluster.map_shared_rank), in rank order:
//     2 x rows x NJ floats a block reads per step, in place of the first
//     kernel's 4H x B through L2. The rows per cluster are chosen at launch
//     from cudaOccupancyMaxActiveClusters (plan_clusters, common.cuh), so
//     that all clusters are resident at once where 8 rows allow; a larger
//     batch runs in waves of clusters, which is correct since clusters are
//     independent;
//   dU: hprev^T @ dxp over all (t, b), float32, the same two kernels,
//     split over ranges of the pairs into partials that lstm_bwd_reduce
//     adds in order.
// Above H = 512 (up to kMaxH = 1024, clusters of 16) U's own columns do
// not fit a block's shared memory: the block writes them transposed into
// the scratch (UT, 4H x H float32) before the walk and the partial dh
// reads them from L2, coalesced over the threads' units, two units a
// thread where H is above the block's 512 threads.
// (Recomputing the gates inside the walk, even on half the block beside
// the partial dh, and summing dU there, R deep per step, kept the call at
// 3.6 ms: both products are issue-bound at 8 rows per block; see PERF.md.)

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pgasr;

constexpr int kLoads = 16;         // remote partial-dh loads issued together

// partial-dh halves of a block: 2 where two threads per unit fit
__host__ __device__ inline int dh_parts(int H) {
  return 2 * H <= kThreads ? 2 : 1;
}

// shared memory of a block, in floats: U's own columns (H x LDU; LDU / 4
// odd, so that lanes reading 16 bytes of different rows do not conflict;
// none where the walk reads them from L2), dpre_mx of the own columns
// (kRows x 4 NJmax), two buffers of the partial dh halves (parts x kRows x
// H)
struct Smem {
  int ldu, nj4;
  size_t dps, pdh, total;
  __host__ __device__ Smem(int H, int njmax, bool u_l2)
      : ldu(4 * (njmax | 1)), nj4(4 * njmax),
        dps(u_l2 ? 0 : (size_t)H * ldu), pdh(dps + (size_t)kRows * nj4),
        total(pdh + (size_t)2 * dh_parts(H) * kRows * H) {}
};

// kUL2: U's own columns do not fit the block's shared memory (H above
// 512 and beyond): the block writes them transposed, UT[g H + u0 + jj][k]
// = U[k][g H + u0 + jj], into the float32 scratch `ut` (4H x H) before the
// walk, and each step's partial dh reads them from L2, coalesced over the
// threads' units k.
template <typename T, bool kUL2>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const T* __restrict__ xp, const T* __restrict__ U,
                const float* __restrict__ mask,
                const float* __restrict__ cprev, const T* __restrict__ gy,
                const float* __restrict__ G, T* __restrict__ dxp,
                float* __restrict__ ut, int B, int T_len, int H, int reverse,
                int CS, int rows) {
  const int H4 = 4 * H;
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterShare P(H, B, CS, rows, (int)cluster.block_rank());
  const int njmax = P.njmax, nj = P.nj, u0 = P.u0, b0 = P.b0;
  const int nrows = P.nrows;  // rows of this cluster, >= 1
  const int parts = dh_parts(H);
  const Smem L(H, njmax, kUL2);
  extern __shared__ float4 smem_raw[];
  float* us = reinterpret_cast<float*>(smem_raw);
  float* dps = us + L.dps;
  float* pdh = us + L.pdh;
  const int tid = threadIdx.x;

  if constexpr (kUL2) {
    for (int i = tid; i < 4 * nj * H; i += kThreads) {
      const int c = i / H, k = i - c * H;  // c = g nj + jj
      const int g = c / nj, jj = c - g * nj;
      ut[((size_t)g * H + u0 + jj) * H + k] =
          to_f32<T>(U[(size_t)k * H4 + (size_t)g * H + u0 + jj]);
    }
  } else {
    for (int i = tid; i < H * L.ldu; i += kThreads) {
      const int k = i / L.ldu, c = i - k * L.ldu;
      const int jj = c >> 2, g = c & 3;
      us[i] = jj < nj
                  ? to_f32<T>(U[(size_t)k * H4 + (size_t)g * H + u0 + jj])
                  : 0.0f;
    }
  }
  for (int i = tid; i < kRows * L.nj4; i += kThreads) dps[i] = 0.0f;

  // the cell thread (row cr, unit cj) and its float32 carries
  const int cr = tid / njmax, cj = tid - cr * njmax;
  const bool cell = cr < nrows && cj < nj;
  const int cb = b0 + cr, cu = u0 + cj;
  float dh = 0.0f, dc = 0.0f;

  // the partial-dh items of this thread: (unit ck, half cp) = (e % H, e /
  // H) for e = tid (and tid + kThreads where H is above kThreads)
  constexpr int kItems = kUL2 ? 2 : 1;
  int ck[kItems], cp[kItems], cj_lo[kItems], cj_hi[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = tid + i * kThreads;
    ck[i] = e % H;
    cp[i] = e / H;  // parts or more: no item
    cj_lo[i] = cp[i] * nj / parts;
    cj_hi[i] = (cp[i] + 1) * nj / parts;
  }

  if constexpr (kUL2) __syncthreads();  // this block's UT rows written
  cluster.sync();  // every block of the cluster runs before any remote read

  for (int s = 0; s < T_len; ++s) {
    const int t = reverse ? s : T_len - 1 - s;
    float x[4] = {0.f, 0.f, 0.f, 0.f}, m = 0.f, m_prev = 0.f, c_old = 0.f,
          g_y = 0.f;
    const size_t bt = (size_t)cb * T_len + t;
    if (cell) {  // independent of the exchange: issue before the barrier
      const T* xrow = xp + bt * H4 + cu;
      const float* grow = G + ((size_t)t * B + cb) * H4 + cu;
#pragma unroll
      for (int g = 0; g < 4; ++g) x[g] = to_f32<T>(xrow[g * H]) + grow[g * H];
      m = mask[bt];
      if (s > 0) m_prev = mask[(size_t)cb * T_len + (reverse ? t - 1 : t + 1)];
      c_old = cprev[(size_t)t * B * H + (size_t)cb * H + cu];
      g_y = to_f32<T>(gy[bt * H + cu]);
    }
    if (s > 0) cluster_wait();  // step s-1's partial dh of every block

    T dv[4];
    if (cell) {
      if (s > 0) {  // dh <- (1 - m_prev) dh + sum of the partials, rank order
        const float* part =
            pdh + (size_t)((s - 1) & 1) * parts * kRows * H + cr * H + cu;
        const int n = CS * parts;  // partial i: rank i / parts, half i % parts
        float sum = 0.0f;
        for (int i0 = 0; i0 < n; i0 += kLoads) {  // kLoads loads in flight
          float v[kLoads];
#pragma unroll
          for (int i = 0; i < kLoads; ++i)
            v[i] = i0 + i < n
                       ? *cluster.map_shared_rank(
                             part + ((i0 + i) % parts) * kRows * H,
                             (unsigned)((i0 + i) / parts))
                       : 0.0f;
#pragma unroll
          for (int i = 0; i < kLoads; ++i) sum += v[i];
        }
        dh = (1.0f - m_prev) * dh + sum;
      }
      const float ig = sigmoid(x[0]);
      const float fg = sigmoid(x[1]);
      const float gg = tanhf(x[2]);
      const float og = sigmoid(x[3]);
      const float c_new = fg * c_old + ig * gg;
      const float th = tanhf(c_new);
      const float dhn = m * (dh + g_y);
      const float dct = m * dc + dhn * og * (1.0f - th * th);
      const float d4[4] = {dct * gg * ig * (1.0f - ig),
                           dct * c_old * fg * (1.0f - fg),
                           dct * ig * (1.0f - gg * gg),
                           dhn * th * og * (1.0f - og)};
      float* dp = dps + cr * L.nj4 + 4 * cj;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dv[g] = from_f32<T>(d4[g]);  // xp and U share the type
        dp[g] = to_f32<T>(dv[g]);
      }
      dc = (1.0f - m) * dc + dct * fg;
    }
    __syncthreads();  // dpre_mx of the block's columns

    // partial dh of unit ck over half cp of the block's columns, for the
    // cluster's rows: dpre_mx[r, cols] . U[ck, cols]
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (cp[i] >= parts) continue;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int jj = cj_lo[i]; jj < cj_hi[i]; ++jj) {
        float4 u;
        if constexpr (kUL2) {
          const float* uc = ut + (size_t)(u0 + jj) * H + ck[i];
          u = make_float4(uc[0], uc[(size_t)H * H], uc[(size_t)2 * H * H],
                          uc[(size_t)3 * H * H]);
        } else {
          u = *reinterpret_cast<const float4*>(us + ck[i] * L.ldu + 4 * jj);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < nrows) {
            const float4 d =
                *reinterpret_cast<const float4*>(dps + r * L.nj4 + 4 * jj);
            acc[r] = fmaf(d.x, u.x, acc[r]);
            acc[r] = fmaf(d.y, u.y, acc[r]);
            acc[r] = fmaf(d.z, u.z, acc[r]);
            acc[r] = fmaf(d.w, u.w, acc[r]);
          }
        }
      }
      float* out = pdh + (size_t)(s & 1) * parts * kRows * H
                   + (size_t)cp[i] * kRows * H + ck[i];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nrows) out[r * H] = acc[r];
    }
    cluster_arrive();  // this step's partial dh is complete

    if (cell) {  // after the arrive: its release need not wait for these
      T* dx = dxp + bt * H4 + cu;
#pragma unroll
      for (int g = 0; g < 4; ++g) dx[g * H] = dv[g];
    }
  }
  cluster_wait();  // no block leaves while another may read its partials
}

// The two products off the walk's chain, float32: out[m][n] = sum over k
// of A(k, m) B(k, n), in order of k, over the split blockIdx.z's range of
// k; 128 x 128 tiles, 16 x 16 threads with 8 x 8 outputs each (rows 4 ty
// .. and 64 + 4 ty .., columns likewise from tx: conflict-free 16-byte
// reads of shared memory), 8-deep slices of k double-buffered in shared
// memory, the next slice's loads in flight while one is computed.
//   kGates: G = hprev @ U: m = t B + b (hprev's rows), k a hidden unit, n
//           a gate column; A(k, m) = hprev[m][k], B(k, n) = U[k][n].
//   kDU:    dU partials: m a hidden unit, k = t B + b, n a gate column;
//           A(k, m) = hprev[k][m], B(k, n) = dxp[b][t][n].
enum { kGates, kDU };
constexpr int kTile = 128, kTileK = 8, kLdTile = kTile + 4;

template <typename T, int kMode>
__global__ void __launch_bounds__(256, 2)
lstm_bwd_gemm(const T* __restrict__ hprev, const T* __restrict__ other,
              int B, int T_len, int M, int N, int K, int k_per_split,
              float* __restrict__ out) {
  __shared__ __align__(16) float As[2][kTileK * kLdTile];  // [kk][m]
  __shared__ __align__(16) float Bs[2][kTileK * kLdTile];  // [kk][n]
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int k_lo = blockIdx.z * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // this thread's 4 elements of each slice: A (kk, c) and B (kk, c)
  float ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + 256 * i;
      int kk, c;
      if constexpr (kMode == kGates) {  // along hprev's rows: k fastest
        kk = e % kTileK;
        c = e / kTileK;
      } else {
        kk = e / kTile;
        c = e % kTile;
      }
      const int k = k0 + kk, m = m0 + c;
      float a = 0.0f;
      if (k < k_hi && m < M)
        a = to_f32<T>(kMode == kGates ? hprev[(size_t)m * K + k]
                                      : hprev[(size_t)k * M + m]);
      ra[i] = a;
      const int kb = k0 + e / kTile, n = n0 + e % kTile;
      float b = 0.0f;
      if (kb < k_hi && n < N) {
        if constexpr (kMode == kGates) {
          b = to_f32<T>(other[(size_t)kb * N + n]);
        } else {
          const int t = kb / B, bb = kb - t * B;
          b = to_f32<T>(other[((size_t)bb * T_len + t) * N + n]);
        }
      }
      rb[i] = b;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + 256 * i;
      if constexpr (kMode == kGates)
        As[buf][(e % kTileK) * kLdTile + e / kTileK] = ra[i];
      else
        As[buf][(e / kTile) * kLdTile + e % kTile] = ra[i];
      Bs[buf][(e / kTile) * kLdTile + e % kTile] = rb[i];
    }
  };
  float acc[8][8] = {};
  fetch(k_lo);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += kTileK) {
    const bool more = k0 + kTileK < k_hi;
    if (more) fetch(k0 + kTileK);
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float* ap = As[buf] + kk * kLdTile + 4 * ty;
      const float* bp = Bs[buf] + kk * kLdTile + 4 * tx;
      const float4 a0 = *reinterpret_cast<const float4*>(ap);
      const float4 a1 = *reinterpret_cast<const float4*>(ap + kTile / 2);
      const float4 b0 = *reinterpret_cast<const float4*>(bp);
      const float4 b1 = *reinterpret_cast<const float4*>(bp + kTile / 2);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      store(buf ^ 1);  // the other buffer was consumed before the last sync
      __syncthreads();
      buf ^= 1;
    }
  }
  float* o = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 4 * ty + (i & 3) + (i >> 2) * kTile / 2;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 4 * tx + (j & 3) + (j >> 2) * kTile / 2;
      if (n < N) o[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// The same two products for bfloat16 inputs on the tensor cores: mma.sync
// m16n8k16 (bf16 operands, exact products, float32 accumulators), 128 x
// 128 tiles, 8 warps of 64 x 32 outputs each, 32-deep slices of k held in
// shared memory as bf16 (double-buffered, rows padded by 8 elements so
// that ldmatrix is free of bank conflicts), the next slice's loads in
// flight while one is computed; 16-byte loads where the rows allow
// (inner sizes multiples of 8), else element by element.
constexpr int kMmaK = 32, kLdA = kMmaK + 8, kLdT = kTile + 8;

template <int kMode>
__global__ void __launch_bounds__(256)
lstm_bwd_gemm_mma(const __nv_bfloat16* __restrict__ hprev,
                  const __nv_bfloat16* __restrict__ other, int B, int T_len,
                  int M, int N, int K, int k_per_split,
                  float* __restrict__ out) {
  using bf16 = __nv_bfloat16;
  // A as [m][k] (kGates) or [k][m] (kDU); B as [k][n]
  constexpr int kASize = kMode == kGates ? kTile * kLdA : kMmaK * kLdT;
  __shared__ __align__(16) bf16 As[2][kASize];
  __shared__ __align__(16) bf16 Bs[2][kMmaK * kLdT];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int k_lo = blockIdx.z * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = 64 * (warp >> 2), wn = 32 * (warp & 3);
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  // A's inner size (K for kGates, M for kDU) and B's (N): 16-byte rows?
  const bool vec_a = (kMode == kGates ? K : M) % 8 == 0, vec_b = N % 8 == 0;

  // a slice's elements of this thread: vectors v = threadIdx.x + 256 i of
  // 8 consecutive elements along the inner dimension
  uint4 ra[2], rb[2];
  auto load8 = [&](const bf16* src, bool vec, bool in, int valid) {
    // 8 elements from src, of which the first `valid` exist
    if (in && vec && valid >= 8) return *reinterpret_cast<const uint4*>(src);
    __align__(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = in && j < valid ? src[j] : __float2bfloat16_rn(0.0f);
    return *reinterpret_cast<const uint4*>(v);
  };
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = threadIdx.x + 256 * i;
      if constexpr (kMode == kGates) {  // A rows m, 4 vectors of k each
        const int r = v >> 2, kc = 8 * (v & 3);
        const int m = m0 + r, k = k0 + kc;
        ra[i] = load8(hprev + (size_t)m * K + k, vec_a, m < M && k < k_hi,
                      k_hi - k);
      } else {  // A rows k, 16 vectors of m each
        const int r = v >> 4, mc = 8 * (v & 15);
        const int k = k0 + r, m = m0 + mc;
        ra[i] = load8(hprev + (size_t)k * M + m, vec_a, k < k_hi && m < M,
                      M - m);
      }
      const int r = v >> 4, nc = 8 * (v & 15);
      const int k = k0 + r, n = n0 + nc;
      const bf16* src;
      if constexpr (kMode == kGates) {
        src = other + (size_t)k * N + n;
      } else {
        const int t = k / B, bb = k - t * B;
        src = other + ((size_t)bb * T_len + t) * N + n;
      }
      rb[i] = load8(src, vec_b, k < k_hi && n < N, N - n);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = threadIdx.x + 256 * i;
      if constexpr (kMode == kGates)
        *reinterpret_cast<uint4*>(As[buf] + (v >> 2) * kLdA + 8 * (v & 3)) =
            ra[i];
      else
        *reinterpret_cast<uint4*>(As[buf] + (v >> 4) * kLdT + 8 * (v & 15)) =
            ra[i];
      *reinterpret_cast<uint4*>(Bs[buf] + (v >> 4) * kLdT + 8 * (v & 15)) =
          rb[i];
    }
  };
  // ldmatrix lane offsets: A from [m][k] (rows m), A from [k][m] read
  // transposed, B from [k][n] read transposed
  const int a_row = lane & 15, a_col = 8 * (lane >> 4);
  const int at_k = (lane & 7) + 8 * (lane >> 4), at_m = 8 * ((lane >> 3) & 1);
  const int b_k = (lane & 7) + 8 * ((lane >> 3) & 1), b_n = 8 * (lane >> 4);

  float acc[4][4][4] = {};  // [m16 tile][n8 tile][fragment]
  fetch(k_lo);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += kMmaK) {
    const bool more = k0 + kMmaK < k_hi;
    if (more) fetch(k0 + kMmaK);
#pragma unroll
    for (int kk = 0; kk < kMmaK; kk += 16) {
      unsigned a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kMode == kGates)
          ldsm_x4(a[i], As[buf] + (wm + 16 * i + a_row) * kLdA + kk + a_col);
        else
          ldsm_x4_trans(a[i],
                        As[buf] + (kk + at_k) * kLdT + wm + 16 * i + at_m);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4_trans(b[j], Bs[buf] + (kk + b_k) * kLdT + wn + 16 * j + b_n);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16_16816(acc[i][j], a[i], b[j >> 1][2 * (j & 1)],
                         b[j >> 1][2 * (j & 1) + 1]);
    }
    if (more) {
      store(buf ^ 1);  // the other buffer was consumed before the last sync
      __syncthreads();
      buf ^= 1;
    }
  }
  float* o = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + c2;
        if (n < N) o[(size_t)m * N + n] = acc[i][j][2 * h];
        if (n + 1 < N) o[(size_t)m * N + n + 1] = acc[i][j][2 * h + 1];
      }
    }
}

// dU = the splits' partials summed in split order, in U's type
template <typename T>
__global__ void lstm_bwd_reduce(const float* __restrict__ part, int n,
                                size_t count, T* __restrict__ dU) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.0f;
    for (int c = 0; c < n; ++c) sum += part[c * count + e];
    dU[e] = from_f32<T>(sum);
  }
}

// splits of the dU product's K = B T: about 4 blocks per SM in all, each
// split at least 1024 pairs long
int du_splits(int B, int T_len, int H) {
  const int tiles = ((H + kTile - 1) / kTile) * ((4 * H + kTile - 1) / kTile);
  return max(1, min(512 / tiles, (B * T_len) / 1024));
}

size_t smem_bytes(int H, int cs, bool u_l2) {
  return Smem(H, (H + cs - 1) / cs, u_l2).total * sizeof(float);
}

// The walk's plan (plan_clusters): clusters of 8 blocks, or 16 where U's
// slice does not fit at 8, a thread per (row, unit) of a block.
template <typename T, bool kUL2>
int plan(int B, int H, ClusterPlan* p) {
  return plan_clusters(lstm_bwd_kernel<T, kUL2>, B, H, true,
                       [H](int cs, int* threads, size_t* smem) {
                         *threads = kThreads;
                         *smem = smem_bytes(H, cs, kUL2);
                         return (H + cs - 1) / cs * kRows <= kThreads;
                       }, p);
}

// whether the walk of type T reads U from L2: no cluster of the
// shared-memory form fits (1), or it does (0), or an error
template <typename T>
int u_from_l2(int B, int H) {
  ClusterPlan p;
  const int rc = plan<T, false>(B, H, &p);
  return rc == kErrNoCluster ? 1 : rc;
}

// float32 scratch of a call: G (T B x 4H), then the dU partials, then (the
// walk reading U from L2) UT (4H x H)
size_t scratch_floats(int B, int T_len, int H, bool u_l2) {
  return ((size_t)T_len * B + (size_t)du_splits(B, T_len, H) * H
          + (u_l2 ? (size_t)H : 0)) * 4 * H;
}

template <typename T>
int dispatch(const void* xp_v, const void* U_v, const float* mask,
             const void* hprev_v, const float* cprev, const void* gy_v,
             void* dxp_v, void* dU_v, float* scratch, size_t n_scratch,
             int B, int T_len, int H, int reverse, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(xp_v);
  const T* U = static_cast<const T*>(U_v);
  const T* hprev = static_cast<const T*>(hprev_v);
  const T* gy = static_cast<const T*>(gy_v);
  T* dxp = static_cast<T*>(dxp_v);
  const int l2 = u_from_l2<T>(B, H);
  if (l2 < 0 || l2 > 1) return l2;
  ClusterPlan p;
  int rc = l2 ? plan<T, true>(B, H, &p) : plan<T, false>(B, H, &p);
  if (rc != 0) return rc;
  if (scratch_floats(B, T_len, H, l2) > n_scratch)
    return cudaErrorInvalidValue;
  const int H4 = 4 * H, BT = B * T_len;
  const int splits = du_splits(B, T_len, H);
  float* G = scratch;
  float* part = scratch + (size_t)BT * H4;
  float* ut = part + (size_t)splits * H * H4;
  const dim3 g_grid((H4 + kTile - 1) / kTile, (BT + kTile - 1) / kTile);
  if constexpr (std::is_same_v<T, float>)
    lstm_bwd_gemm<T, kGates><<<g_grid, 256, 0, stream>>>(hprev, U, B, T_len,
                                                         BT, H4, H, H, G);
  else
    lstm_bwd_gemm_mma<kGates><<<g_grid, 256, 0, stream>>>(hprev, U, B, T_len,
                                                          BT, H4, H, H, G);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(&attr, p, stream);
  if (l2)
    e = cudaLaunchKernelEx(&cfg, lstm_bwd_kernel<T, true>, xp, U, mask,
                           cprev, gy, static_cast<const float*>(G), dxp, ut,
                           B, T_len, H, reverse, p.cs, p.rows);
  else
    e = cudaLaunchKernelEx(&cfg, lstm_bwd_kernel<T, false>, xp, U, mask,
                           cprev, gy, static_cast<const float*>(G), dxp, ut,
                           B, T_len, H, reverse, p.cs, p.rows);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 d_grid((H4 + kTile - 1) / kTile, (H + kTile - 1) / kTile,
                    splits);
  const int per = (BT + splits - 1) / splits;
  if constexpr (std::is_same_v<T, float>)
    lstm_bwd_gemm<T, kDU><<<d_grid, 256, 0, stream>>>(hprev, dxp, B, T_len, H,
                                                      H4, BT, per, part);
  else
    lstm_bwd_gemm_mma<kDU><<<d_grid, 256, 0, stream>>>(hprev, dxp, B, T_len,
                                                       H, H4, BT, per, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t count = (size_t)H * H4;
  lstm_bwd_reduce<T><<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
      part, splits, count, static_cast<T*>(dU_v));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// *floats = the float32 scratch a launch of lstm_bwd at (B, T, H) needs
// (in either type). Returns 0, kErrUnsupportedH or a cudaError_t.
int pgasr_lstm_bwd_scratch(int B, int T_len, int H, long long* floats) {
  *floats = 0;
  if (H < 1 || H > kMaxH) return kErrUnsupportedH;
  const int f = u_from_l2<float>(B, H), h = u_from_l2<__nv_bfloat16>(B, H);
  if (f < 0 || f > 1) return f;
  if (h < 0 || h > 1) return h;
  *floats = (long long)scratch_floats(B, T_len, H, f || h);
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (xp, U, hprev, gy, dxp and dU share
// it). scratch: n_scratch float32, at least pgasr_lstm_bwd_scratch's.
// Returns 0, a cudaError_t value, or one of the negative codes of
// common.cuh or kErrNoCluster.
int pgasr_lstm_bwd(const void* xp, const void* U, const void* mask,
                   const void* hprev, const void* cprev, const void* gy,
                   void* dxp, void* dU, void* scratch, long long n_scratch,
                   int B, int T_len, int H, int reverse, int dtype,
                   void* stream) {
  const float* m = static_cast<const float*>(mask);
  const float* cp = static_cast<const float*>(cprev);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(xp, U, m, hprev, cp, gy, dxp, dU, sc,
                           (size_t)n_scratch, B, T_len, H, reverse, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(xp, U, m, hprev, cp, gy, dxp, dU, sc,
                                   (size_t)n_scratch, B, T_len, H, reverse,
                                   s);
  return kErrDtype;
}

}  // extern "C"
