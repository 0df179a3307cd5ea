// Masked LSTM backward (reverse-time gradient), one direction (lstm_bwd)
// or the two of a bidirectional layer in one call (bilstm_bwd), for Hopper
// (sm_90a).
//
// Replaces the TPU kernels pg_asr_tpu/ops/pallas_lstm.py:_kernel_bwd (via
// _pallas_backward, the backward of the custom VJP of pallas_lstm_scan)
// and _kernel_bi_bwd (via _pallas_bi_backward, pallas_bilstm_scan's).
// Contract and numerics of one direction:
//   xp    (B, T, 4H)  the forward's x@W + b, float32 or bfloat16, gates i,f,g,o
//   U     (H, 4H)     recurrent weights, same type as xp
//   mask  (B, T)      float32, > 0 at valid steps
//   hprev (T, B, H)   the forward's carry h before step t, xp's type
//   cprev (T, B, H)   the forward's carry c before step t, float32
//   gy    (B, T, H)   gradient of the forward's output, xp's type
//   dxp   (B, T, 4H)  out: dpre in xp's type
//   dU    (H, 4H)     out: sum over steps of hprev^T @ dpre_mx, in U's type
// bilstm_bwd takes both directions' xp, U, residuals, one mask and gy (B,
// T, 2H), the gradient of concat(forward, backward), read in place.
// A direction walks time in the opposite order of its forward (t = T-1 ..
// 0 for a forward scan, 0 .. T-1 for a reverse one) with float32 carries
// dh, dc and float32 dU sums. Each step recomputes the gates from xp_t +
// hprev_t @ U (float32 accumulation), then
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
// same from run to run, no sum is taken with atomics, and each direction
// of bilstm_bwd equals lstm_bwd's bits (the same tilings, splits and
// cluster size; only the rows a cluster carries differ).
//
// What bounds it on this card: a chain of T dependent steps, each three
// small products ((B,H)x(H,4H), (B,4H)x(4H,H) and (H,B)x(B,4H), ~100 MFLOP
// at B=64, H=256), far too little per step to fill 132 SMs; the bytes and
// operations of the whole call are far below what the chain's latency
// costs. The first kernel (one cooperative grid of H/2 blocks) spent most
// of a step's ~10.6 us on its exchange: a grid barrier, and every block
// reading the whole previous (B, 4H) dpre_mx through L2 (32 MB a step);
// the first fused-direction kernel, the same design over both, ~15.6 us.
//
// Design. Of a step's three products only one, dpre_mx @ U^T, lies on the
// chain from step to step: the gate recompute reads only the forward's
// residual hprev, and dU only hprev and dpre_mx, which is dxp (xp and U
// share the type). So a call is three launches on one stream, each
// carrying every direction of the call (a grid dimension or a cluster's
// index picks it):
//   the gates: G = hprev @ U for every (t, b), float32, one tiled product
//     over all steps before the walk (lstm_bwd_gemm on the CUDA cores for
//     float32 inputs, lstm_bwd_gemm_mma on the tensor cores for bfloat16:
//     bf16 products are exact, the sums float32);
//   lstm_bwd_kernel: the walk. Batch rows and directions are independent
//     in it, so (row, direction) pairs are split over thread-block clusters
//     that never wait on each other (clusters 0 .. cpd - 1 the first
//     direction, the rest the second), and the hidden units over the CS
//     blocks of a cluster (CS = 8, or 16 where U's slice would not fit;
//     cudaLaunchKernelEx with a cluster dimension, no cooperative launch,
//     no grid barrier). Block q owns units u0 .. u0 + NJ - 1 (ragged: NJ =
//     H / CS or one more) and keeps U's 4 NJ gate columns of them, H x 4
//     NJ, in shared memory as float32, unit-major (column 4 jj + g is U[:,
//     g H + u0 + jj]). Per step, on the cluster's rows (at most 16): the
//     cell backward, one thread per (row, unit), from xp + G, carries dh,
//     dc in its registers, dpre_mx of the block's columns into shared
//     memory; then a partial dh for all H units, dpre_mx[:, own] @ U[:,
//     own]^T, into the block's own double-buffered shared memory (thread
//     (k, half) sums half of the block's columns); then one cluster barrier
//     (barrier.cluster arrive.release, and wait.acquire at the next step's
//     start, so that the step's dxp stores and the next step's loads
//     overlap it). Each block then sums its own units' slices of the 2 CS
//     partials through distributed shared memory (cluster.map_shared_rank),
//     in rank order: 2 x rows x NJ floats a block reads per step, in place
//     of the first kernel's 4H x B through L2. The rows per cluster are
//     chosen at launch from cudaOccupancyMaxActiveClusters (plan_clusters,
//     common.cuh), so that all clusters of all directions are resident at
//     once (15 clusters of 8 on the H100: one direction at B = 64 takes 13
//     clusters of 5 rows, two 14 of 10); a larger batch runs in waves of
//     clusters, which is correct since clusters are independent;
//   dU: hprev^T @ dxp over all (t, b), float32, the same two kernels,
//     split over ranges of the pairs into partials; the block that
//     finishes a tile last (a ticket per tile, counted with atomicAdd and
//     zeroed by the gates launch; the ticket only picks the block) adds the
//     tile's partials in split order and writes dU.
// Above H = 512 U's own columns do not fit a block's shared memory: the
// block writes them transposed into the scratch (UT, 4H x H float32)
// before the walk and the partial dh reads them from L2 (HBM past 50 MB),
// coalesced over the threads' units, a thread looping over units where H
// is above the block's 512 threads; rows per cluster shrink so that a
// thread per (row, unit) remains (H up to 8,192 at one row). Past that
// (lstm_bwd_big) a cluster walks one row, a thread loops over its block's
// units (their carries in shared memory), and the partial dh cross blocks
// through global memory under the same cluster barrier: any H the device
// memory holds.
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
constexpr int kBwdRows = 16;       // rows a cluster of the walk takes at most

// One direction of a call (lstm_bwd one, bilstm_bwd the two of a layer).
template <typename T>
struct BwdDir {
  const T* xp;           // (B, T, 4H)
  const T* U;            // (H, 4H)
  const T* hprev;        // (T, B, H)
  const float* cprev;    // (T, B, H)
  const T* gy;           // its unit 0 in (B, T, gy_ld)
  T* dxp;                // (B, T, 4H)
  T* dU;                 // (H, 4H)
  float* G;              // scratch: T B x 4H gate pre-activations h @ U
  float* part;           // scratch: the dU splits' partials
  float* ut;             // scratch: U transposed (4H x H), U read from L2
  int reverse;           // the forward's: the walk runs the other way
};

template <typename T>
struct BwdArgs {
  BwdDir<T> d[2];
  const float* mask;     // (B, T)
  unsigned* tickets;     // per (direction, dU tile), zeroed by the gates
  float* pg;             // lstm_bwd_big: two buffers of CS partials of H
                         // a cluster
  int n_tickets, gy_ld, B, T_len, H, CS, rows, cpd;
};

// partial-dh halves of a block: 2 where two threads per unit fit
__host__ __device__ inline int dh_parts(int H) {
  return 2 * H <= kThreads ? 2 : 1;
}

// shared memory of a block, in floats: U's own columns (H x LDU; LDU / 4
// odd, so that lanes reading 16 bytes of different rows do not conflict;
// none where the walk reads them from L2), dpre_mx of the own columns
// (rows x 4 NJmax), two buffers of the partial dh halves (parts x rows x
// H); rows: the buffers' row stride
struct Smem {
  int ldu, nj4;
  size_t dps, pdh, total;
  __host__ __device__ Smem(int H, int njmax, int rows, bool u_l2)
      : ldu(4 * (njmax | 1)), nj4(4 * njmax),
        dps(u_l2 ? 0 : (size_t)H * ldu), pdh(dps + (size_t)rows * nj4),
        total(pdh + (size_t)2 * dh_parts(H) * rows * H) {}
};

// kR: the most rows of a cluster (8 or 16; the registers of a partial-dh
// item). kBi: a launch of two directions. kUL2: U's own columns do not fit
// the block's shared memory (H
// above 512 and beyond): the block writes them transposed, UT[g H + u0 +
// jj][k] = U[k][g H + u0 + jj], into the float32 scratch `ut` (4H x H)
// before the walk, and each step's partial dh reads them from L2,
// coalesced over the threads' units k.
template <typename T, int kR, bool kUL2, bool kBi>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const BwdArgs<T> a) {
  const int B = a.B, T_len = a.T_len, H = a.H, CS = a.CS, rows = a.rows;
  const int H4 = 4 * H;
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterShare P(H, B, CS, rows, a.cpd, (int)cluster.block_rank());
  const int njmax = P.njmax, nj = P.nj, u0 = P.u0, b0 = P.b0;
  const int nrows = P.nrows;  // rows of this cluster, >= 1
  // kBi false (one direction): a.d[0]'s pointers, which the compiler
  // reads from the parameters where used rather than holding them
  const int dir = kBi ? P.dir : 0;
  const T* __restrict__ xp = dir ? a.d[1].xp : a.d[0].xp;
  const T* __restrict__ U = dir ? a.d[1].U : a.d[0].U;
  const float* __restrict__ cprev = dir ? a.d[1].cprev : a.d[0].cprev;
  const T* __restrict__ gy = dir ? a.d[1].gy : a.d[0].gy;
  const float* __restrict__ G = dir ? a.d[1].G : a.d[0].G;
  T* __restrict__ dxp = dir ? a.d[1].dxp : a.d[0].dxp;
  float* __restrict__ ut = dir ? a.d[1].ut : a.d[0].ut;
  const int reverse = dir ? a.d[1].reverse : a.d[0].reverse;
  const float* __restrict__ mask = a.mask;
  const int parts = dh_parts(H);
  // rows of the buffers: kR with U in shared memory (a constant stride), the
  // plan's rows where U comes from L2 (H up to 8,192 at one row)
  const int ldr = kUL2 ? rows : kR;
  const Smem L(H, njmax, ldr, kUL2);
  extern __shared__ float4 smem_raw[];
  float* us = reinterpret_cast<float*>(smem_raw);
  float* dps = us + L.dps;
  float* pdh = us + L.pdh;
  const int tid = threadIdx.x;
  const size_t pbuf = (size_t)parts * ldr * H;  // a buffer of partials

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
  for (int i = tid; i < ldr * L.nj4; i += kThreads) dps[i] = 0.0f;

  // the cell thread (row cr, unit cj) and its float32 carries
  const int cr = tid / njmax, cj = tid - cr * njmax;
  const bool cell = cr < nrows && cj < nj;
  const int cb = b0 + cr, cu = u0 + cj;
  float dh = 0.0f, dc = 0.0f;

  // the partial-dh item of this thread where U is in shared memory: unit
  // ck0 of half cp0 (none where cp0 >= parts); reading U from L2 a thread
  // takes items e = tid, tid + kThreads, .. of parts x H
  const int ck0 = tid % H, cp0 = tid / H;
  const int lo0 = cp0 * nj / parts, hi0 = (cp0 + 1) * nj / parts;

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
      g_y = to_f32<T>(gy[bt * a.gy_ld + cu]);
    }
    if (s > 0) cluster_wait();  // step s-1's partial dh of every block

    T dv[4];
    if (cell) {
      if (s > 0) {  // dh <- (1 - m_prev) dh + sum of the partials, rank order
        const float* part = pdh + (size_t)((s - 1) & 1) * pbuf + cr * H + cu;
        const int n = CS * parts;  // partial i: rank i / parts, half i % parts
        float sum = 0.0f;
        for (int i0 = 0; i0 < n; i0 += kLoads) {  // kLoads loads in flight
          float v[kLoads];
#pragma unroll
          for (int i = 0; i < kLoads; ++i)
            v[i] = i0 + i < n
                       ? *cluster.map_shared_rank(
                             part + ((i0 + i) % parts) * ldr * H,
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
    auto partial = [&](int ck, int cp, int jlo, int jhi) {
      float acc[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int jj = jlo; jj < jhi; ++jj) {
        float4 u;
        if constexpr (kUL2) {
          const float* uc = ut + (size_t)(u0 + jj) * H + ck;
          u = make_float4(uc[0], uc[(size_t)H * H], uc[(size_t)2 * H * H],
                          uc[(size_t)3 * H * H]);
        } else {
          u = *reinterpret_cast<const float4*>(us + ck * L.ldu + 4 * jj);
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
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
      float* out = pdh + (size_t)(s & 1) * pbuf + (size_t)cp * ldr * H + ck;
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (r < nrows) out[r * H] = acc[r];
    };
    if constexpr (kUL2) {  // items e = tid, tid + kThreads, .. of parts x H
      for (int e = tid; e < parts * H; e += kThreads) {
        const int ck = e % H, cp = e / H;
        partial(ck, cp, cp * nj / parts, (cp + 1) * nj / parts);
      }
    } else if (cp0 < parts) {
      partial(ck0, cp0, lo0, hi0);
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

enum { kGates, kDU };
constexpr int kTile = 128, kTileK = 8, kLdTile = kTile + 4;

// The operands of a product block: its direction (grid z / splits) and
// split (one for the gates). kBi false (one direction): a.d[0]'s, which
// the compiler reads from the parameters where used
template <typename T, int kMode, bool kBi>
struct Operands {
  int dir, split;
  const T* hprev;
  const T* other;
  float* out;
  __device__ Operands(const BwdArgs<T>& a, int splits)
      : dir(kBi ? (int)blockIdx.z / splits : 0),
        split((int)blockIdx.z - dir * splits),
        hprev(dir ? a.d[1].hprev : a.d[0].hprev),
        other(kMode == kGates ? (dir ? a.d[1].U : a.d[0].U)
                              : (dir ? a.d[1].dxp : a.d[0].dxp)),
        out(kMode == kGates ? (dir ? a.d[1].G : a.d[0].G)
                            : (dir ? a.d[1].part : a.d[0].part)) {}
};

// the gates launch's first block zeroes the dU tiles' tickets
template <typename T>
__device__ __forceinline__ void zero_tickets(const BwdArgs<T>& a) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    for (int i = threadIdx.x; i < a.n_tickets; i += blockDim.x)
      a.tickets[i] = 0u;
}

// After a dU block wrote its split's partial tile: the block that finishes
// the tile last (its ticket) adds the tile's partials of all splits, in
// split order, and writes dU in U's type. The ticket only picks the block;
// the sums run in a fixed order, so the bits do not depend on which block
// adds them. N = 4H: rows of whole float4 vectors, eight a thread at once:
// sixteen raised the bf16 product to 186 registers (kernel_ab.py's compile
// report), one block an SM.
template <typename T>
__device__ void du_finish(const BwdArgs<T>& a, int dir, int splits, int M,
                          int N, int m0, int n0) {
  __shared__ unsigned last;
  __threadfence();  // this block's partials, device-wide, before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(a.tickets + (size_t)dir * gridDim.x * gridDim.y + tile,
                     1u) == (unsigned)splits - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* part = dir ? a.d[1].part : a.d[0].part;
  T* dU = dir ? a.d[1].dU : a.d[0].dU;
  const size_t count = (size_t)M * N;
  // the tile's 128 x 32 vectors of 4, kPer a thread in a pass: few
  // registers, so that the product keeps its occupancy
  constexpr int kVec = kTile / 4, kPer = 8;
#pragma unroll 1
  for (int v0 = threadIdx.x; v0 < kTile * kVec; v0 += 256 * kPer) {
    float4 acc[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < splits; ++c) {
      const float* pc = part + (size_t)c * count;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int v = v0 + 256 * i;
        const int m = m0 + v / kVec, n = n0 + 4 * (v % kVec);
        if (m < M && n < N) {
          const float4 p = __ldcg(
              reinterpret_cast<const float4*>(pc + (size_t)m * N + n));
          acc[i].x += p.x;
          acc[i].y += p.y;
          acc[i].z += p.z;
          acc[i].w += p.w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = v0 + 256 * i;
      const int m = m0 + v / kVec, n = n0 + 4 * (v % kVec);
      if (m < M && n < N) {
        T* o = dU + (size_t)m * N + n;
        o[0] = from_f32<T>(acc[i].x);
        o[1] = from_f32<T>(acc[i].y);
        o[2] = from_f32<T>(acc[i].z);
        o[3] = from_f32<T>(acc[i].w);
      }
    }
  }
}

// The walk past the forms above (see the header): a cluster walks one row
// of one direction; block q writes its partial dh of all H units into slot
// q of a double buffer in global memory, and after the step's cluster
// barrier each block adds its units' CS slots in rank order.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_big(const BwdArgs<T> a) {
  const int B = a.B, T_len = a.T_len, H = a.H, CS = a.CS, H4 = 4 * H;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const ClusterShare P(H, B, CS, 1, a.cpd, (int)rank);
  const int nj = P.nj, u0 = P.u0, b = P.b0, dir = P.dir, tid = threadIdx.x;
  const T* __restrict__ xp = dir ? a.d[1].xp : a.d[0].xp;
  const T* __restrict__ U = dir ? a.d[1].U : a.d[0].U;
  const float* __restrict__ cprev = dir ? a.d[1].cprev : a.d[0].cprev;
  const T* __restrict__ gy = dir ? a.d[1].gy : a.d[0].gy;
  const float* __restrict__ G = dir ? a.d[1].G : a.d[0].G;
  T* __restrict__ dxp = dir ? a.d[1].dxp : a.d[0].dxp;
  float* __restrict__ ut = dir ? a.d[1].ut : a.d[0].ut;
  const int reverse = dir ? a.d[1].reverse : a.d[0].reverse;
  extern __shared__ float4 smem_raw[];
  float* dhc = reinterpret_cast<float*>(smem_raw);  // [njmax] carries
  float* dcc = dhc + P.njmax;
  float* dps = dcc + P.njmax;                       // [njmax][4] dpre_mx
  float* pg = a.pg + (size_t)(blockIdx.x / CS) * 2 * CS * H;  // [2][CS][H]

  for (int i = tid; i < 4 * nj * H; i += kThreads) {
    const int c = i / H, k = i - c * H;  // c = g nj + jj
    const int g = c / nj, jj = c - g * nj;
    ut[((size_t)g * H + u0 + jj) * H + k] =
        to_f32<T>(U[(size_t)k * H4 + (size_t)g * H + u0 + jj]);
  }
  for (int j = tid; j < nj; j += kThreads) dhc[j] = dcc[j] = 0.0f;
  __syncthreads();  // this block's UT rows and carries

  for (int s = 0; s < T_len; ++s) {
    const int t = reverse ? s : T_len - 1 - s;
    const size_t bt = (size_t)b * T_len + t;
    const float m = a.mask[bt];
    const float m_prev =
        s > 0 ? a.mask[(size_t)b * T_len + (reverse ? t - 1 : t + 1)] : 0.0f;
    if (s > 0) cluster_wait();  // step s-1's partials of every block
    for (int j = tid; j < nj; j += kThreads) {
      const int cu = u0 + j;
      float x[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        x[g] = to_f32<T>(xp[bt * H4 + g * H + cu])
               + G[((size_t)t * B + b) * H4 + g * H + cu];
      const float c_old = cprev[(size_t)t * B * H + (size_t)b * H + cu];
      const float g_y = to_f32<T>(gy[bt * a.gy_ld + cu]);
      float dh = dhc[j];
      const float dc = dcc[j];
      if (s > 0) {  // dh <- (1 - m_prev) dh + the partials, rank order
        const float* part = pg + (size_t)((s - 1) & 1) * CS * H + cu;
        float sum = 0.0f;
        for (int q = 0; q < CS; ++q) sum += __ldcg(part + (size_t)q * H);
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
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const T dv = from_f32<T>(d4[g]);  // xp and U share the type
        dps[4 * j + g] = to_f32<T>(dv);
        dxp[bt * H4 + g * H + cu] = dv;
      }
      dhc[j] = dh;
      dcc[j] = (1.0f - m) * dc + dct * fg;
    }
    __syncthreads();  // dpre_mx of the block's columns
    // partial dh of unit k over the block's columns
    float* out = pg + (size_t)(s & 1) * CS * H + (size_t)rank * H;
    for (int k = tid; k < H; k += kThreads) {
      float acc = 0.0f;
      for (int jj = 0; jj < nj; ++jj) {
        const float* uc = ut + (size_t)(u0 + jj) * H + k;
        acc = fmaf(dps[4 * jj], uc[0], acc);
        acc = fmaf(dps[4 * jj + 1], uc[(size_t)H * H], acc);
        acc = fmaf(dps[4 * jj + 2], uc[(size_t)2 * H * H], acc);
        acc = fmaf(dps[4 * jj + 3], uc[(size_t)3 * H * H], acc);
      }
      out[k] = acc;
    }
    cluster_arrive();  // this step's partial written, its reads done
  }
  cluster_wait();
}

// The two products off the walk's chain, float32: out[m][n] = sum over k
// of A(k, m) B(k, n), in order of k, over the split's range of k (a block
// of grid z = direction x splits + split); 128 x 128 tiles, 16 x 16
// threads with 8 x 8 outputs each (rows 4 ty .. and 64 + 4 ty .., columns
// likewise from tx: conflict-free 16-byte reads of shared memory), 8-deep
// slices of k double-buffered in shared memory, the next slice's loads in
// flight while one is computed.
//   kGates: G = hprev @ U: m = t B + b (hprev's rows), k a hidden unit, n
//           a gate column; A(k, m) = hprev[m][k], B(k, n) = U[k][n].
//   kDU:    dU partials: m a hidden unit, k = t B + b, n a gate column;
//           A(k, m) = hprev[k][m], B(k, n) = dxp[b][t][n].
template <typename T, int kMode, bool kBi>
__global__ void __launch_bounds__(256, 2)
lstm_bwd_gemm(const BwdArgs<T> a, int M, int N, int K, int k_per_split,
              int splits) {
  __shared__ __align__(16) float As[2][kTileK * kLdTile];  // [kk][m]
  __shared__ __align__(16) float Bs[2][kTileK * kLdTile];  // [kk][n]
  const Operands<T, kMode, kBi> op(a, splits);
  const T* __restrict__ hprev = op.hprev;
  const T* __restrict__ other = op.other;
  const int B = a.B, T_len = a.T_len;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int k_lo = op.split * k_per_split;
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
      float av = 0.0f;
      if (k < k_hi && m < M)
        av = to_f32<T>(kMode == kGates ? hprev[(size_t)m * K + k]
                                       : hprev[(size_t)k * M + m]);
      ra[i] = av;
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
  if constexpr (kMode == kGates) zero_tickets(a);
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
  float* o = op.out + (size_t)op.split * M * N;
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
  if constexpr (kMode == kDU) du_finish(a, op.dir, splits, M, N, m0, n0);
}

// The same two products for bfloat16 inputs on the tensor cores: mma.sync
// m16n8k16 (bf16 operands, exact products, float32 accumulators), 128 x
// 128 tiles, 8 warps of 64 x 32 outputs each, 32-deep slices of k held in
// shared memory as bf16 (double-buffered, rows padded by 8 elements so
// that ldmatrix is free of bank conflicts), the next slice's loads in
// flight while one is computed; 16-byte loads where the rows allow
// (inner sizes multiples of 8), else element by element.
constexpr int kMmaK = 32, kLdA = kMmaK + 8, kLdT = kTile + 8;

template <int kMode, bool kBi>
__global__ void __launch_bounds__(256, 2)
lstm_bwd_gemm_mma(const BwdArgs<__nv_bfloat16> a, int M, int N, int K,
                  int k_per_split, int splits) {
  using bf16 = __nv_bfloat16;
  const Operands<bf16, kMode, kBi> op(a, splits);
  const bf16* __restrict__ hprev = op.hprev;
  const bf16* __restrict__ other = op.other;
  const int B = a.B, T_len = a.T_len;
  // A as [m][k] (kGates) or [k][m] (kDU); B as [k][n]
  constexpr int kASize = kMode == kGates ? kTile * kLdA : kMmaK * kLdT;
  __shared__ __align__(16) bf16 As[2][kASize];
  __shared__ __align__(16) bf16 Bs[2][kMmaK * kLdT];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int k_lo = op.split * k_per_split;
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

  if constexpr (kMode == kGates) zero_tickets(a);
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
      unsigned fa[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kMode == kGates)
          ldsm_x4(fa[i], As[buf] + (wm + 16 * i + a_row) * kLdA + kk + a_col);
        else
          ldsm_x4_trans(fa[i],
                        As[buf] + (kk + at_k) * kLdT + wm + 16 * i + at_m);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4_trans(b[j], Bs[buf] + (kk + b_k) * kLdT + wn + 16 * j + b_n);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16_16816(acc[i][j], fa[i], b[j >> 1][2 * (j & 1)],
                         b[j >> 1][2 * (j & 1) + 1]);
    }
    if (more) {
      store(buf ^ 1);  // the other buffer was consumed before the last sync
      __syncthreads();
      buf ^= 1;
    }
  }
  float* o = op.out + (size_t)op.split * M * N;
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
  if constexpr (kMode == kDU) du_finish(a, op.dir, splits, M, N, m0, n0);
}


// splits of the dU product's K = B T: one wave of a direction's blocks
// (two resident an SM), each split at least 1024 pairs long. (25 splits,
// a wave and a half at B=64, T=401, H=256, left float32 lstm_bwd 4%
// slower: kernel_ab.py lstm.)
int du_splits(int B, int T_len, int H) {
  int dev = 0, sms = 0;
  if (device_sms(&dev, &sms) != 0) sms = 1;
  const int tiles = ((H + kTile - 1) / kTile) * ((4 * H + kTile - 1) / kTile);
  return max(1, min(2 * sms / tiles, (B * T_len) / 1024));
}

// The walk's plan (plan_clusters): clusters of 8 blocks, or 16 where U's
// slice does not fit at 8 (U in shared memory: 8 rows must fit; from L2:
// a cluster of 16 may take fewer), a thread per (row, unit) of a block.
template <typename T, bool kUL2>
int plan(int B, int H, int ndir, ClusterPlan* p) {
  // occupancy from the launch's own kind of instance (registers differ)
  return plan_clusters(ndir == 2 ? lstm_bwd_kernel<T, kBwdRows, kUL2, true>
                                 : lstm_bwd_kernel<T, kBwdRows, kUL2, false>,
                       B, H, ndir, 1,
                       kRows, kUL2 ? 1 : kRows, kBwdRows,
                       [H](int cs, int r, int* threads, size_t* smem) {
                         const int njmax = (H + cs - 1) / cs;
                         const int ldr = kUL2 ? r : r > kRows ? kBwdRows
                                                              : kRows;
                         *threads = kThreads;
                         *smem = Smem(H, njmax, ldr, kUL2).total
                                 * sizeof(float);
                         return njmax * r <= kThreads;
                       }, p);
}

// The walk's form at (B, H) in type T, into *form: 0 U in shared memory,
// 1 U read from L2, 2 the widest (lstm_bwd_big). Returns 0 or a
// cudaError_t.
template <typename T>
int walk_form(int B, int H, int* form) {
  ClusterPlan p;
  int rc = plan<T, false>(B, H, 1, &p);
  *form = 0;
  if (rc != kErrNoCluster) return rc;
  rc = plan<T, true>(B, H, 1, &p);
  *form = 1;
  if (rc != kErrNoCluster) return rc;
  *form = 2;
  return 0;
}

template <typename T>
int plan_big(int B, int H, int ndir, ClusterPlan* p) {
  return plan_clusters(lstm_bwd_big<T>, B, H, ndir, 1, 1, 1, 1,
                       [H](int cs, int r, int* threads, size_t* smem) {
                         *threads = kThreads;
                         *smem = 6 * (size_t)((H + cs - 1) / cs)
                                 * sizeof(float);
                         return r == 1;
                       }, p);
}

// float32 scratch of a call, per direction: G (T B x 4H), the dU partials,
// (U read from L2) UT (4H x H), (the widest form) two buffers of up to 16
// partials of H a row; then the dU tiles' tickets
size_t scratch_floats(int B, int T_len, int H, int form, int ndir) {
  const size_t tiles =
      (size_t)((H + kTile - 1) / kTile) * ((4 * H + kTile - 1) / kTile);
  return ndir * (((size_t)T_len * B + (size_t)du_splits(B, T_len, H) * H
                  + (form >= 1 ? (size_t)H : 0)) * 4 * H
                 + (form == 2 ? (size_t)B * 2 * 16 * H : 0) + tiles);
}

template <typename Kernel, typename T>
int launch_walk(Kernel kernel, const ClusterPlan& p, const BwdArgs<T>& a,
                cudaStream_t stream) {
  int rc = set_cluster_attrs(kernel, p.cs, p.smem);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(&attr, p, stream);
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e == cudaSuccess) e = cudaGetLastError();
  return e;
}

// the call's three launches: the gates product, the walk, the dU product
template <typename T, bool kBi>
int launch_three(const ClusterPlan& p, const BwdArgs<T>& a, int form,
                 dim3 g_grid, dim3 d_grid, int per, int splits,
                 cudaStream_t stream) {
  const int H = a.H, H4 = 4 * H, BT = a.B * a.T_len;
  if constexpr (std::is_same_v<T, float>)
    lstm_bwd_gemm<T, kGates, kBi><<<g_grid, 256, 0, stream>>>(a, BT, H4, H,
                                                               H, 1);
  else
    lstm_bwd_gemm_mma<kGates, kBi><<<g_grid, 256, 0, stream>>>(a, BT, H4, H,
                                                                H, 1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  int rc;
  if (form == 2)
    rc = launch_walk(lstm_bwd_big<T>, p, a, stream);
  else if (p.rows > kRows)
    rc = form ? launch_walk(lstm_bwd_kernel<T, kBwdRows, true, kBi>, p, a,
                            stream)
              : launch_walk(lstm_bwd_kernel<T, kBwdRows, false, kBi>, p, a,
                            stream);
  else
    rc = form ? launch_walk(lstm_bwd_kernel<T, kRows, true, kBi>, p, a,
                            stream)
              : launch_walk(lstm_bwd_kernel<T, kRows, false, kBi>, p, a,
                            stream);
  if (rc != 0) return rc;
  if constexpr (std::is_same_v<T, float>)
    lstm_bwd_gemm<T, kDU, kBi><<<d_grid, 256, 0, stream>>>(a, H, H4, BT, per,
                                                            splits);
  else
    lstm_bwd_gemm_mma<kDU, kBi><<<d_grid, 256, 0, stream>>>(a, H, H4, BT, per,
                                                             splits);
  return cudaGetLastError();
}

template <typename T>
int dispatch(BwdArgs<T> a, int ndir, float* scratch, size_t n_scratch,
             cudaStream_t stream) {
  const int B = a.B, T_len = a.T_len, H = a.H;
  if (B < 1 || T_len < 1 || H < 1) return cudaErrorInvalidValue;
  int form = 0;
  int rc = walk_form<T>(B, H, &form);
  if (rc != 0) return rc;
  ClusterPlan p;
  rc = form == 0   ? plan<T, false>(B, H, ndir, &p)
       : form == 1 ? plan<T, true>(B, H, ndir, &p)
                   : plan_big<T>(B, H, ndir, &p);
  if (rc != 0) return rc;
  if (scratch_floats(B, T_len, H, form, ndir) > n_scratch)
    return cudaErrorInvalidValue;
  const int H4 = 4 * H, BT = B * T_len;
  const int splits = du_splits(B, T_len, H);
  float* f = scratch;
  for (int d = 0; d < ndir; ++d) {
    a.d[d].G = f;
    f += (size_t)BT * H4;
    a.d[d].part = f;
    f += (size_t)splits * H * H4;
    a.d[d].ut = f;
    f += form >= 1 ? (size_t)H4 * H : 0;
  }
  a.pg = f;
  f += form == 2 ? (size_t)ndir * B * 2 * 16 * H : 0;
  const dim3 d_grid((H4 + kTile - 1) / kTile, (H + kTile - 1) / kTile,
                    splits * ndir);
  a.tickets = reinterpret_cast<unsigned*>(f);
  a.n_tickets = ndir * d_grid.x * d_grid.y;
  a.CS = p.cs;
  a.rows = p.rows;
  a.cpd = p.cpd;
  const dim3 g_grid((H4 + kTile - 1) / kTile, (BT + kTile - 1) / kTile, ndir);
  const int per = (BT + splits - 1) / splits;
  return ndir == 2 ? launch_three<T, true>(p, a, form, g_grid, d_grid, per,
                                           splits, stream)
                   : launch_three<T, false>(p, a, form, g_grid, d_grid, per,
                                            splits, stream);
}

// *floats = the float32 scratch of a call of `ndir` directions at (B, T,
// H) in either type. Returns 0 or a cudaError_t.
int scratch_of(int B, int T_len, int H, int ndir, long long* floats) {
  *floats = 0;
  if (B < 1 || T_len < 1 || H < 1) return cudaErrorInvalidValue;
  int f = 0, h = 0;
  int rc = walk_form<float>(B, H, &f);
  if (rc == 0) rc = walk_form<__nv_bfloat16>(B, H, &h);
  if (rc != 0) return rc;
  *floats = (long long)scratch_floats(B, T_len, H, f > h ? f : h, ndir);
  return 0;
}

template <typename T>
BwdDir<T> bwd_dir(const void* xp, const void* U, const void* hprev,
                  const void* cprev, const void* gy, void* dxp, void* dU,
                  int reverse) {
  BwdDir<T> d = {};
  d.xp = static_cast<const T*>(xp);
  d.U = static_cast<const T*>(U);
  d.hprev = static_cast<const T*>(hprev);
  d.cprev = static_cast<const float*>(cprev);
  d.gy = static_cast<const T*>(gy);
  d.dxp = static_cast<T*>(dxp);
  d.dU = static_cast<T*>(dU);
  d.reverse = reverse;
  return d;
}

template <typename T>
int backward(const void* xp, const void* U, const void* mask,
             const void* hprev, const void* cprev, const void* gy, void* dxp,
             void* dU, float* scratch, size_t n_scratch, int B, int T_len,
             int H, int reverse, cudaStream_t stream) {
  BwdArgs<T> a = {};
  a.d[0] = bwd_dir<T>(xp, U, hprev, cprev, gy, dxp, dU, reverse);
  a.d[1] = a.d[0];
  a.mask = static_cast<const float*>(mask);
  a.gy_ld = H;
  a.B = B;
  a.T_len = T_len;
  a.H = H;
  return dispatch<T>(a, 1, scratch, n_scratch, stream);
}

template <typename T>
int bi_backward(const void* const* p, float* scratch, size_t n_scratch,
                int B, int T_len, int H, cudaStream_t stream) {
  // p: xpf, xpb, Uf, Ub, mask, hpf, cpf, hpb, cpb, gy, dxpf, dxpb, dUf, dUb
  const T* gy = static_cast<const T*>(p[9]);
  BwdArgs<T> a = {};
  a.d[0] = bwd_dir<T>(p[0], p[2], p[5], p[6], gy, const_cast<void*>(p[10]),
                      const_cast<void*>(p[12]), 0);
  a.d[1] = bwd_dir<T>(p[1], p[3], p[7], p[8], gy + H,
                      const_cast<void*>(p[11]), const_cast<void*>(p[13]), 1);
  a.mask = static_cast<const float*>(p[4]);
  a.gy_ld = 2 * H;
  a.B = B;
  a.T_len = T_len;
  a.H = H;
  return dispatch<T>(a, 2, scratch, n_scratch, stream);
}

}  // namespace

extern "C" {

// *floats = the float32 scratch a call of lstm_bwd at (B, T, H) needs (in
// either type). Returns 0 or a cudaError_t.
int pgasr_lstm_bwd_scratch(int B, int T_len, int H, long long* floats) {
  return scratch_of(B, T_len, H, 1, floats);
}

// The same for bilstm_bwd (both directions).
int pgasr_bilstm_bwd_scratch(int B, int T_len, int H, long long* floats) {
  return scratch_of(B, T_len, H, 2, floats);
}

// dtype: 0 = float32, 1 = bfloat16 (xp, U, hprev, gy, dxp and dU share
// it). scratch: n_scratch float32, at least pgasr_lstm_bwd_scratch's.
// Returns 0, a cudaError_t value or kErrDtype.
int pgasr_lstm_bwd(const void* xp, const void* U, const void* mask,
                   const void* hprev, const void* cprev, const void* gy,
                   void* dxp, void* dU, void* scratch, long long n_scratch,
                   int B, int T_len, int H, int reverse, int dtype,
                   void* stream) {
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(xp, U, mask, hprev, cprev, gy, dxp, dU, sc,
                           (size_t)n_scratch, B, T_len, H, reverse, s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(xp, U, mask, hprev, cprev, gy, dxp, dU,
                                   sc, (size_t)n_scratch, B, T_len, H,
                                   reverse, s);
  return kErrDtype;
}

// Both directions of a layer: the forward direction's xpf, Uf, hpf, cpf,
// the backward one's xpb, Ub, hpb, cpb, gy (B, T, 2H) -> dxpf, dxpb, dUf,
// dUb. scratch: at least pgasr_bilstm_bwd_scratch's. The same returns.
int pgasr_bilstm_bwd(const void* xpf, const void* xpb, const void* Uf,
                     const void* Ub, const void* mask, const void* hpf,
                     const void* cpf, const void* hpb, const void* cpb,
                     const void* gy, void* dxpf, void* dxpb, void* dUf,
                     void* dUb, void* scratch, long long n_scratch, int B,
                     int T_len, int H, int dtype, void* stream) {
  const void* p[14] = {xpf, xpb, Uf,  Ub,   mask, hpf,  cpf,
                       hpb, cpb, gy,  dxpf, dxpb, dUf,  dUb};
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bi_backward<float>(p, sc, (size_t)n_scratch, B, T_len, H, s);
  if (dtype == 1)
    return bi_backward<__nv_bfloat16>(p, sc, (size_t)n_scratch, B, T_len, H,
                                      s);
  return kErrDtype;
}

}  // extern "C"
