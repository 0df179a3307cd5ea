// Masked LSTM forward recurrence, one direction (lstm_fwd) or the two of a
// bidirectional layer in one launch (bilstm_fwd), for Hopper (sm_90a).
//
// Replaces the TPU kernels pg_asr_tpu/ops/pallas_lstm.py:_kernel (via
// _pallas_forward / _pallas_forward_train) and _kernel_bi (via
// _pallas_bi_forward), each in its inference form (train=False) and its
// residual form (train=True, the forward of the custom VJP). Contract of
// one direction:
//   xp    (B, T, 4H)  precomputed x@W + b, float32 or bfloat16, gates i,f,g,o
//   U     (H, 4H)     recurrent weights, same type as xp
//   mask  (B, T)      float32, > 0 at valid steps
//   out   (B, T, H)   h_new * mask, in xp's type
//   hprev (T, B, H)   residual form only: the carry h before step t, in
//                     xp's type (padded steps included, as in the Pallas body)
//   cprev (T, B, H)   residual form only: the carry c before step t, float32
// A null hprev/cprev pointer selects the inference form. bilstm_fwd takes
// xpf, xpb, Uf, Ub, one mask, and writes y (B, T, 2H) = concat(forward,
// backward) straight into its two halves, and hpf, cpf, hpb, cpb: the
// forward direction walks t = 0 .. T-1, the backward one T-1 .. 0.
// Carries h and c are float32. h is rounded to U's type before the product
// (h.astype(U.dtype) in the Pallas body) and the product accumulates in
// float32. Where mask == 0 the carry is frozen and the output is zero;
// reverse walks t = T-1 .. 0. Only the summation order of the product
// differs from the plain version; the result is the same from run to run,
// and each direction of bilstm_fwd equals lstm_fwd's bits: the cluster
// size, and with it every (row, unit)'s summation order, is planned
// without regard to the rows a cluster carries or the directions.
//
// What bounds it on this card: the recurrence is a chain of T dependent
// steps, each a small (B, H) x (H, 4H) product plus the gate math (~33
// MFLOP at B=64, H=256), far too little per step to fill 132 SMs, so a
// step's latency bounds the call, not FLOPs or HBM bytes. The first kernel
// (one cooperative grid of H/2 blocks, one grid barrier per step, every
// block reading all of h_{t-1} through L2) took ~4 us a step; the first
// fused-direction kernel, the same design over both directions, ~6.8 us.
//
// Design. Batch rows never meet in the recurrence, and neither do the two
// directions, so (row, direction) pairs are split over thread-block
// clusters that never wait on each other (cudaLaunchKernelEx with a
// cluster dimension; no cooperative launch, no grid barrier): clusters 0 ..
// cpd - 1 walk the first direction, cpd .. 2 cpd - 1 the second, the
// cluster's index choosing its pointers. The hidden units are split over
// the CS blocks of a cluster (CS = 8, or 16 where U's slice does not fit;
// ragged: H / CS units or one more). Rows per cluster come from
// cudaOccupancyMaxActiveClusters (plan_clusters, common.cuh), so that every
// cluster of every direction is resident at once: on the H100 15 clusters
// of 8 one-block-per-SM blocks are (a 16th waits for a second wave), so a
// bidirectional layer at B = 64 takes 14 clusters of 10 rows (float32) or
// 8 of 16 (bfloat16) where one direction takes 13 of 5 or 8 of 8. Block q
// keeps U's 4 NJ gate columns of its units for the whole walk, and their
// carries, and computes their complete gate sums over all H units; only
// h_t of the cluster's rows crosses blocks. Each block writes its units'
// h_t into its own buffer of h (two, alternating) and one thread per peer
// copies that slice into the peer's buffer with cp.async.bulk
// (shared::cta to shared::cluster), whose bytes complete a transaction
// count on the peer's mbarrier (one per buffer): the copy engine moves the
// slice and the sender never waits, and a block starts a step's product
// once its peers' h_{t-1} has landed. (A cluster barrier after per-thread
// remote stores cost ~2.3 K cycles a step in its release, per-thread
// st.async ~1.7 K in issue: PERF.md, Findings.) Each step's xp is loaded a
// step ahead. Nothing else guards the buffers against overwriting: a block
// pushes h_t only after its product of step t, which needed every block's
// h_{t-1}, so no block reaches step t + 1 (and overwrites the buffer of
// h_{t-1}) before every block's product of step t is done.
//   float32 (lstm_fwd_cc, CUDA cores): U's columns in shared memory,
//     unit-major (column 4 jj + g is U[:, g H + u0 + jj]). Thread (slice
//     pk of k, unit pj) forms R rows x 4 gates over its slice of k, in
//     order of k (one 16-byte load of U and up to four broadcast loads of
//     h for 4 R multiply-adds), into shared memory; thread (row, unit) adds
//     the slices in order, adds xp and runs the cell update. R, the rows
//     per cluster (1 .. 16), is a template parameter: no multiply-add for
//     an absent row. (U's slice in registers, its k loop unrolled, ran 20%
//     slower.)
//   bfloat16 (lstm_fwd_bf16, tensor cores): the product as mma.sync
//     m16n8k16, U's gate columns as M, K = H, the cluster's rows as N (one
//     n8 tile up to 8 rows, two up to 16). Warp (w, r) owns 8 units and
//     k-steps 8 r .. 8 r + 7 of their 32 gate columns (two m16 tiles: i
//     and f, g and o), kept as bf16 A fragments in registers for the whole
//     walk (K = 256: 2 warps per unit group); h lives in shared memory as
//     bf16 [k][8 NT rows] and is read as B fragments with ldmatrix.trans;
//     the even and odd k-steps accumulate apart and are added; each warp's
//     sums go to shared memory and are added over the k-ranges in order.
//     Lane (g, c) of the unit group's first warp then holds all four gates
//     of unit g for rows 2c, 2c + 1 (and 8 + 2c, 9 + 2c) and of its second
//     warp for the same rows: the two split the cell updates, carries in
//     registers. h is rounded to bf16 once, where it is written (the
//     Pallas body's h.astype(U.dtype)); bf16 products are exact and the
//     sums float32, each output column's independent of the others, so the
//     second n8 tile changes no bit of the first's rows.
//   Larger H (clusters of 16): where U's slice no longer fits a block's
//     shared memory (f32 from H ~ 416 on) nor 16 warps' registers (bf16
//     above 512), both types take the CUDA-core walk with U's gate columns
//     read from L2 (from HBM past 50 MB) on every step (lstm_fwd_cc with
//     kUL2), one coalesced load per gate over the block's units, a thread
//     looping over its block's units where they outnumber its 256 threads;
//     bfloat16 rounds h to bf16 where it is written, so its products are
//     the tensor-core walk's (exact, float32 sums in another order). Rows
//     per cluster shrink as H grows, so that two buffers of h of the
//     cluster's rows fit a block's shared memory (H up to ~6,900 at one
//     row: 32 H bytes) and a thread per (row, unit) remains.
//   Past that (lstm_fwd_big): a cluster walks one row, a thread loops over
//     its block's units (their carries in shared memory), each unit's gate
//     sums over k in order, and h crosses blocks through a double buffer
//     in global memory under one cluster barrier a step (arrive.release,
//     wait.acquire): any H the device memory holds.

#include <cooperative_groups.h>

#include <type_traits>
#include <utility>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pgasr;
using bf16 = __nv_bfloat16;

constexpr int kF32Threads = 256;
constexpr int kCcRows = 16;       // rows of a cluster of the f32 walk, U shared
constexpr int kGroupUnits = 8;    // units of a bf16 warp: two m16 tiles
constexpr int kWarpKSteps = 8;    // k16 steps of U a bf16 warp holds
constexpr int kBf16Warps = 8;      // warps of a bf16 block up to H = 256
constexpr int kBf16MaxWarps = 16;  // and above (fewer registers a thread)
constexpr int kBf16Rows = 16;      // rows of a bf16 cluster: two n8 tiles

// One direction of a launch: lstm_fwd launches one, bilstm_fwd the two of
// a layer, and a cluster's index picks its own.
template <typename T>
struct FwdDir {
  const T* xp;    // (B, T, 4H)
  const T* U;     // (H, 4H)
  T* hprev;       // (T, B, H), null in the inference form
  float* cprev;   // (T, B, H), null in the inference form
  int reverse;    // walks t = T-1 .. 0
  int out_off;    // column of out holding unit 0: 0, or H (bilstm's second)
};

template <typename T>
struct FwdArgs {
  FwdDir<T> d[2];
  const float* mask;  // (B, T)
  T* out;             // (B, T, out_ld)
  float* hg;          // lstm_fwd_big: two buffers of h (H) a cluster
  int out_ld, B, T_len, H, CS, rows, cpd;
};

// the direction `dir` of a's, field by field (no dynamic index into the
// kernel's parameters). kBi false (a launch of one direction): a.d[0]'s,
// which the compiler reads from the parameters where it uses them rather
// than holding them (selected pointers cost float32 lstm_fwd 2.5%:
// kernel_ab.py lstm)
template <typename T, bool kBi = true>
struct Walk {
  const T* __restrict__ xp;
  const T* __restrict__ U;
  T* __restrict__ hprev;
  float* __restrict__ cprev;
  T* __restrict__ out;
  int reverse;
  __device__ Walk(const FwdArgs<T>& a, int dir)
      : xp(kBi && dir ? a.d[1].xp : a.d[0].xp),
        U(kBi && dir ? a.d[1].U : a.d[0].U),
        hprev(kBi && dir ? a.d[1].hprev : a.d[0].hprev),
        cprev(kBi && dir ? a.d[1].cprev : a.d[0].cprev),
        out(a.out + (kBi && dir ? a.d[1].out_off : a.d[0].out_off)),
        reverse(kBi && dir ? a.d[1].reverse : a.d[0].reverse) {}
};

// --- the exchange of h: bulk copies between the blocks' shared memory,
// counted in bytes on the receiver's mbarrier, one barrier per buffer of h

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// the address `a` of this block's shared memory as block `rank` sees it
__device__ __forceinline__ unsigned peer_addr(unsigned a, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
// `bytes` (a multiple of 16) of this block's shared memory at `src` to a
// peer's at `dst`, counted on the peer's mbarrier `bar` (dst and bar mapped
// to the peer by peer_addr): the copy engine moves them, the sender does not
// wait. Shared memory written by the block's threads before needs
// proxy_fence() by each writer, then a block barrier.
__device__ __forceinline__ void push_bulk(unsigned dst, unsigned src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
               : "memory");
}
// the one arrival of the barrier's current phase, which then completes
// once `bytes` more have landed (bytes that land earlier count too)
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// until the phase of `parity` completed; a step whose bytes have not all
// landed after 10 s traps (a launch error rather than a hung card)
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

// The walk's exchange of h. Buffer b of h (steps s >= 1 with s & 1 == b
// read h_{s-1} from it) has barrier b, which counts the bytes the peers
// push into it; `parity` is the phase each waits for next. A block writes
// its own units' h into its own buffer and pushes that slice to every peer.
struct Exchange {
  unsigned bar[2], parity[2] = {0u, 0u};
  unsigned bytes;  // a step's bytes from the peers
  int T_len;
  // thread 0 sets the barriers up (before the cluster's first sync) and
  // arms them for steps 1 and 2
  __device__ Exchange(unsigned long long* bars, unsigned bytes_, int T)
      : bytes(bytes_), T_len(T) {
    bar[0] = smem_u32(bars);
    bar[1] = smem_u32(bars + 1);
    if (threadIdx.x == 0) {
      mbar_init(bar[0]);
      mbar_init(bar[1]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (T > 1) mbar_expect(bar[1], bytes);
      if (T > 2) mbar_expect(bar[0], bytes);
    }
  }
  // every thread: the peers' h_{s-1} has landed in buffer s & 1
  __device__ void wait(int s) {
    mbar_wait(bar[s & 1], parity[s & 1]);
    parity[s & 1] ^= 1u;
  }
  // thread 0, once every thread of the block waited at step s >= 1: arm
  // the barrier for its next step, s + 2
  __device__ void rearm(int s) {
    if (threadIdx.x == 0 && s > 0 && s + 2 < T_len)
      mbar_expect(bar[s & 1], bytes);
  }
  // thread q < CS (not the block's own rank): the block's slice of buffer
  // b (`slice`, `n` bytes) to block q, after proxy_fence() by every writer
  // of the slice and a block barrier
  __device__ void push(unsigned slice, unsigned n, int b, int CS,
                       unsigned rank) const {
    const unsigned q = threadIdx.x;
    if (q < (unsigned)CS && q != rank && n > 0)
      push_bulk(peer_addr(slice, q), slice, n, peer_addr(bar[b], q));
  }
};

// rows of h a buffer holds per unit: whole 16-byte vectors of R
__host__ __device__ constexpr int h_ld(int R) {
  return R <= 4 ? 4 : R <= 8 ? 8 : 16;
}

// CUDA-core shared memory, in floats: the two barriers (4 floats), U's
// own columns [H][ldu] (ldu = 4 njmax, unit-major: column 4 jj + g is U[:,
// g H + u0 + jj]; none where the walk reads U from L2), two buffers of h
// [H][ldh], the partial gate sums [ks][R][ldu]. pw units are formed at
// once (a thread each), over ks slices of k.
struct F32Smem {
  int pw, ldu, ks, ldh;
  size_t u, h, p, total;
  __host__ __device__ F32Smem(int H, int njmax, int R, bool u_l2)
      : pw(min(njmax, kF32Threads)), ldu(4 * njmax), ks(kF32Threads / pw),
        ldh(h_ld(R)), u(4), h(u + (u_l2 ? 0 : (size_t)H * ldu)),
        p(h + (size_t)2 * H * ldh), total(p + (size_t)ks * R * ldu) {}
};

// The walk on the CUDA cores, float32 products: xp, U, out and hprev of
// type T (float32, or bfloat16 where U's A fragments do not fit the tensor
// -core walk's registers: bf16 products are exact in float32, and h is
// rounded to bf16 where it is written, as the Pallas body's
// h.astype(U.dtype)). kUL2: U's columns are read from L2 on every step
// (coalesced over the block's units, one gate at a time) where their
// slice does not fit the block's shared memory.
template <typename T, int R, bool kUL2, bool kBi>
__global__ void __launch_bounds__(kF32Threads, 1)
lstm_fwd_cc(const FwdArgs<T> a) {
  constexpr int LDH = h_ld(R);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int B = a.B, T_len = a.T_len, H = a.H, CS = a.CS;
  const ClusterShare P(H, B, CS, R, a.cpd, (int)rank);
  const Walk<T, kBi> W(a, P.dir);
  const float* __restrict__ mask = a.mask;
  const F32Smem L(H, P.njmax, R, kUL2);
  const int H4 = 4 * H, tid = threadIdx.x;
  extern __shared__ float4 smem_raw[];
  float* us = reinterpret_cast<float*>(smem_raw) + L.u;  // [H][ldu]
  float* hs = reinterpret_cast<float*>(smem_raw) + L.h;  // [2][H][LDH]
  float* ps = reinterpret_cast<float*>(smem_raw) + L.p;  // [ks][R][ldu]
  Exchange X(reinterpret_cast<unsigned long long*>(smem_raw),
             (unsigned)((H - P.nj) * LDH * sizeof(float)), T_len);
  const unsigned slice_bytes = (unsigned)(P.nj * LDH * sizeof(float));

  if constexpr (!kUL2) {
    for (int i = tid; i < H * L.ldu; i += kF32Threads) {
      const int k = i / L.ldu, c = i - k * L.ldu;
      const int jj = c >> 2, g = c & 3;
      us[i] = jj < P.nj
                  ? to_f32<T>(W.U[(size_t)k * H4 + (size_t)g * H + P.u0 + jj])
                  : 0.0f;
    }
  }
  // the product thread: units pj0 (and, U from L2 and more units than
  // threads, pj0 + pw, ..), k = k_lo .. k_lo + nk - 1
  const int pj0 = tid % L.pw, pk = tid / L.pw;
  const int kl = (H + L.ks - 1) / L.ks;
  const int k_lo = pk < L.ks ? min(H, pk * kl) : H;
  const int nk = min(H, k_lo + kl) - k_lo;
  for (int i = tid; i < 2 * H * LDH; i += kF32Threads) hs[i] = 0.0f;

  // the cell threads: slot e is (row cr, unit cj), i = tid + e kF32Threads;
  // float32 carries in registers
  int cr[2], cj[2];
  bool cell[2];
  float hc[2] = {0.0f, 0.0f}, cc[2] = {0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = tid + e * kF32Threads;
    cr[e] = P.nj > 0 ? i / P.nj : R;
    cj[e] = P.nj > 0 ? i - cr[e] * P.nj : 0;
    cell[e] = cr[e] < P.nrows;
  }
  // this step's cell inputs, loaded a step ahead
  float xn[2][4], mn[2];
  auto load_inputs = [&](int s) {
    const int t = W.reverse ? T_len - 1 - s : s;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mn[e] = 0.0f;
#pragma unroll
      for (int g = 0; g < 4; ++g) xn[e][g] = 0.0f;
      if (cell[e]) {
        const size_t bt = (size_t)(P.b0 + cr[e]) * T_len + t;
        const T* xrow = W.xp + bt * H4 + P.u0 + cj[e];
#pragma unroll
        for (int g = 0; g < 4; ++g) xn[e][g] = to_f32<T>(xrow[g * H]);
        mn[e] = mask[bt];
      }
    }
  };
  load_inputs(0);

  cluster.sync();  // barriers set up and h zeroed in every block

  for (int s = 0; s < T_len; ++s) {
    const int t = W.reverse ? T_len - 1 - s : s;
    float x[2][4], m[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m[e] = mn[e];
#pragma unroll
      for (int g = 0; g < 4; ++g) x[e][g] = xn[e][g];
    }
    if (s > 0) X.wait(s);  // the peers' h_{t-1} in buffer s & 1
    const float* hb = hs + (size_t)(s & 1) * H * LDH + (size_t)k_lo * LDH;
    // the gate sums of unit pj over the thread's slice of k
    auto product = [&](int pj) {
      const float* ub = us + (size_t)k_lo * L.ldu + 4 * pj;
      // kUL2: U[k][g H + u0 + pj], zero for an absent unit
      const bool u_ok = pj < P.nj;
      const T* ug = W.U + (size_t)k_lo * H4 + P.u0 + (u_ok ? pj : 0);
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
#pragma unroll 4
      for (int i = 0; i < nk; ++i) {  // k = k_lo + i
        float4 u;
        if constexpr (kUL2) {
          const T* ur = ug + (size_t)i * H4;
          u = u_ok ? make_float4(to_f32<T>(ur[0]), to_f32<T>(ur[H]),
                                 to_f32<T>(ur[2 * H]), to_f32<T>(ur[3 * H]))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else {
          u = *reinterpret_cast<const float4*>(ub + (size_t)i * L.ldu);
        }
        float hv[LDH];
#pragma unroll
        for (int q = 0; q < (R + 3) / 4; ++q) {
          const float4 h4 =
              *reinterpret_cast<const float4*>(hb + i * LDH + 4 * q);
          hv[4 * q] = h4.x; hv[4 * q + 1] = h4.y;
          hv[4 * q + 2] = h4.z; hv[4 * q + 3] = h4.w;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][0] = fmaf(hv[r], u.x, acc[r][0]);
          acc[r][1] = fmaf(hv[r], u.y, acc[r][1]);
          acc[r][2] = fmaf(hv[r], u.z, acc[r][2]);
          acc[r][3] = fmaf(hv[r], u.w, acc[r][3]);
        }
      }
      if (pk < L.ks) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          *reinterpret_cast<float4*>(ps + ((size_t)pk * R + r) * L.ldu +
                                     4 * pj) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    };
    // one unit a thread, unless U comes from L2 and units outnumber threads
    // (a loop around the one call doubled H = 512: chip_smoke.py phase 3g)
    if (!kUL2 || P.njmax <= kF32Threads) {
      product(pj0);
    } else {
      for (int pj = pj0; pj < P.njmax; pj += L.pw) product(pj);
    }
    __syncthreads();  // the partial gate sums; every thread past the wait
    X.rearm(s);

    const bool push = s + 1 < T_len;  // nobody reads the last step's h
    const int nb = (s + 1) & 1;
    float* hn = hs + (size_t)nb * H * LDH;
    float h_old[2], c_old[2], y[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      h_old[e] = hc[e];
      c_old[e] = cc[e];
      y[e] = 0.0f;
      if (cell[e]) {
        float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float* pp = ps + (size_t)cr[e] * L.ldu + 4 * cj[e];
        for (int kk = 0; kk < L.ks; ++kk) {  // the slices in order
          const float4 v =
              *reinterpret_cast<const float4*>(pp + (size_t)kk * R * L.ldu);
          sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
        }
        const float ig = sigmoid(x[e][0] + sum.x);
        const float fg = sigmoid(x[e][1] + sum.y);
        const float gg = tanhf(x[e][2] + sum.z);
        const float og = sigmoid(x[e][3] + sum.w);
        const float c_new = fg * c_old[e] + ig * gg;
        const float h_new = og * tanhf(c_new);
        const bool valid = m[e] > 0.0f;
        cc[e] = valid ? c_new : c_old[e];
        hc[e] = valid ? h_new : h_old[e];
        y[e] = h_new * m[e];
        if (push)  // h.astype(U.dtype)
          hn[(size_t)(P.u0 + cj[e]) * LDH + cr[e]] = round_to<T>(hc[e]);
      }
    }
    if (push) {
      proxy_fence();
      __syncthreads();  // the block's slice of h_t complete
      X.push(smem_u32(hn + (size_t)P.u0 * LDH), slice_bytes, nb, CS, rank);
      load_inputs(s + 1);
    }

#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (cell[e]) {
        const int b = P.b0 + cr[e], u = P.u0 + cj[e];
        W.out[((size_t)b * T_len + t) * a.out_ld + u] = from_f32<T>(y[e]);
        if (W.hprev != nullptr) {
          const size_t r = ((size_t)t * B + b) * H + u;
          W.hprev[r] = from_f32<T>(h_old[e]);
          W.cprev[r] = c_old[e];
        }
      }
    }
  }
}

// bfloat16 shared memory, in bytes: the two barriers (16 bytes), two
// buffers of h as bf16 [kp][8 NT] (kp = H rounded up to 32: whole
// ldmatrix.x4 reads), then each warp's gate sums [kg][ng][NT][8][32 lanes]
// float32
struct Bf16Smem {
  int kp, ng, kg, ldh;
  size_t h, part, total;
  __host__ __device__ Bf16Smem(int H, int njmax, int NT)
      : kp((H + 31) / 32 * 32), ng((njmax + kGroupUnits - 1) / kGroupUnits),
        kg(((H + 15) / 16 + kWarpKSteps - 1) / kWarpKSteps), ldh(8 * NT),
        h(16), part(h + (size_t)2 * kp * ldh * sizeof(bf16)),
        total(part + (size_t)kg * ng * NT * 32 * 8 * sizeof(float)) {}
};

// NT n8 tiles of rows: 8 NT rows a cluster at most
template <int kWarps, int NT>
__global__ void __launch_bounds__(kWarps * 32, 1)
lstm_fwd_bf16(const FwdArgs<bf16> a) {
  constexpr int LDH = 8 * NT, NR = 2 * NT;  // rows of a lane
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int B = a.B, T_len = a.T_len, H = a.H, CS = a.CS;
  const ClusterShare P(H, B, CS, a.rows, a.cpd, (int)rank);
  const Walk<bf16> W(a, P.dir);
  const float* __restrict__ mask = a.mask;
  const Bf16Smem L(H, P.njmax, NT);
  const int H4 = 4 * H, tid = threadIdx.x;
  extern __shared__ float4 smem_raw[];
  char* base = reinterpret_cast<char*>(smem_raw);
  bf16* hs = reinterpret_cast<bf16*>(base + L.h);  // [2][kp][LDH]
  float* part = reinterpret_cast<float*>(base + L.part);
  Exchange X(reinterpret_cast<unsigned long long*>(smem_raw),
             (unsigned)((H - P.nj) * LDH * sizeof(bf16)), T_len);
  const unsigned slice_bytes = (unsigned)(P.nj * LDH * sizeof(bf16));
  const int warp = tid >> 5, lane = tid & 31;
  const int ug = warp % L.ng, kg = warp / L.ng;  // unit group, k-range
  const int gq = lane >> 2, c2 = 2 * (lane & 3);
  const int jj = kGroupUnits * ug + gq;
  const bool unit_ok = jj < P.nj;
  const int u = P.u0 + jj;
  const int ks0 = kg * kWarpKSteps;
  const int nks = min(kWarpKSteps, (H + 15) / 16 - ks0);

  // U's columns of the warp's units as A fragments [k-step][tile][4]:
  // a[i] is row gq (i even) or gq + 8 (i odd) of the tile, i.e. gate
  // 2 tile + (i & 1) of unit jj, at k = 16 ks + c2 (+ 8 for i >= 2) and
  // the next k; zero past H and for absent units
  unsigned af[kWarpKSteps][2][4];
#pragma unroll
  for (int ks = 0; ks < kWarpKSteps; ++ks)
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 16 * (ks0 + ks) + c2 + 8 * (i >> 1);
        float lo = 0.0f, hi = 0.0f;
        if (ks < nks && unit_ok) {
          const bf16* col = W.U + (size_t)(2 * tile + (i & 1)) * H + u;
          if (k < H) lo = to_f32<bf16>(col[(size_t)k * H4]);
          if (k + 1 < H) hi = to_f32<bf16>(col[(size_t)(k + 1) * H4]);
        }
        af[ks][tile][i] = pack_bf16x2(lo, hi);
      }
  for (int i = tid; i < 2 * L.kp * LDH; i += blockDim.x)
    hs[i] = __float2bfloat16_rn(0.0f);

  // the cell updates of unit u, float32 carries in registers. The lane's
  // rows: row(e) = c2 + (e & 1) + 8 (e >> 1), e < NR. Where two or more
  // warps share a unit group, the first two split them (own(e) for e & 1
  // == kg), else the only one takes all.
  const bool split = L.kg >= 2;
  const bool cell = unit_ok && kg < (split ? 2 : 1);
  auto own = [&](int e) { return cell && (!split || (e & 1) == kg); };
  auto row = [&](int e) { return c2 + (e & 1) + 8 * (e >> 1); };
  float hc[NR], cc[NR];
#pragma unroll
  for (int e = 0; e < NR; ++e) hc[e] = cc[e] = 0.0f;
  // this step's cell inputs, loaded a step ahead (as bf16: converted when
  // used)
  bf16 xn[NR][4];
  float mn[NR];
  auto load_inputs = [&](int s) {
    const int t = W.reverse ? T_len - 1 - s : s;
#pragma unroll
    for (int e = 0; e < NR; ++e) {
      mn[e] = 0.0f;
#pragma unroll
      for (int g = 0; g < 4; ++g) xn[e][g] = __float2bfloat16_rn(0.0f);
      if (own(e) && row(e) < P.nrows) {
        const size_t bt = (size_t)(P.b0 + row(e)) * T_len + t;
        const bf16* xrow = W.xp + bt * H4 + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) xn[e][g] = xrow[g * H];
        mn[e] = mask[bt];
      }
    }
  };
  load_inputs(0);

  cluster.sync();  // barriers set up and h zeroed in every block

  for (int s = 0; s < T_len; ++s) {
    const int t = W.reverse ? T_len - 1 - s : s;
    float x[NR][4], m[NR];
#pragma unroll
    for (int e = 0; e < NR; ++e) {
      m[e] = mn[e];
#pragma unroll
      for (int g = 0; g < 4; ++g) x[e][g] = to_f32<bf16>(xn[e][g]);
    }
    if (s > 0) X.wait(s);  // the peers' h_{t-1} in buffer s & 1
    const bf16* hb = hs + (size_t)(s & 1) * L.kp * LDH;
    float d[NT][2][2][4] = {};  // [n8 tile][tile][k-step parity][fragment]
#pragma unroll
    for (int kk = 0; kk < kWarpKSteps / 2; ++kk) {
      if (2 * kk < nks) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          // B fragments of k-steps ks0 + 2 kk and the next: rows k of h,
          // the n8 tile's rows as columns
          unsigned b[4];
          ldsm_x4_trans(b, hb + (size_t)(16 * (ks0 + 2 * kk) + lane) * LDH +
                               8 * n);
#pragma unroll
          for (int tile = 0; tile < 2; ++tile)
            mma_bf16_16816(d[n][tile][0], af[2 * kk][tile], b[0], b[1]);
          if (2 * kk + 1 < nks) {
#pragma unroll
            for (int tile = 0; tile < 2; ++tile)
              mma_bf16_16816(d[n][tile][1], af[2 * kk + 1][tile], b[2], b[3]);
          }
        }
      }
    }
    {
      float* pl = part + ((size_t)kg * L.ng + ug) * NT * 8 * 32 + lane;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int tile = 0; tile < 2; ++tile)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pl[(8 * n + 4 * tile + i) * 32] = d[n][tile][0][i] + d[n][tile][1][i];
    }
    __syncthreads();  // every warp's sums; every thread past the wait
    X.rearm(s);

    const bool push = s + 1 < T_len;  // nobody reads the last step's h
    const int nb = (s + 1) & 1;
    float h_old[NR], c_old[NR], y[NR];
    if (cell) {
      float gs[NT][2][4] = {};  // [n8 tile][tile][fragment]: k-ranges in order
      for (int k = 0; k < L.kg; ++k) {
        const float* pk = part + ((size_t)k * L.ng + ug) * NT * 8 * 32 + lane;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int tile = 0; tile < 2; ++tile)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              gs[n][tile][i] += pk[(8 * n + 4 * tile + i) * 32];
      }
      // fragment e of tile 0 of n8 tile n is gate i of row 8 n + c2 + e,
      // 2 + e gate f; tile 1 likewise gates g and o
#pragma unroll
      for (int e = 0; e < NR; ++e) {
        const int n = e >> 1, f = e & 1;
        h_old[e] = hc[e];
        c_old[e] = cc[e];
        y[e] = 0.0f;
        if (own(e)) {
          const float ig = sigmoid(x[e][0] + gs[n][0][f]);
          const float fg = sigmoid(x[e][1] + gs[n][0][2 + f]);
          const float gg = tanhf(x[e][2] + gs[n][1][f]);
          const float og = sigmoid(x[e][3] + gs[n][1][2 + f]);
          const float c_new = fg * c_old[e] + ig * gg;
          const float h_new = og * tanhf(c_new);
          const bool valid = m[e] > 0.0f;  // absent rows: m = 0, carries 0
          cc[e] = valid ? c_new : c_old[e];
          hc[e] = valid ? h_new : h_old[e];
          y[e] = h_new * m[e];
          if (push)  // h.astype(U.dtype)
            hs[(size_t)nb * L.kp * LDH + (size_t)u * LDH + row(e)] =
                __float2bfloat16_rn(hc[e]);
        }
      }
    }
    if (push) {
      proxy_fence();
      __syncthreads();  // the block's slice of h_t complete
      X.push(smem_u32(hs + (size_t)nb * L.kp * LDH + (size_t)P.u0 * LDH),
             slice_bytes, nb, CS, rank);
      load_inputs(s + 1);
    }

    if (cell) {
#pragma unroll
      for (int e = 0; e < NR; ++e) {
        if (own(e) && row(e) < P.nrows) {
          const int b = P.b0 + row(e);
          W.out[((size_t)b * T_len + t) * a.out_ld + u] =
              __float2bfloat16_rn(y[e]);
          if (W.hprev != nullptr) {
            const size_t r = ((size_t)t * B + b) * H + u;
            W.hprev[r] = __float2bfloat16_rn(h_old[e]);
            W.cprev[r] = c_old[e];
          }
        }
      }
    }
  }
}

// The walk past the shared-memory forms (see the header): a cluster of CS
// blocks walks one row of one direction; the threads of a block loop over
// its units.
template <typename T>
__global__ void __launch_bounds__(kF32Threads, 1)
lstm_fwd_big(const FwdArgs<T> a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int B = a.B, T_len = a.T_len, H = a.H, CS = a.CS;
  const ClusterShare P(H, B, CS, 1, a.cpd, (int)cluster.block_rank());
  const Walk<T> W(a, P.dir);
  const float* __restrict__ mask = a.mask;
  const int H4 = 4 * H, tid = threadIdx.x, b = P.b0;
  extern __shared__ float4 smem_raw[];
  float* hcar = reinterpret_cast<float*>(smem_raw);  // [njmax] carries
  float* ccar = hcar + P.njmax;
  float* hb = a.hg + (size_t)(blockIdx.x / CS) * 2 * H;  // [2][H]
  for (int j = tid; j < P.nj; j += kF32Threads) {
    hcar[j] = ccar[j] = 0.0f;
    hb[P.u0 + j] = 0.0f;  // h before the first step
  }
  cluster_arrive();
  cluster_wait();
  for (int s = 0; s < T_len; ++s) {
    const int t = W.reverse ? T_len - 1 - s : s;
    const float* hp = hb + (size_t)(s & 1) * H;  // h_{t-1}, all units
    float* hn = hb + (size_t)((s + 1) & 1) * H;
    const size_t bt = (size_t)b * T_len + t;
    const float m = mask[bt];
    for (int j = tid; j < P.nj; j += kF32Threads) {
      const int u = P.u0 + j;
      const T* uc = W.U + u;
      float g4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k = 0; k < H; ++k) {  // in order of k
        const float h = __ldcg(hp + k);
        const T* ur = uc + (size_t)k * H4;
#pragma unroll
        for (int g = 0; g < 4; ++g) g4[g] = fmaf(h, to_f32<T>(ur[g * H]), g4[g]);
      }
      const T* xrow = W.xp + bt * H4 + u;
      const float ig = sigmoid(to_f32<T>(xrow[0]) + g4[0]);
      const float fg = sigmoid(to_f32<T>(xrow[H]) + g4[1]);
      const float gg = tanhf(to_f32<T>(xrow[2 * H]) + g4[2]);
      const float og = sigmoid(to_f32<T>(xrow[3 * H]) + g4[3]);
      const float h_old = hcar[j], c_old = ccar[j];
      const float c_new = fg * c_old + ig * gg;
      const float h_new = og * tanhf(c_new);
      const bool valid = m > 0.0f;
      hcar[j] = valid ? h_new : h_old;
      ccar[j] = valid ? c_new : c_old;
      hn[u] = round_to<T>(hcar[j]);  // h.astype(U.dtype)
      W.out[bt * a.out_ld + u] = from_f32<T>(h_new * m);
      if (W.hprev != nullptr) {
        const size_t r = ((size_t)t * B + b) * H + u;
        W.hprev[r] = from_f32<T>(h_old);
        W.cprev[r] = c_old;
      }
    }
    cluster_arrive();  // this block's h_t written, its reads of h_{t-1} done
    cluster_wait();
  }
}

template <typename Kernel, typename A>
int launch_plan(Kernel kernel, const ClusterPlan& p, A a,
                cudaStream_t stream) {
  int rc = set_cluster_attrs(kernel, p.cs, p.smem);
  if (rc != 0) return rc;
  a.CS = p.cs;
  a.rows = p.rows;
  a.cpd = p.cpd;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(&attr, p, stream);
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e == cudaSuccess) e = cudaGetLastError();
  return e;
}

// the CUDA-core walk's instance for the plan's rows (1 .. kCcRows, or 1 ..
// kRows reading U from L2)
template <typename T, bool kUL2, int... I>
int launch_cc(const ClusterPlan& p, const FwdArgs<T>& a, int ndir,
              cudaStream_t s, std::integer_sequence<int, I...>) {
  using Kernel = void (*)(const FwdArgs<T>);
  static constexpr Kernel kOne[] = {lstm_fwd_cc<T, I + 1, kUL2, false>...};
  static constexpr Kernel kTwo[] = {lstm_fwd_cc<T, I + 1, kUL2, true>...};
  return launch_plan((ndir == 2 ? kTwo : kOne)[p.rows - 1], p, a, s);
}

// The CUDA-core walk with U's columns in shared memory (8 rows a cluster
// must fit), else (no cluster of it fits) read from L2 (a cluster of 16
// may take fewer rows).
template <typename T, bool kUL2>
int dispatch_cc_form(const FwdArgs<T>& a, int ndir, cudaStream_t stream) {
  constexpr int kMax = kUL2 ? kRows : kCcRows;
  const int H = a.H;
  ClusterPlan p;
  // occupancy from the launch's own kind of instance (registers differ)
  int rc = plan_clusters(ndir == 2 ? lstm_fwd_cc<T, kMax, kUL2, true>
                                   : lstm_fwd_cc<T, kMax, kUL2, false>,
                         a.B, H, ndir, 1, kRows,
                         kUL2 ? 1 : kRows, kMax,
                         [H](int cs, int r, int* threads, size_t* smem) {
                           const int njmax = (H + cs - 1) / cs;
                           const F32Smem L(H, njmax, r, kUL2);
                           *threads = kF32Threads;
                           *smem = L.total * sizeof(float);
                           return njmax * r <= 2 * kF32Threads;
                         }, &p);
  if (rc != 0) return rc;
  return launch_cc<T, kUL2>(p, a, ndir, stream,
                            std::make_integer_sequence<int, kMax>{});
}

template <typename T>
int dispatch_cc(const FwdArgs<T>& a, int ndir, cudaStream_t stream) {
  int rc = dispatch_cc_form<T, false>(a, ndir, stream);
  if (rc != kErrNoCluster) return rc;
  rc = dispatch_cc_form<T, true>(a, ndir, stream);
  if (rc != kErrNoCluster) return rc;
  // one row a cluster, h through global memory
  const int H = a.H;
  ClusterPlan p;
  rc = plan_clusters(lstm_fwd_big<T>, a.B, H, ndir, 1, 1, 1, 1,
                     [H](int cs, int r, int* threads, size_t* smem) {
                       *threads = kF32Threads;
                       *smem = 2 * (size_t)((H + cs - 1) / cs) * sizeof(float);
                       return r == 1;
                     }, &p);
  if (rc != 0) return rc;
  return launch_plan(lstm_fwd_big<T>, p, a, stream);
}

// one n8 tile of rows where the plan's rows allow, else two
template <int kWarps>
int launch_bf16(const FwdArgs<bf16>& a, int ndir, cudaStream_t stream) {
  const int H = a.H;
  ClusterPlan p;
  int rc = plan_clusters(lstm_fwd_bf16<kWarps, 2>, a.B, H, ndir, kRows,
                         kRows, kRows, kBf16Rows,
                         [H](int cs, int r, int* threads, size_t* smem) {
                           const Bf16Smem L(H, (H + cs - 1) / cs,
                                            r > kRows ? 2 : 1);
                           *threads = 32 * L.ng * L.kg;
                           *smem = L.total;
                           return L.ng * L.kg <= kWarps;
                         }, &p);
  if (rc != 0) return rc;
  if (p.rows > kRows)
    return launch_plan(lstm_fwd_bf16<kWarps, 2>, p, a, stream);
  return launch_plan(lstm_fwd_bf16<kWarps, 1>, p, a, stream);
}

// the 8-warp kernel where its blocks can hold the hidden units (every H up
// to 256), else the 16-warp one: a launch bound of 512 threads leaves a
// thread 128 registers, and the walk then spills (the 8-warp kernel ran
// 12% faster at H = 256)
int dispatch_bf16(const FwdArgs<bf16>& a, int ndir, cudaStream_t stream) {
  int rc = launch_bf16<kBf16Warps>(a, ndir, stream);
  if (rc != kErrNoCluster) return rc;
  rc = launch_bf16<kBf16MaxWarps>(a, ndir, stream);
  if (rc != kErrNoCluster) return rc;
  // U's fragments do not fit 16 warps' registers (H above 512): the
  // CUDA-core walk
  return dispatch_cc<bf16>(a, ndir, stream);
}

template <typename T>
int dispatch(const FwdArgs<T>& a, int ndir, cudaStream_t stream) {
  if (a.B < 1 || a.T_len < 1 || a.H < 1) return cudaErrorInvalidValue;
  if constexpr (std::is_same_v<T, float>) return dispatch_cc<float>(a, ndir, stream);
  else return dispatch_bf16(a, ndir, stream);
}

template <typename T>
int forward(const void* xp, const void* U, const void* mask, void* out,
            void* hprev, void* cprev, void* hg, int B, int T_len, int H,
            int reverse, cudaStream_t stream) {
  FwdArgs<T> a = {};
  a.d[0] = {static_cast<const T*>(xp), static_cast<const T*>(U),
            static_cast<T*>(hprev), static_cast<float*>(cprev), reverse, 0};
  a.d[1] = a.d[0];
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<T*>(out);
  a.hg = static_cast<float*>(hg);
  a.out_ld = H;
  a.B = B;
  a.T_len = T_len;
  a.H = H;
  return dispatch<T>(a, 1, stream);
}

template <typename T>
int bi_forward(const void* xpf, const void* xpb, const void* Uf,
               const void* Ub, const void* mask, void* y, void* hpf,
               void* cpf, void* hpb, void* cpb, void* hg, int B, int T_len,
               int H, cudaStream_t stream) {
  FwdArgs<T> a = {};
  a.d[0] = {static_cast<const T*>(xpf), static_cast<const T*>(Uf),
            static_cast<T*>(hpf), static_cast<float*>(cpf), 0, 0};
  a.d[1] = {static_cast<const T*>(xpb), static_cast<const T*>(Ub),
            static_cast<T*>(hpb), static_cast<float*>(cpb), 1, H};
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<T*>(y);
  a.hg = static_cast<float*>(hg);
  a.out_ld = 2 * H;
  a.B = B;
  a.T_len = T_len;
  a.H = H;
  return dispatch<T>(a, 2, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xp, U, out and hprev share it).
// hprev/cprev null: the inference form; both set: the residual form. hg:
// float32 scratch of 2 B H (the widest H's exchange of h). Returns 0, a
// cudaError_t value or kErrDtype (common.cuh).
int pgasr_lstm_fwd(const void* xp, const void* U, const void* mask,
                   void* out, void* hprev, void* cprev, void* hg, int B,
                   int T_len, int H, int reverse, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((hprev == nullptr) != (cprev == nullptr)) return cudaErrorInvalidValue;
  if (dtype == 0)
    return forward<float>(xp, U, mask, out, hprev, cprev, hg, B, T_len, H,
                          reverse, s);
  if (dtype == 1)
    return forward<bf16>(xp, U, mask, out, hprev, cprev, hg, B, T_len, H,
                         reverse, s);
  return kErrDtype;
}

// Both directions of a layer in one launch: y (B, T, 2H); the residuals
// hpf, cpf, hpb, cpb all null (inference form) or all set; hg: float32
// scratch of 4 B H. The same returns as pgasr_lstm_fwd.
int pgasr_bilstm_fwd(const void* xpf, const void* xpb, const void* Uf,
                     const void* Ub, const void* mask, void* y, void* hpf,
                     void* cpf, void* hpb, void* cpb, void* hg, int B,
                     int T_len, int H, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int set = (hpf != nullptr) + (cpf != nullptr) + (hpb != nullptr) +
                  (cpb != nullptr);
  if (set != 0 && set != 4) return cudaErrorInvalidValue;
  if (dtype == 0)
    return bi_forward<float>(xpf, xpb, Uf, Ub, mask, y, hpf, cpf, hpb, cpb,
                             hg, B, T_len, H, s);
  if (dtype == 1)
    return bi_forward<bf16>(xpf, xpb, Uf, Ub, mask, y, hpf, cpf, hpb, cpb,
                            hg, B, T_len, H, s);
  return kErrDtype;
}

const char* pgasr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
