// Segment-masked multi-head attention forward (flash attention) for Hopper
// (sm_90a), one block per (query tile, head, batch row).
//
// Replaces the TPU kernel that pg_asr_tpu/ops/flash_attn.py:mhsa reaches:
// JAX's library Pallas TPU flash attention forward
// (jax/experimental/pallas/ops/tpu/flash_attention.py, _flash_attention_impl
// and its pallas_call), called with SegmentIds(q=seg, kv=seg), seg = the
// validity mask as int. Its plain version is
// pg_asr_tpu_torch/ops/flash_attn.py:mhsa_plain. Contract:
//   q, k, v  (B, H, T, dh) float32 or bfloat16, any (batch, head, time)
//            strides in elements, the dh axis contiguous (so q, k, v can be
//            read in place from a fused (B, T, 3, H, dh) projection); rows
//            of whole 16-byte vectors (start, strides and dh) are read by
//            16-byte cp.async, any others element by element
//   seg      (B, T) int32, contiguous; query i attends key j iff
//            seg[b, i] == seg[b, j] (a padded query attends the padded keys)
//   o        (B, H, T, dh) in q's type, strides as given
//   l, m     (B, H, T) float32, contiguous, or both null: the residual form
//            (the library's save_residuals, which its backward reads) also
//            writes the row sum l and row max m of every row < T; null
//            pointers keep the inference form
//   dh in 1 .. 128, on the template instance for 32, 64 or 128 next up
//   (its columns past dh zero-filled as the tiles load: a zero column
//   changes no score and no output; only the first dh are written); dh
//   from 129 on the wide kernel (below: CUDA cores, float32 math in both
//   types, the library's rounding of p; past 256 in pieces of 256); any T
//   >= 1.
//
// Numerics, as the Pallas kernel: s = (q . k accumulated in float32) *
// scale, plus -0.7 * FLT_MAX where the segments differ (an additive mask,
// not -inf); the softmax runs online in float32 over key tiles (running max
// m and sum l per row, old sums rescaled by exp(m_old - m_new)); p =
// exp(s - m) is rounded to v's type before the p . v product, which
// accumulates in float32; l sums p before that rounding; the output is
// acc * (l == 0 ? 1 : 1 / l). Keys beyond T do not exist for the softmax
// (-inf, p = 0). Every query row < T is written, padded rows included.
//
// Skipped tile pairs. A (query tile, key tile) pair whose rows' segment-id
// ranges are disjoint (flash_tiles.cuh tile_flags, the rule of
// ops/flash_attn.py kept_tile_pairs) is not walked: every score of it
// carries the mask, and skipping it changes no bit. Walked after a tile
// with a real key, such a tile would contribute exp(-0.7 * FLT_MAX + s -
// m) = 0 to l and acc with alpha = exp(0) = 1; walked before one, its sums
// would be erased when alpha = exp(m_old - m_new) underflows to exactly 0,
// as the zero sums of a row that has seen no tile are (alpha = exp(-inf)).
// Every row < T has a real key, itself, in its own tile, which is always
// walked; so m, l and the output are those of the walk over every tile.
//
// What bounds it on this card: at the conformer's shapes (B=64, H=4,
// T'=201, dh=64, 13.87% of the 64 x 64 tile pairs empty) one call is ~1.8
// GFLOP on the pairs the mask leaves over ~26 MB in bfloat16 (~52 MB in
// float32): the bytes bound bfloat16 (~8 us at 3.35 TB/s; the products
// are a few microseconds of tensor-core time and the ~10 M exp a few of
// the SFUs'), the operations float32 (~27 us at 67 TFLOP/s on the CUDA
// cores). At 4 key tiles per block, latency and the chain of each warp's
// instructions bound both long before either.
//
// bfloat16, on the tensor cores: 4 warps, each owning 16 query rows, whose
// q fragments stay in registers for the whole walk. Both products are
// mma.sync m16n8k16 (bf16 operands, float32 accumulators): s = q . k^T
// from ldmatrix fragments of the key tile; the scale, the mask and the
// online softmax in registers, the row max and sum over the 4 lanes of a
// quad by shuffles; p = exp(s - m) packed from the s accumulators straight
// into the bf16 A fragment of p . v (so p rounds where the library rounds
// it and never touches shared memory), v read through ldmatrix.trans.
// The k, v tiles and the keys' segment ids are double-buffered: the next
// kept tile's cp.async is in flight while the current one is computed.
// MMAs whose 8 keys lie wholly beyond T are skipped. Tiles stay bf16 in
// shared memory, rows padded by 8 elements (no ldmatrix bank conflicts):
// 46 KB at dh=64; the launch bounds hold the registers to 3 blocks per SM
// (at 4, ptxas spilled 16 bytes and the kernel ran ~3% slower).
//
// float32, on the CUDA cores (TF32 would move the results past the bounds
// the port holds them to): 128 threads as 16 key lanes x 8 row groups;
// each thread owns 8 query rows (ty + 8 i) x 4 keys (tx + 16 j) of the
// score tile and the same 8 rows x dh/16 output columns, so a 16-byte
// shared-memory load feeds ~11 multiply-adds (8 at 4 x 4; 256 threads at
// 4 x 4 and 64 at 16 x 4 ran slower). The q tile stays in shared memory, k
// and v are double-buffered by 16-byte cp.async in their own type, p passes
// through shared memory between the two products. Each row's sums run in
// the order of the first kernel (s over dh in order, the row sum over a
// thread's 4 keys then a 16-lane butterfly, acc over the tile's keys in
// order), so with the skip changing no bit the float32 output, l and m
// keep that kernel's bits.

#include <math.h>

#include <cstdint>
#include <type_traits>

#include "flash_tiles.cuh"

namespace pgasr {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kF32Threads = 128;             // 16 key lanes x 8 row groups
constexpr int kMmaThreads = 32 * (kBT / 16);  // one warp per 16 query rows

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;
  void* o;
  float* l;  // residual form only, else null
  float* m;
  long long sq[3], sk[3], sv[3], so[3];  // (batch, head, time) strides
  int B, H, T;
  float scale;
  int dh;   // the head dim: columns dh .. DH - 1 of the instance are zeros
  int vec;  // q, k, v rows read by 16-byte cp.async (else element-wise)
};

template <typename T, int DH>
constexpr size_t smem_bytes() {
  if constexpr (std::is_same_v<T, float>)
    // the q tile and two buffers of k (rows padded by 4), two of v, the p
    // tile (rows padded by 4); two buffers of the keys' segment ids
    return ((size_t)3 * kBT * (DH + 4) + (size_t)2 * kBT * DH
            + (size_t)kBT * (kBT + 4) + (size_t)2 * kBT) * sizeof(float);
  else
    // the q tile and two buffers of k and of v (rows padded by 8); two
    // buffers of the keys' segment ids
    return (size_t)5 * kBT * (DH + 8) * sizeof(bf16)
           + (size_t)2 * kBT * sizeof(int);
}

// The block's rows and pointers, shared by both types.
template <typename T>
struct Block {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  const int* seg;
  int q0, Tn, n;
  long long row0;  // into l, m
  __device__ Block(const FlashArgs& a)
      : q(static_cast<const T*>(a.q) + blockIdx.z * a.sq[0]
          + blockIdx.y * a.sq[1]),
        k(static_cast<const T*>(a.k) + blockIdx.z * a.sk[0]
          + blockIdx.y * a.sk[1]),
        v(static_cast<const T*>(a.v) + blockIdx.z * a.sv[0]
          + blockIdx.y * a.sv[1]),
        o(static_cast<T*>(a.o) + blockIdx.z * a.so[0] + blockIdx.y * a.so[1]),
        seg(a.seg + (long long)blockIdx.z * a.T),
        q0(blockIdx.x * kBT), Tn(a.T), n((a.T + kBT - 1) / kBT),
        row0(((long long)blockIdx.z * a.H + blockIdx.y) * a.T) {}
};

// --- float32: CUDA cores ----------------------------------------------------

template <int DH, bool kExact>
__device__ __forceinline__ void fwd_f32(const FlashArgs& a) {
  // the instance itself (dh = DH, whole vectors): the checks fold away
  const int dh = kExact ? DH : a.dh;
  const bool vec = kExact || a.vec;
  constexpr int LDK = DH + 4, LDP = kBT + 4, CPT = DH / 16;
  constexpr int TY = kF32Threads / 16, RPT = kBT / TY, KPT = kBT / 16;
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBT * LDK;      // two buffers
  float* Vs = Ks + 2 * kBT * LDK;  // two buffers
  float* Ps = Vs + 2 * kBT * DH;
  int* segk = reinterpret_cast<int*>(Ps + kBT * LDP);  // two buffers
  unsigned char* kept = reinterpret_cast<unsigned char*>(segk + 2 * kBT);

  const Block<float> blk(a);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int Tn = blk.Tn, n = blk.n, q0 = blk.q0;

  load_tile_async<float, DH, LDK, kF32Threads>(Qs, blk.q, a.sq[2], q0, Tn, dh, vec);
  cp_async_commit();
  tile_flags<kF32Threads>(kept, blk.seg, q0, Tn);
  int segq[RPT];
  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = q0 + ty + TY * i;
    segq[i] = t < Tn ? blk.seg[t] : -1;  // rows beyond T: computed, not stored
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }
  __syncthreads();  // the flags

  // the first kept key tile into buffer 0 (the query tile meets itself)
  int kt = next_kept(kept, 0, n);
  load_tile_async<float, DH, LDK, kF32Threads>(Ks, blk.k, a.sk[2], kt * kBT,
                                               Tn, dh, vec);
  load_tile_async<float, DH, DH, kF32Threads>(Vs, blk.v, a.sv[2], kt * kBT,
                                              Tn, dh, vec);
  cp_async_commit();
  if (threadIdx.x < kBT) {
    const int t = kt * kBT + threadIdx.x;
    segk[threadIdx.x] = t < Tn ? blk.seg[t] : 0;
  }

  for (int buf = 0; kt < n; buf ^= 1) {
    const int nxt = next_kept(kept, kt + 1, n);
    // the next tile's segment ids, fetched now, stored after this tile
    const bool stage = nxt < n && threadIdx.x < kBT;
    const int tn = nxt * kBT + threadIdx.x;
    const int ns = stage && tn < Tn ? blk.seg[tn] : 0;
    cp_async_wait_all();
    __syncthreads();  // tile kt is in `buf`; the other buffer and p are free
    if (nxt < n) {
      load_tile_async<float, DH, LDK, kF32Threads>(
          Ks + (buf ^ 1) * kBT * LDK, blk.k, a.sk[2], nxt * kBT, Tn, dh, vec);
      load_tile_async<float, DH, DH, kF32Threads>(
          Vs + (buf ^ 1) * kBT * DH, blk.v, a.sv[2], nxt * kBT, Tn, dh, vec);
    }
    cp_async_commit();
    const float* Kb = Ks + buf * kBT * LDK;
    const float* Vb = Vs + buf * kBT * DH;
    const int* sk = segk + buf * kBT;
    const int k0 = kt * kBT;

    // scores of rows ty + TY i against keys tx + 16 j, q . k in float32
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < DH; c += 4) {
      float4 kv[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Kb[(tx + 16 * j) * LDK + c]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&Qs[(ty + TY * i) * LDK + c]);
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          float acc_s = s[i][j];
          acc_s = fmaf(qv.x, kv[j].x, acc_s);
          acc_s = fmaf(qv.y, kv[j].y, acc_s);
          acc_s = fmaf(qv.z, kv[j].z, acc_s);
          acc_s = fmaf(qv.w, kv[j].w, acc_s);
          s[i][j] = acc_s;
        }
      }
    }

    // scale, segment mask, online softmax; p into Ps (float32: no rounding)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kj = tx + 16 * j;
        float sv = s[i][j] * a.scale;
        sv += segq[i] == sk[kj] ? 0.0f : kMaskValue;
        s[i][j] = k0 + kj < Tn ? sv : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        Ps[(ty + TY * i) * LDP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p . v over the tile's keys (keys beyond T have p = 0, v = 0)
#pragma unroll 2
    for (int kk = 0; kk < kBT; kk += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + TY * i) * LDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vr[CPT];
        if constexpr (CPT % 4 == 0) {
#pragma unroll
          for (int c4 = 0; c4 < CPT; c4 += 4) {
            const float4 w = *reinterpret_cast<const float4*>(
                &Vb[(kk + u) * DH + CPT * tx + c4]);
            vr[c4] = w.x; vr[c4 + 1] = w.y; vr[c4 + 2] = w.z;
            vr[c4 + 3] = w.w;
          }
        } else {
          const float2 w =
              *reinterpret_cast<const float2*>(&Vb[(kk + u) * DH + 2 * tx]);
          vr[0] = w.x; vr[1] = w.y;
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vr[c], acc[i][c]);
        }
      }
    }

    if (stage) segk[(buf ^ 1) * kBT + threadIdx.x] = ns;
    kt = nxt;
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = q0 + ty + TY * i;
    if (t >= Tn) continue;
    const float inv = l[i] == 0.0f ? 1.0f : 1.0f / l[i];
    float* row = blk.o + (long long)t * a.so[2] + CPT * tx;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (CPT * tx + c < dh) row[c] = acc[i][c] * inv;
    if (a.l != nullptr && tx == 0) {  // every thread of the row holds both
      a.l[blk.row0 + t] = l[i];
      a.m[blk.row0 + t] = m[i];
    }
  }
}

// --- bfloat16: tensor cores -------------------------------------------------

template <int DH, bool kExact>
__device__ __forceinline__ void fwd_mma(const FlashArgs& a) {
  // the instance itself (dh = DH, whole vectors): the checks fold away
  const int dh = kExact ? DH : a.dh;
  const bool vec = kExact || a.vec;
  constexpr int LD = DH + 8, TILE = kBT * LD, NK = kBT / 8, ND = DH / 8,
                KQ = DH / 16;
  extern __shared__ float4 smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TILE;      // two buffers
  bf16* Vs = Ks + 2 * TILE;  // two buffers
  int* segk = reinterpret_cast<int*>(Vs + 2 * TILE);  // two buffers
  unsigned char* kept = reinterpret_cast<unsigned char*>(segk + 2 * kBT);

  const Block<bf16> blk(a);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const Lanes L(lane);
  const int Tn = blk.Tn, n = blk.n;

  load_tile_async<bf16, DH, LD, kMmaThreads>(Qs, blk.q, a.sq[2], blk.q0, Tn, dh, vec);
  cp_async_commit();
  tile_flags<kMmaThreads>(kept, blk.seg, blk.q0, Tn);

  // this warp's queries qw .. qw + 15; this lane's rows g and g + 8 of
  // them (rows beyond T are computed, not stored)
  const int qw = blk.q0 + 16 * warp;
  const bool warp_in = qw < Tn;
  int sr[2];
  float m[2], l[2], acc[ND][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = qw + g + 8 * r;
    sr[r] = t < Tn ? blk.seg[t] : -1;
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.0f;
  __syncthreads();  // the flags

  // the first kept key tile into buffer 0 (the query tile meets itself)
  int kt = next_kept(kept, 0, n);
  load_tile_async<bf16, DH, LD, kMmaThreads>(Ks, blk.k, a.sk[2], kt * kBT, Tn, dh, vec);
  load_tile_async<bf16, DH, LD, kMmaThreads>(Vs, blk.v, a.sv[2], kt * kBT, Tn, dh, vec);
  cp_async_commit();
  if (threadIdx.x < kBT) {
    const int t = kt * kBT + threadIdx.x;
    segk[threadIdx.x] = t < Tn ? blk.seg[t] : 0;
  }
  // this warp's q fragments, kept for the whole walk
  unsigned qf[KQ][4];
  cp_async_wait_all();
  __syncthreads();  // the q tile
#pragma unroll
  for (int kq = 0; kq < KQ; ++kq)
    ldsm_x4(qf[kq], Qs + (16 * warp + L.arow) * LD + L.acol + 16 * kq);

  for (int buf = 0; kt < n; buf ^= 1) {
    const int nxt = next_kept(kept, kt + 1, n);
    // the next tile's segment ids, fetched now, stored after this tile
    const bool stage = nxt < n && threadIdx.x < kBT;
    const int tn = nxt * kBT + threadIdx.x;
    const int ns = stage && tn < Tn ? blk.seg[tn] : 0;
    cp_async_wait_all();
    __syncthreads();  // tile kt is in `buf`; the other buffer is free
    if (nxt < n) {
      load_tile_async<bf16, DH, LD, kMmaThreads>(Ks + (buf ^ 1) * TILE, blk.k,
                                                 a.sk[2], nxt * kBT, Tn, dh, vec);
      load_tile_async<bf16, DH, LD, kMmaThreads>(Vs + (buf ^ 1) * TILE, blk.v,
                                                 a.sv[2], nxt * kBT, Tn, dh, vec);
    }
    cp_async_commit();

    if (warp_in) {
      const bf16* Kb = Ks + buf * TILE;
      const bf16* Vb = Vs + buf * TILE;
      const int* sk = segk + buf * kBT;
      const int k0 = kt * kBT;
      // s = q . k^T: this warp's 16 queries x the tile's keys, n-tile j =
      // keys 8 j ..
      float s[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
#pragma unroll
        for (int j = 0; j < NK; j += 2) {
          unsigned bk[4];
          ldsm_x4(bk, Kb + (8 * j + L.brow) * LD + 16 * kq + L.bcol);
          if (k0 + 8 * j < Tn) mma_bf16_16816(s[j], qf[kq], bk[0], bk[1]);
          if (k0 + 8 * j + 8 < Tn)
            mma_bf16_16816(s[j + 1], qf[kq], bk[2], bk[3]);
        }
      }
      // scale and mask; element e of n-tile j: row g + 8 (e / 2), key
      // 8 j + c2 + e % 2
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int col = 8 * j + c2;
        const int2 sj = *reinterpret_cast<const int2*>(sk + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          float sv = s[j][e] * a.scale;
          sv += sr[e >> 1] == (odd ? sj.y : sj.x) ? 0.0f : kMaskValue;
          s[j][e] = k0 + col + odd < Tn ? sv : -INFINITY;
          mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
        }
      }
      // the online softmax over the quad's 4 lanes; p rounded to bf16 pairs
      // in the A-fragment layout of p . v: n-tiles 2 u and 2 u + 1 make
      // k-step u
      float alpha[2], m_new[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        m_new[r] = fmaxf(m[r], mt[r]);
        alpha[r] = expf(m[r] - m_new[r]);  // 0 on the first tile
      }
      unsigned pa[NK / 2][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = expf(s[j][e] - m_new[e >> 1]);
          ps[e >> 1] += p[e];
        }
        pa[j >> 1][2 * (j & 1)] = pack_bf16x2(p[0], p[1]);
        pa[j >> 1][2 * (j & 1) + 1] = pack_bf16x2(p[2], p[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
        ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
        l[r] = alpha[r] * l[r] + ps[r];
        m[r] = m_new[r];
      }
#pragma unroll
      for (int d = 0; d < ND; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][e] *= alpha[e >> 1];
      // acc += p . v over the tile's keys below T; n-tile d = columns 8 d ..
#pragma unroll
      for (int u = 0; u < NK / 2; ++u) {
        if (k0 + 16 * u >= Tn) break;
        const bf16* vr = Vb + (16 * u + L.trow) * LD + L.tcol;
#pragma unroll
        for (int d = 0; d < ND; d += 2) {
          unsigned bv[4];
          ldsm_x4_trans(bv, vr + 8 * d);
          mma_bf16_16816(acc[d], pa[u], bv[0], bv[1]);
          mma_bf16_16816(acc[d + 1], pa[u], bv[2], bv[3]);
        }
      }
    }

    if (stage) segk[(buf ^ 1) * kBT + threadIdx.x] = ns;
    kt = nxt;
  }

  if (!warp_in) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = qw + g + 8 * r;
    if (t >= Tn) continue;
    const float inv = l[r] == 0.0f ? 1.0f : 1.0f / l[r];
    bf16* row = blk.o + (long long)t * a.so[2];
#pragma unroll
    for (int d = 0; d < ND; ++d)
      store_pair(row, c2 + 8 * d, acc[d][2 * r] * inv,
                 acc[d][2 * r + 1] * inv, dh, vec);
    if (a.l != nullptr && (lane & 3) == 0) {  // the quad holds both
      a.l[blk.row0 + t] = l[r];
      a.m[blk.row0 + t] = m[r];
    }
  }
}

// --- head dims past 128: the wide kernel, CUDA cores, float32 math ----------

constexpr int kWideRows = 16;  // query rows of a block: 4 a warp
constexpr int kWideThreads = 128;

size_t wide_smem_bytes() {
  // the q tile, the k and v tiles, the keys' segment ids
  return ((size_t)(kWideRows + 2 * kWideKeys) * kWideLd + kWideKeys)
         * sizeof(float);
}

// The forward for dh past 128: warp w owns query rows 4 w .. 4 w + 3 of
// the block's 16; per key tile of 32 (a lane each) the scores over dh in
// order, the online softmax by warp shuffles, p rounded to v's type (as
// the library rounds it) and broadcast by shuffles to lanes that own
// output columns lane + 32 i. Past kWideDh the head dim is cut in pieces
// of kWideDh: each block writes one piece of the output (grid x = query
// tile x pieces) and sums q . k over all pieces in order, reloading the q
// and k tiles a piece at a time; every block of a query tile computes the
// same scores, so the pieces' softmax statistics agree bit for bit.
template <typename T, bool kPieces>
__global__ void __launch_bounds__(kWideThreads)
flash_attn_wide_kernel(const FlashArgs a) {
  constexpr int CPL = kWideDh / 32;  // output columns of a lane
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [kWideRows][kWideLd]
  float* Ks = Qs + kWideRows * kWideLd;            // [kWideKeys][kWideLd]
  float* Vs = Ks + kWideKeys * kWideLd;            // [kWideKeys][kWideLd]
  int* segk = reinterpret_cast<int*>(Vs + kWideKeys * kWideLd);

  const Block<T> blk(a);  // its pointers; the rows are the block's own
  const int Tn = blk.Tn, dh = a.dh;
  // pieces of the head dim (one up to kWideDh: the loops fold away)
  const int np = kPieces ? (dh + kWideDh - 1) / kWideDh : 1;
  const int pc = blockIdx.x % np, q0 = blockIdx.x / np * kWideRows;
  const int oc = pc * kWideDh, on = min(kWideDh, dh - oc);  // output piece
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (np == 1) load_wide<T>(Qs, blk.q, a.sq[2], q0, kWideRows, Tn, dh,
                            kWideThreads);
  int segq[4];
  float m[4], l[4], acc[4][CPL];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + 4 * warp + r;
    segq[r] = t < Tn ? blk.seg[t] : -1;
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[r][i] = 0.0f;
  }
  const float* qr = Qs + 4 * warp * kWideLd;
  const float* kr = Ks + lane * kWideLd;
  for (int k0 = 0; k0 < Tn; k0 += kWideKeys) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int p = 0; p < np; ++p) {  // q . k over the pieces in order
      const int c0 = p * kWideDh, cn = min(kWideDh, dh - c0);
      __syncthreads();  // the previous tile or piece consumed
      if (np > 1)
        load_wide<T>(Qs, blk.q + c0, a.sq[2], q0, kWideRows, Tn, cn,
                     kWideThreads);
      load_wide<T>(Ks, blk.k + c0, a.sk[2], k0, kWideKeys, Tn, cn,
                   kWideThreads);
      if (p == np - 1)
        load_wide<T>(Vs, blk.v + oc, a.sv[2], k0, kWideKeys, Tn, on,
                     kWideThreads);
      if (p == 0 && threadIdx.x < kWideKeys) {
        const int t = k0 + threadIdx.x;
        segk[threadIdx.x] = t < Tn ? blk.seg[t] : 0;
      }
      __syncthreads();
      for (int d = 0; d < cn; ++d) {
        const float kv = kr[d];
#pragma unroll
        for (int r = 0; r < 4; ++r) s[r] = fmaf(qr[r * kWideLd + d], kv, s[r]);
      }
    }
    const bool key_in = k0 + lane < Tn;
    const int sk = segk[lane];
    float pr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float sv = s[r] * a.scale + (segq[r] == sk ? 0.0f : kMaskValue);
      sv = key_in ? sv : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float alpha = expf(m[r] - m_new);  // 0 on the first tile
      const float p = expf(sv - m_new);
      l[r] = alpha * l[r] + warp_sum(p);
      m[r] = m_new;
      pr[r] = round_to<T>(p);
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[r][i] *= alpha;
    }
    // acc += p . v over the tile's keys in order (zero past T)
    for (int kk = 0; kk < kWideKeys; ++kk) {
      float pk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pk[r] = __shfl_sync(0xffffffffu, pr[r], kk);
      const float* vr = Vs + kk * kWideLd + lane;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const float v = vr[32 * i];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][i] = fmaf(pk[r], v, acc[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + 4 * warp + r;
    if (t >= Tn) continue;
    const float inv = l[r] == 0.0f ? 1.0f : 1.0f / l[r];
    T* row = blk.o + (long long)t * a.so[2] + oc;
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      if (lane + 32 * i < on) row[lane + 32 * i] = from_f32<T>(acc[r][i] * inv);
    if (a.l != nullptr && pc == 0 && lane == 0) {
      a.l[blk.row0 + t] = l[r];
      a.m[blk.row0 + t] = m[r];
    }
  }
}

template <typename T>
int launch_wide(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes();
  const int pieces = (a.dh + kWideDh - 1) / kWideDh;
  auto kernel = pieces > 1 ? flash_attn_wide_kernel<T, true>
                           : flash_attn_wide_kernel<T, false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.T + kWideRows - 1) / kWideRows * pieces, a.H, a.B);
  kernel<<<grid, kWideThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// --- the kernel and its launch -----------------------------------------------

// threads per block and the blocks per SM the registers are held to (the
// dh = 128 instances: the shared memory fits one f32 block, two bf16)
template <typename T, int DH> struct Cfg;
template <int DH> struct Cfg<float, DH> {
  static constexpr int kThreads = kF32Threads, kBlocks = DH <= 64 ? 2 : 1;
};
template <int DH> struct Cfg<bf16, DH> {
  static constexpr int kThreads = kMmaThreads, kBlocks = DH <= 64 ? 3 : 2;
};

template <typename T, int DH, bool kExact>
__global__ void __launch_bounds__(Cfg<T, DH>::kThreads, Cfg<T, DH>::kBlocks)
flash_attn_kernel(const FlashArgs a) {
  if constexpr (std::is_same_v<T, float>) fwd_f32<DH, kExact>(a);
  else fwd_mma<DH, kExact>(a);
}

template <typename T, int DH, bool kExact>
int launch_form(const FlashArgs& a, cudaStream_t stream) {
  auto kernel = flash_attn_kernel<T, DH, kExact>;
  const size_t smem = smem_bytes<T, DH>() + flag_bytes(a.T);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.T + kBT - 1) / kBT, a.H, a.B);
  kernel<<<grid, Cfg<T, DH>::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the instance's own head dim in whole vectors, or any dh below it
template <typename T, int DH>
int launch(const FlashArgs& a, cudaStream_t stream) {
  if (a.dh == DH && a.vec) return launch_form<T, DH, true>(a, stream);
  return launch_form<T, DH, false>(a, stream);
}

// the instance of the next head dim up from dh
template <typename T>
int launch_dh(const FlashArgs& a, cudaStream_t stream) {
  if (a.dh < 1) return kErrHeadDim;
  if (a.dh <= 32) return launch<T, 32>(a, stream);
  if (a.dh <= 64) return launch<T, 64>(a, stream);
  if (a.dh <= 128) return launch<T, 128>(a, stream);
  return launch_wide<T>(a, stream);
}

}  // namespace
}  // namespace pgasr

extern "C" {

// Strides in elements, (batch, head, time) for each of q, k, v, o; l and m
// both null (inference form) or both (B, H, T) float32 (residual form);
// dtype 0 float32, 1 bfloat16; any dh >= 1. Returns 0, kErrHeadDim,
// kErrDtype, or the launch's cudaError_t.
int pgasr_flash_attn(const void* q, const void* k, const void* v,
                     const int* seg, void* o, float* l, float* m,
                     long long q_sb, long long q_sh,
                     long long q_st, long long k_sb, long long k_sh,
                     long long k_st, long long v_sb, long long v_sh,
                     long long v_st, long long o_sb, long long o_sh,
                     long long o_st, int B, int H, int T, int dh, float scale,
                     int dtype, cudaStream_t stream) {
  using namespace pgasr;
  if (B < 1 || H < 1 || T < 1) return cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return cudaErrorInvalidConfiguration;
  if ((l == nullptr) != (m == nullptr)) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return kErrDtype;
  FlashArgs a{q, k, v, seg, o, l, m,
                    {q_sb, q_sh, q_st}, {k_sb, k_sh, k_st},
                    {v_sb, v_sh, v_st}, {o_sb, o_sh, o_st},
                    B, H, T, scale, dh, 1};
  // q, k and v by 16-byte cp.async where every row is whole vectors
  const void* in[3] = {q, k, v};
  const long long* st[3] = {a.sq, a.sk, a.sv};
  const long long* so[1] = {a.so};
  a.vec = rows_vectorised(in, st, 3, so, 1, dh, dtype == 0 ? 4 : 8);
  if (dtype == 0) return launch_dh<float>(a, stream);
  return launch_dh<bf16>(a, stream);
}

}  // extern "C"
