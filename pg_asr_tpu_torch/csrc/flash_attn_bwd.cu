// Backward of the segment-masked multi-head attention (flash attention) for
// Hopper (sm_90a): two kernels, as the library has.
//
// Replaces the two TPU kernels that JAX's library Pallas flash attention
// launches in its custom VJP (jax/experimental/pallas/ops/tpu/
// flash_attention.py, _flash_attention_bwd), which the JAX package reaches
// when it trains with flash_attention (pg_asr_tpu/ops/flash_attn.py:mhsa):
//   dkv  _flash_attention_bwd_dkv (its pallas_call, kernel
//        _flash_attention_dkv_kernel): dk, dv
//   dq   _flash_attention_bwd_dq (its pallas_call, kernel
//        _flash_attention_dq_kernel): dq (its ds output exists only with a
//        bias, which the JAX package never passes)
// Their plain version is pg_asr_tpu_torch/ops/flash_attn.py:mhsa_bwd_plain.
// Contract:
//   q, k, v, do  (B, H, T, dh) float32 or bfloat16, any (batch, head, time)
//                strides in elements, the dh axis contiguous; rows of
//                whole 16-byte vectors are read by 16-byte cp.async, any
//                others element by element
//   seg          (B, T) int32, contiguous; query i attends key j iff
//                seg[b, i] == seg[b, j]
//   l, m, di     (B, H, T) float32, contiguous: the forward's row sum and
//                row max (csrc/flash_attn.cu, residual form) and
//                di = sum(o . do) over dh
//   dq, dk, dv   (B, H, T, dh) in q's type, strides as given
//   dh in 1 .. 128, on the instance for 32, 64 or 128 next up, its columns
//   past dh zero-filled as the tiles load (only the first dh written); dh
//   from 129 on the wide kernels (below: CUDA cores, float32 math, p and
//   ds rounded where the library rounds them; past 256 in pieces of 256);
//   any T >= 1.
//
// Numerics, as the Pallas kernels: s = (q . k in float32) * scale plus
// -0.7 * FLT_MAX where the segments differ; p = exp(s - m) * (1 / l);
// dv = p^T . do with p rounded to do's type; dp = do . v^T in float32;
// ds = (dp - di) * p * scale; dk = ds^T . q with ds rounded to do's type;
// dq = ds . k with ds rounded to k's type; every product accumulates in
// float32 and is written once, in q's type. Keys and queries beyond T do
// not exist (p = 0); padded rows < T are real rows (a padded query attends
// the padded keys) and get their gradients.
//
// What bounds it on this card: per (query, key) pair the segment mask
// leaves and per head, dkv does four dh-long dot products (s, dp, and its
// shares of dv and dk: 8 dh flops) and dq three (6 dh). At the conformer's
// shapes (B=64, H=4, T'=201, dh=64, ragged) that is ~3.6 and ~2.7 GFLOP
// against ~40 MB and ~34 MB in bfloat16 (twice that in float32): in
// float32 the operations on CUDA cores bound both (~0.05 ms at 67
// TFLOP/s), in bfloat16 the bytes (~0.01 ms at 3.35 TB/s). At T'=201 a
// block walks at most 4 tiles, so both are bound by latency and
// occupancy long before the tensor cores' issue rate.
//
// Design. Both kernels work on 64-row tiles: dkv holds a key tile and walks
// the query tiles, dq holds a query tile and walks the key tiles. Each
// output row is summed by one block (no atomics): the results are the same
// bits run to run. Both skip a (query tile, key tile) pair whose rows'
// segment-id ranges are disjoint (tile_flags, the rule of ops/flash_attn.py
// kept_tile_pairs): no pair of rows there shares a segment, every p and ds
// is exactly 0, and skipping changes no bit. Tiles arrive by 16-byte
// cp.async.
//
// bfloat16, on the tensor cores: 4 warps, each owning 16 rows of the held
// tile (keys in dkv, queries in dq). The tiles stay bf16 in shared memory,
// rows padded by 8 elements so that ldmatrix is free of bank conflicts;
// the walked tiles (q and do in dkv, k and v in dq) are double-buffered,
// the next kept tile's copy in flight while the current one is computed,
// and the walked rows' m, 1/l, di and segment ids are fetched into
// registers a tile ahead. All five products are mma.sync m16n8k16 (bf16
// operands, float32 accumulators), over chunks of 32 walked rows: s and dp
// from ldmatrix fragments; p and ds formed in registers from the
// accumulator fragments, rounded to bf16 pairs and fed straight back as
// the A operand of dv += p^T . do and dk += ds^T . q (dkv) or dq += ds . k
// (dq), the B operands by ldmatrix.trans. So p and ds round exactly where
// the library rounds them, never pass through shared memory, and only the
// float32 summation order differs from the plain version. MMAs whose 16
// rows or 8 columns lie wholly beyond T are skipped (T'=201 computes 208
// rows, not 256). Shared memory: 57 KB (dkv) and 55 KB (dq) at dh=64, so
// 3 and 4 blocks per SM; the launch bounds hold the registers to that
// (nvcc -Xptxas -v on the H100 host, kernel_ab.py flash_bwd: dkv 168 and
// dq 128 registers at dh=64, 140 and 105 at dh=32, no spills; cuobjdump
// counts 128 and 96 HMMA at dh=64). More blocks per SM (16-row chunks, or
// 128 registers with spills), fewer (64-row chunks, or k/v fragments held
// in registers) and a per-warp skip of 16 x 32 blocks all ran slower or
// no faster on the card. mma.sync, not wgmma + TMA: at 4 tiles per block
// the 64-row asynchronous warpgroup pipeline has nothing to overlap; it is
// the next step if the MMA rate becomes the limit.
//
// float32, on CUDA cores (TF32 would move the results past the bounds the
// port holds them to): a 16 x 16 thread grid with 4 x 4 register tiles.
// dkv: its k and v tiles stay in shared memory while it walks the query
// tiles, staging q, do and the rows' m, 1/l, di and segment ids; each
// thread owns 4 keys (ty + 16 i) x 4 queries (tx + 16 j) of the s^T and
// dp^T tiles, and 4 keys x dh/16 columns of the dk and dv accumulators.
// dq: q, do and the rows' m, 1/l, di stay while it walks the key tiles;
// each thread owns 4 queries x 4 keys of s and dp and 4 queries x dh/16
// columns of dq. p^T and ds^T (dkv) and ds (dq) pass through shared memory
// between the two products, whose loop stops at the last row below T.
// Rows are padded by 4 floats against bank conflicts; 103 KB (dkv) and
// 85 KB (dq) of shared memory at dh=64, 2 blocks per SM, to which the
// launch bounds hold the registers (128: at dh=64 ptxas spills 16 bytes in
// dkv and 24 in dq; unbounded it took 168, for one block per SM).

#include <math.h>

#include <cstdint>
#include <type_traits>

#include "flash_tiles.cuh"

namespace pgasr {
namespace {

// float32: a 16 x 16 thread grid, kPer x kPer elements per thread
constexpr int kF32Threads = 256;
constexpr int kPer = kBT / 16;
// bfloat16: one warp per 16 rows of the held tile; walked tiles in chunks
constexpr int kMmaThreads = 32 * (kBT / 16);
constexpr int kChunk = 32;

using bf16 = __nv_bfloat16;

struct FlashBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int* seg;
  const float* l;
  const float* m;
  const float* di;
  void* dq;  // the dq kernel's output
  void* dk;  // the dkv kernel's outputs
  void* dv;
  // (batch, head, time) strides of q, k, v, do, dq, dk, dv
  long long sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int B, H, T;
  float scale;
  int dh;   // the head dim: columns dh .. DH - 1 of the instance are zeros
  int vec;  // q, k, v, do rows read by 16-byte cp.async (else element-wise)
};

// threads per block and the blocks per SM the registers are held to (the
// dh = 128 instances: one block, dq in bf16 two, for the accumulators)
template <typename T, int DH> struct Cfg;
template <int DH> struct Cfg<float, DH> {
  static constexpr int kThreads = kF32Threads, kDkvBlocks = DH <= 64 ? 2 : 1,
                       kDqBlocks = DH <= 64 ? 2 : 1;
};
template <int DH> struct Cfg<bf16, DH> {
  static constexpr int kThreads = kMmaThreads, kDkvBlocks = DH <= 64 ? 3 : 1,
                       kDqBlocks = DH <= 64 ? 4 : 2;
};

template <typename T, int DH>
constexpr size_t dkv_smem_bytes() {
  if constexpr (std::is_same_v<T, float>)
    // k, v, q, do tiles and p^T, ds^T tiles (rows padded by 4); the query
    // tile's m, 1/l, di and segment ids
    return ((size_t)4 * kBT * (DH + 4) + (size_t)2 * kBT * (kBT + 4)
            + (size_t)4 * kBT) * sizeof(float);
  else
    // k, v and two buffers of q, do (rows padded by 8); two buffers of the
    // query tile's m, 1/l, di and segment ids
    return (size_t)6 * kBT * (DH + 8) * sizeof(bf16)
           + (size_t)2 * 4 * kBT * sizeof(float);
}

template <typename T, int DH>
constexpr size_t dq_smem_bytes() {
  if constexpr (std::is_same_v<T, float>)
    // q, do, k, v tiles and the ds tile (rows padded by 4); the key tile's
    // segment ids
    return ((size_t)4 * kBT * (DH + 4) + (size_t)kBT * (kBT + 4) + kBT)
           * sizeof(float);
  else
    // q, do and two buffers of k, v (rows padded by 8); two buffers of the
    // key tile's segment ids
    return (size_t)6 * kBT * (DH + 8) * sizeof(bf16)
           + (size_t)2 * kBT * sizeof(int);
}

// --- float32: CUDA cores ----------------------------------------------------

// element u of a float4
__device__ __forceinline__ float lane(const float4& w, int u) {
  return u == 0 ? w.x : u == 1 ? w.y : u == 2 ? w.z : w.w;
}

// acc[r][j] += A[ra(r)] . B[rb(j)] over DH: rows ty + 16 r of tile A
// against rows tx + 16 j of tile B, both with row stride LD
template <int DH, int LD>
__device__ __forceinline__ void tile_dots(float (&acc)[kPer][kPer],
                                          const float* A, const float* Bt,
                                          int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < DH; c += 4) {
    float4 av[kPer], bv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      av[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * LD + c]);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&Bt[(tx + 16 * j) * LD + c]);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
  }
}

// columns CPT * tx .. + CPT of row r of a tile with row stride LD
template <int CPT>
__device__ __forceinline__ void row_cols(float (&out)[CPT], const float* tile,
                                         int LD, int r, int tx) {
  if constexpr (CPT % 4 == 0) {
#pragma unroll
    for (int c4 = 0; c4 < CPT; c4 += 4) {
      const float4 w =
          *reinterpret_cast<const float4*>(&tile[r * LD + CPT * tx + c4]);
      out[c4] = w.x; out[c4 + 1] = w.y; out[c4 + 2] = w.z; out[c4 + 3] = w.w;
    }
  } else {
    const float2 w = *reinterpret_cast<const float2*>(&tile[r * LD + 2 * tx]);
    out[0] = w.x; out[1] = w.y;
  }
}

template <int DH, bool kExact>
__device__ __forceinline__ void dkv_f32(const FlashBwdArgs& a) {
  // the instance itself (dh = DH, whole vectors): the checks fold away
  const int dh = kExact ? DH : a.dh;
  const bool vec = kExact || a.vec;
  constexpr int LD = DH + 4, LDP = kBT + 4, CPT = DH / 16;
  extern __shared__ float4 smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kBT * LD;
  float* Qs = Vs + kBT * LD;
  float* Ds = Qs + kBT * LD;   // do
  float* Ps = Ds + kBT * LD;   // p^T, [key][query]
  float* Ss = Ps + kBT * LDP;  // ds^T, [key][query]
  float* mq = Ss + kBT * LDP;
  float* ilq = mq + kBT;       // 1 / l
  float* diq = ilq + kBT;
  int* segq = reinterpret_cast<int*>(diq + kBT);
  unsigned char* kept = reinterpret_cast<unsigned char*>(segq + kBT);

  const int k0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int Tn = a.T, n = (Tn + kBT - 1) / kBT;
  const float* qp = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const float* kp = static_cast<const float*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const float* vp = static_cast<const float*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const float* dop =
      static_cast<const float*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  float* dkp = static_cast<float*>(a.dk) + b * a.sdk[0] + h * a.sdk[1];
  float* dvp = static_cast<float*>(a.dv) + b * a.sdv[0] + h * a.sdv[1];
  const int* seg = a.seg + (long long)b * Tn;
  const long long row0 = ((long long)b * a.H + h) * Tn;  // into l, m, di

  load_tile_async<float, DH, LD, kF32Threads>(Ks, kp, a.sk[2], k0, Tn, dh, vec);
  load_tile_async<float, DH, LD, kF32Threads>(Vs, vp, a.sv[2], k0, Tn, dh, vec);
  cp_async_commit();
  tile_flags<kF32Threads>(kept, seg, k0, Tn);
  int segk[kPer];
  bool key_in[kPer];
  float dk[kPer][CPT], dv[kPer][CPT];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int t = k0 + ty + 16 * i;
    key_in[i] = t < Tn;
    segk[i] = key_in[i] ? seg[t] : 0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.0f;
  }
  __syncthreads();  // the flags

  for (int qt = next_kept(kept, 0, n); qt < n;
       qt = next_kept(kept, qt + 1, n)) {
    const int q0 = qt * kBT;
    __syncthreads();  // the previous query tile is consumed
    load_tile_async<float, DH, LD, kF32Threads>(Qs, qp, a.sq[2], q0, Tn, dh, vec);
    load_tile_async<float, DH, LD, kF32Threads>(Ds, dop, a.sdo[2], q0, Tn, dh, vec);
    cp_async_commit();
    for (int j = threadIdx.x; j < kBT; j += kF32Threads) {
      const int t = q0 + j;
      const bool in = t < Tn;
      mq[j] = in ? a.m[row0 + t] : 0.0f;
      ilq[j] = in ? 1.0f / a.l[row0 + t] : 0.0f;
      diq[j] = in ? a.di[row0 + t] : 0.0f;
      segq[j] = in ? seg[t] : 0;
    }
    cp_async_wait_all();
    __syncthreads();

    // s^T = k . q^T and dp^T = v . do^T: keys ty + 16 i, queries tx + 16 j
    float s[kPer][kPer], dp[kPer][kPer];
    tile_dots<DH, LD>(s, Ks, Qs, ty, tx);
    tile_dots<DH, LD>(dp, Vs, Ds, ty, tx);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int qj = tx + 16 * j;
      const bool q_in = q0 + qj < Tn;
      const float mj = mq[qj], ilj = ilq[qj], dij = diq[qj];
      const int sj = segq[qj];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        float p = 0.0f, ds = 0.0f;
        if (q_in && key_in[i]) {
          float sv = s[i][j] * a.scale;
          sv += segk[i] == sj ? 0.0f : kMaskValue;
          p = expf(sv - mj) * ilj;
          ds = (dp[i][j] - dij) * p * a.scale;
        }
        Ps[(ty + 16 * i) * LDP + qj] = p;
        Ss[(ty + 16 * i) * LDP + qj] = ds;
      }
    }
    __syncthreads();

    // dv += p^T . do and dk += ds^T . q over the tile's queries below T
    const int qn = min(kBT, Tn - q0);
#pragma unroll 2
    for (int qq = 0; qq < qn; qq += 4) {
      float4 pv[kPer], sv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LDP + qq]);
        sv[i] = *reinterpret_cast<const float4*>(&Ss[(ty + 16 * i) * LDP + qq]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float dor[CPT], qr[CPT];
        row_cols<CPT>(dor, Ds, LD, qq + u, tx);
        row_cols<CPT>(qr, Qs, LD, qq + u, tx);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const float p = lane(pv[i], u), ds = lane(sv[i], u);
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            dv[i][c] = fmaf(p, dor[c], dv[i][c]);
            dk[i][c] = fmaf(ds, qr[c], dk[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (!key_in[i]) continue;
    const long long t = k0 + ty + 16 * i;
    float* dkr = dkp + t * a.sdk[2] + CPT * tx;
    float* dvr = dvp + t * a.sdv[2] + CPT * tx;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (CPT * tx + c < dh) {
        dkr[c] = dk[i][c];
        dvr[c] = dv[i][c];
      }
    }
  }
}

template <int DH, bool kExact>
__device__ __forceinline__ void dq_f32(const FlashBwdArgs& a) {
  // the instance itself (dh = DH, whole vectors): the checks fold away
  const int dh = kExact ? DH : a.dh;
  const bool vec = kExact || a.vec;
  constexpr int LD = DH + 4, LDP = kBT + 4, CPT = DH / 16;
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ds = Qs + kBT * LD;   // do
  float* Ks = Ds + kBT * LD;
  float* Vs = Ks + kBT * LD;
  float* Ss = Vs + kBT * LD;   // ds, [query][key]
  int* segk = reinterpret_cast<int*>(Ss + kBT * LDP);
  unsigned char* kept = reinterpret_cast<unsigned char*>(segk + kBT);

  const int q0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int Tn = a.T, n = (Tn + kBT - 1) / kBT;
  const float* qp = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const float* kp = static_cast<const float*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const float* vp = static_cast<const float*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const float* dop =
      static_cast<const float*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  float* dqp = static_cast<float*>(a.dq) + b * a.sdq[0] + h * a.sdq[1];
  const int* seg = a.seg + (long long)b * Tn;
  const long long row0 = ((long long)b * a.H + h) * Tn;

  load_tile_async<float, DH, LD, kF32Threads>(Qs, qp, a.sq[2], q0, Tn, dh, vec);
  load_tile_async<float, DH, LD, kF32Threads>(Ds, dop, a.sdo[2], q0, Tn, dh, vec);
  cp_async_commit();
  tile_flags<kF32Threads>(kept, seg, q0, Tn);
  bool q_in[kPer];
  int segq[kPer];
  float mr[kPer], ilr[kPer], dir[kPer], dq[kPer][CPT];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int t = q0 + ty + 16 * i;
    q_in[i] = t < Tn;  // rows beyond T are computed, not stored
    segq[i] = q_in[i] ? seg[t] : 0;
    mr[i] = q_in[i] ? a.m[row0 + t] : 0.0f;
    ilr[i] = q_in[i] ? 1.0f / a.l[row0 + t] : 0.0f;
    dir[i] = q_in[i] ? a.di[row0 + t] : 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq[i][c] = 0.0f;
  }
  __syncthreads();  // the flags

  for (int kt = next_kept(kept, 0, n); kt < n;
       kt = next_kept(kept, kt + 1, n)) {
    const int k0 = kt * kBT;
    __syncthreads();  // the previous key tile and ds are consumed
    load_tile_async<float, DH, LD, kF32Threads>(Ks, kp, a.sk[2], k0, Tn, dh, vec);
    load_tile_async<float, DH, LD, kF32Threads>(Vs, vp, a.sv[2], k0, Tn, dh, vec);
    cp_async_commit();
    for (int j = threadIdx.x; j < kBT; j += kF32Threads)
      segk[j] = k0 + j < Tn ? seg[k0 + j] : 0;
    cp_async_wait_all();
    __syncthreads();

    // s = q . k^T and dp = do . v^T: queries ty + 16 i, keys tx + 16 j
    float s[kPer][kPer], dp[kPer][kPer];
    tile_dots<DH, LD>(s, Qs, Ks, ty, tx);
    tile_dots<DH, LD>(dp, Ds, Vs, ty, tx);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int kj = tx + 16 * j;
      const bool k_in = k0 + kj < Tn;
      const int sj = segk[kj];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        float ds = 0.0f;
        if (q_in[i] && k_in) {
          float sv = s[i][j] * a.scale;
          sv += segq[i] == sj ? 0.0f : kMaskValue;
          const float p = expf(sv - mr[i]) * ilr[i];
          ds = (dp[i][j] - dir[i]) * p * a.scale;
        }
        Ss[(ty + 16 * i) * LDP + kj] = ds;
      }
    }
    __syncthreads();

    // dq += ds . k over the tile's keys below T
    const int kn = min(kBT, Tn - k0);
#pragma unroll 2
    for (int kk = 0; kk < kn; kk += 4) {
      float4 sv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        sv[i] = *reinterpret_cast<const float4*>(&Ss[(ty + 16 * i) * LDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float kr[CPT];
        row_cols<CPT>(kr, Ks, LD, kk + u, tx);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const float ds = lane(sv[i], u);
#pragma unroll
          for (int c = 0; c < CPT; ++c) dq[i][c] = fmaf(ds, kr[c], dq[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (!q_in[i]) continue;
    float* row = dqp + (long long)(q0 + ty + 16 * i) * a.sdq[2] + CPT * tx;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (CPT * tx + c < dh) row[c] = dq[i][c];
  }
}

// --- bfloat16: tensor cores -------------------------------------------------


template <int DH, bool kExact>
__device__ __forceinline__ void dkv_mma(const FlashBwdArgs& a) {
  // the instance itself (dh = DH, whole vectors): the checks fold away
  const int dh = kExact ? DH : a.dh;
  const bool vec = kExact || a.vec;
  constexpr int LD = DH + 8, TILE = kBT * LD, NC = kChunk / 8, ND = DH / 8;
  extern __shared__ float4 smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;      // two buffers
  bf16* Ds = Qs + 2 * TILE;  // do, two buffers
  float* rows = reinterpret_cast<float*>(Ds + 2 * TILE);  // 2 x (m, 1/l, di)
  int* segq = reinterpret_cast<int*>(rows + 2 * 3 * kBT);  // two buffers
  unsigned char* kept = reinterpret_cast<unsigned char*>(segq + 2 * kBT);

  const int k0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const Lanes L(lane);
  const int Tn = a.T, n = (Tn + kBT - 1) / kBT;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const bf16* dop =
      static_cast<const bf16*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  bf16* dkp = static_cast<bf16*>(a.dk) + b * a.sdk[0] + h * a.sdk[1];
  bf16* dvp = static_cast<bf16*>(a.dv) + b * a.sdv[0] + h * a.sdv[1];
  const int* seg = a.seg + (long long)b * Tn;
  const long long row0 = ((long long)b * a.H + h) * Tn;  // into l, m, di

  load_tile_async<bf16, DH, LD, kMmaThreads>(Ks, kp, a.sk[2], k0, Tn, dh, vec);
  load_tile_async<bf16, DH, LD, kMmaThreads>(Vs, vp, a.sv[2], k0, Tn, dh, vec);
  cp_async_commit();
  tile_flags<kMmaThreads>(kept, seg, k0, Tn);
  __syncthreads();  // the flags

  // the first kept query tile into buffer 0 (the key tile meets itself)
  int qt = next_kept(kept, 0, n);
  load_tile_async<bf16, DH, LD, kMmaThreads>(Qs, qp, a.sq[2], qt * kBT, Tn, dh, vec);
  load_tile_async<bf16, DH, LD, kMmaThreads>(Ds, dop, a.sdo[2], qt * kBT, Tn, dh, vec);
  cp_async_commit();
  if (threadIdx.x < kBT) {
    const int t = qt * kBT + threadIdx.x;
    const bool in = t < Tn;
    rows[threadIdx.x] = in ? a.m[row0 + t] : 0.0f;
    rows[kBT + threadIdx.x] = in ? 1.0f / a.l[row0 + t] : 0.0f;
    rows[2 * kBT + threadIdx.x] = in ? a.di[row0 + t] : 0.0f;
    segq[threadIdx.x] = in ? seg[t] : 0;
  }

  // this warp's keys kw .. kw + 15; this lane's rows g and g + 8 of them
  const int kw = k0 + 16 * warp;
  const bool warp_in = kw < Tn;
  int segk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    segk[r] = kw + g + 8 * r < Tn ? seg[kw + g + 8 * r] : 0;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.0f;

  for (int buf = 0; qt < n; buf ^= 1) {
    const int nxt = next_kept(kept, qt + 1, n);
    // the next tile's row values, fetched now and stored after this
    // tile's products
    const bool stage = nxt < n && threadIdx.x < kBT;
    const int tn = nxt * kBT + threadIdx.x;
    float nm = 0.0f, nl = 0.0f, ndi = 0.0f;
    int ns = 0;
    if (stage && tn < Tn) {
      nm = a.m[row0 + tn];
      nl = a.l[row0 + tn];
      ndi = a.di[row0 + tn];
      ns = seg[tn];
    }
    cp_async_wait_all();
    __syncthreads();  // tile qt is in `buf`; the other buffer is free
    if (nxt < n) {
      load_tile_async<bf16, DH, LD, kMmaThreads>(Qs + (buf ^ 1) * TILE, qp,
                                                 a.sq[2], nxt * kBT, Tn, dh, vec);
      load_tile_async<bf16, DH, LD, kMmaThreads>(Ds + (buf ^ 1) * TILE, dop,
                                                 a.sdo[2], nxt * kBT, Tn, dh, vec);
    }
    cp_async_commit();

    if (warp_in) {
      const bf16* Qb = Qs + buf * TILE;
      const bf16* Db = Ds + buf * TILE;
      const float* mq = rows + buf * 3 * kBT;
      const float* ilq = mq + kBT;
      const float* diq = ilq + kBT;
      const int* sq = segq + buf * kBT;
      const int q0 = qt * kBT;
      const bf16* ka = Ks + (16 * warp + L.arow) * LD + L.acol;
      const bf16* va = Vs + (16 * warp + L.arow) * LD + L.acol;
#pragma unroll
      for (int qc = 0; qc < kBT; qc += kChunk) {
        if (q0 + qc >= Tn) break;
        // s^T = k . q^T and dp^T = v . do^T: this warp's 16 keys x the
        // chunk's queries, n-tile j = queries qc + 8 j ..
        float s[NC][4], dp[NC][4];
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < DH; kk += 16) {
          unsigned ak[4], av[4];
          ldsm_x4(ak, ka + kk);
          ldsm_x4(av, va + kk);
#pragma unroll
          for (int j = 0; j < NC; j += 2) {
            const int r = (qc + 8 * j + L.brow) * LD + kk + L.bcol;
            unsigned bq[4], bd[4];
            ldsm_x4(bq, Qb + r);
            ldsm_x4(bd, Db + r);
            if (q0 + qc + 8 * j < Tn) {
              mma_bf16_16816(s[j], ak, bq[0], bq[1]);
              mma_bf16_16816(dp[j], av, bd[0], bd[1]);
            }
            if (q0 + qc + 8 * j + 8 < Tn) {
              mma_bf16_16816(s[j + 1], ak, bq[2], bq[3]);
              mma_bf16_16816(dp[j + 1], av, bd[2], bd[3]);
            }
          }
        }
        // p^T and ds^T, rounded to bf16 pairs in the A-fragment layout
        // over the chunk's queries: n-tiles 2 u and 2 u + 1 make k-step u
        unsigned pa[NC / 2][4], sa[NC / 2][4];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int col = qc + 8 * j + c2;  // elements 0, 2; col + 1: 1, 3
          const float2 mj = *reinterpret_cast<const float2*>(mq + col);
          const float2 ilj = *reinterpret_cast<const float2*>(ilq + col);
          const float2 dij = *reinterpret_cast<const float2*>(diq + col);
          const int2 sj = *reinterpret_cast<const int2*>(sq + col);
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;  // query col + odd, key row g + 8 (e / 2)
            const float sv = s[j][e] * a.scale
                             + (segk[e >> 1] == (odd ? sj.y : sj.x)
                                    ? 0.0f : kMaskValue);
            const bool in = q0 + col + odd < Tn;
            p[e] = in ? expf(sv - (odd ? mj.y : mj.x)) * (odd ? ilj.y : ilj.x)
                      : 0.0f;
            ds[e] = in ? (dp[j][e] - (odd ? dij.y : dij.x)) * p[e] * a.scale
                       : 0.0f;
          }
          pa[j >> 1][2 * (j & 1)] = pack_bf16x2(p[0], p[1]);
          pa[j >> 1][2 * (j & 1) + 1] = pack_bf16x2(p[2], p[3]);
          sa[j >> 1][2 * (j & 1)] = pack_bf16x2(ds[0], ds[1]);
          sa[j >> 1][2 * (j & 1) + 1] = pack_bf16x2(ds[2], ds[3]);
        }
        // dv += p^T . do and dk += ds^T . q over the chunk's queries below
        // T; n-tile d = columns 8 d ..
#pragma unroll
        for (int u = 0; u < NC / 2; ++u) {
          if (q0 + qc + 16 * u >= Tn) break;
          const int r = (qc + 16 * u + L.trow) * LD + L.tcol;
#pragma unroll
          for (int d = 0; d < ND; d += 2) {
            unsigned bd[4], bq[4];
            ldsm_x4_trans(bd, Db + r + 8 * d);
            ldsm_x4_trans(bq, Qb + r + 8 * d);
            mma_bf16_16816(dv[d], pa[u], bd[0], bd[1]);
            mma_bf16_16816(dv[d + 1], pa[u], bd[2], bd[3]);
            mma_bf16_16816(dk[d], sa[u], bq[0], bq[1]);
            mma_bf16_16816(dk[d + 1], sa[u], bq[2], bq[3]);
          }
        }
      }
    }

    if (stage) {
      float* r = rows + (buf ^ 1) * 3 * kBT;
      r[threadIdx.x] = nm;
      r[kBT + threadIdx.x] = tn < Tn ? 1.0f / nl : 0.0f;
      r[2 * kBT + threadIdx.x] = ndi;
      segq[(buf ^ 1) * kBT + threadIdx.x] = ns;
    }
    qt = nxt;
  }

  if (!warp_in) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long t = kw + g + 8 * r;
    if (t >= Tn) continue;
    bf16* dkr = dkp + t * a.sdk[2];
    bf16* dvr = dvp + t * a.sdv[2];
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      store_pair(dkr, c2 + 8 * d, dk[d][2 * r], dk[d][2 * r + 1], dh,
                 vec);
      store_pair(dvr, c2 + 8 * d, dv[d][2 * r], dv[d][2 * r + 1], dh,
                 vec);
    }
  }
}

template <int DH, bool kExact>
__device__ __forceinline__ void dq_mma(const FlashBwdArgs& a) {
  // the instance itself (dh = DH, whole vectors): the checks fold away
  const int dh = kExact ? DH : a.dh;
  const bool vec = kExact || a.vec;
  constexpr int LD = DH + 8, TILE = kBT * LD, NC = kChunk / 8, ND = DH / 8;
  extern __shared__ float4 smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ds = Qs + TILE;      // do
  bf16* Ks = Ds + TILE;      // two buffers
  bf16* Vs = Ks + 2 * TILE;  // two buffers
  int* segk = reinterpret_cast<int*>(Vs + 2 * TILE);  // two buffers
  unsigned char* kept = reinterpret_cast<unsigned char*>(segk + 2 * kBT);

  const int q0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const Lanes L(lane);
  const int Tn = a.T, n = (Tn + kBT - 1) / kBT;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const bf16* dop =
      static_cast<const bf16*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  bf16* dqp = static_cast<bf16*>(a.dq) + b * a.sdq[0] + h * a.sdq[1];
  const int* seg = a.seg + (long long)b * Tn;
  const long long row0 = ((long long)b * a.H + h) * Tn;

  load_tile_async<bf16, DH, LD, kMmaThreads>(Qs, qp, a.sq[2], q0, Tn, dh, vec);
  load_tile_async<bf16, DH, LD, kMmaThreads>(Ds, dop, a.sdo[2], q0, Tn, dh, vec);
  cp_async_commit();
  tile_flags<kMmaThreads>(kept, seg, q0, Tn);

  // this warp's queries qw .. qw + 15; this lane's rows g and g + 8 of
  // them (rows beyond T are computed, not stored)
  const int qw = q0 + 16 * warp;
  const bool warp_in = qw < Tn;
  float mr[2], ilr[2], dir[2];
  int sr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = qw + g + 8 * r;
    const bool in = t < Tn;
    mr[r] = in ? a.m[row0 + t] : 0.0f;
    ilr[r] = in ? 1.0f / a.l[row0 + t] : 0.0f;
    dir[r] = in ? a.di[row0 + t] : 0.0f;
    sr[r] = in ? seg[t] : 0;
  }
  float dq[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.0f;
  __syncthreads();  // the flags

  // the first kept key tile into buffer 0 (the query tile meets itself)
  int kt = next_kept(kept, 0, n);
  load_tile_async<bf16, DH, LD, kMmaThreads>(Ks, kp, a.sk[2], kt * kBT, Tn, dh, vec);
  load_tile_async<bf16, DH, LD, kMmaThreads>(Vs, vp, a.sv[2], kt * kBT, Tn, dh, vec);
  cp_async_commit();
  if (threadIdx.x < kBT) {
    const int t = kt * kBT + threadIdx.x;
    segk[threadIdx.x] = t < Tn ? seg[t] : 0;
  }

  for (int buf = 0; kt < n; buf ^= 1) {
    const int nxt = next_kept(kept, kt + 1, n);
    // the next tile's segment ids, fetched now and stored after this
    // tile's products
    const bool stage = nxt < n && threadIdx.x < kBT;
    const int tn = nxt * kBT + threadIdx.x;
    const int ns = stage && tn < Tn ? seg[tn] : 0;
    cp_async_wait_all();
    __syncthreads();  // tile kt is in `buf`; the other buffer is free
    if (nxt < n) {
      load_tile_async<bf16, DH, LD, kMmaThreads>(Ks + (buf ^ 1) * TILE, kp,
                                                 a.sk[2], nxt * kBT, Tn, dh, vec);
      load_tile_async<bf16, DH, LD, kMmaThreads>(Vs + (buf ^ 1) * TILE, vp,
                                                 a.sv[2], nxt * kBT, Tn, dh, vec);
    }
    cp_async_commit();

    if (warp_in) {
      const bf16* Kb = Ks + buf * TILE;
      const bf16* Vb = Vs + buf * TILE;
      const int* sk = segk + buf * kBT;
      const int k0 = kt * kBT;
      const bf16* qa = Qs + (16 * warp + L.arow) * LD + L.acol;
      const bf16* da = Ds + (16 * warp + L.arow) * LD + L.acol;
#pragma unroll
      for (int kc = 0; kc < kBT; kc += kChunk) {
        if (k0 + kc >= Tn) break;
        // s = q . k^T and dp = do . v^T: this warp's 16 queries x the
        // chunk's keys, n-tile j = keys kc + 8 j ..
        float s[NC][4], dp[NC][4];
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < DH; kk += 16) {
          unsigned aq[4], ad[4];
          ldsm_x4(aq, qa + kk);
          ldsm_x4(ad, da + kk);
#pragma unroll
          for (int j = 0; j < NC; j += 2) {
            const int r = (kc + 8 * j + L.brow) * LD + kk + L.bcol;
            unsigned bk[4], bv[4];
            ldsm_x4(bk, Kb + r);
            ldsm_x4(bv, Vb + r);
            if (k0 + kc + 8 * j < Tn) {
              mma_bf16_16816(s[j], aq, bk[0], bk[1]);
              mma_bf16_16816(dp[j], ad, bv[0], bv[1]);
            }
            if (k0 + kc + 8 * j + 8 < Tn) {
              mma_bf16_16816(s[j + 1], aq, bk[2], bk[3]);
              mma_bf16_16816(dp[j + 1], ad, bv[2], bv[3]);
            }
          }
        }
        // ds, rounded to bf16 pairs in the A-fragment layout over the
        // chunk's keys
        unsigned sa[NC / 2][4];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int col = kc + 8 * j + c2;  // elements 0, 2; col + 1: 1, 3
          const int2 sj = *reinterpret_cast<const int2*>(sk + col);
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;  // key col + odd, query row g + 8 (e / 2)
            const int r = e >> 1;
            const float sv = s[j][e] * a.scale
                             + (sr[r] == (odd ? sj.y : sj.x) ? 0.0f
                                                             : kMaskValue);
            const float p = expf(sv - mr[r]) * ilr[r];
            ds[e] = k0 + col + odd < Tn ? (dp[j][e] - dir[r]) * p * a.scale
                                        : 0.0f;
          }
          sa[j >> 1][2 * (j & 1)] = pack_bf16x2(ds[0], ds[1]);
          sa[j >> 1][2 * (j & 1) + 1] = pack_bf16x2(ds[2], ds[3]);
        }
        // dq += ds . k over the chunk's keys below T
#pragma unroll
        for (int u = 0; u < NC / 2; ++u) {
          if (k0 + kc + 16 * u >= Tn) break;
          const int r = (kc + 16 * u + L.trow) * LD + L.tcol;
#pragma unroll
          for (int d = 0; d < ND; d += 2) {
            unsigned bk[4];
            ldsm_x4_trans(bk, Kb + r + 8 * d);
            mma_bf16_16816(dq[d], sa[u], bk[0], bk[1]);
            mma_bf16_16816(dq[d + 1], sa[u], bk[2], bk[3]);
          }
        }
      }
    }

    if (stage) segk[(buf ^ 1) * kBT + threadIdx.x] = ns;
    kt = nxt;
  }

  if (!warp_in) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long t = qw + g + 8 * r;
    if (t >= Tn) continue;
    bf16* row = dqp + t * a.sdq[2];
#pragma unroll
    for (int d = 0; d < ND; ++d)
      store_pair(row, c2 + 8 * d, dq[d][2 * r], dq[d][2 * r + 1], dh,
                 vec);
  }
}

// --- head dims past 128: the wide kernels, CUDA cores, float32 math ---------

constexpr int kWideRows = 16;         // query rows of a tile
constexpr int kWideDkvThreads = 256;  // 8 warps: 2 query rows each
constexpr int kWideDqThreads = 128;   // 4 warps: 4 query rows each

// dkv for dh past 128: a block holds 32 keys (k, v) and walks the query
// tiles of 16 rows. Per row, lane = key: s and dp over dh in order, p and
// ds (rounded to do's type, as the library rounds them before its
// products) into shared memory; then thread (key tid / 8, columns tid % 8
// + 8 i) adds p do and ds q over the tile's rows in order. Past kWideDh
// the head dim is cut in pieces of kWideDh: each block writes one piece of
// dk and dv (grid x = key tile x pieces) and sums s and dp over all pieces
// in order, loading the tiles a piece at a time.
template <typename T, bool kPieces>
__global__ void __launch_bounds__(kWideDkvThreads)
flash_attn_bwd_dkv_wide(const FlashBwdArgs a) {
  constexpr int CPT = kWideDh / 8;  // columns of a thread's key
  extern __shared__ float4 smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [kWideKeys][kWideLd]
  float* Vs = Ks + kWideKeys * kWideLd;
  float* Qs = Vs + kWideKeys * kWideLd;            // [kWideRows][kWideLd]
  float* Ds = Qs + kWideRows * kWideLd;            // do
  float* Ps = Ds + kWideRows * kWideLd;            // [kWideRows][kWideKeys]
  float* Ss = Ps + kWideRows * kWideKeys;          // ds
  float* mq = Ss + kWideRows * kWideKeys;
  float* ilq = mq + kWideRows;
  float* diq = ilq + kWideRows;
  int* segq = reinterpret_cast<int*>(diq + kWideRows);

  const int Tn = a.T, dh = a.dh;
  // pieces of the head dim (one up to kWideDh: the loops fold away)
  const int np = kPieces ? (dh + kWideDh - 1) / kWideDh : 1;
  const int pc = blockIdx.x % np, k0 = blockIdx.x / np * kWideKeys;
  const int oc = pc * kWideDh, on = min(kWideDh, dh - oc);  // output piece
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qp = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const T* dop = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  T* dkp = static_cast<T*>(a.dk) + b * a.sdk[0] + h * a.sdk[1];
  T* dvp = static_cast<T*>(a.dv) + b * a.sdv[0] + h * a.sdv[1];
  const int* seg = a.seg + (long long)b * Tn;
  const long long row0 = ((long long)b * a.H + h) * Tn;  // into l, m, di

  if (np == 1) {
    load_wide<T>(Ks, kp, a.sk[2], k0, kWideKeys, Tn, dh, kWideDkvThreads);
    load_wide<T>(Vs, vp, a.sv[2], k0, kWideKeys, Tn, dh, kWideDkvThreads);
  }
  const bool key_in = k0 + lane < Tn;
  const int segk = key_in ? seg[k0 + lane] : 0;
  const int ak = threadIdx.x >> 3, c0 = threadIdx.x & 7;
  float dk[CPT], dv[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) dk[i] = dv[i] = 0.0f;

  for (int q0 = 0; q0 < Tn; q0 += kWideRows) {
    float s[2] = {0.0f, 0.0f}, dp[2] = {0.0f, 0.0f};
    for (int p = 0; p < np; ++p) {  // s and dp over the pieces in order
      const int pcol = p * kWideDh, cn = min(kWideDh, dh - pcol);
      __syncthreads();  // the previous query tile or piece consumed
      if (np > 1) {
        load_wide<T>(Ks, kp + pcol, a.sk[2], k0, kWideKeys, Tn, cn,
                     kWideDkvThreads);
        load_wide<T>(Vs, vp + pcol, a.sv[2], k0, kWideKeys, Tn, cn,
                     kWideDkvThreads);
      }
      load_wide<T>(Qs, qp + pcol, a.sq[2], q0, kWideRows, Tn, cn,
                   kWideDkvThreads);
      load_wide<T>(Ds, dop + pcol, a.sdo[2], q0, kWideRows, Tn, cn,
                   kWideDkvThreads);
      if (p == 0 && threadIdx.x < kWideRows) {
        const int t = q0 + threadIdx.x;
        const bool in = t < Tn;
        mq[threadIdx.x] = in ? a.m[row0 + t] : 0.0f;
        ilq[threadIdx.x] = in ? 1.0f / a.l[row0 + t] : 0.0f;
        diq[threadIdx.x] = in ? a.di[row0 + t] : 0.0f;
        segq[threadIdx.x] = in ? seg[t] : 0;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = 2 * warp + rr;
        const float* qr = Qs + r * kWideLd;
        const float* dr = Ds + r * kWideLd;
        const float* kr = Ks + lane * kWideLd;
        const float* vr = Vs + lane * kWideLd;
        for (int d = 0; d < cn; ++d) {
          s[rr] = fmaf(qr[d], kr[d], s[rr]);
          dp[rr] = fmaf(dr[d], vr[d], dp[rr]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 2 * warp + rr;
      float p = 0.0f, ds = 0.0f;
      if (q0 + r < Tn && key_in) {
        float sv = s[rr] * a.scale + (segq[r] == segk ? 0.0f : kMaskValue);
        p = expf(sv - mq[r]) * ilq[r];
        ds = (dp[rr] - diq[r]) * p * a.scale;
      }
      Ps[r * kWideKeys + lane] = round_to<T>(p);
      Ss[r * kWideKeys + lane] = round_to<T>(ds);
    }
    if (np > 1) {  // the output piece's q and do
      __syncthreads();
      load_wide<T>(Qs, qp + oc, a.sq[2], q0, kWideRows, Tn, on,
                   kWideDkvThreads);
      load_wide<T>(Ds, dop + oc, a.sdo[2], q0, kWideRows, Tn, on,
                   kWideDkvThreads);
    }
    __syncthreads();
    const int qn = min(kWideRows, Tn - q0);
    for (int r = 0; r < qn; ++r) {
      const float p = Ps[r * kWideKeys + ak], ds = Ss[r * kWideKeys + ak];
      const float* dr = Ds + r * kWideLd + c0;
      const float* qr = Qs + r * kWideLd + c0;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        dv[i] = fmaf(p, dr[8 * i], dv[i]);
        dk[i] = fmaf(ds, qr[8 * i], dk[i]);
      }
    }
  }
  if (k0 + ak < Tn) {
    const long long t = k0 + ak;
    T* dkr = dkp + t * a.sdk[2] + oc;
    T* dvr = dvp + t * a.sdv[2] + oc;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int d = c0 + 8 * i;
      if (d < on) {
        dkr[d] = from_f32<T>(dk[i]);
        dvr[d] = from_f32<T>(dv[i]);
      }
    }
  }
}

// dq for dh past 128: a block holds 16 query rows (q, do; 4 a warp) and
// walks the key tiles of 32 (lane = key): s and dp over dh in order, ds
// rounded to k's type, broadcast by shuffles to the lanes that own dq's
// columns lane + 32 i, added over the keys in order. Past kWideDh, pieces
// as in the dkv kernel: a block writes one piece of dq (grid x = query
// tile x pieces).
template <typename T, bool kPieces>
__global__ void __launch_bounds__(kWideDqThreads)
flash_attn_bwd_dq_wide(const FlashBwdArgs a) {
  constexpr int CPL = kWideDh / 32;
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [kWideRows][kWideLd]
  float* Ds = Qs + kWideRows * kWideLd;
  float* Ks = Ds + kWideRows * kWideLd;            // [kWideKeys][kWideLd]
  float* Vs = Ks + kWideKeys * kWideLd;
  int* segk = reinterpret_cast<int*>(Vs + kWideKeys * kWideLd);

  const int Tn = a.T, dh = a.dh;
  // pieces of the head dim (one up to kWideDh: the loops fold away)
  const int np = kPieces ? (dh + kWideDh - 1) / kWideDh : 1;
  const int pc = blockIdx.x % np, q0 = blockIdx.x / np * kWideRows;
  const int oc = pc * kWideDh, on = min(kWideDh, dh - oc);  // output piece
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qp = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const T* dop = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  T* dqp = static_cast<T*>(a.dq) + b * a.sdq[0] + h * a.sdq[1];
  const int* seg = a.seg + (long long)b * Tn;
  const long long row0 = ((long long)b * a.H + h) * Tn;

  if (np == 1) {
    load_wide<T>(Qs, qp, a.sq[2], q0, kWideRows, Tn, dh, kWideDqThreads);
    load_wide<T>(Ds, dop, a.sdo[2], q0, kWideRows, Tn, dh, kWideDqThreads);
  }
  float mr[4], ilr[4], dir[4], dq[4][CPL];
  int segr[4];
  bool row_in[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + 4 * warp + r;
    row_in[r] = t < Tn;
    mr[r] = row_in[r] ? a.m[row0 + t] : 0.0f;
    ilr[r] = row_in[r] ? 1.0f / a.l[row0 + t] : 0.0f;
    dir[r] = row_in[r] ? a.di[row0 + t] : 0.0f;
    segr[r] = row_in[r] ? seg[t] : 0;
#pragma unroll
    for (int i = 0; i < CPL; ++i) dq[r][i] = 0.0f;
  }
  const float* qr = Qs + 4 * warp * kWideLd;
  const float* dr = Ds + 4 * warp * kWideLd;
  const float* kr = Ks + lane * kWideLd;
  const float* vr = Vs + lane * kWideLd;
  for (int k0 = 0; k0 < Tn; k0 += kWideKeys) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int p = 0; p < np; ++p) {  // s and dp over the pieces in order
      const int pcol = p * kWideDh, cn = min(kWideDh, dh - pcol);
      __syncthreads();  // the previous key tile or piece consumed
      if (np > 1) {
        load_wide<T>(Qs, qp + pcol, a.sq[2], q0, kWideRows, Tn, cn,
                     kWideDqThreads);
        load_wide<T>(Ds, dop + pcol, a.sdo[2], q0, kWideRows, Tn, cn,
                     kWideDqThreads);
      }
      load_wide<T>(Ks, kp + pcol, a.sk[2], k0, kWideKeys, Tn, cn,
                   kWideDqThreads);
      load_wide<T>(Vs, vp + pcol, a.sv[2], k0, kWideKeys, Tn, cn,
                   kWideDqThreads);
      if (p == 0 && threadIdx.x < kWideKeys) {
        const int t = k0 + threadIdx.x;
        segk[threadIdx.x] = t < Tn ? seg[t] : 0;
      }
      __syncthreads();
      for (int d = 0; d < cn; ++d) {
        const float kv = kr[d], vv = vr[d];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[r] = fmaf(qr[r * kWideLd + d], kv, s[r]);
          dp[r] = fmaf(dr[r * kWideLd + d], vv, dp[r]);
        }
      }
    }
    const bool key_in = k0 + lane < Tn;
    const int sk = segk[lane];
    float dsr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float ds = 0.0f;
      if (row_in[r] && key_in) {
        const float sv = s[r] * a.scale + (segr[r] == sk ? 0.0f : kMaskValue);
        const float p = expf(sv - mr[r]) * ilr[r];
        ds = (dp[r] - dir[r]) * p * a.scale;
      }
      dsr[r] = round_to<T>(ds);
    }
    if (np > 1) {  // the output piece's k
      __syncthreads();
      load_wide<T>(Ks, kp + oc, a.sk[2], k0, kWideKeys, Tn, on,
                   kWideDqThreads);
      __syncthreads();
    }
    for (int kk = 0; kk < kWideKeys; ++kk) {
      float dk_[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dk_[r] = __shfl_sync(0xffffffffu, dsr[r], kk);
      const float* kc = Ks + kk * kWideLd + lane;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const float kv = kc[32 * i];
#pragma unroll
        for (int r = 0; r < 4; ++r) dq[r][i] = fmaf(dk_[r], kv, dq[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (!row_in[r]) continue;
    T* row = dqp + (long long)(q0 + 4 * warp + r) * a.sdq[2] + oc;
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      if (lane + 32 * i < on) row[lane + 32 * i] = from_f32<T>(dq[r][i]);
  }
}

size_t wide_dkv_smem_bytes() {
  return ((size_t)(2 * kWideKeys + 2 * kWideRows) * kWideLd
          + (size_t)2 * kWideRows * kWideKeys + (size_t)4 * kWideRows)
         * sizeof(float);
}
size_t wide_dq_smem_bytes() {
  return ((size_t)(2 * kWideRows + 2 * kWideKeys) * kWideLd + kWideKeys)
         * sizeof(float);
}

// --- the two kernels and their launches --------------------------------------

template <typename T, int DH, bool kExact>
__global__ void __launch_bounds__(Cfg<T, DH>::kThreads, Cfg<T, DH>::kDkvBlocks)
flash_attn_bwd_dkv_kernel(const FlashBwdArgs a) {
  if constexpr (std::is_same_v<T, float>) dkv_f32<DH, kExact>(a);
  else dkv_mma<DH, kExact>(a);
}

template <typename T, int DH, bool kExact>
__global__ void __launch_bounds__(Cfg<T, DH>::kThreads, Cfg<T, DH>::kDqBlocks)
flash_attn_bwd_dq_kernel(const FlashBwdArgs a) {
  if constexpr (std::is_same_v<T, float>) dq_f32<DH, kExact>(a);
  else dq_mma<DH, kExact>(a);
}

// the kernel over (tiles of `rows` along T x `pieces` of the head dim,
// heads, batch rows)
template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const FlashBwdArgs& a,
           cudaStream_t stream, int rows = kBT, int pieces = 1) {
  smem += flag_bytes(a.T);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.T + rows - 1) / rows * pieces, a.H, a.B);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the instance of the next head dim up from dh (its own head dim in whole
// vectors: the exact form)
template <typename T, int DH>
int launch_dkv_dh(const FlashBwdArgs& a, cudaStream_t stream) {
  if (a.dh == DH && a.vec)
    return launch(flash_attn_bwd_dkv_kernel<T, DH, true>,
                  Cfg<T, DH>::kThreads, dkv_smem_bytes<T, DH>(), a, stream);
  return launch(flash_attn_bwd_dkv_kernel<T, DH, false>, Cfg<T, DH>::kThreads,
                dkv_smem_bytes<T, DH>(), a, stream);
}

template <typename T, int DH>
int launch_dq_dh(const FlashBwdArgs& a, cudaStream_t stream) {
  if (a.dh == DH && a.vec)
    return launch(flash_attn_bwd_dq_kernel<T, DH, true>, Cfg<T, DH>::kThreads,
                  dq_smem_bytes<T, DH>(), a, stream);
  return launch(flash_attn_bwd_dq_kernel<T, DH, false>, Cfg<T, DH>::kThreads,
                dq_smem_bytes<T, DH>(), a, stream);
}

// pieces of kWideDh columns of a wide kernel's head dim
int wide_pieces(int dh) { return (dh + kWideDh - 1) / kWideDh; }

template <typename T>
int launch_dkv(const FlashBwdArgs& a, cudaStream_t stream) {
  if (a.dh < 1) return kErrHeadDim;
  if (a.dh <= 32) return launch_dkv_dh<T, 32>(a, stream);
  if (a.dh <= 64) return launch_dkv_dh<T, 64>(a, stream);
  if (a.dh <= 128) return launch_dkv_dh<T, 128>(a, stream);
  const int np = wide_pieces(a.dh);
  return launch(np > 1 ? flash_attn_bwd_dkv_wide<T, true>
                       : flash_attn_bwd_dkv_wide<T, false>,
                kWideDkvThreads, wide_dkv_smem_bytes(), a, stream, kWideKeys,
                np);
}

template <typename T>
int launch_dq(const FlashBwdArgs& a, cudaStream_t stream) {
  if (a.dh < 1) return kErrHeadDim;
  if (a.dh <= 32) return launch_dq_dh<T, 32>(a, stream);
  if (a.dh <= 64) return launch_dq_dh<T, 64>(a, stream);
  if (a.dh <= 128) return launch_dq_dh<T, 128>(a, stream);
  const int np = wide_pieces(a.dh);
  return launch(np > 1 ? flash_attn_bwd_dq_wide<T, true>
                       : flash_attn_bwd_dq_wide<T, false>,
                kWideDqThreads, wide_dq_smem_bytes(), a, stream, kWideRows,
                np);
}

int make_args(FlashBwdArgs* a, const void* q, const void* k, const void* v,
              const void* dout, const int* seg, const float* l,
              const float* m, const float* di, void* dq, void* dk, void* dv,
              const long long* strides, int B, int H, int T, int dh,
              float scale, int dtype) {
  if (B < 1 || H < 1 || T < 1) return cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return cudaErrorInvalidConfiguration;
  if (dtype != 0 && dtype != 1) return kErrDtype;
  *a = FlashBwdArgs{q, k, v, dout, seg, l, m, di, dq, dk, dv};
  long long* dst[7] = {a->sq, a->sk, a->sv, a->sdo, a->sdq, a->sdk, a->sdv};
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  // the inputs by 16-byte cp.async where every row is whole vectors
  const void* in[4] = {q, k, v, dout};
  const long long* st[4] = {a->sq, a->sk, a->sv, a->sdo};
  const long long* so[3] = {a->sdq, a->sdk, a->sdv};
  a->vec = rows_vectorised(in, st, 4, so, 3, dh, dtype == 0 ? 4 : 8);
  a->dh = dh;
  a->B = B;
  a->H = H;
  a->T = T;
  a->scale = scale;
  return 0;
}

}  // namespace
}  // namespace pgasr

extern "C" {

// `strides`: 21 (batch, head, time) strides in elements, of q, k, v, do,
// dq, dk, dv in that order (the output not computed may be anything);
// dtype 0 float32, 1 bfloat16; any dh >= 1. Each returns 0,
// kErrHeadDim, kErrDtype, or the launch's cudaError_t.
int pgasr_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const int* seg, const float* l,
                             const float* m, const float* di, void* dk,
                             void* dv, const long long* strides, int B, int H,
                             int T, int dh, float scale, int dtype,
                             cudaStream_t stream) {
  using namespace pgasr;
  FlashBwdArgs a;
  const int rc = make_args(&a, q, k, v, dout, seg, l, m, di, nullptr, dk, dv,
                           strides, B, H, T, dh, scale, dtype);
  if (rc != 0) return rc;
  if (dtype == 0) return launch_dkv<float>(a, stream);
  return launch_dkv<__nv_bfloat16>(a, stream);
}

int pgasr_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const int* seg, const float* l,
                            const float* m, const float* di, void* dq,
                            const long long* strides, int B, int H, int T,
                            int dh, float scale, int dtype,
                            cudaStream_t stream) {
  using namespace pgasr;
  FlashBwdArgs a;
  const int rc = make_args(&a, q, k, v, dout, seg, l, m, di, dq, nullptr,
                           nullptr, strides, B, H, T, dh, scale, dtype);
  if (rc != 0) return rc;
  if (dtype == 0) return launch_dq<float>(a, stream);
  return launch_dq<__nv_bfloat16>(a, stream);
}

}  // extern "C"
