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
//                strides in elements, the dh axis contiguous
//   seg          (B, T) int32, contiguous; query i attends key j iff
//                seg[b, i] == seg[b, j]
//   l, m, di     (B, H, T) float32, contiguous: the forward's row sum and
//                row max (csrc/flash_attn.cu, residual form) and
//                di = sum(o . do) over dh
//   dq, dk, dv   (B, H, T, dh) in q's type, strides as given
//   dh = 32 or 64 (a template parameter); any T >= 1.
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
// against ~80 MB and ~67 MB (float32): the float32 operations bound both
// (~0.05 ms at 67 TFLOP/s); in bfloat16 the bytes would, but the kernels
// compute in float32 on CUDA cores in both types, so the float32
// operation rate is their limit.
//
// What the design does about it: the forward's 16 x 16 thread grid and
// 4 x 4 register tiles. dkv: one block per (64-key tile, head, utterance);
// its k and v tiles stay in shared memory while it walks the query tiles,
// staging q, do and the rows' m, 1/l, di; each thread owns 4 keys (ty +
// 16 i) x 4 queries (tx + 16 j) of the s^T and dp^T tiles, and 4 keys x
// dh/16 columns of the dk and dv accumulators, which stay in registers
// for the whole walk. dq: one block per (64-query tile, head, utterance);
// q, do and the rows' m, 1/l, di stay while it walks the key tiles; each
// thread owns 4 queries x 4 keys of s and dp and 4 queries x dh/16
// columns of dq. p^T and ds^T (dkv) and ds (dq) pass through shared
// memory between the two products. No atomics: each output row is summed
// by one block, so the result is deterministic. Rows are padded by 4
// floats against bank conflicts; the tiles take 103 KB (dkv) and 85 KB
// (dq) of shared memory at dh=64, above the 48 KB default, so the launch
// opts in. Tensor cores, TMA and a fused single-pass backward are later
// work.

#include <math.h>

#include "common.cuh"

namespace pgasr {
namespace {

constexpr int kBT = 64;            // rows of a query or key tile
constexpr int kBwdThreads = 256;   // 16 x 16
constexpr int kPer = kBT / 16;     // tile rows (or columns) per thread
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;  // -0.7 * FLT_MAX

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
};

template <int DH>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, do tiles and p^T, ds^T tiles (rows padded by 4); the query
  // tile's m, 1/l, di and segment ids
  return ((size_t)4 * kBT * (DH + 4) + (size_t)2 * kBT * (kBT + 4)
          + (size_t)4 * kBT) * sizeof(float);
}

template <int DH>
constexpr size_t dq_smem_bytes() {
  // q, do, k, v tiles and the ds tile (rows padded by 4); the key tile's
  // segment ids
  return ((size_t)4 * kBT * (DH + 4) + (size_t)kBT * (kBT + 4) + kBT)
         * sizeof(float);
}

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
  if constexpr (CPT == 4) {
    const float4 w = *reinterpret_cast<const float4*>(&tile[r * LD + 4 * tx]);
    out[0] = w.x; out[1] = w.y; out[2] = w.z; out[3] = w.w;
  } else {
    const float2 w = *reinterpret_cast<const float2*>(&tile[r * LD + 2 * tx]);
    out[0] = w.x; out[1] = w.y;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kBwdThreads)
flash_attn_bwd_dkv_kernel(const FlashBwdArgs a) {
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

  const int k0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int Tn = a.T;
  const T* qp = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const T* dop = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  T* dkp = static_cast<T*>(a.dk) + b * a.sdk[0] + h * a.sdk[1];
  T* dvp = static_cast<T*>(a.dv) + b * a.sdv[0] + h * a.sdv[1];
  const int* seg = a.seg + (long long)b * Tn;
  const long long row0 = ((long long)b * a.H + h) * Tn;  // into l, m, di

  load_rows_f32<T, DH, kBwdThreads>(Ks, LD, kp, a.sk[2], k0, kBT, Tn);
  load_rows_f32<T, DH, kBwdThreads>(Vs, LD, vp, a.sv[2], k0, kBT, Tn);
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

  for (int q0 = 0; q0 < Tn; q0 += kBT) {
    __syncthreads();  // the previous query tile is consumed
    load_rows_f32<T, DH, kBwdThreads>(Qs, LD, qp, a.sq[2], q0, kBT, Tn);
    load_rows_f32<T, DH, kBwdThreads>(Ds, LD, dop, a.sdo[2], q0, kBT, Tn);
    for (int j = threadIdx.x; j < kBT; j += kBwdThreads) {
      const int t = q0 + j;
      const bool in = t < Tn;
      mq[j] = in ? a.m[row0 + t] : 0.0f;
      ilq[j] = in ? 1.0f / a.l[row0 + t] : 0.0f;
      diq[j] = in ? a.di[row0 + t] : 0.0f;
      segq[j] = in ? seg[t] : 0;
    }
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
        Ps[(ty + 16 * i) * LDP + qj] = round_to<T>(p);
        Ss[(ty + 16 * i) * LDP + qj] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dv += p^T . do and dk += ds^T . q over the tile's queries (rows
    // beyond T have p = ds = 0)
#pragma unroll 2
    for (int qq = 0; qq < kBT; qq += 4) {
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
    T* dkr = dkp + t * a.sdk[2] + CPT * tx;
    T* dvr = dvp + t * a.sdv[2] + CPT * tx;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dkr[c] = from_f32<T>(dk[i][c]);
      dvr[c] = from_f32<T>(dv[i][c]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kBwdThreads)
flash_attn_bwd_dq_kernel(const FlashBwdArgs a) {
  constexpr int LD = DH + 4, LDP = kBT + 4, CPT = DH / 16;
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ds = Qs + kBT * LD;   // do
  float* Ks = Ds + kBT * LD;
  float* Vs = Ks + kBT * LD;
  float* Ss = Vs + kBT * LD;   // ds, [query][key]
  int* segk = reinterpret_cast<int*>(Ss + kBT * LDP);

  const int q0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int Tn = a.T;
  const T* qp = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const T* dop = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  T* dqp = static_cast<T*>(a.dq) + b * a.sdq[0] + h * a.sdq[1];
  const int* seg = a.seg + (long long)b * Tn;
  const long long row0 = ((long long)b * a.H + h) * Tn;

  load_rows_f32<T, DH, kBwdThreads>(Qs, LD, qp, a.sq[2], q0, kBT, Tn);
  load_rows_f32<T, DH, kBwdThreads>(Ds, LD, dop, a.sdo[2], q0, kBT, Tn);
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

  for (int k0 = 0; k0 < Tn; k0 += kBT) {
    __syncthreads();  // the previous key tile and ds are consumed
    load_rows_f32<T, DH, kBwdThreads>(Ks, LD, kp, a.sk[2], k0, kBT, Tn);
    load_rows_f32<T, DH, kBwdThreads>(Vs, LD, vp, a.sv[2], k0, kBT, Tn);
    for (int j = threadIdx.x; j < kBT; j += kBwdThreads)
      segk[j] = k0 + j < Tn ? seg[k0 + j] : 0;
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
        Ss[(ty + 16 * i) * LDP + kj] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dq += ds . k over the tile's keys (keys beyond T have ds = 0)
#pragma unroll 2
    for (int kk = 0; kk < kBT; kk += 4) {
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
    T* row = dqp + (long long)(q0 + ty + 16 * i) * a.sdq[2] + CPT * tx;
#pragma unroll
    for (int c = 0; c < CPT; ++c) row[c] = from_f32<T>(dq[i][c]);
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const FlashBwdArgs& a,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.T + kBT - 1) / kBT, a.H, a.B);
  kernel<<<grid, kBwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch_dkv(const FlashBwdArgs& a, int dh, cudaStream_t stream) {
  if (dh == 32)
    return launch(flash_attn_bwd_dkv_kernel<T, 32>, dkv_smem_bytes<32>(), a,
                  stream);
  if (dh == 64)
    return launch(flash_attn_bwd_dkv_kernel<T, 64>, dkv_smem_bytes<64>(), a,
                  stream);
  return kErrHeadDim;
}

template <typename T>
int launch_dq(const FlashBwdArgs& a, int dh, cudaStream_t stream) {
  if (dh == 32)
    return launch(flash_attn_bwd_dq_kernel<T, 32>, dq_smem_bytes<32>(), a,
                  stream);
  if (dh == 64)
    return launch(flash_attn_bwd_dq_kernel<T, 64>, dq_smem_bytes<64>(), a,
                  stream);
  return kErrHeadDim;
}

int make_args(FlashBwdArgs* a, const void* q, const void* k, const void* v,
              const void* dout, const int* seg, const float* l,
              const float* m, const float* di, void* dq, void* dk, void* dv,
              const long long* strides, int B, int H, int T, float scale) {
  if (B < 1 || H < 1 || T < 1) return cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return cudaErrorInvalidConfiguration;
  *a = FlashBwdArgs{q, k, v, dout, seg, l, m, di, dq, dk, dv};
  long long* dst[7] = {a->sq, a->sk, a->sv, a->sdo, a->sdq, a->sdk, a->sdv};
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
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
// dtype 0 float32, 1 bfloat16. Each returns 0, kErrHeadDim, kErrDtype, or
// the launch's cudaError_t.
int pgasr_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const int* seg, const float* l,
                             const float* m, const float* di, void* dk,
                             void* dv, const long long* strides, int B, int H,
                             int T, int dh, float scale, int dtype,
                             cudaStream_t stream) {
  using namespace pgasr;
  FlashBwdArgs a;
  const int rc = make_args(&a, q, k, v, dout, seg, l, m, di, nullptr, dk, dv,
                           strides, B, H, T, scale);
  if (rc != 0) return rc;
  if (dtype == 0) return launch_dkv<float>(a, dh, stream);
  if (dtype == 1) return launch_dkv<__nv_bfloat16>(a, dh, stream);
  return kErrDtype;
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
                           nullptr, strides, B, H, T, scale);
  if (rc != 0) return rc;
  if (dtype == 0) return launch_dq<float>(a, dh, stream);
  if (dtype == 1) return launch_dq<__nv_bfloat16>(a, dh, stream);
  return kErrDtype;
}

}  // extern "C"
