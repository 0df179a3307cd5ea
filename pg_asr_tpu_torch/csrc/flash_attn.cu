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
//            read in place from a fused (B, T, 3, H, dh) projection)
//   seg      (B, T) int32, contiguous; query i attends key j iff
//            seg[b, i] == seg[b, j] (a padded query attends the padded keys)
//   o        (B, H, T, dh) in q's type, strides as given
//   l, m     (B, H, T) float32, contiguous, or both null: the residual form
//            (the library's save_residuals, which its backward reads) also
//            writes the row sum l and row max m of every row < T; null
//            pointers keep the inference form
//   dh = 32 or 64 (a template parameter); any T >= 1.
//
// Numerics, as the Pallas kernel: s = (q . k accumulated in float32) *
// scale, plus -0.7 * FLT_MAX where the segments differ (an additive mask,
// not -inf); the softmax runs online in float32 over key tiles (running max
// m and sum l per row, old sums rescaled by exp(m_old - m_new)); p =
// exp(s - m) is rounded to v's type before the p . v product, which
// accumulates in float32; the output is acc * (l == 0 ? 1 : 1 / l). Keys
// beyond T do not exist for the softmax (-inf, p = 0). Every query row
// < T is written, padded rows included.
//
// What bounds it on this card: at the conformer's shapes (B=64, H=4,
// T'=201, dh=64) one call is ~2.6 GFLOP over ~50 MB (float32), so the
// float32 operations bound it (0.04 ms at 67 TFLOP/s); in bfloat16 the
// bytes bound the card (~8 us), but this kernel computes in float32 on
// CUDA cores in both types, so its float32 operation rate is its limit.
//
// What the design does about it: 64 query rows per block and 64 keys per
// tile, 256 threads as a 16 x 16 grid; each thread owns 4 query rows
// (ty + 16 i) x 4 keys (tx + 16 j) of the score tile and the same 4 rows x
// dh/16 output columns, so each 16-byte shared-memory load of q or k
// feeds 4 multiply-adds and the float32 work dominates the loads. The q
// tile stays in shared memory for the whole walk; the k and v tiles are
// staged there (converted to float32) one tile at a time; the row max and
// sum are reduced over the 16 threads of a row with shuffles and kept in
// registers, with the output accumulator. Rows of q, k and p are padded
// by 4 floats in shared memory so that 8 threads reading 8 rows at one
// column hit 32 distinct banks. The score and p tiles never leave the
// block. Tensor cores (mma/wgmma for bfloat16), TMA and double-buffered
// tiles are later work.

#include <math.h>

#include "common.cuh"

namespace pgasr {
namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kAttnThreads = 256; // 16 x 16
constexpr int kRowsPerThread = kBQ / 16;
constexpr int kKeysPerThread = kBK / 16;
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;  // -0.7 * FLT_MAX

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
};

template <int DH>
constexpr size_t smem_floats() {
  // q and k tiles (rows padded by 4), v tile, p tile (rows padded by 4)
  return (size_t)kBQ * (DH + 4) + (size_t)kBK * (DH + 4) + (size_t)kBK * DH
         + (size_t)kBQ * (kBK + 4);
}

template <int DH>
constexpr size_t smem_bytes() {
  return smem_floats<DH>() * sizeof(float) + kBK * sizeof(int);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kAttnThreads)
flash_attn_kernel(const FlashArgs a) {
  constexpr int LDQ = DH + 4, LDP = kBK + 4;
  constexpr int CPT = DH / 16;  // output columns per thread: 4 or 2
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBQ * LDQ;
  float* Vs = Ks + kBK * LDQ;
  float* Ps = Vs + kBK * DH;
  int* segk = reinterpret_cast<int*>(Ps + kBQ * LDP);

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int Tn = a.T;
  const T* qp = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  T* op = static_cast<T*>(a.o) + b * a.so[0] + h * a.so[1];
  const int* seg = a.seg + (long long)b * Tn;

  load_rows_f32<T, DH, kAttnThreads>(Qs, LDQ, qp, a.sq[2], q0, kBQ, Tn);
  int segq[kRowsPerThread];
  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][CPT];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int t = q0 + ty + 16 * i;
    segq[i] = t < Tn ? seg[t] : -1;  // rows beyond T are computed, not stored
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < Tn; k0 += kBK) {
    __syncthreads();  // the previous tile's k, v and p are consumed
    load_rows_f32<T, DH, kAttnThreads>(Ks, LDQ, kp, a.sk[2], k0, kBK, Tn);
    load_rows_f32<T, DH, kAttnThreads>(Vs, DH, vp, a.sv[2], k0, kBK, Tn);
    for (int j = threadIdx.x; j < kBK; j += kAttnThreads)
      segk[j] = k0 + j < Tn ? seg[k0 + j] : 0;
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j, q . k in float32
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < DH; c += 4) {
      float4 qv[kRowsPerThread], kv[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LDQ + c]);
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LDQ + c]);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) {
          float acc_s = s[i][j];
          acc_s = fmaf(qv[i].x, kv[j].x, acc_s);
          acc_s = fmaf(qv[i].y, kv[j].y, acc_s);
          acc_s = fmaf(qv[i].z, kv[j].z, acc_s);
          acc_s = fmaf(qv[i].w, kv[j].w, acc_s);
          s[i][j] = acc_s;
        }
    }

    // scale, segment mask, online softmax; p rounded to v's type into Ps
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int kj = tx + 16 * j;
        float sv = s[i][j] * a.scale;
        sv += segq[i] == segk[kj] ? 0.0f : kMaskValue;
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
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = round_to<T>(p);
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
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vr[CPT];
        if constexpr (CPT == 4) {
          const float4 w = *reinterpret_cast<const float4*>(&Vs[(kk + u) * DH + 4 * tx]);
          vr[0] = w.x; vr[1] = w.y; vr[2] = w.z; vr[3] = w.w;
        } else {
          const float2 w = *reinterpret_cast<const float2*>(&Vs[(kk + u) * DH + 2 * tx]);
          vr[0] = w.x; vr[1] = w.y;
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vr[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tn) continue;
    const float inv = l[i] == 0.0f ? 1.0f : 1.0f / l[i];
    T* row = op + (long long)t * a.so[2] + CPT * tx;
#pragma unroll
    for (int c = 0; c < CPT; ++c) row[c] = from_f32<T>(acc[i][c] * inv);
    if (a.l != nullptr && tx == 0) {  // every thread of the row holds both
      const long long r = ((long long)b * a.H + h) * Tn + t;
      a.l[r] = l[i];
      a.m[r] = m[i];
    }
  }
}

template <typename T, int DH>
int launch(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_attn_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.T + kBQ - 1) / kBQ, a.H, a.B);
  flash_attn_kernel<T, DH><<<grid, kAttnThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch_dh(const FlashArgs& a, int dh, cudaStream_t stream) {
  if (dh == 32) return launch<T, 32>(a, stream);
  if (dh == 64) return launch<T, 64>(a, stream);
  return kErrHeadDim;
}

}  // namespace
}  // namespace pgasr

extern "C" {

// Strides in elements, (batch, head, time) for each of q, k, v, o; l and m
// both null (inference form) or both (B, H, T) float32 (residual form);
// dtype 0 float32, 1 bfloat16. Returns 0, kErrHeadDim, kErrDtype, or the
// launch's cudaError_t.
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
  const FlashArgs a{q, k, v, seg, o, l, m,
                    {q_sb, q_sh, q_st}, {k_sb, k_sh, k_st},
                    {v_sb, v_sh, v_st}, {o_sb, o_sh, o_st},
                    B, H, T, scale};
  if (dtype == 0) return launch_dh<float>(a, dh, stream);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(a, dh, stream);
  return kErrDtype;
}

}  // extern "C"
