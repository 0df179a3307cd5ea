// The lattice tiling and per-cell logits shared by the fused RNN-T joint
// kernels (joint_fwd.cu, joint_bwd.cu).
//
// A block owns one utterance b, one u-tile of kUT lattice rows (one lane
// each) and a walk over kTilesPerBlock T-tiles of kTT frames (one warp
// each): 256 cells per T-tile, one per thread. W (J x A, zero-padded to AP
// columns) and the u-tile's g rows stay in shared memory for the whole
// walk; each T-tile's e rows are staged in turn. Every value is float32 in
// shared memory and registers whatever the inputs' type.
#pragma once

#include <math.h>

#include "common.cuh"

namespace pgasr {
namespace joint {

constexpr int kTT = 8;                 // frames of a T-tile: one warp each
constexpr int kUT = 32;                // lattice rows of a u-tile: one lane each
constexpr int kThreads = kTT * kUT;    // 256: one lattice cell per thread
constexpr int kTilesPerBlock = 4;      // T-tiles a block walks

struct Args {
  const void* e;       // (B, T, J)
  const void* g;       // (B, U + 1, J)
  const void* W;       // (J, A)
  const void* bias;    // (A,)
  const int* labels;   // (B, U), int32; unread when U == 0
  int B, T, U, J, A;
};

// the register arrays' vocab width: A rounded up to 8, 16 or 32 (0 above)
inline int padded_vocab(int A) {
  return A < 1 ? 0 : A <= 8 ? 8 : A <= 16 ? 16 : A <= 32 ? 32 : 0;
}

inline int t_walks(int T) {
  return (T + kTT * kTilesPerBlock - 1) / (kTT * kTilesPerBlock);
}
inline int u_tiles(int U) { return (U + 1 + kUT - 1) / kUT; }

// floats of shared memory before the kernel's own: Ws [J][AP], Gs
// [kUT][J + 1] (rows padded by one against bank conflicts), Es [kTT][J]
inline size_t tile_floats(int J, int AP) {
  return (size_t)J * AP + (size_t)kUT * (J + 1) + (size_t)kTT * J;
}

// W (zero-padded to AP columns) and the u-tile's g rows (zero beyond U)
template <typename T, int AP>
__device__ __forceinline__ void load_w_g(float* Ws, float* Gs, const Args& a,
                                         int b, int u0) {
  const T* W = static_cast<const T*>(a.W);
  for (int i = threadIdx.x; i < a.J * AP; i += kThreads) {
    const int j = i / AP, c = i % AP;
    Ws[i] = c < a.A ? to_f32<T>(W[(long long)j * a.A + c]) : 0.0f;
  }
  const T* g = static_cast<const T*>(a.g);
  const int U1 = a.U + 1, J = a.J;
  for (int i = threadIdx.x; i < kUT * J; i += kThreads) {
    const int r = i / J, c = i % J, u = u0 + r;
    Gs[r * (J + 1) + c] =
        u < U1 ? to_f32<T>(g[((long long)b * U1 + u) * J + c]) : 0.0f;
  }
}

// the T-tile's e rows (zero beyond T)
template <typename T>
__device__ __forceinline__ void load_e(float* Es, const Args& a, int b,
                                       int t0) {
  const T* e = static_cast<const T*>(a.e);
  const int J = a.J;
  for (int i = threadIdx.x; i < kTT * J; i += kThreads) {
    const int r = i / J, c = i % J, t = t0 + r;
    Es[i] = t < a.T ? to_f32<T>(e[((long long)b * a.T + t) * J + c]) : 0.0f;
  }
}

template <typename T, int AP>
__device__ __forceinline__ void load_bias(float (&bz)[AP], const Args& a) {
  const T* bias = static_cast<const T*>(a.bias);
#pragma unroll
  for (int c = 0; c < AP; ++c) bz[c] = c < a.A ? to_f32<T>(bias[c]) : 0.0f;
}

// z = tanh(e_t + g_u) . W over j = 0 .. J-1 in order, then + bias (the
// Pallas kernel's dot, then + b): the cell of frame row w of Es and
// lattice row `lane` of Gs
template <int AP>
__device__ __forceinline__ void cell_logits(float (&z)[AP], const float* Es,
                                            const float* Gs, const float* Ws,
                                            const float (&bz)[AP], int J,
                                            int w, int lane) {
#pragma unroll
  for (int c = 0; c < AP; ++c) z[c] = 0.0f;
  const float* er = Es + w * J;
  const float* gr = Gs + lane * (J + 1);
#pragma unroll 2
  for (int j = 0; j < J; ++j) {
    const float h = tanhf(er[j] + gr[j]);
    const float4* wr = reinterpret_cast<const float4*>(Ws + j * AP);
#pragma unroll
    for (int c = 0; c < AP / 4; ++c) {
      const float4 wv = wr[c];
      z[4 * c] = fmaf(h, wv.x, z[4 * c]);
      z[4 * c + 1] = fmaf(h, wv.y, z[4 * c + 1]);
      z[4 * c + 2] = fmaf(h, wv.z, z[4 * c + 2]);
      z[4 * c + 3] = fmaf(h, wv.w, z[4 * c + 3]);
    }
  }
#pragma unroll
  for (int c = 0; c < AP; ++c) z[c] += bz[c];
}

// max and sum of exp(z - max) over the first A entries
template <int AP>
__device__ __forceinline__ void max_sum(const float (&z)[AP], int A,
                                        float* m, float* s) {
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < AP; ++c)
    if (c < A) mx = fmaxf(mx, z[c]);
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < AP; ++c)
    if (c < A) sum += expf(z[c] - mx);
  *m = mx;
  *s = sum;
}

// z[y] without a dynamic index into the register array (0 for y outside
// [0, AP), as the Pallas kernel's all-zero one-hot row gives)
template <int AP>
__device__ __forceinline__ float pick(const float (&z)[AP], int y) {
  float v = 0.0f;
#pragma unroll
  for (int c = 0; c < AP; ++c) v = c == y ? z[c] : v;
  return v;
}

// raises the kernel's shared-memory limit to `smem` bytes, or returns
// kErrSharedMemory when the card cannot give a block that much
template <typename Kernel>
int prepare_smem(Kernel kernel, size_t smem) {
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&smem_max,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (smem > (size_t)smem_max) return kErrSharedMemory;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline int check_args(const Args& a) {
  if (a.B < 1 || a.T < 1 || a.U < 0 || a.J < 1) return cudaErrorInvalidValue;
  if (a.B > 65535 || u_tiles(a.U) > 65535) return cudaErrorInvalidConfiguration;
  if (padded_vocab(a.A) == 0) return kErrVocab;
  return 0;
}

}  // namespace joint
}  // namespace pgasr
