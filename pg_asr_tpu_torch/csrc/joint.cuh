// The arguments and checks of the fused RNN-T joint kernels (joint_fwd.cu,
// joint_bwd.cu), and the vocab-chunked tile they share.
//
// A block owns one utterance b and one u-tile of kUT = 32 lattice rows and
// walks frames in tiles of NC cells (NC / 32 frames x 32 rows, cell = 32
// frame + row). Any J and any A: J is cut in pieces of kJC = 256 columns
// and the vocabulary in chunks of kVC = 32 columns. Per tile and chunk:
//   h = tanh(e + g) of a piece's columns, staged in shared memory as
//       [j][cell] (float4 along cells), thread j the column j0 + j; staged
//       once per tile where J fits one piece, else again for each chunk;
//   W's piece x chunk staged as [j][vocab] (and [vocab][j] where the
//       backward needs it), once for the whole walk where both fit one;
//   z = h . W over the piece's columns, register-tiled: warp w takes 16
//       vocab columns (w & 1) and 8 CPL cells, a lane CPL = 4 or 8 cells x
//       4 columns (CPL / 4 float4s of h, one of W, 4 CPL multiply-adds a
//       column j); where the warps' cells do not cover the tile, they
//       split j in NKS slices, stored apart and added in order;
//   the logsumexp carried across chunks (running max m and sum s, two
//       threads per cell): s = s exp(m - m') + sum exp(z - m').
// Every value is float32 in shared memory and registers whatever the
// inputs' type, and every sum runs in a fixed order: the same bits come
// out run to run.
#pragma once

#include <math.h>

#include "common.cuh"

namespace pgasr {
namespace joint {

constexpr int kUT = 32;       // lattice rows of a u-tile
constexpr int kJC = 256;      // columns of a J piece: one a thread
constexpr int kVC = 32;       // vocab columns of a chunk
constexpr int kThreads = 256;
constexpr int kLdwt = kJC + 1;  // row of W^T [vocab][j], padded: no conflicts

struct Args {
  const void* e;       // (B, T, J)
  const void* g;       // (B, U + 1, J)
  const void* W;       // (J, A)
  const void* bias;    // (A,)
  const int* labels;   // (B, U), int32; unread when U == 0
  int B, T, U, J, A;
};

inline int u_tiles(int U) { return (U + 1 + kUT - 1) / kUT; }
__host__ __device__ inline int chunks(int A) { return (A + kVC - 1) / kVC; }
__host__ __device__ inline int pieces(int J) { return (J + kJC - 1) / kJC; }

// j slices of the product: the 8 warps as 2 vocab halves x cell groups of
// 8 CPL cells x slices
__host__ __device__ constexpr int slices(int nc, int cpl) {
  return 4 * 8 * cpl / nc;
}

// shared memory of a tile, in floats: h [kJC][NC + 4], W [kJC][kVC], the
// j slices of z [NKS][kVC][NC + 4], the chunk's bias [kVC]; with `wt` also
// W^T [kVC][kLdwt] and the dz products [kJC][NC + 4]
struct TileSmem {
  int ldh;
  size_t w, z, bias, wt, d, total;
  __host__ __device__ TileSmem(int nc, int cpl, bool wt_)
      : ldh(nc + 4), w((size_t)kJC * ldh), z(w + (size_t)kJC * kVC),
        bias(z + (size_t)slices(nc, cpl) * kVC * ldh), wt(bias + kVC),
        d(wt + (wt_ ? (size_t)kVC * kLdwt : 0)),
        total(d + (wt_ ? (size_t)kJC * ldh : 0)) {}
};

// g of column j for the u-tile's rows (zero past U and J)
template <typename T>
__device__ __forceinline__ void load_g(float (&gr)[kUT], const Args& a, int b,
                                       int u0, int j) {
  const T* g = static_cast<const T*>(a.g);
  const int U1 = a.U + 1;
#pragma unroll
  for (int r = 0; r < kUT; ++r)
    gr[r] = j < a.J && u0 + r < U1
                ? to_f32<T>(g[((long long)b * U1 + u0 + r) * a.J + j])
                : 0.0f;
}

// h of the tile's cells for the piece's column j = j0 + threadIdx.x (gr
// its g), zero past J
template <typename T, int NC>
__device__ __forceinline__ void stage_h(float* hs, const Args& a, int b,
                                        int t0, int j0,
                                        const float (&gr)[kUT]) {
  constexpr int F = NC / kUT, ldh = NC + 4;
  const T* e = static_cast<const T*>(a.e);
  const int jl = threadIdx.x, j = j0 + jl;
  float* row = hs + (size_t)jl * ldh;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const bool ok = j < a.J;
    const float ev = ok && t0 + f < a.T
                         ? to_f32<T>(e[((long long)b * a.T + t0 + f) * a.J + j])
                         : 0.0f;
#pragma unroll
    for (int r4 = 0; r4 < kUT / 4; ++r4)
      *reinterpret_cast<float4*>(row + kUT * f + 4 * r4) =
          ok ? make_float4(tanhf(ev + gr[4 * r4]), tanhf(ev + gr[4 * r4 + 1]),
                           tanhf(ev + gr[4 * r4 + 2]),
                           tanhf(ev + gr[4 * r4 + 3]))
             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// W's rows j0 .. j0 + kJC - 1 and columns c0 .. c0 + kVC - 1 as [j][vocab]
// (and as [vocab][j] into wts unless null), the chunk's bias; zero past J
// and A
template <typename T>
__device__ __forceinline__ void stage_w(float* ws, float* wts, float* bs,
                                        const Args& a, int j0, int c0) {
  const T* W = static_cast<const T*>(a.W);
  for (int i = threadIdx.x; i < kJC * kVC; i += kThreads) {
    const int jl = i / kVC, k = i - jl * kVC, j = j0 + jl, c = c0 + k;
    const float v = j < a.J && c < a.A ? to_f32<T>(W[(long long)j * a.A + c])
                                       : 0.0f;
    ws[i] = v;
    if (wts != nullptr) wts[(size_t)k * kLdwt + jl] = v;
  }
  if (threadIdx.x < kVC) {
    const int c = c0 + threadIdx.x;
    bs[threadIdx.x] =
        c < a.A ? to_f32<T>(static_cast<const T*>(a.bias)[c]) : 0.0f;
  }
}

// The product's lane tile: warp w's vocab half ch, cell group cg and j
// slice ks; a lane's cells c0 .. c0 + 3 (and c0 + 32 .. c0 + 35 where CPL
// is 8: each float4 load of the warp one 128-byte wavefront) and its 4
// vocab columns col ..
template <int NC, int CPL>
struct LaneTile {
  static constexpr int CG = NC / (8 * CPL), NKS = slices(NC, CPL);
  int ch, cg, ks, c0, col;
  __device__ LaneTile() {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    ch = w & 1;
    cg = (w >> 1) % CG;
    ks = (w >> 1) / CG;
    c0 = 8 * CPL * cg + 4 * (lane & 7);
    col = 16 * ch + 4 * (lane >> 3);
  }
};

// acc += h . W over the staged piece's first jn columns, in order of j
// within the warp's slice (layout in the header)
template <int NC, int CPL>
__device__ __forceinline__ void z_product(float (&acc)[CPL][4],
                                          const float* hs, const float* ws,
                                          int jn) {
  constexpr int ldh = NC + 4, NKS = slices(NC, CPL);
  const LaneTile<NC, CPL> L;
  const int per = (jn + NKS - 1) / NKS;
  const int lo = min(jn, L.ks * per), hi = min(jn, lo + per);
  const float* hp = hs + L.c0;
  const float* wp = ws + L.col;
#pragma unroll 4
  for (int j = lo; j < hi; ++j) {
    float hv[CPL];
#pragma unroll
    for (int q4 = 0; q4 < CPL / 4; ++q4) {
      const float4 h =
          *reinterpret_cast<const float4*>(hp + (size_t)j * ldh + 32 * q4);
      hv[4 * q4] = h.x; hv[4 * q4 + 1] = h.y;
      hv[4 * q4 + 2] = h.z; hv[4 * q4 + 3] = h.w;
    }
    const float4 wv = *reinterpret_cast<const float4*>(wp + (size_t)j * kVC);
    const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[c][k] = fmaf(hv[c], wr[k], acc[c][k]);
  }
}

// the warp's sums into its slice of zs [NKS][kVC][ldh]
template <int NC, int CPL>
__device__ __forceinline__ void store_z(float* zs,
                                        const float (&acc)[CPL][4]) {
  constexpr int ldh = NC + 4;
  const LaneTile<NC, CPL> L;
#pragma unroll
  for (int q4 = 0; q4 < CPL / 4; ++q4)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<float4*>(zs + ((size_t)L.ks * kVC + L.col + k) * ldh
                                 + L.c0 + 32 * q4) =
          make_float4(acc[4 * q4][k], acc[4 * q4 + 1][k],
                      acc[4 * q4 + 2][k], acc[4 * q4 + 3][k]);
}

// z of the chunk's column k for `cell`: the slices in order, then + bias
template <int NC, int CPL>
__device__ __forceinline__ float z_at(const float* zs, const float* bs, int k,
                                      int cell) {
  constexpr int NKS = slices(NC, CPL), ldh = NC + 4;
  float z = zs[(size_t)k * ldh + cell];
#pragma unroll
  for (int s = 1; s < NKS; ++s) z += zs[((size_t)s * kVC + k) * ldh + cell];
  return z + bs[k];
}

// The two threads of a cell (lanes l and l ^ 16 of a warp: 16 vocab
// columns of a chunk each) for the logsumexp across chunks.
struct CellPair {
  int cell, half;
  bool on;
  float m = -INFINITY, s = 0.0f;
  template <int NC>
  __device__ static CellPair make() {
    CellPair p;
    const int lane = threadIdx.x & 31;
    p.cell = (threadIdx.x >> 5) * 16 + (lane & 15);
    p.half = lane >> 4;
    p.on = threadIdx.x < 2 * NC;
    return p;
  }
  // folds chunk c0's columns (z from zs) into m and s; both threads of the
  // pair end with the same values
  template <int NC, int CPL>
  __device__ void fold(const float* zs, const float* bs, int c0, int A) {
    const int lo = 16 * half, hi = min(lo + 16, A - c0);
    float cm = -INFINITY;
    for (int k = lo; k < hi; ++k)
      cm = fmaxf(cm, z_at<NC, CPL>(zs, bs, k, cell));
    cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 16));
    const float nm = fmaxf(m, cm);
    float part = 0.0f;
    for (int k = lo; k < hi; ++k)
      part += expf(z_at<NC, CPL>(zs, bs, k, cell) - nm);
    part += __shfl_xor_sync(0xffffffffu, part, 16);
    s = s * expf(m - nm) + part;
    m = nm;
  }
  __device__ float lse() const { return m + logf(s); }
};

// raises the kernel's shared-memory limit to `smem` bytes, or returns
// kErrSharedMemory when the card cannot give a block that much
template <typename Kernel>
int prepare_smem(Kernel kernel, size_t smem) {
  int smem_max = 0;
  const int e = smem_optin(&smem_max);
  if (e != 0) return e;
  if (smem > (size_t)smem_max) return kErrSharedMemory;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline int check_args(const Args& a) {
  if (a.B < 1 || a.T < 1 || a.U < 0 || a.J < 1 || a.A < 1)
    return cudaErrorInvalidValue;
  if (a.B > 65535 || u_tiles(a.U) > 65535) return cudaErrorInvalidConfiguration;
  return 0;
}

}  // namespace joint
}  // namespace pgasr
