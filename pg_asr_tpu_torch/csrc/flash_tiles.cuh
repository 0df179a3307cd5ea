// Tile helpers of the flash-attention kernels (flash_attn.cu,
// flash_attn_bwd.cu): 64-row tiles of (.., T, dh) slices, the segment-id
// ranges that decide which (query tile, key tile) pairs are skipped, and
// the ldmatrix lane offsets of the tensor-core paths.
#pragma once

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace pgasr {
namespace {

constexpr int kBT = 64;  // rows of a query or key tile
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;  // -0.7 * FLT_MAX

// bytes of one flag per walked tile, after a kernel's fixed shared arrays
size_t flag_bytes(int T) {
  return ((size_t)(T + kBT - 1) / kBT + 15) / 16 * 16;
}

// (min, max) of the segment ids of rows t0 .. t0 + kBT - 1 below Tn, in
// every lane of the calling warp; (INT_MAX, INT_MIN) for no row
__device__ __forceinline__ int2 seg_range(const int* seg, int t0, int Tn) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = INT_MIN;
  if (t0 + lane < Tn) lo = hi = seg[t0 + lane];
  if (t0 + lane + 32 < Tn) {
    const int s = seg[t0 + lane + 32];
    lo = min(lo, s);
    hi = max(hi, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return make_int2(lo, hi);
}

// flags[t] for each walked tile t: 0 where the segment-id ranges of tile t
// and of the held tile (rows h0 ..) are disjoint, so that no (query, key)
// pair of the two shares a segment and every score of the pair carries the
// mask, so that p (and ds) are exactly 0 (the pair is skipped), else 1;
// ops/flash_attn.py
// kept_tile_pairs. The caller synchronises before reading them.
template <int NT>
__device__ void tile_flags(unsigned char* flags, const int* seg, int h0,
                           int Tn) {
  const int2 held = seg_range(seg, h0, Tn);
  const int n = (Tn + kBT - 1) / kBT;
  for (int t = threadIdx.x / 32; t < n; t += NT / 32) {
    const int2 r = seg_range(seg, t * kBT, Tn);
    if ((threadIdx.x & 31) == 0) flags[t] = !(r.y < held.x || held.y < r.x);
  }
}

// the first kept tile at or after t (n if none)
__device__ __forceinline__ int next_kept(const unsigned char* flags, int t,
                                         int n) {
  while (t < n && !flags[t]) ++t;
  return t;
}

// rows t0 .. t0 + kBT - 1 of a strided (.., T, dh) slice into a shared tile
// of DH columns (the instance: dh <= DH) and row stride LD elements, by NT
// threads; rows at or beyond Tn and columns at or beyond dh are zero-filled
// (zero columns change no score and no output). With `vec` (rows and dh
// whole 16-byte vectors) by 16-byte cp.async, which the caller commits;
// else element by element.
template <typename T, int DH, int LD, int NT>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                long long st, int t0, int Tn,
                                                int dh, bool vec) {
  constexpr int kVec = 16 / sizeof(T), kRowVecs = DH / kVec;
  static_assert(kBT * kRowVecs % NT == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < kBT * kRowVecs / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / kRowVecs, c = (e % kRowVecs) * kVec, t = t0 + r;
    if (vec) {
      const bool in = t < Tn && c < dh;
      cp_async16(dst + r * LD + c, in ? src + (long long)t * st + c : src, in);
    } else {
#pragma unroll
      for (int x = 0; x < kVec; ++x)
        dst[r * LD + c + x] = t < Tn && c + x < dh
                                  ? src[(long long)t * st + c + x]
                                  : from_f32<T>(0.0f);
    }
  }
}

// columns col, col + 1 of an output row, those below dh: one 4-byte store
// where `vec` (dh a whole number of 16-byte vectors, so col + 1 < dh
// whenever col < dh, and the row 16-byte aligned), else element by element
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int col,
                                           float lo, float hi, int dh,
                                           bool vec) {
  if (col >= dh) return;
  if (vec) {
    *reinterpret_cast<unsigned*>(row + col) = pack_bf16x2(lo, hi);
  } else {
    row[col] = __float2bfloat16_rn(lo);
    if (col + 1 < dh) row[col + 1] = __float2bfloat16_rn(hi);
  }
}

// Head dims past the instances (32, 64, 128) run the wide kernels
// (flash_attn.cu, flash_attn_bwd.cu): float32 tiles of kWideDh columns with
// rows padded by one (a lane per row reads one column of 32 rows from 32
// banks), a lane per key of a walked tile of kWideKeys, the head dim walked
// in order, in pieces of kWideDh past it (a block per output piece).
constexpr int kWideDh = 256;
constexpr int kWideKeys = 32;
constexpr int kWideLd = kWideDh + 1;

// rows t0 .. t0 + rows - 1 of a strided (.., T, dh) slice into shared
// memory as float32 [rows][kWideLd], by nt threads: zero past T and, up to
// kWideDh, past dh
template <typename T>
__device__ __forceinline__ void load_wide(float* dst, const T* src,
                                          long long st, int t0, int rows,
                                          int Tn, int dh, int nt) {
  for (int i = threadIdx.x; i < rows * kWideDh; i += nt) {
    const int r = i / kWideDh, d = i - r * kWideDh, t = t0 + r;
    dst[r * kWideLd + d] =
        t < Tn && d < dh ? to_f32<T>(src[(long long)t * st + d]) : 0.0f;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// whether every row of the `n_in` inputs (pointers, strides in elements)
// and of the `n_out` outputs (strides) is whole 16-byte vectors of `vec`
// elements, dh among them
inline int rows_vectorised(const void* const* in, const long long* const* st,
                           int n_in, const long long* const* so, int n_out,
                           int dh, long long vec) {
  if (dh % vec != 0) return 0;
  for (int i = 0; i < n_in; ++i) {
    if (reinterpret_cast<uintptr_t>(in[i]) % 16 != 0) return 0;
    for (int j = 0; j < 3; ++j)
      if (st[i][j] % vec != 0) return 0;
  }
  for (int i = 0; i < n_out; ++i)
    for (int j = 0; j < 3; ++j)
      if (so[i][j] % 2 != 0) return 0;  // the bf16 pair stores
  return 1;
}

// ldmatrix row offsets of this lane: A fragments (16 x 16, rows of the
// held tile), B fragments of two 8-wide n-tiles (rows of a tile stored
// [n][k]), and B fragments read transposed (rows of a tile stored [k][n])
struct Lanes {
  int arow, acol, brow, bcol, trow, tcol;
  __device__ Lanes(int lane)
      : arow(lane & 15), acol(8 * (lane >> 4)),
        brow((lane & 7) + 8 * (lane >> 4)), bcol(8 * ((lane >> 3) & 1)),
        trow((lane & 7) + 8 * ((lane >> 3) & 1)), tcol(8 * (lane >> 4)) {}
};

}  // namespace
}  // namespace pgasr
