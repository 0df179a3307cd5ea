// Fused RNN-T joint, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of pg_asr_tpu/ops/pallas_joint.py
// (via `_fused_backward`, the custom VJP of `fused_joint_log_probs`). Its
// plain version is pg_asr_tpu_torch/ops/joint.py:fused_joint_bwd_plain.
// Contract: e, g, W, bias, labels as csrc/joint_fwd.cu; gb (B, T, U+1) and
// gy (B, T, U) float32, contiguous (the cotangents of lp_blank, lp_label);
// de (B, T, J), dg (B, U+1, J), dW (J, A), db (A,) in the inputs' type; a
// float32 scratch of pgasr_joint_bwd_scratch_floats() floats; J <= 512.
// Per cell, in float32 whatever the inputs' type: h = tanh(e_t + g_u), z =
// h . W + bias, p = exp(z - max) / sum, dz = gb * 1[a = 0] + gy * 1[a =
// y_u] - (gb + gy) * p (u = U has no label cotangent), dpre = (dz . W^T) *
// (1 - h^2); de = sum_u dpre, dg = sum_t dpre, dW = sum h^T dz, db = sum
// dz, each summed in float32 and rounded once, to the output's type.
//
// What bounds it on this card: per cell J tanh and three J x A products
// (z, dz . W^T, h^T dz): 35 GFLOP at the train shape (B=64, T'=201,
// U+1=61, J=256, A=28), ~0.53 ms at the float32 67 TFLOP/s; its bytes take
// ~0.02 ms. The first kernel ran at ~27% of that peak: one thread per
// column walked a tile's 256 cells serially, tanh was computed twice per
// (cell, j), the vocab was padded to 32, and 896 blocks wrote 83 MB of
// float32 partials.
//
// Design. One block (256 threads) per (utterance b, u-tile of 32 lattice
// rows) walks all T frames in tiles of NC cells (NC / 32 frames x 32
// rows, cell = 32 frame + row; NC = 128 at J <= 256, fewer where shared
// memory asks): 128 blocks at the train shape, one wave. W stays in shared
// memory in both layouts, [JP][A4] and [A4][JP] (A4 = A rounded up to 4,
// JP = J rounded up to 256, zero-padded).
// Per tile, with a block barrier between the phases:
//   A  h = tanh(e + g) of the tile's cells, once, into shared memory as
//      [j][cell] (float4 along cells): thread j keeps g of the block's
//      rows in registers for the whole walk and loads e a tile ahead;
//   B  z = h . W + bias: warp w takes vocab columns 4w .. 4w+3 (ceil(A/4)
//      warps: no warp works on a padded group), a lane 4 cells (and a
//      slice of j where NC < 128, the slices added by a shuffle tree);
//   C  softmax and dz in place of z, two threads per cell;
//   E  dW += h^T dz: warp w vocab columns 4w .., a lane columns j = lane +
//      32 i of W; its 8 x 4 (16 x 4 at J > 256) sums stay in registers
//      over the whole walk, and so does db;
//   D  dpre = (dz . W^T) (1 - h^2) in place of h: a lane columns j = lane
//      + 32 i, a warp 8 cells (4 at J > 256) at a time, over the A vocab
//      columns only;
//   F  thread j sums its column of dpre: de over the tile's 32 rows, one
//      value per frame (a partial of this u-tile), dg of each row over the
//      frames, in registers over the whole walk.
// Every sum runs in a fixed order. The walk over all frames makes dg
// final in the block; de has one partial per u-tile (2 at the train
// shape), dW and db one per block (~4 MB in all, against 83 MB of the
// first kernel): two small passes add them in index order. No atomics:
// the same bits come out run to run.

#include "joint.cuh"

namespace pgasr {
namespace {

using joint::Args;
using joint::kJC;
using joint::kUT;
using joint::kVC;

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kMaxJ = 512;
constexpr int kMaxFrames = 4;  // frames of a tile: 128 cells / 32 rows

struct BwdArgs {
  const float* gb;  // (B, T, U+1)
  const float* gy;  // (B, T, U)
  float* de_part;   // [nU][B][T][J]
  float* dw_part;   // [blocks][J][A4]
  float* db_part;   // [blocks][A4]
  void* dg;         // (B, U+1, J), the output
};

// shared memory of a block, in floats: h, then dpre, [JP][NC + 4]; W
// [JP][A4]; W^T [A4][JP]; z, then dz, [A4][NC + 4]; bias [A4]. JP = J
// rounded up to 256 columns, the padding zero: phases D and E then need no
// test of j, which kept the compiler from overlapping a lane's columns
struct BwdSmem {
  int jp, ldh, a4;
  size_t w, wt, z, bias, total;
  __host__ __device__ BwdSmem(int J, int A, int nc)
      : jp((J + kBwdThreads - 1) / kBwdThreads * kBwdThreads), ldh(nc + 4),
        a4((A + 3) / 4 * 4), w((size_t)jp * ldh), wt(w + (size_t)jp * a4),
        z(wt + (size_t)a4 * jp), bias(z + (size_t)a4 * ldh),
        total(bias + a4) {}
};

// scratch partials, in floats
struct Sizes {
  int nU;
  long long blocks, de, dw, db;
};

Sizes sizes(int B, int T, int U, int J, int A) {
  Sizes s;
  s.nU = joint::u_tiles(U);
  s.blocks = (long long)s.nU * B;
  const int a4 = (A + 3) / 4 * 4;
  s.de = (long long)s.nU * B * T * J;
  s.dw = s.blocks * J * a4;
  s.db = s.blocks * a4;
  return s;
}

template <typename T, int JT>
__global__ void __launch_bounds__(kBwdThreads, 1)
joint_bwd_kernel(const Args a, const BwdArgs o, int nc) {
  constexpr int JW = 8 * JT;      // columns j = lane + 32 i of a lane (D, E)
  constexpr int CD = 8 / JT;      // cells of a lane's tile in phase D
  const BwdSmem L(a.J, a.A, nc);
  extern __shared__ float4 smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);  // [jp][ldh]
  float* ws = hs + L.w;                            // [jp][a4]
  float* wts = hs + L.wt;                          // [a4][jp]
  float* zs = hs + L.z;                            // [a4][ldh]
  float* bs = hs + L.bias;                         // [a4]
  const int J = a.J, A = a.A, U1 = a.U + 1, a4 = L.a4, ldh = L.ldh;
  const int jp = L.jp;
  const int ut = blockIdx.x, b = blockIdx.y, u0 = ut * kUT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int frames = nc / kUT, nq = nc / 4;
  const T* e = static_cast<const T*>(a.e);
  const T* g = static_cast<const T*>(a.g);
  {
    const T* W = static_cast<const T*>(a.W);
    const T* bias = static_cast<const T*>(a.bias);
    for (int i = tid; i < jp * a4; i += kBwdThreads) {
      const int j = i / a4, c = i - j * a4;
      const float v =
          c < A && j < J ? to_f32<T>(W[(long long)j * A + c]) : 0.0f;
      ws[i] = v;
      wts[(size_t)c * jp + j] = v;
    }
    for (int c = tid; c < a4; c += kBwdThreads)
      bs[c] = c < A ? to_f32<T>(bias[c]) : 0.0f;
  }
  // phase B: warp `warp` (< a4 / 4) takes vocab columns 4 warp ..; lane
  // (cq, ks) cells 4 cq .. 4 cq + 3 over slice ks of j
  const bool vocab_warp = warp < a4 / 4;
  const int cq = lane % nq, ks = lane / nq, nks = 32 / nq;
  const int jl = (J + nks - 1) / nks;
  const int jb_lo = min(J, ks * jl), jb_hi = min(J, jb_lo + jl);
  // phase E's sums (dW of columns j = lane + 32 i, vocab 4 warp ..; db of
  // the same vocab columns, alike in every lane), phase F's (dg of columns
  // tid + 256 jt, rows u0 ..), over the whole walk; phase A's g of the
  // same columns and rows (zero past U), in registers for the whole walk,
  // and its e of the tile's frames, loaded a tile ahead
  float dw[JW][4], db4[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dg[JT][kUT];
  float gr[JT][kUT], er[JT][kMaxFrames];
#pragma unroll
  for (int i = 0; i < JW; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) dw[i][k] = 0.0f;
#pragma unroll
  for (int jt = 0; jt < JT; ++jt) {
    const int j = tid + kBwdThreads * jt;
#pragma unroll
    for (int r = 0; r < kUT; ++r) {
      dg[jt][r] = 0.0f;
      gr[jt][r] = j < J && u0 + r < U1
                      ? to_f32<T>(g[((long long)b * U1 + u0 + r) * J + j])
                      : 0.0f;
    }
  }
  auto load_e = [&](int t0) {
#pragma unroll
    for (int jt = 0; jt < JT; ++jt) {
      const int j = tid + kBwdThreads * jt;
#pragma unroll
      for (int f = 0; f < kMaxFrames; ++f)
        er[jt][f] = j < J && f < frames && t0 + f < a.T
                        ? to_f32<T>(e[((long long)b * a.T + t0 + f) * J + j])
                        : 0.0f;
    }
  };
  load_e(0);

  for (int t0 = 0; t0 < a.T; t0 += frames) {
    __syncthreads();  // W staged; the previous tile's dpre consumed
    // A: h of the tile's cells, thread j the column j (and j + 256; zero
    // past J: e and g are)
#pragma unroll
    for (int jt = 0; jt < JT; ++jt) {
      const int j = tid + kBwdThreads * jt;
      {
#pragma unroll
        for (int f = 0; f < kMaxFrames; ++f) {
          if (f < frames) {
#pragma unroll
            for (int r4 = 0; r4 < kUT / 4; ++r4)
              *reinterpret_cast<float4*>(hs + (size_t)j * ldh + kUT * f +
                                         4 * r4) =
                  make_float4(tanhf(er[jt][f] + gr[jt][4 * r4]),
                              tanhf(er[jt][f] + gr[jt][4 * r4 + 1]),
                              tanhf(er[jt][f] + gr[jt][4 * r4 + 2]),
                              tanhf(er[jt][f] + gr[jt][4 * r4 + 3]));
          }
        }
      }
    }
    __syncthreads();
    if (t0 + frames < a.T) load_e(t0 + frames);  // used by the next tile

    // B: z = h . W + bias, in order of j within a slice, the slices added
    // by a shuffle tree
    if (vocab_warp) {
      float acc[4][4];  // [cell][vocab]
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[c][k] = 0.0f;
#pragma unroll 8
      for (int j = jb_lo; j < jb_hi; ++j) {
        const float4 h = *reinterpret_cast<const float4*>(hs + (size_t)j * ldh
                                                          + 4 * cq);
        const float4 w = *reinterpret_cast<const float4*>(ws + (size_t)j * a4
                                                          + 4 * warp);
        const float hv[4] = {h.x, h.y, h.z, h.w};
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[c][k] = fmaf(hv[c], wv[k], acc[c][k]);
      }
      for (int off = 16; off >= nq; off >>= 1)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[c][k] += __shfl_xor_sync(0xffffffffu, acc[c][k], off);
      if (ks == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float bk = bs[4 * warp + k];
          *reinterpret_cast<float4*>(zs + (size_t)(4 * warp + k) * ldh +
                                     4 * cq) =
              make_float4(acc[0][k] + bk, acc[1][k] + bk, acc[2][k] + bk,
                          acc[3][k] + bk);
        }
      }
    }
    __syncthreads();

    // C: softmax and dz in place of z, two threads per cell (lanes l and
    // l ^ 16: half the vocab each, max and sum joined by a shuffle); zero
    // outside the lattice and in the padded vocab rows
    if (tid < 2 * nc) {
      const int cell = (tid >> 5) * 16 + (lane & 15), half = lane >> 4;
      const int ah = (A + 1) / 2, c_lo = half * ah, c_hi = min(A, c_lo + ah);
      const int t = t0 + cell / kUT, u = u0 + cell % kUT;
      float* zc = zs + cell;
      float mx = -INFINITY;
      for (int c = c_lo; c < c_hi; ++c) mx = fmaxf(mx, zc[(size_t)c * ldh]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      float sum = 0.0f;
      for (int c = c_lo; c < c_hi; ++c) {  // exp(z - max) in place of z
        const float ex = expf(zc[(size_t)c * ldh] - mx);
        zc[(size_t)c * ldh] = ex;
        sum += ex;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 16);
      if (t < a.T && u < U1) {
        const long long row = (long long)b * a.T + t;
        const float gbv = o.gb[row * U1 + u];
        const float gyv = u < a.U ? o.gy[row * a.U + u] : 0.0f;
        const int y = u < a.U ? a.labels[(long long)b * a.U + u] : -1;
        const float both = (gbv + gyv) / sum;
        for (int c = c_lo; c < c_hi; ++c)
          zc[(size_t)c * ldh] = ((c == 0 ? gbv : 0.0f) + (c == y ? gyv : 0.0f))
                                - both * zc[(size_t)c * ldh];
      } else {
        for (int c = c_lo; c < c_hi; ++c) zc[(size_t)c * ldh] = 0.0f;
      }
      if (half == 1)
        for (int c = A; c < a4; ++c) zc[(size_t)c * ldh] = 0.0f;
    }
    __syncthreads();

    // E: dW += h^T dz and db += dz over the tile's cells, in cell order
    if (vocab_warp) {
      for (int q = 0; q < nq; ++q) {
        float dz[4][4];  // [vocab][cell]
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 v = *reinterpret_cast<const float4*>(
              zs + (size_t)(4 * warp + k) * ldh + 4 * q);
          dz[k][0] = v.x; dz[k][1] = v.y; dz[k][2] = v.z; dz[k][3] = v.w;
#pragma unroll
          for (int c = 0; c < 4; ++c) db4[k] += dz[k][c];
        }
#pragma unroll
        for (int i = 0; i < JW; ++i) {
          const float4 h = *reinterpret_cast<const float4*>(
              hs + (size_t)(lane + 32 * i) * ldh + 4 * q);
          const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              dw[i][k] = fmaf(hv[c], dz[k][c], dw[i][k]);
        }
      }
    }
    __syncthreads();  // h read: D overwrites it with dpre

    // D: dpre = (dz . W^T) (1 - h^2), over the A vocab columns in order
    for (int c0 = CD * warp; c0 < nc; c0 += CD * kBwdWarps) {
      float acc[JW][CD];
#pragma unroll
      for (int i = 0; i < JW; ++i)
#pragma unroll
        for (int k = 0; k < CD; ++k) acc[i][k] = 0.0f;
#pragma unroll 2
      for (int c = 0; c < A; ++c) {
        float dz[CD];
#pragma unroll
        for (int k4 = 0; k4 < CD / 4; ++k4) {
          const float4 v = *reinterpret_cast<const float4*>(
              zs + (size_t)c * ldh + c0 + 4 * k4);
          dz[4 * k4] = v.x; dz[4 * k4 + 1] = v.y;
          dz[4 * k4 + 2] = v.z; dz[4 * k4 + 3] = v.w;
        }
        const float* wr = wts + (size_t)c * jp + lane;
#pragma unroll
        for (int i = 0; i < JW; ++i) {
          const float w = wr[32 * i];
#pragma unroll
          for (int k = 0; k < CD; ++k) acc[i][k] = fmaf(dz[k], w, acc[i][k]);
        }
      }
#pragma unroll
      for (int i = 0; i < JW; ++i) {
#pragma unroll
        for (int k4 = 0; k4 < CD / 4; ++k4) {
          float4* hp = reinterpret_cast<float4*>(
              hs + (size_t)(lane + 32 * i) * ldh + c0 + 4 * k4);
          const float4 h = *hp;
          *hp = make_float4(acc[i][4 * k4] * (1.0f - h.x * h.x),
                            acc[i][4 * k4 + 1] * (1.0f - h.y * h.y),
                            acc[i][4 * k4 + 2] * (1.0f - h.z * h.z),
                            acc[i][4 * k4 + 3] * (1.0f - h.w * h.w));
        }
      }
    }
    __syncthreads();

    // F: column j of dpre -> de of each frame (over the 32 rows in order),
    // dg of each row (over the frames in order)
#pragma unroll
    for (int jt = 0; jt < JT; ++jt) {
      const int j = tid + kBwdThreads * jt;
      if (j < J) {
        const float* col = hs + (size_t)j * ldh;
        for (int f = 0; f < frames; ++f) {
          float de = 0.0f;
#pragma unroll
          for (int r4 = 0; r4 < kUT / 4; ++r4) {
            const float4 v =
                *reinterpret_cast<const float4*>(col + kUT * f + 4 * r4);
            de += v.x; de += v.y; de += v.z; de += v.w;
            dg[jt][4 * r4] += v.x;
            dg[jt][4 * r4 + 1] += v.y;
            dg[jt][4 * r4 + 2] += v.z;
            dg[jt][4 * r4 + 3] += v.w;
          }
          const int t = t0 + f;
          if (t < a.T)
            o.de_part[(((long long)ut * a.B + b) * a.T + t) * J + j] = de;
        }
      }
    }
  }

  // dg is final: this block walked every frame of rows u0 ..
  T* dgo = static_cast<T*>(o.dg);
#pragma unroll
  for (int jt = 0; jt < JT; ++jt) {
    const int j = tid + kBwdThreads * jt;
    if (j < J) {
#pragma unroll
      for (int r = 0; r < kUT; ++r)
        if (u0 + r < U1)
          dgo[((long long)b * U1 + u0 + r) * J + j] = from_f32<T>(dg[jt][r]);
    }
  }
  // this block's partials of dW and db
  const long long blk = (long long)b * gridDim.x + ut;
  if (vocab_warp) {
#pragma unroll
    for (int i = 0; i < JW; ++i) {
      const int j = lane + 32 * i;
      if (j < J)
        *reinterpret_cast<float4*>(o.dw_part + (blk * J + j) * a4 + 4 * warp) =
            make_float4(dw[i][0], dw[i][1], dw[i][2], dw[i][3]);
    }
    if (lane == 0)
      *reinterpret_cast<float4*>(o.db_part + blk * a4 + 4 * warp) =
          make_float4(db4[0], db4[1], db4[2], db4[3]);
  }
}

// de = the u-tiles' partials summed in order, one thread per element
template <typename T>
__global__ void joint_bwd_reduce_de(const float* part, long long n, int nU,
                                    T* de) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float s = 0.0f;
    for (int k = 0; k < nU; ++k) s += part[k * n + i];
    de[i] = from_f32<T>(s);
  }
}

// dW (J x A) and db (A), one warp per element: lane l sums the block
// partials l, l + 32, ... in order, then a fixed shuffle tree
template <typename T>
__global__ void joint_bwd_reduce_w(const float* dw_part, const float* db_part,
                                   long long blocks, int J, int A, int a4,
                                   T* dW, T* db) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long n = (long long)J * A + A;
  if (warp >= n) return;
  const bool is_w = warp < (long long)J * A;
  const long long j = is_w ? warp / A : 0;
  const int c = is_w ? (int)(warp % A) : (int)(warp - (long long)J * A);
  float s = 0.0f;
  for (long long k = lane; k < blocks; k += 32)
    s += is_w ? dw_part[(k * J + j) * a4 + c] : db_part[k * a4 + c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) {
    if (is_w) dW[warp] = from_f32<T>(s);
    else db[c] = from_f32<T>(s);
  }
}

// ---------------------------------------------------------------------------
// The chunked form: any A and J (joint.cuh's tile, NC = 64 cells). A block
// per (u-tile, utterance) walks every frame, as above. Per tile, pass 1
// carries the logsumexp over the vocab chunks; pass 2 recomputes each
// chunk's z, forms its dz in place and, per J piece, adds h^T dz to the
// block's dW partial and dz . W^T (1 - h^2) of the chunk to de (per frame)
// and dg (per row). These sums live in the float32 scratch, each element
// owned by one thread of one block (read, added, written back by it in a
// fixed order): dg final in the block, de one partial per u-tile, dW and
// db one per block, added by the same two reductions.
// ---------------------------------------------------------------------------

constexpr int kChunkNC = 64;
constexpr int kChunkCPL = 4;  // a lane's cells in the z product

struct ChunkedArgs {
  const float* gb;  // (B, T, U+1)
  const float* gy;  // (B, T, U)
  float* de_part;   // [nU][B][T][J]
  float* dw_part;   // [blocks][J][ap]
  float* db_part;   // [blocks][ap]
  float* dg_acc;    // [B][U+1][J]
  void* dg;         // (B, U+1, J), the output
};

struct ChunkedSizes {
  int nU, ap;
  long long blocks, de, dw, db, dg;
};

ChunkedSizes chunked_sizes(int B, int T, int U, int J, int A) {
  ChunkedSizes s;
  s.nU = joint::u_tiles(U);
  s.ap = joint::chunks(A) * kVC;
  s.blocks = (long long)s.nU * B;
  s.de = (long long)s.nU * B * T * J;
  s.dw = s.blocks * J * s.ap;
  s.db = s.blocks * s.ap;
  s.dg = (long long)B * (U + 1) * J;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(joint::kThreads, 1)
joint_bwd_chunked_kernel(const Args a, const ChunkedArgs o) {
  constexpr int NC = kChunkNC, F = NC / kUT;
  const joint::TileSmem L(NC, kChunkCPL, true);
  const int ldh = L.ldh;
  extern __shared__ float4 smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);  // [kJC][ldh]
  float* ws = hs + L.w;                            // [kJC][kVC]
  float* zs = hs + L.z;                            // [NKS][kVC][ldh]
  float* bs = hs + L.bias;                         // [kVC]
  float* wts = hs + L.wt;                          // [kVC][kLdwt]
  float* ds = hs + L.d;                            // [kJC][ldh]
  const int J = a.J, U1 = a.U + 1, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ut = blockIdx.x, b = blockIdx.y, u0 = ut * kUT;
  const int nch = joint::chunks(a.A), np = joint::pieces(J);
  const int ap = nch * kVC;
  const bool resident = nch == 1 && np == 1;
  const long long blk = (long long)b * gridDim.x + ut;
  joint::CellPair cp = joint::CellPair::make<NC>();
  const int u = u0 + cp.cell % kUT;
  const int y = cp.on && u < a.U ? a.labels[(long long)b * a.U + u] : -1;

  float gr[kUT];
  if (np == 1) joint::load_g<T>(gr, a, b, u0, tid);
  if (resident) joint::stage_w<T>(ws, wts, bs, a, 0, 0);
  // z of chunk c into zs: h staged where `stage_first` asks it of piece 0
  // or where J takes pieces
  auto chunk_z = [&](int c, int t0, bool stage_first) {
    float acc[kChunkCPL][4] = {};
    for (int p = 0; p < np; ++p) {
      const int j0 = p * kJC;
      __syncthreads();
      if (np > 1 || stage_first) {
        if (np > 1) joint::load_g<T>(gr, a, b, u0, j0 + tid);
        joint::stage_h<T, NC>(hs, a, b, t0, j0, gr);
      }
      if (!resident) joint::stage_w<T>(ws, wts, bs, a, j0, c * kVC);
      __syncthreads();
      joint::z_product<NC, kChunkCPL>(acc, hs, ws, min(kJC, J - j0));
    }
    joint::store_z<NC, kChunkCPL>(zs, acc);
    __syncthreads();
  };

  for (int t0 = 0; t0 < a.T; t0 += F) {
    const bool first = t0 == 0;
    // pass 1: the logsumexp of each cell over all chunks
    cp.m = -INFINITY;
    cp.s = 0.0f;
    for (int c = 0; c < nch; ++c) {
      chunk_z(c, t0, c == 0);
      if (cp.on) cp.fold<NC, kChunkCPL>(zs, bs, c * kVC, a.A);
    }
    const int t = t0 + cp.cell / kUT;
    const bool in = cp.on && t < a.T && u < U1;
    float gbv = 0.0f, gyv = 0.0f;
    if (in) {
      const long long row = (long long)b * a.T + t;
      gbv = o.gb[row * U1 + u];
      gyv = u < a.U ? o.gy[row * a.U + u] : 0.0f;
    }
    const float both = (gbv + gyv) / cp.s;

    // pass 2, per chunk: z again, dz in place of z (slice 0), db, then per
    // J piece dW, dpre, de and dg
    for (int c = 0; c < nch; ++c) {
      const int c0 = c * kVC;
      chunk_z(c, t0, false);
      if (cp.on) {
        for (int k = 16 * cp.half; k < 16 * cp.half + 16; ++k) {
          float dz = 0.0f;
          if (in && c0 + k < a.A) {
            const float ex =
                expf(joint::z_at<NC, kChunkCPL>(zs, bs, k, cp.cell) - cp.m);
            dz = (c0 + k == 0 ? gbv : 0.0f) + (c0 + k == y ? gyv : 0.0f)
                 - both * ex;
          }
          zs[(size_t)k * ldh + cp.cell] = dz;
        }
      }
      __syncthreads();
      if (tid < kVC) {  // db of column c0 + tid, over the cells in order
        float s = 0.0f;
        for (int q = 0; q < NC; ++q) s += zs[(size_t)tid * ldh + q];
        float* d = o.db_part + blk * ap + c0 + tid;
        *d = first ? s : *d + s;
      }
      for (int p = 0; p < np; ++p) {
        const int j0 = p * kJC;
        __syncthreads();  // the previous piece's dpre summed
        if (np > 1) {
          joint::load_g<T>(gr, a, b, u0, j0 + tid);
          joint::stage_h<T, NC>(hs, a, b, t0, j0, gr);
        }
        if (!resident) joint::stage_w<T>(ws, wts, bs, a, j0, c0);
        __syncthreads();
        // dW += h^T dz: warp `warp` vocab columns 4 warp .., a lane the
        // columns j0 + lane + 32 i, over the cells in order
        {
          float dw[kJC / 32][4] = {};
          for (int q = 0; q < NC / 4; ++q) {
            float dz[4][4];  // [vocab][cell]
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float4 v = *reinterpret_cast<const float4*>(
                  zs + (size_t)(4 * warp + k) * ldh + 4 * q);
              dz[k][0] = v.x; dz[k][1] = v.y; dz[k][2] = v.z; dz[k][3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < kJC / 32; ++i) {
              const float4 h = *reinterpret_cast<const float4*>(
                  hs + (size_t)(lane + 32 * i) * ldh + 4 * q);
              const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
              for (int cc = 0; cc < 4; ++cc)
#pragma unroll
                for (int k = 0; k < 4; ++k)
                  dw[i][k] = fmaf(hv[cc], dz[k][cc], dw[i][k]);
            }
          }
#pragma unroll
          for (int i = 0; i < kJC / 32; ++i) {
            const int j = j0 + lane + 32 * i;
            if (j < J) {
              float4* d = reinterpret_cast<float4*>(
                  o.dw_part + (blk * J + j) * ap + c0 + 4 * warp);
              float4 v = make_float4(dw[i][0], dw[i][1], dw[i][2], dw[i][3]);
              if (!first) {
                const float4 old = *d;
                v.x += old.x; v.y += old.y; v.z += old.z; v.w += old.w;
              }
              *d = v;
            }
          }
        }
        // dpre = (dz . W^T) (1 - h^2) of this chunk into ds: a lane the
        // columns lane + 32 i, a warp 4 cells at a time, over the chunk's
        // vocab columns in order
        for (int q0 = 4 * warp; q0 < NC; q0 += 4 * (joint::kThreads / 32)) {
          float acc[kJC / 32][4] = {};
          const int nk = min(kVC, a.A - c0);
          for (int k = 0; k < nk; ++k) {
            const float4 v =
                *reinterpret_cast<const float4*>(zs + (size_t)k * ldh + q0);
            const float dz[4] = {v.x, v.y, v.z, v.w};
            const float* wr = wts + (size_t)k * joint::kLdwt + lane;
#pragma unroll
            for (int i = 0; i < kJC / 32; ++i) {
              const float w = wr[32 * i];
#pragma unroll
              for (int cc = 0; cc < 4; ++cc)
                acc[i][cc] = fmaf(dz[cc], w, acc[i][cc]);
            }
          }
#pragma unroll
          for (int i = 0; i < kJC / 32; ++i) {
            const size_t r = (size_t)(lane + 32 * i) * ldh + q0;
            const float4 h = *reinterpret_cast<const float4*>(hs + r);
            *reinterpret_cast<float4*>(ds + r) =
                make_float4(acc[i][0] * (1.0f - h.x * h.x),
                            acc[i][1] * (1.0f - h.y * h.y),
                            acc[i][2] * (1.0f - h.z * h.z),
                            acc[i][3] * (1.0f - h.w * h.w));
          }
        }
        __syncthreads();
        // column j of dpre -> de of each frame (over the 32 rows in order)
        // and dg of each row (over the frames in order)
        const int j = j0 + tid;
        if (j < J) {
          const float* col = ds + (size_t)tid * ldh;
          float dgl[kUT] = {};
#pragma unroll
          for (int f = 0; f < F; ++f) {
            float de = 0.0f;
#pragma unroll
            for (int r = 0; r < kUT; ++r) {
              const float v = col[kUT * f + r];
              de += v;
              dgl[r] += v;
            }
            if (t0 + f < a.T) {
              float* d = o.de_part +
                         (((long long)ut * a.B + b) * a.T + t0 + f) * J + j;
              *d = c == 0 ? de : *d + de;
            }
          }
#pragma unroll
          for (int r = 0; r < kUT; ++r) {
            if (u0 + r < U1) {
              float* d = o.dg_acc + ((long long)b * U1 + u0 + r) * J + j;
              *d = first && c == 0 ? dgl[r] : *d + dgl[r];
            }
          }
        }
      }
    }
  }

  // dg is final: this block walked every frame of rows u0 ..
  T* dgo = static_cast<T*>(o.dg);
  for (int j = tid; j < J; j += joint::kThreads)
    for (int r = 0; r < kUT && u0 + r < U1; ++r) {
      const long long i = ((long long)b * U1 + u0 + r) * J + j;
      dgo[i] = from_f32<T>(o.dg_acc[i]);
    }
}

// the two reductions of the partials: de over the u-tiles, dW and db over
// the blocks (`ap` the partials' vocab stride)
template <typename T>
int reduce(const Args& a, const float* de_part, const float* dw_part,
           const float* db_part, int nU, long long blocks, int ap, void* de,
           void* dW, void* db, cudaStream_t stream) {
  const long long n_de = (long long)a.B * a.T * a.J;
  const long long de_blocks = (n_de + 255) / 256;
  joint_bwd_reduce_de<T><<<(unsigned)(de_blocks < 4096 ? de_blocks : 4096),
                           256, 0, stream>>>(de_part, n_de, nU,
                                             static_cast<T*>(de));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long warps = (long long)a.J * a.A + a.A;
  joint_bwd_reduce_w<T><<<(unsigned)((warps + 7) / 8), 256, 0, stream>>>(
      dw_part, db_part, blocks, a.J, a.A, ap, static_cast<T*>(dW),
      static_cast<T*>(db));
  return cudaGetLastError();
}

template <typename T>
int launch_chunked(const Args& a, const float* gb, const float* gy,
                   float* scratch, void* de, void* dg, void* dW, void* db,
                   cudaStream_t stream) {
  const size_t smem =
      joint::TileSmem(kChunkNC, kChunkCPL, true).total * sizeof(float);
  const int rc = joint::prepare_smem(joint_bwd_chunked_kernel<T>, smem);
  if (rc != 0) return rc;
  const ChunkedSizes s = chunked_sizes(a.B, a.T, a.U, a.J, a.A);
  const ChunkedArgs o{gb, gy, scratch, scratch + s.de, scratch + s.de + s.dw,
                      scratch + s.de + s.dw + s.db, dg};
  joint_bwd_chunked_kernel<T><<<dim3(s.nU, a.B), joint::kThreads, smem,
                                stream>>>(a, o);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce<T>(a, o.de_part, o.dw_part, o.db_part, s.nU, s.blocks, s.ap,
                   de, dW, db, stream);
}

// cells of a tile of the resident form: the most of 128, 64, 32 whose
// shared memory fits (0 if none does)
int tile_cells(int J, int A, int smem_max) {
  for (int nc : {128, 64, 32})
    if (BwdSmem(J, A, nc).total * sizeof(float) <= (size_t)smem_max)
      return nc;
  return 0;
}

// the resident form takes A <= 32 and J <= 512 where its tile fits; every
// other shape runs the chunked form
bool resident_form(int J, int A) {
  int smem_max = 0;
  if (A > kVC || J > kMaxJ || smem_optin(&smem_max) != 0) return false;
  return tile_cells(J, A, smem_max) > 0;
}

template <typename T, int JT>
int launch(const Args& a, const float* gb, const float* gy, float* scratch,
           void* de, void* dg, void* dW, void* db, cudaStream_t stream) {
  int smem_max = 0;
  const int e = smem_optin(&smem_max);
  if (e != 0) return e;
  const int nc = tile_cells(a.J, a.A, smem_max);
  if (nc == 0) return kErrSharedMemory;
  const size_t smem = BwdSmem(a.J, a.A, nc).total * sizeof(float);
  int rc = joint::prepare_smem(joint_bwd_kernel<T, JT>, smem);
  if (rc != 0) return rc;
  const Sizes s = sizes(a.B, a.T, a.U, a.J, a.A);
  const BwdArgs o{gb, gy, scratch, scratch + s.de, scratch + s.de + s.dw, dg};
  joint_bwd_kernel<T, JT><<<dim3(s.nU, a.B), kBwdThreads, smem, stream>>>(
      a, o, nc);
  const cudaError_t le = cudaGetLastError();
  if (le != cudaSuccess) return le;
  return reduce<T>(a, o.de_part, o.dw_part, o.db_part, s.nU, s.blocks,
                   (a.A + 3) / 4 * 4, de, dW, db, stream);
}

template <typename T>
int dispatch(const Args& a, const float* gb, const float* gy, float* scratch,
             void* de, void* dg, void* dW, void* db, cudaStream_t stream) {
  if (!resident_form(a.J, a.A))
    return launch_chunked<T>(a, gb, gy, scratch, de, dg, dW, db, stream);
  if (a.J <= 256)
    return launch<T, 1>(a, gb, gy, scratch, de, dg, dW, db, stream);
  return launch<T, 2>(a, gb, gy, scratch, de, dg, dW, db, stream);
}

}  // namespace
}  // namespace pgasr

extern "C" {

// Floats of float32 scratch that pgasr_joint_bwd needs.
long long pgasr_joint_bwd_scratch_floats(int B, int T, int U, int J, int A) {
  using namespace pgasr;
  if (!resident_form(J, A)) {
    const ChunkedSizes s = chunked_sizes(B, T, U, J, A);
    return s.de + s.dw + s.db + s.dg;
  }
  const Sizes s = sizes(B, T, U, J, A);
  return s.de + s.dw + s.db;
}

// dtype 0 float32, 1 bfloat16 (of e, g, W, bias and the outputs). Returns
// 0, kErrSharedMemory, kErrDtype or a launch's cudaError_t.
int pgasr_joint_bwd(const void* e, const void* g, const void* W,
                    const void* bias, const int* labels, const float* gb,
                    const float* gy, float* scratch, void* de, void* dg,
                    void* dW, void* db, int B, int T, int U, int J, int A,
                    int dtype, void* stream) {
  using namespace pgasr;
  const joint::Args a{e, g, W, bias, labels, B, T, U, J, A};
  const int rc = joint::check_args(a);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(a, gb, gy, scratch, de, dg, dW, db, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(a, gb, gy, scratch, de, dg, dW, db, s);
  return kErrDtype;
}

}  // extern "C"
