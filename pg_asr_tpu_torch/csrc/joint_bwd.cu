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
using joint::kUT;

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

// cells of a tile: the most of 128, 64, 32 whose shared memory fits (0 if
// none does)
int tile_cells(int J, int A, int smem_max) {
  for (int nc : {128, 64, 32})
    if (BwdSmem(J, A, nc).total * sizeof(float) <= (size_t)smem_max)
      return nc;
  return 0;
}

template <typename T, int JT>
int launch(const Args& a, const float* gb, const float* gy, float* scratch,
           void* de, void* dg, void* dW, void* db, cudaStream_t stream) {
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int nc = tile_cells(a.J, a.A, smem_max);
  if (nc == 0) return kErrSharedMemory;
  const size_t smem = BwdSmem(a.J, a.A, nc).total * sizeof(float);
  int rc = joint::prepare_smem(joint_bwd_kernel<T, JT>, smem);
  if (rc != 0) return rc;
  const Sizes s = sizes(a.B, a.T, a.U, a.J, a.A);
  const BwdArgs o{gb, gy, scratch, scratch + s.de, scratch + s.de + s.dw, dg};
  joint_bwd_kernel<T, JT><<<dim3(s.nU, a.B), kBwdThreads, smem, stream>>>(
      a, o, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n_de = (long long)a.B * a.T * a.J;
  const long long de_blocks = (n_de + 255) / 256;
  joint_bwd_reduce_de<T><<<(unsigned)(de_blocks < 4096 ? de_blocks : 4096),
                           256, 0, stream>>>(o.de_part, n_de, s.nU,
                                             static_cast<T*>(de));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long warps = (long long)a.J * a.A + a.A;
  joint_bwd_reduce_w<T><<<(unsigned)((warps + 7) / 8), 256, 0, stream>>>(
      o.dw_part, o.db_part, s.blocks, a.J, a.A, (a.A + 3) / 4 * 4,
      static_cast<T*>(dW), static_cast<T*>(db));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, const float* gb, const float* gy, float* scratch,
             void* de, void* dg, void* dW, void* db, cudaStream_t stream) {
  if (a.J <= 256)
    return launch<T, 1>(a, gb, gy, scratch, de, dg, dW, db, stream);
  if (a.J <= kMaxJ)
    return launch<T, 2>(a, gb, gy, scratch, de, dg, dW, db, stream);
  return kErrSharedMemory;
}

}  // namespace
}  // namespace pgasr

extern "C" {

// Floats of float32 scratch that pgasr_joint_bwd needs (0 for a vocab size
// it does not take).
long long pgasr_joint_bwd_scratch_floats(int B, int T, int U, int J, int A) {
  using namespace pgasr;
  if (joint::padded_vocab(A) == 0) return 0;
  const Sizes s = sizes(B, T, U, J, A);
  return s.de + s.dw + s.db;
}

// dtype 0 float32, 1 bfloat16 (of e, g, W, bias and the outputs). Returns
// 0, kErrVocab, kErrSharedMemory (J above 512, or a tile that does not
// fit), kErrDtype or a launch's cudaError_t.
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
