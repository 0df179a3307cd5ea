// Fused RNN-T joint, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of pg_asr_tpu/ops/pallas_joint.py
// (via `_fused_backward`, the custom VJP of `fused_joint_log_probs`). Its
// plain version is pg_asr_tpu_torch/ops/joint.py:fused_joint_bwd_plain.
// Contract: e, g, W, bias, labels as csrc/joint_fwd.cu; gb (B, T, U+1) and
// gy (B, T, U) float32, contiguous (the cotangents of lp_blank, lp_label);
// de (B, T, J), dg (B, U+1, J), dW (J, A), db (A,) in the inputs' type; a
// float32 scratch of pgasr_joint_bwd_scratch_floats() floats.
// Per cell, in float32: h and z recomputed as the forward, p = exp(z -
// max) / sum, dz = gb * 1[a = 0] + gy * 1[a = y_u] - (gb + gy) * p (u = U
// has no label cotangent), dpre = (dz . W^T) * (1 - h^2); de = sum_u dpre,
// dg = sum_t dpre, dW = sum h^T dz, db = sum dz, each summed in float32 and
// rounded once, to the output's type, at the end.
//
// No atomics, and every output summed in a fixed order (the Pallas kernel
// accumulates dg over the T-tiles and dW, db over the whole grid in
// scratch that the TPU's sequential grid keeps; here blocks run in any
// order). Pass 1 (joint_bwd_kernel), one block per (b, u-tile, walk of 4
// T-tiles) as the forward:
//   phase 1, one thread per cell: z, p and dz, staged in shared memory;
//   phase 2, one thread per column j: over the tile's cells in (u, t)
//   order it recomputes h, forms dh = dz . W[j] and dpre, and sums
//     de over the u-tile's rows       -> de_part [u-tile][b][t][j]
//     dg over the walk's frames       -> dg_part [walk][b][u][j]
//     dW over the block's cells       -> dw_part [block][j][a]
//   and db over the block's cells (threads a < AP) -> db_part [block][a];
//   each partial has one owner thread, which adds each tile to it in turn.
// Pass 2 sums the partials in index order: de and dg one thread per
// element (2 and 7 partials at the train shape), dW and db one warp per
// element (strided over the 896 block partials, then a shuffle tree).
// At B=64, T'=201, U+1=61, J=256, A=28 the scratch is ~83 MB.
//
// What bounds it on this card: per cell J tanh and three J x A products
// (z, dz . W^T, h^T dz): 33.7 GFLOP at the train shape, ~0.50 ms at the
// float32 67 TFLOP/s; its bytes (inputs, outputs, the scratch written and
// read once) take ~0.05 ms. Tensor cores are later work.

#include "joint.cuh"

namespace pgasr {
namespace {

using joint::Args;
using joint::kTT;
using joint::kUT;

struct BwdArgs {
  const float* gb;  // (B, T, U+1)
  const float* gy;  // (B, T, U)
  float* de_part;   // [nU][B][T][J]
  float* dg_part;   // [nW][B][U+1][J]
  float* dw_part;   // [blocks][J][AP]
  float* db_part;   // [blocks][AP]
};

struct Sizes {
  int nW, nU;
  long long blocks, de, dg, dw, db;  // floats of each partial
};

Sizes sizes(int B, int T, int U, int J, int AP) {
  Sizes s;
  s.nW = joint::t_walks(T);
  s.nU = joint::u_tiles(U);
  s.blocks = (long long)s.nW * s.nU * B;
  s.de = (long long)s.nU * B * T * J;
  s.dg = (long long)s.nW * B * (U + 1) * J;
  s.dw = s.blocks * J * AP;
  s.db = s.blocks * AP;
  return s;
}

template <typename T, int AP>
__global__ void __launch_bounds__(joint::kThreads, 2)
joint_bwd_kernel(const Args a, const BwdArgs o) {
  constexpr int LDZ = AP + 4;  // dz rows, padded against bank conflicts
  extern __shared__ float4 smem_raw[];
  float* Ws = reinterpret_cast<float*>(smem_raw);
  float* Gs = Ws + a.J * AP;
  float* Es = Gs + kUT * (a.J + 1);
  float* Dz = Es + kTT * a.J;  // [kTT * kUT][LDZ]

  const int b = blockIdx.z, u0 = blockIdx.y * kUT;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int J = a.J, U1 = a.U + 1, u = u0 + lane;
  const long long blk =
      ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
      blockIdx.x;
  float* dwp = o.dw_part + blk * J * AP;
  float* dbp = o.db_part + blk * AP;
  joint::load_w_g<T, AP>(Ws, Gs, a, b, u0);
  float bz[AP];
  joint::load_bias<T, AP>(bz, a);
  const int y = u < a.U ? a.labels[(long long)b * a.U + u] : -1;
  const int nu = min(kUT, U1 - u0);

  for (int k = 0; k < joint::kTilesPerBlock; ++k) {
    const int t0 = (blockIdx.x * joint::kTilesPerBlock + k) * kTT;
    if (t0 >= a.T) break;
    const int nt = min(kTT, a.T - t0);
    __syncthreads();  // W and g staged; the previous tile's e and dz consumed
    joint::load_e<T>(Es, a, b, t0);
    __syncthreads();

    // phase 1: this thread's cell -> dz (zero outside the lattice)
    {
      float z[AP];
      joint::cell_logits<AP>(z, Es, Gs, Ws, bz, J, w, lane);
      const int t = t0 + w;
      float dz[AP];
#pragma unroll
      for (int c = 0; c < AP; ++c) dz[c] = 0.0f;
      if (t < a.T && u < U1) {
        float m, s;
        joint::max_sum<AP>(z, a.A, &m, &s);
        const long long row = (long long)b * a.T + t;
        const float gbv = o.gb[row * U1 + u];
        const float gyv = u < a.U ? o.gy[row * a.U + u] : 0.0f;
        const float both = gbv + gyv;
#pragma unroll
        for (int c = 0; c < AP; ++c) {
          if (c < a.A) {
            const float p = expf(z[c] - m) / s;
            dz[c] = ((c == 0 ? gbv : 0.0f) + (c == y ? gyv : 0.0f)) - both * p;
          }
        }
      }
      float4* dr = reinterpret_cast<float4*>(Dz + (w * kUT + lane) * LDZ);
#pragma unroll
      for (int c = 0; c < AP / 4; ++c)
        dr[c] = make_float4(dz[4 * c], dz[4 * c + 1], dz[4 * c + 2],
                            dz[4 * c + 3]);
    }
    __syncthreads();

    // phase 2: one thread per column j, over the tile's cells in (u, t)
    // order
    for (int j = threadIdx.x; j < J; j += joint::kThreads) {
      float wj[AP], dwj[AP], de[kTT];
      const float4* wr = reinterpret_cast<const float4*>(Ws + j * AP);
      float4* dwr = reinterpret_cast<float4*>(dwp + (long long)j * AP);
#pragma unroll
      for (int c = 0; c < AP / 4; ++c) {
        const float4 v = wr[c];
        wj[4 * c] = v.x; wj[4 * c + 1] = v.y;
        wj[4 * c + 2] = v.z; wj[4 * c + 3] = v.w;
        const float4 d = k == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : dwr[c];
        dwj[4 * c] = d.x; dwj[4 * c + 1] = d.y;
        dwj[4 * c + 2] = d.z; dwj[4 * c + 3] = d.w;
      }
#pragma unroll
      for (int q = 0; q < kTT; ++q) de[q] = 0.0f;
      for (int r = 0; r < nu; ++r) {
        const float gv = Gs[r * (J + 1) + j];
        float dgv = 0.0f;
#pragma unroll
        for (int q = 0; q < kTT; ++q) {
          if (q < nt) {
            const float h = tanhf(Es[q * J + j] + gv);
            const float4* dzr =
                reinterpret_cast<const float4*>(Dz + (q * kUT + r) * LDZ);
            float dh = 0.0f;
#pragma unroll
            for (int c = 0; c < AP / 4; ++c) {
              const float4 d = dzr[c];
              dh = fmaf(d.x, wj[4 * c], dh);
              dh = fmaf(d.y, wj[4 * c + 1], dh);
              dh = fmaf(d.z, wj[4 * c + 2], dh);
              dh = fmaf(d.w, wj[4 * c + 3], dh);
              dwj[4 * c] = fmaf(h, d.x, dwj[4 * c]);
              dwj[4 * c + 1] = fmaf(h, d.y, dwj[4 * c + 1]);
              dwj[4 * c + 2] = fmaf(h, d.z, dwj[4 * c + 2]);
              dwj[4 * c + 3] = fmaf(h, d.w, dwj[4 * c + 3]);
            }
            const float dpre = dh * (1.0f - h * h);
            de[q] += dpre;
            dgv += dpre;
          }
        }
        float* dgp = o.dg_part +
            (((long long)blockIdx.x * a.B + b) * U1 + u0 + r) * J + j;
        *dgp = k == 0 ? dgv : *dgp + dgv;
      }
#pragma unroll
      for (int q = 0; q < kTT; ++q)
        if (q < nt)
          o.de_part[(((long long)blockIdx.y * a.B + b) * a.T + t0 + q) * J +
                    j] = de[q];
#pragma unroll
      for (int c = 0; c < AP / 4; ++c)
        dwr[c] = make_float4(dwj[4 * c], dwj[4 * c + 1], dwj[4 * c + 2],
                             dwj[4 * c + 3]);
    }
    // db over the tile's cells, in cell order (padding cells hold dz = 0)
    if (threadIdx.x < AP) {
      float s = k == 0 ? 0.0f : dbp[threadIdx.x];
      for (int cell = 0; cell < kTT * kUT; ++cell) s += Dz[cell * LDZ + threadIdx.x];
      dbp[threadIdx.x] = s;
    }
  }
}

// pass 2a: de and dg, one thread per element, partials summed in index
// order and rounded once to the output type
template <typename T>
__global__ void joint_bwd_reduce_eg(const float* de_part, const float* dg_part,
                                    long long n_de, long long n_dg, int nU,
                                    int nW, T* de, T* dg) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_de + n_dg; i += stride) {
    if (i < n_de) {
      float s = 0.0f;
      for (int k = 0; k < nU; ++k) s += de_part[k * n_de + i];
      de[i] = from_f32<T>(s);
    } else {
      const long long r = i - n_de;
      float s = 0.0f;
      for (int k = 0; k < nW; ++k) s += dg_part[k * n_dg + r];
      dg[r] = from_f32<T>(s);
    }
  }
}

// pass 2b: dW (J x A) and db (A), one warp per element: lane l sums the
// block partials l, l + 32, ... in order, then a fixed shuffle tree
template <typename T, int AP>
__global__ void joint_bwd_reduce_w(const float* dw_part, const float* db_part,
                                   long long blocks, int J, int A, T* dW,
                                   T* db) {
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
    s += is_w ? dw_part[(k * J + j) * AP + c] : db_part[k * AP + c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) {
    if (is_w) dW[warp] = from_f32<T>(s);
    else db[c] = from_f32<T>(s);
  }
}

template <typename T, int AP>
int launch(const Args& a, const float* gb, const float* gy, float* scratch,
           void* de, void* dg, void* dW, void* db, cudaStream_t stream) {
  const Sizes s = sizes(a.B, a.T, a.U, a.J, AP);
  const BwdArgs o{gb, gy, scratch, scratch + s.de, scratch + s.de + s.dg,
                  scratch + s.de + s.dg + s.dw};
  const size_t smem = (joint::tile_floats(a.J, AP)
                       + (size_t)kTT * kUT * (AP + 4)) * sizeof(float);
  int rc = joint::prepare_smem(joint_bwd_kernel<T, AP>, smem);
  if (rc != 0) return rc;
  const dim3 grid(s.nW, s.nU, a.B);
  joint_bwd_kernel<T, AP><<<grid, joint::kThreads, smem, stream>>>(a, o);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const long long n_de = (long long)a.B * a.T * a.J;
  const long long n_dg = (long long)a.B * (a.U + 1) * a.J;
  const long long eg_blocks = (n_de + n_dg + 255) / 256;
  joint_bwd_reduce_eg<T><<<(unsigned)(eg_blocks < 4096 ? eg_blocks : 4096),
                           256, 0, stream>>>(
      o.de_part, o.dg_part, n_de, n_dg, s.nU, s.nW, static_cast<T*>(de),
      static_cast<T*>(dg));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long warps = (long long)a.J * a.A + a.A;
  joint_bwd_reduce_w<T, AP><<<(unsigned)((warps + 7) / 8), 256, 0, stream>>>(
      o.dw_part, o.db_part, s.blocks, a.J, a.A, static_cast<T*>(dW),
      static_cast<T*>(db));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, const float* gb, const float* gy, float* scratch,
             void* de, void* dg, void* dW, void* db, cudaStream_t stream) {
  switch (joint::padded_vocab(a.A)) {
    case 8: return launch<T, 8>(a, gb, gy, scratch, de, dg, dW, db, stream);
    case 16: return launch<T, 16>(a, gb, gy, scratch, de, dg, dW, db, stream);
    case 32: return launch<T, 32>(a, gb, gy, scratch, de, dg, dW, db, stream);
  }
  return kErrVocab;
}

}  // namespace
}  // namespace pgasr

extern "C" {

// Floats of float32 scratch that pgasr_joint_bwd needs (0 for a vocab size
// it does not take).
long long pgasr_joint_bwd_scratch_floats(int B, int T, int U, int J, int A) {
  using namespace pgasr;
  const int AP = joint::padded_vocab(A);
  if (AP == 0) return 0;
  const Sizes s = sizes(B, T, U, J, AP);
  return s.de + s.dg + s.dw + s.db;
}

// dtype 0 float32, 1 bfloat16 (of e, g, W, bias and the outputs). Returns
// 0, kErrVocab, kErrSharedMemory, kErrDtype or a launch's cudaError_t.
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
