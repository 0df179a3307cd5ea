// Fused-direction masked BiLSTM backward (reverse walk of both directions),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel pg_asr_tpu/ops/pallas_lstm.py:_kernel_bi_bwd (via
// _pallas_bi_backward, the backward of pallas_bilstm_scan's custom VJP).
// Same contract and numerics:
//   xpf, xpb   (B, T, 4H)  the forward's per-direction x@W + b, f32 or bf16
//   Uf, Ub     (H, 4H)     recurrent weights, xp's type
//   mask       (B, T)      float32, > 0 at valid steps
//   hpf, hpb   (T, B, H)   each direction's carry h before step t, xp's type
//   cpf, cpb   (T, B, H)   each direction's carry c before step t, float32
//   gy         (B, T, 2H)  gradient of the output concat(forward, backward)
//   dxpf, dxpb (B, T, 4H)  out: each direction's dpre in xp's type
//   dUf, dUb   (H, 4H)     out: sum over steps of hprev^T @ dpre_mx, U's type
// Walk step s visits time T-1-s of the forward direction and time s of the
// backward direction (the reverse of bilstm_fwd's walk). Each direction
// has lstm_bwd.cu's (and _kernel_bwd's) numerics: float32 carries dh, dc,
// a float32 dU accumulator, the gates recomputed from xp_t + hprev_t @ U,
// dpre rounded to U's type (dpre_mx) for both products, padded steps
// passing dh and dc through.
//
// What bounds it on this card: as lstm_bwd, the latency of a chain of T
// dependent steps (three small products each, an exchange of dpre_mx
// through L2 and a grid barrier), not FLOPs or HBM bytes. One launch for
// both directions halves the chains.
//
// Design: lstm_bwd.cu's, with the grid split into two halves, one per
// direction, and one barrier per step serving both. NJ as in bilstm_fwd.cu
// (4 hidden units per block at H = 256: 2 x 64 blocks, one per SM). Per
// direction the dpre_mx exchange is lstm_bwd's double-buffered global
// (B, 4H) array in U's type; with two directions twice its bytes cross L2
// per step, each block reading only its own direction's. Shared memory at
// NJ = 4, f32: U's 16 gate columns (16 KB), its 4 rows (16 KB), the dU
// accumulators (16 columns x 512 threads, 32 KB), the carries and the
// step's dpre_mx (6 KB at B = 64). The dU accumulators live in shared
// memory across the walk (column-major, so the accesses are free of bank
// conflicts) and in registers only during phase C: at NJ = 4 a thread's 16
// sums held in registers over the whole walk would crowd phases A and B;
// moving a float between the two is exact, so the sums are lstm_bwd's.
// dUf and dUb need no atomics: each column has one owning block, which
// sums over rows in a fixed order, so two runs give equal bits.
// The step code is lstm_bwd.cu's, kept in its own copy: the two kernels
// compiled from one shared template ran lstm_bwd up to 3.8% slower in
// bf16 with the same bits (kernel_ab.py, PERF.md), and lstm_bwd keeps its
// timing.
// Numerics: a lane's partial dot products (k = lane, lane + 32, .. with
// fmaf), the warp reductions (a fixed tree over lane bits) and the dU sums
// (rows b = g, g + G, .. then the G partials in order) do not depend on NJ,
// so each direction gives lstm_bwd's bits.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pgasr;

constexpr int kRowsA = 4;  // batch rows a warp takes at once in phase A

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
bilstm_bwd_kernel(const T* __restrict__ xpf, const T* __restrict__ xpb,
                  const T* __restrict__ Uf, const T* __restrict__ Ub,
                  const float* __restrict__ mask, const T* __restrict__ hpf,
                  const float* __restrict__ cpf, const T* __restrict__ hpb,
                  const float* __restrict__ cpb, const T* __restrict__ gy,
                  T* __restrict__ dxpf, T* __restrict__ dxpb,
                  T* __restrict__ dUf, T* __restrict__ dUb, T* dbuf, int B,
                  int T_len, int H) {
  constexpr int C = 4 * NJ;   // gate columns of this block
  constexpr int RB = 8 / NJ;  // rows a warp takes at once in phase B
  static_assert(RB * C == 32, "one partial sum per lane after the reduction");
  const int H4 = 4 * H;
  extern __shared__ float smem[];
  float* ucol_s = smem;             // [C][H]: column c = g*NJ + jj is U[:, g*H + j0 + jj]
  float* urow_s = ucol_s + C * H;   // [NJ][4H]: row jj is U[j0 + jj, :]
  float* dh_s = urow_s + NJ * H4;   // [B][NJ] dh carry of this block's units
  float* dc_s = dh_s + B * NJ;      // [B][NJ] dc carry
  float* dp_s = dc_s + B * NJ;      // [B][C] this step's dpre_mx, own columns
  float* du_s = dp_s + B * C;       // [C][kThreads] dU accumulators
  cg::grid_group grid = cg::this_grid();

  const int per_dir = H / NJ;
  const int dir = blockIdx.x >= per_dir;  // 0: forward, 1: backward (reverse)
  const int j0 = (blockIdx.x - dir * per_dir) * NJ;
  const T* xp = dir ? xpb : xpf;
  const T* U = dir ? Ub : Uf;
  const T* hprev = dir ? hpb : hpf;
  const float* cprev = dir ? cpb : cpf;
  T* dxp = dir ? dxpb : dxpf;
  T* dU = dir ? dUb : dUf;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t BH4 = (size_t)B * H4;
  const size_t H2 = (size_t)2 * H;
  T* db = dbuf + (size_t)dir * 2 * BH4;  // this direction's two buffers

  for (int i = threadIdx.x; i < C * H; i += kThreads) {
    const int c = i / H, k = i - c * H;
    const int g = c / NJ, jj = c - g * NJ;
    ucol_s[i] = to_f32<T>(U[(size_t)k * H4 + (size_t)g * H + j0 + jj]);
  }
  for (int i = threadIdx.x; i < NJ * H4; i += kThreads) {
    const int jj = i / H4, k = i - jj * H4;
    urow_s[i] = to_f32<T>(U[(size_t)(j0 + jj) * H4 + k]);
  }
  for (int i = threadIdx.x; i < B * NJ; i += kThreads) {
    dh_s[i] = 0.0f;
    dc_s[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < kThreads * C; i += kThreads) du_s[i] = 0.0f;

  // dU: thread (g, k) = (threadIdx / H, threadIdx % H) sums rows b = g mod G
  const int G = kThreads / H;
  const int du_k = threadIdx.x % H;
  const int du_g = threadIdx.x / H;
  const bool du_on = du_g < G;

  // phase B: after the reduction lane l holds sum l = r*C + g*NJ + jj; the
  // lanes with g == 0 run the cell backward of row r, unit j0 + jj
  const int my_r = lane / C;
  const int my_jj = lane % C;
  const bool cell_lane = my_jj < NJ;
  __syncthreads();

  for (int s = 0; s < T_len; ++s) {
    const int t = dir ? s : T_len - 1 - s;
    const T* hp_t = hprev + (size_t)t * B * H;
    const float* cp_t = cprev + (size_t)t * B * H;
    T* d_next = db + (size_t)(s & 1) * BH4;

    // (A) dh <- (1 - m_prev) * dh + dpre_mx_prev @ U[j, :]^T
    if (s > 0) {
      const int t_prev = dir ? t - 1 : t + 1;
      const T* d_prev = db + (size_t)((s - 1) & 1) * BH4;
      for (int b0 = warp * kRowsA; b0 < B; b0 += kWarps * kRowsA) {
        float acc[kRowsA * NJ];
#pragma unroll
        for (int v = 0; v < kRowsA * NJ; ++v) acc[v] = 0.0f;
        const T* drow[kRowsA];
#pragma unroll
        for (int r = 0; r < kRowsA; ++r)  // rows past B reread row B-1, unused
          drow[r] = d_prev + (size_t)min(b0 + r, B - 1) * H4;
#pragma unroll 4
        for (int k = lane; k < H4; k += 32) {
          float dv[kRowsA];
#pragma unroll
          for (int r = 0; r < kRowsA; ++r) dv[r] = ldcg_f32<T>(drow[r] + k);
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            const float u = urow_s[jj * H4 + k];
#pragma unroll
            for (int r = 0; r < kRowsA; ++r)
              acc[r * NJ + jj] = fmaf(dv[r], u, acc[r * NJ + jj]);
          }
        }
        float mine = 0.0f;
#pragma unroll
        for (int v = 0; v < kRowsA * NJ; ++v) {
#pragma unroll
          for (int level = 0; level < 5; ++level)
            acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], 16 >> level);
          if (lane == v) mine = acc[v];
        }
        if (lane < kRowsA * NJ) {
          const int b = b0 + lane / NJ, jj = lane % NJ;
          if (b < B) {
            const float m = mask[(size_t)b * T_len + t_prev];
            dh_s[b * NJ + jj] = (1.0f - m) * dh_s[b * NJ + jj] + mine;
          }
        }
      }
      __syncthreads();
    }

    // (B) gate recompute from xp_t + hprev_t @ U, then the cell backward
    for (int b0 = warp * RB; b0 < B; b0 += kWarps * RB) {
      const int b_cell = b0 + my_r;
      const bool do_cell = cell_lane && b_cell < B;
      float x_i = 0.f, x_f = 0.f, x_g = 0.f, x_o = 0.f, m = 0.f, c_old = 0.f,
            g_y = 0.f;
      if (do_cell) {  // independent of the product: issue first
        const size_t bt = (size_t)b_cell * T_len + t;
        const T* xrow = xp + bt * H4 + j0 + my_jj;
        x_i = to_f32<T>(xrow[0]);
        x_f = to_f32<T>(xrow[H]);
        x_g = to_f32<T>(xrow[2 * H]);
        x_o = to_f32<T>(xrow[3 * H]);
        m = mask[bt];
        c_old = cp_t[(size_t)b_cell * H + j0 + my_jj];
        g_y = to_f32<T>(gy[bt * H2 + (size_t)dir * H + j0 + my_jj]);
      }

      float acc[RB * C];
#pragma unroll
      for (int v = 0; v < RB * C; ++v) acc[v] = 0.0f;
      const T* hrow[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        hrow[r] = hp_t + (size_t)min(b0 + r, B - 1) * H;
#pragma unroll 4
      for (int k = lane; k < H; k += 32) {
        float hk[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) hk[r] = to_f32<T>(hrow[r][k]);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float u = ucol_s[c * H + k];
#pragma unroll
          for (int r = 0; r < RB; ++r) acc[r * C + c] = fmaf(hk[r], u, acc[r * C + c]);
        }
      }
#pragma unroll
      for (int level = 0; level < 5; ++level) {
        const int n = 16 >> level;
        const bool upper = (lane & n) != 0;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (i < n) {
            const float send = upper ? acc[i] : acc[i + n];
            const float keep = upper ? acc[i + n] : acc[i];
            acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, n);
          }
        }
      }
      const float p_i = acc[0];
      const float p_f = __shfl_sync(0xffffffffu, acc[0], (lane + NJ) & 31);
      const float p_g = __shfl_sync(0xffffffffu, acc[0], (lane + 2 * NJ) & 31);
      const float p_o = __shfl_sync(0xffffffffu, acc[0], (lane + 3 * NJ) & 31);

      if (do_cell) {
        const int jj = my_jj;
        const int j = j0 + jj;
        const size_t bt = (size_t)b_cell * T_len + t;
        const float ig = sigmoid(x_i + p_i);
        const float fg = sigmoid(x_f + p_f);
        const float gg = tanhf(x_g + p_g);
        const float og = sigmoid(x_o + p_o);
        const float c_new = fg * c_old + ig * gg;
        const float th = tanhf(c_new);
        const float dh = dh_s[b_cell * NJ + jj];
        const float dc = dc_s[b_cell * NJ + jj];
        const float dhn = m * (dh + g_y);
        const float dct = m * dc + dhn * og * (1.0f - th * th);
        const float d_i = dct * gg * ig * (1.0f - ig);
        const float d_f = dct * c_old * fg * (1.0f - fg);
        const float d_g = dct * ig * (1.0f - gg * gg);
        const float d_o = dhn * th * og * (1.0f - og);
        T* dx = dxp + bt * H4 + j;
        T* dn = d_next + (size_t)b_cell * H4 + j;
        float* dp = dp_s + b_cell * C + jj;
        const float d4[4] = {d_i, d_f, d_g, d_o};
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const T v = from_f32<T>(d4[g]);  // xp and U share the type
          dx[g * H] = v;
          dn[g * H] = v;
          dp[g * NJ] = to_f32<T>(v);
        }
        dc_s[b_cell * NJ + jj] = (1.0f - m) * dc + dct * fg;
      }
    }
    __syncthreads();

    // (C) dU[:, own columns] += hprev_t^T @ dpre_mx[:, own columns]
    if (du_on) {
      float du[C];
#pragma unroll
      for (int c = 0; c < C; ++c) du[c] = du_s[c * kThreads + threadIdx.x];
      for (int b = du_g; b < B; b += G) {
        const float hv = to_f32<T>(hp_t[(size_t)b * H + du_k]);
        const float* prow = dp_s + b * C;
#pragma unroll
        for (int c = 0; c < C; ++c) du[c] = fmaf(hv, prow[c], du[c]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) du_s[c * kThreads + threadIdx.x] = du[c];
    }
    grid.sync();  // this step's dpre_mx complete everywhere before step s+1
  }

  __syncthreads();
  for (int i = threadIdx.x; i < C * H; i += kThreads) {
    const int c = i / H, k = i - c * H;
    float sum = 0.0f;
    for (int g = 0; g < G; ++g) sum += du_s[c * kThreads + g * H + k];
    const int gate = c / NJ, jj = c - gate * NJ;
    dU[(size_t)k * H4 + (size_t)gate * H + j0 + jj] = from_f32<T>(sum);
  }
}

template <typename T, int NJ>
int launch(const void* xpf, const void* xpb, const void* Uf, const void* Ub,
           const float* mask, const void* hpf, const float* cpf,
           const void* hpb, const float* cpb, const void* gy, void* dxpf,
           void* dxpb, void* dUf, void* dUb, void* dbuf, int B, int T_len,
           int H, cudaStream_t stream, int dev, int sms) {
  auto kernel = bilstm_bwd_kernel<T, NJ>;
  constexpr int C = 4 * NJ;
  const size_t smem = sizeof(float) * ((size_t)C * H + (size_t)NJ * 4 * H +
                                       (size_t)2 * B * NJ + (size_t)B * C +
                                       (size_t)kThreads * C);
  const int grid = 2 * (H / NJ);
  int rc = prepare_cooperative(kernel, smem, grid, dev, sms);
  if (rc != 0) return rc;

  const T* xpf_t = static_cast<const T*>(xpf);
  const T* xpb_t = static_cast<const T*>(xpb);
  const T* uf_t = static_cast<const T*>(Uf);
  const T* ub_t = static_cast<const T*>(Ub);
  const T* hpf_t = static_cast<const T*>(hpf);
  const T* hpb_t = static_cast<const T*>(hpb);
  const T* gy_t = static_cast<const T*>(gy);
  T* dxpf_t = static_cast<T*>(dxpf);
  T* dxpb_t = static_cast<T*>(dxpb);
  T* duf_t = static_cast<T*>(dUf);
  T* dub_t = static_cast<T*>(dUb);
  T* db_t = static_cast<T*>(dbuf);
  void* args[] = {(void*)&xpf_t,  (void*)&xpb_t,  (void*)&uf_t,
                  (void*)&ub_t,   (void*)&mask,   (void*)&hpf_t,
                  (void*)&cpf,    (void*)&hpb_t,  (void*)&cpb,
                  (void*)&gy_t,   (void*)&dxpf_t, (void*)&dxpb_t,
                  (void*)&duf_t,  (void*)&dub_t,  (void*)&db_t,
                  (void*)&B,      (void*)&T_len,  (void*)&H};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                              dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* xpf, const void* xpb, const void* Uf, const void* Ub,
             const float* mask, const void* hpf, const float* cpf,
             const void* hpb, const float* cpb, const void* gy, void* dxpf,
             void* dxpb, void* dUf, void* dUb, void* dbuf, int B, int T_len,
             int H, cudaStream_t stream) {
  int dev = 0, sms = 0;
  int rc = device_sms(&dev, &sms);
  if (rc != 0) return rc;
  if (H > kThreads) return kErrUnsupportedH;  // phase C: a thread per k
  // bilstm_fwd.cu's split of hidden units over blocks
  if (2 * H <= sms)
    return launch<T, 1>(xpf, xpb, Uf, Ub, mask, hpf, cpf, hpb, cpb, gy, dxpf,
                        dxpb, dUf, dUb, dbuf, B, T_len, H, stream, dev, sms);
  if (H % 2 == 0 && H <= sms)
    return launch<T, 2>(xpf, xpb, Uf, Ub, mask, hpf, cpf, hpb, cpb, gy, dxpf,
                        dxpb, dUf, dUb, dbuf, B, T_len, H, stream, dev, sms);
  if (H % 4 == 0 && H <= 2 * sms)
    return launch<T, 4>(xpf, xpb, Uf, Ub, mask, hpf, cpf, hpb, cpb, gy, dxpf,
                        dxpb, dUf, dUb, dbuf, B, T_len, H, stream, dev, sms);
  return kErrUnsupportedH;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (every tensor but mask, cpf and cpb,
// which are float32). dbuf: scratch of 2 x 2 x B x 4H elements of U's type.
// Returns 0, a cudaError_t value, or one of the negative codes of
// common.cuh.
int pgasr_bilstm_bwd(const void* xpf, const void* xpb, const void* Uf,
                     const void* Ub, const void* mask, const void* hpf,
                     const void* cpf, const void* hpb, const void* cpb,
                     const void* gy, void* dxpf, void* dxpb, void* dUf,
                     void* dUb, void* dbuf, int B, int T_len, int H, int dtype,
                     void* stream) {
  const float* m = static_cast<const float*>(mask);
  const float* cf = static_cast<const float*>(cpf);
  const float* cb = static_cast<const float*>(cpb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(xpf, xpb, Uf, Ub, m, hpf, cf, hpb, cb, gy, dxpf,
                           dxpb, dUf, dUb, dbuf, B, T_len, H, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(xpf, xpb, Uf, Ub, m, hpf, cf, hpb, cb, gy,
                                   dxpf, dxpb, dUf, dUb, dbuf, B, T_len, H, s);
  return kErrDtype;
}

}  // extern "C"
