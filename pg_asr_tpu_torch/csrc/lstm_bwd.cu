// Masked LSTM backward (reverse-time gradient) of one direction, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pg_asr_tpu/ops/pallas_lstm.py:_kernel_bwd (via
// _pallas_backward, the backward of the custom VJP of pallas_lstm_scan).
// Same contract and numerics:
//   xp    (B, T, 4H)  the forward's x@W + b, float32 or bfloat16, gates i,f,g,o
//   U     (H, 4H)     recurrent weights, same type as xp
//   mask  (B, T)      float32, > 0 at valid steps
//   hprev (T, B, H)   the forward's carry h before step t, xp's type
//   cprev (T, B, H)   the forward's carry c before step t, float32
//   gy    (B, T, H)   gradient of the forward's output, xp's type
//   dxp   (B, T, 4H)  out: dpre in xp's type
//   dU    (H, 4H)     out: sum over steps of hprev^T @ dpre_mx, in U's type
// It walks time in the opposite order of the forward (t = T-1 .. 0 for a
// forward scan, 0 .. T-1 for a reverse one) with float32 carries dh, dc and
// a float32 dU accumulator. Each step recomputes the gates from
// xp_t + hprev_t @ U (float32 accumulation), then
//   dhn = m*(dh + gy); dct = m*dc + dhn*o*(1 - th^2)
//   dpre = [dct*g*i*(1-i), dct*cprev*f*(1-f), dct*i*(1-g^2), dhn*th*o*(1-o)]
//   dxp_t = dpre (xp's type); dpre_mx = dpre rounded to U's type
//   dU += hprev_t^T @ dpre_mx; dh = (1-m)*dh + dpre_mx @ U^T
//   dc = (1-m)*dc + dct*f
// Padded steps (m == 0) pass dh and dc through and contribute nothing.
//
// What bounds it on this card: like the forward, a chain of T dependent
// steps, each three small products ((B,H)x(H,4H), (B,4H)x(4H,H) and
// (H,B)x(B,4H), ~100 MFLOP at B=64, H=256), far too little per step to
// fill 132 SMs; bytes and FLOPs of the whole call are far below what the
// chain's latency costs.
//
// Design (plain and correct first; wgmma, TMA and clusters are later work):
// one persistent cooperative launch of H/NJ blocks, block b owning hidden
// units j0 .. j0+NJ-1 (NJ = 1 or 2, as the forward). It keeps in shared
// memory U's 4*NJ gate columns of its units (for the gate recompute), U's
// NJ rows of its units (for dh), and the dh, dc carries of its units.
//   * dh needs every gate column: dh[b, j] = sum_k dpre_mx[b, k] U[j, k]
//     over all 4H k, but a block computes dpre only for its own columns. So
//     dpre_mx crosses blocks each step, as h does in the forward: each block
//     writes its columns into a double-buffered global (B, 4H) array in U's
//     type (exact: that is what both products consume), the grid
//     synchronises once per step, and at the next step every block reads
//     the whole array through L2 (__ldcg; L1 may hold the value from two
//     steps back). This exchange is B x 4H per step, four times the
//     forward's h exchange, and is the largest cost of a step.
//   * dU without a cross-block reduction: the block's own columns of dU
//     need all of hprev_t (read-only residual) and only the block's own
//     dpre_mx, so each block accumulates H x 4*NJ float32 sums in
//     registers over the whole walk (thread: one k, one group of batch
//     rows) and writes its columns of dU once at the end; no atomics, so
//     the result is the same from run to run.
// Per step: (A) from the other blocks' dpre_mx of the previous step, warps
// take 4 batch rows at once, lanes split the 4H-long dot products, a warp
// reduction finishes them, and the carry becomes dh; (B) the gate
// recompute, laid out as the forward's product (a warp takes 8/NJ rows,
// butterfly reduce-scatter of 32 partial sums), and the cell backward on
// one lane per (row, unit); (C) the dU update; then the grid barrier.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pgasr;

constexpr int kRowsA = 4;  // batch rows a warp takes at once in phase A

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const T* __restrict__ xp, const T* __restrict__ U,
                const float* __restrict__ mask, const T* __restrict__ hprev,
                const float* __restrict__ cprev, const T* __restrict__ gy,
                T* __restrict__ dxp, T* __restrict__ dU, T* dbuf, int B,
                int T_len, int H, int reverse) {
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
  float* red_s = dp_s + B * C;      // [kThreads][C] final dU reduction
  cg::grid_group grid = cg::this_grid();

  const int j0 = blockIdx.x * NJ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t BH4 = (size_t)B * H4;

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

  // dU: thread (g, k) = (threadIdx / H, threadIdx % H) sums rows b = g mod G
  const int G = kThreads / H;
  const int du_k = threadIdx.x % H;
  const int du_g = threadIdx.x / H;
  const bool du_on = du_g < G;
  float du[C];
#pragma unroll
  for (int c = 0; c < C; ++c) du[c] = 0.0f;

  // phase B: after the reduction lane l holds sum l = r*C + g*NJ + jj; the
  // lanes with g == 0 run the cell backward of row r, unit j0 + jj
  const int my_r = lane / C;
  const int my_jj = lane % C;
  const bool cell_lane = my_jj < NJ;
  __syncthreads();

  for (int s = 0; s < T_len; ++s) {
    const int t = reverse ? s : T_len - 1 - s;
    const T* hp_t = hprev + (size_t)t * B * H;
    const float* cp_t = cprev + (size_t)t * B * H;
    T* d_next = dbuf + (size_t)(s & 1) * BH4;

    // (A) dh <- (1 - m_prev) * dh + dpre_mx_prev @ U[j, :]^T
    if (s > 0) {
      const int t_prev = reverse ? t - 1 : t + 1;
      const T* d_prev = dbuf + (size_t)((s - 1) & 1) * BH4;
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
        g_y = to_f32<T>(gy[bt * H + j0 + my_jj]);
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
      for (int b = du_g; b < B; b += G) {
        const float hv = to_f32<T>(hp_t[(size_t)b * H + du_k]);
        const float* prow = dp_s + b * C;
#pragma unroll
        for (int c = 0; c < C; ++c) du[c] = fmaf(hv, prow[c], du[c]);
      }
    }
    grid.sync();  // this step's dpre_mx complete everywhere before step s+1
  }

  if (du_on) {
#pragma unroll
    for (int c = 0; c < C; ++c) red_s[threadIdx.x * C + c] = du[c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C * H; i += kThreads) {
    const int c = i / H, k = i - c * H;
    float sum = 0.0f;
    for (int g = 0; g < G; ++g) sum += red_s[(g * H + k) * C + c];
    const int gate = c / NJ, jj = c - gate * NJ;
    dU[(size_t)k * H4 + (size_t)gate * H + j0 + jj] = from_f32<T>(sum);
  }
}

template <typename T, int NJ>
int launch(const void* xp, const void* U, const float* mask, const void* hprev,
           const float* cprev, const void* gy, void* dxp, void* dU, void* dbuf,
           int B, int T_len, int H, int reverse, cudaStream_t stream, int dev,
           int sms) {
  auto kernel = lstm_bwd_kernel<T, NJ>;
  constexpr int C = 4 * NJ;
  const size_t smem = sizeof(float) * ((size_t)C * H + (size_t)NJ * 4 * H +
                                       (size_t)2 * B * NJ + (size_t)B * C +
                                       (size_t)kThreads * C);
  const int grid = H / NJ;
  int rc = prepare_cooperative(kernel, smem, grid, dev, sms);
  if (rc != 0) return rc;

  const T* xp_t = static_cast<const T*>(xp);
  const T* u_t = static_cast<const T*>(U);
  const T* hp_t = static_cast<const T*>(hprev);
  const T* gy_t = static_cast<const T*>(gy);
  T* dxp_t = static_cast<T*>(dxp);
  T* du_t = static_cast<T*>(dU);
  T* db_t = static_cast<T*>(dbuf);
  void* args[] = {(void*)&xp_t,  (void*)&u_t,   (void*)&mask, (void*)&hp_t,
                  (void*)&cprev, (void*)&gy_t,  (void*)&dxp_t, (void*)&du_t,
                  (void*)&db_t,  (void*)&B,     (void*)&T_len, (void*)&H,
                  (void*)&reverse};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                              dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* xp, const void* U, const float* mask, const void* hprev,
             const float* cprev, const void* gy, void* dxp, void* dU, void* dbuf,
             int B, int T_len, int H, int reverse, cudaStream_t stream) {
  int dev = 0, sms = 0;
  int rc = device_sms(&dev, &sms);
  if (rc != 0) return rc;
  // the forward's split of hidden units over blocks (see lstm_fwd.cu)
  if (H <= sms)
    return launch<T, 1>(xp, U, mask, hprev, cprev, gy, dxp, dU, dbuf, B, T_len,
                        H, reverse, stream, dev, sms);
  if (H % 2 == 0 && H / 2 <= sms)
    return launch<T, 2>(xp, U, mask, hprev, cprev, gy, dxp, dU, dbuf, B, T_len,
                        H, reverse, stream, dev, sms);
  return kErrUnsupportedH;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xp, U, hprev, gy, dxp, dU and dbuf share
// it). dbuf: scratch of 2 x B x 4H elements. Returns 0, a cudaError_t value,
// or one of the negative codes of common.cuh.
int pgasr_lstm_bwd(const void* xp, const void* U, const void* mask,
                   const void* hprev, const void* cprev, const void* gy,
                   void* dxp, void* dU, void* dbuf, int B, int T_len, int H,
                   int reverse, int dtype, void* stream) {
  const float* m = static_cast<const float*>(mask);
  const float* cp = static_cast<const float*>(cprev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(xp, U, m, hprev, cp, gy, dxp, dU, dbuf, B, T_len, H,
                           reverse, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(xp, U, m, hprev, cp, gy, dxp, dU, dbuf, B,
                                   T_len, H, reverse, s);
  return kErrDtype;
}

}  // extern "C"
