// Fused-direction masked BiLSTM forward recurrence, for Hopper (sm_90a).
//
// Replaces the TPU kernel pg_asr_tpu/ops/pallas_lstm.py:_kernel_bi (via
// _pallas_bi_forward), both its inference form (train=False) and its
// residual form (train=True, the forward of pallas_bilstm_scan's custom VJP).
// Same contract:
//   xpf, xpb (B, T, 4H)  each direction's x@W + b, float32 or bfloat16
//   Uf, Ub   (H, 4H)     each direction's recurrent weights, xp's type
//   mask     (B, T)      float32, > 0 at valid steps
//   y        (B, T, 2H)  concat(forward, backward) of h_new * mask, xp's type
//   hpf, hpb (T, B, H)   residual form only: each direction's carry h before
//                        its step t, in xp's type (padded steps included)
//   cpf, cpb (T, B, H)   residual form only: the carry c before step t, f32
// Null residual pointers select the inference form. Step s runs forward
// time s and backward time T-1-s; each direction has lstm_fwd.cu's (and
// _kernel's) numerics: float32 carries, h rounded to U's type before the
// product, the carry frozen where mask == 0.
//
// What bounds it on this card: as lstm_fwd, a chain of T dependent steps
// whose latency (an L2 round trip for h and one grid-wide barrier per
// step) costs far more than the FLOPs or HBM bytes of the whole call.
// Fusing the directions halves the chains: the two directions share each
// step's barrier and latency instead of running two launches one after
// the other.
//
// Design: lstm_fwd.cu's, with the grid split into two halves, one per
// direction, in ONE cooperative launch (one barrier per step serves both).
// Block b < H/NJ owns hidden units j0 .. j0+NJ-1 of the forward direction,
// block H/NJ + b the same units of the backward direction; each keeps its
// units' 4*NJ gate columns of its direction's U and their c carry in shared
// memory, and every block reads all of its direction's h_{t-1} from a
// double-buffered global array (one per direction). Co-residency decides
// NJ: lstm_fwd's NJ = 2 at H = 256 gives 128 blocks, and two directions'
// 256 blocks of 512 threads cannot all be resident on 132 SMs. Of the
// three ways out (NJ = 4; two blocks per SM at half the registers; one
// block carrying the same units of both directions) this takes the
// smallest NJ with 2H/NJ <= #SMs: NJ = 4 at H = 256, so 128 blocks, one
// per SM (the first option: it keeps lstm_fwd's registers, and needs no
// second code path inside a block), each doing twice an lstm_fwd block's
// per-step work (4 units, not 2). RB = 8/NJ rows per warp keeps the 32
// partial sums per lane of lstm_fwd's butterfly reduce-scatter.
// The step code is lstm_fwd.cu's, kept in its own copy: the two kernels
// compiled from one shared template ran lstm_fwd 1.0-2.7% slower with the
// same bits (kernel_ab.py, PERF.md), and lstm_fwd keeps its timing.
// Numerics: whatever NJ, a lane sums h[b, k] * U[k, col] over k = lane,
// lane + 32, ... in order with fmaf, and the butterfly adds the 32 lanes'
// partials in one fixed tree (partners by lane bit 4, 3, .. 0); the cell
// update is lstm_fwd's code. So each direction gives lstm_fwd's bits,
// which chip_smoke.py checks.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pgasr;

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
bilstm_fwd_kernel(const T* __restrict__ xpf, const T* __restrict__ xpb,
                  const T* __restrict__ Uf, const T* __restrict__ Ub,
                  const float* __restrict__ mask, T* __restrict__ y,
                  float* hbuf, T* __restrict__ hpf, float* __restrict__ cpf,
                  T* __restrict__ hpb, float* __restrict__ cpb, int B,
                  int T_len, int H) {
  constexpr int C = 4 * NJ;  // gate columns of this block
  constexpr int RB = 8 / NJ; // rows a warp takes at once: RB * C == 32
  static_assert(RB * C == 32, "one partial sum per lane after the reduction");
  extern __shared__ float smem[];
  float* u_s = smem;         // [C][H]; column c = g*NJ + jj is U[:, g*H + j0 + jj]
  float* c_s = smem + C * H; // [B][NJ] cell carry of this block's units
  cg::grid_group grid = cg::this_grid();

  const int per_dir = H / NJ;
  const int dir = blockIdx.x >= per_dir;  // 0: forward, 1: backward (reverse)
  const int j0 = (blockIdx.x - dir * per_dir) * NJ;
  const T* xp = dir ? xpb : xpf;
  const T* U = dir ? Ub : Uf;
  T* hprev = dir ? hpb : hpf;
  float* cprev = dir ? cpb : cpf;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t BH = (size_t)B * H;
  const size_t H4 = (size_t)4 * H;
  const size_t H2 = (size_t)2 * H;
  float* hb = hbuf + (size_t)dir * 2 * BH;  // this direction's two buffers
  // after the reduction lane l holds sum l = r*C + g*NJ + jj; the lanes with
  // g == 0 run the cell update of row r, unit j0 + jj
  const int my_r = lane / C;
  const int my_jj = lane % C;
  const bool cell_lane = my_jj < NJ;

  for (int i = threadIdx.x; i < C * H; i += kThreads) {
    const int c = i / H, k = i - c * H;
    const int g = c / NJ, jj = c - g * NJ;
    u_s[i] = to_f32<T>(U[(size_t)k * H4 + (size_t)g * H + j0 + jj]);
  }
  for (int i = threadIdx.x; i < B * NJ; i += kThreads) {
    const int b = i / NJ, jj = i - b * NJ;
    c_s[i] = 0.0f;
    hb[(size_t)b * H + j0 + jj] = 0.0f;  // h_{-1} = 0 in buffer 0
  }
  grid.sync();

  for (int s = 0; s < T_len; ++s) {
    const int t = dir ? T_len - 1 - s : s;
    const float* h_prev = hb + (size_t)(s & 1) * BH;
    float* h_next = hb + (size_t)((s + 1) & 1) * BH;

    for (int b0 = warp * RB; b0 < B; b0 += kWarps * RB) {
      // this lane's cell inputs (independent of the product): issue first
      const int b_cell = b0 + my_r;
      const bool do_cell = cell_lane && b_cell < B;
      float x_i = 0.f, x_f = 0.f, x_g = 0.f, x_o = 0.f, m = 0.f, h_old = 0.f;
      if (do_cell) {
        const size_t bt = (size_t)b_cell * T_len + t;
        const T* xrow = xp + bt * H4 + j0 + my_jj;
        x_i = to_f32<T>(xrow[0]);
        x_f = to_f32<T>(xrow[H]);
        x_g = to_f32<T>(xrow[2 * H]);
        x_o = to_f32<T>(xrow[3 * H]);
        m = mask[bt];
        h_old = __ldcg(h_prev + (size_t)b_cell * H + j0 + my_jj);
      }

      float acc[RB * C];
#pragma unroll
      for (int v = 0; v < RB * C; ++v) acc[v] = 0.0f;
      const float* hrow[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r)  // rows past B reread row B-1, unused
        hrow[r] = h_prev + (size_t)min(b0 + r, B - 1) * H;
#pragma unroll 4
      for (int k = lane; k < H; k += 32) {
        float hk[RB];
        // __ldcg: read through L2 only; L1 may hold this buffer's value
        // from two steps ago, written by another block
#pragma unroll
        for (int r = 0; r < RB; ++r)
          hk[r] = to_f32<T>(from_f32<T>(__ldcg(hrow[r] + k)));
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float u = u_s[c * H + k];
#pragma unroll
          for (int r = 0; r < RB; ++r) acc[r * C + c] = fmaf(hk[r], u, acc[r * C + c]);
        }
      }
      // butterfly reduce-scatter (lstm_fwd.cu): at each level a lane keeps
      // the half of its sums selected by its lane bit and adds the
      // partner's copy of it
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
        const int j = j0 + my_jj;
        const size_t bt = (size_t)b_cell * T_len + t;
        const float ig = sigmoid(x_i + p_i);
        const float fg = sigmoid(x_f + p_f);
        const float gg = tanhf(x_g + p_g);
        const float og = sigmoid(x_o + p_o);
        const float c_old = c_s[b_cell * NJ + my_jj];
        if (hprev != nullptr) {  // residual form: the carry before this step
          const size_t r = ((size_t)t * B + b_cell) * H + j;
          hprev[r] = from_f32<T>(h_old);
          cprev[r] = c_old;
        }
        const float c_new = fg * c_old + ig * gg;
        const float h_new = og * tanhf(c_new);
        const bool valid = m > 0.0f;
        c_s[b_cell * NJ + my_jj] = valid ? c_new : c_old;
        h_next[(size_t)b_cell * H + j] = valid ? h_new : h_old;
        y[bt * H2 + (size_t)dir * H + j] = from_f32<T>(h_new * m);
      }
    }
    grid.sync();  // h_t of both directions complete before any block reads it
  }
}

template <typename T, int NJ>
int launch(const void* xpf, const void* xpb, const void* Uf, const void* Ub,
           const float* mask, void* y, float* hbuf, void* hpf, float* cpf,
           void* hpb, float* cpb, int B, int T_len, int H, cudaStream_t stream,
           int dev, int sms) {
  auto kernel = bilstm_fwd_kernel<T, NJ>;
  const size_t smem = sizeof(float) * ((size_t)4 * NJ * H + (size_t)B * NJ);
  const int grid = 2 * (H / NJ);
  int rc = prepare_cooperative(kernel, smem, grid, dev, sms);
  if (rc != 0) return rc;

  const T* xpf_t = static_cast<const T*>(xpf);
  const T* xpb_t = static_cast<const T*>(xpb);
  const T* uf_t = static_cast<const T*>(Uf);
  const T* ub_t = static_cast<const T*>(Ub);
  T* y_t = static_cast<T*>(y);
  T* hpf_t = static_cast<T*>(hpf);
  T* hpb_t = static_cast<T*>(hpb);
  void* args[] = {(void*)&xpf_t, (void*)&xpb_t, (void*)&uf_t,  (void*)&ub_t,
                  (void*)&mask,  (void*)&y_t,   (void*)&hbuf,  (void*)&hpf_t,
                  (void*)&cpf,   (void*)&hpb_t, (void*)&cpb,   (void*)&B,
                  (void*)&T_len, (void*)&H};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                              dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* xpf, const void* xpb, const void* Uf, const void* Ub,
             const float* mask, void* y, float* hbuf, void* hpf, float* cpf,
             void* hpb, float* cpb, int B, int T_len, int H,
             cudaStream_t stream) {
  int dev = 0, sms = 0;
  int rc = device_sms(&dev, &sms);
  if (rc != 0) return rc;
  // fewest units per block such that one block per SM covers both
  // directions' H units: on an H100 (132 SMs) NJ = 1 up to H = 66, 2 up to
  // H = 132, 4 up to H = 264 (the package's hidden sizes 64 .. 256)
  if (2 * H <= sms)
    return launch<T, 1>(xpf, xpb, Uf, Ub, mask, y, hbuf, hpf, cpf, hpb, cpb,
                        B, T_len, H, stream, dev, sms);
  if (H % 2 == 0 && H <= sms)
    return launch<T, 2>(xpf, xpb, Uf, Ub, mask, y, hbuf, hpf, cpf, hpb, cpb,
                        B, T_len, H, stream, dev, sms);
  if (H % 4 == 0 && H <= 2 * sms)
    return launch<T, 4>(xpf, xpb, Uf, Ub, mask, y, hbuf, hpf, cpf, hpb, cpb,
                        B, T_len, H, stream, dev, sms);
  return kErrUnsupportedH;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xpf, xpb, Uf, Ub, y, hpf and hpb share
// it). hbuf: float32 scratch of 2 x 2 x B x H. Residual pointers all null:
// the inference form; all set: the residual form. Returns 0, a cudaError_t
// value, or one of the negative codes of common.cuh.
int pgasr_bilstm_fwd(const void* xpf, const void* xpb, const void* Uf,
                     const void* Ub, const void* mask, void* y, void* hbuf,
                     void* hpf, void* cpf, void* hpb, void* cpb, int B,
                     int T_len, int H, int dtype, void* stream) {
  const float* m = static_cast<const float*>(mask);
  float* h = static_cast<float*>(hbuf);
  float* cf = static_cast<float*>(cpf);
  float* cb = static_cast<float*>(cpb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool none = !hpf && !cpf && !hpb && !cpb;
  const bool all = hpf && cpf && hpb && cpb;
  if (!none && !all) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(xpf, xpb, Uf, Ub, m, y, h, hpf, cf, hpb, cb, B,
                           T_len, H, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(xpf, xpb, Uf, Ub, m, y, h, hpf, cf, hpb,
                                   cb, B, T_len, H, s);
  return kErrDtype;
}

}  // extern "C"
