// Masked LSTM forward recurrence of one direction, for Hopper (sm_90a).
//
// Replaces the TPU kernel pg_asr_tpu/ops/pallas_lstm.py:_kernel (the
// inference form of pallas_lstm_scan, train=False). Same contract:
//   xp   (B, T, 4H)  precomputed x@W + b, float32 or bfloat16, gates i,f,g,o
//   U    (H, 4H)     recurrent weights, same type as xp
//   mask (B, T)      float32, > 0 at valid steps
//   out  (B, T, H)   h_new * mask, in xp's type
// Carries h and c are float32. h is rounded to U's type before the product
// (h.astype(U.dtype) in the Pallas body) and the product accumulates in
// float32. Where mask == 0 the carry is frozen and the output is zero;
// reverse walks t = T-1 .. 0.
//
// What bounds it on this card: the recurrence is a chain of T dependent
// steps, each a small (B, H) x (H, 4H) product plus the gate math. At the
// slice's shape (B=64, H=256) a step is ~33 MFLOP, far too little to fill
// 132 SMs, so the kernel is bound by per-step latency (an L2 round trip for
// h and one grid-wide barrier), not by FLOPs or HBM bytes.
//
// What the design does about it: one persistent cooperative launch walks all
// T steps, so there is no per-step launch. U (1 MiB in f32 at H=256) does not
// fit one SM's 227 KB of shared memory, so it is split by hidden unit: block
// b owns NJ (1 or 2) units j and keeps their four gate columns {g*H + j} of U
// in shared memory for the whole walk, and keeps their c carry in shared memory. The
// cell update of a unit needs only its own four gates, so c never leaves the
// block. Only h crosses blocks: every block reads all of h_{t-1} (B x H f32,
// L2-resident) from a double-buffered global array, writes its own slice of
// h_t, and the grid synchronises once per step.
// Inside a block, a warp takes RB = 8/NJ batch rows at once, so each lane
// holds RB x 4NJ = 32 partial sums: its lanes split the H-long dot products
// (coalesced h loads of RB rows issued together, four k-strides deep;
// conflict-free shared reads of U, each reused for RB rows). A butterfly
// reduce-scatter (31 shuffles for 32 sums, not 32 x 5) leaves lane l with
// the full sum l; three more shuffles bring a unit's four gates to one lane,
// which runs the cell update. A warp so pays a few memory latencies per row
// group, not per row: at B=64 one group per warp, ~4 us per step on an H100
// (1.6 ms for T=401 in chip_smoke.py).
// Tensor cores (wgmma), TMA and clusters/DSMEM are left for later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Error codes of our own; positive codes are cudaError_t values.
constexpr int kErrUnsupportedH = -1;    // H above 2 x #SMs, or odd and above #SMs
constexpr int kErrGridNotResident = -2; // cooperative grid cannot be co-resident
constexpr int kErrSharedMemory = -3;    // per-block shared memory above the limit
constexpr int kErrDtype = -4;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ U,
                const float* __restrict__ mask, T* __restrict__ out,
                float* hbuf, int B, int T_len, int H, int reverse) {
  constexpr int C = 4 * NJ;  // gate columns of this block
  constexpr int RB = 8 / NJ; // rows a warp takes at once: RB * C == 32
  static_assert(RB * C == 32, "one partial sum per lane after the reduction");
  extern __shared__ float smem[];
  float* u_s = smem;         // [C][H]; column c = g*NJ + jj is U[:, g*H + j0 + jj]
  float* c_s = smem + C * H; // [B][NJ] cell carry of this block's units
  cg::grid_group grid = cg::this_grid();

  const int j0 = blockIdx.x * NJ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t BH = (size_t)B * H;
  const size_t H4 = (size_t)4 * H;
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
    hbuf[(size_t)b * H + j0 + jj] = 0.0f;  // h_{-1} = 0 in buffer 0
  }
  grid.sync();

  for (int s = 0; s < T_len; ++s) {
    const int t = reverse ? T_len - 1 - s : s;
    const float* h_prev = hbuf + (size_t)(s & 1) * BH;
    float* h_next = hbuf + (size_t)((s + 1) & 1) * BH;

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
      // butterfly reduce-scatter: at each level a lane keeps the half of its
      // sums selected by its lane bit and adds the partner's copy of it
      // (constant trip counts, so acc stays in registers)
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
        const float c_new = fg * c_old + ig * gg;
        const float h_new = og * tanhf(c_new);
        const bool valid = m > 0.0f;
        c_s[b_cell * NJ + my_jj] = valid ? c_new : c_old;
        h_next[(size_t)b_cell * H + j] = valid ? h_new : h_old;
        out[bt * H + j] = from_f32<T>(h_new * m);
      }
    }
    grid.sync();  // h_t complete everywhere before any block reads it
  }
}

template <typename T, int NJ>
int launch(const void* xp, const void* U, const float* mask, void* out,
           float* hbuf, int B, int T_len, int H, int reverse,
           cudaStream_t stream, int dev, int sms) {
  auto kernel = lstm_fwd_kernel<T, NJ>;
  const size_t smem = sizeof(float) * ((size_t)4 * NJ * H + (size_t)B * NJ);
  int smem_max = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (smem > (size_t)smem_max) return kErrSharedMemory;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  const int grid = H / NJ;
  if (grid > per_sm * sms) return kErrGridNotResident;

  const T* xp_t = static_cast<const T*>(xp);
  const T* u_t = static_cast<const T*>(U);
  T* out_t = static_cast<T*>(out);
  void* args[] = {(void*)&xp_t, (void*)&u_t, (void*)&mask, (void*)&out_t,
                  (void*)&hbuf, (void*)&B,   (void*)&T_len, (void*)&H,
                  (void*)&reverse};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads),
                                  args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* xp, const void* U, const float* mask, void* out,
             float* hbuf, int B, int T_len, int H, int reverse,
             cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // fewest units per block such that one block per SM covers all H units:
  // on an H100 (132 SMs) NJ = 1 up to H = 132, NJ = 2 up to H = 264, which
  // holds every hidden size the package configures (64 .. 256)
  if (H <= sms)
    return launch<T, 1>(xp, U, mask, out, hbuf, B, T_len, H, reverse, stream, dev, sms);
  if (H % 2 == 0 && H / 2 <= sms)
    return launch<T, 2>(xp, U, mask, out, hbuf, B, T_len, H, reverse, stream, dev, sms);
  return kErrUnsupportedH;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (xp, U and out share it).
// Returns 0, a cudaError_t value, or one of the negative codes above.
int pgasr_lstm_fwd(const void* xp, const void* U, const void* mask, void* out,
                   void* hbuf, int B, int T_len, int H, int reverse, int dtype,
                   void* stream) {
  const float* m = static_cast<const float*>(mask);
  float* h = static_cast<float*>(hbuf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(xp, U, m, out, h, B, T_len, H, reverse, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(xp, U, m, out, h, B, T_len, H, reverse, s);
  return kErrDtype;
}

const char* pgasr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
