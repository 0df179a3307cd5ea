// Fused RNN-T joint, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of pg_asr_tpu/ops/pallas_joint.py
// (via `_fused_forward`, reached from models/transducer.py
// `joint_lattice_log_probs` when TransducerConfig.fused_joint is set). Its
// plain version is pg_asr_tpu_torch/ops/joint.py:fused_joint_plain.
// Contract:
//   e (B, T, J), g (B, U+1, J), W (J, A), bias (A,): one type, float32 or
//   bfloat16, contiguous; labels (B, U) int32, contiguous
//   lp_blank (B, T, U+1), lp_label (B, T, U): float32, contiguous
//   any A >= 1, J >= 1, T >= 1, U >= 0.
// Per lattice cell, in float32: h = tanh(e_t + g_u), z = h . W + bias,
// lse = the logsumexp of z carried over vocab chunks of 32 (joint.cuh),
// lp_blank = z[0] - lse, lp_label = z[y_u] - lse (u < U; 0 - lse for a
// label outside [0, A), as the Pallas kernel's all-zero one-hot row). The
// 4-D joint never reaches device memory.
//
// What bounds it on this card: per cell J tanh and J x A multiply-adds.
// At the transducer's train shape (B=64, T'=201, U+1=61, J=256, A=28:
// 784 704 cells) that is 11.25 GFLOP and 201 M tanh against ~23 MB of
// inputs and outputs, so the float32 operation rate bounds it (~0.17 ms at
// 67 TFLOP/s) in both input types: the math is float32 on CUDA cores.
//
// Design (joint.cuh; the layout of joint_bwd.cu's products). The first
// kernel ran one thread per cell over all J with its z in registers (A at
// most 32), loading one h and a broadcast float4 of W for 4 multiply-adds.
// Here a block owns (utterance, u-tile of 32 rows, a run of 4 tiles of 128
// cells): h = tanh(e + g) is staged once per tile, and each lane forms 8
// cells x 4 vocab columns from three 16-byte loads, 32 multiply-adds a
// column j (4 cells a lane ran 12% slower; e loaded a tile ahead with 8
// tiles a block, and a tanh from __expf, ran no faster: PERF.md). W's chunk
// and the u-tile's g stay for the whole run where J <= 256 and A <= 32 (the
// transducer's default); any other J and A take pieces of J and chunks of
// the vocabulary, with the logsumexp carried across the chunks. Its 202 KB
// of shared memory hold one block (8 warps) per SM, and the products run
// at about a third of the FFMA issue rate: latency-bound with two warps a
// scheduler. Tensor cores (TF32) would change the float32 numerics of the
// Pallas body: not used.

#include "joint.cuh"

namespace pgasr {
namespace {

using joint::Args;
using joint::kJC;
using joint::kUT;
using joint::kVC;

constexpr int kTilesPerBlock = 4;

// a lane's cells in the product: 8 (4 x 4 vocab columns from three 16-byte
// loads: 32 multiply-adds a column j)
constexpr int kCPL = 8;

template <typename T, int NC>
__global__ void __launch_bounds__(joint::kThreads)
joint_fwd_kernel(const Args a, float* lpb, float* lpy) {
  constexpr int F = NC / kUT;
  const joint::TileSmem L(NC, kCPL, false);
  extern __shared__ float4 smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);  // [kJC][ldh]
  float* ws = hs + L.w;                            // [kJC][kVC]
  float* zs = hs + L.z;                            // [NKS][kVC][ldh]
  float* bs = hs + L.bias;                         // [kVC]
  const int b = blockIdx.z, u0 = blockIdx.y * kUT;
  const int nch = joint::chunks(a.A), np = joint::pieces(a.J);
  const bool resident = nch == 1 && np == 1;  // W's chunk and g stay
  const int U1 = a.U + 1;
  joint::CellPair cp = joint::CellPair::make<NC>();
  const int u = u0 + cp.cell % kUT;
  const int y = cp.on && u < a.U ? a.labels[(long long)b * a.U + u] : -1;

  float gr[kUT];
  if (np == 1) joint::load_g<T>(gr, a, b, u0, threadIdx.x);
  if (resident) joint::stage_w<T>(ws, nullptr, bs, a, 0, 0);

  for (int k = 0; k < kTilesPerBlock; ++k) {
    const int t0 = (blockIdx.x * kTilesPerBlock + k) * F;
    if (t0 >= a.T) break;
    cp.m = -INFINITY;
    cp.s = 0.0f;
    float z0 = 0.0f, zy = 0.0f;  // this half's z[0], z[y]
    for (int c = 0; c < nch; ++c) {
      const int c0 = c * kVC;
      float acc[kCPL][4] = {};
      for (int p = 0; p < np; ++p) {
        const int j0 = p * kJC;
        __syncthreads();  // the previous piece's products done
        if (np > 1 || c == 0) {
          if (np > 1) joint::load_g<T>(gr, a, b, u0, j0 + threadIdx.x);
          joint::stage_h<T, NC>(hs, a, b, t0, j0, gr);
        }
        if (!resident) joint::stage_w<T>(ws, nullptr, bs, a, j0, c0);
        __syncthreads();
        joint::z_product<NC, kCPL>(acc, hs, ws, min(kJC, a.J - j0));
      }
      joint::store_z<NC, kCPL>(zs, acc);
      __syncthreads();
      if (cp.on) {
        cp.fold<NC, kCPL>(zs, bs, c0, a.A);
        if (c == 0 && cp.half == 0)
          z0 = joint::z_at<NC, kCPL>(zs, bs, 0, cp.cell);
        const int k = y - c0;
        if (k >= 16 * cp.half && k < 16 * cp.half + 16 && y < a.A)
          zy = joint::z_at<NC, kCPL>(zs, bs, k, cp.cell);
      }
    }
    if (cp.on) {
      zy += __shfl_xor_sync(0xffffffffu, zy, 16);  // one half holds it
      const int t = t0 + cp.cell / kUT;
      if (cp.half == 0 && t < a.T && u < U1) {
        const float lse = cp.lse();
        const long long row = (long long)b * a.T + t;
        lpb[row * U1 + u] = z0 - lse;
        if (u < a.U) lpy[row * a.U + u] = zy - lse;
      }
    }
  }
}

template <typename T, int NC>
int launch(const Args& a, float* lpb, float* lpy, cudaStream_t stream) {
  const size_t smem =
      joint::TileSmem(NC, kCPL, false).total * sizeof(float);
  const int rc = joint::prepare_smem(joint_fwd_kernel<T, NC>, smem);
  if (rc != 0) return rc;
  const int frames = kTilesPerBlock * (NC / kUT);
  const dim3 grid((a.T + frames - 1) / frames, joint::u_tiles(a.U), a.B);
  joint_fwd_kernel<T, NC><<<grid, joint::kThreads, smem, stream>>>(a, lpb,
                                                                   lpy);
  return cudaGetLastError();
}

// 128 cells a tile where the shared memory allows, else 64
template <typename T>
int dispatch(const Args& a, float* lpb, float* lpy, cudaStream_t stream) {
  int smem_max = 0;
  const int e = smem_optin(&smem_max);
  if (e != 0) return e;
  if (joint::TileSmem(128, kCPL, false).total * sizeof(float) <=
      (size_t)smem_max)
    return launch<T, 128>(a, lpb, lpy, stream);
  return launch<T, 64>(a, lpb, lpy, stream);
}

}  // namespace
}  // namespace pgasr

extern "C" {

// dtype 0 float32, 1 bfloat16 (of e, g, W and bias). Returns 0,
// kErrSharedMemory, kErrDtype or the launch's cudaError_t.
int pgasr_joint_fwd(const void* e, const void* g, const void* W,
                    const void* bias, const int* labels, float* lp_blank,
                    float* lp_label, int B, int T, int U, int J, int A,
                    int dtype, void* stream) {
  using namespace pgasr;
  const joint::Args a{e, g, W, bias, labels, B, T, U, J, A};
  const int rc = joint::check_args(a);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, lp_blank, lp_label, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, lp_blank, lp_label, s);
  return kErrDtype;
}

}  // extern "C"
