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
//   1 <= A <= 32, any T >= 1, U >= 0, J >= 1 (while W and the tiles fit
//   shared memory: J <= ~680 at A = 32).
// Per lattice cell, in float32: h = tanh(e_t + g_u), z = h . W + bias
// (summed over j in order), lse = max + log(sum exp(z - max)),
// lp_blank = z[0] - lse, lp_label = z[y_u] - lse (u < U). The 4-D joint
// never reaches device memory.
//
// What bounds it on this card: per cell J tanh and J x A multiply-adds.
// At the transducer's train shape (B=64, T'=201, U+1=61, J=256, A=28:
// 784 704 cells) that is 11.25 GFLOP and 201 M tanh against ~23 MB of
// inputs and outputs, so the float32 operation rate bounds it (~0.17 ms at
// 67 TFLOP/s) in both input types: the math is float32 on CUDA cores.
//
// What the design does about it (joint.cuh): one thread per cell, z in
// registers (A padded to 8, 16 or 32); W and the block's 32 g rows stay in
// shared memory while the block walks 4 T-tiles of 8 frames, so each e, g
// and W value is read from device memory once per block; W is read as
// broadcast float4s, g rows are padded against bank conflicts. Tensor
// cores (the head product as a GEMM of 256 cells x J x A) are later work.

#include "joint.cuh"

namespace pgasr {
namespace {

using joint::Args;
using joint::kTT;
using joint::kUT;

template <typename T, int AP>
__global__ void __launch_bounds__(joint::kThreads)
joint_fwd_kernel(const Args a, float* lpb, float* lpy) {
  extern __shared__ float4 smem_raw[];
  float* Ws = reinterpret_cast<float*>(smem_raw);
  float* Gs = Ws + a.J * AP;
  float* Es = Gs + kUT * (a.J + 1);

  const int b = blockIdx.z, u0 = blockIdx.y * kUT;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int U1 = a.U + 1, u = u0 + lane;
  joint::load_w_g<T, AP>(Ws, Gs, a, b, u0);
  float bz[AP];
  joint::load_bias<T, AP>(bz, a);
  const int y = u < a.U ? a.labels[(long long)b * a.U + u] : -1;

  for (int k = 0; k < joint::kTilesPerBlock; ++k) {
    const int t0 = (blockIdx.x * joint::kTilesPerBlock + k) * kTT;
    if (t0 >= a.T) break;
    __syncthreads();  // W and g staged; the previous e tile consumed
    joint::load_e<T>(Es, a, b, t0);
    __syncthreads();
    float z[AP];
    joint::cell_logits<AP>(z, Es, Gs, Ws, bz, a.J, w, lane);
    const int t = t0 + w;
    if (t < a.T && u < U1) {
      float m, s;
      joint::max_sum<AP>(z, a.A, &m, &s);
      const float lse = m + logf(s);
      const long long row = (long long)b * a.T + t;
      lpb[row * U1 + u] = z[0] - lse;
      if (u < a.U) lpy[row * a.U + u] = joint::pick<AP>(z, y) - lse;
    }
  }
}

template <typename T, int AP>
int launch(const Args& a, float* lpb, float* lpy, cudaStream_t stream) {
  const size_t smem = joint::tile_floats(a.J, AP) * sizeof(float);
  const int rc = joint::prepare_smem(joint_fwd_kernel<T, AP>, smem);
  if (rc != 0) return rc;
  const dim3 grid(joint::t_walks(a.T), joint::u_tiles(a.U), a.B);
  joint_fwd_kernel<T, AP><<<grid, joint::kThreads, smem, stream>>>(a, lpb,
                                                                   lpy);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, float* lpb, float* lpy, cudaStream_t stream) {
  switch (joint::padded_vocab(a.A)) {
    case 8: return launch<T, 8>(a, lpb, lpy, stream);
    case 16: return launch<T, 16>(a, lpb, lpy, stream);
    case 32: return launch<T, 32>(a, lpb, lpy, stream);
  }
  return kErrVocab;
}

}  // namespace
}  // namespace pgasr

extern "C" {

// dtype 0 float32, 1 bfloat16 (of e, g, W and bias). Returns 0, kErrVocab,
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
