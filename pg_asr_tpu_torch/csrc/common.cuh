// Helpers shared by the kernels (lstm_fwd.cu, lstm_bwd.cu, ctc_beam.cu,
// flash_attn.cu, flash_attn_bwd.cu, joint_fwd.cu, joint_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pgasr {

constexpr int kThreads = 512;

// Error codes of our own; positive codes are cudaError_t values.
constexpr int kErrSharedMemory = -3;    // per-block shared memory above the limit
constexpr int kErrDtype = -4;
constexpr int kErrBeamRange = -5;       // ctc_beam: M, Lmax or blank out of range, or
                                        // the block form's candidates past shared memory
constexpr int kErrHeadDim = -6;         // flash_attn(_bwd): head dim below 1

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

// value rounded to T and widened back (exact in float32)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// load through L2 only (ld.global.cg): the value was written by another
// block during this launch, and L1 may still hold an older copy
template <typename T> __device__ __forceinline__ float ldcg_f32(const T* p);
template <> __device__ __forceinline__ float ldcg_f32<float>(const float* p) {
  return __ldcg(p);
}
template <> __device__ __forceinline__ float ldcg_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// A (rows x DH) tile of a strided (.., T, DH) slice into shared memory as
// float32, row stride `ld`, by a block of NT threads; rows at or beyond Tn
// become zeros.
template <typename T, int DH, int NT>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const T* src,
                                              long long st, int t0, int rows,
                                              int Tn) {
  for (int e = threadIdx.x; e < rows * DH; e += NT) {
    const int r = e / DH, c = e % DH;
    const int t = t0 + r;
    dst[r * ld + c] = t < Tn ? to_f32<T>(src[(long long)t * st + c]) : 0.0f;
  }
}

// --- Ampere/Hopper building blocks of the tensor-core kernels
// (flash_attn.cu, flash_attn_bwd.cu, lstm_bwd.cu)

// 16 bytes from global to shared memory without passing through registers
// (cp.async.cg: cached in L2 only); with `valid` false nothing is read and
// the 16 bytes are zeroed. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits for every cp.async group this thread committed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 matrices of 16-bit values from shared memory: lanes 8i .. 8i+7
// give the addresses of matrix i's rows (16 bytes each); r[i] receives row
// lane / 4, columns 2 (lane % 4) and 2 (lane % 4) + 1 of matrix i, or with
// the .trans form the same of its transpose.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a . b on the tensor cores, one warp: a 16 x 16 (row-major fragment
// a[4]), b 16 x 8 (column-major fragment b0, b1), both bfloat16; d 16 x 8
// float32. Fragments as the PTX ISA's mma.m16n8k16 lays them out, with
// g = lane / 4, c = 2 (lane % 4): a[0] row g, columns c, c+1; a[1] row
// g+8; a[2] row g, columns c+8, c+9; a[3] row g+8, columns c+8, c+9;
// b0 rows c, c+1 of column g; b1 rows c+8, c+9; d[0], d[1] row g, columns
// c, c+1; d[2], d[3] row g+8.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest-even bfloat16, `lo` in the low half
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// *smem_max = the shared memory a block of the current device can opt in
// to. Returns 0 or a cudaError_t.
inline int smem_optin(int* smem_max) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return e;
}

// Device ordinal and SM count of the current device.
inline int device_sms(int* dev, int* sms) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
}

// --- Thread-block clusters of the LSTM walks (lstm_fwd.cu, lstm_bwd.cu):
// clusters own batch rows of one direction, the blocks of a cluster own
// hidden units, and only the cluster's blocks exchange data, through
// distributed shared memory (lstm_bwd under a split cluster barrier,
// lstm_fwd counted on mbarriers). A launch carries one direction or the
// two of a bidirectional layer: clusters 0 .. cpd - 1 walk the first,
// cpd .. 2 cpd - 1 the second.

constexpr int kRows = 8;           // batch rows of a cluster that fill the
                                   // bf16 walk's n8 tile
constexpr int kErrNoCluster = -9;  // no cluster of the kernel fits the device

// The cluster barrier split in two: arrive (release: this thread's earlier
// writes, to its own and to peer blocks' shared memory, become visible to
// every thread that waits after it) and wait (acquire); work between the
// two overlaps the barrier. Every thread of the cluster takes part.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A block's share of a walk: the direction `dir` of its cluster (cpd
// clusters a direction), whose rows are b0 .. b0 + nrows - 1 (`rows` a
// cluster, the last one ragged); the block of rank q owns the hidden units
// u0 .. u0 + nj - 1 (H / CS or one more; njmax the most a block of the
// cluster has).
struct ClusterShare {
  int njmax, nj, u0, dir, b0, nrows;
  __device__ ClusterShare(int H, int B, int CS, int rows, int cpd, int q)
      : njmax((H + CS - 1) / CS), nj(H / CS + (q < H % CS)),
        u0(q * (H / CS) + min(q, H % CS)),
        dir((int)(blockIdx.x / CS) >= cpd),
        b0(((int)(blockIdx.x / CS) - dir * cpd) * rows),
        nrows(min(rows, B - b0)) {}
};

// A launch's choice: cluster size, rows per cluster, clusters a direction
// and in all, threads and dynamic shared memory per block.
struct ClusterPlan {
  int cs, rows, cpd, clusters, threads;
  size_t smem;
};

inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr,
                                         const ClusterPlan& p,
                                         cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cs * p.clusters);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Raises the kernel's dynamic shared memory to `smem` bytes and, for
// clusters above 8 blocks, allows them. Returns 0 or a cudaError_t.
template <typename Kernel>
int set_cluster_attrs(Kernel kernel, int cs, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && cs > 8)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  return e == cudaSuccess ? 0 : e;
}

// Plans a walk of `ndir` directions of B rows each. fit(cs, rows,
// &threads, &smem) says whether a block of a cluster of cs blocks carrying
// `rows` rows fits, and its threads and dynamic shared memory. Takes the
// first cluster size of 8 (at most H) and 16 at which the most rows that
// fit (up to max_rows, within the device's shared memory) reach `need`
// (at 8) or `need16` (at 16) and at least one cluster fits on the device
// (cudaOccupancyMaxActiveClusters: n). So the cluster size, and with it
// every (row, unit)'s summation order, does not depend on B or ndir. Rows
// per cluster: as few as let every cluster of the ndir directions be
// resident at once (n / ndir a direction), rounded up to a multiple of
// `grain`; a larger batch runs in waves of clusters, which is correct
// since clusters never wait on each other. Sets the kernel's attributes
// for the most rows. Returns 0, a cudaError_t or kErrNoCluster.
template <typename Kernel, typename Fit>
int plan_clusters(Kernel kernel, int B, int H, int ndir, int grain,
                  int need, int need16, int max_rows, Fit fit,
                  ClusterPlan* p) {
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  for (int cs : {H < 8 ? H : 8, 16}) {
    ClusterPlan c = {cs, 0, 1, 1, 0, 0};  // one cluster for the query
    int cap = 0;
    for (int r = max_rows; r >= 1 && cap == 0; --r)
      if (fit(cs, r, &c.threads, &c.smem) && c.smem <= (size_t)smem_max)
        cap = r;
    if (cap < min(cs == 16 ? need16 : need, max_rows)) continue;
    int rc = set_cluster_attrs(kernel, cs, c.smem);
    if (rc != 0) return rc;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(&attr, c, 0);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (n < 1) continue;
    const int per = max(1, n / ndir);
    c.rows = min(cap, ((B + per - 1) / per + grain - 1) / grain * grain);
    c.cpd = (B + c.rows - 1) / c.rows;
    c.clusters = ndir * c.cpd;
    fit(cs, c.rows, &c.threads, &c.smem);  // the launch's own
    *p = c;
    return 0;
  }
  return kErrNoCluster;
}

}  // namespace pgasr
