// Block-circulant weight adjoint in the frequency domain, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bc_dw_kernel` / `bc_dw_pallas` in
// src/repro/kernels/block_circulant/kernel.py. Same function:
//
//   dŵ[p, q, f] = Σ_b ĝ[b, p, f] · conj(x̂[b, q, f])
//
// with x (B, Q·k) and the upstream cotangent g (B, P·k), each f32 or bf16,
// x̂ = x through the analysis bases C/S (k, K) and ĝ = g through the adjoint
// of the inverse rDFT CiT/SiT (k, K), K = k/2+1, all from
// `_dft_bases_adjoint_np` (odd k included: the bases carry the Hermitian
// fold). The epilogue either writes the raw pair dwr/dwi (P, Q, K) f32
// (freq_out = 1, trainable frozen tables) or folds back to the time domain,
// dw = dwr @ CT + dwi @ ST, as (P, Q·k) f32 (freq_out = 0, trainable block
// tables). All products and sums are f32 (FMA on CUDA cores).
//
// What bounds it on the H100. Per row the function needs Q forward and P
// adjoint real transforms (an FFT does each in ~2.5·k·log2 k flops) and
// 8·P·Q·K flops of per-bin complex products; its bytes are one read of x
// and g and one write of dw. At the training shapes (2048 rows, k = 128)
// the floor is f32 throughput (67 TFLOP/s without tensor cores), a few µs.
// This kernel computes the transforms as dense DFT matmuls (4·k·K flops per
// block-row, ~10x an FFT) and recomputes x̂ once per p tile and ĝ once per
// q tile, so it sits well above that floor (chip_smoke.py times it).
//
// Design. The TPU kernel walks the batch as a sequential grid axis and
// keeps its (pt, qt, K) accumulator pair in VMEM. CUDA blocks run in no
// order, and one block per (p, q) tile would leave most of the 132 SMs idle
// (fused QKV has 4 such tiles). So the rows are split across blocks:
//
//   1. bc_dw_partial, grid (P/8, Q/8, splits): each block owns an 8 x 8
//      (p, q) tile and one contiguous range of rows. Per chunk of kRows
//      rows it stages x and g in shared memory (rows and blocks past the
//      edge are zero, so they add exact zeros: nothing is padded in device
//      memory), transforms both into shared memory, and accumulates the
//      per-bin complex products in registers (each thread owns a fixed set
//      of (p, q, f) elements; rows in order). It writes its partial sums to
//      a workspace (2, splits, P, Q, K).
//   2. bc_dw_reduce, one block per (p, q): sums the partials over the splits
//      in split order — a fixed order, no atomics, so a launch is
//      reproducible bit for bit — then writes the pair or folds it through
//      CT/ST.
//
// The bases are read from global memory (resident in L2). Later versions:
// one transform per row shared by all tiles, then wgmma/TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;                 // rows staged per chunk
constexpr int kPT = 8;                   // p blocks per tile
constexpr int kQT = 8;                   // q blocks per tile
constexpr int kMaxK = 128;               // largest supported block size
constexpr int kMaxF = kMaxK / 2 + 1;     // largest K
constexpr int kAccPerThread = (kPT * kQT * kMaxF + kThreads - 1) / kThreads;
constexpr int kFoldThreads = 128;

__device__ __forceinline__ float load(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

// dynamic shared memory of bc_dw_partial for block size k, in bytes
int partial_smem_bytes(int k) {
  const int K = k / 2 + 1;
  return (int)sizeof(float) * (kRows * (kQT + kPT) * k + 2 * kRows * (kQT + kPT) * K);
}

// Stage kRows rows of `nb` blocks (starting at block b0 of `nblocks`) into
// dst (kRows, nb, k); rows >= r_end and blocks >= nblocks are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int r_end, int b0, int nblocks,
                                      int nb, int k) {
  const long stride = (long)nblocks * k;
  for (int e = threadIdx.x; e < kRows * nb * k; e += kThreads) {
    const int r = e / (nb * k), c = e - r * (nb * k);
    const int bb = c / k;
    dst[e] = (r0 + r < r_end && b0 + bb < nblocks)
                 ? load(src, (long)(r0 + r) * stride + (long)b0 * k + c)
                 : 0.f;
  }
}

// (rows, k) @ (k, K) twice: re = src @ Br, im = src @ Bi
__device__ __forceinline__ void transform(float* re, float* im,
                                          const float* src, int rows,
                                          const float* __restrict__ Br,
                                          const float* __restrict__ Bi, int k,
                                          int K) {
  for (int e = threadIdx.x; e < rows * K; e += kThreads) {
    const int row = e / K, f = e - row * K;
    const float* v = src + row * k;
    float sr = 0.f, si = 0.f;
    for (int a = 0; a < k; ++a) {
      sr = fmaf(v[a], Br[a * K + f], sr);
      si = fmaf(v[a], Bi[a * K + f], si);
    }
    re[e] = sr;
    im[e] = si;
  }
}

template <typename XT, typename GT>
__global__ void __launch_bounds__(kThreads)
bc_dw_partial(const XT* __restrict__ x, const GT* __restrict__ g,
              const float* __restrict__ C, const float* __restrict__ S,
              const float* __restrict__ CiT, const float* __restrict__ SiT,
              float* __restrict__ part, int B, int P, int Q, int k,
              int rows_per_split) {
  extern __shared__ float smem[];
  const int K = k / 2 + 1;
  const int p0 = blockIdx.x * kPT, q0 = blockIdx.y * kQT;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(B, r_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int nacc = kPT * kQT * K;

  float* xs = smem;                          // (kRows, kQT, k)
  float* gs = xs + kRows * kQT * k;          // (kRows, kPT, k)
  float* xr_s = gs + kRows * kPT * k;        // (kRows, kQT, K)
  float* xi_s = xr_s + kRows * kQT * K;
  float* gr_s = xi_s + kRows * kQT * K;      // (kRows, kPT, K)
  float* gi_s = gr_s + kRows * kPT * K;

  float acc_r[kAccPerThread], acc_i[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    acc_r[i] = 0.f;
    acc_i[i] = 0.f;
  }

  for (int r0 = r_begin; r0 < r_end; r0 += kRows) {
    stage(xs, x, r0, r_end, q0, Q, kQT, k);
    stage(gs, g, r0, r_end, p0, P, kPT, k);
    __syncthreads();
    transform(xr_s, xi_s, xs, kRows * kQT, C, S, k, K);
    transform(gr_s, gi_s, gs, kRows * kPT, CiT, SiT, k, K);
    __syncthreads();
    // per-bin complex products, rows contracted:
    //   dwr += ĝr·x̂r + ĝi·x̂i,  dwi += ĝi·x̂r − ĝr·x̂i
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < nacc) {
        const int f = e % K, pq = e / K;
        const int qq = pq % kQT, pp = pq / kQT;
        float ar = acc_r[i], ai = acc_i[i];
        for (int r = 0; r < kRows; ++r) {
          const float gr = gr_s[(r * kPT + pp) * K + f];
          const float gi = gi_s[(r * kPT + pp) * K + f];
          const float xr = xr_s[(r * kQT + qq) * K + f];
          const float xi = xi_s[(r * kQT + qq) * K + f];
          ar += gr * xr + gi * xi;
          ai += gi * xr - gr * xi;
        }
        acc_r[i] = ar;
        acc_i[i] = ai;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged tiles
  }

  const long plane = (long)P * Q * K;
  float* pr = part + (long)blockIdx.z * plane;
  float* pi = part + ((long)gridDim.z + blockIdx.z) * plane;
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (e < nacc) {
      const int f = e % K, pq = e / K;
      const int qq = pq % kQT, pp = pq / kQT;
      if (p0 + pp < P && q0 + qq < Q) {
        const long o = ((long)(p0 + pp) * Q + (q0 + qq)) * K + f;
        pr[o] = acc_r[i];
        pi[o] = acc_i[i];
      }
    }
  }
}

// One block per (p, q): partial sums in split order, then the epilogue.
__global__ void __launch_bounds__(kFoldThreads)
bc_dw_reduce(const float* __restrict__ part, const float* __restrict__ CT,
             const float* __restrict__ ST, float* __restrict__ out0,
             float* __restrict__ out1, int P, int Q, int k, int splits,
             int freq_out) {
  const int K = k / 2 + 1;
  const long pq = blockIdx.x;                // p·Q + q
  const long plane = (long)P * Q * K;
  __shared__ float dr[kMaxF], di[kMaxF];
  for (int f = threadIdx.x; f < K; f += kFoldThreads) {
    const float* pr = part + pq * K + f;
    const float* pi = pr + (long)splits * plane;
    float sr = 0.f, si = 0.f;
    for (int s = 0; s < splits; ++s) {
      sr += pr[(long)s * plane];
      si += pi[(long)s * plane];
    }
    if (freq_out) {
      out0[pq * K + f] = sr;
      out1[pq * K + f] = si;
    }
    dr[f] = sr;
    di[f] = si;
  }
  if (freq_out) return;                      // uniform across the block
  __syncthreads();
  // dw (P, Q·k) row-major: element (p, q·k + a) sits at pq·k + a
  for (int a = threadIdx.x; a < k; a += kFoldThreads) {
    float v = 0.f;
    for (int f = 0; f < K; ++f) {
      v = fmaf(dr[f], CT[f * k + a], v);
      v = fmaf(di[f], ST[f * k + a], v);
    }
    out0[pq * k + a] = v;
  }
}

template <typename XT, typename GT>
int launch_partial(const void* x, const void* g, const void* C, const void* S,
                   const void* CiT, const void* SiT, void* part, int B, int P,
                   int Q, int k, int splits, int rows_per_split,
                   cudaStream_t stream) {
  const int smem = partial_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      bc_dw_partial<XT, GT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + kPT - 1) / kPT, (Q + kQT - 1) / kQT, splits);
  bc_dw_partial<XT, GT><<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const GT*>(g),
      static_cast<const float*>(C), static_cast<const float*>(S),
      static_cast<const float*>(CiT), static_cast<const float*>(SiT),
      static_cast<float*>(part), B, P, Q, k, rows_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. x (B, Q·k) and g (B, P·k) are bf16 when
// x_bf16 / g_bf16 (else f32). `part` is an f32 workspace of
// 2·splits·P·Q·K floats; the rows are cut into `splits` ranges of
// `rows_per_split` (splits·rows_per_split >= B). freq_out: out0/out1 are
// dwr/dwi (P, Q, K) f32; else out0 is dw (P, Q·k) f32 and out1 must be null.
// Returns the first CUDA error of the two launches (0 on success).
extern "C" int bc_dw_launch(const void* x, const void* g, const void* C,
                            const void* S, const void* CiT, const void* SiT,
                            const void* CT, const void* ST, void* part,
                            void* out0, void* out1, int B, int P, int Q, int k,
                            int x_bf16, int g_bf16, int freq_out, int splits,
                            int rows_per_split, void* stream) {
  if (B < 1 || P < 1 || Q < 1 || k < 1 || k > kMaxK || splits < 1 ||
      splits > 65535 || rows_per_split < 1 ||
      (long)splits * rows_per_split < B || (long)(Q + kQT - 1) / kQT > 65535 ||
      (freq_out != 0) != (out1 != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (x_bf16) {
    rc = g_bf16 ? launch_partial<__nv_bfloat16, __nv_bfloat16>(
                      x, g, C, S, CiT, SiT, part, B, P, Q, k, splits, rows_per_split, s)
                : launch_partial<__nv_bfloat16, float>(
                      x, g, C, S, CiT, SiT, part, B, P, Q, k, splits, rows_per_split, s);
  } else {
    rc = g_bf16 ? launch_partial<float, __nv_bfloat16>(
                      x, g, C, S, CiT, SiT, part, B, P, Q, k, splits, rows_per_split, s)
                : launch_partial<float, float>(
                      x, g, C, S, CiT, SiT, part, B, P, Q, k, splits, rows_per_split, s);
  }
  if (rc != 0) return rc;
  bc_dw_reduce<<<P * Q, kFoldThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(CT),
      static_cast<const float*>(ST), static_cast<float*>(out0),
      static_cast<float*>(out1), P, Q, k, splits, freq_out);
  return (int)cudaGetLastError();
}
