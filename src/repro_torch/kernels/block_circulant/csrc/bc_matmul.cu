// Block-circulant matmul in the frequency domain, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bc_kernel` / `bc_matmul_pallas` in
// src/repro/kernels/block_circulant/kernel.py. Same function:
//
//   y[b, i·k:(i+1)·k] = act( iDFT( Σ_j DFT(x[b, j·k:(j+1)·k]) · ŵ[i, j] ) + bias )
//
// with x (B, q·k) f32 or bf16, frozen tables wr/wi (p, q, K = k/2+1) f32 or
// int8 with one f32 scale per (p, q) block, bias (p·k) f32, output (B, p·k)
// in x's type. The real DFTs are matmuls against the bases C/S (k, K) and
// Ci/Si (K, k) built by `_dft_bases_np` (odd k included); all arithmetic is
// f32 (FMA on CUDA cores: no TF32, no bf16 products).
//
// What bounds it on the H100. The function needs, per row, q forward and p
// inverse real transforms (an FFT does each in ~2.5·k·log2 k flops) and
// 8·p·q·K flops of per-bin complex products, and its bytes are one read of
// x and the tables and one write of y. At full width that floor is the
// table reads at decode (B <= 4, tens of nanoseconds) and f32 throughput
// (67 TFLOP/s without tensor cores) at B = 512 (~1.3–1.7 µs). This kernel
// computes the transforms as dense DFT matmuls, 4·q·k·K + 4·p·K·k flops per
// row (~15x the FFT count for the transforms, ~6.6x the whole function's
// least flops for fused QKV at k = 128), and reaches neither floor: with
// (B/8) x (p/8) blocks a decode launch runs 4 blocks,
// each walking q, the k-long DFT loops and the inverse serially, so it is
// bound by latency inside those few blocks (chip_smoke.py times it).
//
// Design. The grid is (row tiles of kRows, output-block tiles of kPBlk).
// A loop over the q input blocks inside the block takes the place of the
// TPU's sequential q grid axis; the (kRows, kPBlk, K) real/imag accumulators
// stay in registers across that loop (each thread owns a fixed set of
// accumulator elements), so partial sums never leave the SM. Per q step the
// block stages one x tile and one table tile in shared memory — int8
// tables are dequantized while staging, `float(q) * scale`, the same float
// op as `dequantize_symmetric`, so the int8 launch is bit-identical to the
// fp32 launch on dequantized tables — then computes the x tile's forward
// DFT into shared memory and the per-bin complex products into the
// accumulators. After the last q step the accumulators go through shared
// memory into the inverse DFT, the bias and activation epilogue, and one
// store in x's type. Ragged B and p edges are masked in the kernel (no
// caller-side padding). The bases are read from global memory (133 KB at
// k = 128, resident in L2). Later versions: more blocks per launch at small
// B (split q or k across blocks), no x-tile DFT recomputed per p tile,
// then wgmma/TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;                 // batch rows per block
constexpr int kPBlk = 8;                 // output blocks per block
constexpr int kMaxK = 128;               // largest supported block size
constexpr int kMaxF = kMaxK / 2 + 1;     // largest K
constexpr int kAccPerThread = (kRows * kPBlk * kMaxF + kThreads - 1) / kThreads;

__device__ __forceinline__ float load_x(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_y(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_y(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

// 0 none, 1 relu, 2 tanh, 3 sigmoid, 4 gelu (tanh approximation)
__device__ __forceinline__ float activate(float z, int act) {
  switch (act) {
    case 1: return fmaxf(z, 0.f);
    case 2: return tanhf(z);
    case 3: return 1.f / (1.f + expf(-z));
    case 4: {
      const float c = 0.7978845608028654f;  // sqrt(2/pi)
      return 0.5f * z * (1.f + tanhf(c * (z + 0.044715f * z * z * z)));
    }
    default: return z;
  }
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(kThreads)
bc_matmul_kernel(const XT* __restrict__ x, const WT* __restrict__ wr,
                 const WT* __restrict__ wi, const float* __restrict__ scale,
                 const float* __restrict__ bias, const float* __restrict__ C,
                 const float* __restrict__ S, const float* __restrict__ Ci,
                 const float* __restrict__ Si, XT* __restrict__ y, int B, int P,
                 int Q, int k, int act) {
  const int K = k / 2 + 1;
  const int b0 = blockIdx.x * kRows;
  const int p0 = blockIdx.y * kPBlk;
  const int tid = threadIdx.x;
  const int nacc = kRows * kPBlk * K;

  __shared__ float xs[kRows * kMaxK];                 // x tile (f32)
  __shared__ float xr_s[kRows * kMaxF], xi_s[kRows * kMaxF];
  __shared__ float wr_s[kPBlk * kMaxF], wi_s[kPBlk * kMaxF];
  __shared__ float yr_s[kRows * kPBlk * kMaxF], yi_s[kRows * kPBlk * kMaxF];

  float acc_r[kAccPerThread], acc_i[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    acc_r[i] = 0.f;
    acc_i[i] = 0.f;
  }

  const long x_stride = (long)Q * k;
  for (int j = 0; j < Q; ++j) {
    // stage the x tile (rows past B are zero)
    for (int e = tid; e < kRows * k; e += kThreads) {
      const int b = e / k, a = e - b * k;
      xs[e] = (b0 + b < B) ? load_x(x, (long)(b0 + b) * x_stride + (long)j * k + a)
                           : 0.f;
    }
    // stage the table tile, dequantizing int8 (blocks past P are zero)
    for (int e = tid; e < kPBlk * K; e += kThreads) {
      const int pp = e / K, f = e - pp * K;
      float r = 0.f, im = 0.f;
      if (p0 + pp < P) {
        const long o = ((long)(p0 + pp) * Q + j) * K + f;
        r = (float)wr[o];
        im = (float)wi[o];
        if (scale != nullptr) {
          const float s = scale[(long)(p0 + pp) * Q + j];
          r = r * s;
          im = im * s;
        }
      }
      wr_s[e] = r;
      wi_s[e] = im;
    }
    __syncthreads();
    // forward rDFT of the x tile: (kRows, k) @ (k, K)
    for (int e = tid; e < kRows * K; e += kThreads) {
      const int b = e / K, f = e - b * K;
      const float* xrow = xs + b * k;
      float sr = 0.f, si = 0.f;
      for (int a = 0; a < k; ++a) {
        const float v = xrow[a];
        sr = fmaf(v, C[a * K + f], sr);
        si = fmaf(v, S[a * K + f], si);
      }
      xr_s[e] = sr;
      xi_s[e] = si;
    }
    __syncthreads();
    // per-bin complex products, accumulated over q in registers
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < nacc) {
        const int f = e % K, bp = e / K;
        const int pp = bp % kPBlk, b = bp / kPBlk;
        const float ar = xr_s[b * K + f], ai = xi_s[b * K + f];
        const float vr = wr_s[pp * K + f], vi = wi_s[pp * K + f];
        acc_r[i] += ar * vr - ai * vi;
        acc_i[i] += ar * vi + ai * vr;
      }
    }
    __syncthreads();  // the next step overwrites the staged tiles
  }

#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (e < nacc) {
      yr_s[e] = acc_r[i];
      yi_s[e] = acc_i[i];
    }
  }
  __syncthreads();

  // inverse rDFT (K, k), bias, activation, one store in x's type
  const long y_stride = (long)P * k;
  for (int e = tid; e < kRows * kPBlk * k; e += kThreads) {
    const int a = e % k, bp = e / k;
    const int pp = bp % kPBlk, b = bp / kPBlk;
    if (b0 + b >= B || p0 + pp >= P) continue;
    const float* rr = yr_s + bp * K;
    const float* ii = yi_s + bp * K;
    float v = 0.f;
    for (int f = 0; f < K; ++f) {
      v = fmaf(rr[f], Ci[f * k + a], v);
      v = fmaf(ii[f], Si[f * k + a], v);
    }
    const long col = (long)(p0 + pp) * k + a;
    if (bias != nullptr) v += bias[col];
    store_y(y, (long)(b0 + b) * y_stride + col, activate(v, act));
  }
}

template <typename XT, typename WT>
void launch(const void* x, const void* wr, const void* wi, const void* scale,
            const void* bias, const void* C, const void* S, const void* Ci,
            const void* Si, void* y, int B, int P, int Q, int k, int act,
            cudaStream_t stream) {
  const dim3 grid((B + kRows - 1) / kRows, (P + kPBlk - 1) / kPBlk);
  bc_matmul_kernel<XT, WT><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(wr),
      static_cast<const WT*>(wi), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(C),
      static_cast<const float*>(S), static_cast<const float*>(Ci),
      static_cast<const float*>(Si), static_cast<XT*>(y), B, P, Q, k, act);
}

}  // namespace

// Plain C entry point for ctypes. x_bf16: x and y are bf16 (else f32);
// w_int8: wr/wi are int8 and `scale` (P, Q) f32 is required (else f32 and
// `scale` must be null). `bias` may be null. Returns cudaGetLastError().
extern "C" int bc_matmul_forward(const void* x, const void* wr, const void* wi,
                                 const void* scale, const void* bias,
                                 const void* C, const void* S, const void* Ci,
                                 const void* Si, void* y, int B, int P, int Q,
                                 int k, int x_bf16, int w_int8, int act,
                                 void* stream) {
  if (B < 1 || P < 1 || Q < 1 || k < 1 || k > kMaxK || act < 0 || act > 4 ||
      (w_int8 != 0) != (scale != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (w_int8)
      launch<__nv_bfloat16, int8_t>(x, wr, wi, scale, bias, C, S, Ci, Si, y, B, P, Q, k, act, s);
    else
      launch<__nv_bfloat16, float>(x, wr, wi, scale, bias, C, S, Ci, Si, y, B, P, Q, k, act, s);
  } else {
    if (w_int8)
      launch<float, int8_t>(x, wr, wi, scale, bias, C, S, Ci, Si, y, B, P, Q, k, act, s);
    else
      launch<float, float>(x, wr, wi, scale, bias, C, S, Ci, Si, y, B, P, Q, k, act, s);
  }
  return (int)cudaGetLastError();
}
