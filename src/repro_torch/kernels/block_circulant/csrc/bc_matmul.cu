// Block-circulant matmul in the frequency domain, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bc_kernel` / `bc_matmul_pallas` in
// src/repro/kernels/block_circulant/kernel.py. Same function:
//
//   y[b, i·k:(i+1)·k] = act( iDFT( Σ_j DFT(x[b, j·k:(j+1)·k]) · ŵ[i, j] ) + bias )
//
// with x (B, q·k) f32 or bf16, frozen tables wr/wi (p, q, K = k/2+1) f32 or
// int8 with one f32 scale per (p, q) block, bias (p·k) f32, output (B, p·k)
// in x's type. The inverse is irfft's: bins 0 and k/2 count once, the others
// twice, scaled by 1/k, and the imaginary parts at bins 0 and k/2 are
// dropped (the rows of the reference's Si there are zero), whatever the
// tables hold there. All arithmetic is f32 on CUDA cores: no TF32, no bf16
// products.
//
// What bounds it on the H100. Per row the function needs q forward and p
// inverse real transforms (~2.5·k·log2 k flops each by FFT) and 8·p·q·K
// flops of per-bin complex products; its bytes are one read of x and the
// tables and one write of y. At decode (B <= 8) that floor is tens of
// nanoseconds of table reads, far under a launch, so a decode launch is
// bound by the launch and the latency of one block's chain of loads,
// transforms and barriers (~10–13 µs). At B = 512..2048 the floor is the
// f32 rate or HBM (1–7 µs), and the kernel takes 8–23x that. Builds that
// left one phase out, timed while this design was tuned, ran about a
// third faster without the per-bin products at B = 2048 and a quarter
// faster without the forward FFT. At those shapes a block takes ~108 KB
// of shared memory, so an SM holds two blocks (16 warps); that the
// products and transforms then wait on shared-memory latency is a reading
// of these times, not a measurement (no profiler measured it).
// chip_smoke.py prints the kernel's times, geometry and registers.
//
// Design.
//  * Geometry from the shapes (`_mm_geometry` in kernel.py): a block owns
//    `rows` batch rows and `p_group` output blocks, and the fewer columns
//    of blocks, the fewer times each x row is transformed. At decode
//    p_group is 1, so a launch runs one block per output block (>= p
//    blocks); at B = 2048 one column of 256 blocks owns all output blocks,
//    so each x row is transformed once. The q sum never leaves a block:
//    no second kernel, no atomics, two launches agree bit for bit.
//  * x̂ computed once per block: the block stages its rows' x chunk
//    (`q_chunk` input blocks; 16-byte vector loads where k and the pointer
//    allow) in shared memory as f32 and transforms it in place; every
//    output block of the block reads the same x̂.
//  * Transforms, power-of-two k (a template parameter, so every index is a
//    shift; the FFT lives in bc_fft.cuh, shared with bc_dw.cu): a real FFT as an N = k/2-point complex FFT of (x[2n], x[2n+1])
//    plus the split step. The complex FFT is four-step, N = N1·N2 (64 =
//    8·8, 32 = 8·4, 16 = 4·4, N <= 8 in one step): N1-point DFTs in
//    registers over stride-N2 elements, a twiddle, N2-point DFTs over
//    contiguous groups; two passes over shared memory and one barrier.
//    The forward leaves bin f1 + N1·f2 in slot N2·f1 + f2; the products
//    and the inverse (the same steps reversed, conjugated) work in that
//    order, so no permutation pass runs. Slot 0 packs the two real bins
//    (X_0, X_{k/2}). A row is padded by one complex after every N2 slots,
//    so both passes' accesses spread over the banks. Twiddles e^{-2πij/k},
//    j < k, are a host table built in float64 (`fft_twiddles`), staged in
//    shared memory. Any other k (odd, 1, 96, ...) runs dense DFT loops over
//    `dft_bases` staged in shared memory (C/S for the forward, then Ci/Si
//    for the inverse in the same space).
//  * Per-bin products: thread (bin, output-block group, q group) holds
//    rows x p_per_thread complex accumulators in registers; each table
//    value it reads serves all its rows, each x̂ value all its output
//    blocks. The table tile of a pass and chunk (p_pass x q_chunk rows of
//    K bins, contiguous in memory for each output block) is copied to
//    shared memory with cp.async while x is staged and transformed, so
//    the product loop waits on no global load. Its row loads are issued
//    together, without branches. int8 tables (plain loads: rows of K bytes
//    are not 4-byte aligned) are dequantized as they are read,
//    `float(q) * scale`, the same float op as `dequantize_symmetric`, so
//    the int8 launch is bit-identical to the f32 launch on dequantized
//    tables. Where a block holds fewer output blocks than its threads have
//    groups (decode), the groups split the q sum and add their partials in
//    a fixed order in shared memory.
//  * Epilogue: the inverse transform of each (row, output block), bias,
//    activation, one store in x's type (two elements per store on the FFT
//    path); ragged B and p are masked here.
//  * Tensor cores are not used: the per-bin product contracts only q terms
//    per bin, and the f32 tolerance (2e-5 relative) rules out TF32. A
//    3xTF32 split on mma.sync is a later option.
//  * Groups: G independent products of one shape (a MoE layer's experts,
//    the reference's `_bc_kernel` under `jax.vmap`) run as one launch with
//    grid z = G. Block z offsets x, the tables, their scales, the bias and
//    y by its group's stride and then runs the single-product code above
//    unchanged; each group's geometry is the one product's. G = 1 is the
//    single launch (z = 0, no offset).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bc_fft.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 128;       // largest supported block size
constexpr int kMaxRows = 8;      // batch rows per block
constexpr int kMaxJ = 2;         // output blocks per thread per pass
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ void store_y(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_y(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}
// M in {2, 4, 8} neighbouring outputs, i a multiple of M: one 8- or
// 16-byte store per 4 f32 or 8 bf16 outputs
template <int M>
__device__ __forceinline__ void store_yv(float* p, long i,
                                         const float (&v)[M]) {
  if constexpr (M == 2) {
    *reinterpret_cast<float2*>(p + i) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < M; j += 4)
      *reinterpret_cast<float4*>(p + i + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  }
}
template <int M>
__device__ __forceinline__ void store_yv(__nv_bfloat16* p, long i,
                                         const float (&v)[M]) {
  __nv_bfloat162 h[M / 2];
#pragma unroll
  for (int j = 0; j < M / 2; ++j)
    h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  if constexpr (M == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p + i) = h[0];
  } else if constexpr (M == 4) {
    *reinterpret_cast<uint2*>(p + i) = *reinterpret_cast<const uint2*>(h);
  } else {
    *reinterpret_cast<uint4*>(p + i) = *reinterpret_cast<const uint4*>(h);
  }
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

// 4-byte asynchronous copy global -> shared, and the wait for all of a
// thread's copies
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// acc[r][j] += x̂[r] · ŵ[j] over one q step; the packed slot multiplies
// its two real bins separately. The R row loads are issued together (rows
// past R re-read row R-1 and are not accumulated), so one shared-memory
// latency serves them all.
template <bool kPacked>
__device__ __forceinline__ void accumulate(float2 (&acc)[kMaxRows][kMaxJ],
                                           const float2* xh, int stride,
                                           const float2 (&w)[kMaxJ], int R,
                                           int J) {
  float2 v[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) v[r] = xh[min(r, R - 1) * stride];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    if (j < J) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < R) {
          if (kPacked) {
            acc[r][j].x = fmaf(v[r].x, w[j].x, acc[r][j].x);
            acc[r][j].y = fmaf(v[r].y, w[j].y, acc[r][j].y);
          } else {
            acc[r][j].x =
                fmaf(v[r].x, w[j].x, fmaf(-v[r].y, w[j].y, acc[r][j].x));
            acc[r][j].y =
                fmaf(v[r].x, w[j].y, fmaf(v[r].y, w[j].x, acc[r][j].y));
          }
        }
      }
    }
  }
}

// Shared-memory layout, in floats. FFT path (N = k/2 > 0): the x chunk,
// transformed in place, R·QC padded rows; the q-group partials, QG·R·PT
// padded rows (the inverse runs in place in the first R·PT); the k
// twiddles. Dense path (N = 0): the x chunk R·QC·k, the partials
// QG·R·PT·K complex, the x̂ chunk R·QC·K complex, the bases 2·k·K. Both:
// the table tile of a pass and chunk, wr then wi as (PT, QC, K) in the
// tables' type (room for f32), and its int8 scales (PT, QC).
// `_mm_smem_bytes` in kernel.py mirrors it; every launch checks that the
// two agree.
struct Layout {
  int xs, ys, xh, bs, wt, sc;
  __host__ __device__ Layout(int N, int row, int k, int R, int QC, int QG,
                             int PT) {
    const int K = k / 2 + 1;
    if (N > 0) {
      xs = 2 * R * QC * row;
      ys = 2 * QG * R * PT * row;
      xh = 0;
      bs = 2 * k;
    } else {
      xs = (R * QC * k + 3) / 4 * 4;
      ys = 2 * QG * R * PT * K;
      xh = 2 * R * QC * K;
      bs = 2 * k * K;
    }
    wt = 2 * PT * QC * K;
    sc = PT * QC;
  }
  __host__ __device__ int floats() const {
    return xs + ys + xh + bs + wt + sc;
  }
};

// kN = k/2 for power-of-two k (FFT path), 0 for any other k (dense path).
template <typename XT, typename WT, int kN>
__global__ void __launch_bounds__(kThreads)
bc_matmul_kernel(const XT* __restrict__ x, const WT* __restrict__ wr,
                 const WT* __restrict__ wi, const float* __restrict__ scale,
                 const float* __restrict__ bias, const float2* __restrict__ tw,
                 const float* __restrict__ C, const float* __restrict__ Sb,
                 const float* __restrict__ Ci, const float* __restrict__ Si,
                 XT* __restrict__ y, int B, int P, int Q, int k_rt, int act,
                 int R, int PG, int QC, int QG, int PI, int J) {
  constexpr bool kFFT = kN > 0;
  using F = Fft<kFFT ? kN : 1>;
  const int k = kFFT ? 2 * kN : k_rt;
  const int K = k / 2 + 1;
  // this block's group: every per-group operand moves by its group stride
  const long grp_z = blockIdx.z;
  x += grp_z * B * Q * k;
  wr += grp_z * P * Q * K;
  wi += grp_z * P * Q * K;
  if (scale != nullptr) scale += grp_z * P * Q;
  if (bias != nullptr) bias += grp_z * P * k;
  y += grp_z * B * P * k;
  const int S = kFFT ? kN : K;                // slots per transformed row
  const int RS = kFFT ? F::kRow : K;          // row stride, in complex
  const int tid = threadIdx.x;
  const int PT = PI * J;
  const int b0 = blockIdx.x * R;
  const int pg0 = blockIdx.y * PG;
  const int pend = min(P, pg0 + PG);
  const int nchunks = (Q + QC - 1) / QC;

  extern __shared__ float4 smem_raw[];
  const Layout L(kN, F::kRow, k, R, QC, QG, PT);
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* ys = xs + L.xs;
  float* xhf = kFFT ? xs : ys + L.ys;
  float* bs = ys + L.ys + L.xh;
  float2* xs2 = reinterpret_cast<float2*>(xs);
  float2* ys2 = reinterpret_cast<float2*>(ys);
  const float2* xh2 = reinterpret_cast<const float2*>(xhf);
  float2* tws = reinterpret_cast<float2*>(bs);
  WT* tr = reinterpret_cast<WT*>(bs + L.bs);   // table tile: wr, then wi
  WT* ti = tr + PT * QC * K;
  float* sct = bs + L.bs + L.wt;               // its int8 scales

  if constexpr (kFFT) {
    for (int e = tid; e < k; e += kThreads) tws[e] = tw[e];
  }

  // thread -> (bin f, output-block group pi, q group qg); bin f lives at
  // fpos in a transformed row (slot order, padded)
  const int f = tid % S, grp = tid / S;
  const bool active = grp < PI * QG;
  const int pi = grp / QG, qg = grp - (grp / QG) * QG;
  const bool packed = kFFT && f == 0;
  const int fpos = kFFT ? F::pos(F::slot(f)) : f;

  const long x_ld = (long)Q * k;
  const long y_ld = (long)P * k;
  constexpr int V = 16 / sizeof(XT);
  const bool vec = (k % V == 0) &&
                   ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  int held = 0;  // dense path: 1 = C/S staged, 2 = Ci/Si staged

  for (int pass = 0; pg0 + pass < pend; pass += PT) {
    float2 acc[kMaxRows][kMaxJ];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) acc[r][j] = make_float2(0.f, 0.f);

    for (int c = 0; c < nchunks; ++c) {
      const int q0 = c * QC, qn = min(QC, Q - q0);
      const int nrows = R * QC;
      __syncthreads();  // the previous chunk's readers are done
      // the table tile of this pass and chunk: for each output block, the
      // chunk's qn·K table values are contiguous in memory. Asynchronous
      // copies (f32), in flight while x is staged and transformed; int8 by
      // plain loads
      for (int pp = 0; pp < PT && pg0 + pass + pp < pend; ++pp) {
        const long o = ((long)(pg0 + pass + pp) * Q + q0) * K;
        for (int e = tid; e < qn * K; e += kThreads) {
          if constexpr (sizeof(WT) == 4) {
            cp_async4(tr + pp * QC * K + e, wr + o + e);
            cp_async4(ti + pp * QC * K + e, wi + o + e);
          } else {
            tr[pp * QC * K + e] = wr[o + e];
            ti[pp * QC * K + e] = wi[o + e];
          }
        }
      }
      if (scale != nullptr) {
        for (int e = tid; e < PT * QC; e += kThreads) {
          const int pp = e / QC, q = e - pp * QC;
          const int p = pg0 + pass + pp;
          if (p < pend && q < qn) sct[e] = scale[(long)p * Q + q0 + q];
        }
      }
      if (nchunks > 1 || pass == 0) {
        // stage x: row (r, q) is staged row r·QC + q; past B or qn is zero.
        // FFT path: complex n = (x[2n], x[2n+1]) at the padded pos(n)
        const int seg = QC * k;
        if (vec) {
          const int nv = seg / V;
          for (int e = tid; e < R * nv; e += kThreads) {
            const int r = e / nv, col = (e - r * nv) * V;
            float v[V];
            if (b0 + r < B && col < qn * k) {
              load_x16(x + (long)(b0 + r) * x_ld + (long)q0 * k + col, v);
            } else {
#pragma unroll
              for (int i = 0; i < V; ++i) v[i] = 0.f;
            }
            if constexpr (kFFT) {
              const int q = col / k, a = col % k;
              float2* z = xs2 + (r * QC + q) * F::kRow;
#pragma unroll
              for (int i = 0; i < V / 2; ++i)
                z[F::pos(a / 2 + i)] = make_float2(v[2 * i], v[2 * i + 1]);
            } else {
              float4* dst = reinterpret_cast<float4*>(xs + r * seg + col);
#pragma unroll
              for (int i = 0; i < V / 4; ++i)
                dst[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                     v[4 * i + 3]);
            }
          }
        } else {
          for (int e = tid; e < R * seg; e += kThreads) {
            const int r = e / seg, col = e - r * seg;
            const float v =
                (b0 + r < B && col < qn * k)
                    ? load_x(x, (long)(b0 + r) * x_ld + (long)q0 * k + col)
                    : 0.f;
            if constexpr (kFFT) {
              const int q = col / k, a = col % k;
              xs[2 * ((r * QC + q) * F::kRow + F::pos(a / 2)) + (a & 1)] = v;
            } else {
              xs[e] = v;
            }
          }
        }
        if (!kFFT && held != 1) {
          for (int e = tid; e < k * K; e += kThreads) {
            bs[e] = C[e];
            bs[k * K + e] = Sb[e];
          }
          held = 1;
        }
        __syncthreads();
        if constexpr (kFFT) {
          fft_rows<kN, false, kThreads>(xs2, nrows, tws);
          __syncthreads();
          split_rows<kN, false, kThreads>(xs2, nrows, tws);
        } else {
          // dense rDFT of every staged row through C/S
          for (int e = tid; e < nrows * K; e += kThreads) {
            const int row = e / K, fr = e - row * K;
            const float* xr = xs + row * k;
            float sr = 0.f, si = 0.f;
            for (int a = 0; a < k; ++a) {
              sr = fmaf(xr[a], bs[a * K + fr], sr);
              si = fmaf(xr[a], bs[k * K + a * K + fr], si);
            }
            xhf[2 * e] = sr;
            xhf[2 * e + 1] = si;
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      // per-bin complex products over this chunk's q steps; int8 tables
      // dequantize here, float(q) * scale
      if (active) {
        const float2* xq = xh2 + fpos;
        for (int q = qg; q < qn; q += QG) {
          // tile loads without branches: rows past the pass re-read its
          // last row and are replaced by zero
          float2 w[kMaxJ];
#pragma unroll
          for (int j = 0; j < kMaxJ; ++j) {
            const int pp = min(pi + j * PI, PT - 1);
            const int o = (pp * QC + q) * K;
            float r = (float)tr[o + f];
            float im = packed ? (float)tr[o + kN] : (float)ti[o + f];
            if (scale != nullptr) {
              const float sv = sct[pp * QC + q];
              r = r * sv;
              im = im * sv;
            }
            const bool ok = j < J && pg0 + pass + pi + j * PI < pend;
            w[j] = ok ? make_float2(r, im) : make_float2(0.f, 0.f);
          }
          if (packed)
            accumulate<true>(acc, xq + q * RS, QC * RS, w, R, J);
          else
            accumulate<false>(acc, xq + q * RS, QC * RS, w, R, J);
        }
      }
    }

    // partials -> shared memory, then the q groups' sum in a fixed order
    __syncthreads();  // the previous pass's epilogue is done with ys
    if (active) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j)
          if (r < R && j < J)
            ys2[((qg * R + r) * PT + pi + j * PI) * RS + fpos] = acc[r][j];
    }
    __syncthreads();
    const int nout = R * PT;
    if (QG > 1) {
      for (int e = tid; e < nout * RS; e += kThreads) {
        float2 s = ys2[e];
        for (int g = 1; g < QG; ++g) s = cadd(s, ys2[g * nout * RS + e]);
        ys2[e] = s;
      }
      __syncthreads();
    }
    if constexpr (kFFT) {
      split_rows<kN, true, kThreads>(ys2, nout, tws);
      __syncthreads();
      fft_rows<kN, true, kThreads>(ys2, nout, tws);
      __syncthreads();
      // natural order: complex n of a row = k·(y[2n], y[2n+1]); each
      // thread takes kV neighbouring complex (one pad group at most)
      constexpr int kV = F::G < 4 ? F::G : 4;
      constexpr int kPer = kN / kV;
      const float inv_k = 1.f / (float)k;
      for (int e = tid; e < nout * kPer; e += kThreads) {
        const int row = e / kPer, n0 = e % kPer * kV;
        const int r = row / PT, pp = row - r * PT;
        const int b = b0 + r, p = pg0 + pass + pp;
        if (b >= B || p >= pend) continue;
        const long col = (long)p * k + 2 * n0;
        float v[2 * kV];
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          const float2 z = ys2[row * F::kRow + F::pos(n0 + i)];
          v[2 * i] = z.x * inv_k;
          v[2 * i + 1] = z.y * inv_k;
        }
#pragma unroll
        for (int i = 0; i < 2 * kV; ++i) {
          if (bias != nullptr) v[i] += bias[col + i];
          v[i] = activate(v[i], act);
        }
        store_yv<2 * kV>(y, (long)b * y_ld + col, v);
      }
    } else {
      if (held != 2) {
        for (int e = tid; e < k * K; e += kThreads) {
          bs[e] = Ci[e];
          bs[k * K + e] = Si[e];
        }
        held = 2;
        __syncthreads();
      }
      // inverse rDFT through Ci/Si, bias, activation, one store
      for (int e = tid; e < nout * k; e += kThreads) {
        const int row = e / k, a = e - row * k;
        const int r = row / PT, pp = row - r * PT;
        const int b = b0 + r, p = pg0 + pass + pp;
        if (b >= B || p >= pend) continue;
        const float* yr = ys + row * K * 2;
        float v = 0.f;
        for (int fr = 0; fr < K; ++fr) {
          v = fmaf(yr[2 * fr], bs[fr * k + a], v);
          v = fmaf(yr[2 * fr + 1], bs[k * K + fr * k + a], v);
        }
        const long col = (long)p * k + a;
        if (bias != nullptr) v += bias[col];
        store_y(y, (long)b * y_ld + col, activate(v, act));
      }
    }
  }
}

template <typename XT, typename WT, int kN>
int launch(const void* x, const void* wr, const void* wi, const void* scale,
           const void* bias, const void* tw, const void* C, const void* S,
           const void* Ci, const void* Si, void* y, int B, int P, int Q, int k,
           int G, int act, int R, int PG, int QC, int QG, int PI, int J,
           int smem, cudaStream_t stream) {
  // the caller's size (`_mm_smem_bytes`) must be this layout's, so the
  // geometry was chosen on the bytes the kernel really takes
  const Layout L(kN, Fft<(kN > 0 ? kN : 1)>::kRow, k, R, QC, QG, PI * J);
  if (smem != 4L * L.floats() || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  // the limit is held per device: set it on every launch, as bc_dw.cu does
  // (to the most any geometry takes, so threads launching other sizes
  // never lower it under one another)
  const cudaError_t e = cudaFuncSetAttribute(
      bc_matmul_kernel<XT, WT, kN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + R - 1) / R, (P + PG - 1) / PG, G);
  bc_matmul_kernel<XT, WT, kN><<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(wr),
      static_cast<const WT*>(wi), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float2*>(tw),
      static_cast<const float*>(C), static_cast<const float*>(S),
      static_cast<const float*>(Ci), static_cast<const float*>(Si),
      static_cast<XT*>(y), B, P, Q, k, act, R, PG, QC, QG, PI, J);
  return (int)cudaGetLastError();
}

// the instantiation for block size k: the FFT length for a power of two,
// else the dense path
template <typename XT, typename WT>
int launch_k(const void* x, const void* wr, const void* wi, const void* sc,
             const void* bias, const void* tw, const void* C, const void* S,
             const void* Ci, const void* Si, void* y, int B, int P, int Q,
             int k, int G, int act, int R, int PG, int QC, int QG, int PI,
             int J, int smem, cudaStream_t s) {
#define BC_LAUNCH(N)                                                        \
  launch<XT, WT, N>(x, wr, wi, sc, bias, tw, C, S, Ci, Si, y, B, P, Q, k,  \
                    G, act, R, PG, QC, QG, PI, J, smem, s)
  switch (k) {
    case 2: return BC_LAUNCH(1);
    case 4: return BC_LAUNCH(2);
    case 8: return BC_LAUNCH(4);
    case 16: return BC_LAUNCH(8);
    case 32: return BC_LAUNCH(16);
    case 64: return BC_LAUNCH(32);
    case 128: return BC_LAUNCH(64);
    default: return BC_LAUNCH(0);
  }
#undef BC_LAUNCH
}

}  // namespace

// Plain C entry point for ctypes. `groups` G >= 1 products of one shape
// run as one launch: x (G, B, Q·k), wr/wi (G, P, Q, K), scale (G, P, Q),
// bias (G, P·k), y (G, B, P·k), each contiguous; G = 1 is one product.
// x_bf16: x and y are bf16 (else f32); w_int8: wr/wi are int8 and `scale`
// (G, P, Q) f32 is required (else f32 and `scale` must be null). `bias` may
// be null. Power-of-two k >= 2 takes the FFT path and needs `tw` (k complex
// twiddles, `fft_twiddles`), shared by the groups; any other k takes the
// dense path and needs the bases C, S (k, K) and Ci, Si (K, k).
// The geometry (rows, p_group, q_chunk, q_groups, p_inner, p_per_thread)
// and the block's dynamic shared memory in bytes (`smem_bytes`, which must
// equal `Layout`'s) come from `_mm_geometry`. Returns a CUDA error code (0
// on success).
extern "C" int bc_matmul_forward(const void* x, const void* wr, const void* wi,
                                 const void* scale, const void* bias,
                                 const void* tw, const void* C, const void* S,
                                 const void* Ci, const void* Si, void* y,
                                 int B, int P, int Q, int k, int groups,
                                 int x_bf16, int w_int8, int act, int rows,
                                 int p_group, int q_chunk, int q_groups,
                                 int p_inner, int p_per_thread,
                                 int smem_bytes, void* stream) {
  const bool fft = k >= 2 && (k & (k - 1)) == 0;
  const int slots = fft ? k / 2 : k / 2 + 1;
  if (B < 1 || P < 1 || Q < 1 || k < 1 || k > kMaxK || act < 0 || act > 4 ||
      groups < 1 || groups > 65535 ||
      (w_int8 != 0) != (scale != nullptr) || rows < 1 || rows > kMaxRows ||
      p_group < 1 || q_chunk < 1 || q_chunk > Q || q_groups < 1 ||
      p_inner < 1 || p_per_thread < 1 || p_per_thread > kMaxJ ||
      p_inner * q_groups * slots > kThreads ||
      (fft ? tw == nullptr
           : (C == nullptr || S == nullptr || Ci == nullptr ||
              Si == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BC_ARGS                                                              \
  x, wr, wi, scale, bias, tw, C, S, Ci, Si, y, B, P, Q, k, groups, act, rows, \
      p_group, q_chunk, q_groups, p_inner, p_per_thread, smem_bytes, s
  int rc;
  if (x_bf16)
    rc = w_int8 ? launch_k<__nv_bfloat16, int8_t>(BC_ARGS)
                : launch_k<__nv_bfloat16, float>(BC_ARGS);
  else
    rc = w_int8 ? launch_k<float, int8_t>(BC_ARGS)
                : launch_k<float, float>(BC_ARGS);
#undef BC_ARGS
  return rc;
}
