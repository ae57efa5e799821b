// Shared pieces of the block-circulant kernels (bc_matmul.cu, bc_dw.cu):
// loads of f32 or bf16 rows, complex helpers, and the k/2-point real FFT of
// padded shared-memory rows (the four-step complex FFT plus the real-FFT
// split step).
//
// The real FFT of a row x of k = 2N reals runs as the N-point complex FFT
// of z[n] = (x[2n], x[2n+1]) plus the split step. The complex FFT is
// four-step, N = N1·N2 (64 = 8·8, 32 = 8·4, 16 = 4·4, N <= 8 in one step):
// N1-point DFTs in registers over stride-N2 elements, a twiddle, N2-point
// DFTs over contiguous groups; two passes over shared memory and one
// barrier. The forward leaves bin f1 + N1·f2 in slot N2·f1 + f2 (`Fft::slot`)
// and slot 0 packs the two real bins (X_0, X_{k/2}); the inverse takes that
// order and returns natural order, unscaled (k·x). A row is padded by one
// complex after every N2 slots (`Fft::pos`), so both passes' accesses
// spread over the banks. Twiddles e^{-2πij/k}, j < k, are a host table
// built in float64 (`fft_twiddles` in kernel.py), staged in shared memory
// by the caller. Every loop strides by the block's thread count kThreads,
// a template parameter that must equal the launch's blockDim.x.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// internal linkage: each kernel source builds into its own library
namespace {

__device__ __forceinline__ float load_x(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
// 16 bytes of a row -> 4 or 8 floats
__device__ __forceinline__ void load_x16(const float* p, float* v) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load_x16(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {   // a·b
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {  // a·conj(b)
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}
// a·(-i) forward, a·(+i) inverse
template <bool kInv>
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return kInv ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// M-point DFT in registers, natural order in and out; e^{-2πi/M} forward,
// e^{+2πi/M} inverse (unscaled)
template <int M, bool kInv>
__device__ __forceinline__ void dft(float2 (&v)[M]) {
  if constexpr (M == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  } else if constexpr (M == 4) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]), t3 = mul_mi<kInv>(csub(v[1], v[3]));
    v[0] = cadd(t0, t2);
    v[2] = csub(t0, t2);
    v[1] = cadd(t1, t3);
    v[3] = csub(t1, t3);
  } else if constexpr (M == 8) {
    float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
    dft<4, kInv>(e);
    dft<4, kInv>(o);
    const float c = 0.70710678118654752f;  // the e^{∓iπ/4} twiddles
    o[1] = cmul(o[1], make_float2(c, kInv ? c : -c));
    o[2] = mul_mi<kInv>(o[2]);
    o[3] = cmul(o[3], make_float2(-c, kInv ? c : -c));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = cadd(e[j], o[j]);
      v[j + 4] = csub(e[j], o[j]);
    }
  }
}

// The N-point complex FFT of one padded shared-memory row (N = k/2).
template <int N>
struct Fft {
  static constexpr int N1 = N >= 32 ? 8 : N == 16 ? 4 : N;
  static constexpr int N2 = N / N1;
  static constexpr int G = N2 > 1 ? N2 : N;   // slots between pads
  static constexpr int kRow = N + N / G;      // padded row, in complex
  // shared-memory position of slot s
  __device__ static __forceinline__ int pos(int s) { return s + s / G; }
  // the forward leaves bin f1 + N1·f2 in slot N2·f1 + f2
  __device__ static __forceinline__ int slot(int f) {
    return N2 * (f % N1) + f / N1;
  }
  // the bin that slot s holds (slot 0: bins 0 and N, packed)
  __device__ static __forceinline__ int bin(int s) {
    return s / N2 + N1 * (s % N2);
  }
};

// Forward (natural order in, slot order out) or inverse (slot order in,
// natural order out, unscaled) FFT of `nrows` rows; the caller syncs after.
template <int N, bool kInv, int kThreads>
__device__ __forceinline__ void fft_rows(float2* buf, int nrows,
                                         const float2* tws) {
  using F = Fft<N>;
  constexpr int N1 = F::N1, N2 = F::N2;
  const int tid = threadIdx.x;
  if constexpr (kInv && N2 > 1) {
    // N2-point DFTs over contiguous groups, then the twiddle
    for (int e = tid; e < nrows * N1; e += kThreads) {
      const int row = e / N1, f1 = e % N1;
      float2* z = buf + row * F::kRow;
      float2 u[N2];
#pragma unroll
      for (int i = 0; i < N2; ++i) u[i] = z[F::pos(N2 * f1 + i)];
      dft<N2, true>(u);
#pragma unroll
      for (int n2 = 1; n2 < N2; ++n2) u[n2] = cmulc(u[n2], tws[2 * n2 * f1]);
#pragma unroll
      for (int i = 0; i < N2; ++i) z[F::pos(N2 * f1 + i)] = u[i];
    }
    __syncthreads();
  }
  if constexpr (N1 > 1) {
    // N1-point DFTs over stride-N2 elements (forward: then the twiddle)
    for (int e = tid; e < nrows * N2; e += kThreads) {
      const int row = e / N2, n2 = e % N2;
      float2* z = buf + row * F::kRow;
      float2 v[N1];
#pragma unroll
      for (int i = 0; i < N1; ++i) v[i] = z[F::pos(N2 * i + n2)];
      dft<N1, kInv>(v);
      if constexpr (!kInv && N2 > 1) {
#pragma unroll
        for (int f1 = 1; f1 < N1; ++f1) v[f1] = cmul(v[f1], tws[2 * n2 * f1]);
      }
#pragma unroll
      for (int i = 0; i < N1; ++i) z[F::pos(N2 * i + n2)] = v[i];
    }
  }
  if constexpr (!kInv && N2 > 1) {
    __syncthreads();
    for (int e = tid; e < nrows * N1; e += kThreads) {
      const int row = e / N1, f1 = e % N1;
      float2* z = buf + row * F::kRow;
      float2 u[N2];
#pragma unroll
      for (int i = 0; i < N2; ++i) u[i] = z[F::pos(N2 * f1 + i)];
      dft<N2, false>(u);
#pragma unroll
      for (int i = 0; i < N2; ++i) z[F::pos(N2 * f1 + i)] = u[i];
    }
  }
}

// Real-FFT split step on transformed rows, in slot order. Forward:
// X_f = E_f + W^f·O_f, X_{N-f} = conj(E_f - W^f·O_f), slot 0 <- (X_0,
// X_{k/2}). Inverse: Z_f = E + i·O with E = Y_f + conj(Y_{N-f}),
// O = (Y_f - conj(Y_{N-f}))·conj(W^f), from slot 0 = (Y_0, Y_{k/2}).
template <int N, bool kInv, int kThreads>
__device__ __forceinline__ void split_rows(float2* buf, int nrows,
                                           const float2* tws) {
  using F = Fft<N>;
  const int tid = threadIdx.x;
  if constexpr (N == 1) {
    for (int row = tid; row < nrows; row += kThreads) {
      float2* z = buf + row * F::kRow;
      const float2 a = z[0];
      z[0] = make_float2(a.x + a.y, a.x - a.y);
    }
  } else {
    constexpr int kHalf = N / 2;
    for (int e = tid; e < nrows * kHalf; e += kThreads) {
      const int row = e / kHalf, fr = e % kHalf + 1;
      float2* z = buf + row * F::kRow;
      const int pf = F::pos(F::slot(fr)), pm = F::pos(F::slot(N - fr));
      const float2 a = z[pf], b = z[pm];
      const float2 w = tws[fr];
      if constexpr (!kInv) {
        const float2 E = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
        const float2 O = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
        const float2 T = cmul(w, O);
        z[pf] = cadd(E, T);
        if (pm != pf) z[pm] = make_float2(E.x - T.x, T.y - E.y);
      } else {
        const float2 E = make_float2(a.x + b.x, a.y - b.y);
        const float2 O = cmulc(make_float2(a.x - b.x, a.y + b.y), w);
        z[pf] = make_float2(E.x - O.y, E.y + O.x);
        if (pm != pf) z[pm] = make_float2(E.x + O.y, O.x - E.y);
      }
      if (fr == kHalf) {        // slot 0: its own pair
        const float2 c = z[0];
        z[0] = make_float2(c.x + c.y, c.x - c.y);
      }
    }
  }
}

}  // namespace
