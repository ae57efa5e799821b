// Block-circulant weight adjoint in the frequency domain, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bc_dw_kernel` / `bc_dw_pallas` in
// src/repro/kernels/block_circulant/kernel.py. Same function:
//
//   dŵ[p, q, f] = Σ_b ĝ[b, p, f] · conj(x̂[b, q, f])
//
// with x (B, Q·k) and the upstream cotangent g (B, P·k), each f32 or bf16.
// The reference computes x̂ through the analysis bases C/S and ĝ through
// the adjoint of the inverse rDFT CiT/SiT (`_dft_bases_adjoint_np`). Both
// are forward real DFTs: x̂ = rfft(x) and ĝ = (g_f/k)·rfft(g), with
// g_f = 1 at f = 0 (and f = k/2 for even k), else 2. So with
// X̂ = rfft(x block) and Ĝ = rfft(g block), one forward transform for both,
//
//   A[p, q, f] = Σ_b Ĝ[b, p, f] · conj(X̂[b, q, f])
//   (dwr + i·dwi)[p, q, f] = (g_f / k) · A[p, q, f]     (freq_out = 1)
//   dw[p, q·k : (q+1)·k]   = irfft(A[p, q, :], n = k)   (freq_out = 0)
//
// since the reference's fold dw = dwr @ CT + dwi @ ST is k·irfft(dŵ/g_f).
// The raw pair dwr/dwi (P, Q, K) f32 is the frozen tables' cotangent; the
// folded dw (P, Q·k) f32 the trainable block tables'. All products and sums
// are f32 (FMA on CUDA cores).
//
// What bounds it on the H100. Per row the function needs Q + P forward
// real transforms (~2.5·k·log2 k flops each by FFT) and 8·P·Q·K flops of
// per-bin complex products; its bytes are one read of x and g and one write
// of dw. At the training shapes (2048 rows, k = 128, bf16) both floors are
// a few µs: ~4–7 µs of f32 FMA (67 TFLOP/s without tensor cores) against
// ~4–6 µs of HBM reads. The kernel transforms each row once per launch by
// FFT and keeps the per-bin sums in registers, but it adds a round trip
// through an f32 workspace of per-split partial sums (splits x P x Q x k/2
// complex, 17 MB at fused QKV, which fits the 50 MB L2) and runs a block's
// phases (staging, FFT, products) one after another on an SM that holds
// only that block, so it sits ~9–10x above the floor (chip_smoke.py
// prints its times, geometry and registers).
//
// Design.
//  * Geometry from the shapes (`_dw_geometry` in kernel.py; the kernel
//    checks what it is given). A block owns a (p, q) tile and a contiguous
//    range of rows. The tile covers all of P and Q wherever P·Q·(k/2)
//    complex sums fit the registers of one block (512 threads, at most
//    kMaxPt x kMaxQt = 32 complex each): then each x row and each g row is
//    transformed exactly once per launch. That holds at every training
//    shape of the slice (fused QKV is 32·8·64 = 16,384 complex, 32 per
//    thread). Where it does not fit, the geometry tiles the side that
//    costs fewer extra transforms (the larger one): with `tiles_p` p tiles
//    every x row is transformed once per p tile, with `tiles_q` q tiles
//    every g row once per q tile. A block is alone on its SM (512 threads at
//    up to 128 registers), so the rows are cut into near-equal ranges
//    (split s takes rows [s·B/splits, (s+1)·B/splits)) until the blocks
//    fill one wave of the 132 SMs and no more: 132 splits of 15–16 rows
//    at 2048 rows. (137 splits of 15 rows, whose last 5 blocks ran as a
//    second wave, took 1.6x as long on an H100.)
//  * Per chunk of `rows` rows (as many as fit the shared-memory budget):
//    stage the x and g rows of the tile as f32 complex pairs in padded rows
//    (16-byte loads where k and the pointer allow; rows and blocks past
//    the edge are never read, and staged blocks past P or Q are zero, so
//    they add exact zeros), run the forward FFT and split step on all of
//    them at once (bc_fft.cuh; the twiddles `fft_twiddles(k)` in shared
//    memory), then accumulate A += Ĝ·conj(X̂) in registers. Thread
//    (slot s, p group, q group) owns pt x qt sums of one slot, in slot
//    order, and takes the rows in order; per row it reads qt X̂ and pt Ĝ
//    values for pt·qt complex products. Slot 0 holds the real pair
//    (bin 0, bin k/2): it takes two real products, (G0·X0, G_{k/2}·X_{k/2}),
//    never a complex product (its loads are rearranged so the same four
//    FMAs compute both, with zeros in place of the cross terms).
//  * bc_dw_partial writes its sums, split by split, to the f32 workspace
//    (splits, P, Q, S) complex that the wrapper allocates. bc_dw_reduce
//    (several (p, q) pairs per block, one thread per (pair, slot)) sums the
//    splits in split order — a fixed order, no atomics, so two launches
//    agree bit for bit — then either writes (g_f/k)·A in natural bin order
//    (freq_out = 1; the imaginary parts at bins 0 and k/2 are 0) or runs
//    the inverse FFT (slot order in, natural order out) with irfft's 1/k.
//  * Any other k (odd, 1, 96, ...) runs the same geometry with dense DFT
//    loops: both x and g through C/S staged in shared memory (K = k/2+1
//    slots in natural order, no packing), then the fold dw = dŵ·Cᵀ + dŵ·Sᵀ
//    per (p, q) in the reduce.
//  * Groups: G independent adjoints of one shape (a MoE layer's experts,
//    the reference's `_bc_dw_kernel` under `jax.vmap`) run as one launch
//    with grid z = G. Block z offsets x and g by its group's stride and
//    then runs the single-adjoint code above unchanged; the workspace is
//    (splits, G, P, Q, S) complex, so bc_dw_reduce sees the G·P·Q pairs of
//    the launch as one flat range and writes dw (G, P, Q·k) or dwr/dwi
//    (G, P, Q, K) with no group logic of its own. The split order stays
//    fixed, so repeat launches agree bit for bit, and G = 1 is the single
//    launch (z = 0, no offset). `_dw_geometry` spreads one wave of blocks
//    over G·tiles·splits: at G >= 132 one split per group.
//
// Later steps: the per-bin products on tensor cores (3xTF32 mma.sync, since
// the f32 tolerance rules out plain TF32); TMA or cp.async to stage the
// next chunk while the current one is transformed; a reduction that keeps
// the partials on chip (thread block clusters) instead of the workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bc_fft.cuh"

namespace {

constexpr int kThreads = 512;           // bc_dw_partial's block
constexpr int kReduceThreads = 256;     // bc_dw_reduce's block
constexpr int kMaxK = 128;              // largest supported block size
constexpr int kMaxPt = 8;               // p blocks per thread
constexpr int kMaxQt = 4;               // q blocks per thread
constexpr int kMaxSmem = 227 * 1024;
// bc_dw_reduce's rows: 256/S rows of at most 2·S complex (padded FFT rows)
constexpr int kReduceBuf = 2 * kReduceThreads;

// Shared-memory layout of bc_dw_partial, in floats, for `rows` batch rows
// of `staged` transformed rows each (the q tile's x blocks, then the p
// tile's g blocks). FFT path (N = k/2 > 0): the padded complex rows,
// transformed in place; the k twiddles. Dense path (N = 0): the transformed
// rows (K complex each); the raw staged rows (k floats each, rounded up to
// 4); the bases C and S (k x K each). `_dw_smem_bytes` in kernel.py mirrors
// it; every launch checks that the two agree.
struct Layout {
  int hat, raw, bs;
  __host__ __device__ Layout(int N, int row, int k, int rows, int staged) {
    const int K = k / 2 + 1;
    const int n = rows * staged;
    if (N > 0) {
      hat = 2 * n * row;
      raw = 0;
      bs = 2 * k;
    } else {
      hat = 2 * n * K;
      raw = (n * k + 3) / 4 * 4;
      bs = 2 * k * K;
    }
  }
  __host__ __device__ int floats() const { return hat + raw + bs; }
};

// Stage `nr` batch rows of one operand's tile: `nb` blocks of k from
// column c0 of each row (leading dimension ld), blocks at or past `nvalid`
// zero, into staged rows r·NS + j0 + block. FFT path: complex n of a block
// = (v[2n], v[2n+1]) at the padded pos(n); dense path: k floats a row.
template <int kN, typename T>
__device__ __forceinline__ void stage(float2* hat, float* raw,
                                      const T* __restrict__ src, long ld,
                                      int r0, int nr, long c0, int nb,
                                      int nvalid, int NS, int j0, int k,
                                      bool vec) {
  using F = Fft<(kN > 0 ? kN : 1)>;
  constexpr int V = 16 / sizeof(T);
  const int seg = nb * k;
  if (vec) {
    const int nv = seg / V;
    for (int e = threadIdx.x; e < nr * nv; e += kThreads) {
      const int r = e / nv, col = (e - r * nv) * V;
      const int blk = col / k, a = col - blk * k;
      float v[V];
      if (blk < nvalid) {
        load_x16(src + (long)(r0 + r) * ld + c0 + col, v);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = 0.f;
      }
      const int row = r * NS + j0 + blk;
      if constexpr (kN > 0) {
        float2* z = hat + row * F::kRow;
#pragma unroll
        for (int i = 0; i < V / 2; ++i)
          z[F::pos(a / 2 + i)] = make_float2(v[2 * i], v[2 * i + 1]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) raw[row * k + a + i] = v[i];
      }
    }
  } else {
    for (int e = threadIdx.x; e < nr * seg; e += kThreads) {
      const int r = e / seg, col = e - r * seg;
      const int blk = col / k, a = col - blk * k;
      const float v =
          blk < nvalid ? load_x(src, (long)(r0 + r) * ld + c0 + col) : 0.f;
      const int row = r * NS + j0 + blk;
      if constexpr (kN > 0) {
        reinterpret_cast<float*>(hat)[2 * (row * F::kRow + F::pos(a / 2)) +
                                      (a & 1)] = v;
      } else {
        raw[row * k + a] = v;
      }
    }
  }
}

// kN = k/2 for power-of-two k (FFT path), 0 for any other k (dense path).
// Grid (tiles_p·tiles_q, splits, G); tile t covers p blocks from
// (t / tiles_q)·PT and q blocks from (t % tiles_q)·QT of group z.
template <typename XT, typename GT, int kN>
__global__ void __launch_bounds__(kThreads, 1)
bc_dw_partial(const XT* __restrict__ x, const GT* __restrict__ g,
              const float2* __restrict__ tw, const float* __restrict__ C,
              const float* __restrict__ Sb, float2* __restrict__ part, int B,
              int P, int Q, int k_rt, int R, int GP, int GQ, int pt, int qt,
              int tiles_q) {
  constexpr bool kFFT = kN > 0;
  using F = Fft<kFFT ? kN : 1>;
  const int k = kFFT ? 2 * kN : k_rt;
  const int K = k / 2 + 1;
  const int S = kFFT ? kN : K;                 // slots per transformed row
  const int RS = kFFT ? F::kRow : K;           // row stride, in complex
  // this block's group: x and g move by its group stride
  const long grp_z = blockIdx.z;
  x += grp_z * B * Q * k;
  g += grp_z * B * P * k;
  const int PT = GP * pt, QT = GQ * qt, NS = QT + PT;
  const int p0 = blockIdx.x / tiles_q * PT, q0 = blockIdx.x % tiles_q * QT;
  const int r_begin = (int)((long)blockIdx.y * B / gridDim.y);
  const int r_end = (int)((long)(blockIdx.y + 1) * B / gridDim.y);
  const int tid = threadIdx.x;

  extern __shared__ float4 smem_raw[];
  const Layout L(kN, F::kRow, k, R, NS);
  float2* hat = reinterpret_cast<float2*>(smem_raw);
  float* raw = reinterpret_cast<float*>(smem_raw) + L.hat;
  float* bs = raw + L.raw;
  float2* tws = reinterpret_cast<float2*>(bs);
  if constexpr (kFFT) {
    for (int e = tid; e < k; e += kThreads) tws[e] = tw[e];
  } else {
    for (int e = tid; e < k * K; e += kThreads) {
      bs[e] = C[e];
      bs[k * K + e] = Sb[e];
    }
  }

  // thread -> (slot s, p group gp, q group gq); its sums are the p blocks
  // gp·pt + i (i < pt) and q blocks gq·qt + j (j < qt) of the tile
  const int s = tid % S, grp = tid / S;
  const bool active = grp < GP * GQ;
  const int gp = active ? grp / GQ : 0, gq = active ? grp % GQ : 0;
  const bool packed = kFFT && s == 0;
  const int spos = kFFT ? F::pos(s) : s;

  float2 acc[kMaxPt][kMaxQt];
#pragma unroll
  for (int i = 0; i < kMaxPt; ++i)
#pragma unroll
    for (int j = 0; j < kMaxQt; ++j) acc[i][j] = make_float2(0.f, 0.f);

  const bool xvec = k % (16 / (int)sizeof(XT)) == 0 &&
                    (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool gvec = k % (16 / (int)sizeof(GT)) == 0 &&
                    (reinterpret_cast<uintptr_t>(g) & 15) == 0;

  for (int r0 = r_begin; r0 < r_end; r0 += R) {
    const int nr = min(R, r_end - r0);
    if (r0 != r_begin) __syncthreads();  // the last chunk's readers are done
    stage<kN>(hat, raw, x, (long)Q * k, r0, nr, (long)q0 * k, QT, Q - q0, NS,
              0, k, xvec);
    stage<kN>(hat, raw, g, (long)P * k, r0, nr, (long)p0 * k, PT, P - p0, NS,
              QT, k, gvec);
    __syncthreads();
    if constexpr (kFFT) {
      fft_rows<kN, false, kThreads>(hat, nr * NS, tws);
      __syncthreads();
      split_rows<kN, false, kThreads>(hat, nr * NS, tws);
    } else {
      // dense rDFT of every staged row through C/S
      for (int e = tid; e < nr * NS * K; e += kThreads) {
        const int row = e / K, f = e - row * K;
        const float* v = raw + row * k;
        float sr = 0.f, si = 0.f;
        for (int a = 0; a < k; ++a) {
          sr = fmaf(v[a], bs[a * K + f], sr);
          si = fmaf(v[a], bs[k * K + a * K + f], si);
        }
        hat[e] = make_float2(sr, si);
      }
    }
    __syncthreads();
    if (active) {
      // A += Ĝ·conj(X̂): re += Gr·Xr + Gi·Xi, im += Gi·Xr − Gr·Xi. The
      // packed slot's loads become xb = 0 and xc = Xi, so the same FMAs
      // give (Gr·Xr, Gi·Xi) exactly. Loads past pt or qt re-read the last
      // block and are not accumulated, so they issue without branches.
      for (int r = 0; r < nr; ++r) {
        const float2* xr = hat + (r * NS + gq * qt) * RS + spos;
        const float2* gr = hat + (r * NS + QT + gp * pt) * RS + spos;
        float xa[kMaxQt], xb[kMaxQt], xc[kMaxQt];
#pragma unroll
        for (int j = 0; j < kMaxQt; ++j) {
          const float2 v = xr[min(j, qt - 1) * RS];
          xa[j] = v.x;
          xb[j] = packed ? 0.f : v.y;
          xc[j] = packed ? v.y : v.x;
        }
#pragma unroll
        for (int i = 0; i < kMaxPt; ++i) {
          const float2 gv = gr[min(i, pt - 1) * RS];
          if (i < pt) {
#pragma unroll
            for (int j = 0; j < kMaxQt; ++j) {
              if (j < qt) {
                acc[i][j].x = fmaf(gv.x, xa[j], fmaf(gv.y, xb[j], acc[i][j].x));
                acc[i][j].y =
                    fmaf(gv.y, xc[j], fmaf(-gv.x, xb[j], acc[i][j].y));
              }
            }
          }
        }
      }
    }
  }

  if (active) {
    // workspace (splits, G, P, Q, S): split y's plane of group z
    float2* out =
        part + ((long)blockIdx.y * gridDim.z + grp_z) * P * Q * S + s;
#pragma unroll
    for (int i = 0; i < kMaxPt; ++i) {
#pragma unroll
      for (int j = 0; j < kMaxQt; ++j) {
        const int p = p0 + gp * pt + i, q = q0 + gq * qt + j;
        if (i < pt && j < qt && p < P && q < Q)
          out[((long)p * Q + q) * S] = acc[i][j];
      }
    }
  }
}

// Sum of the partials in split order, then the epilogue. A block takes
// 256/S (p, q) pairs, one thread per (pair, slot); a grouped launch's
// G·P·Q pairs are one flat range (PQ), group-major as the outputs are.
template <int kN>
__global__ void __launch_bounds__(kReduceThreads)
bc_dw_reduce(const float2* __restrict__ part, const float2* __restrict__ tw,
             const float* __restrict__ C, const float* __restrict__ Sb,
             float* __restrict__ out0, float* __restrict__ out1, int PQ,
             int k_rt, int splits, int freq_out) {
  constexpr bool kFFT = kN > 0;
  using F = Fft<kFFT ? kN : 1>;
  const int k = kFFT ? 2 * kN : k_rt;
  const int K = k / 2 + 1;
  const int S = kFFT ? kN : K;
  const int RB = kReduceThreads / S;           // pairs per block
  const int tid = threadIdx.x, rr = tid / S, s = tid - rr * S;
  const long pq = (long)blockIdx.x * RB + rr;
  const bool mine = rr < RB && pq < PQ;
  __shared__ float2 buf[kReduceBuf];
  __shared__ float2 tws[kMaxK];

  float2 a = make_float2(0.f, 0.f);
  if (mine) {
    const float2* src = part + pq * S + s;
    const long plane = (long)PQ * S;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) {
      const float2 v = src[sp * plane];
      a.x += v.x;
      a.y += v.y;
    }
  }
  const float inv_k = 1.f / (float)k;
  // g_f / k of the slot's bin (dense path); FFT path: 2/k off slot 0
  const float sc = (s == 0 || 2 * s == k ? 1.f : 2.f) * inv_k;

  if (freq_out) {                              // uniform across the block
    if (!mine) return;
    float* dr = out0 + pq * K;
    float* di = out1 + pq * K;
    if (kFFT && s == 0) {                      // (bin 0, bin k/2), real
      dr[0] = a.x * inv_k;
      di[0] = 0.f;
      dr[kN] = a.y * inv_k;
      di[kN] = 0.f;
    } else {
      const int f = kFFT ? F::bin(s) : s;
      dr[f] = a.x * sc;
      di[f] = a.y * sc;
    }
    return;
  }

  if constexpr (kFFT) {
    // irfft(A) = inverse FFT / k: slot order in, natural order out
    for (int e = tid; e < k; e += kReduceThreads) tws[e] = tw[e];
    if (rr < RB) buf[rr * F::kRow + F::pos(s)] = a;   // zero past PQ
    __syncthreads();
    split_rows<kN, true, kReduceThreads>(buf, RB, tws);
    __syncthreads();
    fft_rows<kN, true, kReduceThreads>(buf, RB, tws);
    __syncthreads();
    float2* dw = reinterpret_cast<float2*>(out0);
    for (int e = tid; e < RB * kN; e += kReduceThreads) {
      const int row = e / kN, n = e % kN;
      const long o = (long)blockIdx.x * RB + row;
      if (o >= PQ) continue;
      const float2 z = buf[row * F::kRow + F::pos(n)];
      dw[o * kN + n] = make_float2(z.x * inv_k, z.y * inv_k);
    }
  } else {
    // dŵ = (g_f/k)·A, folded: dw[a] = Σ_f dwr[f]·C[a, f] + dwi[f]·S[a, f]
    if (rr < RB) buf[rr * K + s] = make_float2(a.x * sc, a.y * sc);
    __syncthreads();
    for (int e = tid; e < RB * k; e += kReduceThreads) {
      const int row = e / k, i = e - row * k;
      const long o = (long)blockIdx.x * RB + row;
      if (o >= PQ) continue;
      const float2* d = buf + row * K;
      float v = 0.f;
      for (int f = 0; f < K; ++f) {
        v = fmaf(d[f].x, C[i * K + f], v);
        v = fmaf(d[f].y, Sb[i * K + f], v);
      }
      out0[o * k + i] = v;
    }
  }
}

template <typename XT, typename GT, int kN>
int launch(const void* x, const void* g, const void* tw, const void* C,
           const void* Sb, void* part, void* out0, void* out1, int B, int P,
           int Q, int k, int G, int freq_out, int R, int GP, int GQ, int pt,
           int qt, int splits, int smem, cudaStream_t stream) {
  // the caller's size (`_dw_smem_bytes`) must be this layout's, so the
  // geometry was chosen on the bytes the kernel really takes
  const Layout L(kN, Fft<(kN > 0 ? kN : 1)>::kRow, k, R, GP * pt + GQ * qt);
  if (smem != 4L * L.floats() || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  // the limit is held per device: set it on every launch (to the most any
  // geometry takes, so threads launching other sizes never lower it under
  // one another)
  const cudaError_t e = cudaFuncSetAttribute(
      bc_dw_partial<XT, GT, kN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_p = (P + GP * pt - 1) / (GP * pt);
  const int tiles_q = (Q + GQ * qt - 1) / (GQ * qt);
  bc_dw_partial<XT, GT, kN><<<dim3(tiles_p * tiles_q, splits, G), kThreads,
                              smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const GT*>(g),
      static_cast<const float2*>(tw), static_cast<const float*>(C),
      static_cast<const float*>(Sb), static_cast<float2*>(part), B, P, Q, k,
      R, GP, GQ, pt, qt, tiles_q);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return (int)e1;
  const int S = kN > 0 ? kN : k / 2 + 1;
  const int rb = kReduceThreads / S;
  const long PQ = (long)G * P * Q;
  bc_dw_reduce<kN><<<(int)((PQ + rb - 1) / rb), kReduceThreads, 0, stream>>>(
      static_cast<const float2*>(part), static_cast<const float2*>(tw),
      static_cast<const float*>(C), static_cast<const float*>(Sb),
      static_cast<float*>(out0), static_cast<float*>(out1), (int)PQ, k,
      splits, freq_out);
  return (int)cudaGetLastError();
}

// the instantiation for block size k: the FFT length for a power of two,
// else the dense path
template <typename XT, typename GT>
int launch_k(const void* x, const void* g, const void* tw, const void* C,
             const void* Sb, void* part, void* out0, void* out1, int B, int P,
             int Q, int k, int G, int freq_out, int R, int GP, int GQ, int pt,
             int qt, int splits, int smem, cudaStream_t s) {
#define BC_LAUNCH(N)                                                        \
  launch<XT, GT, N>(x, g, tw, C, Sb, part, out0, out1, B, P, Q, k, G,      \
                    freq_out, R, GP, GQ, pt, qt, splits, smem, s)
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

// Plain C entry point for ctypes. `groups` G >= 1 adjoints of one shape
// run as one launch: x (G, B, Q·k) and g (G, B, P·k), each contiguous and
// bf16 when x_bf16 / g_bf16 (else f32); G = 1 is one adjoint. Power-of-two
// k >= 2 takes the FFT path and
// needs `tw` (k complex twiddles, `fft_twiddles`); any other k takes the
// dense path and needs the bases C, S (k, K). `part` is an f32 workspace of
// splits·G·P·Q·S complex (S = k/2 on the FFT path, K = k/2+1 on the dense
// path). The geometry (rows per chunk, p and q groups, p and q
// blocks per thread, splits; split s takes rows [s·B/splits,
// (s+1)·B/splits)) and the partial kernel's
// dynamic shared memory in bytes (which must equal `Layout`'s) come from
// `_dw_geometry`. freq_out: out0/out1 are dwr/dwi (G, P, Q, K) f32; else
// out0 is dw (G, P, Q·k) f32 and out1 must be null. Returns the first CUDA
// error of the two launches (0 on success).
extern "C" int bc_dw_launch(const void* x, const void* g, const void* tw,
                            const void* C, const void* S, void* part,
                            void* out0, void* out1, int B, int P, int Q, int k,
                            int groups, int x_bf16, int g_bf16, int freq_out,
                            int rows, int p_groups, int q_groups,
                            int p_per_thread, int q_per_thread, int splits,
                            int smem_bytes, void* stream) {
  const bool fft = k >= 2 && (k & (k - 1)) == 0;
  const int slots = fft ? k / 2 : k / 2 + 1;
  if (B < 1 || P < 1 || Q < 1 || k < 1 || k > kMaxK || groups < 1 ||
      groups > 65535 || (long)groups * P * Q > 0x7fffffffL || rows < 1 ||
      p_groups < 1 || q_groups < 1 ||
      (long)p_groups * q_groups * slots > kThreads || p_per_thread < 1 ||
      p_per_thread > kMaxPt || q_per_thread < 1 || q_per_thread > kMaxQt ||
      splits < 1 || splits > 65535 || splits > B ||
      (fft ? tw == nullptr : (C == nullptr || S == nullptr)) ||
      part == nullptr || (freq_out != 0) != (out1 != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BC_DW_ARGS                                                          \
  x, g, tw, C, S, part, out0, out1, B, P, Q, k, groups, freq_out, rows,    \
      p_groups, q_groups, p_per_thread, q_per_thread, splits, smem_bytes, s
  if (x_bf16) {
    return g_bf16 ? launch_k<__nv_bfloat16, __nv_bfloat16>(BC_DW_ARGS)
                  : launch_k<__nv_bfloat16, float>(BC_DW_ARGS);
  }
  return g_bf16 ? launch_k<float, __nv_bfloat16>(BC_DW_ARGS)
                : launch_k<float, float>(BC_DW_ARGS);
#undef BC_DW_ARGS
}
