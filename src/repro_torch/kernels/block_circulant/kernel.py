"""Block-circulant kernels: the CUDA launches and their plain versions.

``bc_matmul`` computes ``y = act(iDFT(Σ_q DFT(x_q)·ŵ_pq) + bias)`` for x
``(B, q·k)`` and frozen frequency tables ``wr, wi (p, q, K = k//2+1)`` —
the function of the reference's Pallas TPU kernel ``_bc_kernel``
(``repro/kernels/block_circulant/kernel.py``). ``bc_dw`` computes the
weight adjoint ``dŵ[p,q,f] = Σ_b ĝ[b,p,f]·conj(x̂[b,q,f])`` of the
reference's ``_bc_dw_kernel``, folded back to the time domain or as the raw
frequency pair. Both take a leading group axis (G products or adjoints of
one shape in one launch: a MoE layer's experts, the reference's kernels
under ``jax.vmap``). On a CUDA tensor each launches its hand-written kernel
(``csrc/bc_matmul.cu``, ``csrc/bc_dw.cu``; the note in each source says
what bounds it on the H100 and how it is laid out); on a CPU tensor each
runs its plain version (:func:`bc_matmul_plain`, :func:`bc_dw_plain`), the
same DFT-as-matmul math in plain PyTorch. There is no fallback between the
two: a CUDA tensor a kernel cannot take raises.

Each kernel's launch geometry comes from the shapes alone.
``bc_matmul``'s (:func:`_mm_geometry`): rows per block, output blocks per
block, the q chunk held in shared memory and the split of the q sum among
a block's threads; a grouped launch (a leading axis of G products of one
shape, a MoE layer's experts) runs G copies of that geometry, one per grid
z index. ``bc_dw``'s (:func:`_dw_geometry`): the (p, q) tile of
a block and its threads, the row splits across blocks and the rows staged
per chunk; a grouped launch runs that geometry once per grid z index, with
one wave of blocks spread over groups, tiles and splits. For a power-of-two
k both kernels transform with the four-step real FFT of ``csrc/bc_fft.cuh``
in shared memory, whose twiddles come from :func:`fft_twiddles`; any other
k runs dense DFT loops over ``dft_bases`` staged in shared memory.

:func:`build` compiles every ``csrc/*.cu`` with ``nvcc`` for ``sm_90a``
(one process per source, all started together) into the ``build/``
directory beside this file, keyed by the hash of each source and the
headers beside it (:func:`_source_key`); the libraries are bound with
``ctypes`` at first use. ``LAUNCHES`` counts kernel launches per wrapper.

Both wrappers call registered ``torch.library`` ops (``OPS``:
``repro_torch::bc_matmul``, ``repro_torch::bc_dw`` and
``repro_torch::bc_dw_freq``, the last returning ``(dwr, dwi)``), so
PyTorch's dispatcher, its dispatch modes and its fake tensors see every
launch as one op: the CPU impl is the plain version, the CUDA impl the
ctypes launch, and a fake impl gives the output shapes and dtypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.circulant import dft_bases, dft_bases_adjoint
from repro_torch.core.quant import dequantize_symmetric

__all__ = ["ACTIVATIONS", "apply_activation", "bc_dw", "bc_dw_plain",
           "bc_matmul", "bc_matmul_plain", "build", "fft_twiddles",
           "LAUNCHES", "OPS", "SOURCES"]

# Epilogue activations fused into the writeback. Keys are the only legal
# ``activation=`` values; the index is the kernel's activation code.
ACTIVATIONS = ("none", "relu", "tanh", "sigmoid", "gelu")

# kernel name -> CUDA source; each builds into its own library
SOURCES = {p.stem: p for p in sorted(
    Path(__file__).with_name("csrc").glob("*.cu"))}
_BUILD_DIR = Path(__file__).with_name("build")
_MAX_K = 128   # kMaxK in both sources; the C entry points reject larger k
# bc_matmul.cu: threads per block, most rows per block (kMaxRows) and most
# output blocks per thread per pass (kMaxJ)
_MM_THREADS = 256
_MM_MAX_ROWS = 8
_MM_MAX_J = 2
# bc_matmul spreads output blocks across blocks until at least this many
# are in flight (one per SM of the H100's 132), and no further
_MM_MIN_BLOCKS = 132
# shared memory a bc_matmul block may take, so two fit on one SM (228 KB,
# 1 KB of it reserved per block)
_MM_SMEM_BUDGET = 110 * 1024
# bc_dw.cu: threads of a bc_dw_partial block, most p and q blocks a thread
# sums (kMaxPt, kMaxQt)
_DW_THREADS = 512
_DW_MAX_PT = 8
_DW_MAX_QT = 4
# bc_dw cuts the rows into near-equal splits until its blocks fill one wave
# of the H100's 132 SMs (a bc_dw_partial block is alone on its SM), each
# split at least _DW_MIN_ROWS rows where B allows
_DW_WAVE = 132
_DW_MIN_ROWS = 8
# shared memory a bc_dw_partial block may take: 512 threads at up to 128
# registers fill an SM's register file, so the block is alone on its SM
_DW_SMEM_BUDGET = 227 * 1024

# Kernel launches per wrapper since the last reset (chip_smoke reads and
# resets them).
LAUNCHES = {"bc_matmul": 0, "bc_dw": 0}


def apply_activation(z: torch.Tensor, activation: str) -> torch.Tensor:
    """Elementwise epilogue. ``gelu`` is the tanh approximation, as the
    reference's ``jax.nn.gelu`` default."""
    if activation == "none":
        return z
    if activation == "relu":
        return torch.clamp_min(z, 0.0)
    if activation == "tanh":
        return torch.tanh(z)
    if activation == "sigmoid":
        return torch.sigmoid(z)
    if activation == "gelu":
        return torch.nn.functional.gelu(z, approximate="tanh")
    raise ValueError(f"unknown activation {activation!r}; one of {ACTIVATIONS}")


def bc_matmul_plain(x2d: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    w_scale: Optional[torch.Tensor] = None, *, k: int,
                    activation: str = "none") -> torch.Tensor:
    """Plain PyTorch version of the kernel: rDFT of x as a matmul with
    C/S, per-bin complex GEMM over q in f32, inverse through Ci/Si, bias,
    activation, cast to x's dtype. int8 tables (``w_scale``) dequantize
    with :func:`dequantize_symmetric` first. Grouped (4-D tables ``(G, p,
    q, K)``, x ``(G, B, q·k)``, scales ``(G, p, q)``, bias ``(G, p·k)``):
    one call per group, stacked."""
    if wr.dim() == 4:
        def pick(t, g):
            return None if t is None else t[g]

        return torch.stack([
            bc_matmul_plain(x2d[g], wr[g], wi[g], pick(bias, g),
                            pick(w_scale, g), k=k, activation=activation)
            for g in range(wr.shape[0])])
    B = x2d.shape[0]
    p, q, K = wr.shape
    C, S, Ci, Si = dft_bases(k, device=x2d.device)
    if w_scale is not None:
        wr = dequantize_symmetric(wr, w_scale)
        wi = dequantize_symmetric(wi, w_scale)
    xb = x2d.float().reshape(B * q, k)
    xr = (xb @ C).reshape(B, q, K).permute(2, 0, 1)          # (K, B, q)
    xi = (xb @ S).reshape(B, q, K).permute(2, 0, 1)
    wrf = wr.float().permute(2, 1, 0)                        # (K, q, p)
    wif = wi.float().permute(2, 1, 0)
    yr = (xr @ wrf - xi @ wif).permute(1, 2, 0).reshape(B * p, K)
    yi = (xr @ wif + xi @ wrf).permute(1, 2, 0).reshape(B * p, K)
    y = (yr @ Ci + yi @ Si).reshape(B, p * k)
    if bias is not None:
        y = y + bias.float().reshape(1, -1)
    return apply_activation(y, activation).to(x2d.dtype)


def bc_dw_plain(x2d: torch.Tensor, g2d: torch.Tensor, *, P: int, Q: int,
                k: int, freq_out: bool = False):
    """Plain PyTorch version of the weight-adjoint kernel: x through C/S,
    g through Ciᵀ/Siᵀ, the per-bin complex GEMM with the rows contracted,
    all in f32; then the fold ``dw = dwr@Cᵀ + dwi@Sᵀ`` to (P, Q·k), or the
    raw (dwr, dwi) pair (P, Q, K) when ``freq_out``. Grouped (x (G, B,
    Q·k), g (G, B, P·k)): one call per group, stacked to (G, P, Q·k) or
    (G, P, Q, K)."""
    if x2d.dim() == 3:
        outs = [bc_dw_plain(x2d[i], g2d[i], P=P, Q=Q, k=k, freq_out=freq_out)
                for i in range(x2d.shape[0])]
        if freq_out:
            return tuple(torch.stack(t) for t in zip(*outs))
        return torch.stack(outs)
    B = x2d.shape[0]
    K = k // 2 + 1
    C, S, CiT, SiT, CT, ST = dft_bases_adjoint(k, device=x2d.device)
    xb = x2d.float().reshape(B * Q, k)
    xr = (xb @ C).reshape(B, Q, K).permute(2, 0, 1)          # (K, B, Q)
    xi = (xb @ S).reshape(B, Q, K).permute(2, 0, 1)
    gb = g2d.float().reshape(B * P, k)
    gr = (gb @ CiT).reshape(B, P, K).permute(2, 1, 0)        # (K, P, B)
    gi = (gb @ SiT).reshape(B, P, K).permute(2, 1, 0)
    dwr = (gr @ xr + gi @ xi).permute(1, 2, 0)               # (P, Q, K)
    dwi = (gi @ xr - gr @ xi).permute(1, 2, 0)
    if freq_out:
        return dwr.contiguous(), dwi.contiguous()
    return (dwr.reshape(P * Q, K) @ CT
            + dwi.reshape(P * Q, K) @ ST).reshape(P, Q * k)


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def _source_key(src: Path) -> str:
    """Build key of one kernel source: the hash of the source and of every
    header beside it (``*.cuh``), so an edit to a shared header rebuilds
    every library."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def build() -> Dict[str, Tuple[Path, str]]:
    """Compile every ``csrc/*.cu`` for ``sm_90a`` into ``build/`` unless a
    library for that exact source and headers already exists, one ``nvcc``
    per source, all started together. Returns ``{name: (library path,
    compiler output)}``; the output (ptxas resource usage) is empty for a
    library that was already built."""
    libs = {name: _BUILD_DIR / f"{name}-{_source_key(src)}.so"
            for name, src in SOURCES.items()}
    out = {name: (lib, "") for name, lib in libs.items() if lib.exists()}
    todo = [name for name in libs if name not in out]
    if not todo:
        return out
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the block-circulant kernels")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = libs[name].with_name(f"{libs[name].name}.{os.getpid()}.tmp")
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"),
               "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name].name} "
                          f"({proc.returncode}):\n{log}")
            continue
        # atomic: concurrent builds race harmlessly
        os.replace(tmp, libs[name])
        out[name] = (libs[name], log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


# ctypes signatures of the C entry points: (pointer args, int args); every
# entry point takes the stream last and returns a CUDA error code
_ENTRY_POINTS = {
    "bc_matmul": ("bc_matmul_forward", 11, 15),
    "bc_dw": ("bc_dw_launch", 8, 15),
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The bound C entry point of kernel ``name`` (built on first use)."""
    fn_name, n_ptr, n_int = _ENTRY_POINTS[name]
    fn = getattr(ctypes.CDLL(str(build()[name][0])), fn_name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _mm_fft(k: int) -> bool:
    """Whether bc_matmul transforms by real FFT (k a power of two >= 2)
    rather than by dense DFT loops."""
    return 2 <= k <= _MAX_K and k & (k - 1) == 0


@functools.lru_cache(maxsize=64)
def fft_twiddles(k: int, device="cpu") -> torch.Tensor:
    """Twiddles of bc_matmul's FFT path: ``(k, 2)`` f32 rows
    ``(cos, -sin)(2πj/k)`` = e^{-2πij/k} for j < k, built in float64. The
    real-FFT split step uses rows j < k/2, the k/2-point FFT's inner
    twiddles the even rows. Cached per (k, device); callers never write
    to it."""
    ang = 2.0 * np.pi * np.arange(k) / k
    tw = np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(tw).to(device).contiguous()


def _fft_split(N: int) -> Tuple[int, int]:
    """(N1, N2) of the kernel's four-step N-point FFT (``Fft<N>`` in
    bc_matmul.cu): N1-point DFTs over stride-N2 elements, then N2-point
    DFTs; N <= 8 in one step."""
    n1 = 8 if N >= 32 else 4 if N == 16 else N
    return n1, N // n1


def _fft_row(N: int) -> int:
    """Padded shared-memory row of an N-point FFT, in complex: one pad
    after every N2 slots (after the row when N2 = 1)."""
    n2 = _fft_split(N)[1]
    return N + N // (n2 if n2 > 1 else N)


class MMGeometry(NamedTuple):
    """Launch geometry of one bc_matmul call (see :func:`_mm_geometry`)."""
    fft: bool          # real-FFT transforms (else dense DFT loops)
    slots: int         # frequency slots per transformed row
    rows: int          # batch rows per block
    p_group: int       # output blocks per block
    q_chunk: int       # input blocks staged in shared memory at once
    q_groups: int      # thread groups that split a block's q sum
    p_inner: int       # thread groups over output blocks
    p_per_thread: int  # output blocks per thread per pass
    grid: Tuple[int, int]
    smem_bytes: int

    @property
    def p_pass(self) -> int:
        """Output blocks one pass over the q sum produces."""
        return self.p_inner * self.p_per_thread


def _mm_smem_bytes(k: int, rows: int, q_chunk: int, q_groups: int,
                   p_pass: int) -> int:
    """Dynamic shared memory of a bc_matmul block in bytes, in the source's
    layout (``Layout`` in bc_matmul.cu, which rejects a launch whose size
    differs from its own). FFT path: the staged x chunk (transformed in
    place) and the q-group partials in padded rows, then the twiddles.
    Dense path: the x chunk, the partials, the x̂ chunk, the staged bases.
    Both: the table tile of a pass and chunk and its scales."""
    K = k // 2 + 1
    if _mm_fft(k):
        row = _fft_row(k // 2)
        floats = (2 * rows * q_chunk * row
                  + 2 * q_groups * rows * p_pass * row + 2 * k)
    else:
        floats = (-(-rows * q_chunk * k // 4) * 4
                  + 2 * q_groups * rows * p_pass * K + 2 * rows * q_chunk * K
                  + 2 * k * K)
    return 4 * (floats + 2 * p_pass * q_chunk * K + p_pass * q_chunk)


@functools.lru_cache(maxsize=1024)
def _mm_geometry(B: int, P: int, Q: int, k: int) -> MMGeometry:
    """bc_matmul's launch geometry, from the shapes alone (so a launch is
    reproducible). Blocks of ``rows`` batch rows and ``p_group`` output
    blocks; each block transforms its x rows once, so the fewer columns of
    blocks, the fewer transforms. Output blocks are spread across columns
    only until ``_MM_MIN_BLOCKS`` blocks are in flight: a decode launch
    (B <= 8) runs one block per output block, a launch at B = 2048 one
    column. A block's threads take (bin, output block, q group): where a
    block holds fewer output blocks than its threads have groups, the
    groups split the q sum and add their partials in a fixed order; where
    it holds more, it makes several passes. The q range is cut into the
    fewest equal chunks that fit ``_MM_SMEM_BUDGET``."""
    fft = _mm_fft(k)
    slots = k // 2 if fft else k // 2 + 1
    groups = _MM_THREADS // slots
    rows = min(_MM_MAX_ROWS, B)
    tiles = -(-B // rows)
    n_pg = min(P, -(-_MM_MIN_BLOCKS // tiles))
    while True:
        p_group = -(-P // n_pg)
        p_inner = min(groups, p_group)
        q_groups = groups // p_inner
        p_inner = groups // q_groups
        p_per_thread = min(_MM_MAX_J, -(-p_group // p_inner))
        p_pass = p_inner * p_per_thread
        p_group = -(-p_group // p_pass) * p_pass  # whole passes per block
        cols = -(-P // p_group)
        if tiles * cols >= _MM_MIN_BLOCKS or n_pg >= P:
            break
        n_pg += 1
    fixed = _mm_smem_bytes(k, rows, 0, q_groups, p_pass)
    per_q = _mm_smem_bytes(k, rows, 1, q_groups, p_pass) - fixed
    fit = max(1, min(Q, (_MM_SMEM_BUDGET - fixed) // per_q))
    q_chunk = -(-Q // -(-Q // fit))            # equal chunks
    return MMGeometry(fft, slots, rows, p_group, q_chunk, q_groups, p_inner,
                      p_per_thread, (tiles, cols),
                      _mm_smem_bytes(k, rows, q_chunk, q_groups, p_pass))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_on(device: torch.device, launch, *args) -> int:
    """Call the C entry point ``launch`` on ``device``'s current stream
    (every entry point takes the stream last), with ``device`` the current
    device for the call. The raw stream handle and the device switch only
    when needed cost less host time per launch than ``torch.cuda.device``
    and a ``Stream`` object."""
    idx = device.index
    prev = torch._C._cuda_getDevice()
    if prev != idx:
        torch._C._cuda_setDevice(idx)
    try:
        return launch(*args, torch._C._cuda_getCurrentRawStream(idx))
    finally:
        if prev != idx:
            torch._C._cuda_setDevice(prev)


# most groups of one launch: the grid's z dimension
_MAX_GROUPS = 65535


def _check_cuda_args(x2d, wr, wi, bias, w_scale, k):
    """Shapes, types, devices and layout of a launch; returns its group
    count G (1 for 2-D x and 3-D tables; the leading axis of 3-D x and
    4-D tables)."""
    grouped = wr.dim() == 4
    lead = wr.shape[:1] if grouped else ()
    if x2d.dim() != 2 + grouped or x2d.dtype not in (torch.float32,
                                                     torch.bfloat16):
        raise ValueError(f"x must be {2 + grouped}-D f32 or bf16, got "
                         f"{tuple(x2d.shape)} {x2d.dtype}")
    if (wr.dim() not in (3, 4) or wr.shape != wi.shape
            or wr.dtype != wi.dtype):
        raise ValueError(f"wr/wi must share one (p, q, K) or (G, p, q, K) "
                         f"shape and dtype, got {tuple(wr.shape)} {wr.dtype} "
                         f"/ {tuple(wi.shape)} {wi.dtype}")
    p, q, K = wr.shape[-3:]
    G = wr.shape[0] if grouped else 1
    if not 1 <= G <= _MAX_GROUPS or x2d.shape[:-2] != lead:
        raise ValueError(f"groups: x {tuple(x2d.shape)} against tables "
                         f"{tuple(wr.shape)}; the kernel takes 1 <= G <= "
                         f"{_MAX_GROUPS} groups, one per table")
    if not 1 <= k <= _MAX_K or K != k // 2 + 1:
        raise ValueError(f"block size k={k} with K={K}: the kernel takes "
                         f"1 <= k <= {_MAX_K} and K = k//2+1")
    if x2d.shape[-1] != q * k:
        raise ValueError(f"x width {x2d.shape[-1]} != q*k = {q * k}")
    if wr.dtype == torch.int8:
        if w_scale is None or w_scale.shape != lead + (p, q) \
                or w_scale.dtype != torch.float32:
            raise ValueError(f"int8 tables need a {lead + (p, q)} f32 "
                             f"w_scale")
    elif wr.dtype != torch.float32 or w_scale is not None:
        raise ValueError(f"tables must be f32 (no w_scale) or int8 "
                         f"(with w_scale), got {wr.dtype}")
    if bias is not None and (bias.shape != lead + (p * k,)
                             or bias.dtype != torch.float32):
        raise ValueError(f"bias must be {lead + (p * k,)} f32, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    for name, t in (("x", x2d), ("wr", wr), ("wi", wi), ("bias", bias),
                    ("w_scale", w_scale)):
        if t is None:
            continue
        if t.device != x2d.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2d.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return G


def bc_matmul(x2d: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              w_scale: Optional[torch.Tensor] = None, *, k: int,
              activation: str = "none") -> torch.Tensor:
    """x (B, q·k) × frozen tables (p, q, K)·2 -> y (B, p·k) in x's dtype.

    ``bias`` (p·k,) f32 and ``activation`` run in the kernel's epilogue;
    ``w_scale`` (p, q) f32 marks wr/wi as int8 tables dequantized in the
    kernel. Grouped: x (G, B, q·k), tables (G, p, q, K), ``w_scale`` (G, p,
    q), ``bias`` (G, p·k) -> y (G, B, p·k), G products in ONE launch (the
    reference's ``_bc_kernel`` under ``jax.vmap``). The call is the
    registered op ``repro_torch::bc_matmul``: CPU tensors take
    :func:`bc_matmul_plain`, CUDA tensors launch the kernel on the current
    stream or raise, meta tensors take the fake implementation.
    """
    if activation not in ACTIVATIONS:
        raise ValueError(
            f"unknown activation {activation!r}; one of {ACTIVATIONS}")
    return OPS["bc_matmul"](x2d, wr, wi, bias, w_scale, k, activation)


def _bc_matmul_cpu(x2d, wr, wi, bias, w_scale, k, activation):
    return bc_matmul_plain(x2d, wr, wi, bias, w_scale, k=k,
                           activation=activation)


def _bc_matmul_cuda(x2d, wr, wi, bias, w_scale, k, activation):
    """The CUDA impl of ``repro_torch::bc_matmul``: the kernel launch."""
    G = _check_cuda_args(x2d, wr, wi, bias, w_scale, k)
    B = x2d.shape[-2]
    p, q, _ = wr.shape[-3:]
    y = torch.empty(x2d.shape[:-1] + (p * k,), dtype=x2d.dtype,
                    device=x2d.device)
    if B == 0:
        return y
    launch = _entry("bc_matmul")
    g = _mm_geometry(B, p, q, k)
    tw, bases = ((fft_twiddles(k, device=x2d.device), (None,) * 4) if g.fft
                 else (None, dft_bases(k, device=x2d.device)))
    rc = _launch_on(
        x2d.device, launch,
        _ptr(x2d), _ptr(wr), _ptr(wi), _ptr(w_scale), _ptr(bias),
        _ptr(tw), *map(_ptr, bases), _ptr(y), B, p, q, k, G,
        int(x2d.dtype == torch.bfloat16), int(wr.dtype == torch.int8),
        ACTIVATIONS.index(activation), g.rows, g.p_group, g.q_chunk,
        g.q_groups, g.p_inner, g.p_per_thread, g.smem_bytes)
    if rc != 0:
        raise RuntimeError(f"bc_matmul kernel launch failed: CUDA error {rc}")
    LAUNCHES["bc_matmul"] += 1
    return y


def _bc_matmul_fake(x2d, wr, wi, bias, w_scale, k, activation):
    """Output shape and dtype of ``repro_torch::bc_matmul``."""
    if activation not in ACTIVATIONS:
        raise ValueError(
            f"unknown activation {activation!r}; one of {ACTIVATIONS}")
    if wr.dim() not in (3, 4) or x2d.dim() != wr.dim() - 1:
        raise ValueError(f"x {tuple(x2d.shape)} against tables "
                         f"{tuple(wr.shape)}: x is 2-D with 3-D tables, "
                         f"3-D with 4-D (grouped) tables")
    return x2d.new_empty(x2d.shape[:-1] + (wr.shape[-3] * k,))


class DWGeometry(NamedTuple):
    """Launch geometry of one bc_dw call (see :func:`_dw_geometry`)."""
    fft: bool            # real-FFT transforms (else dense DFT loops)
    slots: int           # frequency slots per transformed row
    rows: int            # batch rows staged and transformed per chunk
    p_groups: int        # thread groups over a tile's p blocks
    q_groups: int        # thread groups over a tile's q blocks
    p_per_thread: int    # p blocks a thread sums
    q_per_thread: int    # q blocks a thread sums
    tiles: Tuple[int, int]   # (p tiles, q tiles)
    splits: int          # row ranges [s·B/splits, (s+1)·B/splits)
    rows_per_split: int  # the most rows a split takes
    smem_bytes: int
    groups: int          # grid z: one adjoint per group

    @property
    def p_tile(self) -> int:
        return self.p_groups * self.p_per_thread

    @property
    def q_tile(self) -> int:
        return self.q_groups * self.q_per_thread

    @property
    def grid(self) -> Tuple[int, int, int]:
        return self.tiles[0] * self.tiles[1], self.splits, self.groups


def _dw_smem_bytes(k: int, rows: int, staged: int) -> int:
    """Dynamic shared memory of a bc_dw_partial block in bytes, for
    ``rows`` batch rows of ``staged`` transformed rows each (the q tile's x
    blocks and the p tile's g blocks), in the source's layout (``Layout``
    in bc_dw.cu, which rejects a launch whose size differs from its own).
    FFT path: the padded complex rows, then the twiddles. Dense path: the
    transformed rows, the raw rows (rounded up to 4 floats), the bases C
    and S."""
    K = k // 2 + 1
    n = rows * staged
    if _mm_fft(k):
        floats = 2 * n * _fft_row(k // 2) + 2 * k
    else:
        floats = 2 * n * K + -(-n * k // 4) * 4 + 2 * k * K
    return 4 * floats


@functools.lru_cache(maxsize=1024)
def _dw_geometry(B: int, P: int, Q: int, k: int, G: int = 1) -> DWGeometry:
    """bc_dw's launch geometry, from the shapes alone (so a launch is
    reproducible). A block's threads take (slot, p group, q group) and each
    sums up to ``_DW_MAX_PT`` x ``_DW_MAX_QT`` (p, q) blocks of one slot,
    so a block holds at most ``_DW_THREADS`` // slots groups. The groups
    are chosen for the fewest (p, q) tiles, then the fewest transforms
    (each x row is transformed once per p tile, each g row once per q
    tile), then the fewest sums and loads per thread: where all of P and Q
    fit, one tile, and every row is transformed once per launch. The rows
    are then cut into ``splits`` near-equal ranges, as many as fill one
    wave of ``_DW_WAVE`` blocks over the G groups' tiles (at least
    ``_DW_MIN_ROWS`` rows a range where B allows; one range per group once
    G·tiles fill the wave), and each range into the fewest equal chunks
    whose staged rows fit ``_DW_SMEM_BUDGET``. A group's geometry is the
    single adjoint's but for the splits."""
    fft = _mm_fft(k)
    slots = k // 2 if fft else k // 2 + 1
    groups = _DW_THREADS // slots
    best = None
    for gp in range(1, min(groups, P) + 1):
        for gq in range(1, min(groups // gp, Q) + 1):
            pt = min(_DW_MAX_PT, -(-P // gp))
            qt = min(_DW_MAX_QT, -(-Q // gq))
            tp, tq = -(-P // (gp * pt)), -(-Q // (gq * qt))
            # equal tiles: the fewest blocks per thread for these counts
            p_tile, q_tile = -(-P // tp), -(-Q // tq)
            pt, qt = -(-p_tile // gp), -(-q_tile // gq)
            key = (tp * tq, Q * tp + P * tq, pt * qt, pt + qt, gp * gq)
            if best is None or key < best[0]:
                best = key, (gp, gq, pt, qt, tp, tq)
    gp, gq, pt, qt, tp, tq = best[1]
    splits = max(1, min(_DW_WAVE // (G * tp * tq), -(-B // _DW_MIN_ROWS)))
    rows_per_split = -(-B // splits)
    staged = gp * pt + gq * qt
    fit = 1
    while (fit < rows_per_split
           and _dw_smem_bytes(k, fit + 1, staged) <= _DW_SMEM_BUDGET):
        fit += 1
    rows = -(-rows_per_split // -(-rows_per_split // fit))   # equal chunks
    return DWGeometry(fft, slots, rows, gp, gq, pt, qt,
                      (tp, tq), splits, rows_per_split,
                      _dw_smem_bytes(k, rows, staged), G)


def _check_dw_args(x2d, g2d, P, Q, k):
    """Shapes, types, devices and layout of a launch; returns its group
    count G (1 for 2-D x and g; the leading axis of 3-D x and g)."""
    for name, t in (("x", x2d), ("g", g2d)):
        if t.dim() not in (2, 3) or t.dtype not in (torch.float32,
                                                    torch.bfloat16):
            raise ValueError(f"{name} must be 2-D or 3-D f32 or bf16, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if g2d.device != x2d.device:
        raise ValueError(f"g is on {g2d.device}, x on {x2d.device}")
    if not 1 <= k <= _MAX_K or P < 1 or Q < 1:
        raise ValueError(f"block grid P={P}, Q={Q}, k={k}: the kernel takes "
                         f"P, Q >= 1 and 1 <= k <= {_MAX_K}")
    lead = x2d.shape[:-2]
    if (x2d.shape[-1] != Q * k
            or g2d.shape != lead + (x2d.shape[-2], P * k)):
        raise ValueError(f"x {tuple(x2d.shape)} and g {tuple(g2d.shape)} "
                         f"must be ([G,] B, Q*k={Q * k}) and ([G,] B, "
                         f"P*k={P * k})")
    G = lead[0] if lead else 1
    if not 1 <= G <= _MAX_GROUPS:
        raise ValueError(f"groups: x {tuple(x2d.shape)}; the kernel takes "
                         f"1 <= G <= {_MAX_GROUPS} groups")
    return G


def bc_dw(x2d: torch.Tensor, g2d: torch.Tensor, *, P: int, Q: int, k: int,
          freq_out: bool = False):
    """Weight adjoint: x (B, Q·k) and cotangent g (B, P·k), each f32 or
    bf16 -> dw (P, Q·k) f32, or (dwr, dwi) each (P, Q, K) f32 when
    ``freq_out``. Grouped: x (G, B, Q·k) and g (G, B, P·k) -> dw (G, P,
    Q·k) or (dwr, dwi) each (G, P, Q, K), G adjoints in ONE launch (the
    reference's ``_bc_dw_kernel`` under ``jax.vmap``).

    The call is the registered op ``repro_torch::bc_dw`` (``bc_dw_freq``
    when ``freq_out``; a schema has fixed returns): CPU tensors take
    :func:`bc_dw_plain`; CUDA tensors launch the kernel
    (``csrc/bc_dw.cu``: partial sums over row ranges in an f32 workspace,
    then a fixed-order reduction and the epilogue) on the current stream or
    raise; meta tensors take the fake implementation.
    """
    if freq_out:
        return OPS["bc_dw_freq"](x2d, g2d, P, Q, k)
    return OPS["bc_dw"](x2d, g2d, P, Q, k)


def _bc_dw_cpu(x2d, g2d, P, Q, k):
    return bc_dw_plain(x2d, g2d, P=P, Q=Q, k=k)


def _bc_dw_freq_cpu(x2d, g2d, P, Q, k):
    return bc_dw_plain(x2d, g2d, P=P, Q=Q, k=k, freq_out=True)


def _bc_dw_launch(x2d, g2d, P, Q, k, freq_out):
    """The CUDA impls of ``repro_torch::bc_dw`` / ``bc_dw_freq``: the
    kernel launch."""
    G = _check_dw_args(x2d, g2d, P, Q, k)
    lead = x2d.shape[:-2]
    B, K, dev = x2d.shape[-2], k // 2 + 1, x2d.device

    def out(shape):
        return torch.empty(lead + shape, dtype=torch.float32, device=dev)

    outs = ((out((P, Q, K)), out((P, Q, K))) if freq_out
            else (out((P, Q * k)), None))
    if B == 0:                       # a sum over no rows
        for t in outs:
            if t is not None:
                t.zero_()
        return outs if freq_out else outs[0]
    launch = _entry("bc_dw")
    geo = _dw_geometry(B, P, Q, k, G)
    part = torch.empty((geo.splits, G, P, Q, geo.slots, 2),
                       dtype=torch.float32, device=dev)
    tw, bases = ((fft_twiddles(k, device=dev), (None, None)) if geo.fft
                 else (None, dft_bases(k, device=dev)[:2]))
    rc = _launch_on(
        dev, launch,
        _ptr(x2d), _ptr(g2d), _ptr(tw), *map(_ptr, bases), _ptr(part),
        _ptr(outs[0]), _ptr(outs[1]), B, P, Q, k, G,
        int(x2d.dtype == torch.bfloat16), int(g2d.dtype == torch.bfloat16),
        int(freq_out), geo.rows, geo.p_groups, geo.q_groups,
        geo.p_per_thread, geo.q_per_thread, geo.splits, geo.smem_bytes)
    if rc != 0:
        raise RuntimeError(f"bc_dw kernel launch failed: CUDA error {rc}")
    LAUNCHES["bc_dw"] += 1
    return outs if freq_out else outs[0]


def _bc_dw_fake(x2d, g2d, P, Q, k):
    return x2d.new_empty(x2d.shape[:-2] + (P, Q * k), dtype=torch.float32)


def _bc_dw_freq_fake(x2d, g2d, P, Q, k):
    shape = x2d.shape[:-2] + (P, Q, k // 2 + 1)
    return (x2d.new_empty(shape, dtype=torch.float32),
            x2d.new_empty(shape, dtype=torch.float32))


# ---------------------------------------------------------------------------
# The registered ops
# ---------------------------------------------------------------------------

# Low-level define/impl (not the custom_op decorator, whose wrapper costs
# more host time per call): one schema each, a CPU impl (the plain
# version), a CUDA impl (the launch) and a fake impl (shapes and dtypes,
# for meta and fake tensors). No fallback between them: the dispatcher
# sends a CUDA tensor to the launch, which raises on what it cannot take.
_LIB = torch.library.Library("repro_torch", "DEF")
_SCHEMAS = {
    "bc_matmul": ("bc_matmul(Tensor x, Tensor wr, Tensor wi, Tensor? bias, "
                  "Tensor? w_scale, int k, str activation) -> Tensor",
                  _bc_matmul_cpu, _bc_matmul_cuda, _bc_matmul_fake),
    "bc_dw": ("bc_dw(Tensor x, Tensor g, int P, int Q, int k) -> Tensor",
              _bc_dw_cpu,
              lambda x, g, P, Q, k: _bc_dw_launch(x, g, P, Q, k, False),
              _bc_dw_fake),
    "bc_dw_freq": ("bc_dw_freq(Tensor x, Tensor g, int P, int Q, int k) "
                   "-> (Tensor, Tensor)", _bc_dw_freq_cpu,
                   lambda x, g, P, Q, k: _bc_dw_launch(x, g, P, Q, k, True),
                   _bc_dw_freq_fake),
}
for _name, (_schema, _cpu, _cuda, _fake) in _SCHEMAS.items():
    _LIB.define(_schema)
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"repro_torch::{_name}", _fake, lib=_LIB)

#: the ops' overloads, called by the public wrappers (and named by the
#: analysis layer's capture, which records each launch as one op)
OPS = {name: getattr(torch.ops.repro_torch, name).default
       for name in _SCHEMAS}
