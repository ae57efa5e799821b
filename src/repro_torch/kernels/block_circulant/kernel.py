"""Block-circulant kernels: the CUDA launches and their plain versions.

``bc_matmul`` computes ``y = act(iDFT(Σ_q DFT(x_q)·ŵ_pq) + bias)`` for x
``(B, q·k)`` and frozen frequency tables ``wr, wi (p, q, K = k//2+1)`` —
the function of the reference's Pallas TPU kernel ``_bc_kernel``
(``repro/kernels/block_circulant/kernel.py``). ``bc_dw`` computes the
weight adjoint ``dŵ[p,q,f] = Σ_b ĝ[b,p,f]·conj(x̂[b,q,f])`` of the
reference's ``_bc_dw_kernel``, folded back to the time domain or as the raw
frequency pair. On a CUDA tensor each launches its hand-written kernel
(``csrc/bc_matmul.cu``, ``csrc/bc_dw.cu``; the note in each source says
what bounds it on the H100 and how it is laid out); on a CPU tensor each
runs its plain version (:func:`bc_matmul_plain`, :func:`bc_dw_plain`), the
same DFT-as-matmul math in plain PyTorch. There is no fallback between the
two: a CUDA tensor a kernel cannot take raises.

:func:`build` compiles every ``csrc/*.cu`` with ``nvcc`` for ``sm_90a``
(one process per source, all started together) into the ``build/``
directory beside this file, keyed by each source's hash; the libraries are
bound with ``ctypes`` at first use. ``LAUNCHES`` counts kernel launches
per wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.circulant import dft_bases, dft_bases_adjoint
from repro_torch.core.quant import dequantize_symmetric

__all__ = ["ACTIVATIONS", "apply_activation", "bc_dw", "bc_dw_plain",
           "bc_matmul", "bc_matmul_plain", "build", "LAUNCHES", "SOURCES"]

# Epilogue activations fused into the writeback. Keys are the only legal
# ``activation=`` values; the index is the kernel's activation code.
ACTIVATIONS = ("none", "relu", "tanh", "sigmoid", "gelu")

# kernel name -> CUDA source; each builds into its own library
SOURCES = {p.stem: p for p in sorted(
    Path(__file__).with_name("csrc").glob("*.cu"))}
_BUILD_DIR = Path(__file__).with_name("build")
_MAX_K = 128   # kMaxK in both sources; the C entry points reject larger k
_DW_ROWS = 4   # kRows in bc_dw.cu: rows per staged chunk
# bc_dw splits the rows across blocks until about this many are in flight
# (two per SM of the H100's 132)
_DW_TARGET_BLOCKS = 264

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
    with :func:`dequantize_symmetric` first."""
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
    raw (dwr, dwi) pair (P, Q, K) when ``freq_out``."""
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


def build() -> Dict[str, Tuple[Path, str]]:
    """Compile every ``csrc/*.cu`` for ``sm_90a`` into ``build/`` unless a
    library for that exact source already exists, one ``nvcc`` per source,
    all started together. Returns ``{name: (library path, compiler
    output)}``; the output (ptxas resource usage) is empty for a library
    that was already built."""
    libs = {name: _BUILD_DIR / f"{name}-"
            f"{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
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
    "bc_matmul": ("bc_matmul_forward", 10, 7),
    "bc_dw": ("bc_dw_launch", 11, 9),
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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_cuda_args(x2d, wr, wi, bias, w_scale, k):
    if x2d.dim() != 2 or x2d.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be 2-D f32 or bf16, got {tuple(x2d.shape)} "
                         f"{x2d.dtype}")
    if wr.dim() != 3 or wr.shape != wi.shape or wr.dtype != wi.dtype:
        raise ValueError(f"wr/wi must share one (p, q, K) shape and dtype, "
                         f"got {tuple(wr.shape)} {wr.dtype} / "
                         f"{tuple(wi.shape)} {wi.dtype}")
    p, q, K = wr.shape
    if not 1 <= k <= _MAX_K or K != k // 2 + 1:
        raise ValueError(f"block size k={k} with K={K}: the kernel takes "
                         f"1 <= k <= {_MAX_K} and K = k//2+1")
    if x2d.shape[1] != q * k:
        raise ValueError(f"x width {x2d.shape[1]} != q*k = {q * k}")
    if wr.dtype == torch.int8:
        if w_scale is None or w_scale.shape != (p, q) \
                or w_scale.dtype != torch.float32:
            raise ValueError("int8 tables need a (p, q) f32 w_scale")
    elif wr.dtype != torch.float32 or w_scale is not None:
        raise ValueError(f"tables must be f32 (no w_scale) or int8 "
                         f"(with w_scale), got {wr.dtype}")
    if bias is not None and (bias.shape != (p * k,)
                             or bias.dtype != torch.float32):
        raise ValueError(f"bias must be ({p * k},) f32, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    for name, t in (("x", x2d), ("wr", wr), ("wi", wi), ("bias", bias),
                    ("w_scale", w_scale)):
        if t is None:
            continue
        if t.device != x2d.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2d.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def bc_matmul(x2d: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              w_scale: Optional[torch.Tensor] = None, *, k: int,
              activation: str = "none") -> torch.Tensor:
    """x (B, q·k) × frozen tables (p, q, K)·2 -> y (B, p·k) in x's dtype.

    ``bias`` (p·k,) f32 and ``activation`` run in the kernel's epilogue;
    ``w_scale`` (p, q) f32 marks wr/wi as int8 tables dequantized in the
    kernel. CPU tensors take :func:`bc_matmul_plain`; CUDA tensors launch
    the kernel on the current stream or raise.
    """
    if activation not in ACTIVATIONS:
        raise ValueError(
            f"unknown activation {activation!r}; one of {ACTIVATIONS}")
    if x2d.device.type == "cpu":
        return bc_matmul_plain(x2d, wr, wi, bias, w_scale, k=k,
                               activation=activation)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"bc_matmul runs on cuda or cpu, not {x2d.device}")
    _check_cuda_args(x2d, wr, wi, bias, w_scale, k)
    B = x2d.shape[0]
    p, q, _ = wr.shape
    y = torch.empty((B, p * k), dtype=x2d.dtype, device=x2d.device)
    if B == 0:
        return y
    launch = _entry("bc_matmul")
    C, S, Ci, Si = dft_bases(k, device=x2d.device)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = launch(
            _ptr(x2d), _ptr(wr), _ptr(wi), _ptr(w_scale), _ptr(bias),
            _ptr(C), _ptr(S), _ptr(Ci), _ptr(Si), _ptr(y), B, p, q, k,
            int(x2d.dtype == torch.bfloat16), int(wr.dtype == torch.int8),
            ACTIVATIONS.index(activation), stream)
    if rc != 0:
        raise RuntimeError(f"bc_matmul kernel launch failed: CUDA error {rc}")
    LAUNCHES["bc_matmul"] += 1
    return y


def _dw_split(B: int, P: int, Q: int) -> Tuple[int, int]:
    """(splits, rows per split) of bc_dw's row ranges: enough ranges that
    about ``_DW_TARGET_BLOCKS`` blocks run, each a whole number of staged
    chunks. Depends on the shapes alone, so a launch is reproducible."""
    tiles = -(-P // 8) * -(-Q // 8)
    splits = max(1, min(-(-B // _DW_ROWS), -(-_DW_TARGET_BLOCKS // tiles)))
    rows = -(-B // splits)
    rows = -(-rows // _DW_ROWS) * _DW_ROWS
    return -(-B // rows), rows


def _check_dw_args(x2d, g2d, P, Q, k):
    for name, t in (("x", x2d), ("g", g2d)):
        if t.dim() != 2 or t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name} must be 2-D f32 or bf16, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if g2d.device != x2d.device:
        raise ValueError(f"g is on {g2d.device}, x on {x2d.device}")
    if not 1 <= k <= _MAX_K or P < 1 or Q < 1:
        raise ValueError(f"block grid P={P}, Q={Q}, k={k}: the kernel takes "
                         f"P, Q >= 1 and 1 <= k <= {_MAX_K}")
    if x2d.shape[1] != Q * k or g2d.shape != (x2d.shape[0], P * k):
        raise ValueError(f"x {tuple(x2d.shape)} and g {tuple(g2d.shape)} "
                         f"must be (B, Q*k={Q * k}) and (B, P*k={P * k})")


def bc_dw(x2d: torch.Tensor, g2d: torch.Tensor, *, P: int, Q: int, k: int,
          freq_out: bool = False):
    """Weight adjoint: x (B, Q·k) and cotangent g (B, P·k), each f32 or
    bf16 -> dw (P, Q·k) f32, or (dwr, dwi) each (P, Q, K) f32 when
    ``freq_out``.

    CPU tensors take :func:`bc_dw_plain`; CUDA tensors launch the kernel
    (``csrc/bc_dw.cu``: partial sums over row ranges, then a fixed-order
    reduction and the epilogue) on the current stream or raise.
    """
    if x2d.device.type == "cpu":
        return bc_dw_plain(x2d, g2d, P=P, Q=Q, k=k, freq_out=freq_out)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"bc_dw runs on cuda or cpu, not {x2d.device}")
    _check_dw_args(x2d, g2d, P, Q, k)
    B, K, dev = x2d.shape[0], k // 2 + 1, x2d.device
    if freq_out:
        outs = (torch.empty((P, Q, K), dtype=torch.float32, device=dev),
                torch.empty((P, Q, K), dtype=torch.float32, device=dev))
    else:
        outs = (torch.empty((P, Q * k), dtype=torch.float32, device=dev),
                None)
    if B == 0:                       # a sum over no rows
        for t in outs:
            if t is not None:
                t.zero_()
        return outs if freq_out else outs[0]
    launch = _entry("bc_dw")
    splits, rows = _dw_split(B, P, Q)
    part = torch.empty((2, splits, P, Q, K), dtype=torch.float32, device=dev)
    C, S, CiT, SiT, CT, ST = dft_bases_adjoint(k, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            _ptr(x2d), _ptr(g2d), _ptr(C), _ptr(S), _ptr(CiT), _ptr(SiT),
            _ptr(CT), _ptr(ST), _ptr(part), _ptr(outs[0]), _ptr(outs[1]),
            B, P, Q, k, int(x2d.dtype == torch.bfloat16),
            int(g2d.dtype == torch.bfloat16), int(freq_out), splits, rows,
            stream)
    if rc != 0:
        raise RuntimeError(f"bc_dw kernel launch failed: CUDA error {rc}")
    LAUNCHES["bc_dw"] += 1
    return outs if freq_out else outs[0]
