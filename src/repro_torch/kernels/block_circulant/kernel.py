"""Block-circulant matmul kernel: the CUDA launch and its plain version.

``bc_matmul`` computes ``y = act(iDFT(Σ_q DFT(x_q)·ŵ_pq) + bias)`` for x
``(B, q·k)`` and frozen frequency tables ``wr, wi (p, q, K = k//2+1)`` —
the function of the reference's Pallas TPU kernel ``_bc_kernel``
(``repro/kernels/block_circulant/kernel.py``). On a CUDA tensor it launches
the hand-written kernel in ``csrc/bc_matmul.cu`` (see the note there for
what bounds it on the H100 and how it is laid out); on a CPU tensor it runs
:func:`bc_matmul_plain`, the same DFT-as-matmul math in plain PyTorch.
There is no fallback between the two: a CUDA tensor the kernel cannot take
raises.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into the
``build/`` directory beside this file (keyed by the source's hash) and
bound with ``ctypes``. ``LAUNCHES["bc_matmul"]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.core.circulant import dft_bases
from repro_torch.core.quant import dequantize_symmetric

__all__ = ["ACTIVATIONS", "apply_activation", "bc_matmul",
           "bc_matmul_plain", "build", "LAUNCHES", "SOURCE"]

# Epilogue activations fused into the writeback. Keys are the only legal
# ``activation=`` values; the index is the kernel's activation code.
ACTIVATIONS = ("none", "relu", "tanh", "sigmoid", "gelu")

SOURCE = Path(__file__).with_name("csrc") / "bc_matmul.cu"
_BUILD_DIR = Path(__file__).with_name("build")
_MAX_K = 128   # kMaxK in the source; the C entry point rejects larger k

# Kernel launches since the last reset (chip_smoke reads and resets it).
LAUNCHES = {"bc_matmul": 0}


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


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def build() -> Tuple[Path, str]:
    """Compile ``csrc/bc_matmul.cu`` for ``sm_90a`` into ``build/`` unless
    a library for this exact source already exists. Returns the library
    path and the compiler's output (ptxas resource usage; empty when the
    library was already built)."""
    src = SOURCE.read_bytes()
    lib = _BUILD_DIR / f"bc_matmul-{hashlib.sha256(src).hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the block-circulant kernel")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"),
           "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)     # atomic: concurrent builds race harmlessly
    return lib, res.stdout + res.stderr


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.bc_matmul_forward
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


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
    lib = _library()
    C, S, Ci, Si = dft_bases(k, device=x2d.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = lib.bc_matmul_forward(
            ptr(x2d), ptr(wr), ptr(wi), ptr(w_scale), ptr(bias), ptr(C),
            ptr(S), ptr(Ci), ptr(Si), ptr(y), B, p, q, k,
            int(x2d.dtype == torch.bfloat16), int(wr.dtype == torch.int8),
            ACTIVATIONS.index(activation), stream)
    if rc != 0:
        raise RuntimeError(f"bc_matmul kernel launch failed: CUDA error {rc}")
    LAUNCHES["bc_matmul"] += 1
    return y
