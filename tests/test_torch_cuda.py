"""The port on the card: the CUDA kernel against its plain version, and the
smoke engine on the card against the same engine on the CPU. Every test
here needs a CUDA device (marked ``gpu``; skipped without one). This file
imports neither jax nor the JAX package, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.configs.base import SWMConfig
from repro_torch.core.quant import (dequantize_symmetric, quantize_symmetric,
                                    symmetric_scales)
from repro_torch.kernels.block_circulant import kernel
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params
from repro_torch.serve.engine import Request, SamplingParams, ServeEngine

REL_TOL = 2e-5          # fp32 vs fp32 (tests/test_conformance.py REL_TOL)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


def _tables(p, q, k, gen, dev):
    K = k // 2 + 1
    return (torch.randn(p, q, K, generator=gen).to(dev),
            torch.randn(p, q, K, generator=gen).to(dev))


@pytest.mark.parametrize("B,p,q,k", [(1, 32, 8, 128), (37, 5, 3, 7),
                                     (9, 3, 11, 8), (13, 2, 2, 16)])
@pytest.mark.parametrize("act", ["none", "gelu"])
def test_kernel_matches_plain(cuda, B, p, q, k, act):
    gen = torch.Generator().manual_seed(B * 1000 + k)
    wr, wi = _tables(p, q, k, gen, cuda)
    x = torch.randn(B, q * k, generator=gen).to(cuda)
    bias = torch.randn(p * k, generator=gen).to(cuda)
    n0 = kernel.LAUNCHES["bc_matmul"]
    y = kernel.bc_matmul(x, wr, wi, bias, k=k, activation=act)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["bc_matmul"] == n0 + 1
    yp = kernel.bc_matmul_plain(x, wr, wi, bias, k=k, activation=act)
    assert _rel(y, yp) <= REL_TOL


def test_kernel_int8_bit_identical(cuda):
    gen = torch.Generator().manual_seed(28)
    wr, wi = _tables(24, 8, 128, gen, cuda)
    x = torch.randn(4, 8 * 128, generator=gen).to(cuda, torch.bfloat16)
    s = symmetric_scales(wr, wi)
    qr, qi = quantize_symmetric(wr, s), quantize_symmetric(wi, s)
    y8 = kernel.bc_matmul(x, qr, qi, None, s, k=128)
    yd = kernel.bc_matmul(x, dequantize_symmetric(qr, s),
                          dequantize_symmetric(qi, s), k=128)
    assert torch.equal(y8, yd)


def test_kernel_rejects_what_it_cannot_take(cuda):
    wr, wi = _tables(2, 2, 8, torch.Generator().manual_seed(0), cuda)
    x = torch.zeros(3, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.bc_matmul(torch.zeros(16, 3, device=cuda).T, wr, wi, k=8)
    with pytest.raises(ValueError, match="w_scale"):
        kernel.bc_matmul(x, wr.to(torch.int8), wi.to(torch.int8), k=8)
    with pytest.raises(ValueError, match="f32 or bf16"):
        kernel.bc_matmul(x.half(), wr, wi, k=8)


def test_smoke_engine_on_card_matches_cpu(cuda):
    """Same params and requests (f32 smoke config, kernel impl): the card
    engine emits the CPU engine's tokens and launches the kernel 5 times
    per layer per forward."""
    cfg = dataclasses.replace(tq.SMOKE, swm=SWMConfig(block_size=8,
                                                      impl="pallas"))
    params = init_params(build_model(cfg, device="cpu").specs(), 0,
                         device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab, size=int(rng.integers(2, 9))
                                 ).astype(np.int32), max_new=5,
                    sampling=SamplingParams(0.7, 10, i) if i % 2
                    else SamplingParams())
            for i in range(6)]
    outs = {}
    for dev in ("cpu", cuda):
        tree = params if dev == "cpu" else _to(params, dev)
        eng = ServeEngine(build_model(cfg, device=dev), cfg, tree, batch=4,
                          cache_len=32, prompt_buckets=(4, 8, 16))
        n0 = kernel.LAUNCHES["bc_matmul"]
        outs[str(dev)] = eng.generate(reqs)
        forwards = eng.stats.prefill_calls + eng.stats.decode_steps
        if dev != "cpu":
            assert (kernel.LAUNCHES["bc_matmul"] - n0
                    == 5 * cfg.n_layers * forwards)
    assert outs["cpu"] == outs[str(cuda)]


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}
