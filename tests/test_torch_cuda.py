"""The port on the card: the CUDA kernels against their plain versions,
the smoke engine on the card against the same engine on the CPU, and the
autograd Functions' grads on the card against the CPU. Every test here
needs a CUDA device (marked ``gpu``; skipped without one). This file
imports neither jax nor the JAX package, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.configs.base import SWMConfig, TrainConfig
from repro_torch.core.quant import (dequantize_symmetric, quantize_symmetric,
                                    symmetric_scales)
from repro_torch.kernels.block_circulant import kernel, ops
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params, tree_leaves
from repro_torch.train.loop import (init_train_state, make_loss_fn,
                                    value_and_grad)
from repro_torch.serve.engine import Request, SamplingParams, ServeEngine
import test_torch_threads  # noqa: F401  (one thread budget per worker)

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


@pytest.mark.parametrize("B,p,q,k", [
    (1, 32, 8, 128), (37, 5, 3, 7), (9, 3, 11, 8), (13, 2, 2, 16),
    # full width (qwen3-0.6b, k = 128): decode, prefill and train rows
    (4, 32, 8, 128), (4, 8, 24, 128), (512, 32, 8, 128), (512, 8, 16, 128),
    (2048, 8, 32, 128), (2048, 24, 8, 128),
    # FFT path at k = 32 and 64, dense path at k = 96
    (37, 3, 5, 32), (37, 4, 6, 64), (19, 3, 4, 96)])
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


@pytest.mark.parametrize("B,p,q,k", [(4, 8, 24, 128), (512, 32, 8, 128),
                                     (2048, 8, 32, 128), (37, 3, 5, 96)])
def test_kernel_repeat_launch_bit_identical(cuda, B, p, q, k):
    """The q sum never leaves a block and its groups add in a fixed order,
    so two launches on the same inputs agree bit for bit."""
    gen = torch.Generator().manual_seed(B + p + q + k)
    wr, wi = _tables(p, q, k, gen, cuda)
    x = torch.randn(B, q * k, generator=gen).to(cuda, torch.bfloat16)
    y = kernel.bc_matmul(x, wr, wi, k=k)
    again = kernel.bc_matmul(x, wr, wi, k=k)
    assert torch.equal(y, again)


@pytest.mark.parametrize("B,p,q,k", [(4, 32, 8, 128), (2048, 8, 32, 128),
                                     (19, 3, 4, 96)])
def test_kernel_rejects_smem_other_than_its_layout(cuda, monkeypatch, B, p,
                                                   q, k):
    """The geometry is chosen on ``_mm_smem_bytes``, the host's mirror of
    the kernel's shared-memory layout; a launch whose size differs from the
    layout's is refused, so every launch checks that mirror."""
    gen = torch.Generator().manual_seed(B + k)
    wr, wi = _tables(p, q, k, gen, cuda)
    x = torch.randn(B, q * k, generator=gen).to(cuda)
    kernel.bc_matmul(x, wr, wi, k=k)                  # the mirror's size
    geometry = kernel._mm_geometry
    monkeypatch.setattr(kernel, "_mm_geometry", lambda *a: geometry(
        *a)._replace(smem_bytes=geometry(*a).smem_bytes + 16))
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernel.bc_matmul(x, wr, wi, k=k)


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


def _dw_tol(B):
    """bc_dw sums B rows per element in another order than the plain
    version (partials per row range, then the ranges in order). The
    worst-case rounding error of an n-term f32 sum grows linearly in n, so
    REL_TOL, which holds to 512 rows, scales with the row count beyond that
    (``DW_TOL_ROWS`` in chip_smoke.py). bf16 inputs convert exactly to f32
    on both sides, so they are held to the same limit."""
    return REL_TOL * max(1.0, B / 512)


_F32, _BF16 = torch.float32, torch.bfloat16
# (B, P, Q, k, dtype): small grids on both paths; the slice's weight
# adjoints at k = 128 with one row, a row count below the row splits'
# target and the training rows; the FFT path at k = 32 and 64, the dense
# path at k = 96, and grids too large for one tile (p tiled, q tiled)
_DW_CASES = ([(64, 32, 8, 128, _F32), (37, 5, 3, 7, _F32),
              (9, 3, 11, 8, _F32), (13, 2, 2, 16, _F32), (3, 1, 1, 1, _F32)]
             + [(B, P, Q, 128, dt) for B in (1, 5, 2048)
                for P, Q in ((32, 8), (8, 16), (24, 8), (8, 24))
                for dt in (_F32, _BF16)]
             + [(B, P, Q, k, dt) for B, P, Q, k in
                ((37, 3, 5, 32), (29, 4, 6, 64), (19, 3, 4, 96),
                 (300, 8, 16, 64), (64, 64, 8, 128), (40, 2, 300, 128))
                for dt in (_F32, _BF16)])


@pytest.mark.parametrize("B,P,Q,k,dtype", _DW_CASES)
@pytest.mark.parametrize("freq_out", [False, True])
def test_dw_kernel_matches_plain(cuda, B, P, Q, k, dtype, freq_out):
    gen = torch.Generator().manual_seed(B * 100 + k)
    x = torch.randn(B, Q * k, generator=gen).to(cuda, dtype)
    g = torch.randn(B, P * k, generator=gen).to(cuda, dtype)
    n0 = kernel.LAUNCHES["bc_dw"]
    got = kernel.bc_dw(x, g, P=P, Q=Q, k=k, freq_out=freq_out)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["bc_dw"] == n0 + 1
    ref = kernel.bc_dw_plain(x, g, P=P, Q=Q, k=k, freq_out=freq_out)
    for a, b in zip(got if freq_out else [got], ref if freq_out else [ref]):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel(a, b) <= _dw_tol(B)
    again = kernel.bc_dw(x, g, P=P, Q=Q, k=k, freq_out=freq_out)
    for a, b in zip(got if freq_out else [got],
                    again if freq_out else [again]):
        assert torch.equal(a, b)         # fixed-order reduction


@pytest.mark.parametrize("B,P,Q,k", [(2048, 32, 8, 128), (5, 8, 24, 128),
                                     (19, 3, 4, 96)])
def test_dw_kernel_rejects_smem_other_than_its_layout(cuda, monkeypatch, B,
                                                      P, Q, k):
    """The geometry is chosen on ``_dw_smem_bytes``, the host's mirror of
    bc_dw_partial's shared-memory layout; a launch whose size differs from
    the layout's is refused."""
    gen = torch.Generator().manual_seed(B + k)
    x = torch.randn(B, Q * k, generator=gen).to(cuda)
    g = torch.randn(B, P * k, generator=gen).to(cuda)
    kernel.bc_dw(x, g, P=P, Q=Q, k=k)                 # the mirror's size
    geometry = kernel._dw_geometry
    monkeypatch.setattr(kernel, "_dw_geometry", lambda *a: geometry(
        *a)._replace(smem_bytes=geometry(*a).smem_bytes + 16))
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernel.bc_dw(x, g, P=P, Q=Q, k=k)


@pytest.mark.parametrize("path", ["w", "w_freq"])
def test_function_grads_on_card_match_cpu(cuda, path):
    """dx, dw (or dwr/dwi) and db of the ops' autograd Functions: kernels
    on the card against plain versions on the CPU, f32."""
    B, p, q, k = 6, 3, 2, 8
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(B, q * k, generator=gen)
    bias = torch.randn(p * k, generator=gen)
    tabs = ([torch.randn(p, q, k, generator=gen) * 0.25] if path == "w"
            else [torch.randn(p, q, k // 2 + 1, generator=gen)
                  for _ in range(2)])
    cot = torch.randn(B, p * k, generator=gen)
    grads = {}
    for dev in ("cpu", cuda):
        ins = [t.to(dev).requires_grad_(True) for t in [x, bias, *tabs]]
        xs, bs, *ts = ins
        if path == "w":
            y = ops.block_circulant_matmul(xs, ts[0], bias=bs,
                                           activation="gelu")
        else:
            y = ops.block_circulant_matmul(xs, None, bias=bs,
                                           activation="gelu",
                                           w_freq=tuple(ts), k=k)
        n0 = dict(kernel.LAUNCHES)
        grads[str(dev)] = torch.autograd.grad((y * cot.to(dev)).sum(), ins)
        if dev != "cpu":
            assert kernel.LAUNCHES["bc_matmul"] == n0["bc_matmul"] + 1
            assert kernel.LAUNCHES["bc_dw"] == n0["bc_dw"] + 1
    for a, b in zip(grads[str(cuda)], grads["cpu"]):
        assert _rel(a, b) <= REL_TOL


def test_card_loss_gives_every_circulant_leaf_a_grad(cuda):
    """A kernel-path loss on the card differentiates through the kernels:
    every circulant table gets a finite, non-zero grad (the forward alone
    would leave them without one)."""
    cfg = dataclasses.replace(tq.SMOKE, swm=SWMConfig(block_size=8,
                                                      impl="pallas"))
    model = build_model(cfg, device=cuda)
    params = init_params(model.specs(), 0, device=cuda)
    tcfg = TrainConfig()
    init_train_state(params, tcfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 9)).astype(np.int32)).to(cuda)
    n0 = dict(kernel.LAUNCHES)
    (loss, _), grads = value_and_grad(make_loss_fn(model, cfg, tcfg), params,
                                      {"tokens": tokens}, has_aux=True)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    per_pass = 5 * cfg.n_layers
    assert kernel.LAUNCHES["bc_matmul"] - n0["bc_matmul"] == 2 * per_pass
    assert kernel.LAUNCHES["bc_dw"] - n0["bc_dw"] == per_pass
    circ = [g for (p, g) in zip(tree_leaves(params), tree_leaves(grads))
            if p.dim() == 3]
    assert len(circ) == per_pass + 2 * cfg.n_layers     # q/k/v separate
    for g in circ:
        assert torch.isfinite(g).all() and g.abs().max() > 0


# The paper models' launches (B, p, q, k): SWMMLP at B = 64, ASICNet at
# B = 256, SWMCNN's conv1 im2col table (p = 8, r²·q = 100, k = 8) at B·64
# rows and its dx, the SWMLSTM fused gates and Wym at B = 4 (k = 16, 8)
_PAPER = [(64, 32, 49, 16), (64, 8, 8, 64), (256, 8, 8, 64),
          (256, 1, 8, 64), (512, 8, 100, 8), (8192, 8, 100, 8),
          (8192, 100, 8, 8), (4, 256, 42, 16), (4, 256, 64, 16),
          (4, 32, 64, 16), (4, 512, 84, 8), (4, 512, 128, 8),
          (4, 64, 128, 8)]


@pytest.mark.parametrize("B,p,q,k", _PAPER)
def test_kernel_matches_plain_at_paper_shapes(cuda, B, p, q, k):
    """f32 x and tables against the plain version; int8 tables bit for
    bit against the f32 launch on the dequantized tables."""
    gen = torch.Generator().manual_seed(B + p + q + k)
    wr, wi = _tables(p, q, k, gen, cuda)
    x = torch.randn(B, q * k, generator=gen).to(cuda)
    bias = torch.randn(p * k, generator=gen).to(cuda)
    y = kernel.bc_matmul(x, wr, wi, bias, k=k)
    yp = kernel.bc_matmul_plain(x, wr, wi, bias, k=k)
    assert _rel(y, yp) <= REL_TOL
    s = symmetric_scales(wr, wi)
    qr, qi = quantize_symmetric(wr, s), quantize_symmetric(wi, s)
    y8 = kernel.bc_matmul(x, qr, qi, bias, s, k=k)
    yd = kernel.bc_matmul(x, dequantize_symmetric(qr, s),
                          dequantize_symmetric(qi, s), bias, k=k)
    assert torch.equal(y8, yd)


@pytest.mark.parametrize("freq_out", [False, True])
def test_dw_kernel_at_the_cnn_train_shape(cuda, freq_out):
    """SWMCNN's conv1 weight adjoint at batch 128: P = 8, Q = 100, k = 8,
    8192 rows, f32."""
    B, P, Q, k = 8192, 8, 100, 8
    gen = torch.Generator().manual_seed(81)
    x = torch.randn(B, Q * k, generator=gen).to(cuda)
    g = torch.randn(B, P * k, generator=gen).to(cuda)
    got = kernel.bc_dw(x, g, P=P, Q=Q, k=k, freq_out=freq_out)
    ref = kernel.bc_dw_plain(x, g, P=P, Q=Q, k=k, freq_out=freq_out)
    for a, b in zip(got if freq_out else [got], ref if freq_out else [ref]):
        assert _rel(a, b) <= _dw_tol(B)


def test_paper_models_on_card_match_cpu(cuda):
    """Each paper model's forward (narrow widths) on the card against the
    CPU from the same params, unfrozen and frozen; every conv with k > 1
    and every ``impl="pallas"`` layer launches ``bc_matmul``."""
    from repro_torch.kernels.block_circulant.plan import freeze_params
    from repro_torch.models.paper_models import SWMCNN, SWMLSTMASR, SWMMLP
    from repro_torch.nn.module import load_tree

    cases = [(lambda: SWMMLP((64, 32, 32, 10), 16, impl="pallas"), (4, 64),
              2),
             (lambda: SWMCNN(), (2, 28, 28, 1), 1),
             (lambda: SWMLSTMASR(20, 32, 16, 2, 5, 8), (2, 3, 20), 0)]
    for make, shape, launches in cases:
        cpu_model, card_model = make(), make()
        params = init_params(cpu_model.specs(), 0, device="cpu")
        x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
        for mode in ("unfrozen", "off"):
            tree = (params if mode == "unfrozen" else
                    freeze_params(cpu_model.specs(), params, mode))
            load_tree(cpu_model, tree)
            load_tree(card_model, _to(tree, cuda))
            n0 = kernel.LAUNCHES["bc_matmul"]
            with torch.no_grad():
                y = card_model(x.to(cuda))
                torch.cuda.synchronize()
                assert kernel.LAUNCHES["bc_matmul"] - n0 == launches
                # several f32 launches in sequence (the LSTM: 2 layers x
                # 3 steps), each within REL_TOL: 5x REL_TOL
                assert _rel(y, cpu_model(x)) <= 5 * REL_TOL


# Grouped launches (G, B, p, q, k): the jamba experts' wi/wu and wo at
# full width (16 experts, d_ff 14336: p or q = 112) at decode and prefill
# rows, and small ragged grids on both transform paths
_GROUPED = [(16, 4, 112, 32, 128), (16, 32, 32, 112, 128),
            (16, 1, 112, 32, 128), (3, 5, 3, 2, 8), (2, 7, 2, 3, 7),
            (5, 9, 4, 3, 64)]


@pytest.mark.parametrize("G,B,p,q,k", _GROUPED)
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_grouped_kernel_matches_plain_and_single_launches(cuda, G, B, p, q,
                                                          k, dtype):
    """One launch for all G groups (the count moves by one), within the
    plain version's tolerance, every group bit for bit its own single
    launch, and a repeat launch bit-identical."""
    gen = torch.Generator().manual_seed(G * 100 + B + k)
    K = k // 2 + 1
    wr = torch.randn(G, p, q, K, generator=gen).to(cuda)
    wi = torch.randn(G, p, q, K, generator=gen).to(cuda)
    bias = torch.randn(G, p * k, generator=gen).to(cuda)
    x = torch.randn(G, B, q * k, generator=gen).to(cuda, dtype)
    n0 = kernel.LAUNCHES["bc_matmul"]
    y = kernel.bc_matmul(x, wr, wi, bias, k=k, activation="gelu")
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["bc_matmul"] == n0 + 1
    assert y.shape == (G, B, p * k) and y.dtype == dtype
    yp = kernel.bc_matmul_plain(x, wr, wi, bias, k=k, activation="gelu")
    tol = REL_TOL if dtype == _F32 else 2.0 ** -7 + REL_TOL
    assert _rel(y, yp) <= tol
    for g in range(G):
        assert torch.equal(y[g], kernel.bc_matmul(x[g], wr[g], wi[g], bias[g],
                                                  k=k, activation="gelu"))
    assert torch.equal(y, kernel.bc_matmul(x, wr, wi, bias, k=k,
                                           activation="gelu"))


@pytest.mark.parametrize("G,B,p,q,k", _GROUPED[:2] + _GROUPED[3:5])
def test_grouped_kernel_int8_bit_identical(cuda, G, B, p, q, k):
    """int8 tables with (G, p, q) scales: bit for bit the f32 grouped
    launch on the dequantized tables and each group's single int8
    launch."""
    gen = torch.Generator().manual_seed(G + B + p)
    K = k // 2 + 1
    wr = torch.randn(G, p, q, K, generator=gen).to(cuda)
    wi = torch.randn(G, p, q, K, generator=gen).to(cuda)
    x = torch.randn(G, B, q * k, generator=gen).to(cuda, _BF16)
    s = symmetric_scales(wr, wi)
    qr, qi = quantize_symmetric(wr, s), quantize_symmetric(wi, s)
    y8 = kernel.bc_matmul(x, qr, qi, None, s, k=k)
    yd = kernel.bc_matmul(x, dequantize_symmetric(qr, s),
                          dequantize_symmetric(qi, s), k=k)
    assert torch.equal(y8, yd)
    for g in range(G):
        assert torch.equal(y8[g], kernel.bc_matmul(x[g], qr[g], qi[g], None,
                                                   s[g], k=k))


def test_grouped_kernel_rejects_what_it_cannot_take(cuda):
    K = 5
    wr = torch.zeros(3, 2, 2, K, device=cuda)
    with pytest.raises(ValueError, match="groups"):
        kernel.bc_matmul(torch.zeros(2, 4, 16, device=cuda), wr, wr, k=8)
    with pytest.raises(ValueError, match="w_scale"):
        kernel.bc_matmul(torch.zeros(3, 4, 16, device=cuda),
                         wr.to(torch.int8), wr.to(torch.int8),
                         None, torch.ones(2, 2, device=cuda), k=8)
    with pytest.raises(ValueError, match="bias"):
        kernel.bc_matmul(torch.zeros(3, 4, 16, device=cuda), wr, wr,
                         torch.zeros(16, device=cuda), k=8)


def _moe_pair(cuda):
    from repro_torch.configs import jamba_52b as tj
    from repro_torch.nn.module import load_tree
    from repro_torch.nn.moe import MoE

    cfg = tj.SMOKE
    swm = SWMConfig(block_size=8, impl="pallas")
    mods = [MoE(cfg.d_model, cfg.d_ff_expert, cfg.n_experts,
                cfg.n_experts_per_token, swm=swm, dtype="float32")
            for _ in range(2)]
    params = init_params(mods[0].specs(), 0, device="cpu")
    load_tree(mods[0], params)
    load_tree(mods[1], _to(params, cuda))
    return cfg, mods


def test_moe_on_card_is_bit_identical_across_runs_and_matches_cpu(cuda):
    """The dispatch's scatter-add is atomic on the card; under no-drop each
    (expert, slot) receives one token, so two runs agree bit for bit. The
    experts take 3 grouped launches per forward."""
    cfg, (cpu, card) = _moe_pair(cuda)
    x = torch.randn(3, 7, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        n0 = kernel.LAUNCHES["bc_matmul"]
        y1, a1 = card(x.to(cuda), no_drop=True)
        torch.cuda.synchronize()
        assert kernel.LAUNCHES["bc_matmul"] - n0 == 3
        y2, a2 = card(x.to(cuda), no_drop=True)
        yc, ac = cpu(x, no_drop=True)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    # three f32 projections in sequence, as tests/test_torch_moe.py
    assert _rel(y1, yc) <= 1e-4


@pytest.mark.parametrize("arch", ["jamba", "rwkv6"])
def test_hybrid_smoke_engine_on_card_matches_cpu(cuda, arch):
    """The recurrent hybrids' smoke configs (f32, kernel impl) through
    ServeEngine -> RecurrentRunner on the card emit the CPU engine's greedy
    tokens, with the launches per forward the model's layers give."""
    from repro_torch.configs import jamba_52b as tj, rwkv6_7b as tr

    base = {"jamba": tj.SMOKE, "rwkv6": tr.SMOKE}[arch]
    cfg = dataclasses.replace(base, swm=SWMConfig(block_size=8,
                                                  impl="pallas"))
    params = init_params(build_model(cfg, device="cpu").specs(), 0,
                         device="cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(rng.integers(0, cfg.vocab, size=int(rng.integers(2, 9))
                                 ).astype(np.int32), max_new=5)
            for _ in range(6)]
    per_forward = {"jamba": 40, "rwkv6": 24}[arch]
    outs = {}
    for dev in ("cpu", cuda):
        tree = params if dev == "cpu" else _to(params, dev)
        eng = ServeEngine(build_model(cfg, device=dev), cfg, tree, batch=4,
                          cache_len=32)
        n0 = kernel.LAUNCHES["bc_matmul"]
        outs[str(dev)] = eng.generate(reqs)
        forwards = eng.stats.prefill_calls + eng.stats.decode_steps
        if dev != "cpu":
            assert (kernel.LAUNCHES["bc_matmul"] - n0
                    == per_forward * forwards)
    assert outs["cpu"] == outs[str(cuda)]


def test_encdec_smoke_engine_on_card_matches_cpu(cuda):
    """seamless-m4t-medium's smoke config (f32, kernel impl) through
    ServeEngine -> EncDecRunner on the card emits the CPU engine's greedy
    tokens for requests with encoder frames, with 4 launches per encoder
    layer and 8 per decoder layer per prefill, 6 per decoder layer per
    decode step."""
    from repro_torch.configs import seamless_m4t_medium as ts

    cfg = dataclasses.replace(ts.SMOKE, swm=SWMConfig(block_size=8,
                                                      impl="pallas"))
    params = init_params(build_model(cfg, device="cpu").specs(), 0,
                         device="cpu")
    rng = np.random.default_rng(2)
    reqs = [Request(rng.integers(0, cfg.vocab, size=int(rng.integers(2, 9))
                                 ).astype(np.int32), max_new=5,
                    extra=rng.standard_normal((cfg.enc_seq, cfg.d_model)
                                              ).astype(np.float32))
            for _ in range(6)]
    outs = {}
    for dev in ("cpu", cuda):
        tree = params if dev == "cpu" else _to(params, dev)
        eng = ServeEngine(build_model(cfg, device=dev), cfg, tree, batch=4,
                          cache_len=32)
        n0 = kernel.LAUNCHES["bc_matmul"]
        outs[str(dev)] = eng.generate(reqs)
        if dev != "cpu":
            assert (kernel.LAUNCHES["bc_matmul"] - n0
                    == (4 * cfg.n_enc_layers + 8 * cfg.n_layers)
                    * eng.stats.prefill_calls
                    + 6 * cfg.n_layers * eng.stats.decode_steps)
    assert outs["cpu"] == outs[str(cuda)]


# Grouped weight adjoints (G, B, P, Q, k): qwen3-moe-235b-a22b's experts
# in a train step at batch 8 x seq 256 (128 experts, capacity 160 rows;
# wi/wu 12 x 32, wo 32 x 12), a ragged case with a ragged last row chunk,
# and small grids on both transform paths
_GROUPED_DW = [(128, 160, 12, 32, 128), (128, 160, 32, 12, 128),
               (3, 37, 12, 32, 128), (4, 9, 3, 2, 8), (2, 7, 2, 3, 7)]


@pytest.mark.parametrize("G,B,P,Q,k", _GROUPED_DW)
@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("freq_out", [False, True])
def test_grouped_dw_kernel_matches_plain(cuda, G, B, P, Q, k, dtype,
                                         freq_out):
    """One launch for all G groups (the count moves by one), within the
    plain version's tolerance, and a repeat launch bit-identical."""
    gen = torch.Generator().manual_seed(G * 100 + B + k)
    x = torch.randn(G, B, Q * k, generator=gen).to(cuda, dtype)
    g = torch.randn(G, B, P * k, generator=gen).to(cuda, dtype)
    n0 = kernel.LAUNCHES["bc_dw"]
    got = kernel.bc_dw(x, g, P=P, Q=Q, k=k, freq_out=freq_out)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["bc_dw"] == n0 + 1
    ref = kernel.bc_dw_plain(x, g, P=P, Q=Q, k=k, freq_out=freq_out)
    again = kernel.bc_dw(x, g, P=P, Q=Q, k=k, freq_out=freq_out)
    for a, r, a2 in zip(*((t if freq_out else [t])
                          for t in (got, ref, again))):
        assert a.shape == r.shape and a.dtype == torch.float32
        assert _rel(a, r) <= _dw_tol(B)
        assert torch.equal(a, a2)        # fixed-order reduction


def test_grouped_dw_kernel_rejects_what_it_cannot_take(cuda):
    with pytest.raises(ValueError, match="must be"):
        kernel.bc_dw(torch.zeros(3, 4, 16, device=cuda),
                     torch.zeros(2, 4, 16, device=cuda), P=2, Q=2, k=8)
    with pytest.raises(ValueError, match="groups"):
        kernel.bc_dw(torch.zeros(0, 4, 16, device=cuda),
                     torch.zeros(0, 4, 16, device=cuda), P=2, Q=2, k=8)


@pytest.mark.parametrize("path", ["w", "w_freq"])
def test_grouped_function_grads_on_card_match_cpu(cuda, path):
    """The stacked-table Functions on the card: one grouped bc_matmul
    forward and dx and one grouped bc_dw, grads within REL_TOL of the
    CPU's."""
    G, B, p, q, k = 4, 9, 3, 5, 16
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(G, B, q * k, generator=gen)
    bias = torch.randn(G, p * k, generator=gen)
    if path == "w":
        tables = [torch.randn(G, p, q, k, generator=gen) * (q * k) ** -0.5]
    else:
        tables = [torch.randn(G, p, q, k // 2 + 1, generator=gen)
                  for _ in range(2)]
    cot = torch.randn(G, B, p * k, generator=gen)
    out = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_(True) for t in [x, *tables, bias]]
        n0 = dict(kernel.LAUNCHES)
        xs, *ts, b = leaves
        y = ops.block_circulant_matmul(
            xs, ts[0] if path == "w" else None, bias=b, activation="gelu",
            w_freq=tuple(ts) if path == "w_freq" else None, k=k)
        grads = torch.autograd.grad((y * cot.to(dev)).sum(), leaves)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert kernel.LAUNCHES["bc_matmul"] - n0["bc_matmul"] == 2
            assert kernel.LAUNCHES["bc_dw"] - n0["bc_dw"] == 1
        out[str(dev)] = (y.detach(), grads)
    (yc, gc), (yg, gg) = out["cpu"], out[str(cuda)]
    assert _rel(yg, yc) <= REL_TOL
    for a, r in zip(gg, gc):
        assert _rel(a, r) <= REL_TOL


def test_moe_smoke_train_step_on_card_matches_cpu(cuda):
    """qwen3-moe-235b-a22b's smoke config (f32, kernel impl, every layer an
    8-expert MoE) takes one train step on the card and on the CPU from the
    same params and batch: loss and grad norm within REL_TOL x 5 (two
    layers of f32 sums in other orders), with the launches the layers
    give: per layer 2 attention and 3 grouped expert projections, each
    forward and dx, plus the experts' recompute; one bc_dw per
    projection."""
    from repro_torch.configs import qwen3_moe_235b as tm
    from repro_torch.train.loop import make_train_step

    cfg = dataclasses.replace(tm.SMOKE, swm=SWMConfig(block_size=8,
                                                      impl="pallas"))
    params = init_params(build_model(cfg, device="cpu").specs(), 0,
                         device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 17)).astype(np.int32))
    trees = {"cpu": params, cuda: _to(params, cuda)}    # copied first
    out = {}
    for dev in ("cpu", cuda):
        state = init_train_state(trees[dev], TrainConfig())
        step = make_train_step(build_model(cfg, device=dev), cfg,
                               TrainConfig())
        n0 = dict(kernel.LAUNCHES)
        _, m = step(state, {"tokens": tokens.to(dev)})
        if dev != "cpu":
            torch.cuda.synchronize()
            assert kernel.LAUNCHES["bc_matmul"] - n0["bc_matmul"] \
                == cfg.n_layers * (2 * 5 + 3)
            assert kernel.LAUNCHES["bc_dw"] - n0["bc_dw"] == cfg.n_layers * 5
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]))
    (lc, nc), (lg, ng) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 5 * REL_TOL * abs(lc)
    assert abs(ng - nc) <= 5 * REL_TOL * abs(nc)


# 2^-7: one bf16 ulp at the largest magnitude. The dft impl rounds the
# same intermediates to bf16 on both devices; f32 sums in other orders
# (cuBLAS vs the CPU's) can flip one such rounding
_DFT_BF16_TOL = 2.0 ** -7


@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("karatsuba", [False, True])
def test_dft_impl_on_card_matches_cpu(cuda, dtype, karatsuba):
    """``block_circulant_apply(impl="dft")`` and the shared-DFT pair on
    the card against the CPU: values and both grads, qwen3-0.6b's fused
    QKV shape at k = 128."""
    from repro_torch.core import circulant as circ

    gen = torch.Generator().manual_seed(21)
    p, q, k, N = 32, 8, 128, 256
    x = torch.randn(N, q * k, generator=gen).to(dtype)
    w = (torch.randn(p, q, k, generator=gen) / (q * k) ** 0.5).to(dtype)
    w2 = (torch.randn(p, q, k, generator=gen) / (q * k) ** 0.5).to(dtype)
    ct = torch.randn(N, p * k, generator=gen)
    tol = REL_TOL if dtype == _F32 else _DFT_BF16_TOL
    out = {}
    for dev in ("cpu", cuda):
        xs, ws, w2s = (t.to(dev, copy=True).requires_grad_()
                       for t in (x, w, w2))
        y = circ.block_circulant_apply(xs, ws, impl="dft",
                                       karatsuba=karatsuba)
        y1, y2 = circ.block_circulant_apply_pair(xs, ws, w2s)
        c = ct.to(dev)
        ((y.float() * c).sum() + (y1.float() * c).sum()
         + (y2.float() * c).sum()).backward()
        out[str(dev)] = [t.detach().float().cpu()
                         for t in (y, y1, y2, xs.grad, ws.grad, w2s.grad)]
    for a, b in zip(out[str(cuda)], out["cpu"]):
        assert _rel(a, b) <= tol


def test_scan_recompute_grads_on_card_equal_plain_loop(cuda):
    """``chunked_time_scan`` past 256 steps on the card: the per-chunk
    recompute gives the plain loop's grads bit for bit, and its forward
    keeps fewer bytes (only the chunk boundaries)."""
    from repro_torch.nn.scan import chunked_time_scan

    gen = torch.Generator().manual_seed(22)
    T, B, D, N = 515, 2, 64, 16
    h0 = torch.randn(B, D, N, generator=gen)
    dt = torch.rand(T, B, D, generator=gen)
    u = torch.randn(T, B, N, generator=gen)
    A = -torch.rand(D, N, generator=gen)

    def step(h, t):
        dt_t, u_t, a = t
        h = torch.exp(dt_t[..., None] * a) * h + dt_t[..., None] * u_t[:, None]
        return h, torch.einsum("bdn,bn->bd", h, u_t)

    grads, kept = {}, {}
    for remat in (False, True):
        leaves = [t.to(cuda).requires_grad_() for t in (h0, dt, u, A)]
        xs = (leaves[1], leaves[2], leaves[3].expand(T, D, N))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(cuda)
        h, ys = chunked_time_scan(step, leaves[0], xs, chunk=256,
                                  remat=remat)
        kept[remat] = torch.cuda.memory_allocated(cuda) - base
        (h.square().sum() + ys.sin().sum()).backward()
        grads[remat] = [t.grad for t in leaves]
    for g1, g0 in zip(grads[True], grads[False]):
        assert torch.equal(g1, g0)
    assert kept[True] < kept[False]
