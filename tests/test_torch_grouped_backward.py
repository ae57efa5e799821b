"""Port parity: the grouped backward of the block-circulant ops (a MoE
layer's stacked expert tables) against the JAX reference's custom VJPs
under ``jax.vmap``, which run its Pallas kernels in interpret mode on the
CPU, on the same numpy inputs.

Covers: ``ops.block_circulant_matmul`` with stacked time-domain tables
``w (G, p, q, k)`` and frozen f32 tables ``(wr, wi) (G, p, q, K)``, with
and without bias, its outputs and its x, w / (wr, wi) and bias gradients
against ``jax.vmap(jax.grad(...))`` of the reference's op and against G
single-group calls of the port; the grouped ``bc_dw_plain`` against G
single calls; ``_dw_geometry``'s group axis (every (group, row, p, q)
covered once, one wave of blocks); int8 stacked tables still refuse
gradients.

On CPU tensors the Functions run the kernels' plain versions; the grouped
CUDA launches are held against those on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_circulant import ops as jops
from repro_torch.core.quant import quantize_symmetric, symmetric_scales
from repro_torch.kernels.block_circulant import kernel as tkernel
from repro_torch.kernels.block_circulant import ops as tops
from test_torch_bc_dw_geometry import _cover
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

REL_TOL = 2e-5          # fp32 vs fp32 (tests/test_conformance.py REL_TOL)
B, P, Q = 5, 3, 2       # rows per group, output and input blocks


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _inputs(path, G, k, bias):
    """numpy x (G, B, Q·k), the tables and a bias (or None), seeded."""
    K = k // 2 + 1
    x = _rand((G, B, Q * k), 1 + G + k)
    if path == "w":
        tables = [_rand((G, P, Q, k), 2 + G + k, (Q * k) ** -0.5)]
    else:
        tables = [_rand((G, P, Q, K), 3 + G + k), _rand((G, P, Q, K),
                                                        4 + G + k)]
    b = _rand((G, P * k), 5 + G + k) if bias else None
    return x, tables, b


def _act(bias):
    # the fused epilogue runs unfused under autograd: take it with a bias
    return "gelu" if bias else "none"


def _jop(path, k, act):
    if path == "w":
        return lambda x, w, b: jops.block_circulant_matmul(
            x, w, bias=b, activation=act)
    return lambda x, wr, wi, b: jops.block_circulant_matmul(
        x, None, bias=b, activation=act, w_freq=(wr, wi), k=k)


def _top(path, k, act):
    if path == "w":
        return lambda x, w, b: tops.block_circulant_matmul(
            x, w, bias=b, activation=act)
    return lambda x, wr, wi, b: tops.block_circulant_matmul(
        x, None, bias=b, activation=act, w_freq=(wr, wi), k=k)


def _port_grads(path, k, act, x, tables, b, cot):
    """(y, grads of x, the tables and the bias) of one port call."""
    tin = [torch.from_numpy(np.array(a)).requires_grad_(True)
           for a in [x, *tables]]
    tb = None if b is None else torch.from_numpy(np.array(b)
                                                 ).requires_grad_(True)
    y = _top(path, k, act)(*tin, tb)
    leaves = tin + ([] if tb is None else [tb])
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), leaves)
    return y.detach(), grads


CASES = [(path, bias, k, G) for path in ("w", "w_freq")
         for bias in (False, True) for k in (8, 16) for G in (1, 3, 4)]


@pytest.mark.parametrize("path,bias,k,G", CASES)
def test_grouped_grads_match_vmapped_reference(path, bias, k, G):
    """Output and every gradient of the stacked-table op against the
    reference's op under ``jax.vmap(jax.grad(...))`` over the groups."""
    act = _act(bias)
    x, tables, b = _inputs(path, G, k, bias)
    cot = _rand((G, B, P * k), 99)
    n = 1 + len(tables) + bias
    fj = _jop(path, k, act)

    def one(cot_g, *args):
        args = list(args) + [None] * (not bias)
        return jnp.sum(fj(*args) * cot_g)

    jargs = [jnp.asarray(a) for a in [x, *tables] + ([b] if bias else [])]
    jy = jax.vmap(lambda *a: fj(*a, *([None] * (not bias))))(*jargs)
    jg = jax.vmap(jax.grad(one, argnums=tuple(range(1, n + 1))))(
        jnp.asarray(cot), *jargs)
    y, tg = _port_grads(path, k, act, x, tables, b, cot)
    assert y.shape == (G, B, P * k)
    assert _rel(y, jy) <= REL_TOL                    # REL_TOL = 2e-5
    assert len(tg) == len(jg) == n
    for a, r in zip(tg, jg):
        assert a.shape == r.shape
        assert _rel(a, r) <= REL_TOL                 # REL_TOL = 2e-5


@pytest.mark.parametrize("path,bias,k,G", CASES)
def test_grouped_grads_match_single_group_calls(path, bias, k, G):
    """The stacked-table op's output and gradients against G calls of the
    port's single-table op, one per group."""
    act = _act(bias)
    x, tables, b = _inputs(path, G, k, bias)
    cot = _rand((G, B, P * k), 98)
    y, tg = _port_grads(path, k, act, x, tables, b, cot)
    singles = [_port_grads(path, k, act, x[g], [t[g] for t in tables],
                           None if b is None else b[g], cot[g])
               for g in range(G)]
    assert _rel(y, torch.stack([s[0] for s in singles])) <= REL_TOL
    for i, a in enumerate(tg):
        ref = torch.stack([s[1][i] for s in singles])
        assert a.shape == ref.shape
        assert _rel(a, ref) <= REL_TOL               # REL_TOL = 2e-5


@pytest.mark.parametrize("freq_out", [False, True])
@pytest.mark.parametrize("G,Bg,Pg,Qg,k", [(3, 5, 3, 2, 8), (4, 1, 2, 3, 16),
                                          (2, 7, 2, 2, 7)])
def test_grouped_dw_plain_is_g_single_calls(G, Bg, Pg, Qg, k, freq_out):
    """The grouped ``bc_dw_plain`` (what ``bc_dw`` runs on the CPU) equals
    G single calls stacked, in both epilogues."""
    x = torch.from_numpy(_rand((G, Bg, Qg * k), 7))
    g = torch.from_numpy(_rand((G, Bg, Pg * k), 8))
    got = tkernel.bc_dw(x, g, P=Pg, Q=Qg, k=k, freq_out=freq_out)
    singles = [tkernel.bc_dw_plain(x[i], g[i], P=Pg, Q=Qg, k=k,
                                   freq_out=freq_out) for i in range(G)]
    if freq_out:
        K = k // 2 + 1
        for j in range(2):
            assert got[j].shape == (G, Pg, Qg, K)
            assert _rel(got[j], torch.stack([s[j] for s in singles])) \
                <= REL_TOL                           # REL_TOL = 2e-5
    else:
        assert got.shape == (G, Pg, Qg * k)
        assert _rel(got, torch.stack(singles)) <= REL_TOL


@pytest.mark.parametrize("G", [1, 2, 3, 16, 128, 131, 132, 200])
@pytest.mark.parametrize("Bg,Pg,Qg,k", [(160, 12, 32, 128),
                                        (160, 32, 12, 128),
                                        (37, 12, 32, 128), (37, 5, 3, 7),
                                        (2048, 32, 8, 128), (1, 3, 11, 8)])
def test_grouped_geometry_covers_each_group_once_in_one_wave(G, Bg, Pg, Qg,
                                                             k):
    """Every group runs the single adjoint's tiles and row chunks, so each
    (group, row, p, q) is taken exactly once; the blocks of the launch,
    G·tiles·splits, fill at most one wave of the H100's 132 SMs unless one
    split per group already exceeds it (then one split)."""
    geo = tkernel._dw_geometry(Bg, Pg, Qg, k, G)
    one = tkernel._dw_geometry(Bg, Pg, Qg, k)
    assert geo.groups == G and geo.grid[2] == G
    assert geo._replace(splits=0, rows_per_split=0, rows=0, smem_bytes=0,
                        groups=1) == one._replace(
        splits=0, rows_per_split=0, rows=0, smem_bytes=0)
    rows, pq = _cover(geo, Bg, Pg, Qg)
    assert (rows == 1).all() and (pq == 1).all()     # per group, once each
    blocks = geo.grid[0] * geo.grid[1] * geo.grid[2]
    if G * geo.grid[0] <= tkernel._DW_WAVE:
        assert blocks <= tkernel._DW_WAVE
    else:
        assert geo.splits == 1
    if G >= tkernel._DW_WAVE:
        assert geo.splits == 1
    assert geo.smem_bytes <= tkernel._DW_SMEM_BUDGET
    assert geo.splits <= Bg


def test_grouped_geometry_at_the_expert_shapes():
    """qwen3-moe-235b-a22b's expert weight adjoints in a train step at
    batch 8 x seq 256: capacity C = int(2048·8/128·1.25) = 160 rows per
    expert, 128 experts; wi/wu (P, Q) = (12, 32), wo (32, 12). One split
    per expert: 128 groups x 2 tiles = 256 blocks, each expert's 160 rows
    in one range."""
    for P_, Q_ in ((12, 32), (32, 12)):
        geo = tkernel._dw_geometry(160, P_, Q_, 128, 128)
        assert geo.splits == 1 and geo.rows_per_split == 160
        assert geo.grid == (2, 1, 128)


def test_int8_stacked_tables_refuse_gradients():
    """Stacked int8 tables are primal-only, as single ones: the forward
    runs (and equals the dequantized f32 tables' forward), a gradient
    through it raises."""
    G, k = 3, 8
    _, (wr, wi), _ = _inputs("w_freq", G, k, False)
    sc = symmetric_scales(torch.from_numpy(wr), torch.from_numpy(wi))
    qr = quantize_symmetric(torch.from_numpy(wr), sc)
    qi = quantize_symmetric(torch.from_numpy(wi), sc)
    x = torch.from_numpy(_rand((G, B, Q * k), 11)).requires_grad_(True)
    y = tops.block_circulant_matmul(x, None, w_freq=(qr, qi), w_scale=sc,
                                    k=k)
    assert y.shape == (G, B, P * k)
    with torch.no_grad():
        ref = tops.block_circulant_matmul(x, None, w_freq=(qr, qi),
                                          w_scale=sc, k=k)
    assert torch.equal(y.detach(), ref)
    with pytest.raises(NotImplementedError, match="no gradient"):
        y.sum().backward()
