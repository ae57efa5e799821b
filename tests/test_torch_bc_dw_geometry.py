"""bc_dw's FFT formulation and launch geometry, on the CPU.

The CUDA kernel (``csrc/bc_dw.cu``) runs only on the card; what it takes
from the host, and the math it relies on, are checked here:

* the formulation: with X̂ = rfft(x block) and Ĝ = rfft(g block) (the
  kernel's one forward FFT for both, in its slot order, slot 0 packing
  bins 0 and k/2), A = Σ_b Ĝ·conj(X̂) summed split by split as the
  geometry cuts the rows, ``(dwr, dwi) = (g_f/k)·A`` in natural bin order
  and ``dw = irfft(A)``, held against ``bc_dw_plain`` and the JAX
  package's ``_dw_via_kernel`` (Pallas in interpret mode) and
  ``_dw_freq_cotangents``; for k without an FFT path, the same with dense
  DFTs through ``dft_bases``;
* the geometry ``_dw_geometry`` chooses from the shapes: every row and
  every (p, q) block covered exactly once, one tile (each x and g row
  transformed once per launch) at the training shapes, enough blocks at
  2048 rows, shared memory and register sums inside their budgets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_circulant import ops as jops
from repro_torch.core.circulant import dft_bases
from repro_torch.kernels.block_circulant import kernel
from test_torch_bc_geometry import _fft_forward, _fft_inverse, _rel
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

REL_TOL = 2e-5          # fp32 vs fp32 (tests/test_conformance.py REL_TOL)

# (P, Q) of the slice's weight adjoints: fused QKV, o, wi/wu, wo
TRAIN = [(32, 8), (8, 16), (24, 8), (8, 24)]
ROWS = [1, 3, 5, 8, 15, 16, 37, 512, 2048]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _splits(B, geo):
    """The row ranges of the launch, in split order (as bc_dw_partial cuts
    them)."""
    return [range(s * B // geo.splits, (s + 1) * B // geo.splits)
            for s in range(geo.splits)]


def _packed(G, X):
    """Ĝ·conj(X̂) per slot; slot 0 holds the real pairs (bin 0, bin k/2)
    and takes two real products."""
    prod = G * X.conj()
    prod[..., 0] = torch.complex(G[..., 0].real * X[..., 0].real,
                                 G[..., 0].imag * X[..., 0].imag)
    return prod


def _emulate_fft(x, g, P, Q, k, freq_out):
    """bc_dw's FFT path in the kernel's slot order: partial sums per split
    (rows in order), the splits added in order, then the epilogue."""
    B, N = x.shape[0], k // 2
    geo = kernel._dw_geometry(B, P, Q, k)
    X = _fft_forward(x.reshape(B, Q, k), k)                 # (B, Q, N)
    G = _fft_forward(g.reshape(B, P, k), k)                 # (B, P, N)
    A = torch.zeros(P, Q, N, dtype=torch.complex64)
    for rows in _splits(B, geo):
        part = torch.zeros_like(A)
        for b in rows:
            part = part + _packed(G[b, :, None], X[b, None])
        A = A + part
    if not freq_out:
        return _fft_inverse(A, k).reshape(P, Q * k)          # irfft(A)
    n1, n2 = kernel._fft_split(N)
    s = torch.arange(1, N)
    bins = s // n2 + n1 * (s % n2)                          # slot s's bin
    dwr = torch.zeros(P, Q, N + 1)
    dwi = torch.zeros(P, Q, N + 1)
    dwr[..., 0], dwr[..., N] = A[..., 0].real / k, A[..., 0].imag / k
    dwr[..., bins] = A[..., 1:].real * (2 / k)
    dwi[..., bins] = A[..., 1:].imag * (2 / k)
    return dwr, dwi


def _emulate_dense(x, g, P, Q, k, freq_out):
    """bc_dw's dense path: x and g both through C/S, A summed per split,
    dŵ = (g_f/k)·A, folded through C/S."""
    B, K = x.shape[0], k // 2 + 1
    geo = kernel._dw_geometry(B, P, Q, k)
    C, S, _, _ = dft_bases(k)
    xb, gb = x.reshape(B, Q, k), g.reshape(B, P, k)
    X = torch.complex(xb @ C, xb @ S)
    G = torch.complex(gb @ C, gb @ S)
    A = torch.zeros(P, Q, K, dtype=torch.complex64)
    for rows in _splits(B, geo):
        part = torch.zeros_like(A)
        for b in rows:
            part = part + G[b, :, None] * X[b, None].conj()
        A = A + part
    gf = torch.full((K,), 2.0)
    gf[0] = 1.0
    if k % 2 == 0:
        gf[-1] = 1.0
    d = A * (gf / k)
    if freq_out:
        return d.real, d.imag
    return (d.real @ C.T + d.imag @ S.T).reshape(P, Q * k)


@pytest.mark.parametrize("freq_out", [False, True])
@pytest.mark.parametrize("B,P,Q,k", [
    (5, 3, 2, 2), (9, 3, 4, 8), (17, 2, 5, 16), (20, 4, 3, 64),
    (37, 5, 3, 128), (3, 32, 8, 128),
    # dense DFT path: odd k, k = 1, a non-power-of-two even k
    (11, 3, 4, 7), (6, 2, 3, 1), (7, 2, 3, 96)])
def test_formulation_matches_plain_and_reference(B, P, Q, k, freq_out):
    x, g = _rand((B, Q * k), 10 + k), _rand((B, P * k), 20 + k)
    emulate = _emulate_fft if kernel._mm_fft(k) else _emulate_dense
    got = emulate(torch.from_numpy(x), torch.from_numpy(g), P, Q, k,
                  freq_out)
    plain = kernel.bc_dw_plain(torch.from_numpy(x), torch.from_numpy(g),
                               P=P, Q=Q, k=k, freq_out=freq_out)
    ref = jops._dw_via_kernel(jnp.asarray(x), jnp.asarray(g), P, Q, k,
                              interpret=True, freq_out=freq_out)
    if freq_out:
        oracle = jops._dw_freq_cotangents(jnp.asarray(x), jnp.asarray(g),
                                          P, Q, k)
        for i in range(2):
            assert got[i].shape == plain[i].shape == (P, Q, k // 2 + 1)
            assert _rel(got[i], plain[i]) <= REL_TOL
            for want in (ref[i], oracle[i]):
                assert _rel(got[i], torch.from_numpy(np.array(want))) \
                    <= REL_TOL
    else:
        assert got.shape == plain.shape == (P, Q * k)
        assert _rel(got, plain) <= REL_TOL
        want = torch.from_numpy(np.array(ref)).reshape(P, Q * k)
        assert _rel(got, want) <= REL_TOL


def test_formulation_against_float64_rfft():
    """The identities themselves in float64 numpy, independent of the
    port's bases: A = Σ rfft(g)·conj(rfft(x)), dŵ = (g_f/k)·A and
    dw = irfft(A) against the reference's dense definition."""
    for k in (1, 2, 7, 8, 128):
        K = k // 2 + 1
        x, g = _rand((6, 3, k), k), _rand((6, 2, k), 50 + k)
        a = np.arange(k)[:, None] * np.arange(K)[None, :] * 2 * np.pi / k
        gf = np.full(K, 2.0)
        gf[0] = 1.0
        if k % 2 == 0:
            gf[-1] = 1.0
        xh = x @ np.cos(a) - 1j * (x @ np.sin(a))
        gh = (g @ np.cos(a) - 1j * (g @ np.sin(a))) * gf / k  # g @ CiT/SiT
        dwh = np.einsum("bpf,bqf->pqf", gh, xh.conj())
        dw = dwh.real @ np.cos(a).T - dwh.imag @ np.sin(a).T  # CT, ST
        A = np.einsum("bpf,bqf->pqf", np.fft.rfft(g.astype(np.float64)),
                      np.fft.rfft(x.astype(np.float64)).conj())
        np.testing.assert_allclose(gf / k * A, dwh, atol=1e-12)
        np.testing.assert_allclose(np.fft.irfft(A, n=k), dw, atol=1e-12)


def _cover(geo, B, P, Q):
    """How often the launch takes each row (split, then chunk) and sums
    each (p, q) block."""
    rows = np.zeros(B, int)
    for rng in _splits(B, geo):
        assert len(rng) > 0                          # no empty split
        for r0 in range(rng.start, rng.stop, geo.rows):
            rows[r0:min(rng.stop, r0 + geo.rows)] += 1
    pq = np.zeros((P, Q), int)
    tp, tq = geo.tiles
    for t in range(tp * tq):
        p0, q0 = t // tq * geo.p_tile, t % tq * geo.q_tile
        for gp in range(geo.p_groups):
            for gq in range(geo.q_groups):
                for i in range(geo.p_per_thread):
                    for j in range(geo.q_per_thread):
                        p = p0 + gp * geo.p_per_thread + i
                        q = q0 + gq * geo.q_per_thread + j
                        if p < P and q < Q:
                            pq[p, q] += 1
    return rows, pq


@pytest.mark.parametrize("k", [128, 64, 96, 16, 7, 2, 1])
@pytest.mark.parametrize("P,Q", TRAIN + [(16, 8), (5, 3), (3, 11), (1, 1),
                                         (2, 300), (64, 64), (300, 2)])
def test_geometry_covers_each_row_and_block_once(P, Q, k):
    for B in ROWS:
        geo = kernel._dw_geometry(B, P, Q, k)
        rows, pq = _cover(geo, B, P, Q)
        assert (rows == 1).all() and (pq == 1).all()
        assert geo.tiles[0] * geo.p_tile >= P > (geo.tiles[0] - 1) * geo.p_tile
        assert geo.tiles[1] * geo.q_tile >= Q > (geo.tiles[1] - 1) * geo.q_tile
        assert geo.splits <= B
        assert max(map(len, _splits(B, geo))) == geo.rows_per_split
        assert 1 <= geo.rows <= geo.rows_per_split
        assert geo.fft == kernel._mm_fft(k)
        assert geo.slots == (k // 2 if geo.fft else k // 2 + 1)
        # budgets: the kernel's threads, registers and shared memory
        assert geo.p_groups * geo.q_groups * geo.slots <= kernel._DW_THREADS
        assert 1 <= geo.p_per_thread <= kernel._DW_MAX_PT
        assert 1 <= geo.q_per_thread <= kernel._DW_MAX_QT
        assert geo.smem_bytes <= kernel._DW_SMEM_BUDGET
        assert geo.smem_bytes == kernel._dw_smem_bytes(
            k, geo.rows, geo.p_tile + geo.q_tile)
        assert geo.splits <= 65535


@pytest.mark.parametrize("P,Q", TRAIN)
def test_geometry_transforms_each_row_once_at_train_shapes(P, Q):
    """All of P and Q in one tile: each x row and each g row is staged and
    transformed once per launch; at 2048 rows one block on each SM, in one
    wave."""
    for B in ROWS:
        geo = kernel._dw_geometry(B, P, Q, 128)
        assert geo.tiles == (1, 1)
        assert geo.p_tile >= P and geo.q_tile >= Q
        rows, _ = _cover(geo, B, P, Q)
        assert (rows == 1).all()
    geo = kernel._dw_geometry(2048, P, Q, 128)
    assert geo.grid[0] * geo.grid[1] == 132
    # whole threads: every (slot, group) thread of the block holds sums
    assert geo.p_groups * geo.q_groups * geo.slots == kernel._DW_THREADS


@pytest.mark.parametrize("P,Q,side", [(64, 8, "p"), (8, 64, "q"),
                                      (128, 4, "p"), (2, 300, "q")])
def test_geometry_tiles_the_larger_side(P, Q, side):
    """Where P·Q·(k/2) sums do not fit one block, the larger side is cut
    into tiles: only the other operand's rows are transformed again."""
    geo = kernel._dw_geometry(2048, P, Q, 128)
    tp, tq = geo.tiles
    if side == "p":
        assert tp > 1 and tq == 1
    else:
        assert tp == 1 and tq > 1
    assert 132 - tp * tq < geo.grid[0] * geo.grid[1] <= 132   # one wave


def test_geometry_is_deterministic():
    calls = [(B, P, Q, k) for B in ROWS for P, Q in TRAIN + [(5, 3)]
             for k in (128, 96, 7)]
    first = [kernel._dw_geometry.__wrapped__(*c) for c in calls]
    again = [kernel._dw_geometry.__wrapped__(*c) for c in reversed(calls)]
    assert first == list(reversed(again))
    assert [kernel._dw_geometry(*c) for c in calls] == first


def test_geometry_at_the_cnn_train_shape():
    """SWMCNN's conv1 weight adjoint in a train step at batch 128: P = 8,
    Q = r²·q = 100, k = 8 over 128·8·8 = 8192 rows. One tile (each x and g
    row transformed once), 2 x 50 thread groups summing 4 x 2 blocks each
    (the fewest sums per thread that fit), 132 row splits in one wave, and
    a workspace of splits·P·Q·slots·2 f32 = 3.4 MB."""
    B, P, Q, k = 8192, 8, 100, 8
    geo = kernel._dw_geometry(B, P, Q, k)
    rows, pq = _cover(geo, B, P, Q)
    assert (rows == 1).all() and (pq == 1).all()
    assert geo.fft and geo.slots == 4
    assert geo.tiles == (1, 1)
    assert (geo.p_groups, geo.q_groups) == (2, 50)
    assert (geo.p_per_thread, geo.q_per_thread) == (4, 2)
    assert geo.splits == 132 and geo.rows_per_split == 63
    assert geo.smem_bytes <= kernel._DW_SMEM_BUDGET
    assert geo.splits * P * Q * geo.slots * 2 * 4 == 3_379_200


@pytest.mark.parametrize("freq_out", [False, True])
def test_formulation_at_the_cnn_train_shape(freq_out):
    """The kernel's FFT formulation at P = 8, Q = 100, k = 8, split as the
    geometry cuts 8192 rows, against ``bc_dw_plain`` (and 512 rows of it
    against the JAX package's Pallas dw in interpret mode). Sums of B rows:
    the f32 limit scales by B/512, as on the card."""
    P, Q, k = 8, 100, 8
    for B, tol in ((8192, REL_TOL * 8192 / 512), (512, REL_TOL)):
        x, g = _rand((B, Q * k), 31), _rand((B, P * k), 32)
        got = _emulate_fft(torch.from_numpy(x), torch.from_numpy(g), P, Q,
                           k, freq_out)
        plain = kernel.bc_dw_plain(torch.from_numpy(x), torch.from_numpy(g),
                                   P=P, Q=Q, k=k, freq_out=freq_out)
        got, plain = ((got, plain) if freq_out else ((got,), (plain,)))
        for a, b in zip(got, plain):
            assert _rel(a, b) <= tol
    ref = jops._dw_via_kernel(jnp.asarray(x), jnp.asarray(g), P, Q, k,
                              interpret=True, freq_out=freq_out)
    ref = ref if freq_out else (ref.reshape(P, Q * k),)
    for a, r in zip(got, ref):
        assert _rel(a, torch.from_numpy(np.array(r))) <= REL_TOL
