"""bc_matmul's launch geometry and FFT index order, on the CPU.

The CUDA kernel (``csrc/bc_matmul.cu``) runs only on the card; what it
takes from the host is checked here: the geometry ``_mm_geometry`` chooses
from the shapes (every row and output block covered exactly once, at least
P blocks at decode, shared memory inside the budget), and the twiddle table
``fft_twiddles``, driven through the kernel's real FFT written below in
torch in its index order (a four-step k/2-point FFT whose small DFTs and
twiddles all come from the table, slots in the order it leaves them, slot
0 packing bins 0 and k/2), held against the ``dft_bases`` products with
irfft's treatment of bins 0 and k/2.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.circulant import dft_bases
from repro_torch.kernels.block_circulant import kernel
import test_torch_threads  # noqa: F401  (one thread budget per worker)

REL_TOL = 2e-5          # fp32 vs fp32 (tests/test_conformance.py REL_TOL)

# the shapes the main path launches: qwen3-0.6b's projections at k = 128
# (forward p x q, and dx on the transposed grid), plus small ragged ones
SLICE = [(32, 8), (8, 16), (24, 8), (8, 24), (8, 32), (16, 8)]
ROWS = [1, 2, 3, 4, 8, 32, 37, 512, 2048]


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


def _tw(k):
    t = kernel.fft_twiddles(k)
    return torch.complex(t[:, 0], t[:, 1])


def _dft(M, k, inverse=False):
    """M-point DFT matrix from the twiddle table: e^{-2πi·ab/M} is row
    (k/M)·ab mod k."""
    a = torch.arange(M)
    m = _tw(k)[(k // M) * a[:, None] * a[None, :] % k]
    return m.conj() if inverse else m


def _slot(f, N):
    """Slot that holds bin f (< N) after the kernel's four-step FFT."""
    n1, n2 = kernel._fft_split(N)
    return n2 * (f % n1) + f // n1


def _fft_forward(x, k):
    """x (..., k) f32 -> (..., k/2) slots as the kernel holds them: the
    four-step FFT of z[n] = (x[2n], x[2n+1]) leaves bin f1 + N1·f2 in slot
    N2·f1 + f2; the split step; slot 0 is (X_0, X_{k/2}) as (re, im)."""
    N, w = k // 2, _tw(k)
    n1, n2 = kernel._fft_split(N)
    z = torch.complex(x[..., 0::2], x[..., 1::2]).reshape(
        *x.shape[:-1], n1, n2)                            # z[N2·a + b]
    A = torch.einsum("...ab,af->...fb", z, _dft(n1, k))   # N1-point DFTs
    A = A * w[2 * torch.arange(n1)[:, None] * torch.arange(n2)[None, :]]
    z = torch.einsum("...fb,bg->...fg", A, _dft(n2, k)).reshape(
        *x.shape[:-1], N)                                 # N2-point DFTs
    out = z.clone()
    out[..., 0] = torch.complex(z[..., 0].real + z[..., 0].imag,
                                z[..., 0].real - z[..., 0].imag)
    for f in range(1, N // 2 + 1):       # split step
        pf, pm = _slot(f, N), _slot(N - f, N)
        zf, zm = z[..., pf], z[..., pm]
        E = (zf + zm.conj()) / 2
        T = w[f] * (-0.5j) * (zf - zm.conj())
        out[..., pm] = (E - T).conj()
        out[..., pf] = E + T             # pf == pm at f = N/2
    return out


def _fft_inverse(Y, k):
    """Slots (..., k/2) in the kernel's order -> y (..., k) f32."""
    N, w = k // 2, _tw(k)
    n1, n2 = kernel._fft_split(N)
    z = Y.clone()
    z[..., 0] = torch.complex(Y[..., 0].real + Y[..., 0].imag,
                              Y[..., 0].real - Y[..., 0].imag)
    for f in range(1, N // 2 + 1):       # inverse split step
        pf, pm = _slot(f, N), _slot(N - f, N)
        yf, ym = Y[..., pf], Y[..., pm]
        E = yf + ym.conj()
        O = (yf - ym.conj()) * w[f].conj()
        z[..., pm] = E.conj() + 1j * O.conj()
        z[..., pf] = E + 1j * O
    z = z.reshape(*Y.shape[:-1], n1, n2)                  # [f1, f2]
    Bm = torch.einsum("...fg,gb->...fb", z, _dft(n2, k, inverse=True))
    Bm = Bm * w[2 * torch.arange(n1)[:, None]
                * torch.arange(n2)[None, :]].conj()
    z = torch.einsum("...fb,fa->...ab", Bm, _dft(n1, k, inverse=True))
    z = z.reshape(*Y.shape[:-1], N)                       # natural order
    return torch.stack([z.real, z.imag], dim=-1).reshape(*z.shape[:-1],
                                                         k) / k


def _to_slots(re, im, k):
    """Bins (..., K) -> the kernel's slots; the imaginary parts at bins 0
    and k/2 are dropped, as irfft drops them."""
    N = k // 2
    n1, n2 = kernel._fft_split(N)
    s = torch.arange(N)
    bins = s // n2 + n1 * (s % n2)
    out = torch.complex(re[..., bins], im[..., bins])
    out[..., 0] = torch.complex(re[..., 0], re[..., N])
    return out


@pytest.mark.parametrize("k", [2, 8, 16, 64, 128])
def test_fft_forward_matches_dft_bases(k):
    C, S, _, _ = dft_bases(k)
    x = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (5, k)).astype(np.float32))
    got = _fft_forward(x, k)
    want = _to_slots(x @ C, x @ S, k)
    assert _rel(torch.view_as_real(got), torch.view_as_real(want)) <= REL_TOL


@pytest.mark.parametrize("k", [2, 8, 16, 64, 128])
def test_fft_inverse_matches_dft_bases(k):
    """Random spectra, non-zero imaginary parts at bins 0 and k/2
    included (random tables have them; a real w never does)."""
    K = k // 2 + 1
    _, _, Ci, Si = dft_bases(k)
    rng = np.random.default_rng(100 + k)
    yr, yi = (torch.from_numpy(rng.standard_normal((5, K)).astype(
        np.float32)) for _ in range(2))
    assert float(yi[:, 0].abs().min()) > 0 and float(yi[:, -1].abs().min()) > 0
    got = _fft_inverse(_to_slots(yr, yi, k), k)
    assert _rel(got, yr @ Ci + yi @ Si) <= REL_TOL


@pytest.mark.parametrize("k", [2, 8, 16, 64, 128])
def test_fft_round_trip_matches_numpy_rfft(k):
    """The kernel-order FFT pair against float64 numpy: x -> per-bin
    product with a real block's rfft -> irfft, i.e. a circular
    convolution."""
    rng = np.random.default_rng(200 + k)
    x = rng.standard_normal((3, k)).astype(np.float32)
    w = rng.standard_normal(k).astype(np.float32)
    wf = np.fft.rfft(w.astype(np.float64))
    ws = _to_slots(torch.from_numpy(wf.real.astype(np.float32)),
                   torch.from_numpy(wf.imag.astype(np.float32)), k)
    xs = _fft_forward(torch.from_numpy(x), k)
    prod = xs * ws
    prod[..., 0] = torch.complex(xs[..., 0].real * ws[0].real,
                                 xs[..., 0].imag * ws[0].imag)
    got = _fft_inverse(prod, k)
    want = np.fft.irfft(np.fft.rfft(x.astype(np.float64)) * wf, n=k)
    assert _rel(got, torch.from_numpy(want)) <= REL_TOL


def test_twiddles_are_the_float64_table_cast_once():
    for k in (2, 8, 128):
        t = kernel.fft_twiddles(k)
        ang = 2 * np.pi * np.arange(k) / k
        assert t.dtype == torch.float32 and t.shape == (k, 2)
        np.testing.assert_array_equal(
            t.numpy(), np.stack([np.cos(ang), -np.sin(ang)], -1).astype(
                np.float32))
        assert kernel.fft_twiddles(k) is t          # cached per (k, device)


def _cover(g, B, P, Q):
    """How often the launch touches each (row, output block) and, for each
    output block a thread owns in a pass, each q step."""
    rows = np.zeros(B, int)
    outs = np.zeros((B, P), int)
    for bx in range(g.grid[0]):
        r = np.arange(bx * g.rows, min(B, (bx + 1) * g.rows))
        rows[r] += 1
        for by in range(g.grid[1]):
            pend = min(P, (by + 1) * g.p_group)
            for pas in range(0, g.p_group, g.p_pass):
                for pi in range(g.p_inner):
                    for j in range(g.p_per_thread):
                        p = by * g.p_group + pas + pi + j * g.p_inner
                        if p < pend:
                            outs[r, p] += 1
    qs = np.zeros(Q, int)                       # one thread's q groups
    for c in range(0, Q, g.q_chunk):
        for qg in range(g.q_groups):
            qs[np.arange(c + qg, min(Q, c + g.q_chunk), g.q_groups)] += 1
    return rows, outs, qs


@pytest.mark.parametrize("k", [128, 64, 96, 16, 7, 1])
@pytest.mark.parametrize("P,Q", SLICE + [(5, 3), (3, 11), (1, 1), (2, 300)])
def test_geometry_covers_each_row_and_block_once(P, Q, k):
    for B in ROWS:
        g = kernel._mm_geometry(B, P, Q, k)
        rows, outs, qs = _cover(g, B, P, Q)
        assert (rows == 1).all() and (outs == 1).all()
        assert (qs == 1).all()
        assert g.grid[0] * g.rows >= B > (g.grid[0] - 1) * g.rows
        assert g.grid[1] * g.p_group >= P > (g.grid[1] - 1) * g.p_group
        assert 1 <= g.rows <= kernel._MM_MAX_ROWS
        assert 1 <= g.p_per_thread <= kernel._MM_MAX_J
        assert g.p_inner * g.q_groups * g.slots <= kernel._MM_THREADS
        assert g.smem_bytes <= kernel._MM_SMEM_BUDGET
        assert g.fft == (k in (2, 4, 8, 16, 32, 64, 128))
        assert g.slots == (k // 2 if g.fft else k // 2 + 1)


@pytest.mark.parametrize("P,Q", SLICE)
def test_geometry_gives_p_blocks_at_decode(P, Q):
    for B in (1, 2, 3, 4):
        g = kernel._mm_geometry(B, P, Q, 128)
        assert g.grid[0] * g.grid[1] >= P
        assert g.q_chunk == Q            # x staged and transformed once


@pytest.mark.parametrize("P,Q", SLICE)
def test_geometry_keeps_output_blocks_together_at_large_b(P, Q):
    """At large B a block fills whole passes of its threads, so each x row
    is transformed at most P / p_pass times, while every SM has work."""
    for B in (512, 2048):
        g = kernel._mm_geometry(B, P, Q, 128)
        assert g.p_group % g.p_pass == 0
        assert g.grid[1] <= -(-P // g.p_pass)
        assert g.grid[0] * g.grid[1] >= 132


def test_geometry_is_deterministic():
    calls = [(B, P, Q, k) for B in ROWS for P, Q in SLICE
             for k in (128, 96, 7)]
    first = [kernel._mm_geometry.__wrapped__(*c) for c in calls]
    again = [kernel._mm_geometry.__wrapped__(*c) for c in reversed(calls)]
    assert first == list(reversed(again))
    assert [kernel._mm_geometry(*c) for c in calls] == first


def _emulate(x, wr, wi, bias, k):
    """bc_matmul's FFT path in the kernel's order and grouping: slots from
    the FFT above, per-bin products summed per q group and the groups'
    partials added in order, then the inverse and the bias."""
    B, p, q = x.shape[0], wr.shape[0], wr.shape[1]
    g = kernel._mm_geometry(B, p, q, k)
    xs = _fft_forward(x.reshape(B, q, k), k)                 # (B, q, N)
    ws = _to_slots(wr, wi, k)                                # (p, q, N)
    acc = torch.zeros(B, p, k // 2, dtype=torch.complex64)
    for qg in range(g.q_groups):
        part = torch.zeros_like(acc)
        for c in range(0, q, g.q_chunk):
            for j in range(c + qg, min(q, c + g.q_chunk), g.q_groups):
                prod = xs[:, None, j] * ws[None, :, j]
                prod[..., 0] = torch.complex(
                    xs[:, None, j, 0].real * ws[None, :, j, 0].real,
                    xs[:, None, j, 0].imag * ws[None, :, j, 0].imag)
                part = part + prod
        acc = acc + part
    return _fft_inverse(acc, k).reshape(B, p * k) + bias


@pytest.mark.parametrize("B,p,q,k", [(4, 32, 8, 128), (37, 5, 3, 64),
                                     (9, 3, 11, 8), (13, 2, 2, 16),
                                     (3, 2, 5, 2), (512, 3, 2, 32)])
def test_kernel_order_emulation_matches_plain(B, p, q, k):
    """The FFT path in the kernel's slot order and q-group order against
    ``bc_matmul_plain`` (DFT-as-matmul), random tables with non-zero
    imaginary parts at bins 0 and k/2."""
    rng = np.random.default_rng(B + p + q + k)
    K = k // 2 + 1
    t = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((B, q * k), (p, q, K), (p, q, K), (p * k,))]
    x, wr, wi, bias = t
    got = _emulate(x, wr, wi, bias, k)
    want = kernel.bc_matmul_plain(x, wr, wi, bias, k=k)
    assert _rel(got, want) <= REL_TOL


# The paper models' launches (B, p, q, k) on the card: SWMMLP fc0/fc1 at
# B = 64; ASICNet's 512-wide layers at B = 256; SWMCNN's conv1 im2col table
# (p = 8, r²·q = 25·4) at B·8·8 rows (B = 8 forward, B = 128 train) and
# its dx on the transposed grid; SWMLSTM's fused gates and Wym at B = 4,
# k = 16 and 8
PAPER = [(64, 32, 49, 16), (64, 8, 8, 64), (256, 8, 8, 64), (256, 1, 8, 64),
         (512, 8, 100, 8), (8192, 8, 100, 8), (8192, 100, 8, 8),
         (4, 256, 42, 16), (4, 256, 64, 16), (4, 32, 64, 16),
         (4, 512, 84, 8), (4, 512, 128, 8), (4, 64, 128, 8)]


@pytest.mark.parametrize("B,P,Q,k", PAPER)
def test_geometry_at_paper_shapes(B, P, Q, k):
    """Every row, output block and q block once; the FFT path; shared
    memory inside the budget; the q range in one chunk (each x row staged
    and transformed once per block); enough blocks to fill the card where
    the shape has that many output blocks."""
    g = kernel._mm_geometry(B, P, Q, k)
    rows, outs, qs = _cover(g, B, P, Q)
    assert (rows == 1).all() and (outs == 1).all() and (qs == 1).all()
    assert g.fft and g.slots == k // 2
    assert g.p_inner * g.q_groups * g.slots <= kernel._MM_THREADS
    assert g.smem_bytes <= kernel._MM_SMEM_BUDGET
    assert g.q_chunk == Q
    assert g.grid[0] * g.grid[1] >= min(132, -(-B // g.rows) * P)


@pytest.mark.parametrize("B,p,q,k", [(64, 32, 49, 16), (512, 8, 100, 8),
                                     (8192, 100, 8, 8), (4, 512, 128, 8),
                                     (4, 256, 42, 16)])
def test_kernel_order_emulation_at_paper_shapes(B, p, q, k):
    """The FFT path in the kernel's slot order and q-group order at the
    paper models' shapes (the 8 x 100 conv table at k = 8 and its dx, the
    LSTM's 512-block gate table) against ``bc_matmul_plain``."""
    rng = np.random.default_rng(B + p + q + k)
    K = k // 2 + 1
    t = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((B, q * k), (p, q, K), (p, q, K), (p * k,))]
    x, wr, wi, bias = t
    got = _emulate(x, wr, wi, bias, k)
    want = kernel.bc_matmul_plain(x, wr, wi, bias, k=k)
    assert _rel(got, want) <= REL_TOL


# The recurrent hybrids' launches (P, Q) at k = 128: jamba's fused QKV, o,
# Mamba in_proj and out_proj, the FFN's and the experts' wi/wu and wo at
# d_ff 14336 (p or q = 112); rwkv6's time mix shares o's shape, its
# channel mix the FFN's. A grouped launch runs one product's geometry per
# group, so these are its geometries too. Rows: decode 1..4 and the
# prefill buckets' rows up to 4 x 128
HYBRID = [(48, 32), (32, 32), (128, 32), (32, 64), (112, 32), (32, 112)]


@pytest.mark.parametrize("P,Q", HYBRID)
def test_geometry_at_hybrid_shapes(P, Q):
    """Every row and output block once, and the host's shared-memory size
    (the mirror of the kernel's ``Layout``, which a launch checks) within
    the budget at p = 112, q = 112 and p = 128."""
    for B in (1, 2, 3, 4, 8, 16, 32, 64, 128, 512):
        g = kernel._mm_geometry(B, P, Q, 128)
        rows, outs, qs = _cover(g, B, P, Q)
        assert (rows == 1).all() and (outs == 1).all() and (qs == 1).all()
        assert g.fft and g.smem_bytes <= kernel._MM_SMEM_BUDGET
        assert g.smem_bytes == kernel._mm_smem_bytes(
            128, g.rows, g.q_chunk, g.q_groups, g.p_pass)
        assert g.p_inner * g.q_groups * g.slots <= kernel._MM_THREADS


@pytest.mark.parametrize("B,p,q", [(4, 112, 32), (32, 32, 112), (1, 32, 112),
                                   (8, 128, 32)])
def test_kernel_order_emulation_at_hybrid_shapes(B, p, q):
    """The FFT path in the kernel's slot and q-group order at the hybrid
    shapes, against the plain version."""
    rng = np.random.default_rng(B + p + q)
    k, K = 128, 65
    t = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((B, q * k), (p, q, K), (p, q, K), (p * k,))]
    x, wr, wi, bias = t
    assert _rel(_emulate(x, wr, wi, bias, k),
                kernel.bc_matmul_plain(x, wr, wi, bias, k=k)) <= REL_TOL
