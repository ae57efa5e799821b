"""The kernels as registered ``torch.library`` ops: ``repro_torch::
bc_matmul``, ``repro_torch::bc_dw`` and ``repro_torch::bc_dw_freq``.

``torch.library.opcheck`` (schema, autograd registration, fake tensors,
AOT dispatch) on each op on the CPU, over every variant the port launches:
single and grouped, bias and activation, bf16 x, int8 tables with
``w_scale``, both ``bc_dw`` epilogues and an empty batch. The fake
implementation's outputs on ``meta`` tensors have the CPU outputs' shapes
and dtypes, and a meta tensor never reaches a plain version. The
dispatcher holds a CPU and a CUDA kernel for each op and no composite one,
so a CUDA tensor can only reach the launch. The ``gpu``-marked cases run
``opcheck`` on the card (skipped here). No JAX import: the ops are the
port's own.
"""

import pytest
import torch

from repro_torch.core.quant import quantize_symmetric, symmetric_scales
from repro_torch.kernels.block_circulant import kernel
import test_torch_threads  # noqa: F401  (one thread budget per worker)

OPS = ("bc_matmul", "bc_dw", "bc_dw_freq")


def _rand(shape, seed, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).to(device)


def _matmul_args(G=None, B=5, p=4, q=3, k=8, bias=False, act="none",
                 int8=False, x_dtype=torch.float32, device="cpu"):
    lead = () if G is None else (G,)
    K = k // 2 + 1
    x = _rand(lead + (B, q * k), 0, x_dtype, device)
    wr, wi = (_rand(lead + (p, q, K), s, device=device) for s in (1, 2))
    scale = None
    if int8:
        scale = symmetric_scales(wr, wi)
        wr, wi = quantize_symmetric(wr, scale), quantize_symmetric(wi, scale)
    b = _rand(lead + (p * k,), 3, device=device) if bias else None
    return (x, wr, wi, b, scale, k, act)


def _dw_args(G=None, B=6, P=4, Q=3, k=8, dtype=torch.float32, device="cpu"):
    lead = () if G is None else (G,)
    return (_rand(lead + (B, Q * k), 4, dtype, device),
            _rand(lead + (B, P * k), 5, dtype, device), P, Q, k)


MATMUL_CASES = {
    "single": {},
    "grouped": {"G": 3},
    "bias_gelu": {"bias": True, "act": "gelu"},
    "grouped_bias_relu": {"G": 2, "bias": True, "act": "relu"},
    "bf16": {"x_dtype": torch.bfloat16, "act": "sigmoid"},
    "int8": {"int8": True, "bias": True, "act": "tanh"},
    "grouped_int8": {"G": 2, "int8": True},
    "odd_k": {"k": 7, "q": 2},
    "empty_batch": {"B": 0},
}
DW_CASES = {
    "single": {},
    "grouped": {"G": 3},
    "bf16": {"dtype": torch.bfloat16},
    "odd_k": {"k": 5, "Q": 2},
}


def _args(op, case, device="cpu"):
    if op == "bc_matmul":
        return _matmul_args(device=device, **MATMUL_CASES[case])
    return _dw_args(device=device, **DW_CASES[case])


def _cases(op):
    return MATMUL_CASES if op == "bc_matmul" else DW_CASES


PAIRS = [(op, case) for op in OPS for case in _cases(op)]


@pytest.mark.parametrize("op,case", PAIRS)
def test_opcheck_on_cpu(op, case):
    torch.library.opcheck(kernel.OPS[op], _args(op, case))


def _meta(args):
    return tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)


def _outs(y):
    return y if isinstance(y, tuple) else (y,)


@pytest.mark.parametrize("op,case", PAIRS)
def test_fake_outputs_match_cpu(op, case, monkeypatch):
    args = _args(op, case)
    cpu = _outs(kernel.OPS[op](*args))
    # a meta tensor reaches only the fake implementation
    def no_plain(*a, **kw):
        raise AssertionError("a meta tensor reached a plain version")

    monkeypatch.setattr(kernel, "bc_matmul_plain", no_plain)
    monkeypatch.setattr(kernel, "bc_dw_plain", no_plain)
    meta = _outs(kernel.OPS[op](*_meta(args)))
    assert len(meta) == len(cpu)
    for m, c in zip(meta, cpu):
        assert m.device.type == "meta"
        assert m.shape == c.shape and m.dtype == c.dtype


def test_public_wrappers_are_the_ops():
    """``bc_matmul`` / ``bc_dw`` keep their signatures and return the
    ops' results; an unknown activation still raises before dispatch."""
    x, wr, wi, b, s, k, act = _matmul_args(bias=True, act="relu")
    torch.testing.assert_close(
        kernel.bc_matmul(x, wr, wi, b, k=k, activation=act),
        kernel.bc_matmul_plain(x, wr, wi, b, k=k, activation=act),
        rtol=0, atol=0)
    xd, g, P, Q, k = _dw_args()
    dwr, dwi = kernel.bc_dw(xd, g, P=P, Q=Q, k=k, freq_out=True)
    want = kernel.bc_dw_plain(xd, g, P=P, Q=Q, k=k, freq_out=True)
    assert torch.equal(dwr, want[0]) and torch.equal(dwi, want[1])
    with pytest.raises(ValueError, match="unknown activation"):
        kernel.bc_matmul(x, wr, wi, k=k, activation="swish")


@pytest.mark.parametrize("op", OPS)
def test_dispatcher_holds_no_fallback(op):
    """A CPU and a CUDA kernel and a fake one, and nothing that a CUDA
    tensor could reach instead of the launch."""
    name = f"repro_torch::{op}"
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(name, "CPU") and has(name, "CUDA") and has(name, "Meta")
    for key in ("CompositeImplicitAutograd", "CompositeExplicitAutograd"):
        assert not has(name, key)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("op,case", PAIRS)
def test_opcheck_on_cuda(cuda, op, case):
    torch.library.opcheck(kernel.OPS[op], _args(op, case, device=cuda))
