"""Frozen frequency tables: compute FFT(w) once, launch forever.

The paper's inference dataflow computes FFT(w) once and keeps it resident;
only activations stream through FFT → ∘ → IFFT. ``freeze_params`` walks a
(specs, params) tree pair and replaces every circulant-tagged ``w`` with
``wr`` / ``wi`` = rfft(w), so ``nn.Linear`` takes the frozen kernel path.
It also pre-concatenates the known fused projection groups (attention
Q/K/V along p; the LSTM's gate tables and biases) under ``"_fused"``, so
the fused launch reads one resident table. Conv tap tables (tagged
``conv_taps``) freeze into the (p, r²·q, K) im2col block-table layout.

``quantize="int8"`` stores the frozen tables int8 with one symmetric f32
max-abs scale per (p, q) block (``w_scale``), dequantized in the kernel.

The reference's TPU tile choosers (``plan_geometry``/``choose_blocks``)
have no counterpart: the CUDA kernel picks its own launch geometry and
masks ragged edges, so frozen tables are stored unpadded.

:class:`BCPlan` is one frozen projection (or a stack of projections that
share one input) as an object: :func:`build_plan` / :func:`build_multi_plan`
run rfft(w) once, and ``plan.apply(x)`` is one ``bc_matmul`` launch with
no weight-side work. The port's plans carry no tile padding and no
``interpret`` flag (the reference's Pallas-only fields).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.circulant import concat_biases, split_outputs
from repro_torch.core.quant import (dequantize_symmetric, quantize_symmetric,
                                    symmetric_scales)
from repro_torch.kernels.block_circulant import ops as bc_ops

__all__ = ["BCPlan", "build_plan", "build_multi_plan", "freeze_params",
           "attach_fused",
           "count_frozen_tables", "frozen_table_bytes", "dequantize_frozen",
           "FUSED_KEY", "QUANTIZE_MODES"]

# Legal ``quantize=`` values (and, transitively, ServeEngine / --quantize).
QUANTIZE_MODES = ("off", "int8")

# Reserved param-tree key for a pre-concatenated multi-projection frozen
# group ({"wr", "wi"[, "bias", "w_scale"]}).
FUSED_KEY = "_fused"


def _check_quantize(quantize: str) -> None:
    if quantize not in QUANTIZE_MODES:
        raise ValueError(
            f"quantize={quantize!r}; expected one of {QUANTIZE_MODES}")


@dataclasses.dataclass(frozen=True)
class BCPlan:
    """A frozen frequency-domain plan for one projection, or for N
    projections sharing one input stacked along p (``splits`` their p_i).

    ``wr``/``wi`` ``(p, q, K)`` are f32, or int8 with the per-(p, q) block
    f32 ``scale``, dequantized in the kernel; ``bias`` is ``(p·k,)`` f32 or
    None, and ``activation`` the epilogue."""

    wr: torch.Tensor
    wi: torch.Tensor
    bias: Optional[torch.Tensor]
    k: int
    p: int
    q: int
    splits: Tuple[int, ...]
    activation: str = "none"
    scale: Optional[torch.Tensor] = None

    @property
    def in_dim(self) -> int:
        return self.q * self.k

    @property
    def out_dim(self) -> int:
        return self.p * self.k

    @property
    def n_projections(self) -> int:
        return len(self.splits)

    @property
    def quantized(self) -> bool:
        return self.scale is not None

    def table_bytes(self) -> int:
        """Resident bytes of the frozen tables (and scales when
        quantized)."""
        n = self.wr.nbytes + self.wi.nbytes
        return n + (self.scale.nbytes if self.scale is not None else 0)

    def cache_key(self) -> Tuple:
        """(p, q, k, table dtype name), as the reference's."""
        return (self.p, self.q, self.k,
                str(self.wr.dtype).replace("torch.", ""))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., q·k) -> (..., p·k), the fused epilogue included: one
        ``bc_matmul`` launch, no transform of the tables."""
        return bc_ops.block_circulant_matmul(
            x, None, w_freq=(self.wr, self.wi), w_scale=self.scale,
            bias=self.bias, activation=self.activation, k=self.k, q=self.q)

    __call__ = apply

    def apply_multi(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The stacked projections' outputs: one launch, N outputs."""
        return tuple(split_outputs(self.apply(x), self.splits, self.k))


def build_plan(w: torch.Tensor, *, bias: Optional[torch.Tensor] = None,
               activation: str = "none", quantize: str = "off") -> BCPlan:
    """A plan from a time-domain block table ``w (p, q, k)``: rfft(w) runs
    here, once (call at init or after a checkpoint load, never per step);
    ``quantize="int8"`` stores the tables int8 with per-block scales."""
    _check_quantize(quantize)
    p, q, k = w.shape
    with torch.no_grad():
        wr, wi = bc_ops.freq_weights(w)
        scale = None
        if quantize == "int8":
            wr, wi, scale = _quantize_pair(wr, wi)
        b = None if bias is None else bias.reshape(-1).float().contiguous()
    return BCPlan(wr=wr, wi=wi, bias=b, k=int(k), p=int(p), q=int(q),
                  splits=(int(p),), activation=activation, scale=scale)


def build_multi_plan(ws: Sequence[torch.Tensor], *,
                     biases: Optional[Sequence[Optional[torch.Tensor]]] = None,
                     activation: str = "none",
                     quantize: str = "off") -> BCPlan:
    """N projections of one (q, k) that read the same input, stacked
    along p into ONE plan and one launch (``apply_multi`` splits the
    output). Quantization commutes with the stacking: scales are per
    block."""
    q, k = ws[0].shape[1], ws[0].shape[2]
    for w in ws:
        if tuple(w.shape[1:]) != (q, k):
            raise ValueError(f"multi-plan tables must share (q, k); got "
                             f"{[tuple(w.shape) for w in ws]}")
    splits = tuple(int(w.shape[0]) for w in ws)
    with torch.no_grad():
        w_cat = torch.cat(list(ws), 0)
    plan = build_plan(w_cat, bias=concat_biases(splits, biases, k),
                      activation=activation, quantize=quantize)
    return dataclasses.replace(plan, splits=splits)


def _frozen_pair(d) -> bool:
    return isinstance(d, dict) and "wr" in d and "wi" in d


def _attach_fused(out: Dict[str, Any]) -> bool:
    """Attach a pre-concatenated ``FUSED_KEY`` entry when ``out`` is one of
    the known fused projection groups; returns True if added.

    * attention Q/K/V — sibling frozen ``q``/``k``/``v`` sharing (q, K):
      stacked along the output-block (p) axis;
    * LSTM gates — ``W{g}x``/``W{g}r`` for g in i/f/c/o: each gate's x- and
      recurrent-side tables concatenate along q, the four gates stack along
      p, and the gate biases ``b{g}`` pre-concatenate alongside.

    The per-projection tables stay beside the fused copy. Quantized members
    fuse too: per-block scales concatenate alongside the tables (all or
    none of a group may be quantized).
    """
    if FUSED_KEY in out:
        return False

    def _cat_scales(scales, cat):
        if all(s is not None for s in scales):
            return cat(scales)
        if any(s is not None for s in scales):
            raise ValueError(
                "fused projection group mixes quantized and fp32 frozen "
                "tables; freeze with a single quantize mode")
        return None

    qkv = [out.get(n) for n in ("q", "k", "v")]
    if all(_frozen_pair(d) for d in qkv):
        wrs = [d["wr"] for d in qkv]
        shapes = {tuple(w.shape[:-3]) + tuple(w.shape[-2:]) for w in wrs}
        if all(w.dim() >= 3 for w in wrs) and len(shapes) == 1:
            fused = {"wr": torch.cat(wrs, dim=-3),
                     "wi": torch.cat([d["wi"] for d in qkv], dim=-3)}
            sc = _cat_scales([d.get("w_scale") for d in qkv],
                             lambda ss: torch.cat(ss, dim=-2))
            if sc is not None:
                fused["w_scale"] = sc
            out[FUSED_KEY] = fused
            return True
        return False
    gates = []
    for g in ("i", "f", "c", "o"):
        px, pr, b = out.get(f"W{g}x"), out.get(f"W{g}r"), out.get(f"b{g}")
        if not (_frozen_pair(px) and _frozen_pair(pr) and b is not None):
            return False
        gates.append((px, pr, b))
    x_shapes = {tuple(px["wr"].shape) for px, _, _ in gates}
    r_shapes = {tuple(pr["wr"].shape) for _, pr, _ in gates}
    if len(x_shapes) != 1 or len(r_shapes) != 1:
        return False
    xs, rs = x_shapes.pop(), r_shapes.pop()
    if len(xs) != 3 or len(rs) != 3 or xs[0] != rs[0] or xs[-1] != rs[-1]:
        return False
    fused = {
        "wr": torch.cat([torch.cat([px["wr"], pr["wr"]], dim=-2)
                         for px, pr, _ in gates], dim=-3),
        "wi": torch.cat([torch.cat([px["wi"], pr["wi"]], dim=-2)
                         for px, pr, _ in gates], dim=-3),
        "bias": torch.cat([b.reshape(-1).float() for _, _, b in gates]),
    }
    sc = _cat_scales(
        [s for px, pr, _ in gates
         for s in (px.get("w_scale"), pr.get("w_scale"))],
        lambda ss: torch.cat(
            [torch.cat(ss[2 * i: 2 * i + 2], dim=-1)
             for i in range(len(ss) // 2)], dim=-2))
    if sc is not None:
        fused["w_scale"] = sc
    out[FUSED_KEY] = fused
    return True


def attach_fused(tree):
    """``tree`` with a ``FUSED_KEY`` copy attached, in place, to every
    known fused group of frozen tables that lacks one (a frozen tree cut
    into a rank's shards, ``dist.tensor_parallel.shard_params``, whose
    members' p blocks are this rank's); returns ``tree``."""
    if isinstance(tree, dict):
        for val in tree.values():
            attach_fused(val)
        _attach_fused(tree)
    return tree


def _quantize_pair(wr, wi):
    sc = symmetric_scales(wr, wi)
    return quantize_symmetric(wr, sc), quantize_symmetric(wi, sc), sc


def freeze_params(specs, params, quantize: str = "off") -> Dict[str, Any]:
    """Replace every circulant table with its frozen frequency weights.

    Walks the ParamSpec tree (circulant leaves carry the ``"circulant"``
    tag — see ``nn.Linear.specs``) in lockstep with the param tree; every
    tagged ``w`` is REPLACED by ``wr`` / ``wi`` = rfft(w) (the time-domain
    table is dropped). ``quantize="int8"`` stores the tables int8 with a
    sibling ``w_scale``; an fp32-frozen tree re-frozen with ``"int8"``
    quantizes in place (no new rfft) and a quantized tree passes through
    under either mode. Fused groups get a ``FUSED_KEY`` entry. Idempotent;
    untouched subtrees are returned as the same objects.
    """
    from repro_torch.nn.module import ParamSpec

    _check_quantize(quantize)
    if isinstance(specs, ParamSpec) or not isinstance(specs, dict) \
            or not isinstance(params, dict):
        return params
    out = {}
    dropped = set()
    changed = False
    for key, sub_spec in specs.items():
        sub_param = params[key] if key in params else None
        if (isinstance(sub_spec, ParamSpec) and key == "w"
                and "circulant" in sub_spec.tags):
            if "wr" in params and "wi" in params:       # already frozen
                wr, wi = params["wr"], params["wi"]
                if (quantize == "int8" and "w_scale" not in params
                        and wr.dtype.is_floating_point):
                    wr, wi, out["w_scale"] = _quantize_pair(wr, wi)
                    changed = True
                out["wr"], out["wi"] = wr, wi
            else:
                wr, wi = bc_ops.freq_weights(sub_param)
                if "conv_taps" in sub_spec.tags:
                    # conv tap tables (r², p, q, K) freeze straight into
                    # the (p, r²·q, K) im2col block-table layout the conv
                    # forward launches, so it reshapes no weights
                    t, p, q, K = wr.shape
                    wr = wr.permute(1, 0, 2, 3).reshape(p, t * q, K)
                    wi = wi.permute(1, 0, 2, 3).reshape(p, t * q, K)
                # int8 quantizes after the reshape, so the (p, q) scale
                # grid matches the stored table's block grid
                if quantize == "int8":
                    wr, wi, out["w_scale"] = _quantize_pair(wr, wi)
                out["wr"], out["wi"] = wr, wi
                changed = True
            if "w" in params:
                dropped.add("w")
                changed = True
        else:
            new = freeze_params(sub_spec, sub_param, quantize)
            out[key] = new
            changed = changed or (new is not sub_param)
    # params-only keys (already-frozen trees) stay
    for key in params:
        if key in out or key in dropped:
            continue
        if (key == FUSED_KEY and quantize == "int8"
                and isinstance(params[key], dict)
                and "w_scale" not in params[key]):
            # stale fp32 fused group over members just re-quantized above
            changed = True
            continue
        out[key] = params[key]
    changed = _attach_fused(out) or changed
    return out if changed else params


def frozen_table_bytes(params) -> int:
    """Resident bytes of every frozen table in a param tree: all ``wr`` /
    ``wi`` pairs (fused copies included) plus any ``w_scale`` leaves."""
    if not isinstance(params, dict):
        return 0
    n = 0
    for key in ("wr", "wi", "w_scale"):
        if key in params and isinstance(params[key], torch.Tensor):
            n += int(params[key].nbytes)
    return n + sum(frozen_table_bytes(v) for v in params.values()
                   if isinstance(v, dict))


def dequantize_frozen(params):
    """int8-frozen tree -> the equivalent fp32-frozen tree: every
    ``(wr, wi, w_scale)`` triple becomes a ``dequantize_symmetric`` f32
    pair without the scale. Non-dict subtrees pass through."""
    if not isinstance(params, dict):
        return params
    out = {}
    for key, val in params.items():
        if key == "w_scale" and "wr" in params:
            continue
        if key in ("wr", "wi") and "w_scale" in params:
            out[key] = dequantize_symmetric(val, params["w_scale"])
        else:
            out[key] = dequantize_frozen(val)
    return out


def count_frozen_tables(params) -> int:
    """Number of frozen ``wr``/``wi`` pairs in a param tree — the rfft(w)
    transforms ``freeze_params`` performed (``FUSED_KEY`` copies skipped)."""
    if not isinstance(params, dict):
        return 0
    n = 1 if ("wr" in params and "wi" in params) else 0
    return n + sum(count_frozen_tables(v) for key, v in params.items()
                   if key != FUSED_KEY)
