"""Parameter specs and the param-tree view of the port's modules.

Every leaf is declared up front as a :class:`ParamSpec` (shape, dtype,
initializer, tags); ``init_params`` materializes a spec tree into a nested
dict of tensors with explicit ``torch.Generator``s.

The port's modules are ``nn.Module``s that hold their tensors as buffers
named by the reference's leaf keys (``w``, ``wr``, ``wi``, ``w_scale``,
``scale``, ``table``) and their sub-dicts as child modules (``q``, ``ffn_dense``,
``_fused``, ...). :func:`module_tree` reads a module as such a nested dict
and :func:`load_tree` installs one (no copies), so tree functions like
``plan.freeze_params`` apply to a live model. Layers are per-layer modules
(``layers.<i>``); the reference's stacked layout is ``convert``'s concern.

Training takes the same buffers as leaf tensors that require grad and
updates them in place; :func:`tree_leaves` / :func:`tree_map` walk a param
tree (or a grad or moment tree keyed like it) in one fixed order, sorted
keys, as ``jax.tree`` walks the reference's dicts.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import torch_dtype
from repro_torch.device import resolve_device

__all__ = ["ParamSpec", "ParamDict", "init_params", "map_specs",
           "param_count", "param_bytes", "module_tree", "load_tree",
           "tree_leaves", "tree_map"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of a single parameter tensor.

    shape: full shape. dtype: storage dtype. init: "normal" | "zeros" |
    "ones" | "uniform" | "mamba_a_log". scale: std of "normal", bound of
    "uniform" (values in [-scale, scale)). "mamba_a_log" is Mamba's S4D-real
    rule, ``log(1..d_state)`` broadcast over the shape's last axis (the
    reference's ``A_log`` initializer); it takes no randomness, and a random
    ``A_log`` lets the state diverge. tags: markers read by tooling
    ("circulant" lets ``plan.freeze_params`` find SWM tables). axes: the
    logical axis name of each dim (``None`` = never sharded), read by the
    rule table in :mod:`repro_torch.dist.sharding`; ``()`` declares none.
    The reference's leaves carry a leading ``"layers"`` axis in a repeated
    group; the port's per-layer leaves do not.
    """

    shape: tuple
    dtype: Any = torch.float32
    init: str = "normal"
    scale: float = 0.02
    tags: tuple = ()
    axes: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))
        object.__setattr__(self, "tags", tuple(self.tags))
        object.__setattr__(self, "axes", tuple(self.axes))
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} must match shape "
                             f"{self.shape} rank")

    def materialize(self, gen: torch.Generator, device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        if self.init == "normal":
            x = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                            device=device)
            return (x * self.scale).to(self.dtype)
        if self.init == "uniform":
            x = torch.rand(self.shape, generator=gen, dtype=torch.float32,
                           device=device)
            return ((2.0 * x - 1.0) * self.scale).to(self.dtype)
        if self.init == "mamba_a_log":
            a = torch.arange(1, self.shape[-1] + 1, dtype=torch.float32,
                             device=device)
            return torch.log(a).expand(self.shape).to(self.dtype).clone()
        raise ValueError(f"unknown init {self.init!r}")


def _walk(tree, path=()):
    if isinstance(tree, ParamSpec):
        yield path, tree
        return
    if isinstance(tree, Mapping):
        for k in sorted(tree.keys()):
            yield from _walk(tree[k], path + (k,))
        return
    if tree is None:
        return
    raise TypeError(f"spec trees are nested dicts of ParamSpec; got "
                    f"{type(tree)} at {path}")


def map_specs(fn: Callable, tree):
    """Structure-preserving map over a spec tree; fn(path, spec) -> leaf."""
    def rec(t, path):
        if isinstance(t, ParamSpec):
            return fn(path, t)
        if isinstance(t, Mapping):
            return {k: rec(v, path + (k,)) for k, v in t.items()}
        if t is None:
            return None
        raise TypeError(f"bad spec tree node {type(t)} at {path}")

    return rec(tree, ())


def _path_seed(seed: int, path) -> int:
    """Deterministic per-path generator seed: the root seed and a stable
    hash of the path string."""
    h = int.from_bytes(hashlib.blake2b("/".join(map(str, path)).encode(),
                                       digest_size=4).digest(), "big")
    return (int(seed) << 32) | h


def init_params(specs, seed: int = 0, device="cuda"):
    """Materialize a spec tree into a tensor tree on ``device`` (default
    ``"cuda"``; raises without CUDA unless ``device="cpu"``). Deterministic
    in the seed for a given device type."""
    dev = resolve_device(device)

    def make(path, spec):
        gen = torch.Generator(device=dev)
        gen.manual_seed(_path_seed(seed, path))
        return spec.materialize(gen, dev)

    return map_specs(make, specs)


def tree_leaves(tree) -> list:
    """Leaves of a nested-dict tree, keys sorted at every level."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same keys); same structure, keys sorted."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def param_count(specs) -> int:
    return sum(int(np.prod(s.shape)) for _, s in _walk(specs))


def param_bytes(specs) -> int:
    """Storage bytes of a spec tree (each leaf at its dtype's width)."""
    return sum(int(np.prod(s.shape)) * s.dtype.itemsize
               for _, s in _walk(specs))


# ---------------------------------------------------------------------------
# Module <-> param tree
# ---------------------------------------------------------------------------


class ParamDict(nn.Module):
    """A plain sub-dict of a param tree (e.g. the ``_fused`` group):
    buffers and child nodes only, no forward."""


def module_tree(module: nn.Module) -> dict:
    """The module's tensors as a nested dict keyed like the reference's
    param tree (the live buffers — no copies)."""
    out = {k: v for k, v in module._buffers.items() if v is not None}
    for name, child in module._modules.items():
        out[name] = module_tree(child)
    return out


def load_tree(module: nn.Module, tree: dict) -> nn.Module:
    """Install ``tree``'s tensors as the module's buffers (no copies).

    Buffers absent from ``tree`` are dropped (a frozen tree replaces ``w``
    with ``wr``/``wi``); sub-dicts with no child module become
    :class:`ParamDict` nodes; a structural child the tree lacks raises.
    """
    for key in [k for k in module._buffers if k not in tree]:
        del module._buffers[key]
    for key, val in tree.items():
        if isinstance(val, Mapping):
            child = module._modules.get(key)
            if child is None:
                child = ParamDict()
                module.add_module(key, child)
            load_tree(child, val)
        elif isinstance(val, torch.Tensor):
            module.register_buffer(key, val)
        else:
            raise TypeError(f"param tree leaf {key!r} is {type(val)}, "
                            f"not a tensor")
    for key in [k for k in module._modules if k not in tree]:
        if not isinstance(module._modules[key], ParamDict):
            raise KeyError(f"param tree has no entry for submodule {key!r}")
        del module._modules[key]
    return module
