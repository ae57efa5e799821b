"""Atomic, async checkpointing in the reference's on-disk format.

Layout:  <dir>/step_<N>/
            MANIFEST.json           tree structure, shapes, dtypes
            <flat-path>.<shard>.npy one file per shard per leaf
         <dir>/LATEST               atomic pointer (tmp+rename)

The layout is the reference's (``repro.ft.checkpoint``) file for file, so
each package reads what the other wrote: dotted flat paths over sorted
dict keys, ``dtype`` under numpy's names (``"float32"``, ``"bfloat16"``),
a bfloat16 leaf written as an f32 file (numpy has no bfloat16 of its own)
and read back as ``torch.bfloat16``.

* the step directory is written under a ``.tmp`` name and renamed only
  after every leaf and the manifest are written, so a crash never leaves
  a half checkpoint visible; stale ``step_*.tmp`` directories are swept at
  the next save;
* leaves are tensors (on any device), numpy arrays or Python ints; the
  port writes one shard per leaf and reads any number of shards;
* :class:`AsyncCheckpointer` copies the state to host memory before
  ``save`` returns (a device-to-host copy on the card; a clone on the CPU,
  where ``Tensor.cpu()`` would alias the live tensor that the next train
  step updates in place), then serializes on a background thread.

``save_checkpoint(shardings=, mesh=)`` saves a state held as this rank's
shards (the parallel train step's ``state_shardings``) whole, in the same
layout: every rank calls it, each sharded leaf is gathered whole in turn
(``dist.sharding.gather_to``: to rank 0's host memory, and rank 0 writes
it). :func:`gather_state` takes the same route for a writer of its own
(``ft.TrainDriver``'s async checkpointer): the whole state on rank 0.
``restore_checkpoint(shardings=, mesh=)`` is elastic restore: it reads a
checkpoint written from any mesh and returns each leaf as this rank's
shard on the current one (``dist.sharding.local_slices``), reading only
the rows of that shard from each file (memory-mapped).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import full_shape, gather_to, local_slices

__all__ = ["save_checkpoint", "gather_state", "restore_checkpoint",
           "latest_step", "available_steps", "AsyncCheckpointer"]


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield ".".join(prefix), tree


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split(".")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _dtype_name(leaf) -> str:
    """numpy's name for the leaf's dtype, as the reference writes it
    (a Python int is an int32 there: ``jnp.asarray(int)``)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    if isinstance(leaf, (np.ndarray, np.generic)):
        return str(leaf.dtype)
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return "int32"
    raise TypeError(f"checkpoint leaf of type {type(leaf).__name__}: "
                    f"tensors, numpy arrays and Python ints only")


def _host_array(leaf) -> np.ndarray:
    """The leaf as a host numpy array; bfloat16 widened to f32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    data = np.asarray(leaf)
    if data.dtype.name == "bfloat16":
        data = data.astype(np.float32)
    return data


def _whole_leaves(state, shardings, mesh):
    """``(path, leaf)`` of ``state`` in flat order, each leaf whole: with
    ``shardings`` (per-dim specs keyed like the state; a missing subtree
    means whole) and ``mesh``, ``state`` is this rank's shard of each
    leaf, and a sharded leaf is gathered whole in host memory on rank 0
    (None on the others), one leaf at a time (``dist.sharding.gather_to``:
    a collective every rank of the mesh joins)."""
    specs = dict(_flatten(shardings)) if mesh is not None else {}
    for path, leaf in _flatten(state):
        spec = specs.get(path)
        if spec and isinstance(leaf, torch.Tensor):
            leaf = gather_to(leaf, full_shape(leaf.shape, spec, mesh), spec,
                             mesh)
        yield path, leaf


def gather_state(state, shardings, mesh):
    """``state``, held as this rank's shards under ``shardings`` on
    ``mesh``, made whole on rank 0 (its sharded leaves in host memory);
    None on every other rank. Every rank of the mesh calls it."""
    import torch.distributed as dist

    flat = dict(_whole_leaves(state, shardings, mesh))
    return _unflatten(flat) if dist.get_rank() == 0 else None


def save_checkpoint(ckpt_dir: str, step: int, state, shardings=None,
                    mesh=None) -> str:
    """Write ``state`` (nested dicts of leaves) for ``step``. Atomic.

    With ``shardings`` and ``mesh``, ``state`` is this rank's shard of
    each leaf and every rank of the mesh calls this: the leaves are
    gathered whole on rank 0 one at a time (:func:`gather_state`'s route)
    and rank 0 writes each as it comes; every rank returns once the
    checkpoint is complete."""
    if (shardings is None) != (mesh is None):
        raise ValueError("save_checkpoint takes shardings= and mesh= "
                         "together")
    writer = True
    if mesh is not None:
        import torch.distributed as dist

        writer = dist.get_rank() == 0
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    # sweep stale step_*.tmp dirs left by writers that crashed between the
    # leaf writes and the rename: invisible to restore, but they would
    # accumulate forever
    if writer and os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            if name.startswith("step_") and name.endswith(".tmp"):
                shutil.rmtree(os.path.join(ckpt_dir, name),
                              ignore_errors=True)
    if writer:
        os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "leaves": {}}
    for path, leaf in _whole_leaves(state, shardings, mesh):
        if not writer:
            continue
        shape = list(leaf.shape) if hasattr(leaf, "shape") else []
        fn = f"{path}.0.npy"
        np.save(os.path.join(tmp, fn), _host_array(leaf))
        manifest["leaves"][path] = {
            "shape": shape,
            "dtype": _dtype_name(leaf),
            "spec": [],
            "shards": [{"file": fn, "index": [[0, d] for d in shape]}],
        }
    if not writer:
        dist.barrier()             # rank 0's checkpoint is on disk
        return final

    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # atomic LATEST pointer
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(str(step))
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    if mesh is not None:
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def available_steps(ckpt_dir: str) -> list:
    """All fully written step numbers under ``ckpt_dir``, ascending. Only
    renamed (complete) step dirs count: ``.tmp`` dirs from crashed writers
    are invisible, as they are to :func:`restore_checkpoint`."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name[len("step_"):]))
            except ValueError:
                continue
    return sorted(steps)


def restore_checkpoint(ckpt_dir: str, step: int, shardings=None,
                       mesh=None, device="cuda"):
    """Load ``step`` as nested dicts of tensors on ``device`` (default
    ``cuda``; ``device="cpu"`` loads host tensors), each with the
    manifest's dtype: a bfloat16 leaf comes back as ``torch.bfloat16``, a
    0-d leaf as a 0-d tensor. The shards of a leaf are reassembled by
    their index, so checkpoints the reference wrote from any number of
    shards load.

    With ``shardings`` (a tree of per-dim specs keyed like the state, such
    as the data-parallel step's ``state_shardings``; a missing subtree
    means replicated) and ``mesh``, each leaf comes back as this rank's
    shard on ``mesh``, whatever mesh wrote the checkpoint."""
    if (shardings is None) != (mesh is None):
        raise ValueError("restore_checkpoint takes shardings= and mesh= "
                         "together")
    dev = resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    specs = dict(_flatten(shardings)) if shardings else {}

    flat = {}
    for path, info in manifest["leaves"].items():
        shape = tuple(info["shape"])
        name = info["dtype"]
        want = tuple((0, n) for n in shape)
        if mesh is not None and specs.get(path):
            want = local_slices(shape, specs[path], mesh)
        out = np.zeros(tuple(b - a for a, b in want),
                       dtype=np.float32 if name == "bfloat16"
                       else np.dtype(name))
        for sh in info["shards"]:
            # the part of this file inside the wanted block, if any
            lo = [max(a, s[0]) for (a, _), s in zip(want, sh["index"])]
            hi = [min(b, s[1]) for (_, b), s in zip(want, sh["index"])]
            if any(l >= h for l, h in zip(lo, hi)):
                continue
            arr = np.load(os.path.join(d, sh["file"]), mmap_mode="r")
            src = tuple(slice(l - s[0], h - s[0])
                        for l, h, s in zip(lo, hi, sh["index"]))
            dst = tuple(slice(l - a, h - a)
                        for l, h, (a, _) in zip(lo, hi, want))
            out[dst] = arr[src]
        flat[path] = torch.from_numpy(out).to(device=dev,
                                              dtype=torch_dtype(name))
    return _unflatten(flat)


def _host_copy(tree):
    """A copy of ``tree`` in host memory that nothing else aliases."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


class AsyncCheckpointer:
    """Host copy (blocking) -> background serialize, one write in flight."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        os.makedirs(ckpt_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, state):
        self.wait()
        # the host copy is taken before save returns, so a later in-place
        # update of the state cannot tear the checkpoint being written
        host_state = _host_copy(state)

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_state)
            # lint: allow-broad-except — background writer thread; the
            # error (whatever it is) must reach the caller on wait()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
