"""Port parity: ``repro_torch.nn.scan.chunked_time_scan`` against the JAX
package's ``chunked_time_scan`` (and ``lax.scan``) on the same numpy
inputs: a decaying matrix recurrence with a per-step output, at lengths
below, at and past the chunk, with a ragged tail."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.scan import chunked_time_scan as jscan
from repro_torch.nn.scan import chunked_time_scan as tscan

jax.config.update("jax_platform_name", "cpu")

REL_TOL = 2e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def _inputs(T, seed=0):
    rng = np.random.default_rng(seed)
    h0 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    decay = rng.uniform(0.5, 1.0, (T, 2, 3, 1)).astype(np.float32)
    u = rng.standard_normal((T, 2, 3, 4)).astype(np.float32)
    valid = rng.uniform(size=(T, 2)) > 0.3
    return h0, decay, u, valid


def _step(lib):
    def step(h, t):
        d, u, m = t
        h_new = d * h + u
        h_new = lib.where(m[:, None, None], h_new, h)
        return h_new, (h_new * u).sum(-1)
    return step


@pytest.mark.parametrize("T,chunk", [(1, 4), (5, 4), (8, 4), (11, 4),
                                     (7, 256)])
def test_scan_matches_reference(T, chunk):
    h0, decay, u, valid = _inputs(T)
    jh, jys = jscan(_step(jnp), jnp.asarray(h0),
                    tuple(jnp.asarray(a) for a in (decay, u, valid)),
                    chunk=chunk, remat=True)
    th, tys = tscan(_step(torch), torch.from_numpy(h0),
                    tuple(torch.from_numpy(a) for a in (decay, u, valid)),
                    chunk=chunk, remat=True)
    assert tys.shape == (T, 2, 3)
    assert _rel(th.numpy(), jh) <= REL_TOL
    assert _rel(tys.numpy(), jys) <= REL_TOL


def test_scan_chunk_and_remat_change_nothing():
    """The port's loop takes the reference's chunk/remat arguments for its
    signature only: every setting gives the same carry and outputs."""
    h0, decay, u, valid = _inputs(9, seed=1)
    xs = tuple(torch.from_numpy(a) for a in (decay, u, valid))
    ref = tscan(_step(torch), torch.from_numpy(h0), xs)
    for chunk, remat in ((1, False), (4, True), (9, False), (512, True)):
        got = tscan(_step(torch), torch.from_numpy(h0), xs, chunk=chunk,
                    remat=remat)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
