"""Port parity: checkpoints (``repro_torch.ft.checkpoint``), the
fault-tolerant ``TrainDriver`` and the launchers' checkpoint flags, against
the JAX package's ``repro.ft``.

Checkpoints are one on-disk format: each package reads what the other
wrote, leaf for leaf (f32, int32, bf16 and 0-d leaves; bf16 goes to disk
as an f32 file and comes back as bf16), with identical manifests. The
driver runs the same toy step under the same fault schedules in both
packages; a smoke-model restart must end bit-identical to an
uninterrupted run with the model still training its own tensors.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ft import checkpoint as jck
from repro.ft import driver as jdrv
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.configs.registry import get_smoke
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.ft import checkpoint as tck
from repro_torch.ft import driver as tdrv
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params, module_tree, tree_leaves
from repro_torch.train.loop import init_train_state, make_train_step
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")


def _np_tree(seed):
    """f32, int32, bf16 (as f32 values exact in bf16) and 0-d leaves."""
    rng = np.random.default_rng(seed)
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    bf = np.asarray(jnp.asarray(bf, jnp.bfloat16).astype(jnp.float32))
    return {"params": {"w": rng.standard_normal((4, 6)).astype(np.float32),
                       "b": rng.standard_normal(6).astype(np.float32),
                       "emb": bf},
            "opt": {"m": {"w": rng.standard_normal((4, 6))
                          .astype(np.float32)},
                    "count": np.asarray(7, np.int32)},
            "ids": rng.integers(-9, 9, size=(2, 3)).astype(np.int32),
            "step": 11}


def _as_jax(tree):
    out = dict(tree)
    out["params"] = dict(tree["params"],
                         emb=jnp.asarray(tree["params"]["emb"],
                                         jnp.bfloat16))
    return jax.tree.map(lambda x: x if isinstance(x, int)
                        else jnp.asarray(x), out)


def _as_torch(tree):
    def conv(x):
        return x if isinstance(x, int) else torch.from_numpy(np.array(x))

    out = {k: (conv(v) if not isinstance(v, dict)
               else {kk: (conv(vv) if not isinstance(vv, dict)
                          else {k3: conv(v3) for k3, v3 in vv.items()})
                     for kk, vv in v.items()})
           for k, v in tree.items()}
    out["params"]["emb"] = out["params"]["emb"].to(torch.bfloat16)
    return out


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "MANIFEST.json")) as f:
        m = json.load(f)
    return {p: (i["shape"], i["dtype"], [s["index"] for s in i["shards"]])
            for p, i in m["leaves"].items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_read_leaf_for_leaf(tmp_path, writer):
    """Either package writes, both read: every leaf's values, its dtype
    (bf16 stays bf16) and shape; the two packages' manifests agree."""
    tree = _np_tree(0)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_checkpoint(dj, 3, _as_jax(tree))
    tck.save_checkpoint(dt, 3, _as_torch(tree))
    assert _manifest(dj, 3) == _manifest(dt, 3)
    src = dj if writer == "jax" else dt
    assert tck.latest_step(src) == 3 and jck.latest_step(src) == 3
    port = tck.restore_checkpoint(src, 3, device="cpu")
    ref = jck.restore_checkpoint(src, 3)
    flat_p = dict(tck._flatten(port))
    flat_r = dict(jck._flatten(ref))
    assert sorted(flat_p) == sorted(flat_r)
    for path, r in flat_r.items():
        p = flat_p[path]
        assert isinstance(p, torch.Tensor)
        assert str(p.dtype).replace("torch.", "") == str(r.dtype), path
        assert tuple(p.shape) == tuple(r.shape), path
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(r, np.float32), path)
    assert port["params"]["emb"].dtype == torch.bfloat16
    assert port["step"].dim() == 0 and int(port["step"]) == 11
    assert int(port["opt"]["count"]) == 7


def test_checkpoint_reads_a_sharded_leaf(tmp_path):
    """The reference writes one file per addressable shard; the port
    reassembles a leaf from its shards' index ranges."""
    d = str(tmp_path)
    full = np.arange(24, dtype=np.float32).reshape(4, 6)
    tck.save_checkpoint(d, 1, {"w": full})
    sd = os.path.join(d, "step_00000001")
    os.remove(os.path.join(sd, "w.0.npy"))
    np.save(os.path.join(sd, "w.0.npy"), full[:2])
    np.save(os.path.join(sd, "w.1.npy"), full[2:])
    with open(os.path.join(sd, "MANIFEST.json")) as f:
        m = json.load(f)
    m["leaves"]["w"]["shards"] = [
        {"file": "w.0.npy", "index": [[0, 2], [0, 6]]},
        {"file": "w.1.npy", "index": [[2, 4], [0, 6]]}]
    with open(os.path.join(sd, "MANIFEST.json"), "w") as f:
        json.dump(m, f)
    np.testing.assert_array_equal(
        tck.restore_checkpoint(d, 1, device="cpu")["w"].numpy(), full)
    np.testing.assert_array_equal(np.asarray(jck.restore_checkpoint(d, 1)
                                             ["w"]), full)


def test_tmp_sweep_and_available_steps(tmp_path):
    d = str(tmp_path)
    assert tck.available_steps(d) == [] and tck.latest_step(d) is None
    tck.save_checkpoint(d, 3, {"x": np.zeros(2, np.float32)})
    tck.save_checkpoint(d, 7, {"x": torch.ones(2)})
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    os.makedirs(os.path.join(d, "step_junk"))
    assert tck.available_steps(d) == jck.available_steps(d) == [3, 7]
    assert tck.latest_step(d) == 7
    # the next save sweeps the stale tmp dir a crashed writer left
    tck.save_checkpoint(d, 8, {"x": torch.ones(2)})
    assert not os.path.exists(os.path.join(d, "step_00000009.tmp"))
    assert tck.available_steps(d) == [3, 7, 8]
    # a mesh restore takes the shardings and the mesh together
    with pytest.raises(ValueError, match="together"):
        tck.restore_checkpoint(d, 8, shardings={"x": None}, device="cpu")
    with pytest.raises(ValueError, match="together"):
        tdrv.TrainDriver(None, TTrain(checkpoint_dir=d), None, mesh=object())


def test_async_checkpointer_is_not_torn_by_in_place_updates(
        tmp_path, monkeypatch):
    """``save`` takes its host copy before returning: the in-place update
    a train step makes right after must not reach the checkpoint. The
    background write is held until the update has happened."""
    d = str(tmp_path)
    w = torch.arange(1 << 16, dtype=torch.float32)
    b = torch.ones(8, dtype=torch.bfloat16)
    state = {"params": {"w": w, "b": b}, "step": 5}
    want = {"w": w.clone(), "b": b.clone()}
    updated = threading.Event()
    write = tck.save_checkpoint

    def held_write(*args):
        assert updated.wait(timeout=30)
        return write(*args)

    monkeypatch.setattr(tck, "save_checkpoint", held_write)
    ck = tck.AsyncCheckpointer(d)
    ck.save(5, state)
    w.mul_(-1.0)                    # the next step, in place
    b.add_(1.0)
    state["step"] = 6
    updated.set()
    ck.wait()
    assert ck._thread is None
    got = tck.restore_checkpoint(d, 5, device="cpu")
    assert torch.equal(got["params"]["w"], want["w"])
    assert torch.equal(got["params"]["b"], want["b"])
    assert got["params"]["b"].dtype == torch.bfloat16
    assert int(got["step"]) == 5


# ---------------------------------------------------------------------------
# TrainDriver
# ---------------------------------------------------------------------------


def _jax_toy_step(state, batch):
    w = state["params"]["w"]
    g = w - batch
    loss = 0.5 * jnp.sum(g * g)
    return ({"params": {"w": w - 0.25 * g}, "step": state["step"] + 1},
            {"loss": loss})


def _port_toy_step(state, batch):
    w = state["params"]["w"]
    g = w - batch
    loss = 0.5 * (g * g).sum()
    with torch.no_grad():
        w.sub_(0.25 * g)
    state["step"] += 1
    return state, {"loss": loss}


def _toy_batch(step):
    return np.linspace(-1.0, 1.0, 4, dtype=np.float32) * (step + 1)


@pytest.mark.parametrize("faults", [dict(fail_at=(3, 6)),
                                    dict(p_fail=0.3, seed=5)])
def test_driver_matches_reference_under_faults(tmp_path, faults):
    """The same toy step and fault schedule through both drivers: the same
    restarts, executed steps (replays included), losses, checkpoint steps
    on disk and final state."""
    runs = {}
    for name, drv_mod, step_fn, make_batch, w0 in (
            ("jax", jdrv, _jax_toy_step, lambda s: jnp.asarray(_toy_batch(s)),
             {"params": {"w": jnp.zeros(4, jnp.float32)},
              "step": jnp.asarray(0, jnp.int32)}),
            ("port", tdrv, _port_toy_step,
             lambda s: torch.from_numpy(_toy_batch(s)),
             {"params": {"w": torch.zeros(4)}, "step": 0})):
        d = str(tmp_path / name)
        tcfg = (jdrv.TrainConfig if name == "jax" else TTrain)(
            checkpoint_every=2, checkpoint_dir=d)
        drv = drv_mod.TrainDriver(step_fn, tcfg, make_batch,
                                  fault_injector=drv_mod.FaultInjector(
                                      **faults))
        final = drv.run(w0, n_steps=9)
        runs[name] = (drv.restarts, [m["step"] for m in drv.metrics_log],
                      [m["loss"] for m in drv.metrics_log],
                      tck.available_steps(d),
                      np.asarray(final["params"]["w"]), int(final["step"]))
    j, t = runs["jax"], runs["port"]
    assert t[0] == j[0] and t[0] >= 1
    assert t[1] == j[1] and len(t[1]) > 9          # replays logged
    np.testing.assert_allclose(t[2], j[2], rtol=1e-6)
    assert t[3] == j[3]
    np.testing.assert_allclose(t[4], j[4], rtol=1e-6)
    assert t[5] == j[5] == 9


def _smoke_train(ckpt_dir, faults=None, on_restore=None):
    cfg = get_smoke("qwen3-0.6b")
    tcfg = TTrain(learning_rate=1e-3, checkpoint_every=2,
                  checkpoint_dir=ckpt_dir, z_loss=0.0)
    model = build_model(cfg, device="cpu")
    state = init_train_state(init_params(model.specs(), 0, device="cpu"),
                             tcfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, batch=2, seed=0)
    drv = tdrv.TrainDriver(
        make_train_step(model, cfg, tcfg), tcfg,
        lambda s: {"tokens": torch.from_numpy(data.batch_np(s)["tokens"])},
        fault_injector=faults)
    if on_restore is not None:
        inner = drv._restore
        drv._restore = lambda st: on_restore(model, st, inner(st))
    return model, drv, drv.run(state, n_steps=6)


def test_smoke_model_restart_is_bit_identical(tmp_path):
    """qwen3 smoke, a fault at step 3 after checkpoints at 2: one restart,
    steps 2-5 replayed from the checkpoint, final params bit-identical to
    an uninterrupted run; right after the restore the model's tensors are
    the state's (same storage) and hold the checkpoint's values."""
    seen = {}

    def on_restore(model, before, out):
        state, step = out
        ck = tck.restore_checkpoint(str(tmp_path / "a"), step, device="cpu")
        mt = dict(tck._flatten(module_tree(model)))
        for path, leaf in tck._flatten(state["params"]):
            assert mt[path].data_ptr() == leaf.data_ptr(), path
            assert torch.equal(leaf, dict(tck._flatten(ck["params"]))[path])
        seen["step"], seen["state_step"] = step, state["step"]
        return out

    _, drv, final = _smoke_train(str(tmp_path / "a"),
                                 tdrv.FaultInjector(fail_at=(3,)),
                                 on_restore)
    _, clean_drv, clean = _smoke_train(str(tmp_path / "b"))
    assert drv.restarts == 1 and seen == {"step": 2, "state_step": 2}
    assert [m["step"] for m in drv.metrics_log] == [0, 1, 2, 2, 3, 4, 5]
    assert [m["loss"] for m in drv.metrics_log][3:] == \
        [m["loss"] for m in clean_drv.metrics_log][2:]
    assert final["step"] == clean["step"] == 6
    for part in ("params", "opt"):
        for a, b in zip(tree_leaves(final[part]), tree_leaves(clean[part])):
            assert torch.equal(a, b)
    assert tck.available_steps(str(tmp_path / "a")) == [2, 4, 6]


def test_launchers_checkpoint_flags(tmp_path, capsys):
    """``launch.train --ckpt-dir/--ckpt-every`` writes the driver's
    checkpoints; ``launch.serve --ckpt-dir`` serves them; the snapshot
    flags' usage errors are the reference launcher's."""
    d = str(tmp_path / "ckpt")
    drv = tlaunch.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "4",
                        "--seq", "16", "--batch", "2", "--device", "cpu",
                        "--ckpt-dir", d, "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "restarts=0 straggler_events=0" in out
    assert len([l for l in out.splitlines() if l.startswith("step")]) == 4
    assert tck.available_steps(d) == [2, 4] and drv.restarts == 0
    ck = tck.restore_checkpoint(d, 4, device="cpu")
    assert int(ck["step"]) == 4 and set(ck) == {"params", "opt", "step"}
    snap = str(tmp_path / "snap")
    outs = tserve.main(["--model", "qwen3-0.6b", "--smoke", "--device",
                        "cpu", "--batch", "2", "--cache-len", "32",
                        "--n-requests", "3", "--max-new", "3",
                        "--ckpt-dir", d, "--snapshot-dir", snap,
                        "--snapshot-every", "2"])
    out = capsys.readouterr().out
    assert "restored checkpoint step 4" in out and "snapshots=" in out
    assert [len(o) for o in outs] == [3] * 3 and tck.available_steps(snap)
    # the reference launcher's wording (src/repro/launch/serve.py)
    with pytest.raises(SystemExit):
        tserve.main(["--model", "qwen3-0.6b", "--smoke", "--snapshot-every",
                     "3", "--device", "cpu"])
    assert capsys.readouterr().err.strip().splitlines()[-1].endswith(
        "error: --snapshot-every has no effect without --snapshot-dir")
