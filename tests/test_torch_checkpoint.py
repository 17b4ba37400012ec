"""The port's checkpoint manager (``repro_torch.checkpoint.manager``)
against the reference's (``repro.checkpoint.manager``).

* Byte compatibility: the same train state (params, AdamW state with
  ``step``, a StatsBank with telemetry leaves, the guard carry) saved by
  both managers gives the same files (META.json, MANIFEST.json with equal
  CRC32s and sizes); a JAX-saved checkpoint restores in the port and a
  port-saved one in JAX, raw leaves bit for bit, ``OptState.step`` an int
  on the port's side and a 0-d int32 on the reference's.
* Compressed leaves (``compress=True``, f32 of rank >= 2 and >= 4,096
  elements) cross both ways within the codec's tolerance: the same
  payload decoded by either side within 2e-6 relative (the inverse maps'
  log2 / exp2 differ in the last bits), against the source within the
  format's resolution; small leaves stay bit for bit.
* Hardening behaves the same on both sides: quarantine and fall-back for
  a truncated leaf, a flipped bit and a missing manifest, an explicit
  corrupt step raising, every checkpoint corrupt raising
  FileNotFoundError, stray directory names ignored, OSError retries on
  write and read, retry exhaustion re-raising, GC and stale ``.tmp``
  dirs.
* ``save(blocking=False)`` copies to the host before it returns: an
  in-place update right after it does not reach the checkpoint.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import mesh_toy
from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.training import guard as jguard
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.optim.optimizers import OptState

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def jax_states():
    """(initial, trained): the toy's (params, AdamW state, telemetry bank,
    guard state) before and after 3 guarded banked steps (JAX side)."""
    step, params, opt_state, bank, _ = mesh_toy.setup(
        telemetry=True, guard=jguard.GuardConfig())
    gs = jguard.init_state()
    init = jax.device_get((params, opt_state, bank, gs))
    for s in range(3):
        params, opt_state, bank, gs, _ = step(
            params, opt_state, bank, gs, mesh_toy.make_batch(s),
            jnp.int32(s))
    return init, jax.device_get((params, opt_state, bank, gs))


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _port_np_leaves(tree):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in convert.jax_leaves(tree)]


def _assert_leaves_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, (i, x.dtype,
                                                           y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")


def _manifest(path, step):
    d = os.path.join(path, f"step_{step:010d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        man = json.load(f)
    with open(os.path.join(d, "META.json")) as f:
        meta = json.load(f)
    return man, meta


def test_flatten_order_is_jax_order(jax_states):
    """``convert.jax_leaves`` of the converted state lists JAX's leaves in
    JAX's order, ``OptState.step`` as a 0-d int32, and ``unflatten``
    rebuilds the port's tree (step an int, dict key order kept)."""
    _, trained = jax_states
    port = convert.state_from_jax(trained, "cpu")
    assert isinstance(port[1], OptState) and port[1].step == 3
    _assert_leaves_equal(_port_np_leaves(port), _np_leaves(trained))
    back = convert.unflatten(port, convert.jax_leaves(port))
    assert back[1].step == 3 and list(back[2]) == list(port[2])
    _assert_leaves_equal(_port_np_leaves(back), _np_leaves(trained))
    # None gives no leaf (an SGD state's v), as in JAX
    assert len(convert.jax_leaves(OptState(1, {"w": torch.zeros(2)},
                                           None))) == 2


def test_same_state_same_files(tmp_path, jax_states):
    """Both managers write the same bytes for the same state."""
    _, trained = jax_states
    JaxManager(str(tmp_path / "jax")).save(3, trained)
    CheckpointManager(str(tmp_path / "port")).save(
        3, convert.state_from_jax(trained, "cpu"))
    jm, jmeta = _manifest(str(tmp_path / "jax"), 3)
    pm, pmeta = _manifest(str(tmp_path / "port"), 3)
    assert jmeta == pmeta
    assert jm == pm
    assert len(jm["files"]) == len(_np_leaves(trained))


def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path, jax_states):
    init, trained = jax_states
    JaxManager(str(tmp_path)).save(3, trained)
    template = convert.state_from_jax(init, "cpu")
    restored, step = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 3
    assert restored[1].step == 3 and isinstance(restored[1].step, int)
    assert set(restored[2]) == set(trained[2])     # telemetry bank sites
    assert "sat_frac" in next(iter(restored[2].values()))["a.fwd"]
    assert set(restored[3]) == {"gnorm_ema", "steps"}
    _assert_leaves_equal(_port_np_leaves(restored), _np_leaves(trained))


def test_port_checkpoint_restores_in_jax_bitwise(tmp_path, jax_states):
    init, trained = jax_states
    params, opt, bank, gs = convert.state_from_jax(trained, "cpu")
    # a state the port moved on: the optimizer step and every param
    params["w"].mul_(1.5)
    port = (params, OptState(opt.step + 2, opt.m, opt.v), bank, gs)
    CheckpointManager(str(tmp_path)).save(5, port)
    restored, step = JaxManager(str(tmp_path)).restore(init)
    assert step == 5
    assert np.asarray(restored[1].step).dtype == np.int32
    assert int(restored[1].step) == 5
    _assert_leaves_equal(_np_leaves(restored), _port_np_leaves(port))


def _big_state(seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(128, 64).astype(np.float32) * 1e-3
    return {"w": w, "b": rng.randn(64).astype(np.float32),
            "n": np.int32(7)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_compressed_checkpoints_cross_within_the_codec(tmp_path, writer):
    """A compressed checkpoint written by either side restores in both:
    the big leaf's payload decodes within 2e-6 relative on either side and
    within the e5m2 grid of the source; the small leaves bit for bit."""
    src = _big_state()
    jtree = jax.tree_util.tree_map(jnp.asarray, src)
    ptree = convert.state_from_jax(src, "cpu")
    if writer == "jax":
        JaxManager(str(tmp_path), compress=True).save(1, jtree)
    else:
        CheckpointManager(str(tmp_path), compress=True).save(1, ptree)
    d = tmp_path / "step_0000000001"
    assert sorted(n for n in os.listdir(d) if "payload" in n) == \
        ["leaf_00002.payload.npy"]                 # keys sorted: b, n, w
    payload = np.load(d / "leaf_00002.payload.npy")
    assert payload.dtype == np.uint8 and payload.shape == (128, 64)
    jr, _ = JaxManager(str(tmp_path)).restore(jtree)
    pr, _ = CheckpointManager(str(tmp_path)).restore(ptree)
    jw, pw = np.asarray(jr["w"]), pr["w"].numpy()
    nz = jw != 0
    assert np.array_equal(nz, pw != 0)
    assert np.max(np.abs(pw[nz] - jw[nz]) / np.abs(jw[nz])) <= 2e-6
    rel = np.abs(pw[nz] - src["w"][nz]) / np.abs(src["w"][nz])
    assert np.median(rel) < 0.05 and nz.mean() > 0.9
    np.testing.assert_array_equal(pr["b"].numpy(), src["b"])
    assert pr["n"].dtype == torch.int32 and int(pr["n"]) == 7
    np.testing.assert_array_equal(np.asarray(jr["b"]), src["b"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_compressed_payload_codes_agree(tmp_path, writer):
    """The two sides' encoders give the same payload codes for the same
    leaf, up to RNE-boundary flips (one grid step, under 1e-3 of the
    elements), and the same (alpha, beta) within 5e-6 relative (the mean
    of 8,192 log2 values, summed in another order, moves them by ~1e-6)."""
    src = _big_state(1)
    JaxManager(str(tmp_path / "jax"), compress=True).save(
        1, jax.tree_util.tree_map(jnp.asarray, src))
    CheckpointManager(str(tmp_path / "port"), compress=True).save(
        1, convert.state_from_jax(src, "cpu"))
    leaf = "step_0000000001/leaf_00002"
    jp = np.load(tmp_path / "jax" / f"{leaf}.payload.npy").astype(np.int32)
    pp = np.load(tmp_path / "port" / f"{leaf}.payload.npy").astype(np.int32)

    def ordinal(u):
        return np.where(u >= 0x80, -(u & 0x7F), u & 0x7F)

    diff = np.abs(ordinal(jp) - ordinal(pp))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    js = np.load(tmp_path / "jax" / f"{leaf}.stats.npy")
    ps = np.load(tmp_path / "port" / f"{leaf}.stats.npy")
    np.testing.assert_allclose(ps, js, rtol=5e-6)


# ---------------------------------------------------------------------------
# hardening: the same behaviour on both sides
# ---------------------------------------------------------------------------

def _tree(side, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(8, 4).astype(np.float32)
    if side == "jax":
        return {"w": jnp.asarray(w), "step": jnp.int32(seed)}
    return {"w": torch.from_numpy(w),
            "step": torch.tensor(seed, dtype=torch.int32)}


def _manager(side, path, **kw):
    return (JaxManager if side == "jax" else CheckpointManager)(
        str(path), **kw)


def _damage(step_dir, flavor):
    if flavor == "manifest":
        os.remove(os.path.join(step_dir, "MANIFEST.json"))
        return
    leaf = os.path.join(step_dir, sorted(
        n for n in os.listdir(step_dir) if n.endswith(".npy"))[0])
    if flavor == "bitflip":
        with open(leaf, "r+b") as f:
            f.seek(-1, 2)
            byte = f.read(1)
            f.seek(-1, 2)
            f.write(bytes([byte[0] ^ 0xFF]))
    else:
        with open(leaf, "r+b") as f:
            f.truncate(os.path.getsize(leaf) // 2)


def _leaves_np(tree):
    return [np.asarray(x) for x in (jax.tree_util.tree_leaves(tree)
                                    if not isinstance(tree["w"],
                                                      torch.Tensor)
                                    else convert.jax_leaves(tree))]


@pytest.mark.parametrize("flavor,reason", [
    ("truncate", "size mismatch"), ("bitflip", "checksum mismatch"),
    ("manifest", "missing manifest")])
def test_quarantine_falls_back_like_the_reference(tmp_path, flavor, reason):
    got = {}
    for side in ("jax", "port"):
        events = []
        ck = _manager(side, tmp_path / side, event_fn=events.append)
        ck.save(1, _tree(side, 1))
        ck.save(2, _tree(side, 2))
        assert ck.validate(2) == (True, "ok")
        _damage(ck._step_dir(2), flavor)
        ok, why = ck.validate(2)
        restored, step = ck.restore(_tree(side, 0))
        q = [(e["event"], e["step"], e["reason"]) for e in events]
        got[side] = (ok, why, step, q, ck.latest_step(),
                     os.path.isdir(str(tmp_path / side
                                       / "step_0000000002.quarantined")))
        _assert_leaves_equal(_leaves_np(restored),
                             _leaves_np(_tree("jax", 1)))
    assert got["jax"] == got["port"]
    ok, why, step, q, latest, moved = got["port"]
    assert not ok and reason in why and step == 1 and latest == 1 and moved
    assert q == [("checkpoint_quarantined", 2, why)]


@pytest.mark.parametrize("side", ["jax", "port"])
def test_explicit_corrupt_step_raises_and_all_corrupt_is_not_found(
        tmp_path, side):
    events = []
    ck = _manager(side, tmp_path, event_fn=events.append)
    ck.save(1, _tree(side, 1))
    ck.save(2, _tree(side, 2))
    _damage(ck._step_dir(2), "truncate")
    with pytest.raises(ValueError, match="failed validation"):
        ck.restore(_tree(side, 0), step=2)
    _damage(ck._step_dir(1), "manifest")
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        ck.restore(_tree(side, 0))
    assert [e["step"] for e in events] == [2, 1]


def test_stray_names_gc_and_stale_tmp_are_ignored(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(s, _tree("port", s))
    assert "step_0000000001" not in os.listdir(tmp_path)     # GC'd
    os.makedirs(str(tmp_path / "step_0000000001.quarantined"))
    os.makedirs(str(tmp_path / "step_abc"))
    os.makedirs(str(tmp_path / "step_0000000099.tmp"))
    (tmp_path / "notes.txt").write_text("x")
    assert ck.latest_step() == 3
    ck._gc()
    _, step = ck.restore(_tree("port", 0))
    assert step == 3


@pytest.mark.parametrize("side", ["jax", "port"])
def test_write_and_read_retry_transient_oserrors(tmp_path, side,
                                                 monkeypatch):
    ck = _manager(side, tmp_path, retries=3, backoff_s=0.0)
    calls = {"save": 0, "load": 0}
    real_save, real_load = np.save, np.load

    def flaky_save(path, arr, *a, **kw):
        calls["save"] += 1
        if calls["save"] <= 2:
            raise OSError("transient")
        return real_save(path, arr, *a, **kw)

    def flaky_load(path, *a, **kw):
        calls["load"] += 1
        if calls["load"] == 1:
            raise OSError("transient")
        return real_load(path, *a, **kw)

    monkeypatch.setattr(np, "save", flaky_save)
    ck.save(1, _tree(side, 1))
    assert calls["save"] >= 3 and ck.validate(1) == (True, "ok")
    monkeypatch.setattr(np, "load", flaky_load)
    restored, step = ck.restore(_tree(side, 0))
    assert step == 1 and calls["load"] >= 2
    _assert_leaves_equal(_leaves_np(restored), _leaves_np(_tree("jax", 1)))


@pytest.mark.parametrize("side", ["jax", "port"])
def test_retry_exhaustion_reraises(tmp_path, side, monkeypatch):
    ck = _manager(side, tmp_path, retries=2, backoff_s=0.0)

    def always_fail(*a, **kw):
        raise OSError("disk on fire")

    monkeypatch.setattr(np, "save", always_fail)
    with pytest.raises(OSError, match="disk on fire"):
        ck.save(1, _tree(side, 1))


def test_async_save_copies_before_returning(tmp_path):
    """``blocking=False`` returns with the host copies taken: an in-place
    update right after (what the optimizer does next step) does not reach
    the files, and ``last_write_seconds`` is set once the writer ends."""
    w = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    tree = {"w": w, "opt": OptState(4, {"w": w.clone()}, None)}
    ck = CheckpointManager(str(tmp_path))
    ck.save(4, tree, blocking=False)
    w.add_(1000.0)
    tree["opt"].m["w"].zero_()
    ck.wait()
    assert ck.last_write_seconds > 0.0
    template = {"w": torch.zeros(64, 64),
                "opt": OptState(0, {"w": torch.zeros(64, 64)}, None)}
    restored, _ = ck.restore(template)
    want = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    assert torch.equal(restored["w"], want)
    assert torch.equal(restored["opt"].m["w"], want)
    assert restored["opt"].step == 4
    # restored tensors are new: an update to them leaves the template be
    restored["w"].add_(1.0)
    assert float(template["w"].abs().sum()) == 0.0
