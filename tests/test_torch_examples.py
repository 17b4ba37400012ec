"""Slice 13: the port's examples (``python -m repro_torch.examples.*``),
each run on the CPU at a reduced size: every curve and metric finite, the
serving demo's requests served in full, the end-to-end driver resuming
from its own checkpoint."""
import math

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

from repro_torch.examples import (quickstart, serve_lm, train_100m_e2e,
                                  train_ncf, train_resnet_cifar,
                                  train_transformer_tiny)
from repro_torch.launch import doctor


def _finite(*xs):
    return all(math.isfinite(x) for x in xs)


def test_quickstart_four_curves():
    curves = quickstart.main(["--device", "cpu", "--steps", "3"])
    assert set(curves) == {"fp32", "s2fp8", "fp8", "bank"}
    assert all(len(c) == 3 and _finite(*c) for c in curves.values())
    # the first step's loss is the same model on the same batch: the
    # formats differ by their truncation only
    assert abs(curves["s2fp8"][0] - curves["fp32"][0]) < 0.05


def test_train_ncf():
    out = train_ncf.main(["--device", "cpu", "--steps", "3"])
    assert set(out) == {"fp32", "s2fp8", "fp8"}
    assert all(0.0 <= hr <= 1.0 and _finite(loss) for hr, loss in
               out.values())


def test_train_resnet_cifar():
    out = train_resnet_cifar.main(["--device", "cpu", "--steps", "2",
                                   "--depth", "8"])
    assert set(out) == {"fp32", "s2fp8", "fp8", "fp8_ls"}
    assert all(0.0 <= acc <= 1.0 and _finite(loss) for acc, loss in
               out.values())


def test_train_transformer_tiny():
    out = train_transformer_tiny.main(["--device", "cpu", "--steps", "2"])
    assert set(out) == {"fp32", "s2fp8", "fp8", "fp8_ls"}
    assert all(_finite(nll) and 0.0 <= acc <= 1.0 for nll, acc in
               out.values())


def test_serve_lm():
    out = serve_lm.main(["--device", "cpu", "--requests", "2"])
    for engine in ("dense", "payload"):
        assert out[engine]["tokens"] == 2 * 12
        assert all(len(o) == 12 for o in out[engine]["outs"])


def test_train_100m_e2e_checkpoints_and_resumes(tmp_path):
    argv = ["--device", "cpu", "--batch", "2", "--seq", "16", "--n-layers",
            "1", "--vocab", "512", "--mesh", "none", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    loop, hist = train_100m_e2e.main(argv + ["--steps", "2"])
    assert loop.start_step == 0 and len(hist) == 2
    assert _finite(*(h["loss"] for h in hist))
    loop, hist = train_100m_e2e.main(argv + ["--steps", "3"])
    assert loop.start_step == 2 and len(hist) == 1


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, argv in ((quickstart.main, ["--steps", "1"]),
                     (train_ncf.main, ["--steps", "1"]),
                     (serve_lm.main, []),
                     (doctor.main, ["--smoke", "--backends", "plain"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(argv)
