"""Slice 13: ``launch/dryrun.py`` — one full-width production-mesh cell
traced on fake tensors, the launcher's record keys, ``--mem-report``, the
skipped and refused cases.

The cell is minicpm_2b train_4k at 16 x 16 with ``--attn-impl flash``
(the naive route's chunk loop takes about twice as long to trace): rank
0's 16 rows x 4,096 tokens under ``TRAIN_RULES``, its params placed by
``param_pspecs``, the f32 gradient sync recorded, exact-stats s2fp8 on
the cuda engine's kernels (each charged as its kernel).
"""
import json
from unittest import mock

import pytest

from torch_threads import one_torch_thread  # noqa: F401

from repro.launch import memplan as jmemplan
from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis


@pytest.fixture(scope="module")
def cell():
    return dryrun.run_cell("minicpm_2b", "train_4k", multi_pod=False,
                           overrides={"attn_impl": "flash"})


def _placed_elements(arch, sizes):
    """The param elements a rank holds with the leaves placed by
    ``api.param_pspecs`` on a mesh of ``sizes``."""
    from repro_torch.launch import api
    from repro_torch.optim.optimizers import tree_leaves
    cfg = get_config(arch)
    struct = api.param_struct(cfg)
    specs = api.param_pspecs(cfg, struct, sizes)
    total = 0
    for leaf, spec in zip(tree_leaves(struct), _spec_leaves(specs)):
        n = leaf.numel()
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else (entry or ())):
                n //= sizes[a]
        total += n
    return total


def _spec_leaves(specs):
    from repro_torch.parallel import sharding
    return sharding._spec_leaves(specs)


def test_full_width_train_cell_traces(cell):
    assert cell["status"] == "ok"
    # the params placed as the reference's (T over model, F over data) and
    # the model axis split as its rules say: minicpm's 36 heads and odd
    # vocab (122,753) do not divide 16, its d_ff of 5,760 does
    assert cell["model_axis"] == {"mlp": 16}
    assert cell["param_sharding"] == "pspecs"
    assert cell["param_placement"].startswith("param_pspecs")
    mem, rl = cell["memory_analysis"], cell["roofline"]
    # the reference's record keys, plus the port's
    assert {"status", "compile_s", "memory_analysis", "roofline",
            "policy"} <= set(cell)
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "generated_code_bytes"} <= set(mem)
    # rank 0 holds its placed part of the f32 params and AdamW moments
    n = get_config("minicpm_2b").n_params()
    local = _placed_elements("minicpm_2b", {"data": 16, "model": 16})
    assert 12 * local <= mem["argument_bytes"] < 12 * n / 16
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert rl["chips"] == 256 and rl["mesh"] == "16x16"
    assert rl["model_gflops_total"] == pytest.approx(
        analysis.model_flops(get_config("minicpm_2b"), "train_4k") / 1e9)
    # one rank's 16 rows with the MLP split 16 ways: about half of the
    # replicated rank's 1.3 x (6·N·T / 16) (the attention, head and
    # embedding stay whole; measured 0.68)
    share = rl["hlo_gflops_per_dev"] * 16 / rl["model_gflops_total"]
    assert 0.5 < share < 0.85, share
    # the f32 gradient sync and the data gathers over 'data', the MLP's
    # all-reduces, the attention weights' gathers and the split stats
    # over 'model'
    assert {"all_reduce", "all_gather", "reduce_scatter"} <= set(
        rl["coll_breakdown"])
    assert cell["coll_by_axis"]["model"] > 0
    assert cell["coll_by_axis"]["data"] > 0
    calls = cell["kernel_calls"]
    assert calls["qflash_fwd"] == 2 * 40 and calls["qflash_bwd"] == 40
    assert calls["qmatmul_nn"] > 0 and calls["qmatmul_tn"] > 0
    json.dumps(cell)                                  # a JSON record


def test_main_caches_skips_and_refuses(tmp_path, capsys):
    out = tmp_path / "cells.json"
    assert dryrun.main(["--arch", "minicpm_2b", "--shape", "long_500k",
                        "--results", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["minicpm_2b|long_500k|16x16|s2fp8"]["status"] == "skipped"
    assert dryrun.main(["--arch", "minicpm_2b", "--shape", "long_500k",
                        "--results", str(out)]) == 0
    assert "[cached]" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main(["--save-hlo"])
    with pytest.raises(ValueError):
        dryrun.run_cell("minicpm_2b", "decode_32k", False,
                        param_sharding="fsdp")
    assert dryrun.cell_key("a", "s", "16x16", "s2fp8") == "a|s|16x16|s2fp8"
    assert dryrun.cell_key("a", "s", "16x16", "s2fp8", "replicated") == \
        "a|s|16x16|s2fp8|replicated"
    # an older file's un-suffixed record of another placement (or of none)
    # is traced again; a record of the requested placement is reused
    key = "minicpm_2b|train_4k|16x16|s2fp8"
    traced = []

    def fake_cell(*args, **kw):
        traced.append(kw["param_sharding"])
        return {"status": "ok", "compile_s": 0.0,
                "param_sharding": kw["param_sharding"],
                "memory_analysis": {"peak_bytes": 0},
                "roofline": {"hlo_gflops_per_dev": 0.0,
                             "coll_gbytes_per_dev": 0.0,
                             "dominant": "compute", "mfu": 0.0}}
    argv = ["--arch", "minicpm_2b", "--shape", "train_4k", "--results",
            str(out)]
    for old in ({"status": "ok", "model_axis": "replicated"},
                {"status": "ok", "param_sharding": "replicated"}):
        out.write_text(json.dumps({key: old}))
        with mock.patch.object(dryrun, "run_cell", fake_cell):
            assert dryrun.main(argv) == 0
            assert "[run]" in capsys.readouterr().out
            assert dryrun.main(argv) == 0
            assert "[cached]" in capsys.readouterr().out
    assert traced == ["pspecs", "pspecs"]
    assert json.loads(out.read_text())[key]["param_sharding"] == "pspecs"


def test_mem_report(capsys):
    """``--mem-report`` prints ``launch/memplan.py``'s table: the
    reference's rows at the card's 80 GB (its header names the card)."""
    assert dryrun.main(["--mem-report", "--arch", "minicpm_2b"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    want = jmemplan.format_report(["minicpm_2b"], {"data": 16, "model": 16},
                                  hbm_gb=80).strip().splitlines()
    assert "HBM 80 GB/card" in got[0]
    assert got[1:] == want[1:] and len(got) == 5
