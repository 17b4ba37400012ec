"""Slice 13: ``launch/dryrun.py`` — one full-width production-mesh cell
traced on fake tensors, the launcher's record keys, ``--mem-report``, the
skipped and refused cases.

The cell is minicpm_2b train_4k at 16 x 16 with ``--attn-impl flash``
(the naive route's chunk loop takes about twice as long to trace): rank
0's 16 rows x 4,096 tokens, the f32 gradient sync recorded, exact-stats
s2fp8 on the cuda engine's kernels (each charged as its kernel).
"""
import json

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


def test_full_width_train_cell_traces(cell):
    assert cell["status"] == "ok"
    assert cell["model_axis"] == "replicated"
    assert cell["param_sharding"] == "replicated"
    mem, rl = cell["memory_analysis"], cell["roofline"]
    # the reference's record keys, plus the port's
    assert {"status", "compile_s", "memory_analysis", "roofline",
            "policy"} <= set(cell)
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "generated_code_bytes"} <= set(mem)
    # rank 0 holds the full f32 params and AdamW moments (replicated)
    n = get_config("minicpm_2b").n_params()
    assert mem["argument_bytes"] >= 12 * n
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert rl["chips"] == 256 and rl["mesh"] == "16x16"
    assert rl["model_gflops_total"] == pytest.approx(
        analysis.model_flops(get_config("minicpm_2b"), "train_4k") / 1e9)
    # one rank's 16 rows: about 6·N·T / 16 (with the remat replay and
    # attention on top), nowhere near the reference's 1/256 share
    share = rl["hlo_gflops_per_dev"] * 16 / rl["model_gflops_total"]
    assert 1.0 < share < 2.0, share
    # the gradient sync: one f32 all-reduce (2x) per param leaf
    assert set(rl["coll_breakdown"]) == {"all_reduce"}
    assert rl["coll_gbytes_per_dev"] * 1e9 >= 2 * 4 * n
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


def test_mem_report(capsys):
    """``--mem-report`` prints ``launch/memplan.py``'s table: the
    reference's rows at the card's 80 GB (its header names the card)."""
    assert dryrun.main(["--mem-report", "--arch", "minicpm_2b"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    want = jmemplan.format_report(["minicpm_2b"], {"data": 16, "model": 16},
                                  hbm_gb=80).strip().splitlines()
    assert "HBM 80 GB/card" in got[0]
    assert got[1:] == want[1:] and len(got) == 5
