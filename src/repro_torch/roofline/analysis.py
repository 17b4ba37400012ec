"""Roofline terms of a traced step (port of ``repro.roofline.analysis``),
with the card's constants in place of the TPU's.

Card: NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit, from the data
sheet (dense rates; the sparse ones are twice these):

  BF16 tensor cores   989.4 TFLOP/s   (``PEAK_FLOPS``: what ``mfu`` divides
                                       by, as the reference divides by its
                                       chip's bf16 peak)
  TF32 tensor cores   494.7 TFLOP/s
  f32 outside them     67   TFLOP/s
  HBM3                  3.35 TB/s
  NVLink              450   GB/s a direction

  compute_term    = FLOPs / PEAK_FLOPS              [s, one device]
  memory_term     = bytes / HBM_BW                  [s]
  collective_term = collective bytes / LINK_BW      [s]

FLOPs, bytes and collective bytes are one device's, from
``roofline/trace_cost.py`` (the port has no HLO; ``analyze`` takes the
trace's cost where the reference parses HLO text).  ``bound_ms`` is the
kernel table's per-call bound (PERF.md; ``chip_smoke.py`` phase 3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# NVIDIA H100 80GB HBM3 (SXM5), 700 W, data sheet
PEAK_FLOPS = 989.4e12        # BF16 tensor cores, dense
TF32_FLOPS = 494.7e12        # TF32 tensor cores, dense
F32_FLOPS = 67e12            # f32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # NVLink, bytes/s a direction
SFU_PER_S = 132 * 16 * 1.98e9    # MUFU ops (ex2): 16 a clock an SM, 132 SMs
TC_PASSES = 3                # the kernels' compensated TF32 (3 passes)


def bound_ms(nbytes, flops, tensor_cores=False):
    """(bound ms, bound_by, kind of operations) of a call that moves
    ``nbytes`` and does ``flops`` f32 operations: the larger of the bytes
    over HBM and the operations over the f32 cores (with
    ``tensor_cores``, the smaller of that and TC_PASSES TF32 tensor-core
    passes)."""
    tb, tf = nbytes / HBM_BW * 1e3, flops / F32_FLOPS * 1e3
    kind = "f32 cores"
    if tensor_cores and TC_PASSES * flops / TF32_FLOPS * 1e3 < tf:
        tf = TC_PASSES * flops / TF32_FLOPS * 1e3
        kind = f"{TC_PASSES}xTF32 tensor cores"
    return max(tb, tf), ("bytes" if tb >= tf else "operations"), kind


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_gflops: float            # per device (the trace's)
    hlo_gbytes: float            # per device
    coll_gbytes: float           # per device
    coll_breakdown: Dict[str, float]
    model_gflops_total: float    # analytic 6*N*D (or active)
    bytes_per_device: float      # peak live bytes of the trace

    @property
    def compute_s(self) -> float:
        return self.hlo_gflops * 1e9 / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hlo_gbytes * 1e9 / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_gbytes * 1e9 / LINK_BW

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    @property
    def step_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / total traced FLOPs across chips."""
        total = self.hlo_gflops * self.chips
        return self.model_gflops_total / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        denom = self.step_s * PEAK_FLOPS * self.chips
        return (self.model_gflops_total * 1e9 / denom) if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_gflops_per_dev": self.hlo_gflops,
            "hlo_gbytes_per_dev": self.hlo_gbytes,
            "coll_gbytes_per_dev": self.coll_gbytes,
            "coll_breakdown": self.coll_breakdown,
            "model_gflops_total": self.model_gflops_total,
            "bytes_per_device": self.bytes_per_device,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "step_s": self.step_s, "useful_flops_frac": self.useful_flops_frac,
            "mfu": self.mfu,
        }


def model_flops(cfg, shape_name: str) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train / 2*N*D inference, N = active
    params (``cfg.n_active_params``), D = tokens processed (an enc-dec's
    training adds its 448 decoder tokens; decode is one token a
    sequence)."""
    from repro_torch.configs.base import SHAPE_SPECS
    seq, gbs, kind = SHAPE_SPECS[shape_name]
    n = cfg.n_active_params()
    if kind == "train":
        tokens = seq * gbs if not cfg.enc_dec else (seq + 448) * gbs
        return 6.0 * n * tokens
    if kind == "prefill":
        return 2.0 * n * seq * gbs
    return 2.0 * n * gbs


def analyze(arch: str, shape: str, mesh_name: str, chips: int, cost,
            mem_bytes: float, model_gflops_total: float) -> Roofline:
    """Roofline terms from one device's ``trace_cost.TraceCost``."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_gflops=cost.flops / 1e9, hlo_gbytes=cost.bytes / 1e9,
        coll_gbytes=cost.coll_bytes / 1e9,
        coll_breakdown={k: v / 1e9 for k, v in cost.coll.items()},
        model_gflops_total=model_gflops_total,
        bytes_per_device=mem_bytes)
