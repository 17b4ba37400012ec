"""S2FP8 quantize-apply, truncate-apply, dequantize and the statistics
kernels: CUDA kernels + plain versions.

Of ``src/repro/kernels/s2fp8_quant.py``: ``quant_apply`` replaces
``quant_apply_pallas`` (_apply_kernel), ``truncate_apply`` replaces
``truncate_apply_pallas`` (_truncate_kernel / _truncate_body), ``dequant``
replaces ``dequant_pallas`` (_dequant_kernel), ``stats_partials``
replaces ``stats_pallas`` (_stats_kernel), ``quant`` replaces
``quant_pallas`` (stats, then apply) and ``truncate_fused`` replaces
``truncate_fused_pallas`` (_truncate_fused_kernel).  Kernel source:
``repro_torch/csrc/s2fp8_quant.cu`` (element maps and the stats reduction
in s2fp8_common.cuh).

Bound on the card: bytes — one read of the input (f32 or bf16, or the
1-byte payload) and one write of the output per element; the stats and,
up to their capacity (:func:`fused_capacity`), quantize-with-stats and
the fused truncate read the input once, larger tensors twice.
Design: (alpha, beta) read through a device pointer (no host sync);
quantize-apply, truncate-apply and the fused kernels move 16 bytes a
thread a step and encode through the card's code table
(:func:`code_table`: exp2f, clamp and convert replaced by a bucket of t and
one threshold compare, held to the direct map over every f32 t by
:func:`code_sweep`); dequantize and the truncates' output look each byte
up in a per-block 256-entry table of the Eq. 4 inverse map, so
``truncate_apply(x, ab)`` equals ``dequant(quant_apply(x, ab), ab)`` in
x's dtype bit for bit.  The stats are one launch of a deterministic
reduction (per-block partials with the sum in f64 and the count in 64-bit
integers; the last block to finish, by an integer ticket kept per stream
(:func:`ticket`), sums them in a fixed order; no float atomics).
Quantize-with-stats and the fused truncate are one cooperative launch
each whose phase 0 is that reduction, keeping each element's log2 in
registers or shared memory across one grid barrier, before which the last
block has summed the partials, so ``quant(x)`` equals
``(quant_apply(x, stats(x)), stats(x))`` and ``truncate_fused(x)`` equals
``truncate_apply(x, stats(x))`` bit for bit.

The stats wrappers return the triplet (sum log2|x|, max log2|x|, nonzero
count) as f32 [3] and (alpha, beta) as f32 [2], both on x's device.
"""
from __future__ import annotations

import torch

from repro_torch.core import s2fp8
from repro_torch.kernels import build, kernel_entry, plain_version, ref

FMT_ID = {"e5m2": 0, "e4m3": 1}
DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}
PAYLOAD_FMT = {torch.float8_e5m2: "e5m2", torch.float8_e4m3fn: "e4m3"}


def check_cuda_operand(t: torch.Tensor, name: str, dtypes, device=None):
    """Device / dtype / contiguity checks shared by the kernel wrappers.  A
    fake tensor (a dry trace's) holds no memory for a kernel to read, so it
    raises here, before any pointer is taken."""
    from torch._subclasses.fake_tensor import is_fake
    if is_fake(t):
        raise TypeError(f"{name} is a fake tensor: a kernel cannot launch "
                        f"on it (trace on the CPU, where each wrapper "
                        f"takes its plain version)")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; kernel takes {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stats_arg(stats, device) -> torch.Tensor:
    """(alpha, beta) as the kernel's f32 [2] argument on ``device``."""
    ab = s2fp8.as_stats(stats, device)
    if ab.device != device:
        raise ValueError(f"stats on {ab.device}, data on {device}")
    return ab


@plain_version
def quant_apply_plain(x: torch.Tensor, stats, fmt: str = "e5m2"
                      ) -> torch.Tensor:
    """Plain version: Eq. 2 forward map, clamp at the format's max finite,
    RNE cast — ``s2fp8.quantize`` with given stats."""
    return s2fp8.quantize(x, stats=stats, fmt=fmt).payload


@plain_version
def truncate_apply_plain(x: torch.Tensor, stats, fmt: str = "e5m2"
                         ) -> torch.Tensor:
    """Plain version: the Eq. 5 round trip with given stats, in x's dtype."""
    return ref.s2fp8_truncate_ref(x, stats=stats, fmt=fmt)


@plain_version
def dequant_plain(payload: torch.Tensor, stats) -> torch.Tensor:
    """Plain version: the Eq. 4 inverse map of the payload, f32."""
    return ref.s2fp8_dequant_ref(payload, stats)


def _stats_plain(x: torch.Tensor, target_max: float):
    triplet = ref.s2fp8_stats_partials_ref(x)
    alpha, beta = s2fp8.stats_from_reduction(triplet[0], triplet[1],
                                             triplet[2], target_max)
    return triplet, torch.stack([alpha, beta])


@plain_version
def stats_partials_plain(x: torch.Tensor,
                         target_max: float = s2fp8.TARGET_MAX_LOG2):
    """Plain version: (triplet, ab) from ``ref.s2fp8_stats_partials_ref``
    and ``s2fp8.stats_from_reduction``."""
    return _stats_plain(x, target_max)


@plain_version
def quant_plain(x: torch.Tensor, fmt: str = "e5m2"):
    """Plain version: (payload, ab) — the stats of x for ``fmt``'s range,
    then the quantize-apply map with them."""
    _, ab = _stats_plain(x, s2fp8.FMT_TARGET_MAX[fmt])
    return s2fp8.quantize(x, stats=ab, fmt=fmt).payload, ab


@plain_version
def truncate_fused_plain(x: torch.Tensor, fmt: str = "e5m2"):
    """Plain version: (out in x's dtype, ab) — the stats of x for
    ``fmt``'s range, then the Eq. 5 round trip with them."""
    _, ab = _stats_plain(x, s2fp8.FMT_TARGET_MAX[fmt])
    return ref.s2fp8_truncate_ref(x, stats=ab, fmt=fmt), ab


# per-block partials of the stats kernels (24 B each; the card's grid rule
# stays under 4096 blocks, and the library checks it)
_STATS_SCRATCH_BYTES = 24 * 4096
_CODE_TABLES = {}
_LAYOUT = []


def _code_table_layout():
    """(bytes, byte offset of the thresholds, their count) of the code
    table (``CodeTable`` in csrc/s2fp8_common.cuh), asked of the library."""
    if not _LAYOUT:
        out = torch.zeros(3, dtype=torch.int64)
        build.check(build.load("s2fp8_quant").s2fp8_code_table_layout(
            out.data_ptr()), "s2fp8_code_table_layout")
        _LAYOUT.extend(int(v) for v in out)
    return _LAYOUT


def code_table(device: torch.device, fmt: str) -> torch.Tensor:
    """The card's code table of ``fmt`` (raw bytes, laid out as the
    library's ``CodeTable``), built by one small kernel at first use on
    ``device`` and kept: the thresholds of t = alpha log2|x| + beta where
    the payload code steps up depend on the format alone.  The build is
    waited for once, so any stream may read the table afterwards."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), fmt)
    table = _CODE_TABLES.get(key)
    if table is None:
        table = torch.empty(_code_table_layout()[0], dtype=torch.uint8,
                            device=device)
        rc = build.load("s2fp8_quant").s2fp8_code_table(
            table.data_ptr(), FMT_ID[fmt], build.stream_ptr(device))
        build.check(rc, "s2fp8_code_table")
        torch.cuda.current_stream(device).synchronize()
        _CODE_TABLES[key] = table
    return table


def code_thresholds(device: torch.device, fmt: str) -> torch.Tensor:
    """f32 [128] of the code table: entry k the least t whose magnitude
    code is >= k (NaN past the format's max code)."""
    _, at, count = _code_table_layout()
    return code_table(device, fmt)[at:at + 4 * count].view(torch.float32)


def code_sweep(device: torch.device, fmt: str):
    """(mismatches, least mismatching f32 pattern or None): the code
    table's byte against the direct map's (to_fp8 of +-exp2f(t)) for every
    one of the 2^32 f32 bit patterns t, both signs, on the card."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    first = torch.full((1,), -1, dtype=torch.int32, device=device)
    rc = build.load("s2fp8_quant").s2fp8_code_sweep(
        code_table(device, fmt).data_ptr(), FMT_ID[fmt], bad.data_ptr(),
        first.data_ptr(), build.stream_ptr(device))
    build.check(rc, "s2fp8_code_sweep")
    n = int(bad.item())
    return n, (int(first.item()) & 0xFFFFFFFF if n else None)


def fused_capacity(device: torch.device, dtype=torch.float32,
                   registers: bool = False) -> int:
    """The most elements of ``dtype`` that quantize-with-stats and the
    fused truncate keep across their grid barrier on ``device``'s card (a
    tensor up to that size is read once and takes one log2 an element, bar
    its edge elements; a larger one is read a second time past that many);
    with ``registers``, the part kept in registers, the rest being in
    shared memory."""
    out = torch.zeros(2, dtype=torch.int64)
    with torch.cuda.device(device):
        rc = build.load("s2fp8_quant").s2fp8_fused_capacity(
            out.data_ptr(), DTYPE_ID[dtype])
    build.check(rc, "s2fp8_fused_capacity")
    return int(out[1 if registers else 0])


_TICKETS = {}


def ticket(device: torch.device) -> torch.Tensor:
    """The int32 ticket on which the stats kernel and the fused kernels
    count their blocks in, on ``device``'s current stream: one zeroed word
    per device and stream, kept.  The last block of a launch sets it back
    to 0, so launches in one stream's order share it and no launch clears
    it."""
    key = (device.index, build.stream_ptr(device))
    t = _TICKETS.get(key)
    if t is None:
        t = torch.zeros(1, dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def _stats_outputs(x: torch.Tensor):
    """(scratch, triplet, ab) for one stats launch on x's device."""
    scratch = torch.empty(_STATS_SCRATCH_BYTES, dtype=torch.uint8,
                          device=x.device)
    out = torch.empty(5, dtype=torch.float32, device=x.device)
    return scratch, out[:3], out[3:]


@kernel_entry("stats")
def stats_partials(x: torch.Tensor,
                   target_max: float = s2fp8.TARGET_MAX_LOG2):
    """(triplet f32 [3], ab f32 [2]) of ``x`` (f32 or bf16, any shape):
    the Eq. 3-4 reduction and the (alpha, beta) it gives for a range of
    2^target_max, in one launch.  CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return stats_partials_plain(x, target_max)
    check_cuda_operand(x, "x", tuple(DTYPE_ID))
    scratch, triplet, ab = _stats_outputs(x)
    rc = build.load("s2fp8_quant").s2fp8_stats(
        x.data_ptr(), DTYPE_ID[x.dtype], x.numel(), scratch.data_ptr(),
        scratch.numel(), ticket(x.device).data_ptr(),
        triplet.data_ptr(), ab.data_ptr(), target_max,
        build.stream_ptr(x.device))
    build.check(rc, "s2fp8_stats")
    stats_partials.launches += 1
    return triplet, ab


@kernel_entry("quant")
def quant(x: torch.Tensor, fmt: str = "e5m2"):
    """(payload, ab): ``x`` quantized with its own exact stats for
    ``fmt`` — one cooperative launch (the stats, one grid barrier, the
    encode of the kept log2).  CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return quant_plain(x, fmt)
    check_cuda_operand(x, "x", tuple(DTYPE_ID))
    scratch, triplet, ab = _stats_outputs(x)
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    rc = build.load("s2fp8_quant").s2fp8_quant(
        x.data_ptr(), DTYPE_ID[x.dtype], out.data_ptr(), x.numel(),
        scratch.data_ptr(), scratch.numel(),
        ticket(x.device).data_ptr(), triplet.data_ptr(), ab.data_ptr(),
        s2fp8.FMT_TARGET_MAX[fmt], FMT_ID[fmt],
        code_table(x.device, fmt).data_ptr(), build.stream_ptr(x.device))
    build.check(rc, "s2fp8_quant")
    quant.launches += 1
    return out.view(s2fp8.FMT_QDTYPE[fmt]), ab


@kernel_entry("truncate_fused")
def truncate_fused(x: torch.Tensor, fmt: str = "e5m2"):
    """(out, ab): the Eq. 5 round trip of ``x`` with its own exact stats,
    out in ``x``'s dtype — one cooperative launch (the stats, one grid
    barrier, Eq. 5 of the kept log2).  CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return truncate_fused_plain(x, fmt)
    check_cuda_operand(x, "x", tuple(DTYPE_ID))
    scratch, triplet, ab = _stats_outputs(x)
    out = torch.empty_like(x)
    rc = build.load("s2fp8_quant").s2fp8_truncate_fused(
        x.data_ptr(), DTYPE_ID[x.dtype], out.data_ptr(), x.numel(),
        scratch.data_ptr(), scratch.numel(),
        ticket(x.device).data_ptr(), triplet.data_ptr(), ab.data_ptr(),
        s2fp8.FMT_TARGET_MAX[fmt], FMT_ID[fmt],
        code_table(x.device, fmt).data_ptr(), build.stream_ptr(x.device))
    build.check(rc, "s2fp8_truncate_fused")
    truncate_fused.launches += 1
    return out, ab


@kernel_entry("quant_apply")
def quant_apply(x: torch.Tensor, stats, fmt: str = "e5m2") -> torch.Tensor:
    """8-bit payload of ``x`` (same shape, float8 dtype of ``fmt``) under
    the given (alpha, beta).  CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return quant_apply_plain(x, stats, fmt)
    check_cuda_operand(x, "x", tuple(DTYPE_ID))
    ab = stats_arg(stats, x.device)
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    rc = build.load("s2fp8_quant").s2fp8_quant_apply(
        x.data_ptr(), DTYPE_ID[x.dtype], out.data_ptr(), x.numel(),
        ab.data_ptr(), FMT_ID[fmt], code_table(x.device, fmt).data_ptr(),
        build.stream_ptr(x.device))
    build.check(rc, "s2fp8_quant_apply")
    quant_apply.launches += 1
    return out.view(s2fp8.FMT_QDTYPE[fmt])


@kernel_entry("truncate_apply")
def truncate_apply(x: torch.Tensor, stats, fmt: str = "e5m2") -> torch.Tensor:
    """Eq. 5 round trip of ``x`` under the given (alpha, beta), returned in
    ``x``'s dtype (f32 or bf16).  CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return truncate_apply_plain(x, stats, fmt)
    check_cuda_operand(x, "x", tuple(DTYPE_ID))
    ab = stats_arg(stats, x.device)
    out = torch.empty_like(x)
    rc = build.load("s2fp8_quant").s2fp8_truncate_apply(
        x.data_ptr(), DTYPE_ID[x.dtype], out.data_ptr(), x.numel(),
        ab.data_ptr(), FMT_ID[fmt], code_table(x.device, fmt).data_ptr(),
        build.stream_ptr(x.device))
    build.check(rc, "s2fp8_truncate_apply")
    truncate_apply.launches += 1
    return out


@kernel_entry("dequant")
def dequant(payload: torch.Tensor, stats) -> torch.Tensor:
    """f32 values of a float8 payload (same shape; the format is the
    payload's dtype) under the given (alpha, beta).  CPU tensors take the
    plain version."""
    if payload.device.type == "cpu":
        return dequant_plain(payload, stats)
    check_cuda_operand(payload, "payload", tuple(PAYLOAD_FMT))
    ab = stats_arg(stats, payload.device)
    out = torch.empty(payload.shape, dtype=torch.float32,
                      device=payload.device)
    rc = build.load("s2fp8_quant").s2fp8_dequant(
        payload.data_ptr(), out.data_ptr(), payload.numel(), ab.data_ptr(),
        FMT_ID[PAYLOAD_FMT[payload.dtype]], build.stream_ptr(payload.device))
    build.check(rc, "s2fp8_dequant")
    dequant.launches += 1
    return out


quant_apply.launches = 0
truncate_apply.launches = 0
dequant.launches = 0
stats_partials.launches = 0
quant.launches = 0
truncate_fused.launches = 0
