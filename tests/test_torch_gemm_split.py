"""The payload GEMM's arithmetic and its planner, rehearsed on the CPU.

The CUDA payload GEMM (``repro_torch/csrc/s2fp8_matmul.cu``) has two paths,
chosen by ``kernels.s2fp8_matmul.plan_gemm`` from the shape:

* large M: every dequantized value is split into (hi, lo) = (tf32(x),
  tf32(x - hi)), truncated, and each 8-deep step of K accumulates
  lo.hi + hi.lo + hi.hi on TF32 tensor cores ("3xTF32"); the sum of a
  32-deep stage is added to an f32 accumulator stage by stage;
* small M (decode): exact f32 FMAs, K cut into S splits, each split's
  8 K lanes summed in lane order (NN) or its 8 chunk lanes by a fixed
  butterfly (NT), the S partials summed in index order by a second kernel.

Here, in plain torch / numpy:

* an emulation of the large path at the main path's depths (K = 5760,
  2304, 2048, 1408, 256) stays within the on-card tolerance, 1e-5 *
  (|A| @ |B|) of the plain f32 product, and a one-pass emulation does not;
* an emulation of the split-K path, each split in its kernel's order,
  covers K once, stays within that tolerance, and gives the same bits
  whatever order the blocks run in;
* the checked engine's raw-GEMM bound at the tied head's depth passes
  the emulation and rejects a result with one wrong output tile;
* the planner gives every GEMM shape that ``chip_smoke.py`` checks, and
  every decode GEMM of the served models, a path, and its decode grids
  cover at least two waves of an H100's 132 SMs;
* the GEMMs ``chip_smoke.py`` holds for the attention family's full-width
  phases are their configs' weights at the main path's rows.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro_torch.core import s2fp8
from repro_torch.kernels import ref
from repro_torch.kernels import s2fp8_matmul as mm

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(rng, m, k, n, fmt="e5m2"):
    """Dequantized payload operands A [m, k], B [k, n] (f32 values on the
    format's grid) and |A| @ |B|, the tolerance's scale."""
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    ta = s2fp8.quantize(a, fmt=fmt)
    tb = s2fp8.quantize(b / k ** 0.5, fmt=fmt)
    da = ref.s2fp8_dequant_ref(ta.payload, ta.ab)
    db = ref.s2fp8_dequant_ref(tb.payload, tb.ab)
    return da, db, da.abs() @ db.abs()


def large_path_emulated(a, b, passes=3, stage=32):
    """The large path's arithmetic: per 8-deep step of K, lo.hi, hi.lo and
    hi.hi (or hi.hi alone for ``passes=1``) added in that order to the
    stage's sum, each 8-term product in f32; each stage's sum added to the
    f32 accumulator."""
    m, k = a.shape
    pad = -k % stage
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ah, al = ref.split_tf32(a)
    bh, bl = ref.split_tf32(b)

    def steps(x, y):   # [K/8, m, n]: each 8-deep step's product
        return torch.bmm(x.reshape(m, -1, 8).transpose(0, 1),
                         y.reshape(-1, 8, y.shape[1]))

    terms = ([steps(al, bh), steps(ah, bl), steps(ah, bh)] if passes == 3
             else [steps(ah, bh)])
    acc = torch.zeros(m, b.shape[1])
    for s0 in range(0, a.shape[1] // 8, stage // 8):
        part = torch.zeros_like(acc)
        for j in range(s0, s0 + stage // 8):
            for t in terms:
                part = part + t[j]
        acc = acc + part
    return acc


@pytest.mark.parametrize("k", [5760, 2304, 2048, 1408, 256])
def test_three_passes_hold_the_card_tolerance_one_does_not(k):
    rng = np.random.default_rng(k)
    a, b, scale = _operands(rng, 32, k, 32)
    want = a @ b                       # the plain version's f32 product
    got = large_path_emulated(a, b)
    assert bool(((got - want).abs() <= TOL * scale + 1e-30).all())
    worst = ((got - want).abs() / scale).max().item()
    assert worst < TOL / 10            # with a wide margin
    one = large_path_emulated(a, b, passes=1)
    assert not bool(((one - want).abs() <= TOL * scale + 1e-30).all())


def nn_small_emulated(a, b, plan, order=None):
    """The small NN kernel's sums, in f32: split s takes K rows
    [s * kchunk, (s + 1) * kchunk); K lane y of a split takes rows y, y + 8,
    ... in order; the 8 lanes are added in lane order, then the partials in
    split order.  ``order``: the order in which the splits run."""
    a = a.numpy().astype(np.float32)
    b = b.numpy().astype(np.float32)
    m, k = a.shape
    parts = np.zeros((plan.splits, m, b.shape[1]), np.float32)
    for s in (order if order is not None else range(plan.splits)):
        lanes = np.zeros((8, m, b.shape[1]), np.float32)
        for kk in range(s * plan.kchunk, min(k, (s + 1) * plan.kchunk)):
            y = (kk - s * plan.kchunk) % 8
            lanes[y] = lanes[y] + a[:, kk, None] * b[kk][None, :]
        total = np.zeros_like(lanes[0])
        for y in range(8):
            total = total + lanes[y]
        parts[s] = total
    out = np.zeros_like(parts[0])
    for s in range(plan.splits):
        out = out + parts[s]
    return torch.from_numpy(out)


def nt_small_emulated(a, bt, plan):
    """The small NT kernel's sums (one split): chunk lane c of a row takes
    16-deep chunks c, c + 8, ... in order, 16 products each; the 8 lanes
    meet by a butterfly over xor distances 1, 2, 4; lane 0's sum is the
    output."""
    assert plan.splits == 1
    a = a.numpy().astype(np.float32)
    bt = bt.numpy().astype(np.float32)
    m, k = a.shape
    lanes = np.zeros((8, m, bt.shape[0]), np.float32)
    for c in range(-(-k // 16)):
        for kk in range(16 * c, min(k, 16 * c + 16)):
            lanes[c % 8] = lanes[c % 8] + a[:, kk, None] * bt[None, :, kk]
    for off in (1, 2, 4):
        lanes = np.stack([lanes[i] + lanes[i ^ off] for i in range(8)])
    return torch.from_numpy(lanes[0])


@pytest.mark.parametrize("k,n", [(2304, 96), (5760, 40), (300, 200)])
def test_split_k_partition_and_fixed_order_sum(k, n):
    plan = mm.plan_gemm(8, n, k)
    assert plan.path == "small" and plan.splits > 1
    assert plan.kchunk % 16 == 0 and plan.kchunk <= mm.SMALL_KCHUNK_MAX
    # every K row lies in exactly one split, and no split is empty
    assert (plan.splits - 1) * plan.kchunk < k <= plan.splits * plan.kchunk
    rng = np.random.default_rng(k + n)
    a, b, scale = _operands(rng, 8, k, n)
    got = nn_small_emulated(a, b, plan)
    assert bool(((got - a @ b).abs() <= TOL * scale + 1e-30).all())
    shuffled = rng.permutation(plan.splits)
    assert torch.equal(got, nn_small_emulated(a, b, plan, order=shuffled))


def test_small_nt_head_order_holds_the_tolerance():
    k, n = 2304, 300
    plan = mm.plan_gemm(8, 122753, k, layout="nt")
    assert plan.path == "small" and plan.splits == 1
    rng = np.random.default_rng(5)
    a, b, scale = _operands(rng, 8, k, n)
    got = nt_small_emulated(a, b.t().contiguous(), plan)
    assert bool(((got - a @ b).abs() <= TOL * scale + 1e-30).all())


def _gemm_shapes():
    """(layout, m, k, n, g) of every GEMM chip_smoke.py holds on the card;
    g is the output slice count of a batched GEMM (None for 2-D)."""
    cs = _chip_smoke()
    shapes = [("nn", m, k, n, None) for m, k, n in cs.GEMMS_NN]
    shapes += [(lay, m, k, n, None) for lay, ss in cs.GEMMS_NT_TN.items()
               for m, k, n in ss]
    shapes.append(("nt",) + tuple(cs.GEMM_HEAD_DECODE) + (None,))
    shapes += [(lay, m, k, n, ob or max(ga, gb))
               for lay, ga, gb, ob, m, k, n in cs.GEMMS_BATCHED]
    return shapes


# decode GEMMs (8 slots) of the served models, (layout, K, N): minicpm_2b's
# attention projections, MLP and tied head; falcon_mamba_7b's in, x, dt and
# out projections and its head
DECODE = [("nn", 2304, 2304), ("nn", 2304, 5760), ("nn", 5760, 2304),
          ("nt", 2304, 122753), ("nn", 4096, 16384), ("nn", 8192, 288),
          ("nn", 256, 8192), ("nn", 8192, 4096), ("nn", 4096, 65024),
          ("nt", 4096, 65024)]


def test_planner_covers_every_checked_shape():
    shapes = _gemm_shapes()
    assert len(shapes) == 22
    for layout, m, k, n, g in shapes:
        plan = mm.plan_gemm(m, n, k, g=g, layout=layout)
        if g is None and layout != "tn" and m <= mm.SMALL_M:
            assert plan.path == "small", (layout, m, k, n)
            assert plan.grid[0] * plan.grid[1] >= 2 * mm.SMS
            assert (plan.splits - 1) * plan.kchunk < k
            assert k <= plan.splits * plan.kchunk
        else:
            assert plan.path == "large", (layout, m, k, n, g)
            assert plan.bm == (64 if m <= 64 else 128)
            assert plan.grid == (-(-n // mm.LARGE_BN), -(-m // plan.bm),
                                 g or 1)
    m, k, n = _chip_smoke().GEMM_HEAD_DECODE
    head = mm.plan_gemm(m, n, k, layout="nt")
    assert head.splits == 1          # its column tiles fill the card


@pytest.mark.parametrize("layout,k,n", DECODE)
def test_planner_decode_grids_fill_the_card(layout, k, n):
    plan = mm.plan_gemm(8, n, k, layout=layout)
    assert plan.path == "small"
    assert plan.grid[0] * plan.grid[1] >= 2 * mm.SMS
    assert (plan.splits - 1) * plan.kchunk < k <= plan.splits * plan.kchunk
    assert plan.kchunk <= mm.SMALL_KCHUNK_MAX


def test_planner_edges():
    assert mm.plan_gemm(16, 200, 300).path == "small"
    assert mm.plan_gemm(17, 200, 300).path == "large"
    assert mm.plan_gemm(17, 200, 300).bm == 64
    assert mm.plan_gemm(65, 200, 300).bm == 128
    assert mm.plan_gemm(8, 200, 300, layout="tn").path == "large"
    assert mm.plan_gemm(8, 200, 300, g=4).path == "large"
    tiny = mm.plan_gemm(1, 1, 1)
    assert (tiny.splits, tiny.kchunk) == (1, 16)
    with pytest.raises(ValueError):
        mm.plan_gemm(8, 8, 8, layout="tt")


def test_rows_padded_to_sixteen_bytes():
    """Payloads whose rows are not 16-byte multiples are copied into rows
    that are, padded with code 0, which decodes to 0."""
    p = torch.arange(3 * 77, dtype=torch.int32).remainder(251).to(
        torch.uint8).reshape(3, 77).view(torch.float8_e5m2)
    q, ld = mm._aligned(p)
    assert ld == 80 and q.shape == (3, 80)
    assert torch.equal(q[:, :77], p.view(torch.uint8))
    assert not q[:, 77:].any()
    zero = torch.zeros(1, dtype=torch.uint8).view(torch.float8_e5m2)
    assert ref.s2fp8_dequant_ref(zero, torch.tensor([0.7, 3.0])).item() == 0
    same, ld = mm._aligned(torch.zeros(4, 32, dtype=torch.uint8))
    assert ld == 32 and same.shape == (4, 32)


# the attention family's full-width configs by the word that names them in
# chip_smoke.py's GEMMS_FAMILY rows
FAMILY_ARCHS = {"gemma3": "gemma3_1b", "stablelm": "stablelm_12b",
                "nemotron": "nemotron_4_340b"}
FAMILY_ROWS = [(layout, row) for layout, rows in
               _chip_smoke().GEMMS_FAMILY.items() for row, _ in rows]


def _weights(arch):
    """(K, N) of the config's projection, MLP and head weights [in, out],
    and the head's alone."""
    from repro_torch.configs import get_config
    c = get_config(arch)
    d, hd, ff = c.d_model, c.resolved_head_dim, c.d_ff
    head = (d, c.vocab)
    return {(d, c.n_heads * hd), (d, c.kv_heads * hd), (c.n_heads * hd, d),
            (d, ff), (ff, d), head}, head


@pytest.mark.parametrize("layout,row", FAMILY_ROWS)
def test_family_gemm_shapes_are_the_configs(layout, row):
    """Every GEMM that chip_smoke.py holds for the attention family's
    full-width phases is one of its config's weights in the layout the
    main path runs it (NN forward X @ W, and the tied head's dX = dlogits
    @ E; NT dX = dY @ W^T, and the tied head's X @ E^T; TN dW = X^T @ dY),
    at the main path's rows (8 slots at decode, 8 rows x a power-of-two
    bucket at prefill, 1 x 4,096 tokens in training), on the path the
    planner gives those rows."""
    shapes = dict(_chip_smoke().GEMMS_FAMILY[layout])[row]
    arch = next(a for w, a in FAMILY_ARCHS.items() if w in row.split())
    ws, head = _weights(arch)
    for m, k, n in shapes:
        rows = k if layout == "tn" else m
        if layout == "nn":
            assert (k, n) in ws or (n, k) == head, (m, k, n)
        elif layout == "nt":
            assert (n, k) in ws or (k, n) == head, (m, k, n)
        else:
            assert (m, n) in ws or (n, m) == head, (m, k, n)
        plan = mm.plan_gemm(m, n, k, layout=layout)
        if "decode" in row.split():
            assert rows == 8 and plan.path == "small", (m, k, n)
            assert (plan.splits - 1) * plan.kchunk < k
            assert k <= plan.splits * plan.kchunk
            assert plan.kchunk <= mm.SMALL_KCHUNK_MAX
        else:
            assert plan.path == "large", (m, k, n)
            want = 4096 if row.endswith("train") else rows
            assert rows == want and rows % 8 == 0, (m, k, n)
            bucket = rows // (1 if row.endswith("train") else 8)
            assert bucket & (bucket - 1) == 0, (m, k, n)


def test_family_batched_shapes_are_the_configs():
    """The batched GEMMs chip_smoke.py holds for the attention family:
    gemma3_1b's decode attention (8 slots x its K/V heads, its query heads
    a group the M rows, head dim 256 over the local ring and the global
    cache) and the decode probes of stablelm_12b's and nemotron_4_340b's
    calibration (2 rows x 8 K/V heads over the probe's cache of 64 + 4
    positions), all on the large path."""
    from repro_torch.configs import get_config
    rows = dict(_chip_smoke().GEMMS_BATCHED_FAMILY)
    g3 = get_config("gemma3_1b")
    hd, grp = g3.resolved_head_dim, g3.n_heads // g3.kv_heads
    want = {("nt", 8 * g3.kv_heads, grp, hd, s) for s in (g3.window, 1024)}
    want |= {("nn", 8 * g3.kv_heads, grp, s, hd) for s in (g3.window, 1024)}
    assert {(lay, ga, m, k, n) for lay, ga, gb, ob, m, k, n
            in rows["qmatmul_batched decode gemma3"]} == want
    probes = set()
    for arch in ("stablelm_12b", "nemotron_4_340b"):
        c = get_config(arch)
        hd, grp = c.resolved_head_dim, c.n_heads // c.kv_heads
        probes |= {("nt", 2 * c.kv_heads, grp, hd, 64 + 4),
                   ("nn", 2 * c.kv_heads, grp, 64 + 4, hd)}
    assert {(lay, ga, m, k, n) for lay, ga, gb, ob, m, k, n
            in rows["qmatmul_batched probe"]} == probes
    for cases in rows.values():
        for lay, ga, gb, ob, m, k, n in cases:
            assert ga == gb and ob is None
            plan = mm.plan_gemm(m, n, k, g=ga, layout=lay)
            assert plan.path == "large" and plan.bm == 64


HEAD_K = 122753      # minicpm_2b's vocab: the tied head's dX sums over it


def _head_dx_operands(rng, m, n, fmt="e5m2"):
    """The tied head's dX operands at its whole depth, dequantized:
    A = (softmax(logits) - onehot(label)) / m over the vocab, B a seeded
    embedding [vocab, n]; and |A| @ |B|."""
    logits = torch.from_numpy(
        (2.0 * rng.standard_normal((m, HEAD_K))).astype(np.float32))
    a = torch.softmax(logits, dim=1)
    a[torch.arange(m), torch.from_numpy(rng.integers(0, HEAD_K, m))] -= 1.0
    b = torch.from_numpy(
        (0.02 * rng.standard_normal((HEAD_K, n))).astype(np.float32))
    ta, tb = s2fp8.quantize(a / m, fmt=fmt), s2fp8.quantize(b, fmt=fmt)
    da = ref.s2fp8_dequant_ref(ta.payload, ta.ab)
    db = ref.s2fp8_dequant_ref(tb.payload, tb.ab)
    return da, db, da.abs() @ db.abs()


def _plant(kind, y, a, b):
    """``y`` with one 32 x 32 output tile wrong the way ``kind`` says."""
    y = y.clone()
    s = 32 * (HEAD_K // 64)                 # a K stage in the middle
    stage = a[:32, s:s + 32] @ b[s:s + 32, :32]
    if kind == "stage dropped":
        y[:32, :32] -= stage
    elif kind == "stage twice":
        y[:32, :32] += stage
    elif kind == "rows shifted":
        y[:32, :32] = y[1:33, :32]
    else:                                   # "tile scaled by <eps>"
        y[:32, :32] *= 1.0 + float(kind.split()[-1])
    return y


@pytest.mark.parametrize("operands,fault", [
    ("random", "stage dropped"), ("random", "stage twice"),
    ("random", "rows shifted"), ("random", "tile scaled by 0.03"),
    ("head dx", "stage dropped"), ("head dx", "rows shifted"),
    ("head dx", "tile scaled by 0.001")])
def test_checked_engine_rejects_a_wrong_tile_at_the_head_depth(operands,
                                                               fault):
    """The checked engine's raw-GEMM bound at the tied head's K 122,753
    (``chip_smoke.raw_close``: ``raw_tol(K)``, there its cap 4e-5 of
    |A| @ |B|): the large path's 3-pass emulation passes it (measured worst
    4.3e-8 on random operands, 3.0e-6 on the head's dX; the card's kernel
    in a full-width step 1.38e-5), and the same result with one 32 x 32
    output tile wrong fails it by at least twice the bound — a 32-deep K
    stage dropped or added twice (measured 6.0x on random operands, whose
    outputs cancel to ~1/sqrt(K) of |A| @ |B|; 21x on the head's dX,
    softmax minus one-hot over the vocab, whose outputs are about half of
    |A| @ |B|), the tile's rows read one row off (580x; 81,000x), the tile
    scaled by 3% (11x, random) or by 0.1% (20x, the head's dX).  Without
    the cap (8 sqrt(K) 2^-24 = 1.67e-4) the dropped stage on random
    operands fails by 1.4x only.  A wrong one-term K tail (122,753 =
    3,836 stages + 1) is below any bound a sound kernel passes at this
    depth; phase 3's rows at K 77 and 130 hold the tail path, and its row
    ``qmatmul_nn head dx`` holds this shape at 1e-5 of |A| @ |B| on random
    operands."""
    cs = _chip_smoke()
    rng = np.random.default_rng(11)
    a, b, scale = (_operands(rng, 64, HEAD_K, 64) if operands == "random"
                   else _head_dx_operands(rng, 64, 64))
    want = a @ b                            # the plain version's product
    got = large_path_emulated(a, b)
    ok, (worst, tol, _, _) = cs.raw_close(got, want, scale, HEAD_K)
    assert ok and worst <= tol / 4, (worst, tol)
    ok, (worst, tol, _, _) = cs.raw_close(_plant(fault, got, a, b), want,
                                          scale, HEAD_K)
    assert not ok and worst >= 2 * tol, (worst, tol)
