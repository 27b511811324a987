"""The launch plan and the arithmetic order of csrc/dense_w8a8.cu, the kernel
of #16 fused_proj_mlp_q8a8 (ops/w8a8_kernel.py::w8a8_plan), which runs only
on the card.

The work split is restated here from the kernel's loops (producer and
consumers walk the same order): wo's product (phase 1), w1's (phase A) and
w2's (phase B) each cut into row tiles, the cluster's weight row tiles j =
cid, cid + clusters, ... and the CTA's K-chunks of its rank's K-slice; each
cluster reduces its ranks' partial tiles, rank r owning row pairs
[pair_lo(r), pair_lo(r + 1)) of a tile. Checked at B 1, 37, 100, 300 and
500 and every head width: each (row, output column) of each product once,
each K element reduced once, only row tiles whose warpgroup halves are N
values of the s8 wgmma, shared memory within a CTA's 232,448 bytes, every
(row, hidden tile) of t quantized once and every (row, chunk) scale
written once; each CTA's phase-B K-slice folded at chunk boundaries, every
64-wide K tile inside one chunk. Then the kernel's arithmetic order,
restated in torch ops (int32 split-K partials, LN2's statistics from
per-tile sums, the fp32 chunk sums folded per K-slice and summed in rank
order), held to the plain version and to the JAX kernel in interpret mode
at test_torch_w8a8.py's shapes (B 3, C 128, H 512, chunks 128 and 256,
fp32 activations) with that file's tolerance: 2e-5 plus what the entries of
hq and tq that differ by one explain at the output. Last, the refusals
before the library and the wrappers' CPU paths.
"""

import contextlib

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_w8a8 import B, C, EXP, H, TOL, _check_flips, _jax_steps, _layer  # noqa: F401 (EXP: a fixture)

from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from rqvae_tpu_torch.ops import q8_pipeline_kernel as QP
from rqvae_tpu_torch.ops import w8a8_kernel as W8

SMEM = 232_448
ROWS = (1, 37, 100, 300, 500)


def _chunk(C_):
    """The experiment's chunk at C 1536; H itself elsewhere."""
    return 1536 if C_ == 1536 else 4 * C_


def _pair_lo(r, P, s):
    return (r * P) // s


def _restated_units(plan, cta):
    """CTA cta's (product, row tile, weight row tile, K-chunk) in the
    kernel's order, from csrc/dense_w8a8.cu's loops."""
    cid, rank = divmod(cta, plan.cluster)
    C_, H_ = plan.C, plan.H
    for prod, (tiles, k) in enumerate(((C_ // 64, C_), (H_ // 64, C_), (C_ // 64, H_))):
        ks = k // plan.cluster
        for rt in range(plan.row_tiles):
            for j in range(cid, tiles, plan.clusters):
                for kc in range(ks // 64):
                    yield prod, rt, j, (rank * ks) // 64 + kc


def _quantized(plan, cta):
    """The (row, hidden tile) units of t that CTA cta quantizes (csrc/
    dense_w8a8.cu quantize_t: its cluster's tiles, its rank's row pairs of
    every row tile), and the (row, chunk) scales it writes (a chunk's first
    tile)."""
    cid, rank = divmod(cta, plan.cluster)
    P = plan.row_tile // 2
    r0, r1 = 2 * _pair_lo(rank, P, plan.cluster), 2 * _pair_lo(rank + 1, P, plan.cluster)
    per_chunk = plan.chunk // 64
    units, scales = [], []
    for rt in range(plan.row_tiles):
        for j in range(cid, plan.H // 64, plan.clusters):
            for r in range(r0, r1):
                units.append((rt * plan.row_tile + r, j))
                if j % per_chunk == 0:
                    scales.append((rt * plan.row_tile + r, j // per_chunk))
    return units, scales


def _layout(plan):
    """csrc/dense_w8a8.cu w8_layout, restated: (stage, panel, red, total);
    phase A's s8 hq panel (ks / 64 blocks of mt x 64 bytes) takes the bf16
    y panel's bytes (ks / 64 blocks of mt x 128)."""
    mt, ks = plan.row_tile, plan.C // plan.cluster
    stage = -(-(4096 + mt * 64) // 1024) * 1024
    panel = plan.stages * stage
    red = panel + ks // 64 * mt * 128
    total = red + (mt // 2 + 8) * 512 + mt * 4 + (2 * plan.stages + 4) * 8 + 1024
    return stage, panel, red, total


def _check_plan(M, C_):
    H_ = 4 * C_
    plan = W8.w8a8_plan(M, C_, H_, _chunk(C_))
    s = plan.cluster
    # the launch fits the card
    assert s in (1, 2, 4, 8) and C_ % (64 * s) == 0 and s * plan.clusters <= 132
    assert plan.clusters <= H_ // 64
    assert plan.row_tile in W8.ROW_TILES and (plan.row_tiles - 1) * plan.row_tile < M <= plan.row_tiles * plan.row_tile
    # each warpgroup's wgmma takes an N the s8 instruction has
    assert plan.warpgroup_rows() in W8.S8_WGMMA_N
    assert plan.warpgroup_rows() == (plan.row_tile // 2 if plan.row_tile > W8.SPLIT_ROWS else plan.row_tile)
    assert 4 <= plan.stages <= 16
    stage, panel, red, total = _layout(plan)
    assert plan.smem == W8.smem_bytes(plan.row_tile, C_ // s, plan.stages) == total <= SMEM
    # the TMA and the wgmma descriptors' swizzles: the stages and the panel 1024-aligned
    assert stage % 1024 == 0 and panel % 1024 == 0 and red % 16 == 0
    # every (row tile, weight row tile, K-chunk) of each product once: each
    # (row, output column) computed once, each K element reduced once
    counts = [np.zeros((plan.row_tiles, C_ // 64, C_ // 64), np.int32),
              np.zeros((plan.row_tiles, H_ // 64, C_ // 64), np.int32),
              np.zeros((plan.row_tiles, C_ // 64, H_ // 64), np.int32)]
    for cta in range(s * plan.clusters):
        for prod, rt, j, kc in _restated_units(plan, cta):
            counts[prod][rt, j, kc] += 1
    for c in counts:
        assert (c == 1).all(), np.unique(c)
    seen = {(i, m0 // plan.row_tile, j, k0 // 64) for cta in range(s * plan.clusters)
            for i, m0, j, k0 in plan.units(cta)}
    assert len(seen) == sum(c.size for c in counts)
    # each row pair of a partial tile has one owner in the cluster
    P = plan.row_tile // 2
    owners = [((mp + 1) * s - 1) // P for mp in range(P)]
    for r in range(s):
        assert [mp for mp in range(P) if owners[mp] == r] == list(range(_pair_lo(r, P, s), _pair_lo(r + 1, P, s)))
    # the warpgroups' partials push every pair once (lane l of fragment J:
    # pair pair0 + 4 J + l % 4; a split tile's second warpgroup from NW / 2 on)
    nw = plan.warpgroup_rows()
    halves = 2 if nw < plan.row_tile else 1
    assert sorted(w * (nw // 2) + 4 * J + q for w in range(halves) for J in range(nw // 8) for q in range(4)) == \
        list(range(P))
    # t quantized once per (row, hidden tile), each (row, chunk) scale written once
    m_pad = plan.row_tiles * plan.row_tile
    t_units, ts_units = np.zeros((m_pad, H_ // 64), np.int32), np.zeros((m_pad, H_ // plan.chunk), np.int32)
    for cta in range(s * plan.clusters):
        units, scales = _quantized(plan, cta)
        for u in units:
            t_units[u] += 1
        for u in scales:
            ts_units[u] += 1
    assert (t_units == 1).all() and (ts_units == 1).all()
    # the hq pass: CTA b takes rows b, b + grid, ...: every row once
    grid = s * plan.clusters
    assert sorted(m for b in range(grid) for m in range(b, m_pad, grid)) == list(range(m_pad))
    return plan


@pytest.mark.parametrize("C_", DK.WIDTHS)
@pytest.mark.parametrize("M", ROWS)
def test_plan_covers_each_output_and_reduction_once(M, C_):
    _check_plan(M, C_)


def test_smem_is_the_source_notes_arithmetic():
    """B 100, C 1536: cluster 4, one 128-row tile split between the
    warpgroups (64 rows each), seven stages of an int8 weight tile and an 8
    KB tq tile, the 96 KB bf16 y panel (phase A's 48 KB hq panel in its
    bytes), the 36 KB reduction buffer, hs per row, 18 mbarriers, the
    alignment slack."""
    plan = W8.w8a8_plan(100, 1536, 6144, 1536)
    assert (plan.cluster, plan.clusters, plan.row_tile, plan.row_tiles, plan.stages) == (4, 33, 128, 1, 7)
    assert plan.warpgroup_rows() == 64
    assert plan.smem == 7 * 12288 + 98304 + 36864 + 512 + 18 * 8 + 1024 == 222_864


@pytest.mark.parametrize("most", [1, 7, 32])
def test_plan_keeps_to_the_co_resident_clusters(most):
    plan = W8.w8a8_plan(100, 1536, 6144, 1536, max_clusters=lambda *a: most)
    assert plan.clusters <= most
    counts = {}
    for cta in range(plan.cluster * plan.clusters):
        for unit in _restated_units(plan, cta):
            counts[unit] = counts.get(unit, 0) + 1
    assert set(counts.values()) == {1}
    assert len(counts) == plan.row_tiles * (24 * 24 + 2 * 96 * 24)


@pytest.mark.parametrize("chunk", [64, 384, 768, 1536, 3072, 6144])
def test_k_slices_fold_at_chunk_boundaries(chunk):
    """Phase B's K-slice of every CTA, in every cluster size, as the kernel
    folds it (W8Plan.folds, csrc/dense_w8a8.cu k_loop_s8): runs of 64-wide K
    tiles that together are the slice, each inside one chunk, each ending at
    its chunk's end or the slice's; so each chunk's scale multiplies only
    its own sums."""
    C_, H_ = 1536, 6144
    for s in DK.CLUSTER_SIZES:
        plan = W8.W8Plan(100, C_, H_, chunk, s, 1, 112, 1, 5, 0)
        for rank in range(s):
            ks = H_ // s
            runs = plan.folds(rank)
            bounds = [start for start, _ in runs] + [(rank + 1) * ks]
            assert bounds[0] == rank * ks and bounds == sorted(bounds)
            for (start, ch), end in zip(runs, bounds[1:]):
                assert start % 64 == 0 and end % 64 == 0 and start < end
                assert ch * chunk <= start and end <= (ch + 1) * chunk  # every K tile of the run in chunk ch
                assert end == (ch + 1) * chunk or end == (rank + 1) * ks


def _emulated(port, gelu, chunk, s):
    """The kernel's arithmetic order on a cluster of s CTAs, restated in
    torch ops on the CPU (x's dtype for the casts, as the plain version):
    wo's fp32 split-K partials summed in rank order; LN2's statistics from
    per-64-column partial sums taken in tile order; h, hq and hs as
    q8a8_steps; w1's split-K partials as exact integers; t and its chunks'
    tq, ts; w2's int32 sums over each fold run of each rank's K-slice
    (W8Plan.folds) scaled by the run's ts and added into the rank's fp32
    partial, the partials summed in rank order. Returns (out, {"hq", "tq",
    "ts"})."""
    x, y, wo_q, wo_s, bo, lns, lnb, w1_q, w1_s, b1, w2_q, w2_s, b2 = port
    dt = x.dtype
    M, C_ = x.shape
    H_ = w1_q.shape[0]
    kc = C_ // s
    acc_o = sum((y[:, r * kc:(r + 1) * kc].float() @ wo_q[:, r * kc:(r + 1) * kc].float().t() for r in range(s)))
    x2 = x + (acc_o * wo_s.float() + bo.float()).to(dt)
    v = x2.float()
    s1 = sum(v[:, j * 64:(j + 1) * 64].sum(-1) for j in range(C_ // 64))
    s2 = sum((v[:, j * 64:(j + 1) * 64] ** 2).sum(-1) for j in range(C_ // 64))
    mean = s1 / C_
    rstd = torch.rsqrt((s2 / C_ - mean * mean).clamp_min(0.0) + DK.LN_EPS)
    h = ((v - mean[:, None]) * rstd[:, None]) * lns.float() + lnb.float()
    hq, hs = W8._quant_rows(h)
    S = sum(hq[:, r * kc:(r + 1) * kc].long() @ w1_q[:, r * kc:(r + 1) * kc].long().t() for r in range(s))
    t = DK._gelu32((S.float() * hs) * w1_s.float() + b1.float(), gelu)
    tq, ts = zip(*(W8._quant_rows(t[:, j * chunk:(j + 1) * chunk]) for j in range(H_ // chunk)))
    tq_all = torch.cat(tq, 1)
    plan = W8.W8Plan(M, C_, H_, chunk, s, 1, 8, 1, 4, 0)
    acc = None
    for r in range(s):
        part = torch.zeros((M, C_), dtype=torch.float32)
        runs = plan.folds(r)
        ends = [start for start, _ in runs[1:]] + [(r + 1) * (H_ // s)]
        for (start, ch), end in zip(runs, ends):
            sums = tq_all[:, start:end].long() @ w2_q[:, start:end].long().t()
            part = part + sums.float() * ts[ch]
        acc = part if acc is None else acc + part
    out = x2 + (acc * w2_s.float() + b2.float()).to(dt)
    return out, dict(hq=hq, tq=list(tq), ts=list(ts))


def _bound(port, chunk, tq_a, ts_a, tq_b, ts_b):
    """test_torch_w8a8.py's output bound between two runs of the function:
    TOL plus what their tq and ts entries that differ explain."""
    w2 = np.abs(port[10].numpy().astype(np.float64)) * port[11].float().numpy()[:, None]  # |w2_q| s_2 [C, H]
    explained = np.zeros((B, C))
    for j in range(H // chunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        sa, qa = np.asarray(ts_a[j], np.float64), np.asarray(tq_a[j])
        sb, qb = np.asarray(ts_b[j], np.float64), np.asarray(tq_b[j])
        dq = _check_flips(f"tq_{j}", qa, qb)
        explained += (sa * dq) @ w2[:, sl].T + np.abs(sa - sb) * np.abs(qb) @ w2[:, sl].T
    return TOL + explained


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("gelu", ["v1", "v2"])
def test_kernel_order_within_tolerance_of_plain_and_jax(EXP, gelu, chunk):  # noqa: F811
    jargs, port = _layer(50 + chunk // 128)
    want_plain, st = W8.q8a8_steps(*port, gelu_version=gelu, chunk=chunk)
    with pltpu.force_tpu_interpret_mode():
        want_jax = np.asarray(EXP.fused_proj_mlp_q8a8(*jargs, gelu_version=gelu, chunk=chunk))
    hq_j, _, tq_j, ts_j = _jax_steps(EXP, jargs, gelu, chunk)
    for s in (1, 2, 4):
        got, em = _emulated(port, gelu, chunk, s)
        assert got.dtype == torch.float32 and got.shape == (B, C)
        _check_flips("hq", em["hq"].numpy(), st["hq"].numpy())
        _check_flips("hq", em["hq"].numpy(), hq_j)
        bound = _bound(port, chunk, em["tq"], [t.numpy() for t in em["ts"]], st["tq"], [t.numpy() for t in st["ts"]])
        np.testing.assert_array_less(np.abs(got.numpy() - want_plain.numpy()), bound)
        bound = _bound(port, chunk, em["tq"], [t.numpy() for t in em["ts"]], tq_j, ts_j)
        np.testing.assert_array_less(np.abs(got.numpy() - want_jax), bound)


REFUSED = [  # (M, C, H, chunk)
    (100, 768, 3072, 768),     # C outside WIDTHS
    (100, 1536, 4096, 1024),   # H != 4C
    (0, 1536, 6144, 1536),     # no rows
    (100, 1536, 6144, 96),     # chunk % 64
    (100, 1536, 6144, 640),    # H % chunk
    (100, 1536, 6144, 0),      # no chunk
]


@pytest.mark.parametrize("M,C_,H_,chunk", REFUSED)
def test_plan_refuses_other_shapes_before_the_library(M, C_, H_, chunk, monkeypatch):
    def asked(*args, **kwargs):
        raise AssertionError("the kernel library or the device was asked")

    monkeypatch.setattr(W8._build, "library", asked)
    monkeypatch.setattr(torch.cuda, "get_device_properties", asked)
    with pytest.raises(ValueError, match="dense_w8a8"):
        W8._device_plan(M, C_, H_, chunk, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="dense_w8a8"):
        W8.w8a8_plan(M, C_, H_, chunk)


def _layer_at(C_, M=3, seed=0):
    """A layer of the port's types (bf16 activations, int8 weights) at C_, H = 4 C_."""
    r = np.random.RandomState(seed)
    H_ = 4 * C_
    bf = lambda *shape: torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    i8 = lambda *shape: torch.from_numpy(r.randint(-127, 128, shape).astype(np.int8))  # noqa: E731
    return (bf(M, C_), bf(M, C_), i8(C_, C_), bf(C_), bf(C_), bf(C_), bf(C_), i8(H_, C_), bf(H_), bf(H_), i8(C_, H_),
            bf(C_), bf(C_))


@pytest.mark.parametrize("C_,M,chunk,match", [
    (128, 3, 128, "C in"),          # C outside WIDTHS
    (512, 0, 512, "M >= 1"),        # no rows
    (512, 3, 32, "multiple of 64"),  # chunk % 64 (it divides H)
])
def test_wrapper_refuses_before_the_library(C_, M, chunk, match, monkeypatch):
    """On a CUDA device (the device kind stood in for) the wrapper refuses
    these shapes, after its type and shape checks and before the plan asks
    the library or the device anything."""
    def asked(*args, **kwargs):
        raise AssertionError("the kernel library or the device was asked")

    monkeypatch.setattr(QP, "_device_kind", lambda name, t: "cuda")
    monkeypatch.setattr(W8._build, "library", asked)
    monkeypatch.setattr(torch.cuda, "get_device_properties", asked)
    monkeypatch.setattr(W8.DK, "_device", lambda x: contextlib.nullcontext())
    p = _layer_at(C_, M)
    n = W8.fused_proj_mlp_q8a8.launches
    with pytest.raises(ValueError, match=match):
        W8.fused_proj_mlp_q8a8(*p, chunk=chunk)
    assert W8.fused_proj_mlp_q8a8.launches == n


def test_wrappers_take_the_plain_version_on_the_cpu(monkeypatch):
    """On CPU tensors the wrapper returns its plain version, counts no launch
    and never asks the library; the first design raises."""
    def asked(*args, **kwargs):
        raise AssertionError("the kernel library was asked")

    monkeypatch.setattr(W8._build, "library", asked)
    _, port = _layer(60)
    n = W8.fused_proj_mlp_q8a8.launches
    got = W8.fused_proj_mlp_q8a8(*port, chunk=256)
    assert torch.equal(got, W8.fused_proj_mlp_q8a8_plain(*port, chunk=256))
    assert W8.fused_proj_mlp_q8a8.launches == n
    with pytest.raises(ValueError, match="fused_proj_mlp_q8a8_v1: no kernel for device cpu"):
        W8.fused_proj_mlp_q8a8_v1(*port, chunk=256)
    assert W8.fused_proj_mlp_q8a8_v1.launches == 0
