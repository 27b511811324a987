"""The launch plan of csrc/dense_mlp.cu (ops/dense_mlp_kernel.py::mlp_plan),
the kernel of #15 fused_mlp ("mlp" form, bf16 weights) and #20 ablate_ring
("ring" form, int8 or bf16 packed weights), which runs only on the card.

The work split is restated here from the kernel's loops (producer and
consumers walk the same order): phase A (w1 [H, C]) and phase B (w2 [C,
H]) each cut into row tiles rt, the cluster's weight row tiles j = cid,
cid + clusters, ..., and the CTA's K-chunks of its rank's K-slice; each
cluster reduces its ranks' partial tiles, rank r owning row pairs
[pair_lo(r), pair_lo(r + 1)) of a tile. Checked for every M of the
experiments and edges (1, 8, 37, 100, 128, 129, 300, 500, 512), the three
forms and every head width: each (row, output column) of each product
once, each K element of it reduced once, shared memory within a CTA's
232,448 bytes, and at B 500 the weights streamed at most twice (where a
256-row panel fits). Also: #20's packed-w2 tile coordinates against
unpack_w2, the refusals before the library, the co-resident clusters, and
the wrappers' CPU paths (plain versions, no launch counted; the first
designs raise on the CPU). The plain versions themselves are held against
JAX by test_torch_mlp_kernel.py and test_torch_q8_pipeline.py.
"""

import numpy as np
import pytest
import torch

from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from rqvae_tpu_torch.ops import dense_mlp_kernel as DM
from rqvae_tpu_torch.ops import mlp_kernel as MK
from rqvae_tpu_torch.ops import q8_pipeline_kernel as QP

SMEM = 232_448
ROWS = (1, 8, 37, 100, 128, 129, 300, 500, 512)
FORMS = [("mlp", 2), ("ring", 1), ("ring", 2)]
FORM_IDS = ["mlp_bf16", "ring_int8", "ring_bf16"]


def _chunk(form, C):
    """The experiments' packed chunk at C 1536; H itself elsewhere ("ring")."""
    return 0 if form == "mlp" else (1536 if C == 1536 else 4 * C)


def _pair_lo(r, P, s):
    return (r * P) // s


def _restated_units(plan, cta):
    """CTA cta's (product, row tile, weight row tile, K-chunk) in the
    kernel's order, from csrc/dense_mlp.cu's loops."""
    cid, rank = divmod(cta, plan.cluster)
    for prod, (tiles, k) in enumerate(((plan.H // 64, plan.C), (plan.C // 64, plan.H))):
        ks = k // plan.cluster
        for rt in range(plan.row_tiles):
            for j in range(cid, tiles, plan.clusters):
                for kc in range(ks // 64):
                    yield prod, rt, j, (rank * ks) // 64 + kc


def _check_plan(M, C, form, wbytes):
    H = 4 * C
    plan = DM.mlp_plan(M, C, H, form, wbytes, _chunk(form, C))
    s = plan.cluster
    # the launch fits the card
    assert s in (1, 2, 4, 8) and C % (64 * s) == 0 and s * plan.clusters <= 132
    assert plan.clusters <= H // 64
    assert plan.row_tile in DM.ROW_TILES and plan.row_tile % 8 == 0
    assert (plan.row_tiles - 1) * plan.row_tile < M <= plan.row_tiles * plan.row_tile
    assert 4 <= plan.stages <= 16 and 2 <= plan.t_slots <= plan.stages
    assert plan.smem == DM.smem_bytes(plan.row_tile, C // s, plan.stages, plan.t_slots, wbytes) <= SMEM
    # phase B's t slots take the panel's bytes (the larger of the two sizes)
    panel = max((C // s // 64) * plan.row_tile * 128, plan.t_slots * plan.row_tile * 128)
    assert plan.t_slots * plan.row_tile * 128 <= panel
    # decode_dense.cuh's layout, restated: the ring of weight tiles alone, the
    # panel, the reduction buffer, (mean, rstd) per row, LN's (weight, bias)
    # of the K-slice, the mbarriers, the alignment slack
    mt = plan.row_tile
    assert plan.smem == (plan.stages * 64 * 64 * wbytes + panel + (mt // 2 + 8) * 512 + mt * 8 + (C // s) * 8
                         + (2 * plan.stages + 4) * 8 + 1024)
    # every (row tile, weight row tile, K-chunk) of both products once: each
    # (row, output column) computed once, each K element reduced once
    counts = [np.zeros((plan.row_tiles, H // 64, C // 64), np.int32),
              np.zeros((plan.row_tiles, C // 64, H // 64), np.int32)]
    for cta in range(s * plan.clusters):
        for prod, rt, j, kc in _restated_units(plan, cta):
            counts[prod][rt, j, kc] += 1
    for c in counts:
        assert (c == 1).all(), np.unique(c)
    # the plan's own enumeration (DensePlan.units) agrees
    seen = {(i, m0 // plan.row_tile, j, k0 // 64) for cta in range(s * plan.clusters)
            for i, m0, j, k0 in plan.units(cta)}
    assert len(seen) == sum(c.size for c in counts)
    # each row pair of a partial tile has one owner in the cluster
    # (csrc/decode_dense.cuh push_partial: r = ((mp + 1) s - 1) / P)
    P = plan.row_tile // 2
    owners = [((mp + 1) * s - 1) // P for mp in range(P)]
    for r in range(s):
        assert [mp for mp in range(P) if owners[mp] == r] == list(range(_pair_lo(r, P, s), _pair_lo(r + 1, P, s)))
    # the warpgroups' partials (csrc/dense_mlp.cu mlp_push: lane l of
    # fragment J holds pair pair0 + 4 J + l % 4; a tile above SPLIT_ROWS rows
    # is split, the second warpgroup's pair0 MT / 4) push every pair once
    split = plan.row_tile > DM.SPLIT_ROWS
    nw = plan.row_tile // 2 if split else plan.row_tile
    pushed = sorted(w * (nw // 2) + 4 * J + q for w in range(2 if split else 1) for J in range(nw // 8) for q in range(4))
    assert pushed == list(range(P))
    return plan


@pytest.mark.parametrize("form,wbytes", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("C", DK.WIDTHS)
@pytest.mark.parametrize("M", ROWS)
def test_plan_covers_each_output_and_reduction_once(M, C, form, wbytes):
    plan = _check_plan(M, C, form, wbytes)
    if M == 500:
        # a 256-row tile's panel holds C / s x 512 bytes: 96 KB at cluster 8
        # for C 1536 (and less below); at C 1280 (cluster 4 at most) and
        # 2560 it takes 160 KB, which leaves no room for the 68 KB reduction
        # buffer, so 192-row tiles stream the weights three times there
        assert plan.weight_passes() <= (2 if C in (512, 1024, 1536) else 3)


@pytest.mark.parametrize("form,wbytes", FORMS, ids=FORM_IDS)
def test_experiment_shapes_stream_the_weights_at_most_twice(form, wbytes):
    """The experiments' shapes (C 1536, H 6144): B 500 in two 256-row
    passes (two weight passes, not four), B 100 in one."""
    assert DM.mlp_plan(500, 1536, 6144, form, wbytes, _chunk(form, 1536)).row_tiles == 2
    assert DM.mlp_plan(500, 1536, 6144, form, wbytes, _chunk(form, 1536)).row_tile == 256
    assert DM.mlp_plan(100, 1536, 6144, form, wbytes, _chunk(form, 1536)).row_tiles == 1


def test_smem_is_the_source_notes_arithmetic():
    """B 500, C 1536, cluster 8, 256-row tiles: 7 bf16 stages (56 KB), a 96
    KB panel holding 3 t slots of 32 KB, the 68 KB reduction buffer, norm,
    LN parameters, 18 mbarriers and the alignment slack."""
    plan = DM.mlp_plan(500, 1536, 6144, "mlp", 2)
    assert (plan.cluster, plan.row_tile, plan.stages, plan.t_slots) == (8, 256, 7, 3)
    assert plan.smem == 7 * 8192 + 98304 + 69632 + 256 * 8 + 192 * 8 + 18 * 8 + 1024 == 230_032


@pytest.mark.parametrize("most", [1, 7, 32])
@pytest.mark.parametrize("form,wbytes", FORMS, ids=FORM_IDS)
def test_plan_keeps_to_the_co_resident_clusters(form, wbytes, most):
    plan = DM.mlp_plan(100, 1536, 6144, form, wbytes, _chunk(form, 1536), max_clusters=lambda *a: most)
    assert plan.clusters <= most
    counts = {}
    for cta in range(plan.cluster * plan.clusters):
        for unit in _restated_units(plan, cta):
            counts[unit] = counts.get(unit, 0) + 1
    assert set(counts.values()) == {1}
    assert len(counts) == plan.row_tiles * 2 * (6144 // 64) * (1536 // 64)


@pytest.mark.parametrize("chunk", [64, 768, 1536])
def test_packed_w2_coordinates_select_the_tile(chunk):
    """#20's producer reads w2's tile (channels c .. c + 63, K k .. k + 63)
    at w2_coords in the packed [nc, C, chunk] seen as [nc C, chunk]: the
    same values as unpack_w2(w2p)[c:c + 64, k:k + 64], for every tile."""
    C, H = 1536, 6144
    w2 = torch.from_numpy(np.random.RandomState(chunk).randint(-127, 128, (C, H), dtype=np.int8))
    w2p = QP.pack_w2(w2, chunk)
    flat = w2p.reshape(-1, chunk).numpy()
    full = QP.unpack_w2(w2p).numpy()
    np.testing.assert_array_equal(full, w2.numpy())
    for c in range(0, C, 64):
        for k in range(0, H, 64):
            col, row = DM.w2_coords(chunk, C, k, c)
            assert col + 64 <= chunk
            np.testing.assert_array_equal(flat[row:row + 64, col:col + 64], full[c:c + 64, k:k + 64])
    assert DM.w2_coords(0, C, 128, 64) == (128, 64)  # #15's w2 [C, H]


REFUSED = [  # (M, C, H, form, wbytes, chunk)
    (100, 768, 3072, "mlp", 2, 0),       # C outside WIDTHS
    (100, 1536, 4096, "mlp", 2, 0),      # H != 4C
    (0, 1536, 6144, "mlp", 2, 0),        # no rows
    (100, 1536, 6144, "mlp", 1, 0),      # #15 takes bf16 weights only
    (100, 1536, 6144, "ring", 1, 96),    # chunk % 64
    (100, 1536, 6144, "ring", 2, 1000),  # chunk % 64, H % chunk
    (100, 1536, 6144, "ring", 1, 0),     # no packed chunk
    (100, 1536, 6144, "gemm", 2, 0),     # no such form
]


@pytest.mark.parametrize("M,C,H,form,wbytes,chunk", REFUSED)
def test_plan_refuses_other_shapes_before_the_library(M, C, H, form, wbytes, chunk, monkeypatch):
    def asked(*args, **kwargs):
        raise AssertionError("the kernel library or the device was asked")

    monkeypatch.setattr(DM._build, "library", asked)
    monkeypatch.setattr(torch.cuda, "get_device_properties", asked)
    with pytest.raises(ValueError, match="dense_mlp"):
        DM._device_plan(M, C, H, form, wbytes, chunk, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="dense_mlp"):
        DM.mlp_plan(M, C, H, form, wbytes, chunk)


def test_wrappers_take_the_plain_versions_on_the_cpu(monkeypatch):
    """On CPU tensors fused_mlp and ablate_ring return their plain versions,
    count no launch and never ask the library; the first designs raise."""
    def asked(*args, **kwargs):
        raise AssertionError("the kernel library was asked")

    monkeypatch.setattr(DM._build, "library", asked)
    r = np.random.RandomState(3)
    C, H, chunk = 128, 512, 128
    x = torch.from_numpy(r.standard_normal((5, C)).astype(np.float32)).to(torch.bfloat16)
    ln_s, ln_b = torch.ones(C), torch.zeros(C)
    w1 = (torch.from_numpy(r.standard_normal((H, C)).astype(np.float32)) * 0.02).to(torch.bfloat16)
    w2 = (torch.from_numpy(r.standard_normal((C, H)).astype(np.float32)) * 0.02).to(torch.bfloat16)
    b1, b2 = torch.zeros(H, dtype=torch.bfloat16), torch.zeros(C, dtype=torch.bfloat16)
    n = (MK.fused_mlp.launches, QP.ablate_ring.launches)
    got = MK.fused_mlp(x, ln_s, ln_b, w1, b1, w2, b2, chunk=chunk)
    assert torch.equal(got, MK.fused_mlp_plain(x, ln_s, ln_b, w1, b1, w2, b2))
    w1p, w2p = QP.pack_w1(w1, chunk), QP.pack_w2(w2, chunk)
    s1 = torch.ones(H, dtype=torch.bfloat16)
    got = QP.ablate_ring(x, w1p, s1, w2p, None, chunk=chunk)
    assert torch.equal(got, QP.ablate_ring_plain(x, w1p, s1, w2p))
    assert (MK.fused_mlp.launches, QP.ablate_ring.launches) == n
    with pytest.raises(ValueError, match="fused_mlp_v1: no kernel for device cpu"):
        MK.fused_mlp_v1(x, ln_s, ln_b, w1, b1, w2, b2, chunk=chunk)
    with pytest.raises(ValueError, match="ablate_ring_v1: no kernel for device cpu"):
        QP.ablate_ring_v1(x, w1p, s1, w2p, None, chunk=chunk)
    with pytest.raises(ValueError, match="n_buf"):
        QP.ablate_ring(x, w1p, s1, w2p, None, chunk=chunk, n_buf=9)
