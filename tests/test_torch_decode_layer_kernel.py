"""The port's dense decode-layer functions (rqvae_tpu_torch.ops.
decode_layer_kernel) against JAX's fused_ln_qkv / fused_proj_mlp, whose
Pallas kernels run in interpret mode.

On the CPU the wrappers take their plain versions (the CUDA kernels are
compared with those on the card, by chip_smoke.py). fp32, C=128, atol 2e-5:
the JAX kernels' polynomial erf differs from the exact erf by < 1e-6 and
the products are summed in another order. Weights go to the port in the
nn.Linear [out, in] layout, to JAX in its [in, out] layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops import decode_layer_kernel as JDK
from rqvae_tpu_torch.ops import decode_layer_kernel as DK

C = 128
H = 4 * C


def _rand(r, *shape, std=1.0, mean=0.0):
    return (r.standard_normal(shape) * std + mean).astype(np.float32)


@pytest.mark.parametrize("B", [3, 8])
def test_fused_ln_qkv_matches_jax(B):
    r = np.random.RandomState(B)
    x = _rand(r, B, C)
    s, b = _rand(r, C, std=0.1, mean=1.0), _rand(r, C, std=0.1)
    w, bias = _rand(r, C, 3 * C, std=0.05), _rand(r, 3 * C, std=0.05)
    want = JDK.fused_ln_qkv(*map(jnp.asarray, (x, s, b, w, bias)), chunk=128, interpret=True)
    launches = DK.fused_ln_qkv.launches
    got = DK.fused_ln_qkv(*map(torch.from_numpy, (x, s, b, np.ascontiguousarray(w.T), bias)))
    assert DK.fused_ln_qkv.launches == launches  # CPU tensors: no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("B,gelu", [(3, "v1"), (8, "v1"), (3, "v2")])
def test_fused_proj_mlp_matches_jax(B, gelu):
    r = np.random.RandomState(10 + B)
    x, y = _rand(r, B, C), _rand(r, B, C)
    s, b = _rand(r, C, std=0.1, mean=1.0), _rand(r, C, std=0.1)
    wo, bo = _rand(r, C, C, std=0.05), _rand(r, C, std=0.05)
    w1, b1 = _rand(r, C, H, std=0.05), _rand(r, H, std=0.05)
    w2, b2 = _rand(r, H, C, std=0.05), _rand(r, C, std=0.05)
    # chunk 128: the JAX kernel accumulates the MLP over four hidden chunks
    want = JDK.fused_proj_mlp(
        *map(jnp.asarray, (x, y, wo, bo, s, b, w1, b1, w2, b2)),
        gelu_version=gelu, chunk=128, interpret=True,
    )
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    launches = DK.fused_proj_mlp.launches
    got = DK.fused_proj_mlp(
        t(x), t(y), t(wo.T), t(bo), t(s), t(b), t(w1.T), t(b1), t(w2.T), t(b2), gelu_version=gelu
    )
    assert DK.fused_proj_mlp.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("M,N,K", [(100, 4608, 1536), (100, 6144, 1536), (100, 1536, 1536), (100, 1536, 6144), (8, 4608, 1536), (3, 384, 128)])
def test_split_k_divides_the_reduction(M, N, K):
    """The CUDA GEMM needs K divisible by split * 64 and at least one chunk per split."""
    s = DK._splits(M, N, K)
    assert s >= 1 and K % (s * 64) == 0


def _check_plan_covers(M, C, mlp, wbytes):
    """decode_dense.cu's launch plan: the row tiles cover the M rows (none
    empty), every (row tile, weight row tile, 64-element K-chunk) of every
    product falls to exactly one CTA, and the launch fits the card: clusters
    of at most 8, one wave of 132 SMs, at most 232,448 bytes of shared
    memory, a ring of 4 to 16 stages, a row tile the kernel is built for."""
    N = (4 if mlp else 3) * C
    plan = DK.dense_plan(M, C, N, mlp, wbytes=wbytes)
    assert plan.wbytes == wbytes
    assert plan.cluster <= 8 and plan.cluster * plan.clusters <= 132
    assert plan.smem <= 232_448 and 4 <= plan.stages <= 16
    assert plan.smem == DK._smem_bytes(plan.row_tile, C // plan.cluster, plan.stages, mlp, wbytes)
    assert plan.row_tile in (DK.ROW_TILES_MLP if mlp else DK.ROW_TILES_QKV)
    assert (plan.row_tiles - 1) * plan.row_tile < M <= plan.row_tiles * plan.row_tile
    products = plan.products()
    counts = [np.zeros((plan.row_tiles, tiles, k // 64), np.int32) for tiles, k in products]
    for cta in range(plan.cluster * plan.clusters):
        for i, m0, j, k0 in plan.units(cta):
            assert m0 % plan.row_tile == 0 and k0 % 64 == 0
            counts[i][m0 // plan.row_tile, j, k0 // 64] += 1
    want = [(C, C), (N, C), (C, N)] if mlp else [(N, C)]  # (weight rows, K): wo, w1, w2 / wqkv
    assert [(tiles * 64, k) for tiles, k in products] == want
    for (tiles, k), c in zip(products, counts):
        assert (c == 1).all(), f"product [{tiles * 64}, {k}]: counts {np.unique(c)}"


@pytest.mark.parametrize("mlp", [False, True], ids=["ln_qkv", "proj_mlp"])
@pytest.mark.parametrize("C", DK.WIDTHS)
@pytest.mark.parametrize("M", [1, 37, 100, 129, 300, 500])
def test_dense_plan_covers_each_output_and_reduction_once(M, C, mlp):
    """_check_plan_covers at every head width the port builds, bf16 weights."""
    _check_plan_covers(M, C, mlp, 2)


@pytest.mark.parametrize("mlp", [False, True], ids=["ln_qkv_q8", "proj_mlp_q8"])
@pytest.mark.parametrize("C", DK.WIDTHS)
@pytest.mark.parametrize("M", [1, 37, 100, 129, 300, 500])
def test_dense_plan_q8_covers_each_output_and_reduction_once(M, C, mlp):
    """The same with int8 weights (fused_ln_qkv_q8, fused_proj_mlp_q8): a
    ring stage's weight tile is 4 KB, so more stages fit, the K-chunks are
    the same 64 elements."""
    _check_plan_covers(M, C, mlp, 1)


def test_dense_plan_q8_stage_is_half_the_weight_bytes():
    """An int8 ring stage holds 64 x 64 bytes of weight, a bf16 one 8 KB;
    the t tile of proj_mlp (bf16 activations) and the stage's two mbarriers
    are the same in both."""
    for mlp in (False, True):
        s1 = DK._smem_bytes(104, 384, 1, mlp, 1) - DK._smem_bytes(104, 384, 0, mlp, 1)
        s2 = DK._smem_bytes(104, 384, 1, mlp, 2) - DK._smem_bytes(104, 384, 0, mlp, 2)
        t = 104 * 128 if mlp else 0
        assert (s1, s2) == (4096 + t + 16, 8192 + t + 16)


@pytest.mark.parametrize("most", [1, 7, 32])
def test_dense_plan_keeps_to_the_co_resident_clusters(most):
    """With fewer co-resident clusters than SMs allow (the device's count,
    cudaOccupancyMaxActiveClusters), the plan launches no more, and still
    covers every output and reduction element once."""
    plan = DK.dense_plan(100, 1536, 6144, True, max_clusters=lambda mlp, mt, s, smem: most)
    assert plan.clusters <= most
    seen = set()
    for cta in range(plan.cluster * plan.clusters):
        for unit in plan.units(cta):
            assert unit not in seen
            seen.add(unit)
    assert len(seen) == sum(plan.row_tiles * tiles * k // 64 for tiles, k in plan.products())


@pytest.mark.parametrize("most", [1, 7, 32])
def test_dense_plan_q8_keeps_to_the_co_resident_clusters(most):
    """As above with int8 weights, for both products."""
    for mlp, N in ((True, 6144), (False, 4608)):
        plan = DK.dense_plan(100, 1536, N, mlp, max_clusters=lambda mlp, mt, s, smem: most, wbytes=1)
        assert plan.clusters <= most
        seen = set()
        for cta in range(plan.cluster * plan.clusters):
            for unit in plan.units(cta):
                assert unit not in seen
                seen.add(unit)
        assert len(seen) == sum(plan.row_tiles * tiles * k // 64 for tiles, k in plan.products())


REFUSED = [(100, 768, 2304, False), (100, 1536, 4096, False), (100, 1536, 4608, True), (0, 1536, 4608, False)]


@pytest.mark.parametrize("M,C,N,mlp", REFUSED)
def test_dense_plan_refuses_other_shapes(M, C, N, mlp):
    with pytest.raises(ValueError, match="decode_dense"):
        DK.dense_plan(M, C, N, mlp)


@pytest.mark.parametrize("M,C,N,mlp", REFUSED + [(100, 2560, 10240, False), (37, 1280, 3840, True)])
def test_dense_plan_q8_refuses_other_shapes_before_the_library(M, C, N, mlp, monkeypatch):
    """The q8 wrappers' plan (_device_plan, which they call before anything
    else reaches the device or the kernel library) raises ValueError for C
    outside WIDTHS, N != 3C (ln_qkv) or H != 4C (proj_mlp) and M < 1, with
    neither the library nor the device asked; dense_plan with int8 weights
    refuses the same shapes."""
    def asked(*args, **kwargs):
        raise AssertionError("the kernel library or the device was asked")

    monkeypatch.setattr(DK._build, "library", asked)
    monkeypatch.setattr(torch.cuda, "get_device_properties", asked)
    with pytest.raises(ValueError, match="decode_dense"):
        DK._device_plan(M, C, N, mlp, 1, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="decode_dense"):
        DK.dense_plan(M, C, N, mlp, wbytes=1)


def test_tensor_map_key_tells_int8_from_bf16():
    """The TMA tensor-map cache key: an int8 tensor at the address and of
    the shape of a bf16 one (the allocator may reuse a freed weight's
    memory) gets another key, and so its own map."""
    raw = torch.zeros(4, 128, dtype=torch.int8)
    as_bf16 = raw.view(torch.bfloat16)  # [4, 64] bf16 at raw's address
    as_int8 = raw[:, :64]  # [4, 64] int8 at the same address
    assert as_bf16.data_ptr() == as_int8.data_ptr() and as_bf16.shape == as_int8.shape
    assert DK._map_key(as_bf16, 64) != DK._map_key(as_int8, 64)
    assert DK._map_key(as_int8, 64) == DK._map_key(raw[:, :64], 64)
    assert DK._map_key(as_int8, 64) != DK._map_key(as_int8, 104)  # an activation's box


FUSED_KINDS = [(True, 2), (False, 1), (False, 2)]  # (layer, wbytes): #14; #13 with int8 wo, with bf16 wo
FUSED_IDS = ["layer_step", "attn_wo_q8", "attn_wo_bf16"]


def _check_fused_plan_covers(plan, M, C, layer, wbytes, window):
    """csrc/decode_fused.cu's launch plan: the row tiles cover the M rows,
    every (row tile, weight row tile, K-chunk) of every product falls to
    exactly one CTA, every (row, head) of the attention to exactly one warp,
    and the launch fits the card: clusters of at most 8, one wave of 132
    SMs, the shared memory of the layout with the attention's scores (in
    the panel's bytes) within 232,448 bytes, a ring of 4 to 16 stages, a
    row tile the kernels are built for."""
    assert (plan.layer, plan.M, plan.C, plan.wbytes, plan.window) == (layer, M, C, wbytes, window)
    assert plan.cluster <= 8 and plan.cluster * plan.clusters <= 132
    assert plan.row_tile in DK.ROW_TILES_FUSED
    assert (plan.row_tiles - 1) * plan.row_tile < M <= plan.row_tiles * plan.row_tile
    scores = DK._score_bytes(window)
    warps = DK._attn_warps(window)  # each keeps fp32 scores and V scales of window + 1 rows for 4 heads
    assert scores == warps * 4 * 2 * (window + 1) * 4 and 1 <= warps <= 8
    assert warps == 8 or (warps == 1 and scores > 65536) or scores <= 65536 < scores // warps * (warps + 1)
    assert plan.smem == DK._smem_bytes(plan.row_tile, C // plan.cluster, plan.stages, layer, wbytes, scores)
    assert plan.smem <= DK.SMEM_LIMIT and 4 <= plan.stages <= 16
    products = plan.products()
    want = [(3 * C, C), (C, C), (4 * C, C), (C, 4 * C)] if layer else [(C, C)]  # (weight rows, K)
    assert [(tiles * 64, k) for tiles, k in products] == want
    counts = [np.zeros((plan.row_tiles, tiles, k // 64), np.int32) for tiles, k in products]
    heads = np.zeros((M, C // 64), np.int32)
    for cta in range(plan.cluster * plan.clusters):
        for i, m0, j, k0 in plan.units(cta):
            counts[i][m0 // plan.row_tile, j, k0 // 64] += 1
        for b, h in plan.attention_units(cta):
            heads[b, h] += 1
    for (tiles, k), c in zip(products, counts):
        assert (c == 1).all(), f"product [{tiles * 64}, {k}]: counts {np.unique(c)}"
    assert (heads == 1).all(), f"attention units: counts {np.unique(heads)}"


@pytest.mark.parametrize("layer,wbytes", FUSED_KINDS, ids=FUSED_IDS)
@pytest.mark.parametrize("C", DK.WIDTHS)
@pytest.mark.parametrize("M", [1, 37, 100, 129])
def test_fused_plan_covers_each_output_and_reduction_once(M, C, layer, wbytes):
    """_check_fused_plan_covers at every head width the port builds, at the
    sampler's 64-row window."""
    plan = DK.fused_plan(M, C, layer, 64, wbytes)
    _check_fused_plan_covers(plan, M, C, layer, wbytes, 64)


@pytest.mark.parametrize("layer,wbytes", FUSED_KINDS, ids=FUSED_IDS)
@pytest.mark.parametrize("window", [0, 24, 255, 256, 1024, 4223])
def test_fused_plan_fits_the_scores_of_every_window(window, layer, wbytes):
    """Up to the wrappers' longest window (MAX_WINDOW, 4223 rows) the scores
    of a CTA's warps fit beside the ring, at the widest width too."""
    for C in (1536, 2560):
        _check_fused_plan_covers(DK.fused_plan(100, C, layer, window, wbytes), 100, C, layer, wbytes, window)


@pytest.mark.parametrize("most", [1, 7, 32])
def test_fused_plan_keeps_to_the_co_resident_clusters(most):
    """With fewer co-resident clusters than SMs allow (the device's count
    for the fused kernel itself), the plan launches no more, and still
    covers every output, reduction and attention unit once."""
    for layer, wbytes in FUSED_KINDS:
        asked = []

        def count(*args, asked=asked):
            asked.append(args)
            return most

        plan = DK.fused_plan(100, 1536, layer, 64, wbytes, max_clusters=count)
        assert plan.clusters <= most
        assert all(a[0] is layer for a in asked)  # the layer step's kernel or the attention with wo's
        _check_fused_plan_covers(plan, 100, 1536, layer, wbytes, 64)


FUSED_REFUSED = [(100, 768, 64), (100, 3072, 64), (0, 1536, 64), (100, 1536, 4224), (100, 1536, -1)]


@pytest.mark.parametrize("M,C,window", FUSED_REFUSED)
def test_fused_plan_refuses_other_shapes_before_the_library(M, C, window, monkeypatch):
    """The fused wrappers' plan (_fused_device_plan, called before anything
    else reaches the device or the kernel library) raises ValueError for C
    outside WIDTHS, M < 1 and a window outside 0 .. MAX_WINDOW, with
    neither the library nor the device asked."""
    def asked(*args, **kwargs):
        raise AssertionError("the kernel library or the device was asked")

    monkeypatch.setattr(DK._build, "library", asked)
    monkeypatch.setattr(torch.cuda, "get_device_properties", asked)
    for layer, wbytes in FUSED_KINDS:
        with pytest.raises(ValueError, match="decode_fused"):
            DK._fused_device_plan(M, C, layer, window, wbytes, torch.device("cuda", 0))
        with pytest.raises(ValueError, match="decode_fused"):
            DK.fused_plan(M, C, layer, window, wbytes)


def test_fused_layout_keeps_the_dense_layout_when_the_scores_fit():
    """The scores share the panel's bytes: a layout whose scores fit in the
    panel is the dense kernels' own; larger scores grow the panel region to
    their size, and nothing else."""
    for mlp in (False, True):
        panel = (384 // 64) * 104 * 128
        assert DK._smem_bytes(104, 384, 5, mlp, 2, panel) == DK._smem_bytes(104, 384, 5, mlp, 2)
        assert DK._smem_bytes(104, 384, 5, mlp, 2, panel + 4096) == DK._smem_bytes(104, 384, 5, mlp, 2) + 4096
