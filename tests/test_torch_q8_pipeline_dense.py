"""#17 fused_proj_mlp_q8_ring and #18 fused_proj_mlp_q8_packed on the card:
one launch of #6's kernel (csrc/decode_dense.cu::rq_fused_proj_mlp with
int8 weights), #18 with its w2 read through a tensor map of the packed [nc
C, chunk]. The kernel runs only on the card; here: the packed-w2 tile
coordinates of decode_dense.cuh's producer against the plain [C, H] layout
at every chunk of the experiment's sweeps, the packed w1's bytes as [H,
C], the contract (any rows; chunk a multiple of 64 dividing H) and the
refusals of what it leaves out before the library is asked, and the
wrappers' CPU paths: the plain versions, bit-equal at every (chunk, n_buf)
to each other and to decode_layer_kernel.fused_proj_mlp_q8, no launch
counted; the first designs raise on the CPU. The plain versions themselves
are held against JAX by test_torch_q8_pipeline.py.
"""

import numpy as np
import pytest
import torch

from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from rqvae_tpu_torch.ops import dense_mlp_kernel as DM
from rqvae_tpu_torch.ops import q8_pipeline_kernel as QP

C, H = 1536, 6144
CHUNKS = (64, 512, 768, 1536, 3072)  # 64 and the experiment's sweeps (tools/exp_q8_pipeline.py RING/PACKED_CHUNKS)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_packed_w2_coordinates_select_the_tile(chunk):
    """decode_dense.cuh's producer reads #18's w2 tile (channels c .. c + 63,
    K k .. k + 63) at (k mod chunk, (k div chunk) C + c) of the packed w2
    seen as [nc C, chunk] (dense_mlp_kernel.w2_coords: the same address as
    #20's): for every tile, the values of w2 [C, H] at [c:c + 64, k:k + 64]."""
    w2 = torch.from_numpy(np.random.RandomState(chunk).randint(-127, 128, (C, H), dtype=np.int8))
    flat = QP.pack_w2(w2, chunk).reshape(-1, chunk).numpy()  # the matrix the wrapper maps
    full = w2.numpy()
    for c in range(0, C, 64):
        for k in range(0, H, 64):
            col, row = DM.w2_coords(chunk, C, k, c)
            assert col + 64 <= chunk and row + 64 <= flat.shape[0]
            np.testing.assert_array_equal(flat[row:row + 64, col:col + 64], full[c:c + 64, k:k + 64])


@pytest.mark.parametrize("chunk", CHUNKS)
def test_packed_w1_is_w1s_bytes(chunk):
    """#18's w1 map is that of w1p as [H, C]: the same rows as w1 [H, C]."""
    w1 = torch.from_numpy(np.random.RandomState(chunk + 1).randint(-127, 128, (H, C), dtype=np.int8))
    assert torch.equal(QP.pack_w1(w1, chunk).reshape(H, C), w1)


@pytest.mark.parametrize("M", [1, 37, 100, 129, 300, 500])
def test_contract_takes_any_rows(M):
    """The first design took at most 128 rows; #6's kernel takes any M >= 1
    at every chunk of the sweeps, on #6's plan (n_buf sets nothing)."""
    for chunk in CHUNKS:
        QP.dense_point("fused_proj_mlp_q8_ring", M, C, H, chunk)
    plan = DK.dense_plan(M, C, H, True, wbytes=1)
    assert plan.row_tiles * plan.row_tile >= M and plan.smem <= DK.SMEM_LIMIT


def _layer(C_, H_, M=3, seed=0):
    """A layer of the port's types (bf16 activations, int8 weights)."""
    r = np.random.RandomState(seed)

    def bf(*shape, s=1.0):
        return (torch.from_numpy(r.standard_normal(shape).astype(np.float32)) * s).to(torch.bfloat16)

    def i8(*shape):
        return torch.from_numpy(r.randint(-127, 128, shape).astype(np.int8))

    return dict(x=bf(M, C_), y=bf(M, C_), wo_q=i8(C_, C_), wo_s=bf(C_, s=0.01), bo=bf(C_, s=0.05),
                ln_scale=bf(C_, s=0.1) + 1, ln_bias=bf(C_, s=0.1), w1_q=i8(H_, C_), w1_s=bf(H_, s=0.01),
                b1=bf(H_, s=0.05), w2_q=i8(C_, H_), w2_s=bf(C_, s=0.01), b2=bf(C_, s=0.05))


def _ring(p, **kw):
    return QP.fused_proj_mlp_q8_ring(p["x"], p["y"], p["wo_q"], p["wo_s"], p["bo"], p["ln_scale"], p["ln_bias"],
                                     p["w1_q"], p["w1_s"], p["b1"], p["w2_q"], p["w2_s"], p["b2"], **kw)


def _packed(p, chunk, fn=None, **kw):
    fn = fn or QP.fused_proj_mlp_q8_packed
    return fn(p["x"], p["y"], p["wo_q"], p["wo_s"], p["bo"], p["ln_scale"], p["ln_bias"], QP.pack_w1(p["w1_q"], chunk),
              p["w1_s"], p["b1"], QP.pack_w2(p["w2_q"], chunk), p["w2_s"], p["b2"], chunk=chunk, **kw)


REFUSED = [  # (C, H, M, chunk, what the message names)
    (128, 512, 3, 128, "C in"),               # C outside WIDTHS
    (512, 1024, 3, 512, "H = 4C"),            # H != 4C
    (512, 2048, 0, 512, "M >= 1"),            # no rows
    (512, 2048, 3, 32, "multiple of 64"),     # chunk % 64 (it divides H)
]


@pytest.mark.parametrize("packed", [False, True], ids=["ring", "packed"])
@pytest.mark.parametrize("C_,H_,M,chunk,match", REFUSED)
def test_wrappers_refuse_before_the_library(C_, H_, M, chunk, match, packed, monkeypatch):
    """On a CUDA device (the device kind stood in for) #17 and #18 refuse
    these shapes after their type and shape checks, before the library or
    the device is asked, and count no launch."""
    def asked(*args, **kwargs):
        raise AssertionError("the kernel library or the device was asked")

    monkeypatch.setattr(QP, "_device_kind", lambda name, t: "cuda")
    monkeypatch.setattr(QP._build, "library", asked)
    monkeypatch.setattr(torch.cuda, "get_device_properties", asked)
    p = _layer(C_, H_, M)
    n = (QP.fused_proj_mlp_q8_ring.launches, QP.fused_proj_mlp_q8_packed.launches)
    with pytest.raises(ValueError, match=match):
        _packed(p, chunk, n_buf=2) if packed else _ring(p, chunk=chunk, n_buf=2)
    assert (QP.fused_proj_mlp_q8_ring.launches, QP.fused_proj_mlp_q8_packed.launches) == n


def test_wrappers_take_the_plain_versions_on_the_cpu(monkeypatch):
    """On CPU tensors #17 and #18 return the plain version at every (chunk,
    n_buf) of the sweeps, bit-equal to each other and to #6's wrapper, count
    no launch and never ask the library; the first designs raise."""
    def asked(*args, **kwargs):
        raise AssertionError("the kernel library was asked")

    monkeypatch.setattr(QP._build, "library", asked)
    p = _layer(128, 512, M=5, seed=3)
    n = (QP.fused_proj_mlp_q8_ring.launches, QP.fused_proj_mlp_q8_packed.launches, DK.fused_proj_mlp_q8.launches)
    for gelu in ("v1", "v2"):
        ref = DK.fused_proj_mlp_q8(*p.values(), gelu_version=gelu)
        assert torch.equal(ref, QP.fused_proj_mlp_q8_ring_plain(*p.values(), gelu_version=gelu))
        for chunk, n_buf in ((512, 4), (256, 6), (128, 2)):
            assert torch.equal(_ring(p, chunk=chunk, n_buf=n_buf, gelu_version=gelu), ref)
        for chunk, n_buf in ((512, 2), (256, 3), (128, 2)):
            assert torch.equal(_packed(p, chunk, n_buf=n_buf, gelu_version=gelu), ref)
    assert (QP.fused_proj_mlp_q8_ring.launches, QP.fused_proj_mlp_q8_packed.launches,
            DK.fused_proj_mlp_q8.launches) == n
    with pytest.raises(ValueError, match="fused_proj_mlp_q8_ring_v1: no kernel for device cpu"):
        QP.fused_proj_mlp_q8_ring_v1(*p.values(), chunk=128)
    with pytest.raises(ValueError, match="fused_proj_mlp_q8_packed_v1: no kernel for device cpu"):
        _packed(p, 128, fn=QP.fused_proj_mlp_q8_packed_v1)
    assert (QP.fused_proj_mlp_q8_ring_v1.launches, QP.fused_proj_mlp_q8_packed_v1.launches) == (0, 0)
    with pytest.raises(ValueError, match="n_buf"):
        _ring(p, chunk=128, n_buf=9)
