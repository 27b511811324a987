"""The port of tools/exp_q8_pipeline.py against the JAX experiment: the ring
and packed int8 proj + LN2 + MLP (fused_proj_mlp_q8_ring,
fused_proj_mlp_q8_packed), the chunk-stream probe (stream_probe), the
MLP-only ablation (ablate_ring), the weight bridge
(q8_pipeline_weights_from_jax), the wrappers' refusals, and the ported
experiment's main on the CPU.

B 3 (ragged), C 128, H 512, chunk 128 (four chunks), n_buf 2 and 3, fp32
activations from numpy seeds. The JAX side runs its Pallas kernels in
interpret mode: fused_proj_mlp_q8_ring / _packed with interpret=True,
stream_probe / ablate_ring (which take no such argument) inside
pltpu.force_tpu_interpret_mode(). On the CPU the port's wrappers take their
plain versions.

The JAX module parses sys.argv[1] as B when it is imported, so it is
imported with sys.argv patched. Its ring kernel reads the module global H
(nc = H // chunk) rather than the weights' width, so the fixture sets
EXP.H = 512 (a module attribute; the file is not edited). The port takes H
from the weights.

Tolerances, and why:
- #17 / #18: 2e-5, as tests/test_torch_q8.py holds #6 (the same function:
  products summed in another order, int8 values up to 127, exact vs
  polynomial erf < 1e-6). The port's #17 and #18 are equal exactly.
- #19 int8: exact (integer sums, exact in fp32). The int32 view: JAX casts
  each int32 to fp32 and sums in fp32, the port sums the integers exactly
  and casts once: 1e-6 relative to the largest |value|.
- #20: 2e-5 at the output's scale, |d| <= 2e-5 max(1, max |ref|): w2's
  scale is never applied (as in JAX), so the int8 outputs reach 1e3 (1e6
  without gelu and scale), and fp32 roundoff in sums of that size is
  relative to it (observed ~3e-7 of max |ref|).
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rqvae_tpu.models.rqtransformer import model as JM
from rqvae_tpu_torch.checkpoint import from_jax
from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from rqvae_tpu_torch.ops import q8_pipeline_kernel as QP
from rqvae_tpu_torch.tools import _timing
from rqvae_tpu_torch.tools import exp_q8_pipeline as PEXP

B, C, H, CHUNK = 3, 128, 512, 128
TOL = 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def EXP():
    """tools/exp_q8_pipeline.py, imported with sys.argv patched, H set to the test's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["exp_q8_pipeline.py"])
        spec = importlib.util.spec_from_file_location("jax_exp_q8_pipeline",
                                                      os.path.join(ROOT, "tools", "exp_q8_pipeline.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    mod.H = H
    return mod


def _rand(r, *shape, std=1.0, mean=0.0):
    return (r.standard_normal(shape) * std + mean).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    return _t(np.asarray(a, np.float32)).to(torch.bfloat16)


def _layer(seed):
    """One layer's JAX inputs (fp32 activations, QuantizedWeights) and the
    port's (through q8_pipeline_weights_from_jax)."""
    r = np.random.RandomState(seed)
    x, y = _rand(r, B, C), _rand(r, B, C)
    lns, lnb = _rand(r, C, std=0.1, mean=1.0), _rand(r, C, std=0.1)
    bo, b1, b2 = _rand(r, C, std=0.05), _rand(r, H, std=0.05), _rand(r, C, std=0.05)
    wo, w1, w2 = (JM._quantize_weight(jnp.asarray(_rand(r, *s, std=0.05))) for s in ((C, C), (C, H), (H, C)))
    w = from_jax.q8_pipeline_weights_from_jax(wo=wo, w1=w1, w2=w2)
    jax_args = (jnp.asarray(x), jnp.asarray(y), wo.q, wo.scale, jnp.asarray(bo), jnp.asarray(lns), jnp.asarray(lnb),
                w1.q, w1.scale, jnp.asarray(b1), w2.q, w2.scale, jnp.asarray(b2))
    port = dict(x=_t(x), y=_t(y), wo_q=_t(w["wo_q"]), wo_s=_bf16(w["wo_s"]), bo=_t(bo), lns=_t(lns), lnb=_t(lnb),
                w1_q=_t(w["w1_q"]), w1_s=_bf16(w["w1_s"]), b1=_t(b1), w2_q=_t(w["w2_q"]), w2_s=_bf16(w["w2_s"]),
                b2=_t(b2))
    return jax_args, (wo, w1, w2), port


def _ring(p, w1, w2, **kw):
    return QP.fused_proj_mlp_q8_ring(p["x"], p["y"], p["wo_q"], p["wo_s"], p["bo"], p["lns"], p["lnb"], w1, p["w1_s"],
                                     p["b1"], w2, p["w2_s"], p["b2"], **kw)


def _packed(p, w1p, w2p, **kw):
    return QP.fused_proj_mlp_q8_packed(p["x"], p["y"], p["wo_q"], p["wo_s"], p["bo"], p["lns"], p["lnb"], w1p,
                                       p["w1_s"], p["b1"], w2p, p["w2_s"], p["b2"], **kw)


@pytest.mark.parametrize("n_buf", [2, 3])
@pytest.mark.parametrize("gelu", ["v1", "v2"])
def test_ring_and_packed_match_jax(EXP, n_buf, gelu):
    jargs, (_, w1, w2), p = _layer(10 + n_buf)
    ring_j = EXP.fused_proj_mlp_q8_ring(*jargs, gelu_version=gelu, chunk=CHUNK, n_buf=n_buf, interpret=True)
    pj = list(jargs)
    pj[7], pj[10] = EXP.pack_w1(w1.q, CHUNK), EXP.pack_w2(w2.q, CHUNK)
    packed_j = EXP.fused_proj_mlp_q8_packed(*pj, gelu_version=gelu, chunk=CHUNK, n_buf=n_buf, interpret=True)
    bridged = from_jax.q8_pipeline_weights_from_jax(w1_packed=pj[7], w2_packed=pj[10])
    counts = (QP.fused_proj_mlp_q8_ring.launches, QP.fused_proj_mlp_q8_packed.launches)
    ring_t = _ring(p, p["w1_q"], p["w2_q"], gelu_version=gelu, chunk=CHUNK, n_buf=n_buf)
    packed_t = _packed(p, _t(bridged["w1_packed"]), _t(bridged["w2_packed"]), gelu_version=gelu, chunk=CHUNK,
                       n_buf=n_buf)
    assert (QP.fused_proj_mlp_q8_ring.launches, QP.fused_proj_mlp_q8_packed.launches) == counts
    np.testing.assert_allclose(ring_t.numpy(), np.asarray(ring_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(packed_t.numpy(), np.asarray(packed_j), atol=TOL, rtol=0)
    assert torch.equal(ring_t, packed_t)
    shipped = DK.fused_proj_mlp_q8(p["x"], p["y"], p["wo_q"], p["wo_s"], p["bo"], p["lns"], p["lnb"], p["w1_q"],
                                   p["w1_s"], p["b1"], p["w2_q"], p["w2_s"], p["b2"], gelu_version=gelu)
    assert torch.equal(ring_t, shipped)  # the ring form's plain version is #6's


def test_result_does_not_depend_on_chunk_or_depth():
    _, _, p = _layer(20)
    want = _ring(p, p["w1_q"], p["w2_q"], chunk=CHUNK, n_buf=2)
    for chunk, n_buf in ((256, 2), (512, 1), (128, 4)):
        assert torch.equal(_ring(p, p["w1_q"], p["w2_q"], chunk=chunk, n_buf=n_buf), want)
        w1p, w2p = QP.pack_w1(p["w1_q"], chunk), QP.pack_w2(p["w2_q"], chunk)
        assert torch.equal(_packed(p, w1p, w2p, chunk=chunk, n_buf=n_buf), want)


@pytest.mark.parametrize("n_buf", [2, 3])
@pytest.mark.parametrize("mode", ["dma", "dequant"])
def test_stream_probe_matches_jax_exactly(EXP, mode, n_buf):
    _, (_, w1, w2), _ = _layer(30 + n_buf)
    w1p, w2p = EXP.pack_w1(w1.q, CHUNK), EXP.pack_w2(w2.q, CHUNK)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(EXP.stream_probe(w1p, w2p, chunk=CHUNK, n_buf=n_buf, mode=mode))
    bridged = from_jax.q8_pipeline_weights_from_jax(w1_packed=w1p, w2_packed=w2p)
    launches = QP.stream_probe.launches
    got = QP.stream_probe(_t(bridged["w1_packed"]), _t(bridged["w2_packed"]), chunk=CHUNK, n_buf=n_buf, mode=mode)
    assert QP.stream_probe.launches == launches
    assert got.shape == (1, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_stream_probe_int32_view_matches_jax(EXP):
    _, (_, w1, w2), _ = _layer(40)
    w1p32 = np.asarray(EXP.pack_w1(w1.q, CHUNK)).view(np.int32)
    w2p32 = np.asarray(EXP.pack_w2(w2.q, CHUNK)).view(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(EXP.stream_probe(jnp.asarray(w1p32), jnp.asarray(w2p32), chunk=CHUNK, n_buf=2, mode="dma"))
    bridged = from_jax.q8_pipeline_weights_from_jax(w1_packed=w1p32, w2_packed=w2p32)
    t1, t2 = _t(bridged["w1_packed"]), _t(bridged["w2_packed"])
    assert t1.dtype == torch.int32 and tuple(t1.shape) == (H // CHUNK, CHUNK, C // 4)
    got = QP.stream_probe(t1, t2, chunk=CHUNK, n_buf=2, mode="dma").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)
    with pytest.raises(ValueError, match="'dma' mode only"):
        QP.stream_probe(t1, t2, chunk=CHUNK, n_buf=2, mode="dequant")


@pytest.mark.parametrize("n_buf", [2, 3])
@pytest.mark.parametrize("int8,use_gelu,use_scale", [
    (True, True, True), (True, False, True), (True, False, False), (False, True, True)],
    ids=["q8_full", "q8_no_gelu", "q8_no_gelu_noscale", "bf16_same_ring"])
def test_ablate_ring_matches_jax(EXP, int8, use_gelu, use_scale, n_buf):
    r = np.random.RandomState(50 + n_buf)
    h = _rand(r, B, C)
    _, (_, w1, w2), _ = _layer(60 + n_buf)
    if int8:
        a, b = w1.q, w2.q
    else:  # the experiment's bf16 weights: q.astype(bf16) * scale.astype(bf16)
        a = w1.q.astype(jnp.bfloat16) * w1.scale.astype(jnp.bfloat16)
        b = w2.q.astype(jnp.bfloat16) * w2.scale.astype(jnp.bfloat16)
    a, b = EXP.pack_w1(a, CHUNK), EXP.pack_w2(b, CHUNK)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(EXP.ablate_ring(jnp.asarray(h), a, w1.scale, b, w1.scale, chunk=CHUNK, n_buf=n_buf,
                                          use_gelu=use_gelu, use_scale=use_scale))
    bridged = from_jax.q8_pipeline_weights_from_jax(
        w1_packed=np.asarray(a, np.int8 if int8 else np.float32), w2_packed=np.asarray(b, np.int8 if int8 else np.float32))
    t1, t2 = _t(bridged["w1_packed"]), _t(bridged["w2_packed"])
    if not int8:
        t1, t2 = t1.to(torch.bfloat16), t2.to(torch.bfloat16)
    s1 = _bf16(np.asarray(w1.scale, np.float32)[0])
    launches = QP.ablate_ring.launches
    got = QP.ablate_ring(_t(h), t1, s1, t2, None, chunk=CHUNK, n_buf=n_buf, use_gelu=use_gelu, use_scale=use_scale)
    assert QP.ablate_ring.launches == launches
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * max(1.0, float(np.abs(want).max())), rtol=0)


def test_bridge_round_trips(EXP):
    _, (wo, w1, w2), p = _layer(70)
    bridged = from_jax.q8_pipeline_weights_from_jax(
        wo=wo, w1=w1, w2=w2, w1_packed=EXP.pack_w1(w1.q, CHUNK), w2_packed=EXP.pack_w2(w2.q, CHUNK))
    np.testing.assert_array_equal(bridged["w1_q"], np.asarray(w1.q).T)
    np.testing.assert_array_equal(bridged["w2_q"], np.asarray(w2.q).T)
    np.testing.assert_array_equal(bridged["wo_s"], np.asarray(wo.scale, np.float32)[0])
    # the JAX packing, bridged, is the port's packing of the bridged weight
    w1p, w2p = QP.pack_w1(p["w1_q"], CHUNK), QP.pack_w2(p["w2_q"], CHUNK)
    np.testing.assert_array_equal(bridged["w1_packed"], w1p.numpy())
    np.testing.assert_array_equal(bridged["w2_packed"], w2p.numpy())
    assert torch.equal(QP.unpack_w1(w1p), p["w1_q"]) and torch.equal(QP.unpack_w2(w2p), p["w2_q"])
    # the int32 view: bytes transposed, viewed back along the port's last dim
    j32 = np.asarray(EXP.pack_w2(w2.q, CHUNK)).view(np.int32)
    b32 = from_jax.q8_pipeline_weights_from_jax(w2_packed=j32)["w2_packed"]
    np.testing.assert_array_equal(b32.view(np.int8), w2p.numpy())


def test_wrappers_refuse_other_devices_and_ragged_chunks():
    _, _, p = _layer(80)
    meta = {k: v.to("meta") for k, v in p.items()}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        _ring(meta, meta["w1_q"], meta["w2_q"], chunk=CHUNK)
    with pytest.raises(ValueError, match="H % chunk"):
        _ring(p, p["w1_q"], p["w2_q"], chunk=96)
    w1p, w2p = QP.pack_w1(p["w1_q"], CHUNK), QP.pack_w2(p["w2_q"], CHUNK)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        _packed(meta, w1p.to("meta"), w2p.to("meta"), chunk=CHUNK)
    with pytest.raises(ValueError, match="expected"):
        _packed(p, w1p, w2p, chunk=256)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        QP.stream_probe(w1p.to("meta"), w2p.to("meta"), chunk=CHUNK)
    with pytest.raises(ValueError, match="unknown mode"):
        QP.stream_probe(w1p, w2p, chunk=CHUNK, mode="copy")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        QP.ablate_ring(meta["x"], w1p.to("meta"), meta["w1_s"], w2p.to("meta"), None, chunk=CHUNK)
    with pytest.raises(ValueError, match="n_buf"):
        QP.ablate_ring(p["x"], w1p, p["w1_s"], w2p, None, chunk=CHUNK, n_buf=0)


PROBE_REFUSED = [  # (C, H, chunk, what the message names): on the card, before the library is asked
    (512, 2048, 32, "multiple of 64"),   # chunk % 64 (it divides H)
    (512, 1920, 640, "H = 4C"),          # chunk 640 does not divide 4C: nc chunk = 1920
    (128, 512, 128, "C in"),             # C outside WIDTHS
]


@pytest.mark.parametrize("C_,H_,chunk,match", PROBE_REFUSED)
@pytest.mark.parametrize("i32", [False, True], ids=["int8", "int32"])
def test_stream_probe_refuses_before_the_library(C_, H_, chunk, match, i32, monkeypatch):
    """On a CUDA device (the device kind stood in for) #19 refuses a chunk
    that is not a multiple of 64, or that does not divide H = 4C, and a
    width outside #6's plan, after its type and shape checks and before the
    library or the device is asked; no launch is counted."""
    def asked(*args, **kwargs):
        raise AssertionError("the kernel library or the device was asked")

    monkeypatch.setattr(QP, "_device_kind", lambda name, t: "cuda")
    monkeypatch.setattr(QP._build, "library", asked)
    monkeypatch.setattr(torch.cuda, "get_device_properties", asked)
    r = np.random.RandomState(C_ + chunk)
    w1p = torch.from_numpy(r.randint(-127, 128, (H_ // chunk, chunk, C_)).astype(np.int8))
    w2p = torch.from_numpy(r.randint(-127, 128, (H_ // chunk, C_, chunk)).astype(np.int8))
    if i32:
        w1p, w2p = w1p.view(torch.int32), w2p.view(torch.int32)
    n = QP.stream_probe.launches
    with pytest.raises(ValueError, match=match):
        QP.stream_probe(w1p, w2p, chunk=chunk, n_buf=4)
    assert QP.stream_probe.launches == n


@pytest.mark.parametrize("C_,chunk", [(1536, 1536), (1536, 768), (1536, 3072), (512, 64), (2560, 640)])
def test_stream_probe_plan_streams_every_tile_once(C_, chunk):
    """#19's plan is #6's at B 100 (the stage count the log names: 6 at C
    1536); its CTAs stream every 64 x 64 tile of w1 [H, C] and of the packed
    w2 map [nc C, chunk] once, within the map."""
    H_ = 4 * C_
    plan = QP.probe_plan(C_, H_)
    assert plan == DK.dense_plan(100, C_, H_, True, wbytes=1) and plan.smem <= DK.SMEM_LIMIT
    if C_ == 1536:
        assert (plan.cluster, plan.clusters, plan.stages) == (4, 33, 6)
    got = [t for cta in range(plan.cluster * plan.clusters) for t in QP.probe_tiles(plan, chunk, cta)]
    w1 = [(0, k, r) for r in range(0, H_, 64) for k in range(0, C_, 64)]
    w2 = [(1, k, r) for r in range(0, H_ // chunk * C_, 64) for k in range(0, chunk, 64)]
    assert sorted(got) == sorted(w1 + w2)


def _probe_restated(w1p, w2p, chunk, mode):
    """csrc/stream_probe.cu's sums restated over probe_tiles: each CTA's
    tiles in order, a tile's first row in its chunk (r0), whether it holds
    the chunk's column 0, the rows that feed the lanes; [1, 128] fp32."""
    i32 = w1p.dtype == torch.int32
    b1, b2 = w1p.view(torch.int8).reshape(-1, w1p.shape[2] * (4 if i32 else 1)), w2p.view(torch.int8).reshape(-1, chunk)
    C_ = b1.shape[1]
    plan = QP.probe_plan(C_, b1.shape[0])
    lanes = np.zeros(128, np.int64)
    one = 0
    for cta in range(plan.cluster * plan.clusters):
        for i, col, row in QP.probe_tiles(plan, chunk, cta):
            tile = (b1 if i == 0 else b2)[row:row + 64, col:col + 64].numpy().astype(np.int64)
            r0 = row % (chunk if i == 0 else C_)
            limit = min(512 if i32 else 128, chunk if i == 0 else C_)
            if mode == "dequant":
                for r in range(64):
                    if r0 + r < limit:
                        lanes[r0 + r] += tile[r].sum()
            elif col == 0:
                for t in range(16 if i32 else 64):
                    if i32 and r0 + 4 * t < limit:
                        one += int(np.frombuffer(tile[4 * t:4 * t + 4, 0].astype(np.int8).tobytes(), np.int32)[0])
                    elif not i32 and r0 + t < limit:
                        one += int(tile[t, 0])
    out = lanes if mode == "dequant" else np.full(128, one)
    return torch.from_numpy(out.astype(np.float32))[None]


@pytest.mark.parametrize("chunk", [64, 128, 512])
@pytest.mark.parametrize("mode", ["dma", "dequant", "dma-i32"])
def test_stream_probe_kernel_sums_restated(chunk, mode):
    """The kernel's walk and lane arithmetic, restated in numpy at C 512, H
    2048 (#6's plan: cluster 8 x 16), equal the plain version: every lane
    of chunks shorter and longer than 128 rows, column 0 only in the tile
    that holds it, the int32 view's four rows a value."""
    r = np.random.RandomState(chunk)
    w1 = torch.from_numpy(r.randint(-128, 128, (2048, 512)).astype(np.int8))
    w2 = torch.from_numpy(r.randint(-128, 128, (512, 2048)).astype(np.int8))
    w1p, w2p = QP.pack_w1(w1, chunk), QP.pack_w2(w2, chunk)
    if mode == "dma-i32":
        w1p, w2p = w1p.view(torch.int32), w2p.view(torch.int32)
    want = QP.stream_probe_plain(w1p, w2p, "dequant" if mode == "dequant" else "dma")
    assert torch.equal(_probe_restated(w1p, w2p, chunk, "dequant" if mode == "dequant" else "dma"), want)


def test_stage_bytes_match_the_source_note():
    # csrc/q8_pipeline.cu: at 132 blocks, int8 chunk 1536 needs 49,664 B a
    # stage, 768 24,960, 512 20,864, 3072 86,656; bf16 1536 98,816
    got = [QP.stage_bytes(1536, c, wb, 132) for c, wb in ((1536, 1), (768, 1), (512, 1), (3072, 1), (1536, 2))]
    assert got == [49664, 24960, 20864, 86656, 98816]


JAX_LABELS = [  # the JAX experiment's lines at the narrow points below, in order
    "q8 grid-pipeline (shipped)", "ring vs shipped",
    "q8 ring chunk=  128 n_buf=2", "q8 ring chunk=  128 n_buf=3", "q8 ring chunk=  128 n_buf=4",
    "q8 ring chunk=  256 n_buf=2", "packed vs shipped",
    "q8 PACKED chunk=  128 n_buf=2",
    "probe dma       chunk=  128 n_buf=4", "probe dequant   chunk=  128 n_buf=4",
    "probe dma-as-i32 chunk=  128 n_buf=4",
    "ablate q8 full            chunk=128 n_buf=4", "ablate q8 no-gelu         chunk=128 n_buf=4",
    "ablate q8 no-gelu-noscale chunk=128 n_buf=4", "ablate bf16 same-ring     chunk=128 n_buf=2",
]


def test_experiment_main_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("EXP_ITERS", "2")
    for name, value in dict(CHECK_CHUNK=128, RING_CHUNKS=(128, 256), RING_NBUF=(2, 3, 4, 6),
                            PACKED_CHUNKS=(128, 512), PACKED_NBUF=(2,), PROBE_POINTS=((128, 4),),
                            I32_POINTS=((128, 4),), ABLATE_CHUNK=128).items():
        monkeypatch.setattr(PEXP, name, value)
    got = PEXP.main(["3"], device="cpu", C=C, H=H, L=2)
    lines = capsys.readouterr().out.splitlines()
    assert lines == got["lines"] and got["failed"] == []
    jax_lines = [ln for ln in lines if "eager loop" not in ln]
    assert [ln.split(":")[0] for ln in jax_lines] == JAX_LABELS
    assert all("GB/s (int8 bytes)" in ln for ln in jax_lines[:1] + jax_lines[2:6] + jax_lines[7:11])
    assert all("GB/s (weight bytes)" in ln for ln in jax_lines[11:])
    assert "mean|d| 0.000000 max|d| 0.000000" in jax_lines[1]  # on the CPU the ring is #6's plain version
    eager = [ln for ln in lines if "eager loop" in ln]
    assert len(eager) == len(got["points"]) == 13 and all("host clock, CPU" in ln for ln in eager)
    assert [k for k, _, ok in got["points"] if ok] == (
        ["fused_proj_mlp_q8"] + ["fused_proj_mlp_q8_ring"] * 4 + ["fused_proj_mlp_q8_packed"]
        + ["stream_probe"] * 3 + ["ablate_ring"] * 4)
    assert PEXP.launches_per_point(10, 16) == (2 * _timing.BEST_OF + 1) * 10 * 16 + 1


def test_experiment_prints_failed_only_for_refused_points(monkeypatch, capsys):
    monkeypatch.setenv("EXP_ITERS", "1")
    monkeypatch.setenv("EXP_SKIP_SWEEPS", "1")
    monkeypatch.setattr(PEXP, "CHECK_CHUNK", 128)
    monkeypatch.setattr(PEXP, "PROBE_POINTS", ((96, 4),))  # 512 % 96 != 0: the wrapper refuses it
    monkeypatch.setattr(PEXP, "I32_POINTS", ())
    monkeypatch.setattr(PEXP, "ABLATE_CASES", PEXP.ABLATE_CASES[:1])
    monkeypatch.setattr(PEXP, "ABLATE_CHUNK", 128)
    got = PEXP.main(["2"], device="cpu", C=C, H=H, L=1)
    assert len(got["failed"]) == 2 and all("FAILED ValueError: pack_w1: H % chunk must be 0" in ln for ln in got["failed"])
    assert [ln.split(":")[0] for ln in got["failed"]] == ["probe dma chunk=96", "probe dequant chunk=96"]
    monkeypatch.setattr(PEXP, "ABLATE_CASES", (("q8 full", True, True, True),))
    monkeypatch.setattr(QP, "ablate_ring", lambda *a, **k: (_ for _ in ()).throw(RuntimeError("not a refusal")))
    with pytest.raises(RuntimeError, match="not a refusal"):
        PEXP.main(["2"], device="cpu", C=C, H=H, L=1)
    capsys.readouterr()


def test_experiment_raises_without_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PEXP.main(["2"])
