"""The port of tools/exp_w8a8.py against the JAX experiment: the W8A8 proj +
LN2 + MLP (fused_proj_mlp_q8a8, #16) and its plain version's
intermediates, the per-row activation quantizer, the wrapper's refusals,
and the ported experiment's main on the CPU.

B 3 (ragged), C 128, H 512, chunks 128 and 256, fp32 activations from
numpy seeds, int8 weights from the JAX quantizer carried across by
checkpoint/from_jax.py::q8_pipeline_weights_from_jax. The JAX kernel runs
in interpret mode (pltpu.force_tpu_interpret_mode()); its intermediates
(x2, h, hq, hs, t_j, tq_j, ts_j) are restated in jnp from the kernel's
lines (tools/exp_w8a8.py:64-95), with the experiment's own _quant_rows,
DL._ln and DL._gelu. The JAX module parses sys.argv[1] as B when it is
imported, so it is imported with sys.argv patched. On the CPU the port's
wrapper takes its plain version.

Tolerances, and why:
- hs and ts_j: 1e-6 relative (fp32 LayerNorm sums and gelu in another
  order; the JAX kernel's polynomial erf is within 1.5e-7 of the exact one;
  ts_j only in rows whose hq agrees, since an hq flip moves t).
- hq and tq_j: at most 0.5% of the entries may differ, each by one, where
  an fp32 value lands on the other side of a rounding half; none by more.
- The output: 2e-5 plus what those entries explain. The int32 sums are
  exact, so out_port - out_jax = sum_j (ts_j tq_j - ts_j' tq_j') @ w2_j^T
  x s_2 up to fp32 roundoff; the bound adds, per row and column, sum_j
  ts_j |tq_j - tq_j'| @ |w2_j|^T s_2 + |ts_j - ts_j'| |tq_j'| @ |w2_j|^T
  s_2 (an hq flip reaches the output only through t_j).
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rqvae_tpu.models.rqtransformer import model as JM
from rqvae_tpu.ops import decode_layer_kernel as DL
from rqvae_tpu_torch.checkpoint import from_jax
from rqvae_tpu_torch.ops import w8a8_kernel as W8
from rqvae_tpu_torch.tools import _timing
from rqvae_tpu_torch.tools import exp_w8a8 as PEXP

B, C, H = 3, 128, 512
TOL = 2e-5
FLIPS = 0.005  # most share of quantized entries that may differ (by one)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def EXP():
    """tools/exp_w8a8.py, imported with sys.argv patched."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["exp_w8a8.py"])
        spec = importlib.util.spec_from_file_location("jax_exp_w8a8", os.path.join(ROOT, "tools", "exp_w8a8.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
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
    port = (_t(x), _t(y), _t(w["wo_q"]), _bf16(w["wo_s"]), _t(bo), _t(lns), _t(lnb), _t(w["w1_q"]), _bf16(w["w1_s"]),
            _t(b1), _t(w["w2_q"]), _bf16(w["w2_s"]), _t(b2))
    return jax_args, port


def _jax_steps(EXP, args, gelu, chunk):
    """hq, hs, [tq_j], [ts_j] of the JAX kernel, restated from its lines."""
    x, y, wo_q, wo_s, bo, lns, lnb, w1_q, w1_s, b1, w2_q, w2_s, b2 = args
    f32 = jnp.float32
    proj = jnp.dot(y, wo_q.astype(f32), preferred_element_type=f32) * wo_s.astype(f32)
    x2 = x + (proj + bo.astype(f32)).astype(x.dtype)
    h = DL._ln(x2, lns, lnb, f32)
    hq, hs = EXP._quant_rows(h)
    tq, ts = [], []
    for j in range(H // chunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        t32 = jax.lax.dot_general(hq, w1_q[:, sl], (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
        t = DL._gelu(t32.astype(f32) * hs * w1_s[:, sl].astype(f32) + b1[sl].astype(f32), gelu)
        q, s = EXP._quant_rows(t)
        tq.append(np.asarray(q))
        ts.append(np.asarray(s))
    return np.asarray(hq), np.asarray(hs), tq, ts


def _check_flips(name, got, want):
    """At most FLIPS of the entries differ, each by one. Returns |got - want|."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, f"{name}: an entry differs by {d.max()}"
    assert d.mean() <= FLIPS, f"{name}: {int(d.sum())} of {d.size} entries differ"
    return d


def _held(EXP, jargs, port, gelu, chunk):
    """Run both sides at one point and hold the port to JAX (module
    docstring). Returns (port out, JAX out, the output bound)."""
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(EXP.fused_proj_mlp_q8a8(*jargs, gelu_version=gelu, chunk=chunk))
    launches = W8.fused_proj_mlp_q8a8.launches
    got = W8.fused_proj_mlp_q8a8(*port, gelu_version=gelu, chunk=chunk)
    assert W8.fused_proj_mlp_q8a8.launches == launches  # the CPU takes the plain version
    out, st = W8.q8a8_steps(*port, gelu_version=gelu, chunk=chunk)
    assert torch.equal(got, out)
    hq_j, hs_j, tq_j, ts_j = _jax_steps(EXP, jargs, gelu, chunk)
    np.testing.assert_allclose(st["hs"].numpy(), hs_j, rtol=1e-6, atol=0)
    hq_flip = _check_flips("hq", st["hq"].numpy(), hq_j).any(-1)
    w2 = np.abs(port[10].numpy().astype(np.float64)) * port[11].float().numpy()[:, None]  # |w2_q| s_2 [C, H]
    explained = np.zeros((B, C))
    for j, (q, s) in enumerate(zip(st["tq"], st["ts"])):
        sl = slice(j * chunk, (j + 1) * chunk)
        s, q = s.numpy().astype(np.float64), q.numpy()
        np.testing.assert_allclose(s[~hq_flip], ts_j[j][~hq_flip], rtol=1e-6, atol=0)
        dq = _check_flips(f"tq_{j}", q, tq_j[j])
        explained += (s * dq) @ w2[:, sl].T + np.abs(s - ts_j[j]) * np.abs(tq_j[j]) @ w2[:, sl].T
    assert got.dtype == torch.float32 and got.shape == (B, C)
    np.testing.assert_array_less(np.abs(got.numpy() - want), TOL + explained)
    return got, want, TOL + explained


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("gelu", ["v1", "v2"])
def test_q8a8_matches_jax(EXP, gelu, chunk):
    jargs, port = _layer(10 + chunk // 128)
    _held(EXP, jargs, port, gelu, chunk)


def test_result_changes_with_chunk_as_jax(EXP):
    jargs, port = _layer(20)
    got128, want128, bound128 = _held(EXP, jargs, port, "v1", 128)
    got256, want256, bound256 = _held(EXP, jargs, port, "v1", 256)
    d_port, d_jax = (got128 - got256).numpy(), want128 - want256
    # t's row scale is taken per chunk, so the chunk moves the result well
    # beyond the bounds, and the port moves with JAX
    assert np.abs(d_jax).max() > 10 * max(bound128.max(), bound256.max())
    np.testing.assert_array_less(np.abs(d_port - d_jax), bound128 + bound256)


def test_quant_rows_matches_jax(EXP):
    r = np.random.RandomState(30)
    x = _rand(r, 6, 64, std=3.0)
    x[1] = 0.0  # the 1e-8 floor
    x[2, :4] = [127.0, 0.5, 1.5, -2.5]  # halves round to even: 0, 2, -2
    x[3] *= 1e-12
    q, s = W8._quant_rows(_t(x))
    qj, sj = EXP._quant_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert q.dtype == torch.int8 and list(q[2, :4]) == [127, 0, 2, -2] and float(s[1, 0]) == np.float32(1e-8)


def test_wrapper_refusals():
    _, p = _layer(40)
    with pytest.raises(ValueError, match="H % chunk"):
        W8.fused_proj_mlp_q8a8(*p, chunk=96)
    bad = list(p)
    bad[7] = p[7].float()
    with pytest.raises(ValueError, match="w1_q must be int8"):
        W8.fused_proj_mlp_q8a8(*bad)
    with pytest.raises(ValueError, match="unknown gelu version"):
        W8.fused_proj_mlp_q8a8(*p, gelu_version="tanh", chunk=128)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        W8.fused_proj_mlp_q8a8(*[t.to("meta") for t in p], chunk=128)


def test_experiment_main_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("EXP_ITERS", "2")
    got = PEXP.main(["3"], device="cpu", C=C, H=H, L=2, chunk=128)
    lines = capsys.readouterr().out.splitlines()
    assert lines == got["lines"]
    jax_lines = [ln for ln in lines if "eager loop" not in ln]  # the JAX experiment's four lines, in order
    assert [ln.split(":")[0] for ln in jax_lines] == ["bf16  chain", "q8    chain", "q8a8  chain", "q8a8 vs q8"]
    assert jax_lines[0].endswith("GB/s") and all(ln.endswith("GB/s (int8 bytes)") for ln in jax_lines[1:3])
    assert "mean|d|" in jax_lines[3] and "max|d|" in jax_lines[3] and "mean|q8|" in jax_lines[3]
    eager = [ln for ln in lines if "eager loop" in ln]
    assert len(eager) == 3 and all("host clock, CPU" in ln for ln in eager)
    assert set(got["ms"]) == {"bf16", "q8", "q8a8"}
    mean_d, max_d, mean_q8 = got["err"]
    assert 0 < mean_d < max_d < mean_q8  # int8 activations move the layer, by less than its scale
    assert PEXP.launches_per_chain(10, 16) == (2 * _timing.BEST_OF + 1) * 10 * 16 + 1


def test_experiment_raises_without_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PEXP.main(["2"])
