"""The port of tools/exp_mlp_kernel.py against the JAX experiment: the bf16
decode MLP (fused_mlp, #15) and its plain version, the experiment's plain
xla_mlp, the weight bridge (mlp_weights_from_jax), the wrapper's refusals,
the ported experiment's main on the CPU, and the stage arithmetic of the
row-grouped ring kernels (#15 and #16).

B 3 (ragged), C 128, H 512, chunks 128 and 256, fp32 x and LayerNorm
parameters from numpy seeds, bf16 weights and biases (the experiment's
types), carried across by checkpoint/from_jax.py::mlp_weights_from_jax. The
JAX kernel runs in interpret mode (pltpu.force_tpu_interpret_mode()); its
intermediates h and t are restated in jnp from its lines
(tools/exp_mlp_kernel.py:48-72). The kernel reads the module globals C and
H for its block shapes and H // chunk, and its default chunk is bound when
the module loads, so the fixture sets EXP.C and EXP.H (module attributes;
the file is not edited) and every call passes chunk. The JAX kernel has the
erf gelu only; the port's "v2" is held to the restated steps with DL._gelu
"v2". On the CPU the port's wrapper takes its plain version.

Tolerances, and why:
- #15: h and t are rounded to bf16 in both, from fp32 values summed in
  another order (and the JAX kernel's polynomial erf, within 1.5e-7 of the
  exact one), so a value may land on the other side of a bf16 rounding
  half: at most 0.5% of h's and t's entries may differ, each by one bf16
  step of its value. The output is x + t @ w2^T + b2 in fp32: within 2e-5
  plus |t - t'| @ |w2|^T, what those entries explain.
- xla_mlp: every operation rounds to bf16 in both, but XLA may keep fp32
  inside a fusion where torch rounds after each operation (and torch's
  bf16 gelu computes in fp32 then rounds): within 2 bf16 steps of the
  output's scale, 2 x 2^-8 (1 + |ref|) (observed: under one).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rqvae_tpu.models.rqtransformer import model as JM
from rqvae_tpu.ops import decode_layer_kernel as DL
from rqvae_tpu_torch.checkpoint import from_jax
from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from rqvae_tpu_torch.ops import mlp_kernel as MK
from rqvae_tpu_torch.ops import q8_pipeline_kernel as QP
from rqvae_tpu_torch.tools import _timing
from rqvae_tpu_torch.tools import exp_mlp_kernel as PEXP

B, C, H = 3, 128, 512
TOL = 2e-5
FLIPS = 0.005  # most share of bf16 entries that may differ (by one step)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def EXP():
    """tools/exp_mlp_kernel.py with its module globals C and H set to the test's."""
    spec = importlib.util.spec_from_file_location("jax_exp_mlp_kernel", os.path.join(ROOT, "tools", "exp_mlp_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.C, mod.H = C, H
    return mod


def _rand(r, *shape, std=1.0, mean=0.0):
    return (r.standard_normal(shape) * std + mean).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _layer(seed):
    """One layer: the JAX arrays (x, ln_s, ln_b fp32; w1 [C, H], b1, w2 [H,
    C], b2 bf16) and the port's (through mlp_weights_from_jax; bf16 weights
    and biases)."""
    r = np.random.RandomState(seed)
    x = _rand(r, B, C)
    lns, lnb = _rand(r, C, std=0.1, mean=1.0), _rand(r, C, std=0.1)
    bf = jnp.bfloat16
    w1, w2 = jnp.asarray(_rand(r, C, H, std=0.02), bf), jnp.asarray(_rand(r, H, C, std=0.02), bf)
    b1, b2 = jnp.asarray(_rand(r, H, std=0.05), bf), jnp.asarray(_rand(r, C, std=0.05), bf)
    w = from_jax.mlp_weights_from_jax(w1, b1, w2, b2)
    port = dict(x=_t(x), ln_s=_t(lns), ln_b=_t(lnb), **{k: _t(v).to(torch.bfloat16) for k, v in w.items()})
    return (jnp.asarray(x), jnp.asarray(lns), jnp.asarray(lnb), w1, b1, w2, b2), port


def _jax_steps(args, gelu):
    """h and t (bf16, as fp32 numpy) of the JAX kernel, restated from its lines."""
    x, lns, lnb, w1, b1, w2, _ = args
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.maximum(jnp.mean(x32 * x32, axis=-1, keepdims=True) - mean * mean, 0.0)
    h = ((x32 - mean) * jax.lax.rsqrt(var + JM.LN_EPS) * lns + lnb).astype(jnp.bfloat16)
    t = jnp.dot(h, w1, preferred_element_type=jnp.float32)
    t = DL._gelu(t + b1.astype(jnp.float32), gelu).astype(jnp.bfloat16)
    return np.asarray(h, np.float32), np.asarray(t, np.float32)


def _port_steps(p, gelu):
    """h and t of the port's plain version (its first two lines)."""
    h = DK._layer_norm(p["x"].float(), p["ln_s"], p["ln_b"]).to(torch.bfloat16)
    t = DK._gelu32(h.float() @ p["w1"].float().t() + p["b1"].float(), gelu).to(torch.bfloat16)
    return h.float().numpy(), t.float().numpy()


def _check_flips(name, got, want):
    """At most FLIPS of the bf16 entries differ, each by one bf16 step of its value."""
    d = np.abs(got - want)
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (d <= step).all(), f"{name}: an entry differs by more than one bf16 step"
    assert (d > 0).mean() <= FLIPS, f"{name}: {int((d > 0).sum())} of {d.size} entries differ"


def _held(p, want, jsteps, gelu, chunk):
    launches = MK.fused_mlp.launches
    got = MK.fused_mlp(p["x"], p["ln_s"], p["ln_b"], p["w1"], p["b1"], p["w2"], p["b2"], gelu_version=gelu, chunk=chunk)
    assert MK.fused_mlp.launches == launches  # the CPU takes the plain version
    h, t = _port_steps(p, gelu)
    _check_flips("h", h, jsteps[0])
    _check_flips("t", t, jsteps[1])
    explained = np.abs(t - jsteps[1]) @ np.abs(p["w2"].float().numpy()).T
    assert got.dtype == torch.float32 and got.shape == (B, C)
    np.testing.assert_array_less(np.abs(got.numpy() - want), TOL + explained)


@pytest.mark.parametrize("chunk", [128, 256])
def test_fused_mlp_matches_jax(EXP, chunk):
    jargs, p = _layer(10 + chunk // 128)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(EXP.pallas_mlp(*jargs, chunk=chunk))
    _held(p, want, _jax_steps(jargs, "v1"), "v1", chunk)


def test_fused_mlp_gelu_v2_matches_the_jax_steps():
    jargs, p = _layer(13)
    h, t = _jax_steps(jargs, "v2")
    x, _, _, _, _, w2, b2 = jargs
    want = np.asarray(x + jnp.dot(jnp.asarray(t, jnp.bfloat16), w2, preferred_element_type=jnp.float32)
                      + b2.astype(jnp.float32))
    _held(p, want, (h, t), "v2", 128)


def test_xla_mlp_matches_jax(EXP):
    jargs, p = _layer(14)
    x, lns, lnb, w1, b1, w2, b2 = jargs
    want = np.asarray(EXP.xla_mlp(x.astype(jnp.bfloat16), lns, lnb, w1, b1, w2, b2), np.float32)
    got = PEXP.xla_mlp(p["x"].to(torch.bfloat16), p["ln_s"], p["ln_b"], p["w1"], p["b1"], p["w2"], p["b2"])
    assert got.dtype == torch.bfloat16 and got.shape == (B, C)
    np.testing.assert_array_less(np.abs(got.float().numpy() - want), 2 * 2.0**-8 * (1 + np.abs(want)))


def test_bridge_carries_the_weights():
    jargs, p = _layer(15)
    _, _, _, w1, b1, w2, b2 = jargs
    w = from_jax.mlp_weights_from_jax(w1, b1.reshape(1, H), w2, b2)
    np.testing.assert_array_equal(w["w1"], np.asarray(w1, np.float32).T)
    np.testing.assert_array_equal(w["w2"], np.asarray(w2, np.float32).T)
    np.testing.assert_array_equal(w["b1"], np.asarray(b1, np.float32))
    assert w["w1"].shape == (H, C) and w["w2"].shape == (C, H) and w["b1"].shape == (H,)
    assert w["w1"].flags.c_contiguous and torch.equal(_t(w["b2"]).to(torch.bfloat16), p["b2"])


def test_wrapper_refusals():
    _, p = _layer(16)
    args = [p[k] for k in ("x", "ln_s", "ln_b", "w1", "b1", "w2", "b2")]
    with pytest.raises(ValueError, match="H % chunk"):
        MK.fused_mlp(*args, chunk=96)
    bad = list(args)
    bad[3] = torch.zeros(H, C, dtype=torch.int8)
    with pytest.raises(ValueError, match="w1 must be floating point"):
        MK.fused_mlp(*bad, chunk=128)
    with pytest.raises(ValueError, match="unknown gelu version"):
        MK.fused_mlp(*args, gelu_version="tanh", chunk=128)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        MK.fused_mlp(*[a.to("meta") for a in args], chunk=128)


@pytest.fixture
def narrow(monkeypatch):
    """The ported experiment at C 128, H 512, 2 layers, 2 iterations, chunk 128."""
    for name, value in dict(C=C, H=H, L=2).items():
        monkeypatch.setattr(PEXP, name, value)
    monkeypatch.setenv("EXP_ITERS", "2")
    monkeypatch.setenv("EXP_CHUNK", "128")


def test_experiment_main_runs_on_cpu(narrow, capsys):
    got = PEXP.main(["3", "5"], device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines == got["lines"] and lines[0] == "# no round trip subtracted (host clock, CPU)"
    rows = lines[1:]
    assert len(rows) == 4
    for B_, row, eager in zip((3, 5), rows[0::2], rows[1::2]):
        cols = row.split(" | ")  # the JAX experiment's row
        assert cols[0].startswith(f"B={B_:4d} (") and "MB/step) maxdiff=" in cols[0]
        assert cols[1].startswith("xla ") and cols[2].startswith("pallas ") and all("GB/s)" in c for c in cols[1:])
        assert eager.startswith(f"B={B_:4d} eager loop") and "host clock, CPU" in eager
        assert got["rows"][B_]["failed"] == [] and 0 < got["rows"][B_]["maxdiff"] < 0.1
    assert PEXP.launches_per_batch(10) == (2 * _timing.BEST_OF + 1) * 10 * PEXP.L + 2


def test_experiment_prints_fail_only_for_refusals(narrow, monkeypatch, capsys):
    def refuse(*a, **k):
        raise ValueError("fused_mlp: at most 512 activation rows, got 600")

    monkeypatch.setattr(MK, "fused_mlp", refuse)
    got = PEXP.main(["3"], device="cpu")
    row = got["rows"][3]
    assert row["pallas_us"] is None and row["xla_us"] is not None and row["maxdiff"] is None
    assert row["failed"] == ["pallas FAIL: ValueError: fused_mlp: at most 512 activation rows, got 600"]
    assert "maxdiff=n/a" in got["lines"][1] and got["lines"][1].endswith(row["failed"][0])
    monkeypatch.setattr(MK, "fused_mlp", lambda *a, **k: (_ for _ in ()).throw(RuntimeError("not a refusal")))
    with pytest.raises(RuntimeError, match="not a refusal"):
        PEXP.main(["3"], device="cpu")
    capsys.readouterr()


def test_experiment_raises_without_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PEXP.main(["2"])


@pytest.mark.parametrize("weight_bytes,n_buf", [(1, 4), (2, 2)], ids=["int8_w8a8", "bf16_mlp"])
def test_ring_depth_matches_the_source_notes(monkeypatch, weight_bytes, n_buf):
    # csrc/mlp.cu: a bf16 chunk-1536 stage takes 98,816 B at 132 blocks, so
    # two fit the 232,448 B a block may hold; int8 (csrc/w8a8.cu) 49,664 B,
    # four (the cap); rows up to 512, C and chunk multiples of k_align
    monkeypatch.setattr(QP, "_card", lambda dev: (132, 232448))
    assert QP.ring_depth("k", None, 500, 1536, 6144, 1536, weight_bytes, 64) == (132, n_buf)
    assert QP.ring_depth("k", None, 512, 1536, 3072, 1536, weight_bytes, 64) == (132, 2)  # two chunks
    with pytest.raises(ValueError, match="at most 512 activation rows, got 513"):
        QP.ring_depth("k", None, 513, 1536, 6144, 1536, weight_bytes, 64)
    with pytest.raises(ValueError, match="multiples of 64"):
        QP.ring_depth("k", None, 100, 1536, 6144, 1504, weight_bytes, 64)
