"""The port's stage-1 trainer against the JAX package on the CPU: three
train steps with the discriminator and three without, the eval step on
the EMA, the state carried from JAX, and the steps' plumbing (bf16 AMP:
test_torch_trainer_stage1_amp.py).

Geometry: tests/test_trainers.py's tiny DD / HP (32x32 pixels, ch 16,
ch_mult 1,2,2,2, 4x4x2 codes over 64 shared codes, restart on, mse) with
NLayerDiscriminator(ndf=16, n_layers=2) and LPIPS on JAX's init_lpips
weights, each side's init perturbed by seeded noise; 2 images a step, so
the 32 vectors a depth tile the restart pool with noise. Both optimizers
Adam (0.5, 0.9) on a cosine from 1e-3 with no warmup (the weights move
from the first step); lpips_bf16 off, fp32, codes by the plain argmin.

JAX's steps run jitted. Each step's restart draws are handed to the port:
rqvae_tpu.ops.quantize.quantize_train is wrapped at run time so that a
jax.debug.callback records the key, input and codebook state the
quantizer receives inside the step (flax's make_rng derives that key; it
is read, not rebuilt), then JAX's own quantize_train is replayed on them
eagerly with jax.random.uniform / permutation recording their output,
and the port's restart_candidates builds the candidates from those.

Tolerances: metrics 1e-5 relative (+ 1e-6); codes equal; codebook
buffers 1e-4 (they are sums of the encoder's outputs, whose weights carry
the parameters' differences below); each first-step gradient and
BatchNorm statistic within 1e-4 of its tensor's max (+ 1e-6 of the
largest), the later steps' gradients and Adam's moments (their sums)
within 1e-3 (they are taken on weights that already carry the
differences below); parameters 5e-6 + 1e-5
relative where the JAX gradient is above 1e-2 of its tensor's max at
every step, or 0 at every step, and within two learning rates a step
elsewhere. Adam divides each gradient by its own root mean square, so an
entry at 1e-3 of the max, carrying 1e-6 of the max in rounding, moves
its parameter by 1e-3 of a learning rate differently, and more where
the steps' gradients cancel in the first moment (8.5e-6 seen at 1e-3).
Hence 1e-2 and 5e-6 rather than the stage-2 test's 1e-6 and 1e-6: 5e-6 is 1.7e-3
of the three steps' learning rates (3e-3 in all; the stage-2 test's 3e-4). A tensor whose JAX gradient never exceeds 1e-5 of the largest
tensor's is rounding noise, 0 in exact arithmetic (here below 3e-7 of it,
the next tensors above 6e-3: the biases of convs and keys whose output
only a one-channel-per-group GroupNorm or a softmax reads), and is held
to the two learning rates alone: Adam moves a parameter whose gradient is
rounding noise by a learning rate either way.
"""

import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.losses.discriminator import NLayerDiscriminator as JDisc
from rqvae_tpu.losses.lpips import LPIPS as JLPIPS
from rqvae_tpu.losses.lpips import init_lpips
from rqvae_tpu.models.rqvae.model import RQVAE as JRQVAE
from rqvae_tpu.models.rqvae.model import RQVAEHParams as JHParams
from rqvae_tpu.models.rqvae.modules import DDConfig as JDDConfig
from rqvae_tpu.ops import quantize as jrq
from rqvae_tpu.optim.optimizer import create_optimizer as j_create_optimizer
from rqvae_tpu.optim.schedule import create_schedule as j_create_schedule
from rqvae_tpu.trainers import trainer_stage1 as J1
from rqvae_tpu_torch.checkpoint import from_jax
from rqvae_tpu_torch.losses.discriminator import NLayerDiscriminator
from rqvae_tpu_torch.losses.lpips import LPIPS
from rqvae_tpu_torch.models.rqvae.model import RQVAE, RQVAEHParams
from rqvae_tpu_torch.models.rqvae.modules import DDConfig
from rqvae_tpu_torch.optim.schedule import create_schedule
from rqvae_tpu_torch.trainers import trainer_stage1 as T1
from test_torch_quantize_train import jax_draw, recorded_draws
from test_torch_rqtransformer import to_torch
from test_trainers import DD, HP

OPTIM = {"type": "adam", "betas": [0.5, 0.9], "weight_decay": 0.0}
ADAM_B1 = OPTIM["betas"][0]
N_STEPS = 3
BATCH = 2
DISC = dict(ndf=16, n_layers=2)
GAN = dict(lpips_bf16=False)


def _schedule(make):
    return make(base_lr=1e-3, warmup_config={"epoch": 0, "min_lr": 1e-4}, steps_per_epoch=10, max_epoch=1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _adam(opt_state):
    (adam,) = from_jax._optax_states(opt_state, ("count", "mu", "nu"))
    return adam


class QuantizerCalls:
    """Wraps rqvae_tpu.ops.quantize.quantize_train (looked up by
    rq_bottleneck_forward at run time) so that each call inside a jitted
    step records (x, codebook state, key) through jax.debug.callback."""

    def __init__(self):
        self.calls = []
        self.orig = jrq.quantize_train

    def __call__(self, x, state, config, rng, axis_name=None, *, use_kernel=True):
        def record(x_, embed, cluster, ema, key):
            state_ = jrq.CodebookState(embed=jnp.asarray(embed), cluster_size=jnp.asarray(cluster),
                                       embed_ema=jnp.asarray(ema))
            self.calls.append((np.asarray(x_), state_, jnp.asarray(key), config))

        jax.debug.callback(record, x, state.embed, state.cluster_size, state.embed_ema, rng)
        return self.orig(x, state, config, rng, axis_name, use_kernel=use_kernel)

    def draws(self, i):
        """The draws of the i-th recorded call, replayed eagerly."""
        x, state, key, config = self.calls[i]
        with recorded_draws() as calls:
            self.orig(jnp.asarray(x), state, config, key, use_kernel=False)
        return calls


@pytest.fixture(scope="module")
def jax_init():
    """JAX's models, init state (params perturbed) and an image batch."""
    model = JRQVAE(hparams=JHParams.create(HP), ddconfig=JDDConfig.create(DD), use_kernel=False)
    disc = JDisc(**DISC)
    tx = j_create_optimizer(OPTIM, _schedule(j_create_schedule))
    disc_tx = j_create_optimizer(OPTIM, _schedule(j_create_schedule))
    state = J1.init_state(jax.random.PRNGKey(0), model, disc, tx, disc_tx, image_shape=(32, 32, 3), use_ema=True)
    rng = np.random.RandomState(0)
    noisy = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: jnp.asarray((np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)), tree)
    params, disc_params = noisy(state.params), noisy(state.disc_params)
    state = state.replace(params=params, opt_state=tx.init(params), ema_params=jax.tree.map(jnp.copy, params),
                          disc_params=disc_params, disc_opt_state=disc_tx.init(disc_params))
    lpips_vars = init_lpips(jax.random.PRNGKey(4))
    xs = np.random.RandomState(1).uniform(-1.0, 1.0, size=(BATCH, 32, 32, 3)).astype(np.float32)
    return dict(model=model, disc=disc, tx=tx, disc_tx=disc_tx, state=state, lpips_vars=lpips_vars, xs=xs)


def run_jax(ji, use_disc, n_steps=N_STEPS, **gan):
    """JAX's n_steps jitted steps from the init state: states (numpy),
    metrics, codes, gradients (from adam's first moment) of both
    optimizers, and the quantizer's recorded calls."""
    gan_cfg = J1.GanLossConfig(**{**GAN, **gan})
    step = jax.jit(J1.make_train_step(ji["model"], ji["disc"], JLPIPS(), ji["lpips_vars"], gan_cfg, ji["tx"],
                                      ji["disc_tx"], use_discriminator=use_disc))
    recorder = QuantizerCalls()
    state = ji["state"]
    out = dict(states=[jax.device_get(state)], metrics=[], codes=[], grads=[], disc_grads=[], recorder=recorder)
    with mock.patch.object(jrq, "quantize_train", recorder):
        for _ in range(n_steps):
            state, m, c = step(state, {"images": jnp.asarray(ji["xs"])}, jax.random.PRNGKey(7))
            jax.effects_barrier()
            prev, cur = out["states"][-1], jax.device_get(state)
            out["states"].append(cur)
            out["metrics"].append(jax.device_get(m))
            out["codes"].append(np.asarray(c))
            for key, opt in (("grads", "opt_state"), ("disc_grads", "disc_opt_state")):
                mu0, mu1 = _adam(getattr(prev, opt)).mu, _adam(getattr(cur, opt)).mu
                out[key].append(jax.tree.map(lambda a, b: (b - ADAM_B1 * a) / (1.0 - ADAM_B1), mu0, mu1))
    assert len(recorder.calls) == n_steps
    return out


def port_state(ji, jstate, use_ema=True):
    """The port's Stage1State holding JAX's state jstate (numpy)."""
    return from_jax.stage1_state_from_jax(
        jstate, RQVAEHParams.create(HP), DDConfig.create(DD), DISC, OPTIM, _schedule(create_schedule), OPTIM,
        _schedule(create_schedule), device="cpu", use_kernel=False)


def port_lpips(ji):
    lpips = LPIPS(device="cpu")
    lpips.load_state_dict(to_torch(from_jax.lpips_state_dict_from_jax(jax.device_get(ji["lpips_vars"])["params"])))
    return lpips


def run_port(ji, jrun, use_disc, start=0, n_steps=N_STEPS, **gan):
    """The port's steps from JAX's state after `start` steps, with JAX's
    draws: its state and each step's metrics, codes and gradients."""
    state = port_state(ji, jrun["states"][start])
    step = T1.make_train_step(port_lpips(ji), T1.GanLossConfig(**{**GAN, **gan}), use_discriminator=use_disc)
    batch = {"images": _t(ji["xs"])}
    out = dict(metrics=[], codes=[], grads=[], disc_grads=[], step=step)
    for n in range(start, start + n_steps):
        state, m, c = step(state, batch, None, draw=jax_draw(jrun["recorder"].draws(n)))
        out["metrics"].append(m)
        out["codes"].append(c)
        out["grads"].append({k: p.grad.clone() for k, p in state.model.named_parameters()})
        out["disc_grads"].append({k: None if p.grad is None else p.grad.clone()
                                  for k, p in state.disc.named_parameters()})
    out["state"] = state
    return out


@pytest.fixture(scope="module", params=[True, False], ids=["disc", "no_disc"])
def runs(request, jax_init):
    use_disc = request.param
    jrun = run_jax(jax_init, use_disc)
    return use_disc, jrun, run_port(jax_init, jrun, use_disc)


def _compare_metrics(got: dict, want: dict, rtol=1e-5, atol=1e-6):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=rtol, atol=atol, err_msg=k)


def _close_to_max(got: dict, want: dict, what, tol: float = 1e-4) -> None:
    assert set(got) == set(want), (what, set(got) ^ set(want))
    floor = 1e-6 * max(np.abs(np.asarray(w)).max() for w in want.values())
    for k, w in want.items():
        w = np.asarray(w)
        assert np.abs(np.asarray(got[k]) - w).max() <= tol * np.abs(w).max() + floor, (what, k)


def _compare_params(got: dict, want: dict, grads: list, lrs: list):
    """Parameters where each step's JAX gradient is above 1e-2 of its
    tensor's max, or 0, at every step; within two learning rates a step
    everywhere; a noise tensor only within those (module docstring)."""
    top = max(np.abs(np.asarray(gr[k])).max() for gr in grads for k in want)
    for k, w in want.items():
        g = [np.asarray(gr[k]) for gr in grads]
        p = got[k].detach().numpy()
        assert np.abs(p - np.asarray(w)).max() <= 2 * sum(lrs) + 1e-6, k
        if 0 < max(np.abs(x).max() for x in g) < 1e-5 * top:
            continue
        above = np.all([np.abs(x) > 1e-2 * np.abs(x).max() for x in g], axis=0)
        zero = np.all([x == 0 for x in g], axis=0)
        keep = above | zero
        assert keep.mean() > 0.5, (k, keep.mean())
        np.testing.assert_allclose(p[keep], np.asarray(w)[keep], rtol=1e-5, atol=5e-6, err_msg=k)


def _rqvae_sd(tree):
    return from_jax._rqvae_params_from_jax(tree)


def _disc_sd(tree, stats=None):
    return from_jax.discriminator_state_dict_from_jax(tree, stats, DISC["n_layers"])


def _compare_codebook(tensors: dict, cb_state, qcfg):
    """The quantizer.* entries of `tensors` against a JAX CodebookState."""
    want = from_jax.codebook_state_dict_from_jax(cb_state, qcfg)
    got = {k: v for k, v in tensors.items() if k.startswith("quantizer.")}
    assert got and set(got) <= set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=1e-4, rtol=1e-4, err_msg=k)


def test_train_steps_match_jax(runs, jax_init):
    """Metrics (g_weight included), codes, the codebook state, every
    gradient of both optimizers, parameters, Adam's moments, the
    BatchNorm statistics, the EMA of the params and the codebook, and the
    step counters, after three steps."""
    use_disc, jrun, prun = runs
    state = prun["state"]
    final = jrun["states"][-1]
    qcfg = jax_init["model"].quantizer_config
    for n in range(N_STEPS):
        _compare_metrics(prun["metrics"][n], jrun["metrics"][n])
        np.testing.assert_array_equal(prun["codes"][n].numpy(), jrun["codes"][n])
        tol = 1e-4 if n == 0 else 1e-3  # later steps' weights carry the first updates' differences
        _close_to_max({k: g.numpy() for k, g in prun["grads"][n].items()}, _rqvae_sd(jrun["grads"][n]), n, tol)
        if use_disc:
            _close_to_max({k: g.numpy() for k, g in prun["disc_grads"][n].items()}, _disc_sd(jrun["disc_grads"][n]),
                          n, tol)
    if use_disc:
        assert all(float(m["g_weight"]) > 0 for m in prun["metrics"])
        assert state.disc_step == N_STEPS == int(final.disc_step)
    else:
        assert all(float(m["loss_gen"]) == 0 and float(m["g_weight"]) == 0 for m in prun["metrics"])
        assert state.disc_step == 0 and all(g is None for g in prun["disc_grads"][-1].values())
    assert state.step == N_STEPS == int(final.step)
    lrs = [_schedule(create_schedule)(n) for n in range(N_STEPS)]
    jgrads = [_rqvae_sd(g) for g in jrun["grads"]]
    _compare_params(dict(state.model.named_parameters()), _rqvae_sd(final.params), jgrads, lrs)
    disc_sd = _disc_sd(final.disc_params, final.disc_batch_stats)
    dgrads = [_disc_sd(g) for g in jrun["disc_grads"]]
    _compare_params(dict(state.disc.named_parameters()), {k: disc_sd[k] for k, _ in state.disc.named_parameters()},
                    dgrads if use_disc else [{k: np.zeros_like(v) for k, v in d.items()} for d in dgrads], lrs)
    stats = {k: v.numpy() for k, v in state.disc.state_dict().items() if "running" in k}
    _close_to_max(stats, {k: disc_sd[k] for k in stats}, "batch stats")
    for opt, tree, sd in ((state.optimizer, final.opt_state, _rqvae_sd), (state.disc_optimizer, final.disc_opt_state,
                                                                          _disc_sd)):
        adam = _adam(tree)
        params = dict(state.model.named_parameters()) if opt is state.optimizer else dict(state.disc.named_parameters())
        for name, moment in (("mu", adam.mu), ("nu", adam.nu)):
            _close_to_max({k: opt.state[p][name].numpy() for k, p in params.items()}, sd(moment), name, 1e-3)
    _compare_codebook(state.model.state_dict(), final.codebook["state"], qcfg)
    _compare_codebook(state.ema, final.ema_codebook["state"], qcfg)
    ema_params = {k: v for k, v in state.ema.items() if not k.startswith("quantizer.")}
    _compare_params(ema_params, _rqvae_sd(final.ema_params), jgrads, lrs)


def test_eval_step_runs_the_ema_like_jax(runs, jax_init):
    use_disc, jrun, prun = runs
    ji = jax_init
    final = jrun["states"][-1]
    want, want_codes = jax.jit(J1.make_eval_step(ji["model"], ji["disc"], JLPIPS(), ji["lpips_vars"],
                                                 J1.GanLossConfig(**GAN), use_discriminator=use_disc,
                                                 use_ema=True))(final, {"images": jnp.asarray(ji["xs"])})
    ev = T1.make_eval_step(port_lpips(ji), T1.GanLossConfig(**GAN), use_discriminator=use_disc, use_ema=True)
    before = copy.deepcopy(prun["state"].model.state_dict())
    got, codes = ev(prun["state"], {"images": _t(ji["xs"])})
    after = prun["state"].model.state_dict()  # the EMA's values swapped out again, the shared codebook's too
    assert all(torch.equal(after[k], v) for k, v in before.items())
    _compare_metrics(got, jax.device_get(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    plain, _ = T1.make_eval_step(port_lpips(ji), T1.GanLossConfig(**GAN), use_discriminator=use_disc)(
        prun["state"], {"images": _t(ji["xs"])})
    assert float(plain["loss_total"]) != float(got["loss_total"])


def test_carried_state_resumes_like_jax(runs, jax_init):
    """JAX's state after two steps, carried into the port
    (stage1_state_from_jax), takes the third step as JAX's did."""
    use_disc, jrun, _ = runs
    prun = run_port(jax_init, jrun, use_disc, start=2, n_steps=1)
    state = prun["state"]
    _compare_metrics(prun["metrics"][0], jrun["metrics"][2])
    np.testing.assert_array_equal(prun["codes"][0].numpy(), jrun["codes"][2])
    assert state.step == 3 and state.disc_step == (3 if use_disc else 0)
    assert state.optimizer.param_groups[0]["count"] == 3
    lrs = [_schedule(create_schedule)(n) for n in range(N_STEPS)]
    _compare_params(dict(state.model.named_parameters()), _rqvae_sd(jrun["states"][3].params),
                    [_rqvae_sd(g) for g in jrun["grads"]], lrs)
    _compare_codebook(state.model.state_dict(), jrun["states"][3].codebook["state"], jax_init["model"].quantizer_config)


def test_perceptual_weight_zero_skips_lpips(jax_init):
    """perceptual_weight 0 runs without an LPIPS module (loss_pcpt 0);
    the steps leave no gradient in LPIPS; one with a perceptual weight
    needs the module."""
    ji = jax_init
    jstate = jax.device_get(ji["state"])
    state = port_state(ji, jstate)
    step = T1.make_train_step(None, T1.GanLossConfig(perceptual_weight=0.0), use_discriminator=True)
    gen = torch.Generator().manual_seed(0)
    _, m, codes = step(state, {"images": _t(ji["xs"])}, gen)
    assert float(m["loss_pcpt"]) == 0.0 and all(bool(torch.isfinite(v)) for v in m.values())
    assert codes.shape == (BATCH, 4, 4, 2)
    lpips = port_lpips(ji)
    state = port_state(ji, jstate)
    T1.make_train_step(lpips, T1.GanLossConfig(), use_discriminator=True)(state, {"images": _t(ji["xs"])}, gen)
    assert all(p.grad is None for p in lpips.parameters())
    with pytest.raises(ValueError, match="LPIPS"):
        T1.make_train_step(None, T1.GanLossConfig(), use_discriminator=True)
    with pytest.raises(ValueError, match="Generator"):
        T1.make_train_step(lpips, T1.GanLossConfig(), use_discriminator=False)(
            port_state(ji, jstate), {"images": _t(ji["xs"])}, None)


def test_init_state_builds_both_optimizers_and_the_ema():
    model = RQVAE(RQVAEHParams.create(HP), DDConfig.create(DD), device="cpu")
    disc = NLayerDiscriminator(**DISC, device="cpu")
    state = T1.init_state(model, disc, OPTIM, _schedule(create_schedule), {"type": "sgd"}, lambda n: 0.1,
                          use_ema=True)
    assert state.step == 0 and state.disc_step == 0
    assert state.optimizer.param_groups[0]["kind"] == "adam" and state.disc_optimizer.param_groups[0]["kind"] == "sgd"
    assert set(state.ema) == {k for k, _ in model.named_parameters()} | {
        "quantizer.codebooks.0.weight", "quantizer.codebooks.0.cluster_size_ema", "quantizer.codebooks.0.embed_ema"}
    assert T1.init_state(copy.deepcopy(model), copy.deepcopy(disc), OPTIM, _schedule(create_schedule), OPTIM,
                         _schedule(create_schedule)).ema is None


def test_checkpointing_step_equals_plain(jax_init):
    """The train step with the RQ-VAE's checkpointing (each ResnetBlock
    recomputed in the backward, through torch.autograd.grad) gives the
    plain step's metrics, codes and gradients, with restarts drawn from a
    generator and the LPIPS tower in bf16."""
    from rqvae_tpu_torch.models.rqvae.modules import set_checkpointing

    jstate = jax.device_get(jax_init["state"])
    lpips = port_lpips(jax_init)
    runs = []
    for remat in (False, True):
        state = port_state(jax_init, jstate)
        set_checkpointing(state.model, remat)
        step = T1.make_train_step(lpips, T1.GanLossConfig(), use_discriminator=True)
        _, m, codes = step(state, {"images": _t(jax_init["xs"])}, torch.Generator().manual_seed(3))
        runs.append((m, codes, {k: p.grad for k, p in state.model.named_parameters()}))
    (m0, c0, g0), (m1, c1, g1) = runs
    assert torch.equal(c0, c1)
    for k in m0:
        np.testing.assert_allclose(m1[k].numpy(), m0[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
