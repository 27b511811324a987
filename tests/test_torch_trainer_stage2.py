"""The port's stage-2 trainer against the JAX package on the CPU: the
schedule, the optimizers, the EMA, the frozen encode, three train steps,
the eval step, the carried state, the text-conditional losses, the
accumulators, and the sampler after training.

The train steps run the committed synthetic checkpoints' geometry: the
stage-1 RQ-VAE of tests/goldens/synth_ckpt/stage1 (64x64 images, 8x8x2
codes, 64 shared codes) encodes the images, and the stage-2 arch of
synth_ckpt/stage2 (embed 64, 2 + 2 layers of 4 heads, VQ-VAE input and head
embeddings with the depth cumsum) with resid_pdrop 0 trains on them, from
JAX's init perturbed by seeded noise. fp32 (amp off), soft targets at
temp 1, no stochastic codes, adamW with max_gn and a warmup-cosine
schedule that starts from zero, EMA on, 4 images as 2 microbatches.

Tolerances: losses, grad_norm and eval metrics 1e-5 relative; the
schedule 1e-6 relative; the optimizers' parameters 1e-6 absolute + 1e-5
relative after three updates; the EMA 1e-6. After the train steps, each
gradient (kept in .grad as clipped; JAX's recovered from optax's first
moment) and each of Adam's moments within 1e-4 of its tensor's max (plus
1e-6 of the largest of all tensors), and the parameters and their EMA
within 1e-6 absolute + 1e-5 relative, compared only where the JAX
gradient exceeds 1e-6 of its tensor's max at every step, or is 0 at
every step: Adam divides each gradient by its own root mean square, so a
gradient at the level of rounding noise moves its parameter by a whole
learning rate in a direction that noise picks.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from rqvae_tpu.checkpoint.torch_convert import convert_rqvae
from rqvae_tpu.models import ema as JE
from rqvae_tpu.models.rqtransformer import model as JM
from rqvae_tpu.models.rqvae.model import RQVAE as JRQVAE
from rqvae_tpu.models.rqvae.model import RQVAEHParams as JHParams
from rqvae_tpu.models.rqvae.modules import DDConfig as JDDConfig
from rqvae_tpu.optim.optimizer import create_optimizer as j_create_optimizer
from rqvae_tpu.optim.schedule import create_schedule as j_create_schedule
from rqvae_tpu.trainers import accumulator as JA
from rqvae_tpu.trainers import trainer_stage2 as J2
from rqvae_tpu_torch.checkpoint import from_jax
from rqvae_tpu_torch.models import ema as TE
from rqvae_tpu_torch.models.rqtransformer import model as TM
from rqvae_tpu_torch.models.rqtransformer import sampling as TS
from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
from rqvae_tpu_torch.models.rqvae.model import RQVAE, RQVAEHParams
from rqvae_tpu_torch.models.rqvae.modules import DDConfig
from rqvae_tpu_torch.optim.optimizer import create_optimizer
from rqvae_tpu_torch.optim.schedule import create_schedule
from rqvae_tpu_torch.trainers import accumulator as TA
from rqvae_tpu_torch.trainers import trainer_stage2 as T2
from test_torch_rqtransformer import GOLDENS, TOKEMB_ARCH, build_pair, jax_config, to_torch

STEPS_PER_EPOCH = 4
OPTIM = {"type": "adamW", "betas": [0.9, 0.95], "weight_decay": 0.05, "max_gn": 1.0}
WARMUP = {"epoch": 0.5, "mode": "fix", "multiplier": 1, "min_lr": 1e-4, "start_from_zero": True}
LOSS = dict(use_soft_target=True, temp=1.0, stochastic_codes=False, amp_bf16=False)
N_STEPS = 3
ADAM_B1 = OPTIM["betas"][0]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _schedule(make, **kw):
    return make(base_lr=1e-3, warmup_config=kw.get("warmup", WARMUP), steps_per_epoch=STEPS_PER_EPOCH,
                max_epoch=5)


# -- schedule, optimizers, EMA, accumulators --------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["linear", "sqrt", "fix", "none"])
@pytest.mark.parametrize("start_from_zero", [True, False])
def test_schedule_matches_jax(mode, start_from_zero):
    """Warmup over 6 steps to multiplier 2 (world size 4), a 3-step buffer,
    cosine to min_lr over the rest, steps 0-40 (past the end)."""
    warmup = {"epoch": 1.5, "mode": mode, "multiplier": 2, "buffer_epoch": 0.75, "min_lr": 2e-5,
              "start_from_zero": start_from_zero}
    kw = dict(base_lr=1e-3, warmup_config=warmup, steps_per_epoch=4, max_epoch=8, world_size=4)
    got, want = create_schedule(**kw), j_create_schedule(**kw)
    for step in range(41):
        assert isinstance(got(step), float)
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=0, err_msg=str(step))
    if start_from_zero:
        assert got(0) == 0.0


def test_schedule_without_warmup_matches_jax():
    kw = dict(base_lr=3e-4, warmup_config={"epoch": 0, "min_lr": 1e-5}, steps_per_epoch=10, max_epoch=2)
    got, want = create_schedule(**kw), j_create_schedule(**kw)
    for step in range(25):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=0)


OPTIMIZERS = [
    {"type": "adamW", "betas": [0.9, 0.95], "weight_decay": 0.1},
    {"type": "adam", "betas": [0.5, 0.9], "weight_decay": 0.1},
    {"type": "sgd", "momentum": 0.8, "weight_decay": 0.1},
]


@pytest.mark.parametrize("max_gn", [None, 1.0])
@pytest.mark.parametrize("cfg", OPTIMIZERS, ids=[c["type"] for c in OPTIMIZERS])
def test_optimizer_matches_optax(cfg, max_gn):
    """Three updates of three random arrays with random gradients whose
    global norm crosses max_gn (scales 0.2, 3, 0.5), a warmup schedule
    that starts from zero (the first update leaves the parameters)."""
    cfg = dict(cfg) if max_gn is None else dict(cfg, max_gn=max_gn)
    rng = np.random.RandomState(1)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    warmup = {"epoch": 0.5, "mode": "fix", "multiplier": 1, "start_from_zero": True}
    kw = dict(base_lr=0.1, warmup_config=warmup, steps_per_epoch=4, max_epoch=3)
    tx = j_create_optimizer(cfg, j_create_schedule(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt = create_optimizer(cfg, create_schedule(**kw), list(tp.values()))
    for n, scale in enumerate((0.2, 3.0, 0.5)):
        grads = {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = _t(grads[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"update {n} {k}")
            if n == 0:
                assert np.array_equal(tp[k].detach().numpy(), params[k])
    assert opt.param_groups[0]["count"] == 3


def test_optimizer_refuses_an_unknown_type_and_two_groups():
    p = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match="invalid"):
        create_optimizer({"type": "lion"}, lambda n: 0.1, [p])
    q = torch.nn.Parameter(torch.zeros(2))
    from rqvae_tpu_torch.optim.optimizer import Optimizer

    with pytest.raises(ValueError, match="one parameter group"):
        Optimizer([{"params": [p]}, {"params": [q]}], lambda n: 0.1)


def test_ema_update_matches_jax():
    rng = np.random.RandomState(2)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    ema = TE.init_ema(model)
    jema = {k: jnp.array(v.numpy()) for k, v in ema.items()}  # copies: the port updates in place
    for step in (0, 1, 5, 200000):
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(_t(rng.standard_normal(p.shape).astype(np.float32)))
        TE.ema_update(ema, model, step, mu=0.999)
        jema = JE.ema_update(jema, {k: jnp.array(p.detach().numpy()) for k, p in model.named_parameters()},
                             jnp.int32(step), 0.999)
        for k in ema:
            np.testing.assert_allclose(ema[k].numpy(), np.asarray(jema[k]), rtol=0, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="names"):
        TE.ema_update({"x": torch.zeros(1)}, model, 0)


def test_accumulators_match_jax():
    rng = np.random.RandomState(3)
    counts = rng.randint(0, 20, size=(3, 16)).astype(np.float64)
    counts[1] = 0
    np.testing.assert_allclose(TA.compute_entropy(counts), JA.compute_entropy(counts), rtol=1e-12)
    names = ["loss_total", "loss_img", "loss_txt"]
    got, want = TA.AccmStage2(names), JA.AccmStage2(names)
    for i in range(4):
        metrics = {"loss_total": torch.tensor(1.0 + i), "loss_img": np.float32(0.5 * i), "loss_txt": None}
        got.update(metrics, count=i + 1)
        want.update({k: None if v is None else np.asarray(v) for k, v in metrics.items()}, count=i + 1)
    assert got.get_summary() == want.get_summary() and got.get_summary(7) == want.get_summary(7)
    assert got.get_summary().print_line() == want.get_summary().print_line()
    assert got.get_summary().loss_img == want.get_summary().loss_img


# -- the frozen encode and soft codes ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stage1():
    """(JAX model, its variables, the port's RQVAE) of the committed
    synthetic stage-1 checkpoint, and seeded NHWC images [4, 64, 64, 3]."""
    with open(os.path.join(GOLDENS, "synth_ckpt", "stage1", "config.yaml")) as f:
        arch = yaml.safe_load(f)["arch"]
    sd = torch.load(os.path.join(GOLDENS, "synth_ckpt", "stage1", "model.pt"), map_location="cpu")["state_dict"]
    vqvae = RQVAE(RQVAEHParams.create(arch["hparams"]), DDConfig.create(arch["ddconfig"]), device="cpu")
    vqvae.load_state_dict(sd, strict=True)
    jmodel = JRQVAE(hparams=JHParams.create(arch["hparams"]), ddconfig=JDDConfig.create(arch["ddconfig"]))
    params, state = convert_rqvae(sd, jmodel.quantizer_config)
    variables = {"params": params, "codebook": {"state": state}}
    xs = np.random.RandomState(4).uniform(-1.0, 1.0, size=(4, 64, 64, 3)).astype(np.float32)
    return jmodel, variables, vqvae, xs


def _nchw(xs):
    return _t(xs).permute(0, 3, 1, 2).contiguous()


def test_frozen_encode_matches_jax(stage1):
    """fp32 (dtype=None) equals JAX's dtype=None encode; chunk=2 equals
    the whole batch; the bf16 copy tracks fp32 as JAX's does, and neither
    the model nor its fp32 codebooks change dtype."""
    jmodel, variables, vqvae, xs = stage1
    want = np.asarray(J2.make_frozen_encode_fn(jmodel, variables, dtype=None)(jnp.asarray(xs)))
    fn32 = T2.make_frozen_encode_fn(vqvae, dtype=None)
    z32 = fn32(_nchw(xs))
    assert z32.shape == (4, 8, 8, 16) and z32.dtype == torch.float32 and not z32.requires_grad
    np.testing.assert_allclose(z32.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(T2.make_frozen_encode_fn(vqvae, dtype=None, chunk=2)(_nchw(xs)).numpy(),
                               z32.numpy(), atol=1e-5, rtol=0)
    z16 = T2.make_frozen_encode_fn(vqvae, chunk=2)(_nchw(xs))
    assert z16.dtype == torch.bfloat16
    scale = float(z32.abs().mean())
    assert float((z16.float() - z32).abs().mean()) < 0.05 * scale + 1e-3
    assert vqvae.encoder.conv_in.weight.dtype == torch.float32
    assert all(vqvae.quantizer.codebook(d).dtype == torch.float32 for d in range(2))
    soft, codes = T2.make_soft_code_fn(vqvae.quantizer, T2.Stage2LossConfig())(z16, None)
    assert soft.dtype == torch.float32 and codes.shape == (4, 8, 8, 2)


def test_stochastic_soft_codes_follow_the_generator(stage1):
    """Seeded draws repeat, other seeds draw other codes, depth 0's soft
    targets do not depend on the draw (the later depths' residuals do),
    and as temp -> 0 the draw is the argmin."""
    _, _, vqvae, xs = stage1
    z = T2.make_frozen_encode_fn(vqvae, dtype=None)(_nchw(xs))
    fn = T2.make_soft_code_fn(vqvae.quantizer, T2.Stage2LossConfig(stochastic_codes=True, temp=3.0))
    soft_a, a = fn(z, torch.Generator().manual_seed(1))
    soft_b, b = fn(z, torch.Generator().manual_seed(1))
    soft_c, c = fn(z, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and torch.equal(soft_a, soft_b)
    assert not torch.equal(a, c) and torch.equal(soft_a[..., 0, :], soft_c[..., 0, :])
    assert int(a.min()) >= 0 and int(a.max()) < 64
    cold = T2.make_soft_code_fn(vqvae.quantizer, T2.Stage2LossConfig(stochastic_codes=True, temp=1e-6))
    _, greedy = T2.make_soft_code_fn(vqvae.quantizer, T2.Stage2LossConfig())(z, None)
    assert torch.equal(cold(z, torch.Generator().manual_seed(3))[1], greedy)
    with pytest.raises(ValueError, match="Generator"):
        fn(z, None)


# -- train and eval steps against JAX's ------------------------------------------------------------------------


def _stage2_arch():
    with open(os.path.join(GOLDENS, "synth_ckpt", "stage2", "config.yaml")) as f:
        arch = yaml.safe_load(f)["arch"]
    return {**arch, "body": {"n_layer": 2, "block": {"n_head": 4, "resid_pdrop": 0.0}},
            "head": {"n_layer": 2, "block": {"n_head": 4, "resid_pdrop": 0.0}}}


def _adam_state(opt_state):
    (adam,) = from_jax._optax_states(opt_state, ("count", "mu", "nu"))
    return adam


@pytest.fixture(scope="module")
def jax_run(stage1):
    """JAX's init and N_STEPS train steps (jitted once): the states after
    0..N_STEPS steps (numpy), each step's metrics and clipped gradients
    (recovered from adam's first moment), the eval metrics of the last
    EMA, and what the port needs to run the same steps."""
    jmodel, variables, vqvae, xs = stage1
    arch = _stage2_arch()
    jcfg = jax_config(arch)
    rng = np.random.RandomState(5)
    params = jax.device_get(JM.init_transformer_params(jax.random.PRNGKey(5), jcfg))
    params = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params)
    tx = j_create_optimizer(OPTIM, _schedule(j_create_schedule))
    state = J2.Stage2State(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                           ema_params=jax.tree.map(np.copy, params))
    loss_cfg = J2.Stage2LossConfig(**LOSS)
    kw = dict(encode_fn=J2.make_frozen_encode_fn(jmodel, variables, dtype=None),
              vq_state=variables["codebook"]["state"], vq_config=jmodel.quantizer_config)
    step = jax.jit(J2.make_train_step(jcfg, loss_cfg, tx, grad_accum_steps=2, **kw))
    cond = np.array([1, 7, 3, 7], np.int32)
    batch = {"images": jnp.asarray(xs), "cond": jnp.asarray(cond)}
    states, metrics, grads = [jax.device_get(state)], [], []
    for _ in range(N_STEPS):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        states.append(jax.device_get(state))
        metrics.append(jax.device_get(m))
        mu0, mu1 = _adam_state(states[-2].opt_state).mu, _adam_state(states[-1].opt_state).mu
        grads.append(jax.tree.map(lambda a, b: (b - ADAM_B1 * a) / (1.0 - ADAM_B1), mu0, mu1))
    ev = J2.make_eval_step(jcfg, loss_cfg, **kw)(states[-1].ema_params, batch, None)
    return dict(jcfg=jcfg, arch=arch, states=states, metrics=metrics, grads=grads, eval=jax.device_get(ev),
                batch={"images": _nchw(xs), "cond": _t(cond).long()})


def _port_state(jax_run, params_np):
    model = TM.RQTransformer(TransformerConfig.create(jax_run["arch"]), device="cpu")
    model.load_state_dict(to_torch(from_jax.rqtransformer_state_dict_from_jax(params_np, jax_run["jcfg"])))
    model.fuse_qkv()
    return T2.init_state(model, OPTIM, _schedule(create_schedule), use_ema=True)


def _tensors(jax_run, tree):
    sd = from_jax.rqtransformer_state_dict_from_jax(tree, jax_run["jcfg"])
    sd.pop("tok_emb.offsets", None)
    return sd


def _compare_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)


def _close_to_max(got: dict, want: dict, what) -> None:
    """Each tensor within 1e-4 of its max |want|, plus 1e-6 of the largest
    |want| of all: the key biases' gradients (and so their moments) are
    rounding noise on both sides (_compare_params)."""
    assert set(got) == set(want)
    floor = 1e-6 * max(np.abs(np.asarray(w)).max() for w in want.values())
    for k, w in want.items():
        w = np.asarray(w)
        assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max() + floor, (what, k)


def _compare_params(got: dict, want: dict, grads: list):
    """got {name: tensor} against want {name: array} where each step's JAX
    gradient (grads: one {name: array} per step) is above 1e-6 of its
    tensor's max, or 0, at every step (module docstring)."""
    for k, w in want.items():
        if k.endswith("attn.key.bias"):
            # its gradient is 0 in exact arithmetic (the softmax drops a shift
            # common to a query's scores), rounding noise on both sides: Adam
            # moves each entry by at most about the learning rate a step
            bound = 2 * sum(_schedule(create_schedule)(n) for n in range(len(grads))) + 1e-6
            assert np.abs(got[k].detach().numpy() - np.asarray(w)).max() <= bound, k
            continue
        g = [np.asarray(gr[k]) for gr in grads]
        above = np.all([np.abs(x) > 1e-6 * np.abs(x).max() for x in g], axis=0)
        zero = np.all([x == 0 for x in g], axis=0)
        keep = above | zero
        assert keep.mean() > 0.5, (k, keep.mean())
        np.testing.assert_allclose(got[k].detach().numpy()[keep], np.asarray(w)[keep], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.fixture(scope="module")
def port_run(stage1, jax_run):
    """The port's N_STEPS train steps from JAX's initial state: its state,
    each step's metrics and clipped gradients."""
    _, _, vqvae, _ = stage1
    state = _port_state(jax_run, jax_run["states"][0].params)
    step = T2.make_train_step(T2.Stage2LossConfig(**LOSS), encode_fn=T2.make_frozen_encode_fn(vqvae, dtype=None),
                              quantizer=vqvae.quantizer, grad_accum_steps=2)
    metrics, grads = [], []
    for _ in range(N_STEPS):
        state, m = step(state, jax_run["batch"], torch.Generator().manual_seed(0))
        metrics.append(m)
        grads.append({k: p.grad.clone() for k, p in state.model.named_parameters()})
    return state, metrics, grads, step


def test_train_steps_match_jax(jax_run, port_run):
    """Losses, grad_norm, gradients, parameters, EMA and step after each of
    three steps of accumulation, the clip, the schedule (lr 0 at the first
    step) and the EMA."""
    state, metrics, grads, _ = port_run
    assert state.step == N_STEPS == int(jax_run["states"][-1].step)
    assert state.optimizer.param_groups[0]["count"] == N_STEPS
    for n in range(N_STEPS):
        _compare_metrics(metrics[n], jax_run["metrics"][n])
        _close_to_max({k: g.numpy() for k, g in grads[n].items()}, _tensors(jax_run, jax_run["grads"][n]), n)
    assert any(float(m["grad_norm"]) > OPTIM["max_gn"] for m in metrics)  # the clip acted
    jgrads = [_tensors(jax_run, g) for g in jax_run["grads"]]
    _compare_params(dict(state.model.named_parameters()), _tensors(jax_run, jax_run["states"][-1].params), jgrads)
    _compare_params(state.ema, _tensors(jax_run, jax_run["states"][-1].ema_params), jgrads)
    init = _tensors(jax_run, jax_run["states"][0].params)
    moved = [k for k, p in state.model.named_parameters() if not np.array_equal(p.detach().numpy(), init[k])]
    assert len(moved) == len(init)


def test_eval_step_runs_the_ema_like_jax(stage1, jax_run, port_run):
    _, _, vqvae, _ = stage1
    state = port_run[0]
    ev = T2.make_eval_step(T2.Stage2LossConfig(**LOSS), encode_fn=T2.make_frozen_encode_fn(vqvae, dtype=None),
                           quantizer=vqvae.quantizer)
    got = ev(state, jax_run["batch"])
    _compare_metrics(got, jax_run["eval"])
    plain = ev(T2.Stage2State(model=state.model, optimizer=state.optimizer), jax_run["batch"])
    assert float(plain["loss_total"]) != float(got["loss_total"])


def test_carried_state_resumes_like_jax(jax_run, port_run):
    """JAX's state after two steps, carried into the port
    (stage2_state_from_jax), takes the third step as JAX's did."""
    step = port_run[3]
    state = from_jax.stage2_state_from_jax(jax_run["states"][2], TransformerConfig.create(jax_run["arch"]), OPTIM,
                                           _schedule(create_schedule), device="cpu")
    assert state.step == 2 and state.optimizer.param_groups[0]["count"] == 2
    state, m = step(state, jax_run["batch"], torch.Generator().manual_seed(0))
    _compare_metrics(m, jax_run["metrics"][2])
    jgrads = [_tensors(jax_run, g) for g in jax_run["grads"]]
    _compare_params(dict(state.model.named_parameters()), _tensors(jax_run, jax_run["states"][3].params), jgrads)
    _compare_params(state.ema, _tensors(jax_run, jax_run["states"][3].ema_params), jgrads)
    adam = _adam_state(jax_run["states"][3].opt_state)
    for name, moment in (("mu", adam.mu), ("nu", adam.nu)):
        got = {k: state.optimizer.state[p][name].numpy() for k, p in state.model.named_parameters()}
        _close_to_max(got, _tensors(jax_run, moment), name)


def test_sample_after_training_reads_the_new_weights(stage1, port_run):
    """The trained model samples (greedy, top-k 1) the codes that a fresh
    model loaded from its state_dict samples: the step rebuilt the fused
    QKV buffers and dropped the int8 ones (quantized before the step)."""
    _, _, vqvae, _ = stage1
    state, _, _, step = port_run
    model = state.model
    model.quantize_int8()
    step(state, {"codes": torch.zeros(2, 8, 8, 2, dtype=torch.long), "soft_targets": torch.full((2, 8, 8, 2, 64), 1 / 64),
                 "cond": torch.tensor([2, 5])}, torch.Generator().manual_seed(0))
    assert not model.body_transformer.blocks[0].int8 and model.classifier.weight_q is None
    fresh = TM.RQTransformer(model.config, device="cpu")
    fresh.load_state_dict(copy.deepcopy(model.state_dict()))
    fresh.fuse_qkv()
    for blk, ref in zip(model.body_transformer.blocks, fresh.body_transformer.blocks):
        assert torch.equal(blk.wqkv, ref.wqkv)
    cond = torch.tensor([0, 3, 9])
    got = TS.sample(model, 3, torch.Generator().manual_seed(4), cond=cond, quantizer=vqvae.quantizer, top_k=1)
    want = TS.sample(fresh, 3, torch.Generator().manual_seed(4), cond=cond, quantizer=vqvae.quantizer, top_k=1)
    assert torch.equal(got, want)


def test_text_conditional_losses_match_jax():
    """A 2-token condition (TOKEMB_ARCH, hard targets, no dropout): one
    train step's losses and grad_norm, loss_total = 0.9 loss_img + 0.1
    loss_txt, as JAX's step."""
    arch = {**TOKEMB_ARCH, "body": {"n_layer": 2, "block": {"n_head": 2, "resid_pdrop": 0.0}},
            "head": {"n_layer": 2, "block": {"n_head": 2, "resid_pdrop": 0.0}}}
    params, jcfg, _, _, model, _ = build_pair(arch, seed=3)
    rng = np.random.RandomState(6)
    codes = np.stack([rng.randint(0, v, size=(4, 4, 4)) for v in jcfg.vocab_size], axis=-1).astype(np.int32)
    cond = rng.randint(0, 10, size=(4, 2)).astype(np.int32)
    optim = {"type": "adamW", "betas": [0.9, 0.95]}
    kw = dict(base_lr=5e-4, warmup_config={"epoch": 0}, steps_per_epoch=10, max_epoch=10)
    tx = j_create_optimizer(optim, j_create_schedule(**kw))
    jstate = J2.Stage2State(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params))
    cfg = dict(use_soft_target=False, amp_bf16=False)
    jstep = jax.jit(J2.make_train_step(jcfg, J2.Stage2LossConfig(**cfg), tx, grad_accum_steps=2))
    _, want = jstep(jstate, {"codes": jnp.asarray(codes), "cond": jnp.asarray(cond)}, jax.random.PRNGKey(0))
    state = T2.init_state(model, optim, create_schedule(**kw))
    step = T2.make_train_step(T2.Stage2LossConfig(**cfg), grad_accum_steps=2)
    _, got = step(state, {"codes": _t(codes).long(), "cond": _t(cond).long()}, None)
    _compare_metrics(got, jax.device_get(want))
    np.testing.assert_allclose(float(got["loss_total"]),
                               0.9 * float(got["loss_img"]) + 0.1 * float(got["loss_txt"]), rtol=1e-6)


def test_train_step_refusals(jax_run):
    state = _port_state(jax_run, jax_run["states"][0].params)
    codes = torch.zeros(3, 8, 8, 2, dtype=torch.long)
    step = T2.make_train_step(T2.Stage2LossConfig(amp_bf16=False), grad_accum_steps=2)
    with pytest.raises(ValueError, match="microbatches"):
        step(state, {"codes": codes}, None)
    with pytest.raises(ValueError, match="soft targets"):
        T2.make_train_step(T2.Stage2LossConfig(amp_bf16=False))(state, {"codes": codes}, None)
    with pytest.raises(ValueError, match="encode_fn"):
        T2.make_train_step(T2.Stage2LossConfig())(state, {"images": torch.zeros(2, 3, 64, 64)}, None)
