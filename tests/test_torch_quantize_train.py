"""The port's training half of residual quantization and of the RQ-VAE
against the JAX package on the CPU: quantize_train (the EMA codebook
update, code restarts) with shared and unshared codebooks, restart on and
off, ema off; the restart draw; rq_bottleneck_forward and
RQVAE.forward / forward_pre with training=True; the decoder tail; remat
and dropout; the EMA over parameters and codebook buffers; AccmStage1.

JAX's restart draws are handed to the port: quantize_train runs under
jax.disable_jit with jax.random.uniform / permutation wrapped, so the
noise and the permutation each depth drew are recorded, and the port's
restart_candidates builds its candidates from them. The model is
tests/test_trainers.py's tiny DD / HP (32x32 pixels, ch 16, 4x4x2 codes
of 16 dims, 64 shared codes) with JAX's init plus seeded noise.

Tolerances: codes equal; codebooks, counts and EMA sums 1e-5 (fp32 sums
in another order: JAX's one-hot product against index_add_); the
reconstruction 1e-4 as for the inference forward; losses 1e-5.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.models.rqvae.model import RQVAE as JRQVAE
from rqvae_tpu.models.rqvae.model import RQVAEHParams as JHParams
from rqvae_tpu.models.rqvae.modules import DDConfig as JDDConfig
from rqvae_tpu.models.rqvae.modules import Decoder as JDecoder
from rqvae_tpu.models.rqvae.modules import decoder_tail as j_decoder_tail
from rqvae_tpu.ops import quantize as jrq
from rqvae_tpu.trainers import accumulator as JA
from rqvae_tpu_torch.checkpoint import from_jax
from rqvae_tpu_torch.models import ema as TE
from rqvae_tpu_torch.models.rqvae.model import RQVAE, RQVAEHParams
from rqvae_tpu_torch.models.rqvae.modules import DDConfig, set_checkpointing
from rqvae_tpu_torch.ops import quantize as tq
from rqvae_tpu_torch.trainers import accumulator as TA
from test_torch_rqtransformer import to_torch
from test_trainers import DD, HP


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


@contextlib.contextmanager
def recorded_draws():
    """Run JAX eagerly with jax.random.uniform and permutation recording
    what they return: yields the list of ("uniform" | "perm", array)."""
    calls = []
    uniform, permutation = jax.random.uniform, jax.random.permutation

    def rec_uniform(*a, **k):
        out = uniform(*a, **k)
        calls.append(("uniform", np.asarray(out)))
        return out

    def rec_permutation(*a, **k):
        out = permutation(*a, **k)
        calls.append(("perm", np.asarray(out)))
        return out

    with mock.patch.object(jax.random, "uniform", rec_uniform), \
            mock.patch.object(jax.random, "permutation", rec_permutation), jax.disable_jit():
        yield calls


def jax_draw(calls):
    """The port's draw(depth, vectors, n_embed) replaying JAX's recorded
    draws in order: a depth with fewer vectors than codes took a uniform
    then a permutation, else a permutation."""
    queue = list(calls)

    def draw(d, vectors, n_embed):
        uniform = None
        if vectors.shape[0] < n_embed:
            kind, uniform = queue.pop(0)
            assert kind == "uniform"
            uniform = _t(uniform)
        kind, perm = queue.pop(0)
        assert kind == "perm"
        return tq.restart_candidates(vectors, n_embed, _t(perm).long(), uniform)

    draw.queue = queue
    return draw


def jax_quantize_train(x, state, qcfg, key, use_kernel=False):
    """JAX's quantize_train, eagerly, and the draws it made."""
    with recorded_draws() as calls:
        quants, codes, new_state = jrq.quantize_train(jnp.asarray(x), state, qcfg, key, use_kernel=use_kernel)
    return np.asarray(quants), np.asarray(codes), new_state, calls


def _quantizer_pair(shared, restart, ema=True, n_embed=(48, 40), depth=2, seed=0):
    """A JAX codebook state and the port's RQCodebooks holding it: 16-dim
    codes, n_embed per depth (one size when shared), N(0, 1) codes, EMA
    statistics from a short history."""
    n_embed = [n_embed[0]] * depth if shared else list(n_embed)[:depth]
    qcfg = jrq.QuantizerConfig.create(latent_shape=(4, 4, 16), code_shape=(4, 4, depth), n_embed=n_embed,
                                      decay=[0.9, 0.8][:depth] if not shared else 0.9, shared_codebook=shared,
                                      restart_unused_codes=restart, ema=ema)
    rng = np.random.RandomState(seed)
    state = jrq.init_codebook_state(jax.random.PRNGKey(seed), qcfg)
    cluster = rng.uniform(0.0, 3.0, size=state.cluster_size.shape).astype(np.float32)
    state = jrq.CodebookState(embed=state.embed, cluster_size=jnp.asarray(cluster),
                              embed_ema=state.embed * cluster[..., None])
    tcfg = tq.QuantizerConfig.create(latent_shape=(4, 4, 16), code_shape=(4, 4, depth), n_embed=n_embed,
                                     decay=list(qcfg.decay), shared_codebook=shared, restart_unused_codes=restart,
                                     ema=ema)
    quantizer = tq.RQCodebooks(tcfg, device="cpu")
    for d in range(depth):
        b, n = qcfg.codebook_index(d), n_embed[d]
        book = quantizer.codebooks[d]
        book.weight[:n] = _t(state.embed[b][:n])
        book.cluster_size_ema.copy_(_t(state.cluster_size[b][:n]))
        book.embed_ema.copy_(_t(state.embed_ema[b][:n]))
    return qcfg, state, quantizer


def _compare_books(quantizer, state, qcfg, atol=1e-5):
    for d in range(qcfg.depth):
        b, n = qcfg.codebook_index(d), qcfg.n_embed[d]
        book = quantizer.codebooks[d]
        embed, cluster, ema = (np.asarray(a)[b][:n] for a in (state.embed, state.cluster_size, state.embed_ema))
        np.testing.assert_allclose(book.weight[:n].numpy(), embed, atol=atol, rtol=1e-5, err_msg=d)
        assert float(book.weight[n].abs().max()) == 0.0  # the padding row
        np.testing.assert_allclose(book.cluster_size_ema.numpy(), cluster, atol=atol, rtol=1e-5)
        np.testing.assert_allclose(book.embed_ema.numpy(), ema, atol=atol, rtol=1e-5)


CASES = [  # (shared codebook, restart, ema, vectors: 2 x 4 x 4 = 32 rows, or 5 x 4 x 4 = 80)
    (True, True, True, 2),
    (True, True, True, 5),
    (False, True, True, 2),
    (True, False, True, 2),
    (False, False, True, 5),
    (False, True, False, 2),
]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("shared,restart,ema,batch", CASES)
def test_quantize_train_matches_jax(shared, restart, ema, batch, use_kernel):
    """Two successive calls (the second reads the first's update): codes,
    the cumulative quants and every codebook buffer after each. 32 rows
    against 48 / 40 codes tile the pool with noise; 80 rows do not."""
    qcfg, state, quantizer = _quantizer_pair(shared, restart, ema)
    rng = np.random.RandomState(batch)
    for call in range(2):
        x = rng.standard_normal((batch, 4, 4, 16)).astype(np.float32)
        key = jax.random.PRNGKey(10 + call)
        want_q, want_c, new_state, calls = jax_quantize_train(x, state, qcfg, key, use_kernel)
        state = jax.tree.map(jnp.asarray, new_state)
        assert len(calls) == (qcfg.depth * (1 + (batch * 16 < min(qcfg.n_embed))) if restart and ema else 0)
        draw = jax_draw(calls)
        got_q, got_c = tq.quantize_train(_t(x), quantizer, use_kernel=use_kernel, draw=draw)
        assert not draw.queue
        assert got_c.dtype == torch.long and got_c.shape == (batch, 4, 4, qcfg.depth)
        np.testing.assert_array_equal(got_c.numpy(), want_c)
        np.testing.assert_allclose(got_q.numpy(), want_q, atol=1e-5, rtol=0)
        _compare_books(quantizer, state, qcfg)


def test_quantize_train_refuses_a_restart_without_randomness():
    _, _, quantizer = _quantizer_pair(True, True)
    with pytest.raises(ValueError, match="Generator"):
        tq.quantize_train(torch.zeros(1, 4, 4, 16), quantizer)


def test_draw_restart_tiles_with_bounded_noise_and_permutes():
    """Fewer vectors than codes: ceil(n / N) tiles, each row a vector plus
    uniform noise in [0, 0.01 / sqrt(dim)), rows in a permuted order, and
    the same seed draws the same rows; more vectors: a permutation's first
    n_embed rows, exactly."""
    dim = 16
    vectors = torch.randn(10, dim, generator=torch.Generator().manual_seed(0))
    got = tq.draw_restart(vectors, 25, torch.Generator().manual_seed(1))
    assert got.shape == (25, dim)
    std = 0.01 / np.sqrt(dim)
    noise = got[:, None, :] - vectors[None]  # [25, 10, dim]
    src = ((noise >= 0) & (noise < std)).all(dim=-1)
    assert bool(src.any(dim=1).all()) and bool((src.sum(dim=1) == 1).all())
    assert float(noise[src].max()) < std and float(noise[src].min()) >= 0.0
    assert len({tuple(r.tolist()) for r in got}) == 25  # no tile row twice
    assert torch.equal(got, tq.draw_restart(vectors, 25, torch.Generator().manual_seed(1)))
    assert not torch.equal(got, tq.draw_restart(vectors, 25, torch.Generator().manual_seed(2)))
    many = torch.randn(40, dim, generator=torch.Generator().manual_seed(3))
    picked = tq.draw_restart(many, 25, torch.Generator().manual_seed(4))
    rows = (picked[:, None, :] == many[None]).all(dim=-1)
    assert bool((rows.sum(dim=1) == 1).all()) and bool((rows.sum(dim=0) <= 1).all())
    perm = torch.randperm(30, generator=torch.Generator().manual_seed(5))
    with pytest.raises(ValueError, match="noise"):
        tq.restart_candidates(vectors, 25, perm)


# -- the RQ-VAE's training forward ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """(JAX RQVAE (use_kernel False), its variables with noise, the port's
    RQVAE on them, seeded images [2, 32, 32, 3])."""
    jmodel = JRQVAE(hparams=JHParams.create(HP), ddconfig=JDDConfig.create(DD), use_kernel=False)
    variables = jax.device_get(jmodel.init({"params": jax.random.PRNGKey(0), "quantizer": jax.random.PRNGKey(1)},
                                           jnp.zeros((1, 32, 32, 3))))
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                          variables["params"])
    variables = {"params": params, "codebook": jax.tree.map(jnp.asarray, variables["codebook"])}
    xs = np.random.RandomState(1).uniform(-1.0, 1.0, size=(2, 32, 32, 3)).astype(np.float32)
    return jmodel, variables, xs


def _port(jmodel, variables, **kw):
    model = RQVAE(RQVAEHParams.create(HP), DDConfig.create(DD), device="cpu", use_kernel=False, **kw)
    sd = from_jax.rqvae_state_dict_from_jax(variables["params"], variables["codebook"]["state"],
                                            jmodel.quantizer_config)
    model.load_state_dict(to_torch(sd), strict=True)
    return model


@pytest.mark.parametrize("pre_end", [False, True])
def test_training_forward_matches_jax(pair, pre_end):
    """forward(training=True) / forward_pre against JAX's apply with
    mutable codebook: outputs, loss, codes, the updated codebook; the
    commitment loss and the straight-through z_q carry gradients to the
    encoder."""
    jmodel, variables, xs = pair
    model = _port(jmodel, variables)
    calls = []

    def run(key):
        with recorded_draws() as rec:
            out = jmodel.apply(variables, jnp.asarray(xs), training=True, rngs={"quantizer": key},
                               mutable=["codebook"], method=JRQVAE.forward_pre if pre_end else JRQVAE.__call__)
        calls.extend(rec)
        return out

    (want_out, want_loss, want_codes), mutated = run(jax.random.PRNGKey(3))
    fn = model.forward_pre if pre_end else model
    out, loss, codes = fn(_t(xs), training=True, draw=jax_draw(calls))
    if pre_end:
        out = out.permute(0, 2, 3, 1)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-5, rtol=1e-5)
    _compare_books(model.quantizer, jax.device_get(mutated["codebook"]["state"]), jmodel.quantizer_config)
    (loss + out.square().mean()).backward()
    assert float(model.encoder.conv_in.weight.grad.abs().max()) > 0
    assert all(b.grad is None for b in model.buffers())


def test_training_forward_follows_the_generator(pair):
    """With a generator, the same seed gives the same restarts; the
    inference forward leaves the codebooks untouched."""
    jmodel, variables, xs = pair
    a, b, c = (_port(jmodel, variables) for _ in range(3))
    before = {k: v.clone() for k, v in a.state_dict().items()}
    with torch.no_grad():
        a(_t(xs))
        assert all(torch.equal(v, before[k]) for k, v in a.state_dict().items())
        for m, seed in ((a, 5), (b, 5), (c, 6)):
            m(_t(xs), training=True, generator=torch.Generator().manual_seed(seed))
    weight = "quantizer.codebooks.0.weight"
    assert torch.equal(a.state_dict()[weight], b.state_dict()[weight])
    assert not torch.equal(a.state_dict()[weight], c.state_dict()[weight])
    assert not torch.equal(a.state_dict()[weight], before[weight])


def test_decoder_tail_equals_the_full_decode(pair):
    """Decoder(give_pre_end) then decoder_tail against the full decoder, in
    the port and against JAX's decoder_tail."""
    jmodel, variables, _ = pair
    model = _port(jmodel, variables)
    z = np.random.RandomState(2).standard_normal((2, 4, 4, 16)).astype(np.float32)
    with torch.no_grad():
        full = model.decoder(_t(z).permute(0, 3, 1, 2))
        pre = model.decoder(_t(z).permute(0, 3, 1, 2), give_pre_end=True)
        tail = model.decoder.tail(pre)
    np.testing.assert_allclose(tail.numpy(), full.numpy(), atol=1e-5, rtol=1e-5)
    dec = JDecoder(JDDConfig.create(DD))
    jdec = {"params": variables["params"]["decoder"]}
    jpre = dec.apply(jdec, jnp.asarray(z), True, True)
    np.testing.assert_allclose(pre.permute(0, 2, 3, 1).numpy(), np.asarray(jpre), atol=1e-4, rtol=0)
    want = j_decoder_tail(jdec["params"], jpre, 3)
    np.testing.assert_allclose(tail.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _grads(model, xs, gen_seed=None):
    model.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(gen_seed) if gen_seed is not None else None
    out, loss, _ = model(_t(xs), training=True, generator=gen or torch.Generator().manual_seed(0))
    (out.square().mean() + loss).backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}, out.detach()


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_equals_plain(pair, dropout):
    """set_checkpointing(True) recomputes each ResnetBlock and gives the plain
    step's output and gradients, with dropout too (the mask is drawn once,
    before the block)."""
    jmodel, variables, xs = pair
    dd = dict(DD, dropout=dropout)
    models = []
    for remat in (False, True):
        m = RQVAE(RQVAEHParams.create(HP), DDConfig.create(dd), device="cpu", use_kernel=False)
        m.load_state_dict(_port(jmodel, variables).state_dict())
        set_checkpointing(m, remat)
        models.append(m)
    (g0, o0), (g1, o1) = (_grads(m, xs, 7) for m in models)
    assert torch.equal(o0, o1)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    assert all(b.checkpointing for b in models[1].modules() if hasattr(b, "checkpointing"))


def test_dropout_draws_from_the_generator(pair):
    """Dropout 0.5 in training: seeded masks repeat, other seeds differ,
    about half the entries are dropped, and without training (or without a
    generator) the forward is the inference one."""
    jmodel, variables, xs = pair
    model = RQVAE(RQVAEHParams.create(HP), DDConfig.create(dict(DD, dropout=0.5)), device="cpu", use_kernel=False)
    model.load_state_dict(_port(jmodel, variables).state_dict())
    block = model.decoder.up[0].block[0]
    seen = []
    block.conv2.register_forward_hook(lambda mod, inp, out: seen.append(inp[0].detach().clone()))
    with torch.no_grad():
        state = {k: v.clone() for k, v in model.state_dict().items()}
        outs = []
        for seed in (1, 1, 2):
            model.load_state_dict(state)
            outs.append(model(_t(xs), training=True, generator=torch.Generator().manual_seed(seed))[0])
        model.load_state_dict(state)
        plain = model(_t(xs))[0]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert not torch.equal(outs[0], plain)
    dropped = float((seen[0] == 0).float().mean())
    assert 0.4 < dropped < 0.6, dropped
    assert float((seen[-1] == 0).float().mean()) < 0.05


def test_ema_averages_parameters_and_codebook_buffers(pair):
    """init_ema(buffers=True) holds the codebook buffers once (the shared
    codebook under depth 0's names) and averages them like the parameters."""
    jmodel, variables, xs = pair
    model = _port(jmodel, variables)
    ema = TE.init_ema(model, buffers=True)
    names = [k for k in ema if k.startswith("quantizer.")]
    assert names == ["quantizer.codebooks.0.weight", "quantizer.codebooks.0.cluster_size_ema",
                     "quantizer.codebooks.0.embed_ema"]
    old = {k: v.clone() for k, v in ema.items()}
    with torch.no_grad():
        model(_t(xs), training=True, generator=torch.Generator().manual_seed(0))
        model.encoder.conv_in.weight.add_(1.0)
    TE.ema_update(ema, model, 3, mu=0.999)
    decay = min(0.999, 4.0 / 13.0)
    for k, v in dict(model.named_parameters(), **dict(model.named_buffers())).items():
        if k in ema:
            np.testing.assert_allclose(ema[k].numpy(), (decay * old[k] + (1 - decay) * v.detach()).numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert not torch.equal(ema[names[0]], old[names[0]])
    with pytest.raises(ValueError, match="names"):
        TE.ema_update({"quantizer.codebooks.0.weight": ema[names[0]]}, model, 0)


def test_accumulator_stage1_matches_jax():
    rng = np.random.RandomState(3)
    names = ["loss_total", "loss_recon", "g_weight"]
    for pad in (False, True):
        got = TA.AccmStage1(names, n_codebook=2, codebook_size=16, use_padding_idx=pad)
        want = JA.AccmStage1(names, n_codebook=2, codebook_size=16, use_padding_idx=pad)
        for i in range(3):
            codes = rng.randint(0, 17 if pad else 16, size=(2, 4, 4, 2))
            metrics = {"loss_total": torch.tensor(1.0 + i), "loss_recon": np.float32(0.5 * i), "g_weight": None}
            got.update([torch.from_numpy(codes)], metrics, count=2)
            want.update([codes], {k: None if v is None else np.asarray(v) for k, v in metrics.items()}, count=2)
        g, w = got.get_summary(), want.get_summary()
        assert g.metrics == w.metrics and g.print_line() == w.print_line()
        np.testing.assert_array_equal(got.codebooks[0], want.codebooks[0])
        for key in ("ent_codes_w_pad", "ent_codes_wo_pad"):
            if w[key] is None:
                assert g[key] is None
            else:
                np.testing.assert_allclose(g[key][0], w[key][0], rtol=1e-12)
