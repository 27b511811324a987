"""Data-parallel training of the port on the CPU: two gloo ranks, each a
subprocess running this file as a worker, against one process on the
global batch in the test's own process.

  - stage 1: two steps at tests/test_trainers.py's tiny DD / HP (32x32
    pixels, 4x4x2 codes over 64 shared codes, restart on) with
    NLayerDiscriminator(ndf=16, n_layers=2) active and the perceptual
    weight 0 (LPIPS is per-image and reads no batch statistic), global
    batch 2 (one image a rank: 32 vectors a depth tile the restart pool
    with noise); rank 0's restart draws on a generator seeded as the
    single process's;
  - stage 2: one step of a 2 + 2-layer RQ-Transformer on codes, global
    batch 8 in 2 microbatches (4 a rank, 2 a microbatch); the single
    process's microbatch i is both ranks' microbatch i;
  - main_stage1 on a seeded 8-image folder, each rank a process with
    torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT) calling main(argv) with --device cpu: 2 steps of a global
    batch of 4, then eval and the checkpoint;
  - the EMA codebook update against JAX: rqvae_tpu.ops.quantize's
    _ema_update_one with axis_name under shard_map over 2 of the suite's
    virtual CPU devices, and the port's ema_update on 2 ranks, from the
    same vectors, codes and state, with JAX's shard-0 candidates passed to
    the port explicitly.

Bounds: codes, EMA counts and cluster sizes exact (integer sums); the
ranks' weights, buffers and candidates bit-equal to each other (one
all-reduce result on every rank); against the single process (fp32 sums
in another order; the encoder's convs also sum in another order on a
batch of 1 than of 2): gradients within 1e-5 of their tensor's max (+
1e-6 of the largest: a GroupNorm'd conv bias, whose gradient is 0 in
exact arithmetic, holds rounding noise), metrics and g_weight 1e-5 relative (+ 1e-6), EMA
sums, codebooks, candidates and BatchNorm statistics within 1e-5 of their
tensor's max;
post-Adam weights within 5e-6 (+ 1e-5 relative) where every step's
gradient is above 1e-2 of its tensor's max (or 0), and within two
learning rates a step elsewhere and in a tensor whose gradient is
rounding noise (below 1e-5 of the largest tensor's): Adam turns such a
gradient into a step of a learning rate either way
(tests/test_torch_trainer_stage1.py).
Against JAX: cluster sizes 1e-5 relative, EMA sums and codebooks 1e-4
relative (+ 1e-5), JAX's own test_parallel.py bounds.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
WORLD = 2

DD = dict(double_z=False, z_channels=16, resolution=32, in_channels=3, out_ch=3, ch=16, ch_mult=[1, 2, 2, 2],
          num_res_blocks=1, attn_resolutions=[4], dropout=0.0)  # tests/test_trainers.py
HP = dict(embed_dim=16, n_embed=64, loss_type="mse", latent_shape=[4, 4, 16], code_shape=[4, 4, 2],
          shared_codebook=True, restart_unused_codes=True)
DISC = dict(ndf=16, n_layers=2)
OPTIM1 = {"type": "adam", "betas": [0.5, 0.9], "weight_decay": 0.0}
S1_BATCH, S1_STEPS, DRAW_SEED = 2, 2, 7
S2_ARCH = dict(type="rq-transformer", vocab_size=64, block_size=[4, 4, 2], embed_dim=64, input_embed_dim=16,
               shared_tok_emb=True, shared_cls_emb=True, input_emb_vqvae=False, head_emb_vqvae=False,
               cumsum_depth_ctx=True, vocab_size_cond=10, block_size_cond=1,
               body={"n_layer": 2, "block": {"n_head": 4, "resid_pdrop": 0.0}},
               head={"n_layer": 2, "block": {"n_head": 4, "resid_pdrop": 0.0}})
OPTIM2 = {"type": "adamW", "betas": [0.9, 0.95], "weight_decay": 1e-4, "max_gn": 1.0}
S2_BATCH, S2_ACCUM = 8, 2
EMA_N, EMA_DIM, EMA_CODES, EMA_DECAY = 24, 8, 32, 0.99  # vectors a rank: fewer than the codes, so the pool is tiled

GRAD_TOL, METRIC_RTOL, SUM_TOL = 1e-5, 1e-5, 1e-5


# -- the models, built alike in every process ------------------------------------------------------------------------


def _schedule():
    from rqvae_tpu_torch.optim.schedule import create_schedule

    return create_schedule(base_lr=1e-3, warmup_config={"epoch": 0, "min_lr": 1e-4}, steps_per_epoch=10, max_epoch=1)


def build_stage1():
    from rqvae_tpu_torch.losses.discriminator import NLayerDiscriminator
    from rqvae_tpu_torch.models.rqvae.model import RQVAE, RQVAEHParams
    from rqvae_tpu_torch.models.rqvae.modules import DDConfig
    from rqvae_tpu_torch.trainers import trainer_stage1 as T1

    gen = torch.Generator().manual_seed(0)
    model = RQVAE(RQVAEHParams.create(HP), DDConfig.create(DD), device="cpu", use_kernel=False)
    model.init_weights(gen)
    disc = NLayerDiscriminator(**DISC, device="cpu")
    disc.init_weights(gen)
    return T1.init_state(model, disc, OPTIM1, _schedule(), OPTIM1, _schedule(), use_ema=True)


def stage1_images() -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (S1_STEPS, S1_BATCH, 32, 32, 3)).astype(np.float32))


def build_stage2():
    from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
    from rqvae_tpu_torch.models.rqtransformer.model import RQTransformer
    from rqvae_tpu_torch.trainers import trainer_stage2 as T2
    from rqvae_tpu_torch.utils.config import Config, augment_arch_defaults

    model = RQTransformer(TransformerConfig.create(augment_arch_defaults(Config(S2_ARCH)).to_dict()), device="cpu")
    model.init_weights(torch.Generator().manual_seed(3))
    return T2.init_state(model, OPTIM2, _schedule())


def stage2_batch() -> dict:
    rng = np.random.RandomState(2)
    return {"codes": torch.from_numpy(rng.randint(0, 64, (S2_BATCH, 4, 4, 2))),
            "cond": torch.from_numpy(rng.randint(0, 10, (S2_BATCH,)))}


def rank_share(batch: dict, rank: int, world: int, accum: int = 1) -> dict:
    """Rank `rank`'s share of a global batch in which microbatch i is every
    rank's microbatch i in rank order."""
    n = next(iter(batch.values())).shape[0]
    m = n // accum // world
    idx = [i * world * m + rank * m + j for i in range(accum) for j in range(m)]
    return {k: v[idx] for k, v in batch.items()}


def record_candidates():
    """(patch, calls): ops.quantize.ema_update recording the candidates of
    each call."""
    from rqvae_tpu_torch.ops import quantize as Q

    calls, orig = [], Q.ema_update

    def ema_update(book, vectors, idxs, n_embed, decay, eps, candidates, dist=None):
        calls.append(None if candidates is None else candidates.clone())
        return orig(book, vectors, idxs, n_embed, decay, eps, candidates, dist)

    return mock.patch.object(Q, "ema_update", ema_update), calls


def run_stage1(env=None, rank: int = 0, world: int = 1) -> dict:
    """S1_STEPS steps of this rank's share (everything with world 1): the
    metrics, codes, candidates, gradients of both optimizers, and the
    state after the steps."""
    from rqvae_tpu_torch.trainers import trainer_stage1 as T1

    state = build_stage1()
    step = T1.make_train_step(None, T1.GanLossConfig(perceptual_weight=0.0, lpips_bf16=False), use_discriminator=True,
                              dist=env)
    gen = torch.Generator().manual_seed(DRAW_SEED)
    out = dict(metrics=[], codes=[], grads=[], disc_grads=[])
    patch, calls = record_candidates()
    with patch:
        for images in stage1_images():
            batch = rank_share({"images": images}, rank, world)
            state, m, c = step(state, batch, gen)
            out["metrics"].append(m)
            out["codes"].append(c)
            out["grads"].append({k: p.grad.clone() for k, p in state.model.named_parameters()})
            out["disc_grads"].append({k: p.grad.clone() for k, p in state.disc.named_parameters()})
    out.update(candidates=calls, model=state.model.state_dict(), disc=state.disc.state_dict(),
               ema={k: v.clone() for k, v in state.ema.items()}, lrs=[_schedule()(n) for n in range(S1_STEPS)])
    return out


def run_stage2(env=None, rank: int = 0, world: int = 1) -> dict:
    from rqvae_tpu_torch.trainers import trainer_stage2 as T2

    state = build_stage2()
    step = T2.make_train_step(T2.Stage2LossConfig(use_soft_target=False, amp_bf16=False), grad_accum_steps=S2_ACCUM,
                              dist=env)
    state, m = step(state, rank_share(stage2_batch(), rank, world, S2_ACCUM), torch.Generator().manual_seed(5))
    return dict(metrics=m, grads={k: p.grad.clone() for k, p in state.model.named_parameters()},
                params={k: p.detach().clone() for k, p in state.model.named_parameters()})


def run_ema(env, rank: int, inputs: dict) -> dict:
    """The port's ema_update of this rank's half of the vectors and codes,
    with the given candidates."""
    from rqvae_tpu_torch.ops import quantize as Q

    book = Q.VQEmbedding(EMA_CODES, EMA_DIM, device="cpu")
    book.weight[:EMA_CODES] = inputs["embed"]
    book.cluster_size_ema.copy_(inputs["cluster"])
    book.embed_ema.copy_(inputs["embed_ema"])
    rows = slice(rank * EMA_N, (rank + 1) * EMA_N)
    Q.ema_update(book, inputs["vectors"][rows], inputs["codes"][rows], EMA_CODES, EMA_DECAY, 1e-5,
                 inputs["candidates"], env)
    return {k: v.clone() for k, v in book.state_dict().items()}


# -- the workers --------------------------------------------------------------------------------------------------------


def worker(mode: str, rank: int, world: int, port: int, out_dir: str) -> None:
    from rqvae_tpu_torch.parallel import dist as D

    torch.set_num_threads(1)
    if mode == "cli":
        sys.modules["torch.utils.tensorboard"] = None  # the scalars.jsonl writer: tensorboard may import TensorFlow
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port), SMOKE_TEST="1")
        result = run_cli_rank(out_dir)
    else:
        env = D.initialize(backend="gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                           device="cpu")
        assert (env.world_size, env.world_rank, env.master, env.TOTAL_GPU) == (world, rank, rank == 0, world)
        inputs = torch.load(os.path.join(out_dir, "ema_inputs.pt"))
        result = dict(stage1=run_stage1(env, rank, world), stage2=run_stage2(env, rank, world),
                      ema=run_ema(env, rank, inputs))
        D.shutdown(env)
    torch.save(result, os.path.join(out_dir, f"{mode}_{rank}.pt"))


def run_cli_rank(out_dir: str) -> dict:
    """main_stage1 on this rank, recording where it calls torch.save and
    its loader's shards."""
    from rqvae_tpu_torch.cli import main_stage1
    from rqvae_tpu_torch.trainers import loops

    saved, orig = [], torch.save

    def save(obj, path, *a, **k):
        saved.append(os.path.relpath(str(path), out_dir))
        return orig(obj, path, *a, **k)

    with mock.patch.object(torch, "save", save):
        trainer = main_stage1.main(["-m", os.path.join(out_dir, "stage1.yaml"), "-r", os.path.join(out_dir, "results"),
                                    "--device", "cpu", "--seed", "3"])
    shards = []
    for epoch in range(trainer.config.experiment.epochs):
        trainer.loader_trn.set_epoch(epoch)
        shards.append(trainer.loader_trn.sampler.indices().tolist())
    assert isinstance(trainer, loops.Stage1Trainer)
    return dict(saved=saved, shards=shards, result_path=trainer.config.result_path,
                model={k: v.clone() for k, v in trainer.state.model.state_dict().items()},
                disc={k: v.clone() for k, v in trainer.state.disc.state_dict().items()},
                steps=(trainer.state.step, trainer.state.disc_step), n_train=len(trainer.loader_trn.dataset))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(jobs: dict, timeout: int = 240) -> dict:
    """{mode: out_dir} -> {mode: [each rank's result]}: WORLD worker
    processes a mode, every mode's group at once, each on its own port."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = {}
    for mode, out_dir in jobs.items():
        port = _free_port()
        procs[mode] = [subprocess.Popen([sys.executable, HERE, mode, str(r), str(WORLD), str(port), out_dir], cwd=ROOT,
                                        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                       for r in range(WORLD)]
    try:
        logs = {mode: [p.communicate(timeout=timeout)[0] for p in ps] for mode, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    for mode, ps in procs.items():
        for r, (p, log) in enumerate(zip(ps, logs[mode])):
            assert p.returncode == 0, f"{mode} rank {r} exited with {p.returncode}:\n{log[-4000:]}"
    return {mode: [torch.load(os.path.join(out_dir, f"{mode}_{r}.pt"), weights_only=False) for r in range(WORLD)]
            for mode, out_dir in jobs.items()}


# -- comparisons ---------------------------------------------------------------------------------------------------------


def _close_to_max(got: dict, want: dict, what: str, tol: float = GRAD_TOL) -> None:
    assert set(got) == set(want), what
    floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= tol * float(w.abs().max()) + floor, (what, k, err)


def _metrics_close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=METRIC_RTOL, atol=1e-6, err_msg=f"{what} {k}")


def _params_close(got: dict, want: dict, grads: list, lrs: list, what: str) -> None:
    """Post-Adam weights: 5e-6 (+ 1e-5 relative) where every step's gradient
    is above 1e-2 of its tensor's max or 0, two learning rates a step
    elsewhere and in a tensor of rounding noise."""
    top = max(float(gr[k].abs().max()) for gr in grads for k in want)
    for k, w in want.items():
        g = [gr[k] for gr in grads]
        assert float((got[k] - w).abs().max()) <= 2 * sum(lrs) + 1e-6, (what, k)
        if 0 < max(float(x.abs().max()) for x in g) < 1e-5 * top:
            continue
        above = torch.stack([x.abs() > 1e-2 * x.abs().max() for x in g]).all(0)
        zero = torch.stack([x == 0 for x in g]).all(0)
        keep = above | zero
        np.testing.assert_allclose(got[k][keep].numpy(), w[keep].numpy(), rtol=1e-5, atol=5e-6, err_msg=f"{what} {k}")


def _same(a: dict, b: dict, what: str) -> None:
    assert set(a) == set(b), what
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k)


# -- fixtures and tests --------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_ema_inputs() -> dict:
    """Vectors, codes and a codebook state (cluster sizes about 1, so that
    some codes restart and some keep their sums), and JAX's candidates of
    shard 0: its draws recorded on shard 0's vectors, built into
    candidates by the port's restart_candidates (the draws depend on the
    key and the shapes alone)."""
    import jax
    import jax.numpy as jnp

    from rqvae_tpu.ops import quantize as jrq
    from rqvae_tpu_torch.ops import quantize as Q
    from test_torch_quantize_train import recorded_draws

    rng = np.random.RandomState(4)
    vectors = rng.standard_normal((WORLD * EMA_N, EMA_DIM)).astype(np.float32)
    codes = rng.randint(0, EMA_CODES - 4, WORLD * EMA_N)  # the last 4 codes unused in the batch
    embed = rng.standard_normal((EMA_CODES, EMA_DIM)).astype(np.float32)
    cluster = rng.uniform(0.5, 2.0, EMA_CODES).astype(np.float32)
    embed_ema = (embed * cluster[:, None]).astype(np.float32)
    key = jax.random.PRNGKey(9)
    with recorded_draws() as calls:
        jrq._ema_update_one(jnp.asarray(embed), jnp.asarray(cluster), jnp.asarray(embed_ema),
                            jnp.asarray(vectors[:EMA_N]), jnp.asarray(codes[:EMA_N]), EMA_DECAY, 1e-5, True, key, None)
    (k_u, uniform), (k_p, perm) = calls
    assert (k_u, k_p) == ("uniform", "perm")
    candidates = Q.restart_candidates(torch.from_numpy(vectors[:EMA_N]), EMA_CODES,
                                      torch.from_numpy(np.array(perm)).long(), torch.from_numpy(np.array(uniform)))
    return dict(vectors=torch.from_numpy(vectors), codes=torch.from_numpy(codes), embed=torch.from_numpy(embed),
                cluster=torch.from_numpy(cluster), embed_ema=torch.from_numpy(embed_ema), candidates=candidates,
                key=key)


def write_cli_inputs(out: str) -> None:
    """A seeded 8-image folder and a stage-1 config on it: the synthetic
    geometry, a PatchGAN of ndf 8 from epoch 0, no perceptual term, a
    global batch of 4 for one epoch."""
    import yaml

    from test_torch_data import make_folder

    folder = make_folder(os.path.join(out, "imagenet"), n_classes=2, per_class=4)
    with open(os.path.join(ROOT, "tests", "goldens", "synth_ckpt", "stage1", "config.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"].update(root=folder, transforms={"type": "ffhq64x64"})
    cfg["arch"]["ema"] = 0.999
    cfg["optimizer"]["init_lr"] = 1.0e-4
    cfg["experiment"].update(batch_size=4, epochs=1)
    cfg["gan"] = {"disc": {"arch": {"in_channels": 3, "num_layers": 2, "use_actnorm": False, "ndf": 8},
                           "optimizer": {"type": "adam", "init_lr": 1.0e-4, "weight_decay": 0.0, "betas": [0.5, 0.9],
                                         "warmup": {"epoch": 0, "min_lr": 1.0e-5}}},
                  "loss": {"disc_loss": "hinge", "gen_loss": "vanilla", "disc_weight": 0.75, "perceptual_weight": 0.0,
                           "disc_start": 0}}
    with open(os.path.join(out, "stage1.yaml"), "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Both groups of ranks, run at once: the steps (with the EMA inputs)
    and the CLI."""
    steps, cli = str(tmp_path_factory.mktemp("dist")), str(tmp_path_factory.mktemp("dist_cli"))
    inputs = jax_ema_inputs()
    torch.save({k: v for k, v in inputs.items() if k != "key"}, os.path.join(steps, "ema_inputs.pt"))
    write_cli_inputs(cli)
    return inputs, run_workers({"steps": steps, "cli": cli})


@pytest.fixture(scope="module")
def ranks(workers):
    inputs, got = workers
    return inputs, got["steps"]


@pytest.fixture(scope="module")
def cli_ranks(workers):
    return workers[1]["cli"]


def test_stage1_two_ranks_equal_the_global_step(ranks):
    """Both ranks' two steps against one process on the global batch: codes
    (the ranks' in rank order), EMA cluster sizes and counts exact;
    restart candidates (rank 0's draw on the gathered vectors, broadcast),
    EMA sums, codebooks and BatchNorm statistics; g_weight and every
    metric; both optimizers' gradients; post-Adam weights; the ranks'
    states bit-equal."""
    _, got = ranks
    want = run_stage1()
    r0, r1 = got[0]["stage1"], got[1]["stage1"]
    for what in ("model", "disc", "ema"):
        _same(r0[what], r1[what], what)
    for a, b in zip(r0["candidates"], r1["candidates"], strict=True):
        assert torch.equal(a, b)
    qcfg_depth = HP["code_shape"][2]
    assert len(want["candidates"]) == len(r0["candidates"]) == S1_STEPS * qcfg_depth
    for i, (a, b) in enumerate(zip(r0["candidates"], want["candidates"])):
        _close_to_max({"c": a}, {"c": b}, f"candidates {i}", SUM_TOL)
    for n in range(S1_STEPS):
        codes = torch.cat([r0["codes"][n], r1["codes"][n]])
        assert torch.equal(codes, want["codes"][n]), n
        _metrics_close(r0["metrics"][n], want["metrics"][n], f"step {n}")
        _same(r0["metrics"][n], r1["metrics"][n], f"metrics {n}")
        assert float(r0["metrics"][n]["g_weight"]) > 0
        _close_to_max(r0["grads"][n], want["grads"][n], f"rq-vae grads {n}")
        _close_to_max(r0["disc_grads"][n], want["disc_grads"][n], f"disc grads {n}")
    for k, w in want["model"].items():
        if k.startswith("quantizer.") and k.endswith("cluster_size_ema"):
            assert torch.equal(r0["model"][k], w), k  # a function of the code counts alone
    for sd in ("model", "ema"):
        books = {k: v for k, v in r0[sd].items() if k.startswith("quantizer.") and not k.endswith("cluster_size_ema")}
        for k, v in books.items():
            _close_to_max({k: v}, {k: want[sd][k]}, sd, SUM_TOL)
    stats = [k for k in want["disc"] if "running" in k]
    assert stats
    for k in stats:
        _close_to_max({k: r0["disc"][k]}, {k: want["disc"][k]}, "batch stats", SUM_TOL)
    assert torch.equal(r0["disc"]["main.3.num_batches_tracked"], want["disc"]["main.3.num_batches_tracked"])
    params = {k for k in want["grads"][0]}
    _params_close({k: r0["model"][k] for k in params}, {k: want["model"][k] for k in params}, want["grads"],
                  want["lrs"], "rq-vae")
    dparams = set(want["disc_grads"][0])
    _params_close({k: r0["disc"][k] for k in dparams}, {k: want["disc"][k] for k in dparams}, want["disc_grads"],
                  want["lrs"], "disc")


def test_stage2_two_ranks_equal_the_global_step(ranks):
    """One step of 2 microbatches a rank: the averaged gradients, the
    metrics (grad_norm before the clip included) and the weights after the
    clip and AdamW against one process on the global batch; the ranks'
    weights bit-equal."""
    _, got = ranks
    want = run_stage2()
    r0, r1 = got[0]["stage2"], got[1]["stage2"]
    _same(r0["params"], r1["params"], "params")
    _metrics_close(r0["metrics"], want["metrics"], "stage 2")
    _close_to_max(r0["grads"], want["grads"], "stage-2 grads")
    _params_close(r0["params"], want["params"], [want["grads"]], [_schedule()(0)], "stage 2")


def test_ema_two_ranks_equal_jax_shard_map(ranks):
    """rqvae_tpu.ops.quantize._ema_update_one with axis_name under shard_map
    over 2 virtual CPU devices (JAX's psum of the counts and sums; shard
    0's candidates) against the port's ema_update on 2 gloo ranks with
    those candidates; the ranks' cluster sizes bit-equal to one process's
    update of both halves (the summed counts exact), their sums within
    1e-5 of its."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from rqvae_tpu.ops import quantize as jrq
    from rqvae_tpu.parallel import mesh as mesh_lib

    inputs, got = ranks
    mesh = mesh_lib.create_mesh(WORLD, 1, devices=jax.devices()[:WORLD])

    def per_shard(vectors, codes, embed, cluster, ema, key):
        return jrq._ema_update_one(embed, cluster, ema, vectors, codes, EMA_DECAY, 1e-5, True, key, "data")

    fn = shard_map(per_shard, mesh=mesh, in_specs=(P("data"), P("data"), P(), P(), P(), P()),
                   out_specs=(P(), P(), P()), check_vma=False)  # shard 0's all-gathered candidates: replicated
    embed, cluster, ema = fn(*(jnp.asarray(inputs[k].numpy()) for k in ("vectors", "codes", "embed", "cluster",
                                                                        "embed_ema")), inputs["key"])
    _same(got[0]["ema"], got[1]["ema"], "ema")
    sd = got[0]["ema"]
    # one process's ema_update on both halves: the summed counts are exact, so the cluster sizes are bit-equal
    from rqvae_tpu_torch.ops import quantize as Q

    book = Q.VQEmbedding(EMA_CODES, EMA_DIM, device="cpu")
    book.weight[:EMA_CODES] = inputs["embed"]
    book.cluster_size_ema.copy_(inputs["cluster"])
    book.embed_ema.copy_(inputs["embed_ema"])
    Q.ema_update(book, inputs["vectors"], inputs["codes"], EMA_CODES, EMA_DECAY, 1e-5, inputs["candidates"])
    assert torch.equal(sd["cluster_size_ema"], book.cluster_size_ema)
    _close_to_max({"embed_ema": sd["embed_ema"]}, {"embed_ema": book.embed_ema}, "one process", SUM_TOL)
    restarted = (inputs["cluster"] * EMA_DECAY + torch.bincount(inputs["codes"], minlength=EMA_CODES)
                 * (1 - EMA_DECAY)) < 1
    assert 0 < int(restarted.sum()) < EMA_CODES  # both branches of the restart are exercised
    np.testing.assert_allclose(sd["cluster_size_ema"].numpy(), np.asarray(cluster), rtol=1e-5)
    np.testing.assert_allclose(sd["embed_ema"].numpy(), np.asarray(ema), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sd["weight"][:EMA_CODES].numpy(), np.asarray(embed), rtol=1e-4, atol=1e-5)
    assert not sd["weight"][EMA_CODES].any()


def test_initialize_without_a_launcher_is_world_one(monkeypatch):
    """No torchrun environment and no arguments: world 1, no group, and every
    helper the identity."""
    from rqvae_tpu_torch.parallel import dist as D

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    env = D.initialize(device="cpu")
    assert (env.world_size, env.world_rank, env.local_rank, env.num_processes, env.master, env.TOTAL_GPU) == \
        (1, 0, 0, 1, True, 1)
    assert env.group is None and env.device == torch.device("cpu") and not D.active(env)
    x = torch.arange(6.0).reshape(2, 3)
    for fn in (D.all_reduce_sum, D.all_reduce_mean, D.broadcast):
        (y,) = fn([x.clone()], env)
        assert torch.equal(y, x)
    assert D.all_gather_cat(x, env) is x and D.sum_over_ranks(x, env) is x
    assert D.mean_metrics({"a": x}, env)["a"] is x and D.broadcast_object("p", env) == "p"
    D.barrier(env)
    with pytest.raises(ValueError, match="rank and a world size"):
        D.initialize(rank=0, device="cpu")


def test_buckets_split_by_dtype_and_size(monkeypatch):
    from rqvae_tpu_torch.parallel import dist as D

    monkeypatch.setattr(D, "BUCKET_BYTES", 64)
    ts = [torch.zeros(4), torch.zeros(8), torch.zeros(2, dtype=torch.float64), torch.zeros(20), torch.zeros(3)]
    assert D._buckets(ts) == [[0, 1], [2], [3], [4]]


def test_main_stage1_on_two_ranks(cli_ranks):
    """main_stage1 under torchrun's environment on 2 gloo ranks: one result
    directory; rank 0 alone writes model.pt and the checkpoint (every
    rank's generator state in it); the ranks end with bit-equal weights
    and BatchNorm statistics, which model.pt holds; the world size reached
    config_setup; the ranks' shards of each epoch are disjoint and cover
    the 8 images; the global batch of 4 made 2 steps."""
    r0, r1 = cli_ranks
    assert r0["result_path"] == r1["result_path"]
    assert r1["saved"] == []
    assert sorted(os.path.basename(p) for p in r0["saved"]) == ["model.pt", "step_0.pt"]
    _same(r0["model"], r1["model"], "model")
    _same(r0["disc"], r1["disc"], "disc")
    assert r0["steps"] == r1["steps"] == (2, 2)
    weights = torch.load(os.path.join(r0["result_path"], "weights", "step_0", "model.pt"), weights_only=False)
    _same(weights["state_dict"], r0["model"], "model.pt")
    ckpt = torch.load(os.path.join(r0["result_path"], "ckpt", "step_0.pt"), weights_only=False)
    assert len(ckpt["generators"]) == WORLD and not torch.equal(*ckpt["generators"])
    with open(os.path.join(r0["result_path"], "config.yaml")) as f:
        assert "num_devices: 2" in f.read()
    for s0, s1 in zip(r0["shards"], r1["shards"], strict=True):
        assert len(s0) == len(s1) == 4 and not set(s0) & set(s1)
        assert sorted(s0 + s1) == list(range(r0["n_train"]))


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
