"""ZeRO-1 of the port on the CPU: the data-axis split of the optimizer's
moments against the JAX package's zero_opt_state_specs, and a stage-2
step whose 2 gloo ranks (each a subprocess running this file as a worker)
keep half of each moment against the same ranks' replicated step.

The step is tests/test_torch_dist.py's stage-2 setup (a 2 + 2-layer
RQ-Transformer, global batch 8 in 2 microbatches, AdamW with the global
norm clip), two steps so that the second reads the sliced moments the
first wrote. Bounds, JAX's own (tests/test_parallel.py
test_zero_optimizer_state_sharding): the loss rtol 1e-5; parameters and
moments rtol 1e-4 / atol 1e-6 (the update is elementwise on the same
reduced gradient, so they agree to the last bit but for an FMA in a
strided kernel); the ranks bit-equal to each other (one all-gather).
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rqvae_tpu.models.rqtransformer import model as JM
from rqvae_tpu.parallel import mesh as jmesh
from rqvae_tpu_torch.parallel import dist as D
from rqvae_tpu_torch.parallel import mesh as M
from test_torch_dist import S2_ACCUM, S2_ARCH, build_stage2, rank_share, stage2_batch
from test_torch_tp import collect, jax_config, start_workers

HERE = os.path.abspath(__file__)
WORLD, STEPS = 2, 2
# shapes beside the model's: a scalar, dims shorter than the data size, a
# first dim that does not divide and a later one that does
ODD_SHAPES = [(), (1,), (3, 5), (7,), (1, 16), (6, 4), (5, 8, 2), (2, 3)]


def _jax_dims(specs) -> list:
    """Each spec leaf as the index of the data axis, or None."""
    leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [next((i for i, a in enumerate(p) if a == jmesh.DATA_AXIS), None) for p in leaves]


@pytest.mark.parametrize("n_data", [2, 4, 8])
def test_zero_specs_match_jax(n_data):
    params = JM.init_transformer_params(jax.random.PRNGKey(0), jax_config(S2_ARCH))
    opt_state = optax.adamw(1e-3).init(params)
    extra = {f"t{i}": jnp.zeros(s) for i, s in enumerate(ODD_SHAPES)}
    mesh = jmesh.create_mesh(n_data, 1, devices=jax.devices()[:n_data])
    want = _jax_dims(jmesh.zero_opt_state_specs((opt_state, extra), mesh))
    leaves = jax.tree.leaves((opt_state, extra))
    port_state = [torch.zeros(tuple(x.shape)) for x in leaves]
    got = M.zero_opt_state_specs(port_state, n_data)
    assert got == want
    assert any(d == 1 for d in got) and any(d is None for d in got) and any(d == 0 for d in got)
    shards = M.shard_opt_state_zero({"m": port_state}, 1, n_data)["m"]
    for t, s, d in zip(port_state, shards, got):
        assert s.shape == (t.shape if d is None else t.shape[:d] + (t.shape[d] // n_data,) + t.shape[d + 1 :])


def run(env, rank: int, zero: bool) -> dict:
    from rqvae_tpu_torch.optim.optimizer import moment_bytes
    from rqvae_tpu_torch.trainers import trainer_stage2 as T2

    state = build_stage2()
    step = T2.make_train_step(T2.Stage2LossConfig(use_soft_target=False, amp_bf16=False), grad_accum_steps=S2_ACCUM,
                              dist=env, zero=zero)
    losses = []
    for i in range(STEPS):
        state, m = step(state, rank_share(stage2_batch(), rank, WORLD, S2_ACCUM), torch.Generator().manual_seed(5 + i))
        losses.append(m["loss_total"])
    names = {p: k for k, p in state.model.named_parameters()}
    return dict(losses=losses, params={k: p.detach().clone() for k, p in state.model.named_parameters()},
                moments={names[p]: {k: v.clone() for k, v in st.items()} for p, st in state.optimizer.state.items()},
                moment_bytes=moment_bytes(state.optimizer))


def worker(mode: str, rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    env = D.initialize(backend="gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                       device="cpu")
    torch.save(dict(zero=run(env, rank, True), replicated=run(env, rank, False)),
               os.path.join(out_dir, f"{mode}_{rank}.pt"))
    D.shutdown(env)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("zero"))
    return collect("zero", start_workers("zero", WORLD, out_dir, script=HERE), out_dir)


def test_zero_step_equals_the_replicated_step(ranks):
    initial = dict(build_stage2().model.named_parameters())
    for r, out in enumerate(ranks):
        z, ref = out["zero"], out["replicated"]
        np.testing.assert_allclose([float(x) for x in z["losses"]], [float(x) for x in ref["losses"]], rtol=1e-5)
        for k, w in ref["params"].items():
            np.testing.assert_allclose(z["params"][k].numpy(), w.numpy(), rtol=1e-4, atol=1e-6, err_msg=f"rank {r} {k}")
            assert not torch.equal(z["params"][k], initial[k]), f"{k} did not move"
    for k in ranks[0]["zero"]["params"]:
        assert torch.equal(ranks[0]["zero"]["params"][k], ranks[1]["zero"]["params"][k]), k


def test_each_rank_keeps_its_slice_of_the_moments(ranks):
    """Each moment of a ZeRO rank is its slice (zero_dim) of the replicated
    rank's, and the rank holds about half of the moment bytes."""
    half = 0
    for r, out in enumerate(ranks):
        z, ref = out["zero"]["moments"], out["replicated"]["moments"]
        assert set(z) == set(ref)
        for name, moms in ref.items():
            for k, full in moms.items():
                want = M.shard(full, M.zero_dim(full.shape, WORLD), r, WORLD)
                np.testing.assert_allclose(z[name][k].numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=f"rank {r} {name} {k}")
        half = sum(t.numel() * 4 // (1 if M.zero_dim(t.shape, WORLD) is None else WORLD)
                   for moms in ref.values() for t in moms.values())
        assert out["zero"]["moment_bytes"] == half
        assert out["zero"]["moment_bytes"] <= 0.51 * out["replicated"]["moment_bytes"]
    assert half > 0


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
