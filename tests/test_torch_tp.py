"""Tensor-parallel sampling of the port on the CPU: gloo ranks, each a
subprocess running this file as a worker, against one process and against
the JAX package's Megatron-sharded sampler on the suite's virtual CPU mesh.

  - the split: the port's shard of every weight (mesh.shard_state_dict)
    equals the shard that JAX's transformer_param_specs + shard_pytree
    place on model-axis device m, through checkpoint/from_jax, for a
    shared classifier, a per-depth one with a condition classifier, and
    the 512-wide geometry below;
  - TP 2 on tests/test_parallel.py's 512-wide, 8-head, 6x6x1 geometry
    (token embeddings, per-depth classifier; 4 heads of 64 a shard): 2
    ranks' forced_logits of B 16 against the single process's and JAX's
    teacher-forced forward, at the bf16 / fp32 cache and at kv_q8, and
    with int8 weights against the single process's; greedy codes (top-k 1)
    against the single process's and against JAX's sample of the same
    parameters sharded over a (1, 2) mesh (kv_q8: the per-shard q8 kernel
    in interpret mode, as test_tensor_parallel_sampling_kv_q8_kernel_per_shard);
  - a 2 x 2 (data x model) grid of 4 ranks on test_parallel.py's setup
    geometry (64 wide, 4 heads, 4x4x2 codes through the RQ-VAE codebooks):
    top-k 16 / top-p 0.9 draws from a generator seeded alike on every rank
    equal the single process's bit for bit (each data rank keeps its rows
    of the whole batch's uniforms), as
    test_tensor_parallel_sampling_matches_unsharded holds JAX's; greedy
    codes equal JAX's sample on a 2 x 2 mesh;
  - the refusals: dense="mega", attn_wo and the stacked cache on a split
    model, and a split that does not divide the heads.

fp32 throughout. Bounds: logits within 1e-5 (the row-parallel products
summed over the ranks in another order than one product's sum; measured
4.3e-6 of logits up to 4.6, 4.6e-6 with int8 weights); codes exact; int8
scales exact (the group's amax is the unsharded one). kv_q8 rounds k and v
to int8 codes and the attention's terms to bf16 at fixed points: the sum
order's rounding-size differences leave a value on the other side of a
rounding boundary now and then, which moves it by a step (1/127 of its
head's row maximum, or 2^-8 relative). So kv_q8's TP logits are held to
one bf16 step of the logits' largest magnitude on any element (measured
1.1e-3 of 4.6) and to Q8_MEAN_TOL on the mean (measured 2.0e-5; a wrong
head or row moves the mean to the logits' own scale), and its greedy codes
exactly. JAX's kv_q8 reference runs in a subprocess with XLA's excess
precision off: under jit XLA on the CPU otherwise drops some of those bf16
roundings (tests/test_torch_q8.py), and its codes then differ from the
port's single process as much as from its ranks (4 of 16 rows here).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.models.rqtransformer import model as JM
from rqvae_tpu.models.rqtransformer import sampling as JS
from rqvae_tpu.models.rqtransformer.config import TransformerConfig as JTransformerConfig
from rqvae_tpu.ops import quantize as jrq
from rqvae_tpu.parallel import mesh as jmesh
from rqvae_tpu.utils.config import Config, augment_arch_defaults
from rqvae_tpu_torch.checkpoint import from_jax
from rqvae_tpu_torch.models.rqtransformer import model as TM
from rqvae_tpu_torch.models.rqtransformer import sampling as TS
from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
from rqvae_tpu_torch.ops.quantize import QuantizerConfig, RQCodebooks
from rqvae_tpu_torch.parallel import dist as D
from rqvae_tpu_torch.parallel import mesh as M

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
LOGIT_TOL = 1e-5
Q8_MEAN_TOL = 1e-4

# tests/test_parallel.py:267-276
WIDE_ARCH = dict(
    type="rq-transformer", vocab_size=64, block_size=[6, 6, 1], embed_dim=512, input_embed_dim=0,
    shared_tok_emb=False, shared_cls_emb=False, input_emb_vqvae=False, head_emb_vqvae=False,
    cumsum_depth_ctx=False, vocab_size_cond=8, block_size_cond=1,
    body={"n_layer": 2, "block": {"n_head": 8}}, head={"n_layer": 1, "block": {"n_head": 8}},
)
# tests/test_parallel.py:18-25, with its quantizer (:33)
SETUP_ARCH = dict(
    type="rq-transformer", vocab_size=64, block_size=[4, 4, 2], embed_dim=64, input_embed_dim=16,
    shared_tok_emb=True, shared_cls_emb=True, input_emb_vqvae=True, head_emb_vqvae=True, cumsum_depth_ctx=True,
    vocab_size_cond=8, block_size_cond=1,
    body={"n_layer": 2, "block": {"n_head": 4}}, head={"n_layer": 1, "block": {"n_head": 4}},
)
SETUP_QCFG = dict(latent_shape=(4, 4, 16), code_shape=(4, 4, 2), n_embed=64, shared_codebook=True)
# token embeddings at per-depth offsets, a per-depth classifier over
# unequal vocabularies and a 2-token condition with its classifier
TOKEMB_ARCH = dict(
    SETUP_ARCH, vocab_size=[64, 48], input_emb_vqvae=False, head_emb_vqvae=False, shared_tok_emb=False,
    shared_cls_emb=False, block_size_cond=2,
)
WIDE_B, SETUP_B = 16, 8


def jax_config(arch):
    return JTransformerConfig.create(augment_arch_defaults(Config(arch)).to_dict())


def jax_params(arch, seed=0):
    """JAX's init, perturbed so that no bias is zero and no LayerNorm scale
    is one (numpy, fp32)."""
    rng = np.random.RandomState(seed)
    params = jax.device_get(JM.init_transformer_params(jax.random.PRNGKey(seed), jax_config(arch)))
    return jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params)


def port_state(params, arch) -> dict:
    sd = from_jax.rqtransformer_state_dict_from_jax(params, jax_config(arch))
    return {k: torch.from_numpy(np.array(v, copy=True, order="C")) for k, v in sd.items()}


def jax_mesh(n_data, n_model):
    return jmesh.create_mesh(n_data, n_model, devices=jax.devices()[: n_data * n_model])


# -- what every rank and the single process run --------------------------------------------------------------------------


def build_model(inputs: dict, mesh=None) -> tuple:
    """The port's model (this rank's shard on a mesh) and codebooks."""
    model = TM.RQTransformer(TransformerConfig.create(inputs["arch"]), device="cpu", mesh=mesh)
    state = inputs["state"] if mesh is None else M.shard_state_dict(inputs["state"], mesh.model_rank, mesh.n_model)
    model.load_state_dict(state, strict=True)
    books = None
    if inputs.get("codebook") is not None:
        books = RQCodebooks(QuantizerConfig.create(**inputs["qcfg"]), device="cpu")
        with torch.no_grad():
            books.codebooks[0].weight[:-1] = inputs["codebook"]
    return model, books


def run_cases(model, books, inputs: dict) -> dict:
    """Each case's output: forced_logits, sampled codes, the int8 scales of
    block 0 and the refusals' messages."""
    out, B, cond = {}, inputs["batch"], inputs["cond"]
    for name, kind, options in inputs["cases"]:
        if kind == "int8":
            model.quantize_int8()
            blk = model.body_transformer.blocks[0]
            out[name] = {"wo_s": blk.wo_s.clone(), "w1_s": blk.w1_s.clone(), "wqkv_s": blk.wqkv_s.clone()}
        elif kind == "logits":
            out[name] = TS.forced_logits(model, inputs["forced"], cond, books, **options)
        elif kind == "sample":
            gen = torch.Generator().manual_seed(inputs["seed"])
            out[name] = TS.sample(model, B, gen, cond=cond, quantizer=books, **options)
        elif kind == "refuse":
            try:
                TS.sample(model, B, torch.Generator().manual_seed(0), cond=cond, quantizer=books, **options)
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
    return out


def jax_q8_worker(out_dir: str) -> None:
    """JAX's greedy kv_q8 sample of the 512-wide geometry sharded over a
    (1, 2) mesh, the per-shard q8 kernel in interpret mode; run with XLA's
    excess precision off (module docstring)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    jax.config.update("jax_platforms", "cpu")
    params = jax_params(WIDE_ARCH, 0)
    mesh = jax_mesh(1, 2)
    sharded = jmesh.shard_pytree(params, jmesh.transformer_param_specs(params), mesh)
    cond = jax.device_put(jnp.asarray(np.arange(WIDE_B) % 8, jnp.int32), NamedSharding(mesh, P("data")))
    policy = JM.DecodePolicy(attn="pallas", unroll=True, interpret=True, kv_q8=True)
    with mesh:
        codes = JS.sample(sharded, jax_config(WIDE_ARCH), jax.random.PRNGKey(0), WIDE_B, cond=cond, top_k=1,
                          policy=policy)
    np.save(os.path.join(out_dir, "jax_q8.npy"), np.asarray(codes))


def worker(mode: str, rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(out_dir, f"{mode}_inputs.pt"), weights_only=False)
    env = D.initialize(backend="gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                       device="cpu")
    mesh = M.create_mesh(*inputs["mesh"], env)
    model, books = build_model(inputs, mesh)
    out = run_cases(model, books, inputs)
    out["coords"] = (mesh.data_rank, mesh.model_rank)
    torch.save(out, os.path.join(out_dir, f"{mode}_{rank}.pt"))
    D.shutdown(env)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
                **extra)


def start_workers(mode: str, world: int, out_dir: str, script: str = HERE) -> list:
    """`world` ranks of `script`'s worker for `mode`, on one free port."""
    port = _free_port()
    return [subprocess.Popen([sys.executable, script, mode, str(r), str(world), str(port), out_dir], cwd=ROOT,
                             env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def start_jax_q8(out_dir: str) -> subprocess.Popen:
    flags = "--xla_force_host_platform_device_count=8 --xla_allow_excess_precision=false"
    return subprocess.Popen([sys.executable, HERE, "jax_q8", out_dir], cwd=ROOT, env=_env(XLA_FLAGS=flags),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def collect(mode: str, procs: list, out_dir: str, timeout: int = 200, load: bool = True) -> list:
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{mode} rank {r} exited with {p.returncode}:\n{log[-4000:]}"
    if not load:
        return []
    return [torch.load(os.path.join(out_dir, f"{mode}_{r}.pt"), weights_only=False) for r in range(len(procs))]


# -- fixtures -------------------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WIDE_CASES = [
    ("logits", "logits", {}), ("logits_q8", "logits", {"kv_q8": True}),
    ("greedy", "sample", {"top_k": 1}), ("greedy_q8", "sample", {"top_k": 1, "kv_q8": True}),
    ("mega", "refuse", {"dense": "mega"}), ("attn_wo", "refuse", {"kv_q8": True, "attn_wo": True}),
    ("stacked", "refuse", {"unroll": False}),
    ("int8", "int8", {}), ("int8_logits", "logits", {}), ("int8_greedy", "sample", {"top_k": 1}),
]
SETUP_CASES = [("sample", "sample", {"top_k": 16, "top_p": 0.9}), ("greedy", "sample", {"top_k": 1}),
               ("logits", "logits", {})]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups' results, the single process's and JAX's references.
    The ranks start first and run while this process computes the rest."""
    out_dir = str(tmp_path_factory.mktemp("tp"))
    r = np.random.RandomState(5)
    wide_params = jax_params(WIDE_ARCH, 0)
    wide = dict(arch=WIDE_ARCH, state=port_state(wide_params, WIDE_ARCH), batch=WIDE_B, mesh=(1, 2), seed=0,
                cond=torch.from_numpy(np.arange(WIDE_B) % 8), forced=torch.from_numpy(r.randint(0, 64, (WIDE_B, 6, 6, 1))),
                cases=WIDE_CASES)
    setup_params = jax.device_get(JM.init_transformer_params(jax.random.PRNGKey(0), jax_config(SETUP_ARCH)))
    jq = jrq.QuantizerConfig.create(**SETUP_QCFG)
    vq_state = jax.device_get(jrq.init_codebook_state(jax.random.PRNGKey(1), jq))
    setup = dict(arch=SETUP_ARCH, state=port_state(setup_params, SETUP_ARCH), batch=SETUP_B, mesh=(2, 2), seed=2,
                 cond=torch.from_numpy(np.arange(SETUP_B) % 8), qcfg=SETUP_QCFG,
                 codebook=torch.from_numpy(np.array(vq_state.embed[0])),
                 forced=torch.from_numpy(r.randint(0, 64, (SETUP_B, 4, 4, 2))), cases=SETUP_CASES)
    procs = {"jax_q8": [start_jax_q8(out_dir)]}
    for mode, inputs, world in (("wide", wide, 2), ("setup", setup, 4)):
        torch.save(inputs, os.path.join(out_dir, f"{mode}_inputs.pt"))
        procs[mode] = start_workers(mode, world, out_dir)
    try:
        single = {mode: run_cases(*build_model(inputs), inputs) for mode, inputs in (("wide", wide), ("setup", setup))}
        ref = jax_references(wide_params, wide, setup_params, setup, vq_state, jq)
    finally:
        ranks = {mode: collect(mode, ps, out_dir) for mode, ps in procs.items() if mode != "jax_q8"}
        collect("jax_q8", procs["jax_q8"], out_dir, load=False)
    ref["wide_greedy_q8"] = np.load(os.path.join(out_dir, "jax_q8.npy"))
    return dict(ranks=ranks, single=single, jax=ref, wide=wide, setup=setup)


def jax_references(wide_params, wide, setup_params, setup, vq_state, jq) -> dict:
    """JAX's teacher-forced logits of the forced codes and its greedy TP
    samples: the 512-wide geometry sharded over (1, 2) with the fp32 cache
    on the XLA attention (kv_q8's comes from jax_q8_worker), the setup
    geometry over (2, 2)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = jax_config(WIDE_ARCH)
    xs = jnp.asarray(wide["forced"].numpy())
    logits = np.asarray(jax.jit(lambda p: JM.forward(p, cfg, xs, jnp.asarray(wide["cond"].numpy())[:, None]))(
        wide_params))
    out = {"wide_forward": logits}
    for name, n_data, n_model, params, c, inputs, extra in (
        ("wide_greedy", 1, 2, wide_params, cfg, wide, dict(policy=JM.DecodePolicy(attn="vpu", unroll=True))),
        ("setup_greedy", 2, 2, setup_params, jax_config(SETUP_ARCH), setup,
         dict(vq_state=vq_state, vq_config=jq)),
    ):
        mesh = jax_mesh(n_data, n_model)
        sharded = jmesh.shard_pytree(params, jmesh.transformer_param_specs(params), mesh)
        cond = jax.device_put(jnp.asarray(inputs["cond"].numpy(), jnp.int32), NamedSharding(mesh, P("data")))
        with mesh:
            out[name] = np.asarray(JS.sample(sharded, c, jax.random.PRNGKey(0), inputs["batch"], cond=cond,
                                             top_k=1, **extra))
    return out


# -- tests ----------------------------------------------------------------------------------------------------------------


def _jax_shard(leaf, mesh, m):
    device = mesh.devices[0, m]
    return next(np.asarray(s.data) for s in leaf.addressable_shards if s.device == device)


@pytest.mark.parametrize("arch", [SETUP_ARCH, TOKEMB_ARCH, WIDE_ARCH], ids=["shared_cls", "per_depth_cond", "wide"])
def test_shards_equal_jax_shard_pytree(arch):
    params = jax_params(arch, 1)
    config = jax_config(arch)
    full = port_state(params, arch)
    mesh = jax_mesh(4, 2)
    sharded = jmesh.shard_pytree(params, jmesh.transformer_param_specs(params), mesh)
    specs = M.transformer_param_specs(full)
    assert {k for k, v in specs.items() if v is not None} >= {"classifier.linear.weight", "classifier.linear.bias"}
    if arch["block_size_cond"] > 1:
        assert specs["cond_classifier.linear.weight"] == 0 and specs["cond_classifier.linear.bias"] == 0
    for m in range(2):
        want = from_jax.rqtransformer_state_dict_from_jax(jax.tree.map(lambda x: _jax_shard(x, mesh, m), sharded),
                                                          config)
        got = M.shard_state_dict(full, m, 2)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=f"model rank {m}: {k}")
        model = TM.RQTransformer(TransformerConfig.create(arch), device="cpu", mesh=M.Mesh(4, 2, 0, m))
        model.load_state_dict(got, strict=True)


def test_split_block_holds_its_head_group():
    model = TM.RQTransformer(TransformerConfig.create(WIDE_ARCH), device="cpu", mesh=M.Mesh(1, 2, 0, 1))
    blk = model.body_transformer.blocks[0]
    model.fuse_qkv()
    assert blk.wqkv.shape == (3 * 256, 512) and blk.attn.proj.weight.shape == (512, 256)
    assert blk.mlp[0].weight.shape == (1024, 512) and blk.mlp[2].weight.shape == (512, 1024)
    assert model.body_transformer.n_head == 4 and model.body_transformer.width == 256
    assert model.classifier.linear.weight.shape == (1, 512, 32)


@pytest.mark.parametrize("case", ["logits", "logits_q8", "int8_logits"])
def test_tp2_forced_logits_match_single_process_and_jax(runs, case):
    single = runs["single"]["wide"][case]
    for r, out in enumerate(runs["ranks"]["wide"]):
        if case == "logits_q8":
            d = (out[case] - single).abs()
            assert float(d.max()) <= 2.0**-8 * float(single.abs().max()), (r, float(d.max()))
            assert float(d.mean()) <= Q8_MEAN_TOL, (r, float(d.mean()))
            continue
        np.testing.assert_allclose(out[case].numpy(), single.numpy(), rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"rank {r} against the single process")
    if case == "logits":
        np.testing.assert_allclose(single.numpy(), runs["jax"]["wide_forward"], rtol=0, atol=LOGIT_TOL)
        np.testing.assert_allclose(runs["ranks"]["wide"][0][case].numpy(), runs["jax"]["wide_forward"], rtol=0,
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("case", ["greedy", "greedy_q8", "int8_greedy"])
def test_tp2_greedy_codes_equal_single_process_and_jax_tp(runs, case):
    single = runs["single"]["wide"][case]
    assert single.shape == (WIDE_B, 6, 6, 1)
    for out in runs["ranks"]["wide"]:
        assert torch.equal(out[case], single)
    if case != "int8_greedy":
        np.testing.assert_array_equal(single.numpy(), runs["jax"][f"wide_{case}"])


def test_tp2_int8_scales_are_the_unsharded_models(runs):
    single = runs["single"]["wide"]["int8"]
    for m, out in enumerate(runs["ranks"]["wide"]):
        got = out["int8"]
        assert torch.equal(got["wo_s"], single["wo_s"])  # row-parallel: the group's amax
        assert torch.equal(got["w1_s"], single["w1_s"][m * 1024 : (m + 1) * 1024])
        n = 256
        want = torch.cat([single["wqkv_s"][j * 512 + m * n : j * 512 + (m + 1) * n] for j in range(3)])
        assert torch.equal(got["wqkv_s"], want)


@pytest.mark.parametrize("case", ["mega", "attn_wo", "stacked"])
def test_tp_refuses_fused_paths_and_the_stacked_cache(runs, case):
    for out in runs["ranks"]["wide"]:
        assert out[case] is not None and ("tensor-parallel" in out[case])
    assert runs["single"]["wide"][case] != runs["ranks"]["wide"][0][case]


def test_2x2_grid_samples_equal_the_single_process(runs):
    single = runs["single"]["setup"]
    coords = sorted(out["coords"] for out in runs["ranks"]["setup"])
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for out in runs["ranks"]["setup"]:
        for case in ("sample", "greedy"):
            assert out[case].shape == (SETUP_B, 4, 4, 2)
            assert torch.equal(out[case], single[case]), case
        np.testing.assert_allclose(out["logits"].numpy(), single["logits"].numpy(), rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(single["greedy"].numpy(), runs["jax"]["setup_greedy"])
    assert len(torch.unique(single["sample"])) > 8


# (C / tp, heads / tp) of each split the port samples: the 1.4B model (24
# heads of 64) and the 3.8B (40 heads of 64) at TP 2 and 4
SHARD_SHAPES = {"1.4B tp2": (768, 12), "1.4B tp4": (384, 6), "3.8B tp2": (1280, 20), "3.8B tp4": (640, 10)}


@pytest.mark.parametrize("window", (0, 1, 32, 63, 64))
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("shard", list(SHARD_SHAPES))
@pytest.mark.parametrize("B", (2, 8, 50, 100))
def test_shard_shapes_have_a_kernel_plan(B, shard, q8, window):
    """#1 / #4 serve every shard shape of the split models by a plan of
    csrc/decode_attention_tma.cu (never a quiet fall back: a shape without
    one raises ValueError in the wrapper), and the plan attends every
    (batch row, head, window row) once, its copies aligned and inside their
    stages (tests/test_torch_attention_tma.py's checks)."""
    from test_torch_attention_tma import _check_copies
    from rqvae_tpu_torch.ops import attention_kernel as AK
    from rqvae_tpu_torch.ops import decode_layer_kernel as DK

    C, nh = SHARD_SHAPES[shard]
    plan = AK.attention_plan(B, C, nh, window, q8)
    assert plan.hs == 64 and nh % plan.groups == 0 and 1 <= plan.ctas <= B * plan.groups
    assert plan.smem == AK._tma_smem(plan.piece, plan.hpc, window, plan.rows, plan.stages, q8) <= DK.SMEM_LIMIT
    assert plan.piece % 16 == 0 and (C * plan.eb) % 16 == 0
    heads = np.zeros((B, nh), np.int64)
    for cta in range(plan.ctas):
        for u in plan.units(cta):
            b, g = divmod(u, plan.groups)
            heads[b, g * plan.hpc:(g + 1) * plan.hpc] += 1
    assert (heads == 1).all()
    for n_valid in sorted({window, window // 2 + (window > 0)}):
        for cta in sorted({0, plan.ctas - 1}):
            _check_copies(plan, cta, n_valid, window + 1)


def test_split_that_does_not_divide_the_heads_raises():
    arch = dict(WIDE_ARCH, body={"n_layer": 1, "block": {"n_head": 6}}, embed_dim=384)
    with pytest.raises(ValueError, match="does not divide"):
        TM.RQTransformer(TransformerConfig.create(arch), device="cpu", mesh=M.Mesh(1, 4, 0, 0))
    with pytest.raises(ValueError, match="mesh 2x2 != 1 ranks"):
        M.create_mesh(2, 2)


def test_mesh_without_a_group_is_one_rank():
    mesh = M.create_mesh()
    assert (mesh.n_data, mesh.n_model, mesh.data_rank, mesh.model_rank) == (1, 1, 0, 0)
    assert mesh.data_group is None and mesh.model_group is None
    x = torch.ones(3)
    assert D.group_sum(x, None) is x and D.group_gather_last(x, None) is x and D.group_gather_first(x, None) is x


if __name__ == "__main__":
    if sys.argv[1] == "jax_q8":
        jax_q8_worker(sys.argv[2])
    else:
        worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
