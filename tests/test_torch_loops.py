"""The port's epoch loops against the JAX package's on the CPU.

Stage 1: the committed synthetic stage-1 geometry (64x64 images, ch 32,
8x8x2 codes over 64 shared codes) with restarts off and dropout 0, so that
no random draw enters a step; NLayerDiscriminator(ndf 16, 2 layers) with
the discriminator on from epoch 0, LPIPS on JAX's init weights in fp32,
Adam (0.5, 0.9) for both, EMA on. JAX's Stage1Trainer makes its init
state, which the port takes through stage1_state_from_jax; both read a
12-image PNG folder through ffhq64x64's transforms in batches of 4. One
train epoch (3 steps) and the eval of the weights and of the EMA: each
summary metric within 1e-4 relative (+ 1e-5) of JAX's, the codebook-usage
entropies within 1e-6. Both optimizers run at lr 1e-5: fp32 on both sides
with convolutions summed in other orders, and Adam moves a parameter
whose gradient is rounding noise by a whole learning rate in a direction
that noise picks (tests/test_torch_trainer_stage1.py). At lr 0 the
summaries agree within 1e-6 relative, at 1e-5 within 2.2e-5 (g_weight),
at 1e-3 within 3.3e-3: the gap scales with the learning rate, not with
the loop.

Stage 2: the synthetic stage-2 arch (embed 64, 2 + 2 layers of 4 heads,
resid_pdrop 0) over the synthetic stage-1 checkpoint's fp32 frozen
encode, soft targets, adamW with the clip, batch 2 x 2 accumulation
steps, EMA on; class-conditional on the folder and text-conditional on a
cc3m caption folder (8-token captions of the 'simple' BPE with a
synthetic merges file). One train epoch (3 steps) and the eval: summary
metrics within 1e-4 relative (+ 1e-5) of JAX's Stage2Trainer, at lr 1e-5.

Each loop is also held bit-equal to its own train step applied to the
loader's batches in order, with the loop's torch.Generator.
"""

import gzip
import logging
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch
import yaml

from rqvae_tpu import data as jdata
from rqvae_tpu.checkpoint.torch_convert import convert_rqvae
from rqvae_tpu.data import tokenizers as jtokenizers
from rqvae_tpu.losses.discriminator import NLayerDiscriminator as JDisc
from rqvae_tpu.losses.lpips import LPIPS as JLPIPS
from rqvae_tpu.losses.lpips import init_lpips
from rqvae_tpu.models.rqtransformer.config import TransformerConfig as JTransformerConfig
from rqvae_tpu.models.rqvae.model import RQVAE as JRQVAE
from rqvae_tpu.models.rqvae.model import RQVAEHParams as JHParams
from rqvae_tpu.models.rqvae.modules import DDConfig as JDDConfig
from rqvae_tpu.optim.optimizer import create_optimizer as j_create_optimizer
from rqvae_tpu.optim.schedule import create_schedule as j_create_schedule
from rqvae_tpu.trainers import loops as JL
from rqvae_tpu.trainers import trainer_stage1 as J1
from rqvae_tpu.trainers import trainer_stage2 as J2
from rqvae_tpu.utils.config import Config as JConfig
from rqvae_tpu_torch import data as tdata
from rqvae_tpu_torch.checkpoint import from_jax
from rqvae_tpu_torch.losses.lpips import LPIPS
from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
from rqvae_tpu_torch.models.rqvae.model import RQVAE, RQVAEHParams
from rqvae_tpu_torch.models.rqvae.modules import DDConfig
from rqvae_tpu_torch.optim.schedule import create_schedule
from rqvae_tpu_torch.trainers import loops as TL
from rqvae_tpu_torch.trainers import trainer_stage1 as T1
from rqvae_tpu_torch.trainers import trainer_stage2 as T2
from rqvae_tpu_torch.trainers.accumulator import AccmStage1
from rqvae_tpu_torch.utils.config import Config, augment_arch_defaults
from test_torch_data import MERGES, make_folder, one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_rqtransformer import GOLDENS, to_torch

S1_OPTIM = {"type": "adam", "betas": [0.5, 0.9], "weight_decay": 0.0}
S2_OPTIM = {"type": "adamW", "betas": [0.9, 0.95], "weight_decay": 0.05, "max_gn": 1.0}
DISC = dict(ndf=16, n_layers=2)
BATCH = 4
LR = 1e-5  # module docstring
RTOL, ATOL = 1e-4, 1e-5
LOG = logging.getLogger("test_torch_loops")


def _schedule(make, steps_per_epoch=3):
    return make(base_lr=LR, warmup_config={"epoch": 0, "min_lr": LR / 10}, steps_per_epoch=steps_per_epoch,
                max_epoch=2)


def _synth(stage):
    with open(os.path.join(GOLDENS, "synth_ckpt", stage, "config.yaml")) as f:
        return yaml.safe_load(f)


def _compare_summary(got, want, names):
    assert set(got.metrics) == set(want.metrics) == set(names)
    for k in names:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return make_folder(str(tmp_path_factory.mktemp("imagenet")))


# -- stage 1 ----------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stage1(folder):
    """JAX's and the port's Stage1Trainer from one init state, and the
    port's pieces for a second, manual run."""
    arch = _synth("stage1")["arch"]
    arch["hparams"]["restart_unused_codes"] = False
    arch["ema"] = 0.9999
    cfg = {"dataset": {"type": "imagenet", "root": folder, "transforms": {"type": "ffhq64x64"}}, "arch": arch,
           "experiment": {"batch_size": BATCH, "epochs": 1, "test_freq": 1}}
    gan = dict(disc_start=0, lpips_bf16=False)
    jmodel = JRQVAE(hparams=JHParams.create(arch["hparams"]), ddconfig=JDDConfig.create(arch["ddconfig"]),
                    use_kernel=False)
    lpips_vars = init_lpips(jax.random.PRNGKey(4))
    jtrn, jval = jdata.create_dataset(JConfig(cfg))
    jt = JL.Stage1Trainer(model=jmodel, disc=JDisc(**DISC), lpips=JLPIPS(), lpips_vars=lpips_vars,
                          gan_cfg=J1.GanLossConfig(**gan), tx=j_create_optimizer(S1_OPTIM, _schedule(j_create_schedule)),
                          disc_tx=j_create_optimizer(S1_OPTIM, _schedule(j_create_schedule)), config=JConfig(cfg),
                          dataset_trn=jtrn, dataset_val=jval, logger=LOG, seed=0)
    init = jax.device_get(jt.state)
    hp, dd = RQVAEHParams.create(arch["hparams"]), DDConfig.create(arch["ddconfig"])
    lpips = LPIPS(device="cpu")
    lpips.load_state_dict(to_torch(from_jax.lpips_state_dict_from_jax(jax.device_get(lpips_vars)["params"])))

    def port(dataset_trn, dataset_val):
        state = from_jax.stage1_state_from_jax(init, hp, dd, DISC, S1_OPTIM, _schedule(create_schedule), S1_OPTIM,
                                               _schedule(create_schedule), device="cpu", use_kernel=False)
        with mock.patch.dict(os.environ, {"SMOKE_TEST": "1"}):  # the loaders in this process
            return TL.Stage1Trainer(model=state.model, disc=state.disc, lpips=lpips, gan_cfg=T1.GanLossConfig(**gan),
                                    optim_config=S1_OPTIM, schedule=_schedule(create_schedule),
                                    disc_optim_config=S1_OPTIM, disc_schedule=_schedule(create_schedule),
                                    config=Config(cfg), dataset_trn=dataset_trn, dataset_val=dataset_val, logger=LOG,
                                    seed=0)

    ttrn, tval = tdata.create_dataset(Config(cfg))
    pt = port(ttrn, tval)
    summaries = {}
    for name, trainer in (("jax", jt), ("port", pt)):
        summaries[name] = (trainer.train_epoch(0), trainer.eval_epoch(0), trainer.eval_epoch(0, ema=True))
    return dict(summaries=summaries, port=port, pt=pt, lpips=lpips, gan=gan, datasets=(ttrn, tval))


def test_stage1_epoch_and_evals_match_jax(stage1):
    (jtrain, jval, jema), (ptrain, pval, pema) = stage1["summaries"]["jax"], stage1["summaries"]["port"]
    names = TL.Stage1Trainer.METRIC_NAMES
    _compare_summary(ptrain, jtrain, names)
    assert float(ptrain["g_weight"]) > 0 and float(ptrain["loss_disc"]) > 0  # the discriminator was on
    for got, want in ((pval, jval), (pema, jema)):
        _compare_summary(got, want, names)
    for got, want in ((ptrain, jtrain), (pval, jval), (pema, jema)):
        assert got["ent_codes_w_pad"] is None and want["ent_codes_w_pad"] is None
        for g, w in zip(got["ent_codes_wo_pad"], want["ent_codes_wo_pad"], strict=True):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)
        assert got["xs"].shape == (BATCH, 64, 64, 3)
        np.testing.assert_allclose(got["xs"].numpy(), np.asarray(want["xs"]), rtol=0, atol=1e-6)


def test_stage1_epoch_equals_its_own_steps(stage1):
    """A second port trainer's epoch, done by hand: the loader's batches
    through make_train_step with a generator seeded as the loop's; the same
    weights, EMA and optimizer moments bit for bit, and the summary the
    loop's accumulator gives."""
    pt = stage1["pt"]
    manual = stage1["port"](*stage1["datasets"])
    step = T1.make_train_step(stage1["lpips"], T1.GanLossConfig(**stage1["gan"]), use_discriminator=True)
    gen = torch.Generator().manual_seed(1)
    accm = AccmStage1(TL.Stage1Trainer.METRIC_NAMES, n_codebook=2, codebook_size=64)
    manual.loader_trn.set_epoch(0)
    state = manual.state
    for batch in manual.loader_trn:
        state, metrics, codes = step(state, {"images": batch["images"].permute(0, 2, 3, 1)}, gen)
        accm.update([codes], {k: float(v) for k, v in metrics.items()})
    want = accm.get_summary()
    _compare_summary(stage1["summaries"]["port"][0], want, TL.Stage1Trainer.METRIC_NAMES)
    for k in want.metrics:
        assert float(stage1["summaries"]["port"][0][k]) == want[k], k
    for (k, a), b in zip(pt.state.model.state_dict().items(), state.model.state_dict().values(), strict=True):
        assert torch.equal(a, b), k
    for k in pt.state.ema:
        assert torch.equal(pt.state.ema[k], state.ema[k]), k
    for a, b in zip(pt.state.disc.state_dict().values(), state.disc.state_dict().values(), strict=True):
        assert torch.equal(a, b)
    assert (pt.state.step, pt.state.disc_step) == (state.step, state.disc_step) == (3, 3)
    assert torch.equal(pt.generator.get_state(), gen.get_state())


def test_stage1_logging_writes_grids_and_scalars(stage1, tmp_path):
    """The reference's cadence at epoch 0 (test_freq 1): a reconstruction
    and 2 x 2 partial-code grids, the losses and the codebook entropies."""
    from rqvae_tpu_torch.utils.setup import Writer

    pt = stage1["pt"]
    seen = []

    class Spy(Writer):
        def add_scalar(self, tag, value, mode="train", step=0):
            seen.append(("scalar", tag, mode, step))

        def add_image(self, tag, image_hwc, mode="train", step=0):
            assert image_hwc.ndim == 3 and image_hwc.shape[-1] == 3 and 0 <= image_hwc.min() <= image_hwc.max() <= 1
            seen.append(("image", tag, mode, step))

    pt.writer = Spy(None)
    pt.logging(stage1["summaries"]["port"][1], 0, "valid")
    images = [t for kind, t, *_ in seen if kind == "image"]
    assert images == ["reconstruction"] + [f"reconstruction_{d}/{i}-th code" for i in range(2) for d in ("select", "add")]
    scalars = {t for kind, t, *_ in seen if kind == "scalar"}
    assert {f"loss/{k}" for k in TL.Stage1Trainer.METRIC_NAMES} < scalars
    assert {f"codebooks-wo-pad/entropy-level-0/codebook{b}" for b in range(2)} < scalars


# -- stage 2 ----------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frozen_stage1():
    """The synthetic stage-1 checkpoint as JAX's model + variables and the port's RQVAE."""
    arch = _synth("stage1")["arch"]
    sd = torch.load(os.path.join(GOLDENS, "synth_ckpt", "stage1", "model.pt"), map_location="cpu")["state_dict"]
    vqvae = RQVAE(RQVAEHParams.create(arch["hparams"]), DDConfig.create(arch["ddconfig"]), device="cpu")
    vqvae.load_state_dict(sd, strict=True)
    jmodel = JRQVAE(hparams=JHParams.create(arch["hparams"]), ddconfig=JDDConfig.create(arch["ddconfig"]))
    params, state = convert_rqvae(sd, jmodel.quantizer_config)
    return jmodel, {"params": params, "codebook": {"state": state}}, vqvae


def make_cc3m(root, n_train=12, n_val=4):
    """A cc3m caption folder of 64-100 pixel PNGs and a merges file."""
    from test_torch_data import CAPTIONS, smooth_image

    from rqvae_tpu_torch.data.image_io import write_png

    rng = np.random.RandomState(12)
    os.makedirs(os.path.join(root, "imgs"))
    for split, n in (("train", n_train), ("val", n_val)):
        with open(os.path.join(root, f"{split}_list.txt"), "w") as f:
            for i in range(n):
                name = f"imgs/{split}_{i}.png"
                write_png(os.path.join(root, name), smooth_image(rng, int(rng.randint(64, 100)),
                                                                 int(rng.randint(64, 100))))
                f.write(f"{name}\t{CAPTIONS[i % 4]} {i}\n")
    with gzip.open(os.path.join(root, "bpe_simple_vocab_16e6.txt.gz"), "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    return root


def stage2_arch(text: bool) -> dict:
    arch = _synth("stage2")["arch"]
    arch.update(body={"n_layer": 2, "block": {"n_head": 4, "resid_pdrop": 0.0}},
                head={"n_layer": 2, "block": {"n_head": 4, "resid_pdrop": 0.0}}, ema=0.9999)
    if text:
        arch.update(vocab_size_cond=530, block_size_cond=8)  # the synthetic BPE's 527 ids and [PAD]
    return arch


def stage2_config(arch: dict, folder: str, cc3m: str, text: bool) -> dict:
    dataset = ({"dataset": "cc3m", "root": cc3m, "txt_tok_name": "simple", "context_length": 8,
                "transforms": "dalle-vqvae", "image_resolution": 64} if text
               else {"type": "imagenet", "root": folder, "transforms": {"type": "ffhq64x64"}})
    return {"dataset": dataset, "arch": arch, "experiment": {"batch_size": 2, "epochs": 1, "test_freq": 1}}


@pytest.fixture(scope="module", params=[False, True], ids=["class", "text"])
def stage2(request, folder, frozen_stage1, tmp_path_factory):
    text = request.param
    cc3m = make_cc3m(str(tmp_path_factory.mktemp("cc3m")))
    mp = pytest.MonkeyPatch()
    mp.setenv("RQVAE_TPU_TOKENIZER_DIR", cc3m)
    mp.setattr(jtokenizers, "_DEFAULT_DIRS", (cc3m,))
    try:
        jmodel, variables, vqvae = frozen_stage1
        arch = stage2_arch(text)
        cfg = stage2_config(arch, folder, cc3m, text)
        loss = dict(use_soft_target=True, temp=1.0, stochastic_codes=False, amp_bf16=False)
        make = jdata.create_datasets if text else jdata.create_dataset
        jtrn, jval = make(JConfig(cfg))
        jt = JL.Stage2Trainer(
            config=JConfig(cfg), tconf=JTransformerConfig.create(augment_arch_defaults(Config(arch)).to_dict()),
            loss_cfg=J2.Stage2LossConfig(**loss), tx=j_create_optimizer(S2_OPTIM, _schedule(j_create_schedule)),
            encode_fn=J2.make_frozen_encode_fn(jmodel, variables, dtype=None),
            vq_state=variables["codebook"]["state"], vq_config=jmodel.quantizer_config, dataset_trn=jtrn,
            dataset_val=jval, logger=LOG, grad_accum_steps=2, seed=0)
        init = jax.device_get(jt.state)
        tconf = TransformerConfig.create(augment_arch_defaults(Config(arch)))

        def port():
            state = from_jax.stage2_state_from_jax(init, tconf, S2_OPTIM, _schedule(create_schedule), device="cpu")
            make_t = tdata.create_datasets if text else tdata.create_dataset
            trn, val = make_t(Config(cfg))
            with mock.patch.dict(os.environ, {"SMOKE_TEST": "1"}):  # the loaders in this process
                return TL.Stage2Trainer(model=state.model, loss_cfg=T2.Stage2LossConfig(**loss),
                                        optim_config=S2_OPTIM, schedule=_schedule(create_schedule),
                                        encode_fn=T2.make_frozen_encode_fn(vqvae, dtype=None),
                                        quantizer=vqvae.quantizer, config=Config(cfg), dataset_trn=trn,
                                        dataset_val=val, logger=LOG, grad_accum_steps=2, seed=0)

        pt = port()
        summaries = {name: (t.train_epoch(0), t.eval_epoch(0)) for name, t in (("jax", jt), ("port", pt))}
        yield dict(text=text, summaries=summaries, pt=pt, port=port, loss=loss, vqvae=vqvae)
    finally:
        mp.undo()


def test_stage2_epoch_and_eval_match_jax(stage2):
    (jtrain, jval), (ptrain, pval) = stage2["summaries"]["jax"], stage2["summaries"]["port"]
    _compare_summary(ptrain, jtrain, TL.Stage2Trainer.METRIC_NAMES)
    _compare_summary(pval, jval, ["loss_total", "loss_img", "loss_txt"])
    assert (float(ptrain["loss_txt"]) > 0) == stage2["text"]
    assert stage2["pt"].state.step == 3 and len(stage2["pt"].loader_trn) == 3


def test_stage2_epoch_equals_its_own_steps(stage2):
    pt = stage2["pt"]
    manual = stage2["port"]()
    step = T2.make_train_step(T2.Stage2LossConfig(**stage2["loss"]), encode_fn=T2.make_frozen_encode_fn(
        stage2["vqvae"], dtype=None), quantizer=stage2["vqvae"].quantizer, grad_accum_steps=2)
    gen = torch.Generator().manual_seed(1)
    manual.loader_trn.set_epoch(0)
    state, losses = manual.state, []
    for batch in manual.loader_trn:
        assert batch["images"].shape == (4, 3, 64, 64)
        assert batch["cond"].shape == ((4, 8) if stage2["text"] else (4,)) and batch["cond"].dtype == torch.int64
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss_total"]))
    assert float(stage2["summaries"]["port"][0]["loss_total"]) == pytest.approx(np.mean(losses), rel=1e-12)
    for (k, a), b in zip(pt.state.model.state_dict().items(), state.model.state_dict().values(), strict=True):
        assert torch.equal(a, b), k
    for k in pt.state.ema:
        assert torch.equal(pt.state.ema[k], state.ema[k]), k


def test_metrics_flush_every_fifty_steps(monkeypatch):
    """The loop moves its buffered metrics to the host once per FLUSH_EVERY
    steps and at the end, not once a step."""
    calls = []

    class Loop(TL._Loop):
        pass

    loop = Loop()
    loop.writer, loop.device, loop.logger = TL.Writer(None), torch.device("cpu"), LOG
    loop.loader_trn = [{"x": torch.tensor(float(i))} for i in range(120)]
    loop.loader_trn = type("L", (list,), {"batch_size": 1})(loop.loader_trn)
    last = loop._run_steps(0, lambda b: ({"loss": b["x"] * 2}, None), lambda n, v, c: calls.append(v[:, 0].tolist()))
    assert [len(c) for c in calls] == [50, 50, 20] and sum(calls, []) == [2.0 * i for i in range(120)]
    assert float(last["x"]) == 119 and loop.epoch_stats["steps"] == 120 and len(loop.epoch_stats["step_ms"]) == 119
