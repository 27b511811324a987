"""The port's training and dataset CLIs end to end on the CPU, and the
config / setup helpers they stand on, against the JAX package.

  - config_setup, augment_dist_defaults and Config.to_yaml: the JAX
    functions' dicts, to_yaml read back equal by parse_yaml and by
    yaml.safe_load;
  - setup: the result directory, config.yaml, train.log and the source
    snapshot; the Writer's scalars.jsonl without tensorboard; make_grid;
  - main_stage1 (SMOKE_TEST=1, --device cpu, the synthetic stage-1
    geometry with a PatchGAN of ndf 8 and the discriminator from epoch 1)
    for 2 epochs -> weights/step_1/model.pt + config.yaml, which
    cli.common.load_model_from_ckpt reads back; a run stopped after its
    first epoch and continued with --resume ends bit-equal (fp32, CPU) to
    the unbroken run: weights, EMA, both optimizers, the discriminator's
    BatchNorm statistics and the generator state;
  - main_stage2 on that model.pt (vqvae.ckpt=), class-conditional and
    text-conditional (a cc3m caption folder, the 'simple' BPE on a
    synthetic merges file); the text run's resume likewise bit-equal;
  - compute_rfid on the folder from the stage-1 model.pt;
  - main_sampling_txt2img on the text-conditional model.pt at --top-k 1
    (the one determined draw) against JAX's cli/main_sampling_txt2img.py
    on the same checkpoint: samples within 5e-5 (the same codes through
    two fp32 decoders that sum in other orders: 1.1e-5 seen with torch on
    one thread, under 1e-5 on eight); then compute_clip_score with synthetic
    CLIP weights equals scoring the samples directly.
"""

import argparse
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import yaml

from rqvae_tpu.utils import config as JC
from rqvae_tpu.utils import setup as JS
from rqvae_tpu_torch.cli import compute_metrics, compute_rfid, main_sampling_fid, main_sampling_txt2img, main_stage1, main_stage2
from rqvae_tpu_torch.cli.common import load_ar_and_vqvae, load_model_from_ckpt
from rqvae_tpu_torch.metrics import clip_model as CM
from rqvae_tpu_torch.metrics import clip_score as TS
from rqvae_tpu_torch.metrics.fid import load_samples_from_files
from rqvae_tpu_torch.trainers import loops as TL
from rqvae_tpu_torch.utils import config as TC
from rqvae_tpu_torch.utils import setup as TSU
from test_torch_config import synth_stage2
from test_torch_data import make_folder, one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_loops import make_cc3m, stage2_arch
from test_torch_rqtransformer import GOLDENS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(GOLDENS, "synth_ckpt")
GAN = {"disc": {"arch": {"in_channels": 3, "num_layers": 2, "use_actnorm": False, "ndf": 8},
                "optimizer": {"type": "adam", "init_lr": 1.0e-4, "weight_decay": 0.0, "betas": [0.5, 0.9],
                              "warmup": {"epoch": 0, "min_lr": 1.0e-5}}},
       "loss": {"disc_loss": "hinge", "gen_loss": "vanilla", "disc_weight": 0.75, "perceptual_weight": 1.0,
                "disc_start": 1}}
S2_TRAIN = {"optimizer": {"type": "adamW", "init_lr": 1.0e-3, "weight_decay": 0.05, "betas": [0.9, 0.95],
                          "max_gn": 1.0, "warmup": {"epoch": 0.5, "min_lr": 1.0e-4, "mode": "fix", "multiplier": 1}},
            "loss": {"type": "soft_target_cross_entropy", "temp": 1.0, "stochastic_codes": True}}


def _write(path, cfg) -> str:
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return str(path)


def _stage1_config(root, folder) -> str:
    with open(os.path.join(SYNTH, "stage1", "config.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"].update(root=folder, transforms={"type": "ffhq64x64"})
    cfg["arch"]["ema"] = 0.999
    cfg["optimizer"]["init_lr"] = 1.0e-4
    cfg["experiment"].update(batch_size=2, epochs=2)
    cfg["gan"] = GAN
    return _write(os.path.join(root, "stage1.yaml"), cfg)


def _stage2_config(root, name, vq_ckpt, folder=None, cc3m=None) -> str:
    text = cc3m is not None
    dataset = ({"dataset": "cc3m", "root": cc3m, "txt_tok_name": "simple", "context_length": 8,
                "transforms": "dalle-vqvae", "image_resolution": 64, "vocab_size": 64} if text
               else {"type": "imagenet", "root": folder, "vocab_size": 64, "transforms": {"type": "ffhq64x64"}})
    arch = stage2_arch(text)
    arch["body"]["block"]["resid_pdrop"] = arch["head"]["block"]["resid_pdrop"] = 0.1  # dropout draws
    cfg = {"dataset": dataset, "arch": arch, "vqvae": {"ckpt": vq_ckpt}, **S2_TRAIN,
           "experiment": {"batch_size": 2, "total_batch_size": 4, "epochs": 2, "amp_bf16": False}}
    return _write(os.path.join(root, name), cfg)


def _result_dir(trainer) -> str:
    return trainer.config.result_path


def _assert_same_files(a: str, b: str):
    """Two torch files of the loops (nested dicts of tensors) bit-equal."""
    def same(x, y, where):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), where
        elif isinstance(x, dict):
            assert set(x) == set(y), where
            for k in x:
                same(x[k], y[k], f"{where}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, (u, v) in enumerate(zip(x, y, strict=True)):
                same(u, v, f"{where}[{i}]")
        else:
            assert x == y, where

    same(torch.load(a, weights_only=False), torch.load(b, weights_only=False), os.path.basename(a))


# -- config and setup -----------------------------------------------------------------------------------------------


def _args(**kw):
    base = dict(model_config="", result_path="", load_path="", postfix="", seed=0, eval=False, resume=False)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_config_setup_and_to_yaml_equal_jax(stage, tmp_path):
    """config_setup's three branches and augment_dist_defaults against
    JAX's; to_yaml of the result read back by parse_yaml and safe_load."""
    if stage == "stage1":
        path = _write(tmp_path / "c.yaml", {**yaml.safe_load(open(os.path.join(SYNTH, "stage1", "config.yaml"))),
                                           "gan": GAN})
    else:
        cfg = yaml.safe_load(open(os.path.dirname(synth_stage2(tmp_path)) + "/config.yaml"))
        path = _write(tmp_path / "c.yaml", {**cfg, **S2_TRAIN, "experiment": {"batch_size": 2, "total_batch_size": 8}})
    extra = ["experiment.epochs=3", "optimizer.init_lr=2.5e-05", "arch.ema=0.999", "note=a b"]
    args = _args(model_config=path, device="cpu")
    got = TC.config_setup(args, 2, path, extra)
    want = JC.config_setup(args, 2, path, extra)
    assert got.to_dict() == want.to_dict()
    assert got.optimizer.grad_accm_steps == (2 if stage == "stage2" else 1)
    text = got.to_yaml()
    assert TC.parse_yaml(text) == yaml.safe_load(text) == got.to_dict()
    resumed_path = _write(tmp_path / "r.yaml", yaml.safe_load(text))
    for kind in ("eval", "resume"):
        a = _args(model_config=resumed_path, device="cpu", **{kind: True})
        assert TC.config_setup(a, 2, resumed_path).to_dict() == JC.config_setup(a, 2, resumed_path).to_dict()
    with pytest.raises(ValueError, match="num_devices"):
        TC.config_setup(_args(resume=True), 4, resumed_path)
    bad = TC.Config({"experiment": {"batch_size": 3, "total_batch_size": 8}, "optimizer": {}})
    with pytest.raises(ValueError, match="divisible"):
        TC.augment_dist_defaults(bad, 1)
    assert TC.augment_dist_defaults(TC.Config({"experiment": {"batch_size": 3}, "optimizer": {}}), 2).to_dict() == \
        JC.augment_dist_defaults(JC.Config({"experiment": {"batch_size": 3}, "optimizer": {}}), 2).to_dict()


def test_setup_writer_and_grid(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # without tensorboard: scalars.jsonl
    cfg = TC.Config({"a": 1})
    args = _args(model_config=str(tmp_path / "my_run.yaml"), result_path=str(tmp_path / "res"), postfix="p")
    config, logger, writer = TSU.setup(args, cfg)
    result = config.result_path
    assert os.path.dirname(result) == str(tmp_path / "res" / "my_run__p")
    assert TC.load_config(os.path.join(result, "config.yaml")).to_dict() == {"a": 1, "result_path": result}
    snap = os.path.join(result, "source", "rqvae_tpu_torch")
    assert os.path.isfile(os.path.join(snap, "trainers", "loops.py"))
    assert not any("__pycache__" in d for d, _, _ in os.walk(snap))
    logger.info("hello")
    assert "hello" in open(os.path.join(result, "train.log")).read()
    writer.close()
    assert sorted(os.listdir(result)) == ["config.yaml", "scalars.jsonl", "source", "train.log"]
    # scalars.jsonl, and images nowhere
    os.makedirs(tmp_path / "w")
    w = TSU.Writer(str(tmp_path / "w"))
    w.add_scalar("loss/x", np.float32(1.5), "valid", 3)
    grid = TSU.make_grid(np.random.RandomState(0).rand(5, 4, 6, 3), nrow=2)
    np.testing.assert_array_equal(grid, JS.make_grid(np.random.RandomState(0).rand(5, 4, 6, 3), nrow=2))
    w.add_image("reconstruction_add/0-th code", grid, "train", 7)
    w.close()
    assert os.listdir(tmp_path / "w") == ["scalars.jsonl"]
    assert [yaml.safe_load(line) for line in open(tmp_path / "w" / "scalars.jsonl")] == [
        {"tag": "loss/x", "mode": "valid", "step": 3, "value": 1.5}]


def test_writer_falls_back_only_without_tensorboard(tmp_path, monkeypatch):
    """scalars.jsonl stands in for tensorboard only when it cannot be
    imported; a SummaryWriter that fails is an error, not a silent switch."""
    class Broken:
        def __init__(self, log_dir):
            raise OSError(f"cannot write {log_dir}")

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", types.SimpleNamespace(SummaryWriter=Broken))
    with pytest.raises(OSError, match="cannot write"):
        TSU.Writer(str(tmp_path))
    assert os.listdir(tmp_path) == []


# -- the training CLIs --------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    """SMOKE_TEST=1, and no tensorboard (its import pulls in TensorFlow):
    the CLIs' writers take the scalars.jsonl path."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SMOKE_TEST", "1")
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def work(tmp_path_factory, smoke):
    root = str(tmp_path_factory.mktemp("entry"))
    folder = make_folder(os.path.join(root, "imagenet"))
    cc3m = make_cc3m(os.path.join(root, "cc3m"))
    mp = pytest.MonkeyPatch()
    mp.setenv("RQVAE_TPU_TOKENIZER_DIR", cc3m)
    cfg1 = _stage1_config(root, folder)
    s1 = main_stage1.main(["-m", cfg1, "-r", os.path.join(root, "res"), "--device", "cpu"])
    w1 = os.path.join(_result_dir(s1), "weights", "step_1", "model.pt")
    cfg_t = _stage2_config(root, "text.yaml", w1, cc3m=cc3m)
    s2 = main_stage2.main(["-m", cfg_t, "-r", os.path.join(root, "res"), "--device", "cpu"])
    yield dict(root=root, folder=folder, cc3m=cc3m, cfg1=cfg1, s1=s1, w1=w1, cfg_t=cfg_t, s2=s2)
    mp.undo()


def test_stage1_cli_writes_what_the_loaders_read(work):
    s1 = work["s1"]
    for epoch in (0, 1):
        d = os.path.join(_result_dir(s1), "weights", f"step_{epoch}")
        assert sorted(os.listdir(d)) == ["config.yaml", "model.pt"]
        assert os.path.isfile(os.path.join(_result_dir(s1), "ckpt", f"step_{epoch}.pt"))
    kind, model, config = load_model_from_ckpt(work["w1"], device="cpu")
    assert kind == "rq-vae" and config.experiment.epochs == 2 and config.gan.loss.disc_start == 1
    for (k, a), b in zip(model.state_dict().items(), s1.state.model.state_dict().values(), strict=True):
        assert torch.equal(a, b), k
    ckpt = torch.load(work["w1"], weights_only=False)
    assert set(ckpt["state_dict_ema"]) == set(ckpt["state_dict"]) and ckpt["epoch"] == 1
    assert s1.state.step == 4 and s1.state.disc_step == 2  # 2 steps an epoch, the discriminator from epoch 1
    assert os.path.isfile(os.path.join(_result_dir(s1), "source", "rqvae_tpu_torch", "cli", "main_stage1.py"))


def test_entry_points_refuse_to_fall_back_to_the_cpu(work, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (main_stage1.main, main_stage2.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["-m", work["cfg1"], "-r", os.path.join(work["root"], "never")])
    for main in (compute_rfid.main, main_sampling_txt2img.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["-m", work["w1"]])
    assert not os.path.exists(os.path.join(work["root"], "never"))


def test_stage1_resume_equals_the_unbroken_run(work, monkeypatch):
    """Stopped after epoch 0's save, then --resume: epoch 1 (the
    discriminator's first) ends bit-equal to the unbroken run's."""
    real = TL.Stage1Trainer.train_epoch

    def stop(self, epoch):
        if epoch == 1:
            raise KeyboardInterrupt("stopped")
        return real(self, epoch)

    monkeypatch.setattr(TL.Stage1Trainer, "train_epoch", stop)
    with pytest.raises(KeyboardInterrupt):
        main_stage1.main(["-m", work["cfg1"], "-r", os.path.join(work["root"], "res_stop"), "--device", "cpu"])
    monkeypatch.setattr(TL.Stage1Trainer, "train_epoch", real)
    (run,) = os.listdir(os.path.join(work["root"], "res_stop", "stage1"))
    stopped = os.path.join(work["root"], "res_stop", "stage1", run)
    assert not os.path.exists(os.path.join(stopped, "ckpt", "step_1.pt"))
    resumed = main_stage1.main(["-m", os.path.join(stopped, "config.yaml"), "--resume", "--device", "cpu"])
    assert resumed.config.result_path == stopped
    unbroken = _result_dir(work["s1"])
    _assert_same_files(os.path.join(stopped, "ckpt", "step_1.pt"), os.path.join(unbroken, "ckpt", "step_1.pt"))
    _assert_same_files(os.path.join(stopped, "weights", "step_1", "model.pt"), work["w1"])


def test_stage2_cli_text_and_resume(work, monkeypatch):
    """The text-conditional run's model.pt reads back through
    load_ar_and_vqvae; a stopped run resumed ends bit-equal (stochastic
    codes and dropout draw from the resumed generator)."""
    s2 = work["s2"]
    w2 = os.path.join(_result_dir(s2), "weights", "step_1", "model.pt")
    model, vqvae, config = load_ar_and_vqvae(w2, device="cpu")
    assert model.config.block_size_cond == 8 and config.vqvae.ckpt == work["w1"]
    for (k, a), b in zip(model.state_dict().items(), s2.state.model.state_dict().values(), strict=True):
        assert torch.equal(a, b), k
    real = TL.Stage2Trainer.train_epoch

    def stop(self, epoch):
        if epoch == 1:
            raise KeyboardInterrupt("stopped")
        return real(self, epoch)

    monkeypatch.setattr(TL.Stage2Trainer, "train_epoch", stop)
    with pytest.raises(KeyboardInterrupt):
        main_stage2.main(["-m", work["cfg_t"], "-r", os.path.join(work["root"], "res_stop2"), "--device", "cpu"])
    monkeypatch.setattr(TL.Stage2Trainer, "train_epoch", real)
    (run,) = os.listdir(os.path.join(work["root"], "res_stop2", "text"))
    stopped = os.path.join(work["root"], "res_stop2", "text", run)
    main_stage2.main(["-m", os.path.join(stopped, "config.yaml"), "--resume", "--device", "cpu"])
    _assert_same_files(os.path.join(stopped, "ckpt", "step_1.pt"), os.path.join(_result_dir(s2), "ckpt", "step_1.pt"))
    _assert_same_files(os.path.join(stopped, "weights", "step_1", "model.pt"), w2)


def test_stage2_cli_class_conditional_then_sampling(work, tmp_path):
    cfg = _stage2_config(work["root"], "class.yaml", work["w1"], folder=work["folder"])
    trainer = main_stage2.main(["-m", cfg, "-r", str(tmp_path), "--device", "cpu", "experiment.epochs=1"])
    assert trainer.state.step == 2 and trainer.state.model.config.block_size_cond == 1
    w = os.path.join(_result_dir(trainer), "weights", "step_0", "model.pt")
    main_sampling_fid.main(["-m", w, "-n", "2", "-bs", "2", "-o", str(tmp_path / "s"), "--device", "cpu",
                            "--dtype", "float32", "--no-metrics", "--top-k", "1"])
    (pix,) = [pickle.load(open(tmp_path / "s" / "samples_0.pkl", "rb"))]
    assert pix.shape == (2, 3, 64, 64) and 0 <= pix.min() and pix.max() <= 1


def test_compute_rfid_cli(work, capsys, monkeypatch):
    """The CLI hands frechet_distance the statistics of the val split's
    images (eval transforms) and of their reconstructions (a spy: one
    2048-d sqrtm is test_torch_metrics_files'), and prints what it returns."""
    from rqvae_tpu_torch.data import create_dataset
    from rqvae_tpu_torch.metrics import fid as tfid
    from rqvae_tpu_torch.utils.config import augment_defaults

    seen = []
    monkeypatch.setattr(tfid, "frechet_distance", lambda *a: seen.append(a) or 7.25)
    rfid = compute_rfid.main(["-m", work["w1"], "--batch-size", "3", "--device", "cpu", "--root", work["folder"]])
    assert rfid == 7.25 and capsys.readouterr().out.splitlines()[-1] == "rFID: 7.2500"
    (mu_o, s_o, mu_r, s_r), = seen
    _, _, config = load_model_from_ckpt(work["w1"], device="cpu")
    _, val = create_dataset(augment_defaults(config), is_eval=True)
    images = np.stack([val[i][0] for i in range(len(val))])  # NHWC in [-1, 1]
    want_mu, want_sigma = tfid.mean_covar(tfid.InceptionExtractor(device="cpu").activations(images * 0.5 + 0.5))
    np.testing.assert_allclose(mu_o, want_mu, rtol=0, atol=1e-5)
    np.testing.assert_allclose(s_o, want_sigma, rtol=0, atol=1e-5 * np.abs(want_sigma).max())
    assert mu_r.shape == (2048,) and s_r.shape == (2048, 2048) and not np.allclose(mu_r, mu_o)


def _synthetic_clip(directory, merges):
    """A small CLIP in the OpenAI layout (widths 64: one head each, as the
    loader infers) with seeded weights, and the merges file beside it."""
    import shutil

    config = CM.CLIPConfig(image_size=32, patch_size=16, vision_width=64, vision_layers=1, vision_heads=1,
                           text_width=64, text_layers=1, text_heads=1, context_length=16, embed_dim=32)
    model = CM.CLIP(config, device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    os.makedirs(directory)
    torch.save(model.state_dict(), os.path.join(directory, "ViT-B-32.pt"))
    shutil.copy(merges, os.path.join(directory, "bpe_simple_vocab_16e6.txt.gz"))
    return directory


def test_txt2img_equals_jax_cli_then_clip_score(work, tmp_path, monkeypatch, capsys):
    w2 = os.path.join(_result_dir(work["s2"]), "weights", "step_1", "model.pt")
    args = ["-m", w2, "--dataset-root", work["cc3m"], "-bs", "2", "--top-k", "1", "--seed", "0"]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    env = dict(os.environ, RQVAE_TPU_CPU="1", JAX_PLATFORMS="cpu", SMOKE_TEST="1",
               RQVAE_TPU_TOKENIZER_DIR=work["cc3m"])
    res = subprocess.run([sys.executable, "cli/main_sampling_txt2img.py", *args, "-o", jax_out], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    monkeypatch.delenv("SMOKE_TEST")  # the port's run covers the whole caption set: 4 captions, 2 batches
    out = main_sampling_txt2img.main(args + ["-o", port_out, "--device", "cpu", "--dtype", "float32", "--no-kernels"])
    assert out == port_out and sorted(os.listdir(port_out)) == ["samples_00000.pkl", "samples_00001.pkl"]
    got = pickle.load(open(os.path.join(port_out, "samples_00000.pkl"), "rb"))
    want = pickle.load(open(os.path.join(jax_out, "samples_00000.pkl"), "rb"))
    assert got.shape == want.shape == (2, 3, 64, 64) and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)  # module docstring
    # the CLIP score of the samples against the captions, in order
    clip_dir = _synthetic_clip(str(tmp_path / "clip"), os.path.join(work["cc3m"], "bpe_simple_vocab_16e6.txt.gz"))
    monkeypatch.setenv("RQVAE_TPU_CLIP_DIR", clip_dir)
    score = TS.compute_clip_score(port_out, "cc3m", work["cc3m"], batch_size=3, device="cpu")
    scorer = TS.load_clip(device="cpu")
    captions = [line.split("\t")[1].strip() for line in open(os.path.join(work["cc3m"], "val_list.txt"))]
    want_score = float(scorer(load_samples_from_files(port_out), captions).mean())
    assert np.isfinite(score) and score == pytest.approx(want_score, rel=1e-6)
    got_metrics = compute_metrics.main([f"fake_path={port_out}", "dataset=cc3m", f"clip_dataset_root={work['cc3m']}",
                                        "device=cpu"])
    assert got_metrics["CLIP_score"] == pytest.approx(score, rel=1e-6)
    assert capsys.readouterr().out.splitlines()[-1] == f"CLIP_score: {score:.4f}"
