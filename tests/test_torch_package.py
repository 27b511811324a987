"""Packaging rules of the port: rqvae_tpu_torch imports without JAX, flax,
rqvae_tpu, yaml, PIL, safetensors or the HuggingFace tokenizers, and
chip_smoke.py fails without a CUDA device."""

import os
import pkgutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    import rqvae_tpu_torch

    names = ["rqvae_tpu_torch"]
    for info in pkgutil.walk_packages(rqvae_tpu_torch.__path__, "rqvae_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_with_jax_blocked():
    names = _modules()
    for name in ("models.rqtransformer.sampling", "models.ema", "optim.schedule", "optim.optimizer",
                 "trainers.trainer_stage2", "trainers.accumulator", "models", "metrics.inception", "metrics.fid",
                 "metrics.is_score", "metrics.clip_model", "metrics.clip_score", "data.clip_tokenizer",
                 "utils.config", "cli.common", "cli.main_sampling_fid", "cli.compute_metrics", "data",
                 "data.image_io", "data.transforms", "data.datasets", "data.tokenizers", "data.textimg",
                 "data.loader", "utils.setup", "trainers.loops", "cli.main_stage1", "cli.main_stage2",
                 "cli.compute_rfid", "cli.main_sampling_txt2img", "parallel", "parallel.dist",
                 "tools.train_convergence", "parallel.mesh", "tools.dryrun_3p8b"):
        assert f"rqvae_tpu_torch.{name}" in names
    code = (
        "import sys\n"
        "for blocked in ('jax', 'jaxlib', 'flax', 'rqvae_tpu', 'yaml', 'PIL', 'safetensors', 'tokenizers'):\n"
        "    sys.modules[blocked] = None\n"
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print('imported', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


def test_chip_smoke_fails_without_a_cuda_device():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_modules_build_on_cuda_by_default_and_never_fall_back(monkeypatch):
    """Without a `device`, RQTransformer, RQVAE and RQCodebooks build on CUDA;
    where CUDA is absent they raise instead of building on the CPU."""
    import pytest
    import torch

    from rqvae_tpu_torch import resolve_device
    from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
    from rqvae_tpu_torch.models.rqtransformer.model import RQTransformer
    from rqvae_tpu_torch.models.rqvae.model import RQVAE, RQVAEHParams
    from rqvae_tpu_torch.models.rqvae.modules import DDConfig
    from rqvae_tpu_torch.ops.quantize import QuantizerConfig, RQCodebooks

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = dict(type="rq-transformer", vocab_size=16, block_size=[2, 2, 2], embed_dim=64,
                body={"n_layer": 1, "block": {"n_head": 1}}, head={"n_layer": 1, "block": {"n_head": 1}})
    dd = DDConfig.create(dict(double_z=False, z_channels=4, resolution=8, in_channels=3, out_ch=3, ch=8,
                              ch_mult=[1], num_res_blocks=1, attn_resolutions=[], dropout=0.0))
    hp = RQVAEHParams.create(dict(embed_dim=4, n_embed=8, latent_shape=[8, 8, 4], code_shape=[8, 8, 2]))
    qcfg = QuantizerConfig.create(latent_shape=(8, 8, 4), code_shape=(8, 8, 2), n_embed=8)
    for build in (lambda: RQTransformer(TransformerConfig.create(arch)), lambda: RQVAE(hp, dd),
                  lambda: RQCodebooks(qcfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)
