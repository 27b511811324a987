"""Packaging rules of the port: rqvae_tpu_torch imports without JAX, flax,
rqvae_tpu or yaml, and chip_smoke.py fails without a CUDA device."""

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
    assert "rqvae_tpu_torch.models.rqtransformer.sampling" in names
    code = (
        "import sys\n"
        "for blocked in ('jax', 'jaxlib', 'flax', 'rqvae_tpu', 'yaml'):\n"
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
