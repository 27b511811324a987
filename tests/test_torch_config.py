"""The port's config reader, config defaults and checkpoint loaders against
the JAX package, on the CPU.

load_config equals yaml.safe_load on the committed synthetic configs, on
yaml.safe_dump of them, and on written cases of each construct of its YAML
subset; constructs outside the subset raise ValueError naming the line.
merge, from_dotlist, augment_arch_defaults and augment_defaults equal
JAX's. load_rqvae and load_rqtransformer read tests/goldens/synth_ckpt
strictly, with and without EMA weights, and agree with JAX's loaders
through decode_code (within 1e-4 on pixels, as test_torch_rqvae) and
forced_logits (within 1e-4: fp32 through 4 layers and the classifier).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rqvae_tpu.models import load_rqtransformer as jload_rqtransformer
from rqvae_tpu.models import load_rqvae as jload_rqvae
from rqvae_tpu.models.rqtransformer import model as JM
from rqvae_tpu.models.rqtransformer import sampling as JS
from rqvae_tpu.models.rqvae.model import RQVAE as JRQVAE
from rqvae_tpu.utils import config as jconfig
from rqvae_tpu_torch.cli import common
from rqvae_tpu_torch.models import load_rqtransformer, load_rqvae
from rqvae_tpu_torch.models.rqtransformer import sampling as TS
from rqvae_tpu_torch.utils import config as tconfig
from test_torch_rqtransformer import GOLDENS

SYNTH = os.path.join(GOLDENS, "synth_ckpt")
CONFIGS = [os.path.join(SYNTH, s, "config.yaml") for s in ("stage1", "stage2")]


def synth_stage2(tmp_path, ema: bool = False) -> str:
    """A copy of the synthetic stage-2 checkpoint whose config names this
    checkout's stage-1 checkpoint; with `ema`, a state_dict_ema of seeded
    perturbations of its weights. Returns the model.pt path."""
    d = tmp_path / "stage2"
    d.mkdir(exist_ok=True)
    with open(os.path.join(SYNTH, "stage2", "config.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["vqvae"]["ckpt"] = os.path.join(SYNTH, "stage1", "model.pt")
    with open(d / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    if not ema:
        shutil.copy(os.path.join(SYNTH, "stage2", "model.pt"), d / "model.pt")
        return str(d / "model.pt")
    ckpt = torch.load(os.path.join(SYNTH, "stage2", "model.pt"), map_location="cpu")
    gen = torch.Generator().manual_seed(0)
    ckpt["state_dict_ema"] = {k: v + 0.05 * torch.randn(v.shape, generator=gen) if v.is_floating_point() else v
                              for k, v in ckpt["state_dict"].items()}
    torch.save(ckpt, d / "model.pt")
    return str(d / "model.pt")


@pytest.mark.parametrize("path", CONFIGS, ids=["stage1", "stage2"])
def test_committed_configs_equal_safe_load(path):
    with open(path) as f:
        text = f.read()
    want = yaml.safe_load(text)
    assert tconfig.load_config(path) == want
    for dumped in (yaml.safe_dump(want, sort_keys=False), yaml.safe_dump(want)):
        assert tconfig.parse_yaml(dumped) == want


SUBSET_CASES = {
    "nested": "a:\n  b:\n    c: 1\n  d: x\ne: 2\n",
    "flow": "s: [ 8, 8, 2 ]\nt: [0.5, 0.9]\nu: []\nv: [1, [2, 'x y'], c]\n",
    "ints": "a: 1\nb: -3\nc: +4\nd: 0x1f\ne: 017\nf: 0b101\ng: 1_000\nh: 0\ni: 08\n",
    "floats": "a: 4.0e-5\nb: 4e-5\nc: .5\nd: -.5\ne: 1.\nf: 1.5e+3\ng: 12e3\nh: .inf\ni: -.inf\n",
    "bools": "a: true\nb: True\nc: FALSE\nd: yes\ne: off\n",
    "nulls": "a: null\nb: ~\nc:\nd: Null\n",
    "strings": "a: hello world\nb: 'it''s # not a comment'\nc: \"x\\ty\\u00e9\"\nd: /abs/path/model.pt\ne: b:c\n",
    "comments": "# head\na: 1  # tail\n\n   # indented\nb: [1, 2] # after a flow\n",
    "block_seq": "a:\n- 1\n- x\nb:\n  - [2]\n  - c: 3\n    d: 4\n  -\n    - 5\n",
    "keys": "1: a\n'q k': 2\ntrue: 3\n",
    "top_seq": "- 1\n- a: 2\n",
    "empty": "",
}


@pytest.mark.parametrize("name", sorted(SUBSET_CASES))
def test_subset_constructs_equal_safe_load(name):
    text = SUBSET_CASES[name]
    got, want = tconfig.parse_yaml(text), yaml.safe_load(text)
    assert repr(got) == repr(want)


OUTSIDE_CASES = {
    "flow_mapping": ("a: 1\nb: {c: 2}\n", 2),
    "anchor": ("a: &x 1\n", 1),
    "alias": ("a: 1\nb: *x\n", 2),
    "tag": ("a: !!str 1\n", 1),
    "literal_block": ("a: |\n  text\n", 1),
    "folded_block": ("a: >\n  text\n", 1),
    "multi_line_scalar": ("a: one\n  two\n", 2),
    "document": ("---\na: 1\n", 1),
    "tab": ("a:\n\tb: 1\n", 2),
    "date": ("a: 2001-12-14\n", 1),
    "unterminated_flow": ("a: [1, 2\n", 1),
    "bad_indent": ("a:\n    b: 1\n  c: 2\n", 3),
    "not_a_mapping": ("a: 1\njust text\n", 2),
}


@pytest.mark.parametrize("name", sorted(OUTSIDE_CASES))
def test_constructs_outside_the_subset_raise(name, tmp_path):
    text, line = OUTSIDE_CASES[name]
    with pytest.raises(ValueError, match=f"line {line}"):
        tconfig.parse_yaml(text)
    (tmp_path / "c.yaml").write_text(text)
    with pytest.raises(ValueError, match="c.yaml"):
        tconfig.load_config(str(tmp_path / "c.yaml"))


def test_merge_and_from_dotlist_equal_jax():
    base = {"a": {"b": 1, "c": [1, 2]}, "d": "x"}
    over = {"a": {"c": [3], "e": None}, "f": {"g": 2.5}}
    assert tconfig.merge(base, over).to_dict() == jconfig.merge(base, over).to_dict()
    items = ["a.b=3", "a.c=[1, 2]", "d=hello", "e=4.0e-5", "f=4e-5", "g=true", "h=", "i.j.k=null", "l='q'"]
    got, want = tconfig.from_dotlist(items), jconfig.from_dotlist(items)
    assert got.to_dict() == want.to_dict()
    assert got.a.b == 3 and got.i.j.k is None
    with pytest.raises(ValueError, match="key=value"):
        tconfig.from_dotlist(["nokey"])


def test_env_flag_equals_jax(monkeypatch):
    for value in ("", "0", "false", "No", "off", "1", "yes", "x"):
        monkeypatch.setenv("RQ_TEST_FLAG", value)
        assert tconfig.env_flag("RQ_TEST_FLAG") == jconfig.env_flag("RQ_TEST_FLAG")
    monkeypatch.delenv("RQ_TEST_FLAG")
    assert tconfig.env_flag("RQ_TEST_FLAG", True) is True


def test_augment_defaults_equal_jax(tmp_path):
    ckpt = synth_stage2(tmp_path)
    stage1 = CONFIGS[0]
    for path in (stage1, os.path.join(os.path.dirname(ckpt), "config.yaml")):
        got, want = tconfig.load_config(path), jconfig.load_config(path)
        assert got.to_dict() == want.to_dict()
        assert tconfig.augment_arch_defaults(got.arch).to_dict() == jconfig.augment_arch_defaults(want.arch).to_dict()
    got, want = tconfig.load_config(stage1), jconfig.load_config(stage1)
    assert tconfig.augment_defaults(got).to_dict() == jconfig.augment_defaults(want).to_dict()
    # a stage-2 config pulls the stage-1 arch from the config beside vqvae.ckpt
    s2 = tconfig.load_config(os.path.join(os.path.dirname(ckpt), "config.yaml"))
    s2.optimizer = {"type": "adamW", "init_lr": 1e-4, "warmup": {"epoch": 0}}
    s2.loss = {"type": "soft_target_cross_entropy"}
    j2 = jconfig.Config(s2.to_dict())
    got, want = tconfig.augment_defaults(s2), jconfig.augment_defaults(j2)
    assert got.to_dict() == want.to_dict()
    assert got.vqvae.hparams.code_shape == [8, 8, 2] and got.vqvae.ckpt.endswith("stage1/model.pt")


@pytest.fixture(scope="module")
def stage1_pair():
    arch = tconfig.augment_arch_defaults(tconfig.load_config(CONFIGS[0]).arch)
    ckpt = os.path.join(SYNTH, "stage1", "model.pt")
    jmodel, jvars = jload_rqvae(jconfig.Config(arch.to_dict()), ckpt, use_kernel=False)
    return jmodel, jvars, load_rqvae(arch, ckpt, device="cpu")


def test_load_rqvae_matches_jax_through_decode_code(stage1_pair):
    jmodel, jvars, model = stage1_pair
    codes = np.random.RandomState(0).randint(0, 64, (2, 8, 8, 2))
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(codes), method=JRQVAE.decode_code))
    with torch.no_grad():
        got = model.decode_code(torch.from_numpy(codes).long()).numpy()
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("ema", [False, True], ids=["state_dict", "state_dict_ema"])
def test_load_rqtransformer_matches_jax_through_forced_logits(stage1_pair, tmp_path, monkeypatch, ema):
    jmodel, jvars, vqvae = stage1_pair
    # JAX forced_logits calls these per position: jitted once, as test_torch_stacked does
    monkeypatch.setattr(JM, "stack_step", jax.jit(JM.stack_step, static_argnums=(4,)))
    monkeypatch.setattr(JM, "stack_forward", jax.jit(JM.stack_forward, static_argnums=(2,)))
    ckpt = synth_stage2(tmp_path, ema=ema)
    arch = tconfig.augment_arch_defaults(tconfig.load_config(os.path.join(os.path.dirname(ckpt), "config.yaml")).arch)
    model = load_rqtransformer(arch, ckpt, use_ema=ema, device="cpu")
    jcfg, jparams = jload_rqtransformer(jconfig.Config(arch.to_dict()), ckpt, use_ema=ema)
    sd = torch.load(ckpt)["state_dict_ema" if ema else "state_dict"]
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())
    rng = np.random.RandomState(1)
    forced, cond = rng.randint(0, 64, (2, 8, 8, 2)), np.array([3, 7])
    want = np.asarray(JS.forced_logits(jparams, jcfg, jnp.asarray(forced), jnp.asarray(cond)[:, None],
                                       jvars["codebook"]["state"], jmodel.quantizer_config))
    got = TS.forced_logits(model, torch.from_numpy(forced).long(), torch.from_numpy(cond).long(),
                           quantizer=vqvae.quantizer).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_loaders_refuse_what_they_cannot_read(tmp_path):
    arch = tconfig.augment_arch_defaults(tconfig.load_config(CONFIGS[1]).arch)
    with pytest.raises(ValueError, match="no state_dict_ema"):
        load_rqtransformer(arch, os.path.join(SYNTH, "stage2", "model.pt"), use_ema=True, device="cpu")
    orbax = tmp_path / "ckpt" / "step_10"
    orbax.mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        load_rqtransformer(arch, str(orbax), device="cpu")
    s1 = tconfig.augment_arch_defaults(tconfig.load_config(CONFIGS[0]).arch)
    with pytest.raises(ValueError, match="Orbax"):
        load_rqvae(s1, str(orbax), device="cpu")


def test_cli_common_loads_the_pair(tmp_path):
    ckpt = synth_stage2(tmp_path, ema=True)
    model, vqvae, config = common.load_ar_and_vqvae(ckpt, use_ema=True, device="cpu", dtype=torch.float32)
    ema = torch.load(ckpt)["state_dict_ema"]
    assert all(torch.equal(v, ema[k]) for k, v in model.state_dict().items())
    sd1 = torch.load(os.path.join(SYNTH, "stage1", "model.pt"))["state_dict"]
    assert all(torch.equal(v, sd1[k]) for k, v in vqvae.state_dict().items())
    assert config.arch.vocab_size_cond == 10
    kind, m1, c1 = common.load_model_from_ckpt(os.path.join(SYNTH, "stage1", "model.pt"), device="cpu")
    assert kind == "rq-vae" and c1.arch.ddconfig.resolution == 64 and m1.hparams.code_shape == (8, 8, 2)
    with pytest.raises(ValueError, match="stage-2"):
        common.load_ar_and_vqvae(os.path.join(SYNTH, "stage1", "model.pt"), device="cpu")
    assert common.set_seed(7) == 7 and torch.initial_seed() == 7
    assert np.random.randint(1 << 30) == np.random.RandomState(7).randint(1 << 30)
