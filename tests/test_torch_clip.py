"""The port's CLIP, its checkpoint layouts, its preprocessing and the BPE
tokenizer against the JAX package, in fp32 on the CPU.

A small CLIPConfig (vision width 64, 2 layers of 4 heads, 32-pixel images
of 16-pixel patches; text width 48, 2 layers of 3 heads, vocabulary 99,
context 16; embedding 24) with seeded parameters in the JAX layout, carried
into the port by from_jax.clip_state_dict_from_jax, and from the OpenAI and
HuggingFace state_dicts through the port's converters and through JAX's.
Tolerances: embeddings and scores within 2e-5 (O(1) fp32 values through
two pre-LN layers); preprocess_images within one uint8 step of JAX's PIL
path everywhere and off by that step on at most 1% of the values (PIL
rounds its fixed-point filter weights); tokens equal.
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.data import clip_tokenizer as jtok
from rqvae_tpu.metrics import clip_model as JC
from rqvae_tpu.metrics import clip_score as JS
from rqvae_tpu_torch.checkpoint.from_jax import clip_state_dict_from_jax
from rqvae_tpu_torch.data import clip_tokenizer as ttok
from rqvae_tpu_torch.metrics import clip_model as TC
from rqvae_tpu_torch.metrics import clip_score as TS

CFG = TC.CLIPConfig(image_size=32, patch_size=16, vision_width=64, vision_layers=2, vision_heads=4, text_width=48,
                    text_layers=2, text_heads=3, vocab_size=99, context_length=16, embed_dim=24)
TOL = 2e-5


def jax_params(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)

    def n(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def blocks(W, L):
        return {"ln1_scale": 1 + n(L, W), "ln1_bias": n(L, W), "w_in": n(L, W, 3 * W, s=W**-0.5), "b_in": n(L, 3 * W),
                "w_out": n(L, W, W, s=W**-0.5), "b_out": n(L, W), "ln2_scale": 1 + n(L, W), "ln2_bias": n(L, W),
                "w1": n(L, W, 4 * W, s=W**-0.5), "b1": n(L, 4 * W), "w2": n(L, 4 * W, W, s=(4 * W) ** -0.5),
                "b2": n(L, W)}

    W, TW, p, g = CFG.vision_width, CFG.text_width, CFG.patch_size, CFG.image_size // CFG.patch_size
    return {
        "visual": {"conv": n(p, p, 3, W, s=(3 * p * p) ** -0.5), "class_emb": n(W, s=1.0), "pos_emb": n(g * g + 1, W),
                   "ln_pre_scale": 1 + n(W), "ln_pre_bias": n(W), "blocks": blocks(W, CFG.vision_layers),
                   "ln_post_scale": 1 + n(W), "ln_post_bias": n(W), "proj": n(W, CFG.embed_dim, s=W**-0.5)},
        "text": {"token_emb": n(CFG.vocab_size, TW, s=1.0), "pos_emb": n(CFG.context_length, TW),
                 "blocks": blocks(TW, CFG.text_layers), "ln_final_scale": 1 + n(TW), "ln_final_bias": n(TW),
                 "text_proj": n(TW, CFG.embed_dim, s=TW**-0.5)},
    }


def jax_config():
    return JC.CLIPConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})


def tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def hf_layout(openai_sd: dict, spelling: str = "pre_layrnorm") -> dict:
    """The HuggingFace CLIPModel state_dict of an OpenAI-layout one."""
    sd = {
        "vision_model.embeddings.patch_embedding.weight": openai_sd["visual.conv1.weight"],
        "vision_model.embeddings.class_embedding": openai_sd["visual.class_embedding"],
        "vision_model.embeddings.position_embedding.weight": openai_sd["visual.positional_embedding"],
        "vision_model.embeddings.position_ids": torch.arange(5)[None],
        f"vision_model.{spelling}.weight": openai_sd["visual.ln_pre.weight"],
        f"vision_model.{spelling}.bias": openai_sd["visual.ln_pre.bias"],
        "vision_model.post_layernorm.weight": openai_sd["visual.ln_post.weight"],
        "vision_model.post_layernorm.bias": openai_sd["visual.ln_post.bias"],
        "visual_projection.weight": openai_sd["visual.proj"].T.contiguous(),
        "text_model.embeddings.token_embedding.weight": openai_sd["token_embedding.weight"],
        "text_model.embeddings.position_embedding.weight": openai_sd["positional_embedding"],
        "text_model.final_layer_norm.weight": openai_sd["ln_final.weight"],
        "text_model.final_layer_norm.bias": openai_sd["ln_final.bias"],
        "text_projection.weight": openai_sd["text_projection"].T.contiguous(),
        "logit_scale": torch.tensor(4.6),
    }
    for ours, theirs, L in (("visual.transformer.resblocks", "vision_model.encoder.layers", CFG.vision_layers),
                            ("transformer.resblocks", "text_model.encoder.layers", CFG.text_layers)):
        for i in range(L):
            a, b = f"{ours}.{i}", f"{theirs}.{i}"
            for k in ("weight", "bias"):
                for x, part in zip("qkv", openai_sd[f"{a}.attn.in_proj_{k}"].chunk(3, dim=0)):
                    sd[f"{b}.self_attn.{x}_proj.{k}"] = part.contiguous()
                sd[f"{b}.self_attn.out_proj.{k}"] = openai_sd[f"{a}.attn.out_proj.{k}"]
                sd[f"{b}.layer_norm1.{k}"] = openai_sd[f"{a}.ln_1.{k}"]
                sd[f"{b}.layer_norm2.{k}"] = openai_sd[f"{a}.ln_2.{k}"]
                sd[f"{b}.mlp.fc1.{k}"] = openai_sd[f"{a}.mlp.c_fc.{k}"]
                sd[f"{b}.mlp.fc2.{k}"] = openai_sd[f"{a}.mlp.c_proj.{k}"]
    return sd


@pytest.fixture(scope="module")
def pair():
    params = jax_params()
    model = TC.build_clip(tensors(clip_state_dict_from_jax(params)), CFG, device="cpu")
    return params, model


def inputs(seed: int = 0):
    rng = np.random.RandomState(seed)
    pixels = rng.standard_normal((3, CFG.image_size, CFG.image_size, 3)).astype(np.float32)
    tokens = rng.randint(1, CFG.vocab_size - 1, (3, CFG.context_length)).astype(np.int32)
    for i, p in enumerate((3, 9, CFG.context_length - 1)):  # eot (the max id) once a row, zeros after it
        tokens[i, p] = CFG.vocab_size - 1
        tokens[i, p + 1 :] = 0
    return pixels, tokens


def port_outputs(model, pixels, tokens):
    with torch.no_grad():
        px = torch.from_numpy(pixels).permute(0, 3, 1, 2)
        tk = torch.from_numpy(tokens).long()
        return model.encode_image(px).numpy(), model.encode_text(tk).numpy(), TC.clip_scores(model, px, tk).numpy()


def jax_outputs(params, config, pixels, tokens):
    img = JC.encode_image(params, config, jnp.asarray(pixels))
    txt = JC.encode_text(params, config, jnp.asarray(tokens))
    return np.asarray(img), np.asarray(txt), np.asarray(JC.clip_scores(params, config, jnp.asarray(pixels),
                                                                       jnp.asarray(tokens)))


def test_clip_from_jax_params_matches_jax(pair):
    params, model = pair
    pixels, tokens = inputs()
    got = port_outputs(model, pixels, tokens)
    want = jax_outputs(params, jax_config(), pixels, tokens)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    assert np.abs(want[2]).max() > 0.05


@pytest.mark.parametrize("layout", ["openai", "hf", "hf_pre_layernorm"])
@pytest.mark.parametrize("via", ["direct", "sniffed"])
def test_torch_layouts_load_and_match_jax(pair, layout, via):
    """Each checkpoint layout through the port's converter (its own or
    convert_torch_clip's dispatch) loads strictly into the same weights,
    and JAX's converter of the same state_dict gives the same outputs."""
    _, model = pair
    openai_sd = dict(model.state_dict())
    openai_sd.update({"logit_scale": torch.tensor(4.6), "input_resolution": torch.tensor(32)})  # extras are dropped
    sd = openai_sd if layout == "openai" else hf_layout(openai_sd, "pre_layrnorm" if layout == "hf" else
                                                        "pre_layernorm")
    heads = dict(vision_heads=CFG.vision_heads, text_heads=CFG.text_heads)
    if via == "direct":
        convert = TC.convert_openai_clip if layout == "openai" else TC.convert_hf_clip
        got_sd, config = convert(sd, **heads)
    else:
        got_sd, config = TC.convert_torch_clip(sd)
        assert config.vision_heads == CFG.vision_width // 64  # the head-size-64 default
        config = TC.CLIPConfig(**{**config.__dict__, **heads})
    assert config == CFG
    got = TC.build_clip(got_sd, config, device="cpu")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)
    jconvert = JC.convert_openai_clip if layout == "openai" else JC.convert_hf_clip
    jparams, jcfg = jconvert(sd, **heads)
    pixels, tokens = inputs(1)
    for g, w in zip(port_outputs(got, pixels, tokens), jax_outputs(jparams, jcfg, pixels, tokens)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


def test_unknown_layout_raises():
    with pytest.raises(ValueError, match="unrecognized CLIP state_dict layout"):
        TC.convert_torch_clip({"encoder.weight": torch.zeros(1)})


@pytest.mark.parametrize("hw_s", [(48, 40, 32), (64, 64, 32), (20, 30, 32), (256, 256, 224), (100, 37, 64)])
def test_preprocess_matches_jax_pil_path(hw_s):
    h, w, s = hw_s
    rng = np.random.RandomState(h * w)
    x = rng.rand(3, h, w, 3).astype(np.float32)
    x[0] = np.round(x[0] * 4) / 4  # hard edges: the bicubic overshoots and clips
    want = JC.preprocess_images(x, s)
    got = TC.preprocess_images(torch.from_numpy(x).permute(0, 3, 1, 2), s).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (3, s, s, 3)
    step = 1 / 255 / np.asarray(TC.IMAGE_STD, np.float32)
    diff = np.abs(got - want)
    assert (diff <= step * (1 + 1e-4) + 1e-6).all()
    assert (diff > 1e-5).mean() <= 0.01


def write_merges(path, merges):
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")


MERGES = [("t", "h"), ("th", "e</w>"), ("a", "t</w>"), ("c", "at</w>"), ("s", "a"), ("sa", "t</w>"), ("o", "n</w>"),
          ("h", "e"), ("m", "a"), ("ma", "t</w>"), ("d", "o"), ("do", "g</w>")]
TEXTS = ["The cat sat on the mat.", "  a DOG,   the   dog!! ", "café &amp; 42 cats", "",
         "the cat " * 12]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bpe") / "bpe_simple_vocab_16e6.txt.gz")
    write_merges(path, MERGES)
    return ttok.SimpleTokenizer(bpe_path=path), jtok.SimpleTokenizer(bpe_path=path), path


def test_simple_tokenizer_matches_jax(tokenizers):
    port, jax_tok, _ = tokenizers
    assert port.encoder == jax_tok.encoder and (port.sot, port.eot) == (jax_tok.sot, jax_tok.eot)
    for text in TEXTS:
        ids = port.encode(text).ids
        assert ids == jax_tok.encode(text).ids
        assert port.decode(ids) == jax_tok.decode(ids)
    for tok in (port, jax_tok):
        tok.enable_truncation(8)
        tok.enable_padding(10, pad_id=0)
    for text in TEXTS:
        assert port.encode(text).ids == jax_tok.encode(text).ids
        assert len(port.encode(text).ids) == 10


def test_find_reads_the_tokenizer_dir(tokenizers, monkeypatch):
    _, _, path = tokenizers
    import os

    monkeypatch.setattr(ttok, "_DEFAULT_DIRS", (os.path.dirname(path),))
    assert ttok._find("bpe_simple_vocab_16e6.txt.gz") == path
    with pytest.raises(FileNotFoundError, match="RQVAE_TPU_TOKENIZER_DIR"):
        ttok._find("missing.txt")


def test_scorer_tokenize_and_scores_match_jax(pair, tokenizers):
    """CLIPScorer.tokenize (context 16: the long text truncates, its last
    slot becomes eot) and the scores of 32-pixel images, NHWC and NCHW (no
    resize at image size 32, so the pixels match JAX's exactly)."""
    params, model = pair
    _, _, path = tokenizers
    big = TC.CLIPConfig(**{**CFG.__dict__, "vocab_size": 49408})  # the BPE ids reach past 99
    jparams = jax_params()
    jparams["text"]["token_emb"] = np.random.RandomState(9).standard_normal((49408, CFG.text_width)).astype(
        np.float32)
    port_model = TC.build_clip(tensors(clip_state_dict_from_jax(jparams)), big, device="cpu")
    port = TS.CLIPScorer(port_model, ttok.SimpleTokenizer(bpe_path=path))
    jax_scorer = JS.CLIPScorer(jax.tree.map(jnp.asarray, jparams), JC.CLIPConfig(**big.__dict__),
                               jtok.SimpleTokenizer(bpe_path=path))
    texts = TEXTS[:3] + [TEXTS[4]]
    tokens = port.tokenize(texts)
    np.testing.assert_array_equal(tokens, jax_scorer.tokenize(texts))
    assert tokens[3, -1] == port.tokenizer.eot and tokens.dtype == np.int32
    pixels01 = np.random.RandomState(2).rand(4, 32, 32, 3).astype(np.float32)
    want = jax_scorer(pixels01, texts)
    np.testing.assert_allclose(port(pixels01, texts), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(TS.clip_score(pixels01.transpose(0, 3, 1, 2), texts, port), want, atol=TOL, rtol=0)


def test_load_clip_reads_each_file_form(pair, tokenizers, tmp_path, monkeypatch):
    """load_clip from RQVAE_TPU_CLIP_DIR: a torch.save'd OpenAI state_dict
    (.pt), a TorchScript archive of it (the published ViT-B-32.pt's form)
    and a HuggingFace .safetensors, each with the merges file beside it;
    read_safetensors equals the safetensors package's reader."""
    safetensors_torch = pytest.importorskip("safetensors.torch")
    _, model = pair
    _, _, merges = tokenizers
    sd = dict(model.state_dict())
    heads = CFG.vision_width // 64, CFG.text_width // 64  # what the loader infers
    want = TC.build_clip(*TC.convert_openai_clip(sd, *heads), device="cpu").state_dict()

    def check(directory):
        import shutil

        shutil.copy(merges, directory / "bpe_simple_vocab_16e6.txt.gz")
        monkeypatch.setenv("RQVAE_TPU_CLIP_DIR", str(directory))
        scorer = TS.load_clip(device="cpu")
        for k, v in want.items():
            torch.testing.assert_close(scorer.model.state_dict()[k], v, rtol=0, atol=0)
        assert scorer.tokenizer.encode("the cat").ids == jtok.SimpleTokenizer(bpe_path=merges).encode("the cat").ids

    pt = tmp_path / "pt"
    pt.mkdir()
    torch.save(sd, pt / "ViT-B-32.pt")
    check(pt)

    script = tmp_path / "script"
    script.mkdir()
    traced = torch.jit.trace_module(model, {"encode_text": torch.ones(1, CFG.context_length, dtype=torch.long)})
    assert set(traced.state_dict()) == set(sd)
    traced.save(str(script / "ViT-B-32.pt"))
    assert TS._is_torchscript(str(script / "ViT-B-32.pt")) and not TS._is_torchscript(str(pt / "ViT-B-32.pt"))
    check(script)

    st = tmp_path / "st"
    st.mkdir()
    hf = {k: v.contiguous() for k, v in hf_layout(sd).items()}
    safetensors_torch.save_file(hf, str(st / "model.safetensors"))
    got = TS.read_safetensors(str(st / "model.safetensors"))
    ref = safetensors_torch.load_file(str(st / "model.safetensors"))
    assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) and got[k].dtype == ref[k].dtype for k in ref)
    check(st)


def test_read_safetensors_dtypes(tmp_path):
    safetensors_torch = pytest.importorskip("safetensors.torch")
    ts = {"f16": torch.randn(3, 2).half(), "bf16": torch.randn(4).bfloat16(), "i8": torch.arange(-3, 3).to(torch.int8),
          "i64": torch.arange(5), "b": torch.tensor([True, False]), "empty": torch.zeros(0, 3),
          "scalar": torch.tensor(2.5, dtype=torch.float64)}
    safetensors_torch.save_file(ts, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got = TS.read_safetensors(str(tmp_path / "x.safetensors"))
    for k, v in ts.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k


def test_load_clip_without_weights_and_compute_clip_score_raise(monkeypatch, tmp_path):
    monkeypatch.delenv("RQVAE_TPU_CLIP_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="RQVAE_TPU_CLIP_DIR"):
        TS.load_clip(device="cpu")
    with pytest.raises(FileNotFoundError, match="no torch weights"):
        TS._load_state_dict(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="RQVAE_TPU_CLIP_DIR"):
        TS.compute_clip_score(str(tmp_path), "cc3m", device="cpu")
