"""JAX (rqvae_tpu) parameter trees -> the port's state_dicts, numpy only.

Mirrors rqvae_tpu/checkpoint/torch_export.py (export_rqvae,
export_rqtransformer) without importing it: the port never imports JAX or
rqvae_tpu, so the mapping is restated here and tests/test_torch_*.py hold
the two equal key for key and value for value. Inputs are the JAX trees
with numpy leaves (jax.device_get of the params); outputs load into
RQTransformer / RQVAE with strict=True once made torch tensors.

A quantized JAX tree (the output of quantize_transformer_params, with
QuantizedWeight(q, scale) leaves) maps in two parts: its state_dict holds
each quantized weight dequantized (q * scale in fp32), and
rqtransformer_int8_from_jax gives the int8 buffers exactly, for
RQTransformer.load_int8.

stage2_state_from_jax and stage1_state_from_jax carry a whole training
state across (the only functions here that build torch objects): the
parameters, their EMA, the steps and optax's moments, each tree mapped as
the parameters are; stage 1 also the codebook state and its EMA, and the
discriminator with its BatchNorm statistics and its own optimizer.
discriminator_state_dict_from_jax and lpips_state_dict_from_jax map the
stage-1 losses' trees; inception_state_dict_from_jax and
clip_state_dict_from_jax the evaluation nets' (metrics/inception.py, whose
keys are the pytorch-fid checkpoint's, and metrics/clip_model.py, whose
keys are the OpenAI CLIP checkpoint's).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _is_quantized(x) -> bool:
    """A JAX QuantizedWeight(q, scale) leaf (a NamedTuple, matched by fields)."""
    return hasattr(x, "_fields") and tuple(x._fields) == ("q", "scale")


def _np32(x) -> np.ndarray:
    if _is_quantized(x):
        return np.asarray(x.q, np.float32) * np.asarray(x.scale, np.float32)
    return np.asarray(x, np.float32)


def _layer(x, i) -> np.ndarray:
    """Layer i of a stacked [L, ...] leaf, a QuantizedWeight too, as fp32."""
    return _np32(type(x)(x.q[i], x.scale[i]) if _is_quantized(x) else x[i])


def _q8(w, i=None, transpose: bool = True):
    """(int8 q, fp32 scale) of QuantizedWeight w, layer i of a stacked tree:
    q [in, out] -> [out, in] when `transpose`, scale [..., 1, out] -> [out]."""
    q, scale = np.asarray(w.q), np.asarray(w.scale, np.float32)
    if i is not None:
        q, scale = q[i], scale[i]
    return (q.T if transpose else q).astype(np.int8), scale[..., 0, :]


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _conv(sd, key: str, node: dict) -> None:
    # flax kernel [kh, kw, in, out] -> torch weight [out, in, kh, kw]
    sd[f"{key}.weight"] = _np32(node["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in node:
        sd[f"{key}.bias"] = _np32(node["bias"])


def _norm(sd, key: str, node: dict) -> None:
    sd[f"{key}.weight"] = _np32(node["norm"]["scale"])
    sd[f"{key}.bias"] = _np32(node["norm"]["bias"])


def _resblock(sd, key: str, node: dict) -> None:
    _norm(sd, f"{key}.norm1", node["norm1"])
    _conv(sd, f"{key}.conv1", node["conv1"])
    _norm(sd, f"{key}.norm2", node["norm2"])
    _conv(sd, f"{key}.conv2", node["conv2"])
    for shortcut in ("nin_shortcut", "conv_shortcut"):
        if shortcut in node:
            _conv(sd, f"{key}.{shortcut}", node[shortcut])


def _attnblock(sd, key: str, node: dict) -> None:
    _norm(sd, f"{key}.norm", node["norm"])
    for name in ("q", "k", "v", "proj_out"):
        _conv(sd, f"{key}.{name}", node[name])


def _coder(sd, params: dict, prefix: str, updown: str) -> None:
    """flax names {up,down}_{i}_{block,attn}_{j} / _{up,down}sample ->
    {prefix}{up,down}.{i}.{block,attn}.{j} / .{up,down}sample.conv"""
    _conv(sd, f"{prefix}conv_in", params["conv_in"])
    for name, node in params.items():
        if not name.startswith(f"{updown}_"):
            continue
        parts = name.split("_")
        level, kind = parts[1], parts[2]
        if kind == "block":
            _resblock(sd, f"{prefix}{updown}.{level}.block.{parts[3]}", node)
        elif kind == "attn":
            _attnblock(sd, f"{prefix}{updown}.{level}.attn.{parts[3]}", node)
        elif kind in ("downsample", "upsample"):
            _conv(sd, f"{prefix}{updown}.{level}.{kind}.conv", node["conv"])
    _resblock(sd, f"{prefix}mid.block_1", params["mid_block_1"])
    _attnblock(sd, f"{prefix}mid.attn_1", params["mid_attn_1"])
    _resblock(sd, f"{prefix}mid.block_2", params["mid_block_2"])
    _norm(sd, f"{prefix}norm_out", params["norm_out"])
    _conv(sd, f"{prefix}conv_out", params["conv_out"])


def _rqvae_params_from_jax(params_np: dict) -> Dict[str, np.ndarray]:
    """The parameter part of rqvae_state_dict_from_jax (no codebook)."""
    sd: Dict[str, np.ndarray] = {}
    _coder(sd, params_np["encoder"], "encoder.", "down")
    _coder(sd, params_np["decoder"], "decoder.", "up")
    _conv(sd, "quant_conv", params_np["quant_conv"])
    _conv(sd, "post_quant_conv", params_np["post_quant_conv"])
    return sd


def rqvae_state_dict_from_jax(params_np: dict, codebook_np, qcfg) -> Dict[str, np.ndarray]:
    """(flax RQVAE params, codebook state with embed / cluster_size /
    embed_ema, quantizer config) -> RQVAE state_dict."""
    return {**_rqvae_params_from_jax(params_np), **codebook_state_dict_from_jax(codebook_np, qcfg)}


def codebook_state_dict_from_jax(codebook_np, qcfg) -> Dict[str, np.ndarray]:
    """A CodebookState (embed / cluster_size / embed_ema) -> the RQVAE's
    quantizer.codebooks.* buffers."""
    sd: Dict[str, np.ndarray] = {}
    embed = _field(codebook_np, "embed")
    cluster_size = _field(codebook_np, "cluster_size")
    embed_ema = _field(codebook_np, "embed_ema")
    # one entry per depth, even for a shared codebook (reference layout)
    for d in range(qcfg.depth):
        b = qcfg.codebook_index(d)
        n = qcfg.n_embed[b]
        w = _np32(embed[b][:n])
        sd[f"quantizer.codebooks.{d}.weight"] = np.concatenate([w, np.zeros((1, w.shape[1]), np.float32)])
        sd[f"quantizer.codebooks.{d}.cluster_size_ema"] = _np32(cluster_size[b][:n])
        sd[f"quantizer.codebooks.{d}.embed_ema"] = _np32(embed_ema[b][:n])
    return sd


def _stack(sd, prefix: str, stack: dict) -> None:
    attn, mlp = stack["attn"], stack["mlp"]
    for i in range(np.shape(stack["ln1"]["scale"])[0]):
        b = f"{prefix}.blocks.{i}"
        sd[f"{b}.ln1.weight"] = _np32(stack["ln1"]["scale"][i])
        sd[f"{b}.ln1.bias"] = _np32(stack["ln1"]["bias"][i])
        sd[f"{b}.ln2.weight"] = _np32(stack["ln2"]["scale"][i])
        sd[f"{b}.ln2.bias"] = _np32(stack["ln2"]["bias"][i])
        for name, w, bias in (("query", "wq", "bq"), ("key", "wk", "bk"), ("value", "wv", "bv"), ("proj", "wo", "bo")):
            sd[f"{b}.attn.{name}.weight"] = _layer(attn[w], i).T
            sd[f"{b}.attn.{name}.bias"] = _np32(attn[bias][i])
        sd[f"{b}.mlp.0.weight"] = _layer(mlp["w1"], i).T
        sd[f"{b}.mlp.0.bias"] = _np32(mlp["b1"][i])
        sd[f"{b}.mlp.2.weight"] = _layer(mlp["w2"], i).T
        sd[f"{b}.mlp.2.bias"] = _np32(mlp["b2"][i])


def rqtransformer_state_dict_from_jax(params_np: dict, config) -> Dict[str, np.ndarray]:
    """Functional RQ-Transformer param tree -> RQTransformer state_dict."""
    sd: Dict[str, np.ndarray] = {
        "cond_emb.weight": _np32(params_np["cond_emb"]),
        "pos_emb_cond": _np32(params_np["pos_emb_cond"]),
        "pos_emb_hw": _np32(params_np["pos_emb_hw"]),
        "pos_emb_d": _np32(params_np["pos_emb_d"]),
    }
    _stack(sd, "body_transformer", params_np["body"])
    _stack(sd, "head_transformer", params_np["head"])
    for name in ("input_mlp", "head_mlp"):
        if name in params_np:
            sd[f"{name}.weight"] = _np32(params_np[name]["kernel"]).T
            sd[f"{name}.bias"] = _np32(params_np[name]["bias"])
    if "tok_emb" in params_np:
        sd["tok_emb.weight"] = _np32(params_np["tok_emb"])
        if not config.shared_tok_emb:
            sd["tok_emb.offsets"] = np.cumsum([0] + list(config.vocab_size[:-1])).astype(np.int64)
    cls = params_np["classifier"]
    sd["classifier.layer_norm.weight"] = _np32(cls["ln_scale"])
    sd["classifier.layer_norm.bias"] = _np32(cls["ln_bias"])
    k = _np32(cls["kernel"])
    # per-depth weights stay [D, in, out]; nn.Linear wants [out, in]
    sd["classifier.linear.weight"] = k if k.ndim == 3 else k.T
    sd["classifier.linear.bias"] = _np32(cls["bias"])
    if "cond_classifier" in params_np:
        cc = params_np["cond_classifier"]
        sd["cond_classifier.layer_norm.weight"] = _np32(cc["ln_scale"])
        sd["cond_classifier.layer_norm.bias"] = _np32(cc["ln_bias"])
        sd["cond_classifier.linear.weight"] = _np32(cc["kernel"]).T
        sd["cond_classifier.linear.bias"] = _np32(cc["bias"])
    return sd


def rqtransformer_int8_from_jax(qparams_np: dict) -> Dict[str, np.ndarray]:
    """Quantized JAX tree (quantize_transformer_params) -> the port's int8
    buffers {name: array} for RQTransformer.load_int8: per block the fused
    wqkv (wq, wk, wv concatenated along the output, as split_layer_params
    does), wo, w1, w2 as int8 [out, in] with fp32 scales [out] holding the
    bf16 values; the classifier's weight_q in the weight's own layout
    ([V, C] shared, [D, C, V] per depth) with scales [V] / [D, V]."""
    out: Dict[str, np.ndarray] = {}
    for prefix, name in (("body_transformer", "body"), ("head_transformer", "head")):
        attn, mlp = qparams_np[name]["attn"], qparams_np[name]["mlp"]
        for i in range(np.shape(attn["wq"].q)[0]):
            b = f"{prefix}.blocks.{i}"
            parts = [_q8(attn[w], i) for w in ("wq", "wk", "wv")]
            out[f"{b}.wqkv_q"] = np.concatenate([q for q, _ in parts])
            out[f"{b}.wqkv_s"] = np.concatenate([s for _, s in parts])
            for key, w in (("wo", attn["wo"]), ("w1", mlp["w1"]), ("w2", mlp["w2"])):
                out[f"{b}.{key}_q"], out[f"{b}.{key}_s"] = _q8(w, i)
    k = qparams_np["classifier"]["kernel"]
    out["classifier.weight_q"], out["classifier.weight_s"] = _q8(k, transpose=np.ndim(k.q) == 2)
    return out


def _packed_chunks_from_jax(packed) -> np.ndarray:
    """A JAX packed chunk stack [nc, a, b] (tools/exp_q8_pipeline.py
    pack_w1 / pack_w2) as the port's [nc, b, a]: each chunk transposed from
    the JAX [in, out] layout to the nn.Linear [out, in] one. An int32 stack
    (JAX's int8 bytes viewed as int32 along the last dim) is transposed as
    its int8 bytes and viewed back as int32 along the port's last dim."""
    p = np.asarray(packed)
    if p.dtype == np.int32:
        b = p.view(np.int8)
        return np.ascontiguousarray(b.transpose(0, 2, 1)).view(np.int32)
    return np.ascontiguousarray(p.transpose(0, 2, 1))


def q8_pipeline_weights_from_jax(wo=None, w1=None, w2=None, w1_packed=None, w2_packed=None) -> Dict[str, np.ndarray]:
    """The arrays of tools/exp_q8_pipeline.py as the port's
    (rqvae_tpu_torch/ops/q8_pipeline_kernel.py), numpy only. wo, w1, w2:
    QuantizedWeights of [C, C], [C, H], [H, C] ([in, out]) -> "wo_q" [C, C],
    "w1_q" [H, C], "w2_q" [C, H] int8 and "wo_s", "w1_s", "w2_s" fp32 [out].
    w1_packed [nc, C, chunk], w2_packed [nc, chunk, C] (int8, bf16 or fp32,
    or int8 bytes viewed as int32) -> "w1_packed" [nc, chunk, C], "w2_packed"
    [nc, C, chunk], the port's pack_w1 / pack_w2 layout. Absent arguments are
    left out."""
    out = {}
    for name, w in (("wo", wo), ("w1", w1), ("w2", w2)):
        if w is not None:
            out[f"{name}_q"], out[f"{name}_s"] = _q8(w)
    for name, p in (("w1_packed", w1_packed), ("w2_packed", w2_packed)):
        if p is not None:
            out[name] = _packed_chunks_from_jax(p)
    return out


def mlp_weights_from_jax(w1, b1, w2, b2) -> Dict[str, np.ndarray]:
    """The arrays of tools/exp_mlp_kernel.py as the port's
    (rqvae_tpu_torch/ops/mlp_kernel.py), numpy only: w1 [C, H] and w2 [H,
    C] ([in, out], bf16 or fp32) -> "w1" [H, C] and "w2" [C, H]; b1 ([H] or
    [1, H]) -> "b1" [H]; b2 -> "b2" [C]. Values as fp32 (exact for bf16)."""
    return {
        "w1": np.ascontiguousarray(_np32(w1).T),
        "b1": _np32(b1).reshape(-1),
        "w2": np.ascontiguousarray(_np32(w2).T),
        "b2": _np32(b2).reshape(-1),
    }


def _optax_states(tree, fields: tuple) -> list:
    """The optax state nodes (NamedTuples) with exactly `fields` in an
    optax state tree of nested tuples."""
    if hasattr(tree, "_fields"):
        return [tree] if tuple(tree._fields) == fields else []
    if isinstance(tree, (tuple, list)):
        return [s for t in tree for s in _optax_states(t, fields)]
    return []


def _load_optax(optimizer, named_params, opt_state, tensors) -> None:
    """Put optax's state `opt_state` (adam's mu, nu and count, or sgd's
    trace and the schedule's count) into `optimizer`, whose parameters are
    named_params [(name, p)]; tensors(tree) maps a params-shaped tree to
    {name: tensor}."""
    group = optimizer.param_groups[0]
    if group["kind"] == "sgd":
        (trace,), (sched,) = _optax_states(opt_state, ("trace",)), _optax_states(opt_state, ("count",))
        moments, count = {"trace": tensors(trace.trace)}, int(sched.count)
    else:
        (adam,) = _optax_states(opt_state, ("count", "mu", "nu"))
        (sched,) = _optax_states(opt_state, ("count",))
        moments, count = {"mu": tensors(adam.mu), "nu": tensors(adam.nu)}, int(adam.count)
        if int(sched.count) != count:
            raise ValueError(f"adam's count {count} and the schedule's {int(sched.count)} differ")
    for name, p in named_params:
        optimizer.state[p] = {k: v[name] for k, v in moments.items()}
    group["count"] = count


def stage2_state_from_jax(state_np, config, optim_config, schedule, device=None):
    """A JAX Stage2State (rqvae_tpu/trainers/trainer_stage2.py, leaves as
    numpy: jax.device_get) -> the port's Stage2State on `device` (CUDA when
    None): its params in a new RQTransformer(config), the EMA params,
    `step`, and the optimizer of `optim_config` / `schedule` holding
    optax's state: adam's mu, nu and count, or sgd's trace and the
    schedule's count. Every params-shaped tree maps through
    rqtransformer_state_dict_from_jax."""
    import torch

    from rqvae_tpu_torch.models.rqtransformer.model import RQTransformer
    from rqvae_tpu_torch.trainers.trainer_stage2 import init_state

    model = RQTransformer(config, device=device)
    names = [name for name, _ in model.named_parameters()]

    def tensors(tree) -> dict:
        sd = rqtransformer_state_dict_from_jax(tree, config)
        return {k: torch.from_numpy(np.array(v, copy=True)).to(model.pos_emb_hw.device) for k, v in sd.items()}

    model.load_state_dict(tensors(_field(state_np, "params")), strict=True)
    model.fuse_qkv()
    ema_np = _field(state_np, "ema_params")
    state = init_state(model, optim_config, schedule, use_ema=ema_np is not None)
    if ema_np is not None:
        ema = tensors(ema_np)
        state.ema = {k: ema[k] for k in names}
    state.step = int(_field(state_np, "step"))
    _load_optax(state.optimizer, list(model.named_parameters()), _field(state_np, "opt_state"), tensors)
    return state


def discriminator_state_dict_from_jax(params_np: dict, batch_stats_np=None, n_layers: int = 3) -> Dict[str, np.ndarray]:
    """flax NLayerDiscriminator params (conv_0, conv_{n}, norm_{n}, conv_out)
    and batch_stats (norm_{n}: mean, var) -> the port's state_dict in the
    reference's main.{i} layout: conv_n at main.{3n - 1}, norm_n at
    main.{3n}, conv_out at main.{3 n_layers + 2}. An ActNorm's loc / scale
    [1, 1, 1, C] become [1, C, 1, 1], marked initialized (JAX uses them as
    they are); a BatchNorm's scale / bias become weight / bias and, given
    batch_stats, its statistics running_mean / running_var
    (num_batches_tracked 0)."""
    sd: Dict[str, np.ndarray] = {}
    convs = [("conv_0", 0)] + [(f"conv_{n}", 3 * n - 1) for n in range(1, n_layers + 1)]
    for name, i in convs + [("conv_out", 3 * n_layers + 2)]:
        _conv(sd, f"main.{i}", params_np[name])
    for n in range(1, n_layers + 1):
        node, key = params_np[f"norm_{n}"], f"main.{3 * n}"
        if "loc" in node:
            sd[f"{key}.loc"] = _np32(node["loc"]).transpose(0, 3, 1, 2)
            sd[f"{key}.scale"] = _np32(node["scale"]).transpose(0, 3, 1, 2)
            sd[f"{key}.initialized"] = np.array(1, np.uint8)
            continue
        sd[f"{key}.weight"] = _np32(node["scale"])
        sd[f"{key}.bias"] = _np32(node["bias"])
        if batch_stats_np is None:  # an optimizer's moments: parameters alone
            continue
        stats = batch_stats_np[f"norm_{n}"]
        sd[f"{key}.running_mean"] = _np32(stats["mean"])
        sd[f"{key}.running_var"] = _np32(stats["var"])
        sd[f"{key}.num_batches_tracked"] = np.array(0, np.int64)
    return sd


# flax VGG16Features conv{slice}_{i} -> torchvision features index
_VGG_INDEX = {"conv0_0": 0, "conv0_1": 2, "conv1_0": 5, "conv1_1": 7, "conv2_0": 10, "conv2_1": 12, "conv2_2": 14,
              "conv3_0": 17, "conv3_1": 19, "conv3_2": 21, "conv4_0": 24, "conv4_1": 26, "conv4_2": 28}


def lpips_state_dict_from_jax(params_np: dict) -> Dict[str, np.ndarray]:
    """flax LPIPS params (net.conv{s}_{i}, lin{k} [C, 1]) -> the port's
    LPIPS state_dict (net.features.{idx}, lin{k}.model.1.weight [1, C, 1,
    1])."""
    sd: Dict[str, np.ndarray] = {}
    for name, idx in _VGG_INDEX.items():
        _conv(sd, f"net.features.{idx}", params_np["net"][name])
    for k in range(5):
        sd[f"lin{k}.model.1.weight"] = _np32(params_np[f"lin{k}"]).T[:, :, None, None]
    return sd


def stage1_state_from_jax(state_np, hparams, ddconfig, disc_kwargs: dict, optim_config, schedule, disc_optim_config,
                          disc_schedule, device=None, use_kernel: bool = True):
    """A JAX Stage1State (rqvae_tpu/trainers/trainer_stage1.py, leaves as
    numpy) -> the port's Stage1State on `device` (CUDA when None): the
    params and codebook state in a new RQVAE(hparams, ddconfig), the
    discriminator's params and batch_stats in a new
    NLayerDiscriminator(**disc_kwargs), both optimizers holding optax's
    states, the EMA of the params and of the codebook, `step` and
    `disc_step`."""
    import torch

    from rqvae_tpu_torch.losses.discriminator import NLayerDiscriminator
    from rqvae_tpu_torch.models.rqvae.model import RQVAE
    from rqvae_tpu_torch.trainers.trainer_stage1 import init_state

    model = RQVAE(hparams, ddconfig, device=device, use_kernel=use_kernel)
    disc = NLayerDiscriminator(**disc_kwargs, device=device)
    dev = model.quant_conv.weight.device
    qcfg = model.quantizer.config

    def to_dev(sd: dict) -> dict:
        return {k: torch.from_numpy(np.array(v, copy=True)).to(dev) for k, v in sd.items()}

    def rqvae_tensors(params, codebook) -> dict:
        return to_dev(rqvae_state_dict_from_jax(params, _field(codebook, "state"), qcfg))

    def disc_tensors(params, batch_stats=None) -> dict:
        return to_dev(discriminator_state_dict_from_jax(params, batch_stats, disc.n_layers))

    codebook = _field(state_np, "codebook")
    model.load_state_dict(rqvae_tensors(_field(state_np, "params"), codebook), strict=True)
    disc.load_state_dict(disc_tensors(_field(state_np, "disc_params"), _field(state_np, "disc_batch_stats")),
                         strict=True)
    ema_np = _field(state_np, "ema_params")
    state = init_state(model, disc, optim_config, schedule, disc_optim_config, disc_schedule,
                       use_ema=ema_np is not None)
    if ema_np is not None:
        ema = rqvae_tensors(ema_np, _field(state_np, "ema_codebook"))
        state.ema = {k: ema[k] for k in state.ema}
    state.step = int(_field(state_np, "step"))
    state.disc_step = int(_field(state_np, "disc_step"))
    _load_optax(state.optimizer, list(model.named_parameters()), _field(state_np, "opt_state"),
                lambda tree: to_dev(_rqvae_params_from_jax(tree)))
    _load_optax(state.disc_optimizer, list(disc.named_parameters()), _field(state_np, "disc_opt_state"),
                disc_tensors)
    return state


def inception_state_dict_from_jax(params_np: dict) -> Dict[str, np.ndarray]:
    """flax FIDInceptionV3 params (BasicConv: conv.kernel, bn_scale, bn_bias,
    bn_mean, bn_var; fc) -> the port's FIDInceptionV3 state_dict."""
    sd: Dict[str, np.ndarray] = {}

    def walk(node: dict, prefix: str) -> None:
        if "bn_scale" in node:
            _conv(sd, f"{prefix}.conv", node["conv"])
            for ours, theirs in (("weight", "bn_scale"), ("bias", "bn_bias"), ("running_mean", "bn_mean"),
                                 ("running_var", "bn_var")):
                sd[f"{prefix}.bn.{ours}"] = _np32(node[theirs])
            sd[f"{prefix}.bn.num_batches_tracked"] = np.zeros((), np.int64)
            return
        for k, v in node.items():
            walk(v, f"{prefix}.{k}" if prefix else k)

    walk({k: v for k, v in params_np.items() if k != "fc"}, "")
    sd["fc.weight"] = _np32(params_np["fc"]["kernel"]).T
    sd["fc.bias"] = _np32(params_np["fc"]["bias"])
    return sd


def _clip_block(sd, prefix: str, blocks: dict, i: int) -> None:
    """Layer i of the JAX CLIP's stacked blocks -> one OpenAI resblock."""
    def leaf(k):
        return _np32(blocks[k][i])

    sd[f"{prefix}.ln_1.weight"], sd[f"{prefix}.ln_1.bias"] = leaf("ln1_scale"), leaf("ln1_bias")
    sd[f"{prefix}.attn.in_proj_weight"], sd[f"{prefix}.attn.in_proj_bias"] = leaf("w_in").T, leaf("b_in")
    sd[f"{prefix}.attn.out_proj.weight"], sd[f"{prefix}.attn.out_proj.bias"] = leaf("w_out").T, leaf("b_out")
    sd[f"{prefix}.ln_2.weight"], sd[f"{prefix}.ln_2.bias"] = leaf("ln2_scale"), leaf("ln2_bias")
    sd[f"{prefix}.mlp.c_fc.weight"], sd[f"{prefix}.mlp.c_fc.bias"] = leaf("w1").T, leaf("b1")
    sd[f"{prefix}.mlp.c_proj.weight"], sd[f"{prefix}.mlp.c_proj.bias"] = leaf("w2").T, leaf("b2")


def clip_state_dict_from_jax(params_np: dict) -> Dict[str, np.ndarray]:
    """The JAX CLIP's params (rqvae_tpu/metrics/clip_model.py: "visual" and
    "text" with stacked [L, ...] blocks) -> the port's CLIP state_dict (the
    OpenAI layout)."""
    v, t = params_np["visual"], params_np["text"]
    sd: Dict[str, np.ndarray] = {
        "visual.conv1.weight": _np32(v["conv"]).transpose(3, 2, 0, 1),
        "visual.class_embedding": _np32(v["class_emb"]),
        "visual.positional_embedding": _np32(v["pos_emb"]),
        "visual.ln_pre.weight": _np32(v["ln_pre_scale"]),
        "visual.ln_pre.bias": _np32(v["ln_pre_bias"]),
        "visual.ln_post.weight": _np32(v["ln_post_scale"]),
        "visual.ln_post.bias": _np32(v["ln_post_bias"]),
        "visual.proj": _np32(v["proj"]),
        "token_embedding.weight": _np32(t["token_emb"]),
        "positional_embedding": _np32(t["pos_emb"]),
        "ln_final.weight": _np32(t["ln_final_scale"]),
        "ln_final.bias": _np32(t["ln_final_bias"]),
        "text_projection": _np32(t["text_proj"]),
    }
    for i in range(np.shape(v["blocks"]["w_in"])[0]):
        _clip_block(sd, f"visual.transformer.resblocks.{i}", v["blocks"], i)
    for i in range(np.shape(t["blocks"]["w_in"])[0]):
        _clip_block(sd, f"transformer.resblocks.{i}", t["blocks"], i)
    return sd
