"""Sampling throughput of the model zoo: the port of cli/measure_throughput.py.

Builds an RQ-VAE (f32/f16/f8 geometry) and an RQ-Transformer
(huge/large/medium/small/650M, or the body-only vqgan_* stacks) from the
reference measure_throughput zoo, with random bf16 weights from a seed, and
times sampling (`sample`: temperature 1, no top-k, top-p as given) and the
RQ-VAE decode (`decode_code`, in chunks of about 100 images) per sample
over n_loop loops. Geometries of more than 128 positions (f16: 16x16) run
the stacked-cache sampler, as the JAX sampler resolves it. The JAX CLI's
environment knobs (the decode policy) are not ported: this is its run with
no environment set.

    python -m rqvae_tpu_torch.cli.measure_throughput f=16 model=vqgan_huge d=1 c=16384 batch_size=100

Arguments are key=value: f model d c batch_size n_loop warmup
samples_per_loop cond_len vocab_cond top_p int8, as the JAX CLI, plus
device (default: the first CUDA device; device=cpu runs on the CPU).
"""

from __future__ import annotations

import sys
import time

import torch

from rqvae_tpu_torch import resolve_device
from rqvae_tpu_torch.models.rqtransformer import sampling as S
from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
from rqvae_tpu_torch.models.rqtransformer.model import RQTransformer
from rqvae_tpu_torch.models.rqvae.model import RQVAE, RQVAEHParams
from rqvae_tpu_torch.models.rqvae.modules import DDConfig

DTYPE = torch.bfloat16

RQVAE_GEOM = {  # f -> (latent hw, ch_mult, attn res)  (reference rq_defaults.yaml)
    32: (8, [1, 1, 2, 2, 4, 4], 8),
    16: (16, [1, 1, 2, 2, 4], 16),
    8: (32, [1, 2, 2, 4], 32),
}

TRANSFORMERS = {  # model -> (embed_dim, body_d>1, head_d>1, body_d1, n_head)
    # reference zoo (measure_throughput/__main__.py:69-211)
    "huge": (1536, 42, 6, 48, 24),    # 1400M
    "large": (1536, 24, 4, 28, 24),   # 800M
    "medium": (1024, 24, 4, 28, 16),  # 350M
    "small": (512, 24, 4, 28, 8),     # 90M
    # the cc3m text-conditional 650M (embed 1280, body 26, head 4, 20 heads);
    # pair with cond_len=32 vocab_cond=16384 for the text geometry
    "650M": (1280, 26, 4, 26, 20),
}

# the reference's VQGAN baselines: body-only stacks pinned to one f16-d1
# geometry, (embed_dim, body_n_layer, n_head, f, codebook). vqgan_large has
# head size 104, an instantiation of the decode attention kernels of its
# path (the stacked-cache sampler) as 64 is
VQGAN_TRANSFORMERS = {
    "vqgan_large": (1664, 24, 16, 16, 1024),   # 800M,  f16-d1-c1024
    "vqgan_huge": (1536, 48, 24, 16, 16384),   # 1400M, f16-d1-c16384
}


def build(f, model_name, depth, codebook_size, cond_len=1, vocab_cond=1000, device=None, dtype=None):
    """(RQVAE on `device` in `dtype`, its weights not initialised yet, and
    the RQ-Transformer's TransformerConfig) of one zoo row."""
    hw, ch_mult, attn_res = RQVAE_GEOM[f]
    hparams = RQVAEHParams.create(dict(
        bottleneck_type="rq", embed_dim=256, n_embed=codebook_size,
        latent_shape=[hw, hw, 256], code_shape=[hw, hw, depth],
        shared_codebook=True, decay=0.99, restart_unused_codes=True,
        loss_type="mse", latent_loss_weight=0.25,
    ))
    ddconfig = DDConfig.create(dict(
        double_z=False, z_channels=256, resolution=256, in_channels=3,
        out_ch=3, ch=128, ch_mult=ch_mult, num_res_blocks=2,
        attn_resolutions=[attn_res], dropout=0.0,
    ))
    vqvae = RQVAE(hparams, ddconfig, device=device, dtype=dtype)

    if model_name in VQGAN_TRANSFORMERS:
        embed_dim, body_l_d1, n_head, f_req, c_req = VQGAN_TRANSFORMERS[model_name]
        if f != f_req or depth != 1 or codebook_size != c_req:
            raise ValueError(f"{model_name} only works with f{f_req}-d1-c{c_req}")
        body_l, head_l = body_l_d1, 0
    else:
        embed_dim, body_l, head_l, body_l_d1, n_head = TRANSFORMERS[model_name]
    arch = dict(
        type="rq-transformer",
        vocab_size=codebook_size,
        block_size=[hw, hw, depth],
        embed_dim=embed_dim,
        input_embed_dim=256,
        shared_tok_emb=True, shared_cls_emb=True,
        input_emb_vqvae=True, head_emb_vqvae=True, cumsum_depth_ctx=True,
        vocab_size_cond=vocab_cond, block_size_cond=cond_len,
        body={"n_layer": body_l if depth > 1 else body_l_d1, "block": {"n_head": n_head}},
        head={"n_layer": head_l if depth > 1 else 0, "block": {"n_head": n_head}},
    )
    return vqvae, TransformerConfig.create(arch)


def main(argv=None) -> None:
    kv = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    f = int(kv.get("f", 32))
    model_name = kv.get("model", "huge")
    depth = int(kv.get("d", 4))
    codebook_size = int(kv.get("c", 16384))
    batch_size = int(kv.get("batch_size", 50))
    n_loop = int(kv.get("n_loop", 6))
    warmup = int(kv.get("warmup", 1))
    samples_per_loop = int(kv.get("samples_per_loop", 1000))
    # text-conditional geometry: a cond_len-token prompt prefix prefills the
    # body, lengthening its sequence to cond_len + H*W
    cond_len = int(kv.get("cond_len", 1))
    vocab_cond = int(kv.get("vocab_cond", 16384 if cond_len > 1 else 1000))
    top_p = float(kv["top_p"]) if "top_p" in kv else None
    device = resolve_device(kv.get("device"))

    vqvae, tconf = build(f, model_name, depth, codebook_size, cond_len, vocab_cond, device=device, dtype=DTYPE)
    model = RQTransformer(tconf, device=device, dtype=DTYPE)
    gen = torch.Generator(device=device).manual_seed(0)
    vqvae.init_weights(gen)
    model.init_weights(gen)
    # int8=1: weight-only int8 quantization of the transformer
    if kv.get("int8") in ("1", "true", "yes"):
        model.quantize_int8()
        print("int8 weight-only quantization ON")

    n_ar = sum(p.numel() for p in model.parameters())
    n_vq = sum(p.numel() for p in vqvae.parameters())
    title = f"f{f}-{model_name}-d{depth}-c{codebook_size}-bs{batch_size}"
    if cond_len > 1:
        title += f"-cond{cond_len}"
    print(f"{title} | backend {device.type}")
    print(f"rqvae size: {n_vq/1e6:.1f}M, rqtransformer size: {n_ar/1e6:.1f}M")

    cond = torch.zeros(batch_size, cond_len, dtype=torch.long, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def sample_fn(seed):
        return S.sample(
            model, batch_size, torch.Generator(device=device).manual_seed(seed), cond=cond,
            quantizer=vqvae.quantizer, temperature=1.0, top_k=None, top_p=top_p,
        )

    # decode in chunks of batch_size // (batch_size // 100) images (100 at
    # bs100), as the JAX CLI
    chunk = max(1, batch_size // max(1, batch_size // 100))

    @torch.no_grad()
    def decode_fn(codes):
        return torch.cat([(0.5 * vqvae.decode_code(c) + 0.5).clamp(0, 1) for c in codes.split(chunk)])

    n_iter = max(1, samples_per_loop // batch_size)
    speeds = []
    for loop_idx in range(n_loop):
        t_ar = t_dec = 0.0
        t0 = time.time()
        for i in range(n_iter):
            ta = time.time()
            codes = sample_fn(loop_idx * 1000 + i)
            sync()
            tb = time.time()
            decode_fn(codes)
            sync()
            tc = time.time()
            t_ar += tb - ta
            t_dec += tc - tb
        dt = time.time() - t0
        speed = dt / (n_iter * batch_size) * 1000
        print(
            f"{loop_idx+1}/{n_loop} | {speed:.1f} ms/sample "
            f"(ar: {t_ar/(n_iter*batch_size)*1000:.1f}, "
            f"decode: {t_dec/(n_iter*batch_size)*1000:.1f})",
            flush=True,
        )
        if loop_idx >= warmup:
            speeds.append(speed)
    print("-" * 80)
    print(f"{title} | {sum(speeds)/len(speeds):.4f} ms/sample")


if __name__ == "__main__":
    main()
