"""Training-convergence proof of the port's trainers: they learn, end to end.

Port of tools/train_convergence.py. The reference's trainers are validated
by its released checkpoints; here the proof is to overfit a fixed
procedural image set and close the loop:

  stage1:  train the RQ-VAE (the discriminator active from step 0, the
           adaptive GAN weight live) for STEPS1 steps on 64 fixed 256px
           images; record the loss / entropy / g_weight trajectory and a
           reconstruction grid.
  stage2:  freeze the trained RQ-VAE, encode the set, train a 512-wide
           RQ-Transformer with one class per image until the teacher-forced
           loss collapses; then sample codes per class with top_k=1, compare
           them with the training codes (match rate), decode them with the
           trained RQ-VAE and measure the pixel MSE against the originals
           beside the RQ-VAE's own reconstruction floor.
  text:    as stage2 with a caption per image (the cond_classifier's
           txt-weighted loss live), prompted with each caption.
  ab:      stage 1 twice, fp32 and amp_bf16, at the same seed and batch.

It runs the port's Stage1Trainer / Stage2Trainer step functions
(trainers/trainer_stage1.py, trainer_stage2.py) and its sampler, with
torch's default TF32 flags, as the training CLIs run. Codes come from the
nearest_code kernel on CUDA; the sampler's body and head steps run the
decode kernels (C 512, 8 heads).

Artifacts: artifacts/torch_convergence_{stage1,stage2,text}.json
(trajectory, summary, the card's name and power limit, both TF32 flags)
and .png of the same names (originals over reconstructions or decoded
samples); `ab` writes artifacts/torch_convergence_stage1_ab_bs{BS}.json.

    python -m rqvae_tpu_torch.tools.train_convergence [stage1|stage2|both|text|ab] [--device cpu]

STEPS1 / STEPS2 override the step counts (400 / 800), CONV_BS the batch
(16), PWEIGHT the perceptual weight (1.0 when RQVAE_TPU_LPIPS_VGG names the
real VGG weights, else 0: a random VGG's "perceptual" loss is noise).
The pass rules are the JAX tool's: stage 1's reconstruction loss below
0.5x its first value, stage 2's loss below 0.3x, text below 0.3x and its
caption loss below 0.5x, everything finite. tests/test_torch_convergence.py
runs the same loops at a tiny geometry on the CPU.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "artifacts")
N_IMAGES = 64
RES = 256
BS = int(os.environ.get("CONV_BS", "16"))
STEPS1 = int(os.environ.get("STEPS1", "400"))
STEPS2 = int(os.environ.get("STEPS2", "800"))
ENCODE_CHUNK = 16  # images a frozen-encode or decode call


def make_dataset(n=N_IMAGES, res=RES, seed=0):
    """Fixed procedural images in [-1, 1]: per-image random mixtures of
    oriented low-frequency sinusoids (f <= 4, which an 8x8 latent grid
    represents) + a colour-gradient background + a solid square. The JAX
    tool's function (tools/train_convergence.py), bit-equal."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res
    imgs = np.zeros((n, res, res, 3), np.float32)
    for i in range(n):
        img = np.zeros((res, res, 3), np.float32)
        c0, c1 = rs.rand(3) * 2 - 1, rs.rand(3) * 2 - 1
        g = (xx * rs.rand() + yy * rs.rand())[..., None]
        img += c0 + (c1 - c0) * g / max(g.max(), 1e-6)
        for _ in range(2):
            f = rs.uniform(1, 4)
            th = rs.uniform(0, np.pi)
            ph = rs.uniform(0, 2 * np.pi)
            wave = np.sin(2 * np.pi * f * (np.cos(th) * xx + np.sin(th) * yy) + ph)
            img += 0.25 * wave[..., None] * (rs.rand(3) * 2 - 1)
        s = int(res * rs.uniform(0.15, 0.4))
        y0, x0 = rs.randint(0, res - s, 2)
        img[y0 : y0 + s, x0 : x0 + s] = rs.rand(3) * 2 - 1
        imgs[i] = np.clip(img, -1, 1)
    return imgs


def make_captions(n_images, cond_len=8, vocab_cond=64, seed=7):
    """A unique 'caption' per image: cond_len tokens over a vocab_cond-token
    vocabulary, the first token image index mod vocab_cond. The JAX tool's
    function, bit-equal."""
    rs = np.random.RandomState(seed)
    caps = rs.randint(0, vocab_cond, (n_images, cond_len))
    caps[:, 0] = np.arange(n_images) % vocab_cond
    return caps.astype(np.int32)


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if not torch.cuda.is_available():
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
        return out[torch.cuda.current_device()] if out else torch.cuda.get_device_name()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name()


def provenance(device) -> dict:
    return {"device": str(device), "card": card() if torch.device(device).type == "cuda" else "cpu",
            "tf32": {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                     "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32},
            "torch": torch.__version__}


def save_grid(path, rows):
    """rows: [n, H, W, 3] float arrays in [-1, 1], one above the other, as
    one PNG (data/image_io.write_png)."""
    from rqvae_tpu_torch.data.image_io import write_png

    rows = [np.clip((np.asarray(r) + 1) * 127.5, 0, 255).astype(np.uint8) for r in rows]
    n, H, W = rows[0].shape[:3]
    canvas = np.zeros((len(rows) * H, n * W, 3), np.uint8)
    for r, row in enumerate(rows):
        for i in range(n):
            canvas[r * H : (r + 1) * H, i * W : (i + 1) * W] = row[i]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, canvas)
    print(f"# wrote {path}", flush=True)


def write_json(name: str, payload: dict) -> None:
    os.makedirs(ART, exist_ok=True)
    with open(os.path.join(ART, name), "w") as f:
        json.dump(payload, f, indent=1)
    print(f"# wrote {os.path.join(ART, name)}", flush=True)


def code_entropy(codes):
    """Per-depth codebook-usage entropy in bits."""
    codes = np.asarray(codes)
    out = []
    for d in range(codes.shape[-1]):
        _, counts = np.unique(codes[..., d].ravel(), return_counts=True)
        p = counts / counts.sum()
        out.append(float(-(p * np.log2(p)).sum()))
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_stage1(res=RES, small=False, device=None, p_weight=0.0):
    """(RQ-VAE, PatchGAN, LPIPS or None, both optimizers' config and
    schedule) of the JAX tool's geometry: the cIN256 8x8x4 RQ-VAE, or with
    `small` the CPU test's 32px 8x8x2 one; Adam (0.5, 0.9) at a constant
    4e-4. LPIPS only with a perceptual weight."""
    from rqvae_tpu_torch.losses.discriminator import NLayerDiscriminator
    from rqvae_tpu_torch.losses.lpips import load_lpips_params
    from rqvae_tpu_torch.models.rqvae.model import RQVAE, RQVAEHParams
    from rqvae_tpu_torch.models.rqvae.modules import DDConfig
    from rqvae_tpu_torch.optim.schedule import create_schedule

    if small:
        dd = dict(double_z=False, z_channels=16, resolution=res, in_channels=3, out_ch=3, ch=16, ch_mult=[1, 2, 2],
                  num_res_blocks=1, attn_resolutions=[8], dropout=0.0)
        hp = dict(embed_dim=16, n_embed=64, loss_type="mse", latent_shape=[res // 4, res // 4, 16],
                  code_shape=[res // 4, res // 4, 2], shared_codebook=True, restart_unused_codes=True)
    else:
        dd = dict(double_z=False, z_channels=256, resolution=res, in_channels=3, out_ch=3, ch=128,
                  ch_mult=[1, 1, 2, 2, 4, 4], num_res_blocks=2, attn_resolutions=[8], dropout=0.0)
        hp = dict(embed_dim=256, n_embed=16384, loss_type="mse", latent_shape=[8, 8, 256], code_shape=[8, 8, 4],
                  shared_codebook=True, restart_unused_codes=True)
    gen = torch.Generator(device=device).manual_seed(0)
    model = RQVAE(RQVAEHParams.create(hp), DDConfig.create(dd), device=device, use_kernel=not small)
    model.init_weights(gen)
    disc = NLayerDiscriminator(ndf=16 if small else 64, n_layers=2 if small else 3, device=device)
    disc.init_weights(gen)
    lpips = load_lpips_params(device=device)[0] if p_weight else None
    sched = create_schedule(base_lr=4e-4, warmup_config={"epoch": 0, "mode": "fix", "multiplier": 1, "min_lr": 4e-4},
                            steps_per_epoch=1000, max_epoch=10)
    opt_cfg = {"type": "adam", "betas": [0.5, 0.9], "weight_decay": 0.0}
    return model, disc, lpips, opt_cfg, sched


def _perceptual_weight(small: bool) -> float:
    if small:
        return 0.0
    return float(os.environ.get("PWEIGHT", "1.0" if os.environ.get("RQVAE_TPU_LPIPS_VGG") else "0.0"))


def run_stage1(steps=STEPS1, res=RES, bs=BS, n_images=N_IMAGES, small=False, fetch_every=20, save_artifacts=True,
               seed=0, device=None, amp_bf16=False):
    """Stage 1 on the procedural set (the RQ-VAE on bf16 weight copies with
    `amp_bf16`): (state, model, summary, data)."""
    from rqvae_tpu_torch import resolve_device
    from rqvae_tpu_torch.trainers import trainer_stage1 as T1

    device = resolve_device(device)
    p_weight = _perceptual_weight(small)
    t0 = time.time()
    model, disc, lpips, opt_cfg, sched = build_stage1(res, small, device, p_weight)
    data = make_dataset(n_images, res, seed)
    data_t = torch.from_numpy(data).to(device)
    state = T1.init_state(model, disc, opt_cfg, sched, opt_cfg, sched)
    gan_cfg = T1.GanLossConfig(disc_start=0, perceptual_weight=p_weight, amp_bf16=amp_bf16)
    step = T1.make_train_step(lpips, gan_cfg, use_discriminator=True)
    print(f"# stage1 init: {time.time() - t0:.1f}s ({'amp_bf16' if amp_bf16 else 'fp32'}, perceptual weight {p_weight})",
          flush=True)

    generator = torch.Generator(device=device).manual_seed(seed + 1)
    order_rs = np.random.RandomState(seed + 2)
    keys = ("loss_recon", "loss_pcpt", "loss_latent", "loss_gen", "loss_disc", "g_weight")
    traj = {k: [] for k in ("step", *keys, "entropy")}
    pending = []  # (step, metrics, codes) on the device, fetched at the end
    _sync(device)
    t0 = time.time()
    for s in range(steps):
        idx = order_rs.choice(n_images, bs, replace=False)
        state, metrics, codes = step(state, {"images": data_t[torch.from_numpy(idx).to(device)]}, generator)
        if s % fetch_every == 0 or s == steps - 1:
            pending.append((s, metrics, codes))
    _sync(device)
    dt = time.time() - t0
    for s, m, codes in pending:
        traj["step"].append(s)
        for k in keys:
            traj[k].append(float(m[k]))
        traj["entropy"].append(code_entropy(codes.cpu().numpy()))
    print(f"# stage1 {steps} steps in {dt:.1f}s ({dt / steps * 1e3:.1f} ms/step)", flush=True)

    with torch.no_grad():
        out, _, _ = model(data_t[:8])
    out = out.float().cpu().numpy()
    summary = {
        "steps": steps,
        "batch": bs,
        "first_loss_recon": traj["loss_recon"][0],
        "last_loss_recon": traj["loss_recon"][-1],
        "eval_recon_mse": float(np.mean(np.square(out - data[:8]))),
        "first_entropy": traj["entropy"][0],
        "last_entropy": traj["entropy"][-1],
        "max_g_weight": max(traj["g_weight"]),
        "finite": all(np.isfinite(v).all() for v in (traj["loss_recon"], traj["loss_pcpt"], traj["g_weight"])),
        "seconds": dt,
        "ms_per_step": dt / steps * 1e3,
        "amp_bf16": amp_bf16,
        "perceptual_weight": p_weight,
    }
    print("# stage1 summary:", json.dumps(summary), flush=True)
    if save_artifacts:
        write_json("torch_convergence_stage1.json", {"trajectory": traj, "summary": summary, **provenance(device)})
        save_grid(os.path.join(ART, "torch_convergence_stage1.png"), [data[:8], out])
    return state, model, summary, data


def _encode(model, data, device):
    """The frozen RQ-VAE's codes of every image, ENCODE_CHUNK at a time."""
    with torch.no_grad():
        return torch.cat([model.get_codes(torch.from_numpy(data[i : i + ENCODE_CHUNK]).to(device))
                          for i in range(0, data.shape[0], ENCODE_CHUNK)])


def _decode(model, codes):
    with torch.no_grad():
        return torch.cat([model.decode_code(codes[i : i + ENCODE_CHUNK]).float()
                          for i in range(0, codes.shape[0], ENCODE_CHUNK)]).cpu().numpy()


def build_stage2_config(code_shape, vocab, vocab_cond, cond_len=1, small=False):
    """The JAX tool's RQ-Transformer: 512 wide, 8 + 2 layers of 8 heads (128
    wide, 2 + 1 layers of 4 heads with `small`), embeddings from the
    RQ-VAE's codebook, a class (cond_len 1) or a caption to condition on."""
    from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
    from rqvae_tpu_torch.utils.config import Config, augment_arch_defaults

    h, w, d = code_shape
    arch = dict(
        type="rq-transformer", vocab_size=vocab, block_size=[h, w, d], embed_dim=128 if small else 512,
        input_embed_dim=16 if small else 256, shared_tok_emb=True, shared_cls_emb=True, input_emb_vqvae=True,
        head_emb_vqvae=True, cumsum_depth_ctx=True, vocab_size_cond=vocab_cond, block_size_cond=cond_len,
        body={"n_layer": 2 if small else 8, "block": {"n_head": 4 if small else 8}},
        head={"n_layer": 1 if small else 2, "block": {"n_head": 4 if small else 8}},
    )
    return TransformerConfig.create(augment_arch_defaults(Config(arch)).to_dict())


def _run_stage2(name, model, data, conds, config, loss_cfg, steps, bs, small, fetch_every, seed, device, traj_keys):
    """Train a stage-2 model on the frozen codes of `data` conditioned on
    `conds` [N] or [N, L], then sample the first 8 conditions at top_k 1:
    (summary, trajectory, decoded samples). The samples are drawn from
    bf16 copies of the RQ-Transformer and the codebooks, as the sampling
    CLIs draw them, and decoded by the fp32 RQ-VAE."""
    from rqvae_tpu_torch.models.rqtransformer import sampling as S
    from rqvae_tpu_torch.models.rqtransformer.model import RQTransformer
    from rqvae_tpu_torch.trainers import trainer_stage2 as T2

    n_images = data.shape[0]
    codes = _encode(model, data, device)
    print(f"# {name}: training codes {tuple(codes.shape)}", flush=True)
    ar = RQTransformer(config, device=device)
    ar.init_weights(torch.Generator(device=device).manual_seed(seed))
    optim = {"type": "adamW", "betas": [0.9, 0.95], "weight_decay": 0.0, "max_gn": 1.0}
    lr = 1e-3 if small else 3e-4
    state = T2.init_state(ar, optim, lambda _: lr)
    step = T2.make_train_step(loss_cfg, quantizer=model.quantizer)

    generator = torch.Generator(device=device).manual_seed(seed + 1)
    order_rs = np.random.RandomState(seed + 2)
    conds_t = torch.from_numpy(np.asarray(conds)).long().to(device)
    traj = {k: [] for k in ("step", *traj_keys)}
    pending = []
    _sync(device)
    t0 = time.time()
    for s in range(steps):
        idx = torch.from_numpy(order_rs.choice(n_images, bs, replace=False)).to(device)
        state, metrics = step(state, {"codes": codes[idx], "cond": conds_t[idx]}, generator)
        if s % fetch_every == 0 or s == steps - 1:
            pending.append((s, metrics))
    _sync(device)
    dt = time.time() - t0
    for s, m in pending:
        traj["step"].append(s)
        for k in traj_keys:
            traj[k].append(float(m[k]))
    print(f"# {name} {steps} steps in {dt:.1f}s ({dt / steps * 1e3:.1f} ms/step)", flush=True)

    # sample as the sampling CLIs do by default: bf16 copies of both models, the decode kernels' dtype
    n_show = min(8, n_images)
    ar16, quant16 = copy.deepcopy(ar).to(torch.bfloat16), copy.deepcopy(model.quantizer).to(torch.bfloat16)
    _sync(device)
    t1 = time.time()
    with torch.no_grad():
        sampled = S.sample(ar16, n_show, torch.Generator(device=device).manual_seed(seed + 3), cond=conds_t[:n_show],
                           quantizer=quant16, temperature=1.0, top_k=1)
    _sync(device)
    sample_s = time.time() - t1
    want = codes[:n_show]
    pix = _decode(model, sampled)
    recon = _decode(model, want)
    summary = {
        "steps": steps,
        "batch": bs,
        "first_loss": traj["loss_total"][0],
        "last_loss": traj["loss_total"][-1],
        "code_match_rate": float((sampled == want).double().mean()),
        "sampled_pixel_mse": float(np.mean(np.square(pix - data[:n_show]))),
        "rqvae_recon_mse_floor": float(np.mean(np.square(recon - data[:n_show]))),
        "seconds": dt,
        "ms_per_step": dt / steps * 1e3,
        "sample_seconds": sample_s,
    }
    return summary, traj, pix


def run_stage2(stage1_state, model, data, steps=STEPS2, bs=BS, small=False, fetch_every=20, save_artifacts=True,
               seed=10, device=None):
    """A class-per-image RQ-Transformer on the trained stage-1 codes, and
    the closed loop: sample(top_k=1) -> decode -> compare."""
    from rqvae_tpu_torch.trainers import trainer_stage2 as T2

    device = model.quant_conv.weight.device if device is None else torch.device(device)
    n_images = data.shape[0]
    config = build_stage2_config(model.quantizer.config.code_shape, model.quantizer.config.n_embed[0], n_images,
                                 small=small)
    summary, traj, pix = _run_stage2("stage2", model, data, np.arange(n_images), config,
                                     T2.Stage2LossConfig(use_soft_target=False), steps, bs, small, fetch_every, seed,
                                     device, ("loss_total",))
    print("# stage2 summary:", json.dumps(summary), flush=True)
    if save_artifacts:
        write_json("torch_convergence_stage2.json", {"trajectory": traj, "summary": summary, **provenance(device)})
        save_grid(os.path.join(ART, "torch_convergence_stage2.png"), [data[: pix.shape[0]], pix])
    return summary


def run_stage2_text(stage1_state, model, data, steps=STEPS2, bs=BS, small=False, fetch_every=20,
                    save_artifacts=True, seed=20, cond_len=8, vocab_cond=64, device=None):
    """A caption-per-image RQ-Transformer with the cond_classifier's
    txt-weighted loss live (the cc3m configs' txt_weight), and the closed
    loop: prompt -> sample(top_k=1) -> decode -> compare."""
    from rqvae_tpu_torch.trainers import trainer_stage2 as T2

    device = model.quant_conv.weight.device if device is None else torch.device(device)
    captions = make_captions(data.shape[0], cond_len, vocab_cond)
    config = build_stage2_config(model.quantizer.config.code_shape, model.quantizer.config.n_embed[0], vocab_cond,
                                 cond_len, small)
    loss_cfg = T2.Stage2LossConfig(use_soft_target=False, txt_weight=0.1, img_weight=0.9)
    summary, traj, pix = _run_stage2("stage2-text", model, data, captions, config, loss_cfg, steps, bs, small,
                                     fetch_every, seed, device, ("loss_total", "loss_txt"))
    summary = {"cond_len": cond_len, "vocab_cond": vocab_cond, **summary, "first_loss_txt": traj["loss_txt"][0],
               "last_loss_txt": traj["loss_txt"][-1]}
    print("# stage2-text summary:", json.dumps(summary), flush=True)
    if save_artifacts:
        write_json("torch_convergence_text.json", {"trajectory": traj, "summary": summary, **provenance(device)})
        save_grid(os.path.join(ART, "torch_convergence_text.png"), [data[: pix.shape[0]], pix])
    return summary


def run_stage1_ab(steps=STEPS1, bs=BS, device=None):
    """Stage 1 in fp32 and in amp_bf16 at the same seed, data and steps: amp
    tracks fp32 when both are finite, both halve the reconstruction loss
    and amp's last loss is within 25% of fp32's."""
    runs = {}
    for name, amp in (("fp32", False), ("amp_bf16", True)):
        t0 = time.time()
        _, _, summary, _ = run_stage1(steps=steps, bs=bs, save_artifacts=False, device=device, amp_bf16=amp)
        summary["wall_s"] = time.time() - t0
        runs[name] = summary
        print(f"# ab[{name}] bs{bs}: recon {summary['first_loss_recon']:.4f} -> {summary['last_loss_recon']:.4f} "
              f"(eval mse {summary['eval_recon_mse']:.4f})", flush=True)
    ratio = runs["amp_bf16"]["last_loss_recon"] / max(runs["fp32"]["last_loss_recon"], 1e-9)
    out = {"bs": bs, "steps": steps, "runs": runs, "amp_over_fp32_last_recon": ratio}
    from rqvae_tpu_torch import resolve_device

    write_json(f"torch_convergence_stage1_ab_bs{bs}.json", {**out, **provenance(resolve_device(device))})
    ok = (runs["fp32"]["finite"] and runs["amp_bf16"]["finite"]
          and runs["amp_bf16"]["last_loss_recon"] < 0.5 * runs["amp_bf16"]["first_loss_recon"]
          and 0.75 < ratio < 1.25)
    return out, ok


def stage1_ok(s1: dict, ratio: float = 0.5) -> bool:
    return bool(s1["last_loss_recon"] < ratio * s1["first_loss_recon"] and s1["finite"])


def stage2_ok(s2: dict, ratio: float = 0.3) -> bool:
    return bool(np.isfinite(s2["last_loss"]) and s2["last_loss"] < ratio * s2["first_loss"])


def text_ok(st: dict, ratio: float = 0.3, txt_ratio: float = 0.5) -> bool:
    return bool(stage2_ok(st, ratio) and np.isfinite(st["last_loss_txt"])
                and st["last_loss_txt"] < txt_ratio * st["first_loss_txt"])


def run(what: str, device=None, steps1=STEPS1, steps2=STEPS2, bs=BS) -> tuple[bool, dict]:
    """The JAX tool's main without the exit: (converged, summaries)."""
    if what == "ab":
        out, ok = run_stage1_ab(steps1, bs, device)
        return ok, {"ab": out}
    if what == "stage2":
        raise ValueError("stage2 needs the stage1-trained model; run 'both'")
    if what not in ("stage1", "both", "text"):
        raise ValueError(f"unknown mode {what!r}: stage1, stage2, both, text or ab")
    state, model, s1, data = run_stage1(steps=steps1, bs=bs, device=device)
    summaries, ok = {"stage1": s1}, True
    if what != "text":
        ok &= stage1_ok(s1)
    if what == "both":
        summaries["stage2"] = run_stage2(state, model, data, steps=steps2, bs=bs)
        ok &= stage2_ok(summaries["stage2"])
    if what in ("both", "text"):
        summaries["text"] = run_stage2_text(state, model, data, steps=steps2, bs=bs)
        ok &= text_ok(summaries["text"])
    return bool(ok), summaries


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i : i + 2]
    what = argv[0] if argv else "both"
    try:
        ok, _ = run(what, device)
    except ValueError as e:
        print(e, file=sys.stderr)
        sys.exit(2)
    print(json.dumps({"converged": ok}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
