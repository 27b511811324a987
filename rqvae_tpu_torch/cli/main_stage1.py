"""Stage-1 (RQ-VAE) training entry point.

Port of cli/main_stage1.py (the reference's main_stage1.py:54-125): the
config with its defaults and key=value overrides, the datasets, the
RQ-VAE, the PatchGAN discriminator and LPIPS (synthetic weights unless
RQVAE_TPU_LPIPS_VGG / RQVAE_TPU_LPIPS_LIN name the published ones), both
optimizers with their warmup + cosine schedules, then the epoch loop
(trainers/loops.Stage1Trainer) with eval and checkpoints; random weights
come from --seed.

    python -m rqvae_tpu_torch.cli.main_stage1 -m <stage1.yaml> -r results/ [key=value ...]
    torchrun --nproc_per_node=N -m rqvae_tpu_torch.cli.main_stage1 -m <stage1.yaml> ...

Under torchrun each rank is a process on cuda:LOCAL_RANK (NCCL), or on the
CPU with `--device cpu` (gloo); experiment.batch_size is the global batch,
split equally over the ranks, and each step is the global batch's
(parallel/dist.py). The world size goes to config_setup and to both
schedules, as in the JAX CLI. Without a launcher: one process, no group.

The JAX CLI's arguments, plus --device (default: the first CUDA device, or
cuda:LOCAL_RANK under torchrun; `--device cpu` runs on the CPU). The loader decodes in min(8, CPUs)
worker processes, in this process under SMOKE_TEST. `-l <model.pt>`
starts from a stage-1 checkpoint's weights; `--resume -l
<result dir>/config.yaml` (or -m that file) continues a run from the newest
<result dir>/ckpt/step_<epoch>.pt. `main(argv)` returns the trainer.
"""

from __future__ import annotations

import argparse

import torch

from rqvae_tpu_torch.cli.common import load_model_from_ckpt, set_seed
from rqvae_tpu_torch.data import create_dataset
from rqvae_tpu_torch.losses.discriminator import NLayerDiscriminator
from rqvae_tpu_torch.losses.lpips import load_lpips_params
from rqvae_tpu_torch.models import create_rqvae
from rqvae_tpu_torch.optim.schedule import create_schedule
from rqvae_tpu_torch.parallel import dist as D
from rqvae_tpu_torch.trainers import trainer_stage1 as T1
from rqvae_tpu_torch.trainers.loops import Stage1Trainer
from rqvae_tpu_torch.utils.config import config_setup
from rqvae_tpu_torch.utils.setup import setup


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-m", "--model-config", type=str, required=True)
    p.add_argument("-r", "--result-path", type=str, default="./results")
    p.add_argument("-l", "--load-path", type=str, default="")
    p.add_argument("-p", "--postfix", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", type=str, default=None, help="default: the first CUDA device")
    return p.parse_known_args(argv)


def main(argv=None) -> Stage1Trainer:
    args, extra = parse_args(argv)
    if args.resume and not args.load_path:
        args.load_path = args.model_config
    seed = set_seed(args.seed)
    env = D.initialize(device=args.device)
    device = env.device
    config = config_setup(args, env.world_size, args.model_config, extra)
    config, logger, writer = setup(args, config, extra, dist=env)
    logger.info("world size %d (%s)", env.world_size, D.backend_name(env))

    dataset_trn, dataset_val = create_dataset(config, is_eval=args.eval, logger=logger)

    gen = torch.Generator(device=device).manual_seed(seed)
    model = create_rqvae(config.arch, device=device)
    model.init_weights(gen)
    disc_cfg = config.gan.disc.arch
    disc = NLayerDiscriminator(input_nc=disc_cfg.get("in_channels", 3), ndf=disc_cfg.get("ndf", 64),
                               n_layers=disc_cfg.get("num_layers", 3), use_actnorm=disc_cfg.get("use_actnorm", False),
                               device=device)
    disc.init_weights(gen)
    lpips, pretrained = load_lpips_params(device=device)
    if not pretrained:
        logger.warning("LPIPS running with RANDOM VGG weights (set RQVAE_TPU_LPIPS_VGG / RQVAE_TPU_LPIPS_LIN for the "
                       "perceptual term to be meaningful)")

    exp = config.experiment
    steps_per_epoch = max(len(dataset_trn) // exp.batch_size, 1)
    schedule = create_schedule(base_lr=config.optimizer.init_lr, warmup_config=config.optimizer.warmup,
                               steps_per_epoch=steps_per_epoch, max_epoch=exp.epochs, world_size=env.world_size)
    loss = config.gan.loss
    gan_cfg = T1.GanLossConfig(disc_loss=loss.disc_loss, gen_loss=loss.gen_loss, disc_weight=loss.disc_weight,
                               perceptual_weight=loss.perceptual_weight, disc_start=loss.disc_start,
                               lpips_bf16=loss.get("lpips_bf16", True), amp_bf16=exp.get("amp_bf16", False))
    disc_optim = config.gan.disc.optimizer
    disc_schedule = create_schedule(base_lr=disc_optim.init_lr, warmup_config=disc_optim.warmup,
                                    steps_per_epoch=steps_per_epoch, max_epoch=exp.epochs - gan_cfg.disc_start,
                                    world_size=env.world_size)

    trainer = Stage1Trainer(model=model, disc=disc, lpips=lpips, gan_cfg=gan_cfg, optim_config=config.optimizer,
                            schedule=schedule, disc_optim_config=disc_optim, disc_schedule=disc_schedule, config=config,
                            dataset_trn=dataset_trn, dataset_val=dataset_val, logger=logger, writer=writer, seed=seed,
                            dist=env)
    if args.load_path and not args.resume:
        _, loaded, _ = load_model_from_ckpt(args.load_path, device=device)
        model.load_state_dict(loaded.state_dict(), strict=True)
        logger.info("loaded weights from %s", args.load_path)

    epoch_st = trainer.maybe_resume() if args.resume else 0
    if args.eval:
        trainer.broadcast_state()
        trainer.logging(trainer.eval_epoch(0, valid=False), 0, "train")
        trainer.logging(trainer.eval_epoch(0, valid=True), 0, "valid")
    else:
        trainer.run_epoch(epoch_st)
    writer.close()
    D.shutdown(env)
    return trainer


if __name__ == "__main__":
    main()
