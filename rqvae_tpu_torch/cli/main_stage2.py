"""Stage-2 (RQ-Transformer) training entry point.

Port of cli/main_stage2.py (the JAX package's own: the reference withholds
its stage-2 trainer): the config with its defaults and key=value
overrides, the frozen stage-1 RQ-VAE of vqvae.ckpt (its encoder in bf16
unless experiment.encode_bf16 is false), the RQ-Transformer with random
weights from --seed, the text-image datasets where arch.block_size_cond >
1 and the image datasets otherwise, the optimizer with its schedule and
optimizer.grad_accm_steps microbatches, then the epoch loop
(trainers/loops.Stage2Trainer).

    python -m rqvae_tpu_torch.cli.main_stage2 -m <stage2.yaml> -r results/ [vqvae.ckpt=<stage-1 model.pt>]
    torchrun --nproc_per_node=N -m rqvae_tpu_torch.cli.main_stage2 -m <stage2.yaml> ...

Under torchrun each rank is a process on cuda:LOCAL_RANK (NCCL), or on the
CPU with `--device cpu` (gloo); experiment.batch_size times
grad_accm_steps is the global batch, split equally over the ranks, and
each step is the global batch's (parallel/dist.py). The world size goes
to config_setup (total_batch_size over world size x batch_size sets
grad_accm_steps) and to the schedule, as in the JAX CLI. Without a
launcher: one process, no group.

The JAX CLI's arguments, plus --device (default: the first CUDA device, or
cuda:LOCAL_RANK under torchrun; `--device cpu` runs on the CPU). `--resume -l <result dir>/config.yaml`
continues a run. `main(argv)` returns the trainer.
"""

from __future__ import annotations

import argparse

import torch

from rqvae_tpu_torch.cli.common import set_seed
from rqvae_tpu_torch.data import create_dataset, create_datasets
from rqvae_tpu_torch.models import create_rqtransformer, load_rqvae
from rqvae_tpu_torch.optim.schedule import create_schedule
from rqvae_tpu_torch.parallel import dist as D
from rqvae_tpu_torch.trainers import trainer_stage2 as T2
from rqvae_tpu_torch.trainers.loops import Stage2Trainer
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


def main(argv=None) -> Stage2Trainer:
    args, extra = parse_args(argv)
    if args.resume and not args.load_path:
        args.load_path = args.model_config
    seed = set_seed(args.seed)
    env = D.initialize(device=args.device)
    device = env.device
    config = config_setup(args, env.world_size, args.model_config, extra)
    config, logger, writer = setup(args, config, extra, dist=env)
    logger.info("world size %d (%s)", env.world_size, D.backend_name(env))

    vqvae = load_rqvae(config.vqvae, config.vqvae.ckpt, device=device)
    vqvae.requires_grad_(False)
    exp = config.experiment
    encode_fn = T2.make_frozen_encode_fn(vqvae, dtype=torch.bfloat16 if exp.get("encode_bf16", True) else None)

    model = create_rqtransformer(config.arch, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))

    if config.arch.block_size_cond > 1:
        dataset_trn, dataset_val = create_datasets(config, logger=logger)
    else:
        dataset_trn, dataset_val = create_dataset(config, logger=logger)

    loss = config.loss
    loss_cfg = T2.Stage2LossConfig(use_soft_target=loss.type == "soft_target_cross_entropy", temp=loss.temp,
                                   stochastic_codes=loss.stochastic_codes, txt_weight=loss.get("txt_weight", 0.1),
                                   img_weight=loss.get("img_weight", 0.9), amp_bf16=exp.get("amp_bf16", True),
                                   remat=exp.get("remat", False))
    grad_accum = config.optimizer.get("grad_accm_steps", 1)
    steps_per_epoch = max(len(dataset_trn) // (exp.batch_size * grad_accum), 1)
    schedule = create_schedule(base_lr=config.optimizer.init_lr, warmup_config=config.optimizer.warmup,
                               steps_per_epoch=steps_per_epoch, max_epoch=exp.epochs, world_size=env.world_size)

    trainer = Stage2Trainer(model=model, loss_cfg=loss_cfg, optim_config=config.optimizer, schedule=schedule,
                            encode_fn=encode_fn, quantizer=vqvae.quantizer, config=config, dataset_trn=dataset_trn,
                            dataset_val=dataset_val, logger=logger, writer=writer, grad_accum_steps=grad_accum,
                            seed=seed, dist=env)
    epoch_st = trainer.maybe_resume() if args.resume else 0
    if args.eval:
        trainer.broadcast_state()
        logger.info("valid %s", trainer.eval_epoch(0).print_line())
    else:
        trainer.run_epoch(epoch_st)
    writer.close()
    D.shutdown(env)
    return trainer


if __name__ == "__main__":
    main()
