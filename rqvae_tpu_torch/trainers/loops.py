"""Epoch loops tying the train steps, the data, logging and checkpoints together.

Port of rqvae_tpu/trainers/loops.py (the reference's TrainerTemplate /
TrainerRQVAE, trainer.py:90-131 and trainer_rqvae.py:137-403; the stage-2
loop is the JAX package's own). Per epoch: the train steps (stage 1 with
the discriminator from disc_start on), eval every test_freq epochs (also
of the EMA weights where there are any), scalars every 50 steps, stage 1's
reconstruction grids every 250 steps and its reconstruction and per-depth
partial-code grids at the reference's cadence, codebook-usage entropies,
and checkpoints every save_ckpt_freq epochs.

The steps' metrics and codes stay on the device between flushes: one
transfer every 50 steps and at the end of the epoch, no .item() a step
(the stage-2 step is host-bound). Loader batches are NCHW; the stage-1
step takes them as an NHWC view.

Checkpoints are torch files:
  - weights/step_<epoch>/model.pt: {"state_dict", "state_dict_ema" (with
    an EMA), "epoch"} in the reference key layout, config.yaml beside it,
    which cli/common.load_model_from_ckpt and load_ar_and_vqvae read;
  - ckpt/step_<epoch>.pt: the whole train state for --resume: the
    models (with the discriminator's BatchNorm statistics), the
    optimizers (moments and update counts, which set the schedules' step),
    the EMA, the step counters and the trainer's torch.Generator state
    (every rank's, under data parallelism).

Data parallelism (`dist`, a parallel.dist.DistEnv): each rank's loader
reads its shard of every global batch (shard_indices), the steps take the
global step (trainers/trainer_stage1.py, trainer_stage2.py), and the
epoch's and eval's sums are summed over the ranks. At the start of a run
rank 0's parameters and buffers are broadcast, so that a loaded or
resumed model cannot diverge. Only rank 0 writes weights, checkpoints,
grids and scalars, and every rank waits for its checkpoint; every rank
resumes from it. The steps' random bits (dropout, stochastic codes) come
from a generator seeded with seed + 1 + rank; the codebook restarts are
rank 0's draws.
"""

from __future__ import annotations

import glob
import os
import re
import time
from typing import Optional

import numpy as np
import torch

from rqvae_tpu_torch.data.loader import DataLoader
from rqvae_tpu_torch.models.ema import averaged_weights
from rqvae_tpu_torch.models.rqvae.model import RQVAE
from rqvae_tpu_torch.parallel import dist as D
from rqvae_tpu_torch.trainers import trainer_stage1 as T1
from rqvae_tpu_torch.trainers import trainer_stage2 as T2
from rqvae_tpu_torch.trainers.accumulator import AccmStage1, AccmStage2
from rqvae_tpu_torch.utils.config import env_flag
from rqvae_tpu_torch.utils.setup import Writer, make_grid

FLUSH_EVERY = 50  # steps between metric transfers (and step scalars)
GRID_EVERY = 250  # steps between stage 1's reconstruction grids


def _freqs(config) -> tuple[int, int]:
    """(test_freq, save_ckpt_freq); both 1 under SMOKE_TEST."""
    if env_flag("SMOKE_TEST"):
        return 1, 1
    exp = config.experiment
    return exp.get("test_freq", 10), exp.get("save_ckpt_freq", 10)


def _host(obj):
    """A copy of a state_dict or nested state on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def latest_checkpoint(ckpt_dir: str) -> Optional[tuple[int, str]]:
    """(epoch, path) of the newest ckpt/step_<epoch>.pt, or None."""
    found = []
    for path in glob.glob(os.path.join(ckpt_dir, "step_*.pt")):
        m = re.fullmatch(r"step_(\d+)\.pt", os.path.basename(path))
        if m:
            found.append((int(m.group(1)), path))
    return max(found) if found else None


class _Loop:
    """What both trainers share: the loaders, the pending-metric buffer, the
    timing of an epoch, the weights file and the resume file."""

    def _init_loop(self, config, dataset_trn, dataset_val, batch_size: int, device, logger, writer, seed: int,
                   dist: Optional[D.DistEnv]):
        self.config = config
        self.logger = logger
        self.writer = writer or Writer(None)
        self.device = device
        self.dist = dist
        self.master = D.is_master(dist)
        workers = 0 if env_flag("SMOKE_TEST") else None  # None: the loader's default
        shard = dict(process_index=D.rank(dist), process_count=D.world(dist))  # batch_size is the global batch
        self.loader_trn = DataLoader(dataset_trn, batch_size, shuffle=True, seed=seed, num_workers=workers,
                                     device=device, **shard)
        self.loader_val = DataLoader(dataset_val, batch_size, shuffle=False, drop_last=False, num_workers=workers,
                                     device=device, **shard)
        # the steps' random bits (dropout, code restarts, stochastic codes), carried across epochs
        self.generator = torch.Generator(device=device).manual_seed(seed + 1 + D.rank(dist))
        self.epoch_stats: dict = {}

    def broadcast_state(self):
        """Rank 0's parameters, buffers and EMA on every rank."""
        tensors = [t.data for m in self._synced_modules() for t in (*m.parameters(), *m.buffers())]
        if self.state.ema is not None:
            tensors += list(self.state.ema.values())
        D.broadcast(tensors, self.dist)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_steps(self, epoch: int, step, on_flush):
        """Runs step(batch) over the epoch's batches, buffering (metrics,
        codes or None) on the device; `on_flush(names, values, codes)` gets
        the buffer on the host every FLUSH_EVERY steps and at the end.
        Returns the last batch and records epoch_stats: steps, the first
        step's seconds (data included) and step_ms, the milliseconds from
        each step's end to the next one's. On CUDA these are events recorded
        on the stream after each step, read once at the end of the epoch, so
        the steps are not synchronized; an interval holds whatever kept the
        card from the next step (the host, the loader)."""
        pending, last, n = [], None, len(self.loader_trn)

        def flush():
            if not pending:
                return None
            names = list(pending[0][0])
            values = torch.stack([torch.stack([m[k].float().reshape(-1)[0] for k in names]) for m, _ in pending])
            codes = torch.stack([c for _, c in pending]).cpu().numpy() if pending[0][1] is not None else None
            values = values.cpu().numpy()
            pending.clear()
            on_flush(names, values, codes)
            return dict(zip(names, values[-1]))

        cuda = self.device.type == "cuda"
        ends, t_first, t_start = [], 0.0, time.perf_counter()
        for it, batch in enumerate(self.loader_trn):
            pending.append(step(batch))
            last = batch
            if cuda:
                ends.append(torch.cuda.Event(enable_timing=True))
                ends[-1].record()
            else:
                ends.append(time.perf_counter())
            if it == 0:
                self._sync()
                t_first = time.perf_counter() - t_start
            global_iter = epoch * n + it
            if (global_iter + 1) % FLUSH_EVERY == 0:
                for k, v in flush().items():
                    self.writer.add_scalar(f"loss_step/{k}", v, "train", global_iter)
            self._after_step(batch, global_iter)
        flush()
        self._sync()
        if cuda:
            step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        else:
            step_ms = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
        self.epoch_stats = {"steps": len(ends), "first_step_s": t_first, "step_ms": step_ms}
        if step_ms:
            ms = float(np.median(step_ms))
            self.logger.info("epoch %d: %d steps, median %.1f ms/step after the first (%.1f s), %.1f images/s", epoch,
                             len(ends), ms, t_first, self.loader_trn.batch_size / ms * 1e3)
        return last

    def _after_step(self, batch, global_iter: int):
        pass

    def _save_weights(self, epoch: int, model, ema: Optional[dict]) -> str:
        weights_dir = os.path.join(self.config.result_path, "weights", f"step_{epoch}")
        os.makedirs(weights_dir, exist_ok=True)
        payload = {"state_dict": _host(model.state_dict()), "epoch": epoch}
        if ema is not None:
            with averaged_weights(model, ema):
                payload["state_dict_ema"] = _host(model.state_dict())
        path = os.path.join(weights_dir, "model.pt")
        torch.save(payload, path)
        with open(os.path.join(weights_dir, "config.yaml"), "w") as f:
            f.write(self.config.to_yaml())
        return path

    def _generator_states(self) -> list:
        """Every rank's generator state in rank order (a collective)."""
        state = self.generator.get_state()
        if not D.active(self.dist):
            return [state]
        return list(D.all_gather_cat(state.to(self.dist.device)[None], self.dist).cpu())

    def _load_generator(self, saved: dict):
        """This rank's generator state of a saved train state (rank 0's
        where the file holds one only)."""
        states = saved.get("generators")
        state = states[D.rank(self.dist)] if states is not None and len(states) == D.world(self.dist) else \
            saved["generator"]
        self.generator.set_state(state.cpu())

    def save_ckpt(self, epoch: int):
        """Rank 0 writes the weights and the train state; every rank
        waits for them."""
        generators = self._generator_states()
        if self.master:
            path = self._save_weights(epoch, self.state.model, self.state.ema)
            ckpt_dir = os.path.join(self.config.result_path, "ckpt")
            os.makedirs(ckpt_dir, exist_ok=True)
            state = _host(self.train_state())
            state["epoch"] = epoch
            if len(generators) > 1:
                state["generators"] = generators
            torch.save(state, os.path.join(ckpt_dir, f"step_{epoch}.pt"))
            self.logger.info("epoch %d: weights at %s, train state at %s", epoch, path,
                             os.path.join(ckpt_dir, f"step_{epoch}.pt"))
        D.barrier(self.dist)

    def maybe_resume(self) -> int:
        """Loads the newest ckpt/step_<epoch>.pt of the result directory;
        returns the epoch to start from (0 when there is none)."""
        found = latest_checkpoint(os.path.join(self.config.result_path, "ckpt"))
        if found is None:
            return 0
        epoch, path = found
        self.load_train_state(torch.load(path, map_location=self.device, weights_only=False))
        self.logger.info("resumed from epoch %d (%s)", epoch, path)
        return epoch + 1


class Stage1Trainer(_Loop):
    METRIC_NAMES = ["loss_total", "loss_recon", "loss_latent", "loss_pcpt", "loss_gen", "loss_disc", "g_weight",
                    "logits_real", "logits_fake"]

    def __init__(self, *, model: RQVAE, disc, lpips, gan_cfg: T1.GanLossConfig, optim_config, schedule,
                 disc_optim_config, disc_schedule, config, dataset_trn, dataset_val, logger,
                 writer: Optional[Writer] = None, seed: int = 0, dist: Optional[D.DistEnv] = None):
        device = model.quant_conv.weight.device
        self._init_loop(config, dataset_trn, dataset_val, config.experiment.batch_size, device, logger, writer, seed,
                        dist)
        self.model = model
        self.gan_cfg = gan_cfg
        use_ema = config.arch.get("ema") is not None
        self.state = T1.init_state(model, disc, optim_config, schedule, disc_optim_config, disc_schedule,
                                   use_ema=use_ema)
        self._steps = {ud: T1.make_train_step(lpips, gan_cfg, use_discriminator=ud, dist=dist) for ud in (True, False)}
        self._eval_steps = {(ud, ema): T1.make_eval_step(lpips, gan_cfg, use_discriminator=ud, use_ema=ema)
                            for ud in (True, False) for ema in ((True, False) if use_ema else (False,))}
        self.n_codebook = config.arch.hparams.code_shape[-1]

    def _synced_modules(self):
        return self.state.model, self.state.disc

    def get_accm(self):
        hp = self.config.arch.hparams
        return AccmStage1(self.METRIC_NAMES, n_codebook=self.n_codebook, codebook_size=hp.n_embed,
                          code_hier=self.config.arch.get("code_hier", 1),
                          use_padding_idx=hp.get("use_padding_idx", False))

    def train_epoch(self, epoch: int):
        step_fn = self._steps[epoch >= self.gan_cfg.disc_start]
        accm = self.get_accm()
        self.loader_trn.set_epoch(epoch)

        def step(batch):
            self.state, metrics, codes = step_fn(self.state, {"images": batch["images"].permute(0, 2, 3, 1)},
                                                 self.generator)
            return metrics, codes

        def on_flush(names, values, codes):
            for row, c in zip(values, codes):
                accm.update([c], dict(zip(names, row)), count=1)

        last = self._run_steps(epoch, step, on_flush)
        accm.reduce(self.dist)
        summary = accm.get_summary()
        summary["xs"] = None if last is None else last["images"].permute(0, 2, 3, 1)
        return summary

    def _after_step(self, batch, global_iter: int):
        if self.master and (global_iter + 1) % GRID_EVERY == 0:
            self.log_reconstruction(batch["images"].permute(0, 2, 3, 1), global_iter, tag="reconstruction_step")

    def eval_epoch(self, epoch: int, valid: bool = True, ema: bool = False):
        eval_fn = self._eval_steps[(epoch >= self.gan_cfg.disc_start, ema)]
        accm = self.get_accm()
        loader = self.loader_val if valid else self.loader_trn
        n_inst, last_xs = 0, None
        for batch in loader:
            xs = batch["images"].permute(0, 2, 3, 1)
            metrics, codes = eval_fn(self.state, {"images": xs})
            accm.update([codes], {k: float(v) for k, v in metrics.items()}, count=xs.shape[0])
            n_inst += xs.shape[0]
            last_xs = xs
        accm.reduce(self.dist)
        summary = accm.get_summary(accm.counter)
        summary["xs"] = last_xs
        return summary

    @torch.no_grad()
    def log_reconstruction(self, xs, step, tag="reconstruction", mode="train"):
        """The grid of the first 16 images and their reconstructions; returns their codes."""
        xs = xs[:16]
        out, _, codes = self.model(xs)
        self._write_grid(xs, out, tag, mode, step)
        return codes

    @torch.no_grad()
    def log_partial_reconstruction(self, xs, epoch: int, code_idx: int, mode: str, decode_type: str, codes=None):
        """Per-depth partial-code reconstruction grids (the reference's
        trainer_rqvae.py:366-389): 'select' decodes depth code_idx alone,
        'add' depths 0..code_idx. `codes`: those of xs[:16] where the
        caller has them (JAX's forward_partial_code encodes again)."""
        xs = xs[:16]
        codes = self.model.get_codes(xs) if codes is None else codes
        recon = self.model.decode_partial_code(codes, code_idx, decode_type)
        self._write_grid(xs, recon, f"reconstruction_{decode_type}/{code_idx}-th code", mode, epoch)

    def _write_grid(self, xs, recon, tag, mode, step):
        real, recon = RQVAE.get_recon_imgs(xs.float(), recon.float())
        n = real.shape[0] // 2
        grid = torch.cat([real[:n], recon[:n], real[n:], recon[n:]]).cpu().numpy()
        self.writer.add_image(tag, make_grid(grid, nrow=max(n, 1)), mode, step)

    def logging(self, summary, epoch: int, mode: str):
        test_freq, _ = _freqs(self.config)
        if self.master and (epoch % 10 == 1 or epoch % test_freq == 0) and summary.get("xs") is not None:
            codes = self.log_reconstruction(summary["xs"], epoch, mode=mode)
            if self.n_codebook > 1:
                for code_idx in range(self.n_codebook):
                    for decode_type in ("select", "add"):
                        self.log_partial_reconstruction(summary["xs"], epoch, code_idx, mode, decode_type, codes)
        for k, v in summary.metrics.items():
            self.writer.add_scalar(f"loss/{k}", v, mode, epoch)
        for level, ents in enumerate(summary["ent_codes_wo_pad"] or []):
            for book, ent in enumerate(np.atleast_1d(ents)):
                self.writer.add_scalar(f"codebooks-wo-pad/entropy-level-{level}/codebook{book}", ent, mode, epoch)
        self.logger.info("ep:%d %s %s", epoch, mode, summary.print_line())

    def train_state(self) -> dict:
        s = self.state
        return {"model": s.model.state_dict(), "disc": s.disc.state_dict(), "optimizer": s.optimizer.state_dict(),
                "disc_optimizer": s.disc_optimizer.state_dict(), "ema": s.ema, "step": s.step,
                "disc_step": s.disc_step, "generator": self.generator.get_state()}

    def load_train_state(self, saved: dict):
        s = self.state
        s.model.load_state_dict(saved["model"], strict=True)
        s.disc.load_state_dict(saved["disc"], strict=True)
        s.optimizer.load_state_dict(saved["optimizer"])
        s.disc_optimizer.load_state_dict(saved["disc_optimizer"])
        if s.ema is not None:
            for k, v in saved["ema"].items():
                s.ema[k].copy_(v)
        s.step, s.disc_step = saved["step"], saved["disc_step"]
        self._load_generator(saved)

    def run_epoch(self, epoch_st: int = 0):
        test_freq, save_freq = _freqs(self.config)
        self.broadcast_state()
        for epoch in range(epoch_st, self.config.experiment.epochs):
            t0 = time.time()
            self.logging(self.train_epoch(epoch), epoch, "train")
            if epoch % test_freq == test_freq - 1:
                self.logging(self.eval_epoch(epoch), epoch, "valid")
                if self.state.ema is not None:
                    self.logging(self.eval_epoch(epoch, ema=True), epoch, "valid_ema")
            if epoch % save_freq == save_freq - 1:
                self.save_ckpt(epoch)
            self.logger.info("epoch %d done in %.1fs", epoch, time.time() - t0)


class Stage2Trainer(_Loop):
    """The stage-2 loop (the JAX package's own: the reference withholds its trainer)."""

    METRIC_NAMES = ["loss_total", "loss_img", "loss_txt", "grad_norm"]

    def __init__(self, *, model, loss_cfg: T2.Stage2LossConfig, optim_config, schedule, encode_fn, quantizer, config,
                 dataset_trn, dataset_val, logger, writer: Optional[Writer] = None, grad_accum_steps: int = 1,
                 seed: int = 0, dist: Optional[D.DistEnv] = None):
        device = model.pos_emb_hw.device
        self._init_loop(config, dataset_trn, dataset_val, config.experiment.batch_size * grad_accum_steps, device,
                        logger, writer, seed, dist)
        self.state = T2.init_state(model, optim_config, schedule, use_ema=config.arch.get("ema") is not None)
        kw = dict(encode_fn=encode_fn, quantizer=quantizer)
        self._train_step = T2.make_train_step(loss_cfg, grad_accum_steps=grad_accum_steps, dist=dist, **kw)
        self._eval_step = T2.make_eval_step(loss_cfg, **kw)

    def _synced_modules(self):
        return (self.state.model,)

    def train_epoch(self, epoch: int):
        accm = AccmStage2(self.METRIC_NAMES)
        self.loader_trn.set_epoch(epoch)

        def step(batch):
            self.state, metrics = self._train_step(self.state, batch, self.generator)
            return {k: v for k, v in metrics.items() if k in self.METRIC_NAMES}, None

        def on_flush(names, values, _):
            for row in values:
                accm.update(dict(zip(names, row)), count=1)

        self._run_steps(epoch, step, on_flush)
        accm.reduce(self.dist)
        return accm.get_summary()

    def eval_epoch(self, epoch: int):
        accm = AccmStage2(["loss_total", "loss_img", "loss_txt"])
        # the same draws every eval
        generator = torch.Generator(device=self.device).manual_seed(1234 + D.rank(self.dist))
        for batch in self.loader_val:
            metrics = self._eval_step(self.state, batch, generator)
            accm.update({k: float(v) for k, v in metrics.items() if v.numel() == 1}, count=1)
        accm.reduce(self.dist)
        return accm.get_summary()

    def train_state(self) -> dict:
        s = self.state
        return {"model": s.model.state_dict(), "optimizer": s.optimizer.state_dict(), "ema": s.ema, "step": s.step,
                "generator": self.generator.get_state()}

    def load_train_state(self, saved: dict):
        s = self.state
        s.model.load_state_dict(saved["model"], strict=True)
        T2.refresh_derived_buffers(s.model)
        s.optimizer.load_state_dict(saved["optimizer"])
        if s.ema is not None:
            for k, v in saved["ema"].items():
                s.ema[k].copy_(v)
        s.step = saved["step"]
        self._load_generator(saved)

    def run_epoch(self, epoch_st: int = 0):
        test_freq, save_freq = _freqs(self.config)
        self.broadcast_state()
        for epoch in range(epoch_st, self.config.experiment.epochs):
            summary = self.train_epoch(epoch)
            for k, v in summary.metrics.items():
                self.writer.add_scalar(f"loss/{k}", v, "train", epoch)
            self.logger.info("ep:%d train %s", epoch, summary.print_line())
            if epoch % test_freq == test_freq - 1:
                self.logger.info("ep:%d valid %s", epoch, self.eval_epoch(epoch).print_line())
            if epoch % save_freq == save_freq - 1:
                self.save_ckpt(epoch)
