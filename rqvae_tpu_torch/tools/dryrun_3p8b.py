"""Tensor-parallel sampling of the 3.8B RQ-Transformer at its full geometry.

Port of tools/dryrun_3p8b.py. The reference's flagship
(configs/imagenet256/stage2/in256-rqtransformer-8x8x4-3800M.yaml: embed
2560, body 42 and head 6 layers of 40 heads, vocabulary 16384, 8x8x4
codes through the RQ-VAE's codebooks) sampled by a model split over `--tp`
ranks (models/rqtransformer/model.py's Megatron split; TP 2: 1280 lanes
and 20 heads of 64 a shard, TP 4: 640 and 10), batch 2, top-k 64: the
head-split caches, the row-parallel sums, the gathered vocabulary slices,
and on CUDA the decode attention kernel (#1) on each shard.

Each rank builds only its own shard, on its own device (bf16 on CUDA,
fp32 on the CPU): the full model is never built, on the host or on a card.
The weights are zeros by default, as the JAX tool's (uniform logits: every
collective, cache and kernel still runs); --random-init draws the split
tensors from a generator seeded per rank and the replicated ones from one
seeded alike on every rank, on the device.

    python -m rqvae_tpu_torch.tools.dryrun_3p8b [--tp 2|4] [--random-init] [--device cuda|cpu]
        [--body-layers N] [--head-layers N] [--timeout S]

It starts the --tp ranks as processes of its own on tcp://localhost and
prints each rank's line (peak memory, seconds, the codes' shape and range,
#1's launches) and then one JSON line. Rank r runs on cuda:r when the
machine has a card for each rank (NCCL), else every rank on cuda:0 (gloo:
NCCL refuses two ranks on one card). --body-layers / --head-layers cut the
depth (the CPU test does), nothing else.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ARCH_3P8B = dict(  # in256-rqtransformer-8x8x4-3800M.yaml, as tools/dryrun_3p8b.py:61-76
    type="rq-transformer", vocab_size=16384, block_size=[8, 8, 4], embed_dim=2560, input_embed_dim=256,
    shared_tok_emb=True, shared_cls_emb=True, input_emb_vqvae=True, head_emb_vqvae=True, cumsum_depth_ctx=True,
    vocab_size_cond=1000, block_size_cond=1,
    body={"n_layer": 42, "block": {"n_head": 40}}, head={"n_layer": 6, "block": {"n_head": 40}},
)
QUANTIZER_3P8B = dict(latent_shape=(8, 8, 256), code_shape=(8, 8, 4), n_embed=16384, shared_codebook=True)
BATCH, TOP_K, SEED = 2, 64, 7  # the JAX tool's sample call
RESULT = "dryrun_3p8b rank "  # the prefix of a rank's JSON line


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m rqvae_tpu_torch.tools.dryrun_3p8b", description=__doc__.split("\n")[0])
    p.add_argument("--tp", type=int, default=2, help="ranks the model is split over (2 or 4)")
    p.add_argument("--random-init", action="store_true", help="seeded N(0, 0.02) weights instead of zeros")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--body-layers", type=int, default=None, help="cut the body's depth (default 42)")
    p.add_argument("--head-layers", type=int, default=None, help="cut the head's depth (default 6)")
    p.add_argument("--timeout", type=float, default=900.0, help="seconds the ranks may take")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)  # set for a rank's own process
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def arch(args) -> dict:
    out = dict(ARCH_3P8B)
    if args.body_layers is not None:
        out["body"] = {"n_layer": args.body_layers, "block": {"n_head": 40}}
    if args.head_layers is not None:
        out["head"] = {"n_layer": args.head_layers, "block": {"n_head": 40}}
    return out


def rank_main(args) -> dict:
    """One rank's process: joins the group, then run_rank; returns its
    result line."""
    from rqvae_tpu_torch.parallel import dist as D

    cuda = args.device == "cuda"
    if cuda:
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", args.rank if n_cards >= args.tp else 0)
        backend = "nccl" if n_cards >= args.tp else "gloo"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    env = D.initialize(backend=backend, init_method=f"tcp://localhost:{args.port}", rank=args.rank,
                       world_size=args.tp, device=dev)
    out = run_rank(args, env)
    D.shutdown(env)
    return out


def run_rank(args, env) -> dict:
    """This rank's part on `env`'s group of args.tp ranks (its device
    env.device): its shard of the model, one sample call; returns its
    result line (chip_smoke.py runs it in ranks it started)."""
    from rqvae_tpu_torch.models.rqtransformer import sampling as S
    from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
    from rqvae_tpu_torch.models.rqtransformer.model import RQTransformer
    from rqvae_tpu_torch.ops import attention_kernel as AK
    from rqvae_tpu_torch.ops.quantize import QuantizerConfig, RQCodebooks
    from rqvae_tpu_torch.parallel import dist as D
    from rqvae_tpu_torch.parallel.mesh import create_mesh

    dev = env.device
    cuda = dev.type == "cuda"
    rank = D.rank(env)
    mesh = create_mesh(1, args.tp, env)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    dtype = torch.bfloat16 if cuda else torch.float32
    with torch.no_grad():
        model = RQTransformer(TransformerConfig.create(arch(args)), device=dev, dtype=dtype, mesh=mesh)
        if args.random_init:
            model.init_weights(torch.Generator(device=dev).manual_seed(SEED),
                               split_generator=torch.Generator(device=dev).manual_seed(SEED + 1 + rank))
        else:
            for p in model.parameters():
                p.zero_()
            model.fuse_qkv()
        books = RQCodebooks(QuantizerConfig.create(**QUANTIZER_3P8B), device=dev, dtype=dtype)
        books.init_weights(torch.Generator(device=dev).manual_seed(SEED + 100))
    n_local = sum(p.numel() for p in model.parameters())
    D.barrier(env)
    init_s = time.perf_counter() - t0
    attn = AK.decode_attention_update
    before = attn.launches
    t0 = time.perf_counter()
    codes = S.sample(model, BATCH, torch.Generator(device=dev).manual_seed(SEED), quantizer=books,
                     cond=torch.zeros(BATCH, dtype=torch.long, device=dev), top_k=TOP_K)
    if cuda:
        torch.cuda.synchronize(dev)
    sample_s = time.perf_counter() - t0
    out = dict(rank=rank, tp=args.tp, backend=D.backend_name(env), device=str(dev),
               card=torch.cuda.get_device_name(dev) if cuda else "cpu", params_local=n_local,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None, init_s=init_s,
               sample_s=sample_s, codes_shape=list(codes.shape), codes_min=int(codes.min()),
               codes_max=int(codes.max()), codes=codes.flatten().tolist(),
               kernel=attn.__name__, launches=attn.launches - before)
    return out


def launch(args, argv) -> list[dict]:
    """Start the --tp ranks, wait up to --timeout seconds, and return their
    result lines; on a failure or the timeout every rank is killed and its
    output's tail shown."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "rqvae_tpu_torch.tools.dryrun_3p8b", *argv, "--port", str(port)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(args.tp)]
    deadline = time.monotonic() + args.timeout
    logs, failed = [], None
    try:
        for r, p in enumerate(procs):
            try:
                logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                failed = f"rank {r} still running after {args.timeout:.0f} s"
                break
            if p.returncode != 0:
                failed = f"rank {r} exited with {p.returncode}"
                break
    finally:
        for p in procs:
            p.kill()
    if failed:
        tails = []
        for r, p in enumerate(procs):
            text = logs[r] if r < len(logs) else (p.communicate()[0] or "")
            tails.append(f"--- rank {r}:\n{text[-3000:]}")
        raise RuntimeError(f"dryrun_3p8b: {failed}\n" + "\n".join(tails))
    results = []
    for log in logs:
        lines = [ln[len(RESULT):] for ln in log.splitlines() if ln.startswith(RESULT)]
        results.append(json.loads(lines[-1]))
    return results


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    if args.rank is not None:
        out = rank_main(args)
        print(RESULT + json.dumps(out), flush=True)
        return out
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun_3p8b: torch.cuda.is_available() is False; pass --device cpu to run on the CPU")
    t0 = time.perf_counter()
    results = launch(args, argv)
    wall = time.perf_counter() - t0
    a = arch(args)
    for r in results:
        print(f"# rank {r['rank']} of TP {r['tp']} ({r['backend']}, {r['device']}, {r['card']}): "
              f"{r['params_local'] / 1e9:.3f}B params local, peak "
              + (f"{r['peak_gib']:.2f} GiB" if r["peak_gib"] is not None else "not measured (CPU)")
              + f", init {r['init_s']:.1f} s, sample {r['sample_s']:.1f} s, codes {tuple(r['codes_shape'])} in "
              f"[{r['codes_min']}, {r['codes_max']}], {r['kernel']} launches {r['launches']}", flush=True)
    same = all(r["codes"] == results[0]["codes"] for r in results)
    shape = (BATCH, *a["block_size"])
    ok = same and all(tuple(r["codes_shape"]) == shape and 0 <= r["codes_min"] and r["codes_max"] < 16384
                      for r in results)
    summary = dict(ok=ok, tp=args.tp, batch=BATCH, top_k=TOP_K,
                   layers=[a["body"]["n_layer"], a["head"]["n_layer"]], random_init=args.random_init,
                   codes_equal_across_ranks=same, wall_s=wall,
                   ranks=[{k: v for k, v in r.items() if k != "codes"} for r in results])
    print(json.dumps(summary), flush=True)
    if not ok:
        raise SystemExit("dryrun_3p8b: the ranks' codes differ or are out of range")
    return summary


if __name__ == "__main__":
    main()
