"""W8A8 decode-MLP kernel experiment, the port of tools/exp_w8a8.py.

Does a true W8A8 proj + LN2 + MLP, int8 activations quantized per row and
s8 x s8 -> s32 products (the H100's int8 tensor cores, twice the bf16
rate, no widening of the weights), beat the q8 kernel that streams int8
weights and widens them into bf16 products? On the same dependent chain of
L = 16 decode-shaped layers (x -> layer(x), weights made from a seed) it
times, in the JAX experiment's order and with its lines:

- the "bf16" chain through the port's #3 (decode_layer_kernel.
  fused_proj_mlp) on the dequantized weights (q.to(bf16) * scale.to(bf16));
- the "q8" chain through #6 (decode_layer_kernel.fused_proj_mlp_q8);
- the "q8a8" chain through #16 (w8a8_kernel.fused_proj_mlp_q8a8: one
  persistent launch of csrc/dense_w8a8.cu, both MLP products on s8 wgmma,
  planned by w8a8_kernel.w8a8_plan; `chunk` is part of its result, the
  hidden units of one activation scale, and sets no depth);
- the q8a8 vs q8 error of one layer (mean|d|, max|d|, mean|q8|).

GB/s are JAX's byte counts: L (C^2 + 2 C H) weights, 2 bytes each for
bf16, 1 for int8.

Timing (rqvae_tpu_torch/tools/_timing.py): on the card each chain of L x
ITERS calls is captured once in a torch.cuda.CUDAGraph and replayed, best
of 3, under CUDA events: the device time that JAX's one jitted lax.scan
measured, per iteration of L layers. Each replay adds its launches to the
wrapper's count. An eager-loop line follows each chain. On the CPU
(device=cpu) every line reads the host clock: it shows that the
experiment runs, not a rate.

    python -m rqvae_tpu_torch.tools.exp_w8a8 [B] [device=cpu]   (default B 100)

Env: EXP_ITERS (chain iterations, default 30).
"""

from __future__ import annotations

import os
import sys

import torch

from rqvae_tpu_torch import resolve_device
from rqvae_tpu_torch.models.rqtransformer.model import quantize_weight
from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from rqvae_tpu_torch.ops import w8a8_kernel as W8
from rqvae_tpu_torch.tools._timing import BEST_OF, card_line, time_chain


def launches_per_chain(iters: int, L: int) -> int:
    """Launches of a chain's kernel that main counts on the card: the eager
    chain of L x iters calls BEST_OF times, one warm-up call, the chain once
    at capture and BEST_OF replays of it."""
    return (2 * BEST_OF + 1) * iters * L + 1


def main(argv=None, device=None, C=1536, H=6144, L=16, chunk=1536) -> dict:
    """Run the experiment at batch B (argv, default 100); a `device=`
    argument or keyword picks the device (default: the first CUDA device,
    raising without one). C, H, L, chunk: the layer geometry and #16's
    chunk. Returns {"lines": every line printed, "ms": {chain: ms per
    iteration of L layers}, "err": (mean|d|, max|d|, mean|q8|)}."""
    args = list(sys.argv[1:] if argv is None else argv)
    for a in [a for a in args if a.startswith("device=")]:
        device = a.split("=", 1)[1]
        args.remove(a)
    dev = resolve_device(device)
    B = int(args[0]) if args else 100
    iters = int(os.environ.get("EXP_ITERS", "30"))
    lines, ms = [], {}

    def out(line):
        print(line, flush=True)
        lines.append(line)

    if dev.type == "cuda":
        out(card_line())
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def normal(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    x, y = normal(B, C).to(bf), normal(B, C).to(bf)
    lns, lnb = torch.ones(C, device=dev, dtype=bf), torch.zeros(C, device=dev, dtype=bf)
    bo, b1, b2 = (torch.zeros(n, device=dev, dtype=bf) for n in (C, H, C))
    wos = [quantize_weight(normal(C, C, std=0.05)) for _ in range(L)]
    w1s = [quantize_weight(normal(H, C, std=0.05)) for _ in range(L)]
    w2s = [quantize_weight(normal(C, H, std=0.05)) for _ in range(L)]
    bytes_q8 = L * (C * C + 2 * C * H)
    clock = "CUDA graph replay" if dev.type == "cuda" else "host clock, CPU"

    def timed(wrapper, label, layer, nbytes, unit=""):
        """Time the chain x -> layer(i, x) over the L layers, ITERS times;
        print the JAX line and the eager-loop line."""
        def chain():
            v = x
            for _ in range(iters):
                for i in range(L):
                    v = layer(i, v)
            return v

        t, eager = time_chain(chain, iters, dev, {wrapper: iters * L}, warm=lambda: layer(0, x))
        out(f"{label} chain: {t * 1e3:7.2f} ms  {nbytes / t / 1e9:6.0f} GB/s{unit}")
        out(f"{label} chain: eager loop {eager * 1e3:7.2f} ms per iteration of {L} layers (host dispatch "
            f"included; the line above: {clock})")
        ms[label.strip()] = t * 1e3

    def dequant(w):  # as JAX: q.astype(bf16) * scale.astype(bf16)
        return w[0].to(bf) * w[1][:, None]

    wbf = [(dequant(wo), dequant(w1), dequant(w2)) for wo, w1, w2 in zip(wos, w1s, w2s)]

    def bf16_layer(i, v):
        wo, w1, w2 = wbf[i]
        return DK.fused_proj_mlp(v, y, wo, bo, lns, lnb, w1, b1, w2, b2)

    timed(DK.fused_proj_mlp, "bf16 ", bf16_layer, 2 * bytes_q8)
    del wbf

    def q8(i, v):
        return DK.fused_proj_mlp_q8(v, y, *wos[i], bo, lns, lnb, *w1s[i], b1, *w2s[i], b2)

    def q8a8(i, v):
        return W8.fused_proj_mlp_q8a8(v, y, *wos[i], bo, lns, lnb, *w1s[i], b1, *w2s[i], b2, chunk=chunk)

    timed(DK.fused_proj_mlp_q8, "q8   ", q8, bytes_q8, " (int8 bytes)")
    timed(W8.fused_proj_mlp_q8a8, "q8a8 ", q8a8, bytes_q8, " (int8 bytes)")

    # the numeric error of ONE q8a8 layer against the q8 (W8A16) layer
    o_q8, o_a8 = q8(0, x).float(), q8a8(0, x).float()
    d = (o_a8 - o_q8).abs()
    err = (float(d.mean()), float(d.max()), float(o_q8.abs().mean()))
    out(f"q8a8 vs q8: mean|d| {err[0]:.5f} max|d| {err[1]:.5f} (mean|q8| {err[2]:.4f})")
    return {"lines": lines, "ms": ms, "err": err}


if __name__ == "__main__":
    main()
