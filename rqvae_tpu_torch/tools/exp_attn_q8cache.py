"""Kernel-rate experiment: int8-quantized KV cache vs bf16 in the read-only
decode attention, the port of tools/exp_attn_q8cache.py.

It measures the isolated stream rates of the two read-only decode attention
kernels at the 1.4B body geometry (C 1536, 24 heads): decode_attention over
a bf16 [B, T, C] cache and decode_attention_q8 over the same rows quantized
to int8 with per-(row, head) scales, half the cache bytes. Inputs come from
np.random.RandomState(0) in the JAX experiment's order; the caches are
quantized by quantize_kv, the scales stored as bf16; cur_len = T - 1; the
new token's k / v are unquantized. Each form runs a dependent chain of ITERS
calls, x -> attention(x, ...), best of 3, and prints the JAX experiment's
two lines per batch (us per call, GB/s on its byte counts: 2 B T C 2 bf16,
2 B T C + 2 B T n_head 2 int8), then a third with the eager loop's time.

On the card the chain is captured once in a torch.cuda.CUDAGraph and
replayed, timed with CUDA events: the device time of the ITERS kernels, as
the JAX experiment's one jitted lax.scan measured. An eager loop of the same
calls pays host dispatch per call, which is the third line. The wrapper
counts each captured launch once, at capture; a replay relaunches the ITERS
kernels without passing through the wrapper, so each replay adds ITERS to the
wrapper's count. On the CPU (device=cpu) both lines time the eager loop on
the host clock: a check that the experiment runs, not a rate.

    python -m rqvae_tpu_torch.tools.exp_attn_q8cache [B ...] [device=cpu]   (default B: 100 500)

Env: EXP_T (cache rows, default 64), EXP_ITERS (chain length, default 50).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from rqvae_tpu_torch import resolve_device
from rqvae_tpu_torch.ops import attention_kernel as AK
from rqvae_tpu_torch.tools._timing import BEST_OF, card_line, time_chain

C, NH = 1536, 24


def _chain(fn, q, iters):
    x = q
    for _ in range(iters):
        x = fn(x)
    return x


def launches_per_batch(iters: int) -> int:
    """Launches of each kernel that main counts per batch on the card: the
    eager chain BEST_OF times, one warm-up call, the chain once at capture
    and BEST_OF replays of it."""
    return BEST_OF * iters + 1 + iters + BEST_OF * iters


def main(argv=None, device=None) -> dict:
    """Run the experiment for the batches in argv (default 100 500); a
    `device=` argument or keyword picks the device (default: the first
    CUDA device, raising without one). Returns {B: {"bf16_us", "q8_us",
    "bf16_eager_us", "q8_eager_us", "bf16_gbs", "q8_gbs"}}."""
    args = list(sys.argv[1:] if argv is None else argv)
    for a in [a for a in args if a.startswith("device=")]:
        device = a.split("=", 1)[1]
        args.remove(a)
    dev = resolve_device(device)
    batches = [int(a) for a in args] or [100, 500]
    T = int(os.environ.get("EXP_T", "64"))
    iters = int(os.environ.get("EXP_ITERS", "50"))
    if dev.type == "cuda":
        print(card_line(), flush=True)
    r = np.random.RandomState(0)
    results = {}
    for B in batches:
        def bf16(a):
            return torch.from_numpy(a).to(dev, torch.bfloat16)

        q, kn, vn = bf16(r.randn(B, C)), bf16(r.randn(B, C)), bf16(r.randn(B, C))
        kc = torch.from_numpy(r.randn(B, T, C).astype(np.float32)).to(dev)
        vc = torch.from_numpy(r.randn(B, T, C).astype(np.float32)).to(dev)
        cache = []
        for x in (kc, vc):
            xq, xs = AK.quantize_kv(x.reshape(B * T, C), NH)
            cache += [xq.reshape(B, T, C), xs.reshape(B, T, NH).to(torch.bfloat16)]
        kc16, vc16 = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
        del kc, vc
        cur = T - 1

        def bf(x):
            return AK.decode_attention(x, kn, vn, kc16, vc16, cur, NH)

        def q8(x):
            return AK.decode_attention_q8(x, kn, vn, *cache, cur, NH)

        # each chain warmed up by one call fn(q)
        t_bf, e_bf = time_chain(lambda: _chain(bf, q, iters), iters, dev, {AK.decode_attention: iters},
                                warm=lambda: bf(q))
        t_q8, e_q8 = time_chain(lambda: _chain(q8, q, iters), iters, dev, {AK.decode_attention_q8: iters},
                                warm=lambda: q8(q))
        bytes_bf = 2 * B * T * C * 2
        bytes_q8 = 2 * B * T * C + 2 * B * T * NH * 2
        print(f"B={B:4d} T={T}: bf16 {t_bf * 1e6:8.1f} us  {bytes_bf / t_bf / 1e9:6.0f} GB/s", flush=True)
        print(f"B={B:4d} T={T}: q8   {t_q8 * 1e6:8.1f} us  {bytes_q8 / t_q8 / 1e9:6.0f} GB/s (int8 bytes)  "
              f"speedup {t_bf / t_q8:.2f}x", flush=True)
        clock = "CUDA graph replay" if dev.type == "cuda" else "host clock, CPU"
        print(f"B={B:4d} T={T}: eager loop bf16 {e_bf * 1e6:8.1f} us, q8 {e_q8 * 1e6:8.1f} us per call "
              f"(host dispatch included; the lines above: {clock})", flush=True)
        results[B] = dict(bf16_us=t_bf * 1e6, q8_us=t_q8 * 1e6, bf16_eager_us=e_bf * 1e6,
                          q8_eager_us=e_q8 * 1e6, bf16_gbs=bytes_bf / t_bf / 1e9, q8_gbs=bytes_q8 / t_q8 / 1e9)
    return results


if __name__ == "__main__":
    main()
