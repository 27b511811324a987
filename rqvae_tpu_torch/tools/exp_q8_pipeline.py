"""int8 weight-stream pipeline-depth experiment, the port of
tools/exp_q8_pipeline.py.

Does an explicit, deeper pipeline of weight-chunk copies lift the int8
weight-streaming MLP off its floor, and is the limit the copy engine, the
dequantize, gelu or the scales? On the same dependent chain of L layers of
proj + LN2 + MLP (x -> layer(x), int8 wo / w1 / w2 made from a seed) it
times, in the JAX experiment's order and with its lines:

- the "shipped" chain through the port's #6 (decode_layer_kernel.
  fused_proj_mlp_q8);
- the ring kernel (#17) and the packed-layout kernel (#18) against it
  (mean|d| / max|d|), then their sweeps over (chunk, n_buf). Both launch
  #6's kernel (csrc/decode_dense.cu, one persistent launch planned by
  decode_layer_kernel.dense_plan; #18 reads its packed w2 through a tensor
  map of [nc C, chunk]): (chunk, n_buf) sets no depth any more, so the
  sweeps time one kernel at each point, and its bits equal #6's;
- the chunk stream alone (#19, csrc/stream_probe.cu: #6's TMA ring on #6's
  plan at B 100, without the products; (chunk, n_buf) sets no depth):
  "dma", "dequant" and the same bytes viewed as int32 ("dma-as-i32": on
  Hopper the bytes land in shared memory the same way whatever their type,
  so this line is expected to equal "dma"; JAX viewed them so to isolate
  TPU tile packing);
- the MLP alone (#20): int8 with and without gelu and the scale, and bf16
  weights through the same code.

GB/s are JAX's byte counts: bytes_q8 = L (C^2 + 2 C H) for the full
layers, bytes_probe = L 2 C H for the stream alone, twice that for bf16.
The chunk / n_buf points are the JAX sweep's (RING_CHUNKS and the other
module constants; a point with fewer chunks than stages is skipped, as in
JAX). A point the wrapper refuses (for #17 / #18 / #19 a chunk outside
their contract, none of the sweeps')
prints FAILED with the wrapper's ValueError, and the sweep goes on; any
other exception propagates.

Timing (rqvae_tpu_torch/tools/_timing.py): on the card each chain of L x
ITERS calls is captured once in a torch.cuda.CUDAGraph and replayed, best
of 3, under CUDA events: the device time that JAX's one jitted lax.scan
measured, per iteration of L layers. Each replay adds its launches to the
wrapper's count. An eager-loop line follows each point. On the CPU
(device=cpu) every line reads the host clock: it shows that the experiment
runs, not a rate.

    python -m rqvae_tpu_torch.tools.exp_q8_pipeline [B] [device=cpu]   (default B 100)

Env: EXP_ITERS (chain iterations, default 30), EXP_SKIP_SWEEPS,
EXP_SKIP_PROBES (as in JAX).
"""

from __future__ import annotations

import os
import sys

import torch

from rqvae_tpu_torch import resolve_device
from rqvae_tpu_torch.models.rqtransformer.model import quantize_weight
from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from rqvae_tpu_torch.ops import q8_pipeline_kernel as QP
from rqvae_tpu_torch.tools._timing import BEST_OF, card_line, time_chain

# the JAX experiment's points (tools/exp_q8_pipeline.py:449-457, :495-507,
# :510-557, :560-635)
CHECK_CHUNK = 1536  # the ring and packed numeric checks
RING_CHUNKS = (1536, 768, 512)
RING_NBUF = (2, 3, 4, 6)
PACKED_CHUNKS = (1536, 768, 3072)
PACKED_NBUF = (2, 3, 4)
PROBE_POINTS = ((1536, 4), (768, 4))
I32_POINTS = ((1536, 4),)
ABLATE_CHUNK, ABLATE_NBUF, ABLATE_NBUF_BF16 = 1536, 4, 2
ABLATE_CASES = (  # (name, int8 weights, use_gelu, use_scale)
    ("q8 full           ", True, True, True),
    ("q8 no-gelu        ", True, False, True),
    ("q8 no-gelu-noscale", True, False, False),
    ("bf16 same-ring    ", False, True, True),
)


def _pad(s):
    return f"{s:9s}"


def launches_per_point(iters: int, L: int) -> int:
    """Launches of a point's kernel that main counts on the card: the eager
    chain of L x iters calls BEST_OF times, one warm-up call, the chain once
    at capture and BEST_OF replays of it."""
    return (2 * BEST_OF + 1) * iters * L + 1


def main(argv=None, device=None, C=1536, H=6144, L=16) -> dict:
    """Run the experiment at batch B (argv, default 100); a `device=`
    argument or keyword picks the device (default: the first CUDA device,
    raising without one). C, H, L: the layer geometry. Returns {"lines":
    every line printed, "points": [(wrapper name, label, ok)] for each timed
    point, "failed": the FAILED lines}."""
    args = list(sys.argv[1:] if argv is None else argv)
    for a in [a for a in args if a.startswith("device=")]:
        device = a.split("=", 1)[1]
        args.remove(a)
    dev = resolve_device(device)
    B = int(args[0]) if args else 100
    iters = int(os.environ.get("EXP_ITERS", "30"))
    lines, points, failed = [], [], []

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

    def timed(wrapper, label, layer, x0, nbytes, unit):
        """Time the chain x -> layer(i, x) over the L layers, ITERS times;
        print the JAX line and the eager-loop line."""
        def chain():
            v = x0
            for _ in range(iters):
                for i in range(L):
                    v = layer(i, v)
            return v

        t, eager = time_chain(chain, iters, dev, {wrapper: iters * L}, warm=lambda: layer(0, x0))
        out(f"{label}: {t * 1e3:7.2f} ms  {nbytes / t / 1e9:6.0f} GB/s ({unit})")
        out(f"{label}: eager loop {eager * 1e3:7.2f} ms per iteration of {L} layers (host dispatch included; "
            f"the line above: {clock})")
        points.append((wrapper.__name__, label, True))

    def attempt(wrapper, label, fail_label, fn):
        """fn(), or a FAILED line for a point the wrapper refuses (ValueError)."""
        try:
            fn()
        except ValueError as e:
            line = f"{fail_label}: FAILED {type(e).__name__}: {str(e)[:120]}"
            out(line)
            failed.append(line)
            points.append((wrapper.__name__, label, False))

    def shipped(i, v):
        return DK.fused_proj_mlp_q8(v, y, *wos[i], bo, lns, lnb, *w1s[i], b1, *w2s[i], b2)

    timed(DK.fused_proj_mlp_q8, "q8 grid-pipeline (shipped)", shipped, x, bytes_q8, "int8 bytes")

    def diff(a, b):
        d = (a.float() - b.float()).abs()
        return f"mean|d| {float(d.mean()):.6f} max|d| {float(d.max()):.6f}"

    o_ref = shipped(0, x)
    o_ring = QP.fused_proj_mlp_q8_ring(x, y, *wos[0], bo, lns, lnb, *w1s[0], b1, *w2s[0], b2, chunk=CHECK_CHUNK)
    out(f"ring vs shipped: {diff(o_ring, o_ref)}")

    skip_sweeps = bool(os.environ.get("EXP_SKIP_SWEEPS"))
    for chunk in () if skip_sweeps else RING_CHUNKS:
        for n_buf in RING_NBUF:
            if H // chunk < n_buf:
                continue
            label = f"q8 ring chunk={chunk:5d} n_buf={n_buf}"

            def ring(i, v, _c=chunk, _n=n_buf):
                return QP.fused_proj_mlp_q8_ring(v, y, *wos[i], bo, lns, lnb, *w1s[i], b1, *w2s[i], b2,
                                                 chunk=_c, n_buf=_n)

            attempt(QP.fused_proj_mlp_q8_ring, label, label,
                    lambda: timed(QP.fused_proj_mlp_q8_ring, label, ring, x, bytes_q8, "int8 bytes"))

    def packed_weights(chunk):
        return [QP.pack_w1(w[0], chunk) for w in w1s], [QP.pack_w2(w[0], chunk) for w in w2s]

    w1p, w2p = packed_weights(CHECK_CHUNK)
    o_p = QP.fused_proj_mlp_q8_packed(x, y, *wos[0], bo, lns, lnb, w1p[0], w1s[0][1], b1, w2p[0], w2s[0][1], b2,
                                      chunk=CHECK_CHUNK, n_buf=2)
    out(f"packed vs shipped: {diff(o_p, o_ref)}")
    del w1p, w2p

    for chunk in () if skip_sweeps else PACKED_CHUNKS:
        for n_buf in PACKED_NBUF:
            if H // chunk < n_buf:
                continue
            label = f"q8 PACKED chunk={chunk:5d} n_buf={n_buf}"
            w1p, w2p = packed_weights(chunk)

            def packed(i, v, _c=chunk, _n=n_buf, _w1=w1p, _w2=w2p):
                return QP.fused_proj_mlp_q8_packed(v, y, *wos[i], bo, lns, lnb, _w1[i], w1s[i][1], b1, _w2[i],
                                                   w2s[i][1], b2, chunk=_c, n_buf=_n)

            attempt(QP.fused_proj_mlp_q8_packed, label, label,
                    lambda: timed(QP.fused_proj_mlp_q8_packed, label, packed, x, bytes_q8, "int8 bytes"))
            del w1p, w2p

    # the chunk stream alone: the copies, then the copies and the widening
    bytes_probe = L * 2 * C * H
    skip_probes = bool(os.environ.get("EXP_SKIP_PROBES"))
    acc0 = torch.zeros((1, QP.PROBE_LANES), dtype=torch.float32, device=dev)

    def probe_points(mode, points_, as_i32):
        for chunk, n_buf in () if skip_probes else points_:
            name = "dma-as-i32" if as_i32 else _pad(mode)
            label = f"probe {name} chunk={chunk:5d} n_buf={n_buf}"
            fail = f"probe {'dma-as-i32' if as_i32 else mode} chunk={chunk}"

            def run(_c=chunk, _n=n_buf):
                w1p, w2p = packed_weights(_c)
                if as_i32:
                    w1p, w2p = [w.view(torch.int32) for w in w1p], [w.view(torch.int32) for w in w2p]

                def probe(i, s):
                    return s + QP.stream_probe(w1p[i], w2p[i], chunk=_c, n_buf=_n, mode=mode)

                timed(QP.stream_probe, label, probe, acc0, bytes_probe, "int8 bytes")

            attempt(QP.stream_probe, label, fail, run)

    for mode in ("dma", "dequant"):
        probe_points(mode, PROBE_POINTS, False)
    probe_points("dma", I32_POINTS, True)

    # the MLP alone: which compute fails to hide under the copies?
    h0 = normal(B, C).to(bf)
    for name, int8, use_gelu, use_scale in ABLATE_CASES:
        chunk = ABLATE_CHUNK
        nb = ABLATE_NBUF if int8 else ABLATE_NBUF_BF16  # bf16 chunks are 2x bytes
        label = f"ablate {name} chunk={chunk} n_buf={nb}"

        def run(_c=chunk, _n=nb, _g=use_gelu, _s=use_scale, _q=int8):
            if _q:
                w1p, w2p = packed_weights(_c)
            else:  # the dequantized weights, as JAX: q.astype(bf16) * scale.astype(bf16)
                w1p = [QP.pack_w1(q.to(bf) * s[:, None], _c) for q, s in w1s]
                w2p = [QP.pack_w2(q.to(bf) * s[:, None], _c) for q, s in w2s]

            def ablate(i, v):
                return QP.ablate_ring(v, w1p[i], w1s[i][1], w2p[i], w2s[i][1], chunk=_c, n_buf=_n,
                                      use_gelu=_g, use_scale=_s)

            timed(QP.ablate_ring, label, ablate, h0, bytes_probe * (1 if _q else 2), "weight bytes")

        attempt(QP.ablate_ring, label, f"ablate {name}", run)

    return {"lines": lines, "points": points, "failed": failed}


if __name__ == "__main__":
    main()
