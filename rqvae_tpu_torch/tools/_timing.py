"""Timing of the ported kernel experiments: a chain of calls captured once
in a CUDA graph and replayed under CUDA events (the device time that the
JAX experiments' one jitted lax.scan measured), beside the same chain run
eagerly; and the card's name and power limit.

On the CPU (device=cpu) both times are the eager loop's on the host clock:
a check that an experiment runs, not a rate.
"""

from __future__ import annotations

import subprocess
import time

import torch

BEST_OF = 3


def _best_s(run, iters, dev) -> float:
    """Best of BEST_OF runs of run() (ITERS calls), in seconds per call: CUDA
    events on the card, the host clock on the CPU."""
    best = float("inf")
    for _ in range(BEST_OF):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize(dev)
            s = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            run()
            s = time.perf_counter() - t0
        best = min(best, s / iters)
    return best


def time_chain(chain, iters, dev, launches, warm=None) -> tuple[float, float]:
    """(graph seconds per call, eager seconds per call) of chain(), a closure
    that runs `iters` dependent calls. On the card, warm() (one call; chain()
    when None) runs once on a side stream, chain() is captured once in a CUDA
    graph, and each replay adds its launches to the wrappers' counts:
    `launches` maps each kernel wrapper to the launches one chain() makes (a
    replay relaunches them without passing through the wrapper). On the CPU
    both times are the eager loop's."""
    eager = _best_s(chain, iters, dev)
    if dev.type != "cuda":
        return eager, eager
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm up off the capture, as torch.cuda.graph asks
        (warm or chain)()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain()
    torch.cuda.synchronize(dev)

    def replay():
        graph.replay()
        for wrapper, n in launches.items():
            wrapper.launches += n

    return _best_s(replay, iters, dev), eager


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]
