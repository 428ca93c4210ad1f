"""Timing on the card, shared by ``chip_smoke.py`` and the tools."""
from __future__ import annotations

import subprocess
import time

import numpy as np
import torch


def card():
    """The card's ``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters=20, warmup=10, repeats=5, graph=False):
    """Milliseconds per call of ``fn`` from CUDA events: the median over
    ``repeats`` runs of the mean of ``iters`` calls, after ``warmup``.

    ``graph=True`` captures the ``iters`` calls in one CUDA graph and times
    its replays: the device time of the calls, without the Python and launch
    time of the host between them. Without it the calls are enqueued back to
    back (an event loop): a kernel wrapper that takes longer on the host
    than its kernel on the card is then timed by the host.
    """
    for _ in range(warmup):
        fn()
    if graph:
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(iters):
                fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def host_ms(fn, iters=100):
    """Milliseconds of host time per call of ``fn``, enqueued back to back
    (the card is not waited for until the end)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3
