"""Capture and replay of the fused engine's pure functions as CUDA graphs.

PyTorch's counterpart of a jitted function: a ``Graph`` holds one pure
function of no arguments that reads tensors its engine owns (and never
reallocates) and returns its outputs, or copies them into such tensors.
On a CUDA device the first call captures it: it runs once eagerly on a
side stream (a kernel's first launch of a size may set attributes and
cuBLAS and cuDNN make their handles, which a capture must not see), with
the tensors it writes (``writes``) saved before and restored after, so
the warm-up leaves no trace; then ``torch.cuda.graph`` records it into
the engine's memory pool. Every call after that replays it. On the CPU
every call runs the function eagerly: the same arithmetic, through the
kernels' plain versions. There is no fallback: a capture that fails
raises.

Outputs that the function returns live in the pool and stay valid until
another graph of the pool replays; callers read them first.

Counts: ``COUNTS[label]`` holds the captures and replays of every graph
of that label (``reset_counts`` zeroes them). The kernel wrappers count
their launches in ``kernels.build.LAUNCHES`` when they launch; a capture
records launches without running them, so the wrappers' counts during a
capture are taken back and added again at each replay, which launches
them.
"""
from __future__ import annotations

import gc
from collections import defaultdict
from typing import Callable, Optional, Sequence

import torch

from ..kernels import build

COUNTS: dict = defaultdict(lambda: {"captures": 0, "replays": 0})


def reset_counts() -> None:
    COUNTS.clear()


class Graph:
    """``fn`` captured once on ``device`` (CUDA) and replayed, or run
    eagerly (CPU). ``writes``: every tensor ``fn`` updates in place."""

    def __init__(self, label: str, fn: Callable, device,
                 writes: Sequence[torch.Tensor] = (), pool=None):
        self.label, self.fn = label, fn
        self.device = torch.device(device)
        self.writes = list(writes)
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.launches: dict = {}

    def __call__(self):
        if self.device.type != "cuda":
            return self.fn()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for k, v in self.launches.items():
            build.LAUNCHES[k] += v
        COUNTS[self.label]["replays"] += 1
        return self.out

    def _capture(self):
        saved = [t.clone() for t in self.writes]
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.fn()
            for t, s in zip(self.writes, saved):
                t.copy_(s)
        main.wait_stream(side)
        before = dict(build.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        # The cyclic garbage collector is paused while capturing: run
        # there, it can destroy an earlier engine's unreachable graphs
        # (CUDAGraph reset is not permitted while a stream captures), and
        # the capture then fails as invalidated (seen in
        # tests/test_torch_gpu.py's epoch-graph test, run after the
        # per-batch one in the same process).
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = self.fn()
        finally:
            if collecting:
                gc.enable()
        self.launches = {k: v - before[k] for k, v in build.LAUNCHES.items()
                         if v != before[k]}
        build.LAUNCHES.update(before)
        self.graph, self.out = graph, out
        COUNTS[self.label]["captures"] += 1
