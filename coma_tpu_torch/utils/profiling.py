"""Profiling and timing helpers (counterpart of ``coma_tpu/utils/profiling.py``;
the reference has none, SURVEY.md §5: ad-hoc ``time()`` prints only).

- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json`` in ``log_dir``; open it in ui.perfetto.dev or
  chrome://tracing), with the card's activity when a card is present.
- :func:`sync`: waits for every tensor of a nested structure to be computed.
- :func:`timed`: best seconds per call; CUDA events when the output lies on
  the card, the host clock otherwise.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Iterator, Tuple

import torch


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('/tmp/trace'): run_step()`` -> ``/tmp/trace/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sync(tree) -> float:
    """Wait until every tensor in ``tree`` is computed (one
    ``torch.cuda.synchronize`` for each card they lie on); returns the sum of
    each tensor's first element, so the value is observably used."""
    total = 0.0
    devices = set()
    for t in _tensors(tree):
        if t.is_cuda:
            devices.add(t.device)
        if t.numel():
            total += float(t.reshape(-1)[0])
    for dev in devices:
        torch.cuda.synchronize(dev)
    return total


def _on_card(tree) -> bool:
    return any(t.is_cuda for t in _tensors(tree))


def timed(fn: Callable, *args, iters: int = 3, warmup: int = 1, **kwargs) -> Tuple[float, Any]:
    """(best seconds per call, last output). A call whose output lies on the
    card is timed by CUDA events around it; any other by the host clock
    after :func:`sync`."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        sync(out)
    best = float("inf")
    for _ in range(iters):
        if out is not None and _on_card(out):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            sync(out)
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(out)
            seconds = time.perf_counter() - t0
        best = min(best, seconds)
    return best, out
