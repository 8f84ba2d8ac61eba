"""torch.profiler hooks: Chrome traces of train and serve.

``trace_session(dir)`` profiles the enclosed block (host ops, and the
card's kernels when CUDA is available) and writes a Chrome trace into
``dir`` (nothing happens when ``dir`` is falsy: the ``--profile-dir``
gate). ``annotate`` and ``step_annotation`` mark host regions on the
trace's timeline as ``record_function`` spans; the round engines mark
each round with ``experiments.runner.ROUND_SPAN``.

Open the trace at https://ui.perfetto.dev or in ``chrome://tracing``. A
failure of the profiler raises: torch.profiler is part of torch, so no
run is without it.
"""
from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace_session(profile_dir=None, filename: str = "trace.json"):
    """Profile the enclosed block into ``profile_dir/filename`` (a Chrome
    trace JSON); a no-op when ``profile_dir`` is falsy. Yields the
    ``torch.profiler.profile`` (None when off)."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(str(profile_dir), filename))


def annotate(name: str):
    """A named host span (``record_function``)."""
    return torch.profiler.record_function(name)


def step_annotation(name: str, step: int):
    """A host span carrying a step number, named ``name#step`` (the
    JAX package's ``StepTraceAnnotation``)."""
    return torch.profiler.record_function(f"{name}#{int(step)}")
