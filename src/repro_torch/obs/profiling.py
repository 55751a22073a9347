"""Kernel profiling hooks: named scopes for the compression stages and
opt-in ``torch.profiler`` capture (DESIGN.md §14; the port of
``repro.obs.profiling``).

Device profiles should attribute time to the stages KVComp adds (the Fetch
kernel's in-situ-decompression attention, the Store's ``pack_encode``, the
huffman slot LUT decode, the blockwise span scan), not to one stream of
anonymous kernels.  ``annotate(name)`` puts a region under a
``kvcomp/<name>`` scope: a ``torch.profiler.record_function`` range, which
the profiler also draws on the device track around the kernels launched
inside it.  ``annotation(name)`` is the host-region counterpart
(``kvcomp:<name>``), and ``trace_capture(dir)`` records a block with
``torch.profiler.profile`` and writes its Chrome trace into ``dir``.

The reference's scope is a trace-time ``jax.named_scope`` that costs nothing
when the compiled step runs.  Here the scope is entered on every call, about
a hundred times a decode step, on a path that is already host-bound; so
outside a capture ``annotate`` does no work that reaches the profiler: it
returns a shared no-op context, chosen by a flag that ``trace_capture``
sets.  A capture that fails raises: nothing here swallows a profiler error.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["annotate", "annotation", "trace_capture"]

SCOPE_PREFIX = "kvcomp"

# True while ``trace_capture`` records: the only time ``annotate`` opens a
# profiler range.
_capturing = False


class _Idle(contextlib.nullcontext):
    """The scope outside a capture: a no-op context that, used as a
    decorator, chooses the scope again at every call of the function."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def __call__(self, fn):
        @functools.wraps(fn)
        def scoped(*args, **kwargs):
            with annotate(self.name):
                return fn(*args, **kwargs)

        return scoped


_idle: dict[str, _Idle] = {}


def annotate(name: str):
    """``kvcomp/<name>`` scope around a region, as a context manager or a
    decorator: a ``torch.profiler.record_function`` range during a capture,
    else one shared no-op context per name."""
    if _capturing:
        return torch.profiler.record_function(f"{SCOPE_PREFIX}/{name}")
    idle = _idle.get(name)
    if idle is None:
        idle = _idle[name] = _Idle(name)
    return idle


def annotation(name: str):
    """Host-side profiler range ``kvcomp:<name>`` around a region (always a
    ``record_function``: host regions are entered rarely)."""
    return torch.profiler.record_function(f"{SCOPE_PREFIX}:{name}")


@contextlib.contextmanager
def trace_capture(log_dir):
    """Record the block with ``torch.profiler`` (host, and the card when
    there is one) and write a Chrome trace (``*.pt.trace.json``, loadable in
    Perfetto) into ``log_dir``; yields the profiler, so a caller can read
    ``key_averages()`` or ``events()``.  ``None`` (or "") records nothing
    and yields None.  Profiler errors propagate."""
    global _capturing
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    if _capturing:
        raise RuntimeError("trace_capture: a capture is already recording")
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        _capturing = True
        try:
            yield prof
        finally:
            _capturing = False
