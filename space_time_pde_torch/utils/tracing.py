"""Named spans over the port's layers, timed on the host and on the card.

The port's only timing facility. Off by default: :func:`span` is then
one flag check returning a shared null context, so it records nothing,
allocates nothing, registers no hook and puts no event into a CUDA
graph. :func:`enable` / :func:`disable` switch it; a captured graph
holds the spans' events when tracing was on while it was captured
(``train/trainer.py::CapturedStep``), and every replay times them again.

While on, a span keeps

- a host record (:class:`Record`): its name, start and end on
  ``time.perf_counter_ns``, the span it opened in, the dispatch it ran
  in and its occurrence there (a train span's inner-step index);
- a ``torch.profiler.record_function`` range, only while a profiler is
  active, so that the host spans sit on the profiler trace's clock;
- once CUDA is in use, a pair of timing CUDA events recorded on the
  current stream, made with ``external=True``: under graph capture each
  record is an event-record node of the graph.

A dispatch (:func:`scope`) is one call of a step function (its
``n_inner`` optimizer steps) or one decode window; a span opened
outside any dispatch opens its own. The events are made once for each
(name, occurrence in a dispatch) and reused by every later dispatch, so
tracing allocates no event a step. :func:`device_ms` reads the last
dispatch that opened spans: its events after a synchronise (for a
captured step, the graph's last replay), or its host records where it
recorded no event (on the CPU, whose work runs in the calling thread).

The backward pass is one chain of spans: ``span("backward.pde")``
around ``loss.backward()``, and :func:`hand_over` hooks on the
forward's tensors that, once their gradients are computed, end the
open backward span and open the next one. Autograd runs a tensor's
hooks on the stream of the operation that made it, so their events
land on the step's stream.

Span names (:data:`NAMES`), where they are opened and what they hold:

``step``             ``train/trainer.py::make_train_step``: a whole
                     optimizer step, parent of the train spans below
``batch``            ``data/device_pipeline.py::DeviceSampler.wrap_loss``:
                     the crop and point reads, normalisation
``encode``           ``make_loss_fn``: the UNet3d / UNet4d forward
``jet_fwd``          ``make_loss_fn``: the query's corner gather and jet
                     (or plain query) forward
``pde``              ``make_loss_fn``: regression loss, PDE residuals,
                     their sum
``backward.pde``     the loss and PDE residuals' backward, up to the
                     jet's outputs' gradients
``backward.jet``     the jet backward and the gather's scatter-add, up
                     to the latent's gradient
``backward.encode``  the encoder's backward, to the end of backward
``optim``            ``train/optim.py::Optimizer.step``: global norm,
                     clip, Adam
``decode.encode``    ``inference.py::make_dense_decoder``: the UNet
                     forward of a decode window
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["NAMES", "Record", "device_ms", "disable", "enable", "enabled",
           "hand_over", "records", "scope", "span"]

NAMES = ("step", "batch", "encode", "jet_fwd", "pde", "backward.pde",
         "backward.jet", "backward.encode", "optim", "decode.encode")

_NULL = contextlib.nullcontext()
_on = False


class Record:
    """One span's host record; ``events`` is its CUDA event pair or
    None."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "dispatch",
                 "index", "events", "range", "implicit")

    def __init__(self, name, parent, dispatch, index, implicit):
        self.name, self.parent = name, parent
        self.dispatch, self.index = dispatch, index
        self.implicit = implicit
        self.events = self.range = None
        self.start_ns = time.perf_counter_ns()
        self.end_ns = None

    def __repr__(self):
        return (f"Record({self.name!r}, parent={self.parent!r}, "
                f"dispatch={self.dispatch}, index={self.index})")


class _State:
    def __init__(self):
        self.dispatches = 0      # dispatches opened since enable()
        self.ident = None        # the open dispatch's index
        self.current: Optional[List[Record]] = None
        self.counts: Dict[str, int] = {}
        self.stack: List[Record] = []
        self.last: List[Record] = []
        self.events: Dict[Tuple[str, int, int], Tuple] = {}


_S = _State()


def enable() -> None:
    """Tracing on: spans record from here, and a graph captured from here
    holds their events. Dispatches are numbered from 0 again."""
    global _on
    _on = True
    _S.dispatches, _S.ident, _S.current = 0, None, None
    _S.counts, _S.stack, _S.last = {}, [], []


def disable() -> None:
    """Tracing off. The last dispatch's spans stay readable, and a graph
    captured while it was on keeps timing them."""
    global _on
    _on = False
    _S.current, _S.stack = None, []


def enabled() -> bool:
    return _on


def _open() -> None:
    _S.ident = _S.dispatches
    _S.dispatches += 1
    _S.current, _S.counts = [], {}


def _close() -> None:
    if _S.current:
        _S.last = _S.current
    _S.current = None


def _begin(name: str) -> None:
    if name not in NAMES:
        raise ValueError(f"no span {name!r}; the spans are {NAMES}")
    implicit = _S.current is None
    if implicit:
        _open()
    index = _S.counts.get(name, 0)
    _S.counts[name] = index + 1
    rec = Record(name, _S.stack[-1].name if _S.stack else None, _S.ident,
                 index, implicit)
    if torch.autograd._profiler_enabled():
        rec.range = torch.autograd.profiler.record_function(name)
        rec.range.__enter__()
    if torch.cuda.is_initialized():
        stream = torch.cuda.current_stream()
        key = (name, index, stream.device_index)
        pair = _S.events.get(key)
        if pair is None:
            pair = _S.events[key] = tuple(
                torch.cuda.Event(enable_timing=True, external=True)
                for _ in range(2))
        pair[0].record(stream)
        rec.events = pair
    _S.current.append(rec)
    _S.stack.append(rec)


def _end() -> None:
    if not _S.stack:            # tracing was switched off inside the span
        return
    rec = _S.stack.pop()
    if rec.events is not None:
        rec.events[1].record(torch.cuda.current_stream())
    if rec.range is not None:
        rec.range.__exit__(None, None, None)
    rec.end_ns = time.perf_counter_ns()
    if rec.implicit:
        _close()


class _Span:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _begin(self.name)

    def __exit__(self, *exc):
        _end()          # the innermost open span: a hand-over renames it
        return False


class _Scope:
    __slots__ = ()

    def __enter__(self):
        _open()

    def __exit__(self, *exc):
        _close()
        return False


def span(name: str):
    """A context manager timing the block as the span ``name`` (one of
    :data:`NAMES`); the shared null context while tracing is off."""
    if not _on:
        return _NULL
    return _Span(name)


def scope():
    """A context manager around one dispatch, numbered from 0 at
    :func:`enable`: the spans opened in it are numbered from 0 by name.
    Inside an open dispatch, or while tracing is off, the shared null
    context."""
    if not _on or _S.current is not None:
        return _NULL
    return _Scope()


def hand_over(tensors: Sequence[torch.Tensor], ended: str,
              opened: str) -> None:
    """Once the gradients of ``tensors`` are computed, end the open span
    ``ended`` and open ``opened`` in its place (nothing while tracing is
    off, or where ``ended`` is not the innermost open span then)."""
    if not _on:
        return
    tensors = [t for t in tensors if t.requires_grad]
    if not tensors:
        return

    def hook(_grads):
        if _S.stack and _S.stack[-1].name == ended:
            _end()
            _begin(opened)

    torch.autograd.graph.register_multi_grad_hook(tensors, hook)


def records() -> List[Record]:
    """The host records of the last dispatch that opened spans, in the
    order they opened."""
    return list(_S.last)


def device_ms() -> Dict[str, Tuple[float, int]]:
    """``{name: (milliseconds, occurrences)}`` of the last dispatch that
    opened spans: the milliseconds summed over the name's occurrences,
    between its CUDA events (each waited for first), or on its host
    records where it has none."""
    out: Dict[str, Tuple[float, int]] = {}
    for rec in _S.last:
        if rec.events is not None:
            start, end = rec.events
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (rec.end_ns - rec.start_ns) / 1e6
        total, n = out.get(rec.name, (0.0, 0))
        out[rec.name] = (total + ms, n + 1)
    return out
