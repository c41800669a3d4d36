"""What a traced run (``--trace 1``) records, from the benchmark's side of
the program's calls:

- spans: host-clock time of the kind's span targets (module functions that
  the kind names, wrapped while the run lasts) and of the kind's own
  ``spans(name)`` blocks; inside the profiled window each is also a
  ``torch.profiler.record_function`` range ``zkbench.<name>``;
- launches: every ``backend.launch``, with CUDA events on its stream around
  it, the op's least time from its cost file, and the MSM it falls in;
- MSMs: each ``msm._msm_impl`` call's wall time, with the card
  synchronised before and after it (in the window; a span alone in the
  profiled rounds);
- the profiler's device activity over the profiled window: the union of
  kernel and copy intervals, the kernels by name, and the idle gaps with
  the innermost span the host was in.

Nothing here runs in an untraced run, where only ``NullSpans`` is used.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import time


class NullSpans:
    """The untraced run's spans: nothing recorded."""

    def __call__(self, name: str):
        return contextlib.nullcontext()


class Tracer:
    def __init__(self, costs, span_targets):
        import torch

        self.torch = torch
        self.costs = costs
        self.targets = span_targets
        self.span_s = collections.Counter()
        self.span_calls = collections.Counter()
        self.window_span_s = self.span_s      # the window's alone, once profiling starts
        self.window_span_calls = self.span_calls
        self.intervals = []       # (name, start, end) on the host clock, while profiled
        self.pending = []         # (op, least_s, start event, end event, msm index)
        self.launches = []        # (op, class, least_s, card_s, msm index): the window's
        self.profiled_launches = []  # the same, of the profiled rounds
        self._sink = self.launches
        self.msm_wall_s = []
        self._msm = None          # index of the MSM being run
        self._sync_msm = True
        self._saved = []
        self.prof = None
        self.prof_start = self.prof_end = None

    # -- spans -------------------------------------------------------------
    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = (self.torch.profiler.record_function(f"zkbench.{name}") if self.prof is not None
               else contextlib.nullcontext())
        with ctx:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                self.span_s[name] += t1 - t0
                self.span_calls[name] += 1
                if self.prof is not None:
                    self.intervals.append((name, t0, t1))

    def _wrap(self, owner, attr, replacement):
        self._saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, replacement)

    def install_spans(self) -> None:
        """Wrap the kind's span targets (host clock only, no synchronisation)."""
        for module, attr, name in self.targets:
            owner = importlib.import_module(module)
            fn = getattr(owner, attr)

            def spanned(*args, _fn=fn, _name=name, **kwargs):
                with self(_name):
                    return _fn(*args, **kwargs)

            self._wrap(owner, attr, spanned)

    def install_device_taps(self) -> None:
        """Time every launch by CUDA events and every MSM with the card
        synchronised around it."""
        from zkfl_tpu_torch import backend
        from zkfl_tpu_torch.ops import msm

        torch = self.torch
        launch = backend.launch

        def timed_launch(entry, count_as, *args):
            least = self.costs.least_s(count_as, args)  # raises for an op without a cost file
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            launch(entry, count_as, *args)
            end.record()
            self.pending.append((count_as, least, start, end, self._msm))

        impl = msm._msm_impl

        def timed_msm(*args, **kwargs):
            if not self._sync_msm:  # the profiled rounds: a span alone
                with self("msm"):
                    return impl(*args, **kwargs)
            torch.cuda.synchronize()
            self._msm = len(self.msm_wall_s)
            self.msm_wall_s.append(0.0)
            t0 = time.perf_counter()
            try:
                with self("msm"):
                    out = impl(*args, **kwargs)
                    torch.cuda.synchronize()
            finally:
                self.msm_wall_s[self._msm] = time.perf_counter() - t0
                self._msm = None
            return out

        self._wrap(backend, "launch", timed_launch)
        self._wrap(msm, "_msm_impl", timed_msm)

    def for_profile(self) -> None:
        """Before the profiled rounds: keep the window's span totals apart,
        stop synchronising around the MSMs (they stay spans; the launches'
        events stay, recorded apart)."""
        self.settle()
        self.window_span_s = collections.Counter(self.span_s)
        self.window_span_calls = collections.Counter(self.span_calls)
        self._sync_msm = False
        self._sink = self.profiled_launches

    def uninstall(self) -> None:
        while self._saved:
            owner, attr, fn = self._saved.pop()
            setattr(owner, attr, fn)

    def settle(self) -> None:
        """Read the card times of the launches made so far (after a round)."""
        self.torch.cuda.synchronize()
        for op, least, start, end, msm in self.pending:
            self._sink.append((op, self.costs.cost(op)["class"], least,
                                  start.elapsed_time(end) / 1e3, msm))
        self.pending = []

    # -- the profiled window -------------------------------------------------
    def start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.prof_start = time.perf_counter()
        with self.torch.profiler.record_function("zkbench.clock"):
            self.clock_mark = time.perf_counter()

    def stop_profile(self) -> None:
        self.settle()
        self.prof_end = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def device_activity(self) -> dict:
        """From the profiled rounds: the device's busy seconds (the union of
        its kernel, copy and set intervals) and the window's seconds; the
        device ops' seconds by name; the idle stretches' seconds by the
        innermost span the host was in; and the program's launches matched
        in order to their kernels' profiled durations (``kernel_rows``:
        class, least seconds, card seconds).  Where the profiler saw another
        number of the program's kernels than there were launches, nothing
        can be matched: ``kernel_rows`` is None, the rooflines read nothing,
        and the program's kernels are listed under their kernel names
        instead of their op names."""
        events = self.prof.profiler.kineto_results.events()
        mark = next(e for e in events if e.name() == "zkbench.clock")
        offset = mark.start_ns() / 1e9 - self.clock_mark   # kineto clock - host clock
        w0, w1 = self.prof_start + offset, self.prof_end + offset
        device = []
        for e in events:
            # device-side intervals, less the record_function ranges' images
            if "CUDA" in str(e.device_type()) and not e.name().startswith("zkbench."):
                s = e.start_ns() / 1e9
                t = s + e.duration_ns() / 1e9
                if min(t, w1) > max(s, w0):
                    device.append((max(s, w0), min(t, w1), e.name()))
        device.sort()
        gaps = idle_gaps([(s, t) for s, t, _ in device], w0, w1)
        busy = (w1 - w0) - sum(t - s for s, t in gaps)
        spans = [(s + offset, t + offset, n) for n, s, t in self.intervals]
        own_names = {self.costs.cost(op)["kernel_name"] for op, *_ in self.profiled_launches}
        own = [(s, t, name) for s, t, name in device if kernel_base(name) in own_names]
        rows, ops = match_kernels(self.profiled_launches, own)
        for s, t, name in device:
            if kernel_base(name) not in own_names:
                ops[name[:120]] += t - s
        return {"busy_s": busy, "window_s": w1 - w0, "ops": ops,
                "gaps": attribute(gaps, spans), "kernel_rows": rows,
                "own_kernels": len(own), "launches": len(self.profiled_launches),
                "n_device_events": len(device)}


def match_kernels(launches, own):
    """The program's launches (op, class, least seconds, ...) matched in
    order to the profiler's intervals of its kernels (start, end, name):
    (rows of (class, least seconds, card seconds), card seconds by op).
    Where the counts differ there is no match: (None, card seconds by
    kernel name)."""
    ops = collections.Counter()
    if len(own) != len(launches):
        for s, t, name in own:
            ops[kernel_base(name)] += t - s
        return None, ops
    rows = []
    for (op, cls, least, *_), (s, t, _) in zip(launches, own):
        rows.append((cls, least, t - s))
        ops[op] += t - s
    return rows, ops


def kernel_base(name: str) -> str:
    """A kernel's function name without namespace, template arguments or
    parameters: "void (anonymous namespace)::g1_padd_kernel(...)" ->
    "g1_padd_kernel"."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = min((i for i in (name.find("("), name.find("<")) if i >= 0), default=len(name))
    return name[:cut].rsplit("::", 1)[-1].strip()


def idle_gaps(intervals, w0: float, w1: float) -> list:
    """The stretches of [w0, w1] that no interval covers."""
    gaps, reached = [], w0
    for s, t in sorted(intervals):
        if s > reached:
            gaps.append((reached, s))
        reached = max(reached, t)
    if w1 > reached:
        gaps.append((reached, w1))
    return gaps


def innermost(spans) -> list:
    """Nested spans (start, end, name) as a timeline of (start, end, name)
    pieces, each under the innermost span open there."""
    bounds = sorted({x for s, t, _ in spans for x in (s, t)})
    pieces, opened = [], sorted(spans)
    stack, k = [], 0
    for a, b in zip(bounds, bounds[1:]):
        while k < len(opened) and opened[k][0] <= a:
            stack.append(opened[k])
            k += 1
        stack = [sp for sp in stack if sp[1] > a]
        if stack:
            pieces.append((a, b, max(stack)[2]))
    return pieces


def attribute(gaps, spans) -> collections.Counter:
    """Each gap's seconds split over the innermost spans open during it;
    ``between_rounds`` where none is."""
    out = collections.Counter()
    pieces = innermost(spans)
    k = 0
    for s, t in gaps:
        covered = 0.0
        while k < len(pieces) and pieces[k][1] <= s:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < t:
            a, b, name = pieces[j]
            part = min(b, t) - max(a, s)
            if part > 0:
                out[name] += part
                covered += part
            j += 1
        if t - s - covered > 0:
            out["between_rounds"] += t - s - covered
    return out
