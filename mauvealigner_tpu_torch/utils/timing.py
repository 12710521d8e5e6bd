"""The port's host spans and work counters.

The reference's observability is a progress ticker (LogProgress,
src/mauveAligner.cpp:482,532); here every pipeline phase is a span.
``PhaseTimer.phase(name)`` opens one: its path is the names of the spans
open on the calling thread, outermost first, joined by "/" (for example
``tree_progressive/pair_align/anchoring/k2_extend``).  ``phases[path]``
totals its seconds and ``calls[path]`` counts its entries; ``counters``
holds counts of work only (bases, sort entries, DP cells), never seconds.

A pool worker's spans nest under the span that submitted its task
(``path()`` in the caller, ``under(path)`` in the worker).  Such siblings
run concurrently, so their seconds may sum to more than their parent's.

While a torch profiler records, each span also opens the profiler range
``phase:<path>``, stamped on the clock of the device work launched inside
it; with none recording, no range is opened (a range costs about 30 times
the check even then).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Dict, Sequence, Tuple

import torch


class PhaseTimer:
    def __init__(self) -> None:
        # keyed by path, in the order the spans first opened (a parent
        # before its children)
        self.phases: "OrderedDict[str, float]" = OrderedDict()
        self.calls: Dict[str, int] = {}
        self.counters: Dict[str, float] = {}
        # spans close and counters accumulate on concurrent pool threads
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def path(self) -> Tuple[str, ...]:
        """The names of the spans open on this thread, outermost first."""
        return tuple(self._stack())

    @contextlib.contextmanager
    def under(self, path: Sequence[str]):
        """Open the body's spans under `path` (another thread's path())."""
        saved = getattr(self._local, "stack", None)
        self._local.stack = list(path)
        try:
            yield
        finally:
            self._local.stack = saved

    @contextlib.contextmanager
    def phase(self, name: str):
        stack = self._stack()
        stack.append(name)
        path = "/".join(stack)
        with self._lock:
            self.phases.setdefault(path, 0.0)
        t0 = time.perf_counter()
        try:
            if torch._C._autograd._profiler_enabled():
                with torch.profiler.record_function(f"phase:{path}"):
                    yield
            else:
                yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            with self._lock:
                self.phases[path] = self.phases.get(path, 0.0) + dt
                self.calls[path] = self.calls.get(path, 0) + 1

    def add(self, counter: str, value: float) -> None:
        with self._lock:
            self.counters[counter] = self.counters.get(counter, 0.0) + value

    def reset(self) -> None:
        with self._lock:
            self.phases.clear()
            self.calls.clear()
            self.counters.clear()

    def self_seconds(self, path: str) -> float:
        """A span's seconds less those of its direct children."""
        depth = path.count("/") + 1
        return self.phases[path] - sum(
            t for p, t in self.phases.items()
            if p.startswith(path + "/") and p.count("/") == depth
        )

    def report(self) -> str:
        """The span tree, each span under its parent in the order they first
        opened, then the counters."""
        first = {p: i for i, p in enumerate(self.phases)}

        def tree_order(path):
            names = path.split("/")
            return [first.get("/".join(names[:k]), -1) for k in range(1, len(names) + 1)]

        w = max([len(p) for p in self.phases] + [len("top-level spans")]) + 2
        lines = [f"{'span':<{w}}{'total s':>10}{'self s':>10}{'calls':>8}"]
        for path in sorted(self.phases, key=tree_order):
            lines.append(f"{path:<{w}}{self.phases[path]:>10.3f}"
                         f"{self.self_seconds(path):>10.3f}{self.calls.get(path, 0):>8d}")
        top = sum(t for p, t in self.phases.items() if "/" not in p)
        lines.append(f"{'top-level spans':<{w}}{top:>10.3f}")
        lines.append("self = total less the children's totals; children run on "
                     "pool threads at once may sum to more than their parent")
        for c, v in sorted(self.counters.items()):
            lines.append(f"{c}: {v:,.0f}")
        return "\n".join(lines) + "\n"


# process-global default timer (cheap; aligners use it when none is given)
GLOBAL = PhaseTimer()
