"""A stretch of host time cut into phases at shared clock reads.

A :class:`Split` divides one stretch (a served step) into leaf phases that
follow each other without a gap, grouped into nested regions. A leaf ends
at ONE read of the caller's clock, and the next leaf starts at that same
read, so the leaves' seconds (:attr:`Split.seconds`) sum to the stretch
exactly, up to float rounding. Opening or closing a region ends the
running leaf first; a region never reads the clock of its own. Always on,
a leaf costs a clock read and a dict add.

While tracing is on or a ``torch.profiler`` session records, every region
and leaf is also a :class:`~.trace.Span` named ``prefix + name``, begun
and ended at its boundary reads: a tracer span (spans opened live inside
it nest under it, and each leaf's lasts exactly the seconds its phase
gained) and a ``record_function`` range, as the span decides
(``obs/trace.py``). Otherwise no span is made.

:data:`NO_SPLIT` takes the same calls and does nothing, for callers that
do not split.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

from .trace import Span, Tracer


class Split:
    """Leaf phases and nested regions of one stretch; see the module.

    ``seconds`` maps each phase to the seconds it took in this stretch;
    ``device`` is the caller's to fill (device seconds by card, on a
    served step). The stretch starts at a clock read made here. ``spans``
    makes every region and leaf a span of ``tracer`` (None: a profiler
    range alone).
    """

    __slots__ = ("clock", "t", "seconds", "device", "_prefix", "_tracer",
                 "_spans", "_leaf", "_open")

    def __init__(self, clock: Callable[[], float], phases: Iterable[str], *,
                 prefix: str = "", tracer: Optional[Tracer] = None,
                 spans: bool = False):
        self.clock = clock
        self.t = clock()
        self.seconds = dict.fromkeys(phases, 0.0)
        self.device: dict = {}
        self._prefix = prefix
        self._tracer = tracer
        self._spans = spans
        self._leaf: Optional[str] = None
        self._open: list = []       # live spans: regions, the leaf on top

    def _begin(self, name: str, attrs: dict) -> None:
        self._open.append(
            Span(self._tracer, self._prefix + name, attrs).begin(self.t))

    def to(self, phase: Optional[str] = None, **attrs: Any) -> float:
        """End the running leaf at one clock read, and start ``phase``
        (None: none) at that read; returns the read. With no leaf running
        nothing is read, and ``phase`` starts at the last read."""
        if self._leaf is not None:
            now = self.clock()
            self.seconds[self._leaf] += now - self.t
            self.t = now
            if self._spans:
                self._open.pop().end(now)
        self._leaf = phase
        if phase is not None and self._spans:
            self._begin(phase, attrs)
        return self.t

    def open(self, name: str, **attrs: Any) -> None:
        """Open the region ``name`` at the boundary (ending the running
        leaf)."""
        self.to(None)
        if self._spans:
            self._begin(name, attrs)

    def close(self, **attrs: Any) -> None:
        """Close the innermost open region at the boundary (ending the
        running leaf); ``attrs`` are added to its span."""
        self.to(None)
        if self._spans:
            self._open.pop().set(**attrs).end(self.t)

    def abort(self) -> None:
        """Close everything still open (a stretch cut short by an error),
        so no span stays on the stack and no profiler range stays open."""
        self.to(None)
        while self._open:
            self._open.pop().end(self.t)


class NoSplit:
    """Takes a :class:`Split`'s calls and does nothing; ``device`` is None,
    so a caller knows not to time the device for it."""

    __slots__ = ()
    device = None

    def to(self, phase: Optional[str] = None, **attrs: Any) -> float:
        return 0.0

    def open(self, name: str, **attrs: Any) -> None:
        pass

    def close(self, **attrs: Any) -> None:
        pass


NO_SPLIT = NoSplit()
