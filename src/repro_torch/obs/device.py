"""Device instants on the tracer's clock.

A :class:`DeviceClock` belongs to one stream of work, the current stream
of its device on the thread that uses it.  :meth:`~DeviceClock.anchor` is
called right after a synchronize of that stream, so the CUDA event it
records runs as it is recorded and its device time is the
``time.monotonic()`` reading taken with it.  :meth:`~DeviceClock.mark`
records an event on the stream while the work is queued;
:meth:`~DeviceClock.resolve` turns a mark into monotonic seconds, the
anchor's reading plus the device time between the two events.  Resolve a
mark only once it is known to be complete (after a synchronize, or a
copy to the host that waited for it): it never waits.

On the CPU the work runs as it is issued: a mark is the host's monotonic
reading, and a device interval is the host interval.  A clock is made
only where telemetry is on, so with telemetry off no CUDA event exists.
"""

from __future__ import annotations

import time
from typing import Union

import torch

__all__ = ["DeviceClock"]

Mark = Union[float, "torch.cuda.Event"]


class DeviceClock:
    """CUDA events on the current stream, read on the monotonic clock."""

    __slots__ = ("device", "cuda", "_anchor", "_anchor_t")

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._anchor = None
        self._anchor_t = 0.0

    def anchor(self) -> None:
        """Tie the device's time to the host's: call right after a
        synchronize of the current stream."""
        if self.cuda:
            self._anchor = self._event()
        self._anchor_t = time.monotonic()

    def _event(self) -> "torch.cuda.Event":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def mark(self) -> Mark:
        """The current point of the stream's work."""
        return self._event() if self.cuda else time.monotonic()

    def resolve(self, mark: Mark) -> float:
        """Monotonic seconds at which the work reached ``mark``."""
        if not self.cuda:
            return mark
        return self._anchor_t + 1e-3 * self._anchor.elapsed_time(mark)
