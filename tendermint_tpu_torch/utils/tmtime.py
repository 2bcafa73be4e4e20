"""Nanosecond-precision UTC time (ref: libs/time/time.go), trimmed to what
commit verification needs.

Consensus timestamps are protobuf Timestamps (seconds since the unix epoch
+ nanos), and the zero value is the Go zero time 0001-01-01T00:00:00Z
(seconds = -62135596800). `Time` stores (seconds, nanos) exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

GO_ZERO_SECONDS = -62135596800  # 0001-01-01T00:00:00Z relative to unix epoch
_NS = 1_000_000_000


@dataclass(frozen=True, order=True)
class Time:
    seconds: int = GO_ZERO_SECONDS
    nanos: int = 0

    def __post_init__(self):
        if not 0 <= self.nanos < _NS:
            total = self.seconds * _NS + self.nanos
            object.__setattr__(self, "seconds", total // _NS)
            object.__setattr__(self, "nanos", total % _NS)
