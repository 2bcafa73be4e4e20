"""Nanosecond-precision UTC time (ref: libs/time/time.go), trimmed to what
commit and light-header verification need.

Consensus timestamps are protobuf Timestamps (seconds since the unix epoch
+ nanos), and the zero value is the Go zero time 0001-01-01T00:00:00Z
(seconds = -62135596800). `Time` stores (seconds, nanos) exactly; its
RFC 3339 rendering is the reference's, so error messages that print a
time read alike in both packages.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone

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

    @classmethod
    def now(cls) -> "Time":
        return cls.from_unix_ns(_time.time_ns())

    @classmethod
    def from_unix_ns(cls, ns: int) -> "Time":
        return cls(ns // _NS, ns % _NS)

    def unix_ns(self) -> int:
        return self.seconds * _NS + self.nanos

    def is_zero(self) -> bool:
        return self.seconds == GO_ZERO_SECONDS and self.nanos == 0

    def add(self, ns: int) -> "Time":
        return Time.from_unix_ns(self.unix_ns() + ns)

    def sub(self, other: "Time") -> int:
        """Difference in nanoseconds."""
        return self.unix_ns() - other.unix_ns()

    def rfc3339(self) -> str:
        """RFC3339Nano rendering (trailing fractional zeros trimmed)."""
        dt = datetime(1970, 1, 1, tzinfo=timezone.utc) + timedelta(seconds=self.seconds)
        # the year zero-padded: %Y is not on glibc, and Go's zero time is year 1
        base = f"{dt.year:04d}-" + dt.strftime("%m-%dT%H:%M:%S")
        if self.nanos:
            frac = f"{self.nanos:09d}".rstrip("0")
            return f"{base}.{frac}Z"
        return base + "Z"

    def __str__(self):
        return self.rfc3339()


ZERO = Time()
