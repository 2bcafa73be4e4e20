"""Per-IP inbound connection tracking (ref: internal/p2p/conn_tracker.go).

Bounds concurrent inbound connections per source IP and enforces a
cooldown between repeated dials from the same IP, protecting the accept
path from a single misbehaving address.
"""

from __future__ import annotations

import threading
import time


class ConnTracker:
    """ref: connTracker (conn_tracker.go:16)."""

    def __init__(self, max_per_ip: int = 8, window: float = 1.0):
        self.max_per_ip = max_per_ip
        self.window = window  # min seconds between new conns per IP
        self._lock = threading.Lock()
        self._count: dict[str, int] = {}
        self._last: dict[str, float] = {}

    def add_conn(self, ip: str) -> None:
        """Raises on limit breach (the accept path then drops the conn)."""
        with self._lock:
            n = self._count.get(ip, 0)
            if n >= self.max_per_ip:
                raise ConnectionRefusedError(
                    f"too many concurrent connections from {ip} ({n})"
                )
            now = time.monotonic()
            last = self._last.get(ip, 0.0)
            if n > 0 and now - last < self.window:
                raise ConnectionRefusedError(
                    f"connection from {ip} rate-limited (retry in {self.window - (now - last):.2f}s)"
                )
            self._count[ip] = n + 1
            self._last[ip] = now

    def remove_conn(self, ip: str) -> None:
        with self._lock:
            n = self._count.get(ip, 0)
            if n <= 1:
                self._count.pop(ip, None)
                # drop the timestamp too: unbounded growth across many
                # distinct source IPs is a memory leak on a public node
                self._last.pop(ip, None)
            else:
                self._count[ip] = n - 1

    def len(self, ip: str) -> int:
        with self._lock:
            return self._count.get(ip, 0)
