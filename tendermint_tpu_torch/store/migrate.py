"""Store key-layout migration (ref: scripts/keymigrate/migrate.go,
cmd `tendermint key-migrate`).

The reference migrated legacy string-formatted DB keys (`H:%d`,
`P:%d:%d`, ...) to typed orderedcode keys. Our current layout is the
typed one — binary prefixes with fixed-width big-endian heights
(store/blockstore.py:22-31, state/store.py:24-31), which sort
bytewise in height order. This module upgrades databases written with
the legacy ASCII-decimal layout (heights as `b"123"`, part indices as
`b":7"`) in place, idempotently: already-migrated keys are left
untouched, so re-running after a crash mid-migration is safe
(mirrors keymigrate's "safe to run repeatedly" contract).
"""

from __future__ import annotations

import re

from .kv import KVStore

# legacy patterns: ASCII-decimal heights (and part index for P:)
_LEGACY = [
    (re.compile(rb"^H:(\d+)$"), b"H:", None),
    (re.compile(rb"^C:(\d+)$"), b"C:", None),
    (re.compile(rb"^SC:(\d+)$"), b"SC:", None),
    (re.compile(rb"^EC:(\d+)$"), b"EC:", None),
    (re.compile(rb"^P:(\d+):(\d+)$"), b"P:", 4),
    (re.compile(rb"^validatorsKey:(\d+)$"), b"validatorsKey:", None),
    (re.compile(rb"^consensusParamsKey:(\d+)$"), b"consensusParamsKey:", None),
    (re.compile(rb"^abciResponsesKey:(\d+)$"), b"abciResponsesKey:", None),
]


def _migrate_key(key: bytes) -> bytes | None:
    """New key for a legacy one, or None if `key` is already current."""
    for pat, prefix, idx_width in _LEGACY:
        m = pat.match(key)
        if m is None:
            continue
        new = prefix + int(m.group(1)).to_bytes(8, "big")
        if idx_width is not None:
            new += b":" + int(m.group(2)).to_bytes(idx_width, "big")
        return new
    return None


def migrate_db(db: KVStore) -> int:
    """Rewrite every legacy-layout key in `db`. Returns the number of
    keys migrated. Crash-safe: the new key is written before the legacy
    one is deleted, and current-layout keys always win a collision."""
    moves: list[tuple[bytes, bytes]] = []
    for key, _ in db.iterator():
        new = _migrate_key(key)
        if new is not None:
            moves.append((key, new))
    for old, new in moves:
        value = db.get(old)
        if value is not None and not db.has(new):
            db.set(new, value)
        db.delete(old)
    return len(moves)
