"""Consensus write-ahead log (ref: internal/consensus/wal.go:61-436).

Every message is logged BEFORE it is processed; the node's own messages
(internal queue) are fsync'd (WriteSync) so a crashed validator can
never act twice on the same input. Record framing: u32 crc32(payload) ‖
u32 length ‖ payload, payload = JSON of a TimedWALMessage. A torn or
corrupt tail stops replay (the reference's repairWalFile behavior).

EndHeightMessage marks a height as fully committed; replay starts from
the record after the last EndHeight(h >= target-1)
(ref: SearchForEndHeight wal.go:261).
"""

from __future__ import annotations

import base64
import json
import os
import struct
import threading
import zlib
from dataclasses import dataclass

from ..proto import messages as pb
from ..types.proposal import Proposal
from ..types.vote import Vote

MAX_WAL_MSG_SIZE = 1024 * 1024  # wal.go:32


@dataclass
class EndHeightMessage:
    """ref: EndHeightMessage (wal.go:44)."""

    height: int


@dataclass
class TimeoutInfo:
    """ref: timeoutInfo (state.go:78)."""

    duration_s: float
    height: int
    round: int
    step: int


@dataclass
class MsgInfo:
    """A consensus message + the peer that sent it ('' = internal)
    (ref: msgInfo state.go:70)."""

    msg: object
    peer_id: str = ""


@dataclass
class EventRoundStep:
    """Step transition marker, logged for replay catch-up
    (ref: EventDataRoundState written at state.go:952)."""

    height: int
    round: int
    step: int


def _encode_msg(m) -> dict:
    from .messages import (
        BlockPartMessage,
        ProposalMessage,
        VoteMessage,
    )

    if isinstance(m, EndHeightMessage):
        return {"type": "end_height", "height": m.height}
    if isinstance(m, EventRoundStep):
        return {"type": "round_step", "height": m.height, "round": m.round, "step": m.step}
    if isinstance(m, TimeoutInfo):
        return {
            "type": "timeout",
            "duration_s": m.duration_s,
            "height": m.height,
            "round": m.round,
            "step": m.step,
        }
    if isinstance(m, MsgInfo):
        inner = m.msg
        if isinstance(inner, ProposalMessage):
            body = {"kind": "proposal", "data": base64.b64encode(inner.proposal.to_proto().encode()).decode()}
        elif isinstance(inner, BlockPartMessage):
            body = {
                "kind": "block_part",
                "height": inner.height,
                "round": inner.round,
                "data": base64.b64encode(inner.part.to_proto().encode()).decode(),
            }
        elif isinstance(inner, VoteMessage):
            body = {"kind": "vote", "data": base64.b64encode(inner.vote.to_proto().encode()).decode()}
        else:
            raise TypeError(f"unsupported WAL msgInfo payload: {type(inner)}")
        return {"type": "msg_info", "peer_id": m.peer_id, "msg": body}
    raise TypeError(f"unsupported WAL message: {type(m)}")


def _decode_msg(doc: dict):
    from ..types.part_set import Part
    from .messages import BlockPartMessage, ProposalMessage, VoteMessage

    t = doc["type"]
    if t == "end_height":
        return EndHeightMessage(doc["height"])
    if t == "round_step":
        return EventRoundStep(doc["height"], doc["round"], doc["step"])
    if t == "timeout":
        return TimeoutInfo(doc["duration_s"], doc["height"], doc["round"], doc["step"])
    if t == "msg_info":
        body = doc["msg"]
        kind = body["kind"]
        if kind == "proposal":
            inner = ProposalMessage(Proposal.from_proto(pb.Proposal.decode(base64.b64decode(body["data"]))))
        elif kind == "block_part":
            inner = BlockPartMessage(
                body["height"], body["round"], Part.from_proto(pb.Part.decode(base64.b64decode(body["data"])))
            )
        elif kind == "vote":
            inner = VoteMessage(Vote.from_proto(pb.Vote.decode(base64.b64decode(body["data"]))))
        else:
            raise ValueError(f"unknown msg kind {kind}")
        return MsgInfo(inner, doc.get("peer_id", ""))
    raise ValueError(f"unknown WAL message type {t}")


def frame_record(payload: bytes) -> bytes:
    """CRC-frame one payload (u32 crc32 | u32 len | payload), enforcing
    the size limit. Paired with iter_wal_records as the single source of
    truth for the framing — used by WAL._append and the json2wal tool."""
    if len(payload) > MAX_WAL_MSG_SIZE:
        raise ValueError(f"msg is too big: {len(payload)} bytes, max: {MAX_WAL_MSG_SIZE} bytes")
    return struct.pack("<II", zlib.crc32(payload), len(payload)) + payload


def iter_wal_records(data: bytes):
    """Yield (offset, payload) for each clean CRC-framed record in
    `data`, stopping at the first torn/corrupt frame. The single source
    of truth for the WAL framing — used by replay (_read_all) and the
    wal2json operator tool."""
    pos = 0
    while pos + 8 <= len(data):
        crc, length = struct.unpack_from("<II", data, pos)
        end = pos + 8 + length
        if end > len(data) or length > MAX_WAL_MSG_SIZE:
            return
        payload = data[pos + 8 : end]
        if zlib.crc32(payload) != crc:
            return
        yield pos, payload
        pos = end


class WAL:
    """ref: BaseWAL (wal.go:61) over an autofile.Group-style rotating
    file set: the head file rotates at `max_file_size`, rotated files
    keep numbered suffixes (`<path>.000`, `.001`, …, oldest first), and
    at most `max_files` rotated files are retained (ref:
    internal/libs/autofile/group.go RotateFile/checkTotalSizeLimit).
    Replay reads the retained files oldest → head."""

    def __init__(self, path: str, max_file_size: int = 8 << 20, max_files: int = 8):
        self._path = path
        self.max_file_size = max_file_size
        self.max_files = max_files
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._lock = threading.Lock()
        self._migrate_legacy_suffixes()
        self._f = open(path, "ab")

    def _migrate_legacy_suffixes(self) -> None:
        """Rename 3-digit rotated segments from the earlier scheme into
        the 9-digit sequence so replay and retention keep seeing them."""
        import glob as _glob

        legacy = sorted(_glob.glob(self._path + ".[0-9][0-9][0-9]"))
        for p in legacy:
            idx = int(p.rsplit(".", 1)[1])
            target = f"{self._path}.{idx:09d}"
            if not os.path.exists(target):
                os.replace(p, target)

    def write(self, msg) -> None:
        """Buffered append (ref: Write wal.go:118 — fsync deferred)."""
        self._append(msg, fsync=False)

    def write_sync(self, msg) -> None:
        """Append + fsync — used for the node's OWN messages
        (ref: WriteSync wal.go:132; state.go:964)."""
        self._append(msg, fsync=True)

    def _rotated_paths(self) -> list[str]:
        """Existing rotated files, oldest first (fixed-width monotone
        suffixes sort lexicographically = chronologically)."""
        import glob as _glob

        return sorted(_glob.glob(self._path + "." + "[0-9]" * 9))

    def _fsync_dir(self) -> None:
        """Persist directory entries after renames/creates — without
        this, a post-rotation write_sync fsyncs file data whose directory
        entry may still be volatile (the record would vanish on power
        loss, breaking the double-sign guard the WAL exists for)."""
        dfd = os.open(os.path.dirname(os.path.abspath(self._path)) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def _maybe_rotate_locked(self) -> None:
        if self._f.tell() < self.max_file_size:
            return
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        # Monotone 9-digit suffixes: the new segment takes max(existing)+1
        # — one rename, crash-atomic, and a fresh index can never land on
        # an occupied suffix (a shift scheme interrupted mid-shift leaves
        # sparse indices that a dense counter would then overwrite).
        # Retention deletes the oldest beyond max_files. 9 digits at the
        # default 8 MiB per segment is ~8 EB of WAL before overflow.
        rotated = self._rotated_paths()
        next_idx = int(rotated[-1].rsplit(".", 1)[1]) + 1 if rotated else 0
        os.replace(self._path, f"{self._path}.{next_idx:09d}")
        rotated = self._rotated_paths()
        while len(rotated) > self.max_files:
            os.remove(rotated.pop(0))
        self._f = open(self._path, "ab")
        self._fsync_dir()

    def _append(self, msg, fsync: bool) -> None:
        rec = frame_record(json.dumps(_encode_msg(msg), separators=(",", ":")).encode())
        with self._lock:
            self._maybe_rotate_locked()
            self._f.write(rec)
            self._f.flush()
            if fsync:
                os.fsync(self._f.fileno())

    def flush_and_sync(self) -> None:
        with self._lock:
            if self._f.closed:
                return  # already closed by a fatal-halt teardown
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                os.fsync(self._f.fileno())
                self._f.close()

    # ------------------------------------------------------------ replay

    @staticmethod
    def _scan_file(data: bytes):
        """(decoded msgs, bytes consumed, clean) for one file's bytes."""
        out = []
        consumed = 0
        for pos, payload in iter_wal_records(data):
            try:
                out.append(_decode_msg(json.loads(payload)))
            except Exception:
                return out, consumed, False
            consumed = pos + 8 + len(payload)
        # a torn/corrupt frame stops the iterator short of the end
        return out, consumed, consumed == len(data)

    def _paths_snapshot(self) -> list[str]:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
            return self._rotated_paths() + (
                [self._path] if os.path.exists(self._path) else []
            )

    def read_all_with_status(self) -> tuple[list, bool]:
        """Decode every intact record across the rotated set + head,
        oldest first; stop at the FIRST corruption anywhere and do not
        read later files — replaying past a hole would hand the state
        machine a log with a silent gap (the reference's repairWalFile
        truncates at the corruption point for the same reason,
        state.go:2735). Returns (msgs, clean)."""
        out = []
        for path in self._paths_snapshot():
            with open(path, "rb") as f:
                data = f.read()
            msgs, _, clean = self._scan_file(data)
            out.extend(msgs)
            if not clean:
                return out, False  # truncate replay at the corruption
        return out, True

    def _read_all(self) -> list:
        return self.read_all_with_status()[0]

    def repair(self) -> bool:
        """Repair-and-continue after corruption (ref: state.go:441-466 +
        repairWalFile state.go:2735): back up the corrupt file to
        `<file>.CORRUPTED`, rewrite it keeping only the records before
        the corruption point, and back up + drop any LATER files (their
        records are beyond the hole; keeping them would splice a silent
        gap into the log). Appends then continue on the clean tail.
        Returns True if anything was repaired; False if the set was
        already clean."""
        with self._lock:
            if not self._f.closed:
                self._f.flush()
            paths = self._rotated_paths() + (
                [self._path] if os.path.exists(self._path) else []
            )
            corrupt_idx = None
            intact = b""
            for fi, path in enumerate(paths):
                with open(path, "rb") as f:
                    data = f.read()
                _, consumed, clean = self._scan_file(data)
                if not clean:
                    corrupt_idx = fi
                    intact = data[:consumed]
                    break
            if corrupt_idx is None:
                return False
            if not self._f.closed:
                self._f.close()
            bad = paths[corrupt_idx]
            os.replace(bad, bad + ".CORRUPTED")
            with open(bad, "wb") as f:
                f.write(intact)
                f.flush()
                os.fsync(f.fileno())
            for later in paths[corrupt_idx + 1 :]:
                os.replace(later, later + ".CORRUPTED")
            # reopen (or recreate) the head for appends
            self._f = open(self._path, "ab")
            self._fsync_dir()
            return True

    def search_for_end_height(self, height: int) -> list | None:
        """Messages after EndHeight(height), or None if not found
        (ref: SearchForEndHeight wal.go:261; height 0 always 'found' so
        fresh chains replay from the start)."""
        return self.search_for_end_height_with_status(height)[0]

    def search_for_end_height_with_status(self, height: int):
        """(messages-after-EndHeight | None, clean) — the clean flag
        drives the caller's repair-and-retry loop (ref: state.go:425)."""
        msgs, clean = self.read_all_with_status()
        if height == 0:
            return msgs, clean
        idx = None
        for i, m in enumerate(msgs):
            if isinstance(m, EndHeightMessage) and m.height == height:
                idx = i
        if idx is None:
            return None, clean
        return msgs[idx + 1 :], clean
