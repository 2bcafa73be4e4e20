"""The port's protobuf decoders on arbitrary and truncated bytes.

A port copy of tests/test_fuzz.py::test_proto_message_decoders_never_crash
on the same eight message classes: any bytes either decode or raise
ValueError, IndexError or OverflowError. A fixed64 or fixed32 field cut
short raises ValueError("truncated fixed64" / "truncated fixed32") in the
port, as a cut varint raises "truncated varint"; the reference's decoders
raise struct.error there, which the last test pins so that a change to
either side shows. Well-formed messages decode as they do in the
reference. The hypothesis runs keep no example database."""

from __future__ import annotations

import struct

import numpy as np
import pytest

pytest.importorskip("hypothesis")

from hypothesis import example, given, settings, strategies as st  # noqa: E402

from tendermint_tpu.proto import messages as ref_pb  # noqa: E402
from tendermint_tpu.proto import wire as ref_wire  # noqa: E402
from tendermint_tpu_torch.proto import messages as pb  # noqa: E402
from tendermint_tpu_torch.proto import wire  # noqa: E402
from tendermint_tpu_torch.proto.message import Field, Message  # noqa: E402

CLASSES = ("Vote", "Commit", "Header", "ConsensusMessage", "PexMessage", "NodeInfoProto",
           "AuthSigMessage", "BitArrayProto")
ACCEPTED = (ValueError, IndexError, OverflowError)

# ConsensusMessage's field 1000 (origin_ns) is a fixed64: tag 1000 then
# fewer than eight bytes; b"\xc0>" is the tag alone, the input hypothesis
# drew against the reference
FIXED64_CUT = [b"\xc0>", b"\xc1>", b"\xc1>\x01", b"\xc1>\x01\x02\x03\x04\x05\x06\x07"]


class _Fixed(Message):
    fields = [Field(1, "fixed32", "a"), Field(2, "sfixed64", "b"), Field(3, "sfixed32", "c")]


@given(st.binary(min_size=0, max_size=512))
@settings(max_examples=400, deadline=None, database=None)
@example(b"\xc0>")
@example(b"\xc1>\x01\x02")
@example(b"\x0d\x01\x02\x03")
@example(b"\x11\x01")
def test_port_message_decoders_never_crash(data):
    for name in CLASSES:
        try:
            getattr(pb, name).decode(data)
        except ACCEPTED:
            pass
    try:
        _Fixed.decode(data)
    except ACCEPTED:
        pass


@pytest.mark.parametrize("data", FIXED64_CUT)
def test_truncated_fixed64_field_raises_value_error(data):
    with pytest.raises(ValueError, match="truncated fixed64"):
        pb.ConsensusMessage.decode(data)


@pytest.mark.parametrize("n", range(8))
def test_truncated_fixed_decoders(n):
    buf = bytes(range(1, n + 1))
    with pytest.raises(ValueError, match="truncated fixed64"):
        wire.decode_fixed64(buf, 0)
    if n < 4:
        with pytest.raises(ValueError, match="truncated fixed32"):
            wire.decode_fixed32(buf, 0)
        with pytest.raises(ValueError, match="truncated fixed32"):
            _Fixed.decode(b"\x0d" + buf)
    else:
        assert wire.decode_fixed32(buf, 0) == ref_wire.decode_fixed32(buf, 0)
    with pytest.raises(ValueError, match="truncated fixed64"):
        _Fixed.decode(b"\x11" + buf)


def test_well_formed_fixed_fields_decode_as_in_the_reference():
    rng = np.random.default_rng(23)
    for _ in range(200):
        v64 = int(rng.integers(-(2**63), 2**63 - 1, dtype=np.int64))
        v32 = int(rng.integers(-(2**31), 2**31 - 1, dtype=np.int32))
        off = int(rng.integers(0, 5))
        pad = bytes(rng.integers(0, 256, off, dtype=np.uint8))
        b64, b32 = pad + wire.encode_fixed64(v64), pad + wire.encode_fixed32(v32)
        assert b64 == pad + ref_wire.encode_fixed64(v64) and b32 == pad + ref_wire.encode_fixed32(v32)
        assert wire.decode_fixed64(b64, off) == ref_wire.decode_fixed64(b64, off) == (v64, off + 8)
        assert wire.decode_fixed32(b32, off) == ref_wire.decode_fixed32(b32, off) == (v32, off + 4)
        ns = int(rng.integers(1, 2**63 - 1, dtype=np.int64))
        msg = pb.ConsensusMessage(origin_ns=ns)
        raw = msg.encode()
        assert raw == ref_pb.ConsensusMessage(origin_ns=ns).encode()
        assert pb.ConsensusMessage.decode(raw).origin_ns == ref_pb.ConsensusMessage.decode(raw).origin_ns == ns
        vote = dict(type=1, height=int(rng.integers(1, 2**40)), round=int(rng.integers(0, 9)),
                    signature=bytes(rng.integers(0, 256, 64, dtype=np.uint8)))
        raw = pb.Vote(**vote).encode()
        assert raw == ref_pb.Vote(**vote).encode()
        assert pb.Vote.decode(raw).encode() == ref_pb.Vote.decode(raw).encode() == raw


@pytest.mark.parametrize("data", FIXED64_CUT)
def test_reference_keeps_struct_error_on_a_truncated_fixed64(data):
    """The reference's defect, pinned: its decoder raises struct.error on the
    same input (tests/test_fuzz.py accepts only ValueError, IndexError and
    OverflowError, so it fails whenever hypothesis draws such bytes)."""
    with pytest.raises(struct.error):
        ref_pb.ConsensusMessage.decode(data)
    with pytest.raises(ValueError):
        pb.ConsensusMessage.decode(data)
