"""Single-block fast-path (scan_block_full) parity.

The pooled_cols=True fast path (pipeline._build_seq_table_single) must
be identical to the generic scan+concat path in every observable: table
columns, output size, frame bounds and — for malformed inputs — the
raised exception (message included).  Inputs come from the seeded
corpus.  Reference semantics under test: the block token grammar of
lib/lz4ada.adb:724-804 and the back-reference range check of
lz4ada.adb:867-874.
"""

import numpy as np
import pytest

from lz4tpu import compress, corpus, native
from lz4tpu import pipeline as P
from lz4tpu.constants import FOR_ALL, Reservation

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native engine unavailable"
)


def _tables(data):
    buf = np.frombuffer(data, np.uint8)
    parsed = P.parse_frames(buf, FOR_ALL)
    t_old = P.build_seq_table(buf, parsed, FOR_ALL, data)
    t_new = P.build_seq_table(
        buf, parsed, FOR_ALL, data, pooled_cols=True
    )
    return buf, t_old, t_new


@pytest.mark.parametrize("case", corpus.case_names())
def test_fast_path_table_and_prep_parity(case):
    data = corpus.cases()[case][0]
    if not data:
        pytest.skip("empty input has no table")
    _buf, t_old, t_new = _tables(data)
    for f in ("out_start", "lit_len", "lit_src", "match_len", "match_off"):
        assert np.array_equal(getattr(t_old, f), getattr(t_new, f)), f
    assert t_old.n_out == t_new.n_out
    assert np.array_equal(t_old.frame_out_start, t_new.frame_out_start)
    assert [vars(s) for s in t_old.spans] == [vars(s) for s in t_new.spans]


def _single_block(payload=b"fast path payload, fast path payload " * 40):
    return bytearray(compress(payload, content_checksum=False))


def _corrupt_offset_zero(f):
    # first sequence: token at byte 11; make its match offset zero
    blk = _single_block(b"abcdefgh" * 64)
    tok = blk[11]
    lit = tok >> 4
    blk[12 + lit:14 + lit] = b"\x00\x00"
    return blk


def _corrupt_truncated(f):
    blk = _single_block()
    size = int.from_bytes(blk[7:11], "little")
    blk[7:11] = (size - 5).to_bytes(4, "little")
    del blk[11 + size - 5:11 + size]
    return blk


def _corrupt_backref(f):
    blk = _single_block(b"abcdefgh" * 64)
    tok = blk[11]
    lit = tok >> 4
    blk[12 + lit:14 + lit] = (60000).to_bytes(2, "little")
    return blk


@pytest.mark.parametrize("corrupt", [_corrupt_offset_zero,
                                     _corrupt_truncated, _corrupt_backref])
def test_fast_path_error_parity(corrupt):
    """Malformed single-block frames must raise the same error (message
    included) through the pooled fast path as through the generic
    path."""
    data = bytes(corrupt(None))
    buf = np.frombuffer(data, np.uint8)
    parsed = P.parse_frames(buf, Reservation.USE_FIRST)
    errors = []
    for pooled in (False, True):
        with pytest.raises(Exception) as ei:
            P.build_seq_table(buf, parsed, Reservation.USE_FIRST, data,
                              pooled_cols=pooled)
        errors.append((type(ei.value), str(ei.value)))
    assert errors[0] == errors[1]


def test_fast_path_decode_bit_exact():
    """End-to-end device decode through the fast path: one 1.1 MB text
    block (the shape of the lz4 CLI's single-block frames)."""
    payload = corpus.log_text(np.random.default_rng(11), 1_137_664)
    data = compress(payload, block_max_code=7)
    buf = np.frombuffer(data, np.uint8)
    assert len(P.parse_frames(buf, Reservation.USE_FIRST).frames[0].blocks) == 1
    assert P.decompress_device(data) == payload
