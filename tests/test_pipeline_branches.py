"""Branch tests for pipeline classification/fallback paths that the
vector suites never route through: the oracle-rerun safety net, the
single-block fast path's capacity and corruption exits, the threaded
multi-block scan, and plan_decode's resolver/numpy capacity caps
(reference behaviors: lz4ada.adb:766-772 offset-0, adb:867-874
backref-before-start, adb:316-328 BD codes)."""

import numpy as np
import pytest

import lz4tpu
from lz4tpu import pipeline
from lz4tpu.constants import (
    EndOfFrame,
    MAGIC_LEGACY,
    MAGIC_MODERN,
    Reservation,
    is_any_magic,
    reservation_for_bd_code,
)
from lz4tpu.errors import DataCorruption, NotSupported
from lz4tpu.frame import parse_frames

RES = Reservation.SZ_8_MIB


def _parse(frame: bytes):
    buf = np.frombuffer(frame, np.uint8)
    return buf, parse_frames(buf, RES)


def _swap_payload(frame: bytes, payload: bytes) -> bytes:
    """Replace the first block's compressed payload (size word fixed
    up, high bit clear = compressed)."""
    _, parsed = _parse(frame)
    blk = parsed.frames[0].blocks[0]
    return (frame[:blk.comp_off - 4]
            + len(payload).to_bytes(4, "little") + payload
            + frame[blk.comp_off + blk.comp_len:])


def test_oracle_rerun_flexible_reservation_no_progress():
    # Valid stream + flexible reservation: the push parser consumes
    # everything cleanly, so the no-progress diagnostic must fire
    # (the batch classifier flagged something streaming did not).
    frame = lz4tpu.compress(b"hello oracle " * 40)
    with pytest.raises(DataCorruption, match="no progress"):
        pipeline._oracle_rerun(frame, Reservation.USE_FIRST)


def test_oracle_rerun_concrete_clean_decode_raises():
    frame = lz4tpu.compress(b"hello oracle " * 40)
    with pytest.raises(DataCorruption, match="no progress"):
        pipeline._oracle_rerun(frame, RES)


def test_single_block_capacity_exceeded():
    frame = lz4tpu.compress(b"capacity " * 200)
    buf, parsed = _parse(frame)
    assert len(parsed.frames) == 1 and len(parsed.frames[0].blocks) == 1
    parsed.frames[0].blocks[0].comp_off = 1 << 31  # int32 coordinate edge
    with pytest.raises(pipeline.BatchCapacityExceeded):
        pipeline._build_seq_table_single(buf, parsed, RES, frame)


def _single_block_error(payload: bytes):
    """Route a hand-built raw block through the single-compressed-block
    fast path and return the reference-parity exception it raises."""
    frame = lz4tpu.compress(b"AAAABBBBCCCC", content_checksum=False)
    bad = _swap_payload(frame, payload)
    buf, parsed = _parse(bad)
    assert len(parsed.frames[0].blocks) == 1
    with pytest.raises(DataCorruption) as ei:
        pipeline.build_seq_table(buf, parsed, RES, bad, pooled_cols=True)
    return ei.value


def test_single_block_offset_zero_oracle_parity():
    # token 0x12: 1 literal then a match with LE16 offset 0x0000 —
    # scan status != OK -> oracle rerun raises the streaming engine's
    # byte-exact message (lz4ada.adb:766-772).
    exc = _single_block_error(bytes([0x12, ord("A"), 0x00, 0x00]))
    # differential: the streaming host engine's message is the contract
    with pytest.raises(DataCorruption) as ref:
        lz4tpu.decompress_host(
            _swap_payload(
                lz4tpu.compress(b"AAAABBBBCCCC", content_checksum=False),
                bytes([0x12, ord("A"), 0x00, 0x00])), RES)
    assert str(exc) == str(ref.value)


def test_single_block_backref_before_start_oracle_parity():
    # offset 2 with only 1 byte of output: min_reach < 0 -> oracle
    # rerun (lz4ada.adb:867-874).
    exc = _single_block_error(bytes([0x12, ord("A"), 0x02, 0x00]))
    with pytest.raises(DataCorruption) as ref:
        lz4tpu.decompress_host(
            _swap_payload(
                lz4tpu.compress(b"AAAABBBBCCCC", content_checksum=False),
                bytes([0x12, ord("A"), 0x02, 0x00])), RES)
    assert str(exc) == str(ref.value)


def test_single_block_output_capacity_exceeded(monkeypatch):
    # total decoded bytes past the int32 coordinate cap (the 2 GiB
    # class) — shrink the cap so an RLE expansion trips the output-side
    # check without a 2 GiB corpus.
    frame = lz4tpu.compress(b"A" * 1000, content_checksum=False)
    buf, parsed = _parse(frame)
    end = (parsed.frames[0].blocks[0].comp_off
           + parsed.frames[0].blocks[0].comp_len)
    monkeypatch.setattr(pipeline, "_BATCH_MAX_OUT", max(end + 1, 500))
    with pytest.raises(pipeline.BatchCapacityExceeded):
        pipeline._build_seq_table_single(buf, parsed, RES, frame)


def _patch_content_size(frame: bytes, delta: int) -> bytes:
    """Adjust the modern header's declared content size by ``delta``
    and fix the header checksum (HC = (xxh32(FLG..dictID)>>8)&0xFF,
    lz4ada.adb:351-361)."""
    from lz4tpu.xxh32 import xxh32

    declared = int.from_bytes(frame[6:14], "little") + delta
    body = frame[4:6] + declared.to_bytes(8, "little")
    hc = (xxh32(body) >> 8) & 0xFF
    return frame[:6] + declared.to_bytes(8, "little") + bytes([hc]) \
        + frame[15:]


@pytest.mark.parametrize("delta", [-1, 1])
def test_single_block_content_size_mismatch_parity(delta):
    frame = lz4tpu.compress(b"content size " * 50, content_size=True,
                            content_checksum=False)
    bad = _patch_content_size(frame, delta)
    buf, parsed = _parse(bad)
    with pytest.raises(DataCorruption) as batch:
        pipeline.build_seq_table(buf, parsed, RES, bad, pooled_cols=True)
    with pytest.raises(DataCorruption) as ref:
        lz4tpu.decompress_host(bad, RES)
    assert str(batch.value) == str(ref.value)


def test_multiblock_threaded_scan_matches_serial(monkeypatch):
    data = (b"The quick brown fox jumps over the lazy dog %08d. " * 4096
            % tuple(range(4096)))
    frame = lz4tpu.compress(data, block_max_code=4)  # 64 KiB blocks
    buf, parsed = _parse(frame)
    assert sum(b.is_compressed for b in parsed.blocks) > 1
    monkeypatch.setenv("LZ4TPU_PACK_THREADS", "1")
    serial = pipeline.build_seq_table(buf, parsed, RES, frame)
    monkeypatch.setenv("LZ4TPU_PACK_THREADS", "3")
    threaded = pipeline.build_seq_table(buf, parsed, RES, frame)
    assert threaded.n_out == serial.n_out == len(data)
    for f in ("out_start", "lit_len", "lit_src", "match_len", "match_off"):
        np.testing.assert_array_equal(getattr(threaded, f),
                                      getattr(serial, f))


def _dense_chain_table():
    data = (b"chain %06d seed text with mild repetition. " * 3000
            % tuple(range(3000)))
    frame = lz4tpu.compress(data, content_checksum=False)
    buf, parsed = _parse(frame)
    table = pipeline.build_seq_table(buf, parsed, RES, frame)
    chains = pipeline._chains_of(table)
    assert len(chains) == 1
    assert chains[0].seq_hi - chains[0].seq_lo > pipeline._SPARSE_MAX_SEQS
    return buf, parsed, table


def test_plan_decode_dense_chain_to_resolver():
    buf, parsed, table = _dense_chain_table()
    plan = pipeline.plan_decode(buf, table)
    assert len(plan.dense) == 1 and not plan.sparse


@pytest.mark.parametrize("n_seqs,seq_bytes,sparse", [
    (3, 200_000, True),       # a zeros run: few giant segments
    (40, 4096, True),         # exactly the per-sequence byte floor
    (40, 4095, False),        # below it: the resolver takes the chain
    (600, 1 << 20, False),    # too many sequences for a sparse program
])
def test_plan_decode_sparse_shape_rule(n_seqs, seq_bytes, sparse):
    """A chain is sparse when it has at most _SPARSE_MAX_SEQS sequences
    producing at least _SPARSE_MIN_SEQ_BYTES each on average."""
    ll = np.full(n_seqs, 1, np.int32)
    ml = np.full(n_seqs, seq_bytes - 1, np.int32)
    mo = np.ones(n_seqs, np.int32)
    ls = np.zeros(n_seqs, np.int32)
    n_out = n_seqs * seq_bytes
    table = pipeline.SeqTable(
        out_start=(np.arange(n_seqs) * seq_bytes).astype(np.int32),
        lit_len=ll, lit_src=ls, match_len=ml, match_off=mo, n_out=n_out,
        frame_out_start=np.array([0, n_out], np.int64),
        spans=[pipeline.BlockSpan(0, 0, n_seqs, 0, n_out, True)])
    plan = pipeline.plan_decode(np.zeros(16, np.uint8), table)
    assert (len(plan.sparse), len(plan.dense)) == ((1, 0) if sparse
                                                   else (0, 1))


def test_lazy_decode_session_reexport_and_bad_attr():
    from lz4tpu.serve import DecodeSession

    assert lz4tpu.DecodeSession is DecodeSession
    with pytest.raises(AttributeError, match="no attribute"):
        lz4tpu.definitely_not_an_attr


def test_reservation_bd_codes_and_magic_predicate():
    assert reservation_for_bd_code(4) is Reservation.SZ_64_KIB
    assert reservation_for_bd_code(7) is Reservation.SZ_4_MIB
    with pytest.raises(NotSupported):
        reservation_for_bd_code(3)
    assert is_any_magic(MAGIC_MODERN) and is_any_magic(MAGIC_LEGACY)
    assert is_any_magic(0x184D2A50) and is_any_magic(0x184D2A5F)
    assert not is_any_magic(0x184D2A60)
    assert EndOfFrame.MAYBE.value == 1
