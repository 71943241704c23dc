"""Seeded corpus: payloads and LZ4 frames generated in-repo.

Every input the tests, ``chip_smoke.py`` and ``bench.py`` decode comes
from here, made from a seed — no file is read.  Frames are written by
this package's encoder (``api.compress``) or assembled by hand where
the encoder does not emit a shape (stored blocks, skippable frames,
concatenations).  The oracle for every decode is the native host engine
(``api.decompress_host``) and the original payload.

Payloads:

* ``log_text`` — log-like text: Zipf-weighted tokens (keywords, words,
  numbers, hex ids, paths) in lines, so matches reach across the
  whole 64 KiB window, as in the compressible data LZ4's users ship.
* ``zeros`` and ``incompressible`` — the two ends of the ratio range.

``cases()`` names small frames covering the format's shapes, for the
differential tests.
"""

from __future__ import annotations

import functools
import struct

import numpy as np

from .api import _frame_descriptor, compress
from .constants import MAGIC_MODERN, SKIPPABLE_LO
from .xxh32 import xxh32

_ALPHA = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)
_DIGITS = np.frombuffer(b"0123456789", np.uint8)
_KEYWORDS = (b"INFO", b"WARN", b"ERROR", b"DEBUG", b"GET", b"POST",
             b"user=", b"status=200", b"status=404", b"latency_ms=",
             b"request_id=", b"/api/v1/orders", b"/api/v1/users",
             b"kafka.consumer", b"partition=", b"offset=")


def _vocab(rng: np.random.Generator, n: int = 4096) -> list[bytes]:
    """Token vocabulary: keywords, words, numbers, hex ids, paths."""
    toks = list(_KEYWORDS)
    while len(toks) < n:
        kind = rng.integers(0, 5)
        if kind <= 1:
            tok = _ALPHA[rng.integers(0, 26, rng.integers(2, 11))]
        elif kind == 2:
            tok = _DIGITS[rng.integers(0, 10, rng.integers(1, 7))]
        elif kind == 3:
            tok = _HEX[rng.integers(0, 16, 8)]
        else:
            parts = [_ALPHA[rng.integers(0, 26, rng.integers(3, 8))]
                     for _ in range(rng.integers(2, 4))]
            tok = np.concatenate([np.concatenate([[47], p]) for p in parts])
        toks.append(bytes(tok.astype(np.uint8)))
    return toks


def log_text(rng: np.random.Generator, n: int) -> bytes:
    """``n`` bytes of log-like text (about 3-4x compressible by LZ4)."""
    vocab = _vocab(rng)
    blob = np.frombuffer(b"".join(t + b" " for t in vocab), np.uint8)
    lens = np.array([len(t) + 1 for t in vocab], np.int64)
    starts = np.cumsum(lens) - lens
    weights = 1.0 / np.arange(1, len(vocab) + 1) ** 1.05
    weights /= weights.sum()
    parts = []
    have = 0
    while have < n:
        m = max(16, (n - have) // 6 + 16)
        idx = rng.choice(len(vocab), size=m, p=weights)
        tl = lens[idx]
        off = np.cumsum(tl) - tl
        gather = np.arange(int(tl.sum())) - np.repeat(off - starts[idx], tl)
        chunk = blob[gather]
        # about one line break per 12 tokens, replacing a separator
        ends = (off + tl - 1)[rng.random(m) < 1 / 12]
        chunk[ends] = ord("\n")
        parts.append(chunk)
        have += chunk.size
    return np.concatenate(parts)[:n].tobytes()


def zeros(n: int) -> bytes:
    return bytes(n)


def incompressible(rng: np.random.Generator, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def stored_frame(payload: bytes, block_size: int = 1 << 16,
                 block_checksum: bool = False) -> bytes:
    """A modern frame whose blocks are all stored uncompressed (the
    high bit of the block size word), with a content checksum."""
    code = {1 << 16: 4, 1 << 18: 5, 1 << 20: 6, 1 << 22: 7}[block_size]
    out = bytearray(struct.pack("<I", MAGIC_MODERN))
    out += _frame_descriptor(None, code, True, block_checksum, True)
    for pos in range(0, len(payload), block_size):
        blk = payload[pos:pos + block_size]
        out += struct.pack("<I", len(blk) | 0x80000000) + blk
        if block_checksum:
            out += struct.pack("<I", xxh32(blk))
    out += bytes(4) + struct.pack("<I", xxh32(payload))
    return bytes(out)


def skippable_frame(data: bytes, nibble: int = 0) -> bytes:
    return struct.pack("<II", SKIPPABLE_LO + nibble, len(data)) + data


def kafka_frame(rng: np.random.Generator, size: int) -> tuple[bytes, bytes]:
    """One message-broker batch: ``size`` bytes of log text in a frame
    of 64 KiB independent blocks without checksums — the frame Apache
    Kafka's ``compression.type=lz4`` producer writes."""
    payload = log_text(rng, size)
    return compress(payload, block_max_code=4, block_independence=True,
                    content_checksum=False), payload


def _periodic(rng, period: int, n: int) -> bytes:
    unit = incompressible(rng, period)
    return (unit * (n // period + 1))[:n]


def _far_matches(rng, n: int) -> bytes:
    """Repeats of a ~64 KiB random unit: matches at offsets near the
    window limit, chained across linked blocks."""
    unit = incompressible(rng, 65000)
    return (unit * (n // len(unit) + 1))[:n]


def _mixed(rng, n: int) -> bytes:
    third = n // 3
    return (log_text(rng, third) + zeros(third)
            + incompressible(rng, n - 2 * third))


def _case_frames(rng: np.random.Generator) -> dict:
    """name -> (frame, payload); small sizes for CPU tests."""
    text = log_text(rng, 300_000)
    c = {}
    c["text_cli_default"] = compress(text), text
    c["text_linked_64k_blockcsum"] = compress(
        text, block_max_code=4, block_checksum=True), text
    c["text_independent_64k"] = compress(
        text, block_max_code=4, block_independence=True,
        content_checksum=False), text
    c["text_all_checksums_size"] = compress(
        text, block_max_code=5, block_independence=True, block_checksum=True,
        content_size=True), text
    c["text_optimal_level"] = compress(text[:100_000], level=10), text[:100_000]
    z = zeros(400_000)
    c["zeros_independent_64k"] = compress(
        z, block_max_code=4, block_independence=True), z
    c["zeros_linked_256k"] = compress(z, block_max_code=5), z
    r = incompressible(rng, 200_000)
    c["incompressible"] = compress(r, block_max_code=4), r
    c["stored_blocks_text"] = stored_frame(text[:150_000]), text[:150_000]
    c["stored_blocks_blockcsum"] = stored_frame(
        r[:100_000], block_checksum=True), r[:100_000]
    p = _periodic(rng, 2, 100_000) + _periodic(rng, 37, 100_000)
    c["rle_short_periods"] = compress(p, block_max_code=4), p
    p = _periodic(rng, 1000, 200_000)
    c["overlapping_long_matches"] = compress(p, block_max_code=5), p
    f = _far_matches(rng, 260_000)
    c["far_offsets_linked"] = compress(f, block_max_code=4), f
    m = _mixed(rng, 300_000)
    c["mixed_engines"] = compress(
        m, block_max_code=4, block_independence=True, block_checksum=True), m
    lg = text[:120_000]
    c["legacy"] = compress(lg, frame_format="legacy"), lg
    c["legacy_then_modern"] = (
        compress(lg, frame_format="legacy") + compress(text[:50_000]),
        lg + text[:50_000])
    c["skippable_around_frame"] = (
        skippable_frame(b"meta" * 10, 3) + compress(text[:80_000])
        + skippable_frame(b"", 15), text[:80_000])
    parts = [text[:70_000], z[:90_000], r[:30_000]]
    c["concatenated_frames"] = (
        compress(parts[0], block_checksum=True)
        + compress(parts[1], block_max_code=4, content_size=True)
        + compress(parts[2], content_checksum=False), b"".join(parts))
    c["empty_frame"] = compress(b""), b""
    c["empty_then_text"] = compress(b"") + compress(text[:5000]), text[:5000]
    c["tiny"] = compress(b"hello, lz4"), b"hello, lz4"
    kf, kp = kafka_frame(rng, 200_000)
    c["kafka_batch"] = kf, kp
    return c


def case_names() -> list[str]:
    """Stable case order (for test parametrisation)."""
    return list(cases())


@functools.lru_cache(maxsize=2)
def cases(seed: int = 0) -> dict:
    """name -> (frame bytes, payload bytes) for the differential tests;
    built once per seed and process."""
    return _case_frames(np.random.default_rng(seed))
