"""Native ctypes-glue branch coverage (round-4 verdict next-#7): the
fallback, pool-regrow, and error-status paths of lz4tpu/native.

These are the branches users hit when inputs are malformed, buffers
are caller-provided, or the engine cannot load — each asserted for
BEHAVIOR (status code, exception, fallback value), not just executed.
"""

import numpy as np
import pytest

from lz4tpu import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native engine unavailable"
)


def test_pack_threads_env_paths(monkeypatch):
    monkeypatch.setenv("LZ4TPU_PACK_THREADS", "3")
    assert native.pack_threads() == 3
    monkeypatch.setenv("LZ4TPU_PACK_THREADS", "0")
    assert native.pack_threads() == 1          # clamped to >= 1
    monkeypatch.setenv("LZ4TPU_PACK_THREADS", "not-a-number")
    assert native.pack_threads() >= 1          # tuning knob never raises
    monkeypatch.delenv("LZ4TPU_PACK_THREADS")
    assert native.pack_threads() >= 1


def test_scan_sequences_error_status():
    # token: 1 literal + match, offset word 0x0000 -> E_OFFSET_ZERO
    bad = b"\x10A\x00\x00"
    status, *cols, total, reach = native.scan_sequences(bad)
    assert status == native.E_OFFSET_ZERO
    assert total == 0 and all(c.size == 0 for c in cols)


def test_scan_sequences_pooled_regrow():
    """The per-thread pooled scan scratch regrows when a larger block
    arrives, and views stay per-call consistent."""
    small = native.compress_block(b"tiny block data, repeated " * 4)
    rng = np.random.default_rng(5)
    words = [rng.integers(97, 123, 7, dtype=np.uint8).tobytes()
             for _ in range(64)]
    big_payload = b" ".join(
        words[rng.integers(0, 64)] for _ in range(40_000))
    from lz4tpu import compress
    from lz4tpu.frame import parse_frames
    from lz4tpu.constants import FOR_ALL

    frame = compress(big_payload, block_max_code=7)
    buf = np.frombuffer(frame, np.uint8)
    blk = parse_frames(buf, FOR_ALL).frames[0].blocks[0]
    assert blk.is_compressed
    st1, *_r1, t1, _ = native.scan_sequences(small, pooled=True)
    st2, *_r2, t2, _ = native.scan_sequences(
        buf[blk.comp_off:blk.comp_off + blk.comp_len], pooled=True)
    assert st1 == native.OK and st2 == native.OK
    assert t2 == len(big_payload)


def test_scan_block_full_error_status():
    bad = b"\x10A\x00\x00"
    res = native.scan_block_full(bad)
    assert res[0] < 0
    assert res[1].size == 0


def test_decode_block_ring_error_statuses():
    buf = np.zeros(1 << 20, np.uint8)
    st, _pos, _err = native.decode_block_ring(b"\x10A\x00\x00", buf, 0, 0)
    assert st == native.E_OFFSET_ZERO
    # back-reference before the stream start
    st, _pos, err = native.decode_block_ring(
        b"\x14A\x05\x00" + b"B" * 4, buf, 0, 0)
    assert st == native.E_BACKREF_RANGE and err < 0


def test_compress_block_paths():
    assert native.compress_block(b"") == b""
    payload = b"history path payload " * 30
    hist = b"history path "
    for kw in (dict(), dict(lazy=False), dict(optimal=True)):
        blk = native.compress_block(payload, hist=hist, **kw)
        ring = np.zeros(1 << 20, np.uint8)
        ring[:len(hist)] = np.frombuffer(hist, np.uint8)
        st, pos, _err = native.decode_block_ring(blk, ring, len(hist), 0)
        assert st == native.OK
        assert ring[len(hist):pos].tobytes() == payload


def test_compress_block_cands_shapes():
    joined = np.frombuffer(b"shape test shape test!", np.uint8)
    n = joined.size
    cand1d = np.full(n, -1, np.int32)
    blk = native.compress_block_cands(joined, 0, n, cand1d)
    from lz4tpu.block import decode_block

    assert decode_block(blk) == joined.tobytes()
    with pytest.raises(ValueError, match="cover the joined buffer"):
        native.compress_block_cands(
            joined, 0, n, np.zeros((1, n - 3), np.int32))


def test_native_xxh32_empty_update_and_reset():
    h = native.NativeXXH32()
    h.update(b"")                      # size-0 fast-out branch
    h.update(b"abc")
    from lz4tpu.xxh32 import xxh32 as pyhash

    assert h.final() == pyhash(b"abc")
    h.reset(seed=7)
    h.update(b"abc")
    assert h.final() == pyhash(b"abc", seed=7)


def test_available_caches_load_error(monkeypatch):
    """Once loading failed, available() reports False without
    retrying (the cached-error branch of _get)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error",
                        RuntimeError("simulated load failure"))
    assert native.available() is False
    with pytest.raises(RuntimeError, match="simulated"):
        native._get()


def test_get_stale_so_build_failure_is_cached(monkeypatch, tmp_path):
    """A missing/stale .so triggers a rebuild; a rebuild failure is
    cached as the load error (no retry storm on every call)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(native, "_so_path",
                        lambda: str(tmp_path / "absent.so"))

    def boom(so):
        raise RuntimeError("simulated compiler failure")

    monkeypatch.setattr(native, "_build", boom)
    with pytest.raises(RuntimeError, match="simulated compiler"):
        native._get()
    # the failure is now the cached load error
    assert isinstance(native._load_error, RuntimeError)
    assert native.available() is False


def test_build_compiles_and_binds(monkeypatch, tmp_path):
    """The self-compile path produces a loadable, bindable library
    (the in-process analog of the packaging test's fresh-interpreter
    self-compile)."""
    import ctypes

    so = tmp_path / "fresh_lz4core.so"
    native._build(str(so))
    assert so.exists() and so.stat().st_size > 0
    lib = native._bind(ctypes.CDLL(str(so)))
    assert lib.lz4tpu_xxh32_state_size() > 0


def test_library_name_keys_on_source_flags_and_host(monkeypatch):
    """The cached library is named by a hash of the source, the flags
    and the host CPU: the same inputs find the same file, and a copy of
    the checkout on another host (or with other flags) builds anew."""
    path = native._so_path()
    assert path == native._so_path()
    assert path.endswith(".so") and "_lz4core." in path
    monkeypatch.setattr(native, "_host_cpu", lambda: "another cpu")
    other_host = native._so_path()
    assert other_host != path
    monkeypatch.setattr(native, "_FLAGS", native._FLAGS + ["-g"])
    assert native._so_path() not in (path, other_host)
