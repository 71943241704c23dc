"""Device-side match finding (device/encode.py): candidates via gram
sorting + native emission.  Pure-XLA, so these run on CPU CI too."""

import numpy as np
import pytest

import lz4tpu
from lz4tpu.device import encode as de


def ref_candidates(data: np.ndarray, k: int = 1) -> np.ndarray:
    """O(n*k) reference: the k nearest previous identical 4-grams."""
    n = data.size
    out = np.full((k, n), -1, np.int64)
    prev: dict = {}
    d = data
    for p in range(n - 3):
        g = int(d[p]) | int(d[p + 1]) << 8 | int(d[p + 2]) << 16 \
            | int(d[p + 3]) << 24
        occ = prev.setdefault(g, [])
        for depth, q in enumerate(reversed(occ[-k:])):
            if p - q <= 65535:
                out[depth, p] = q
        occ.append(p)
    return out


class TestCandidates:
    def test_matches_reference_small(self):
        rng = np.random.default_rng(7)
        # low-entropy bytes so grams repeat
        data = rng.integers(0, 4, 5000, dtype=np.uint8)
        got = de.match_candidates(data)
        want = ref_candidates(data)
        # positions whose gram wraps into padding are masked to -1
        assert (got[0, : data.size - 3] == want[0, : data.size - 3]).all()

    def test_depth_k_matches_reference(self):
        rng = np.random.default_rng(8)
        data = rng.integers(0, 3, 4000, dtype=np.uint8)
        got = de.match_candidates(data, k_cands=4)
        want = ref_candidates(data, k=4)
        assert (got[:, : data.size - 3] == want[:, : data.size - 3]).all()

    def test_window_limit(self):
        # same gram 70000 apart: candidate must be masked (> 64 KiB)
        data = np.zeros(70016, np.uint8)
        data[:4] = [1, 2, 3, 4]
        data[70000:70004] = [1, 2, 3, 4]
        data[4:70000] = (np.arange(69996) % 251).astype(np.uint8) + 4
        got = de.match_candidates(data)
        assert got[0, 70000] == -1 or 70000 - got[0, 70000] <= 65535


class TestRoundTrip:
    def vectors(self):
        rng = np.random.default_rng(3)
        text = (b"the quick brown fox jumps over the lazy dog. " * 400)
        yield b""
        yield b"a"
        yield b"Hello, world." * 100
        yield bytes(5000)                       # zeros
        yield rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()  # random
        yield text
        yield text + bytes(10000) + text        # mixed

    def test_block_roundtrip(self):
        from lz4tpu.block import decode_block

        for payload in self.vectors():
            comp = de.compress_block_device(payload)
            if not payload:
                assert comp == b""
                continue
            got = decode_block(np.frombuffer(comp, np.uint8), len(payload))
            assert bytes(got) == payload

    def test_frame_roundtrip_device_backend(self):
        rng = np.random.default_rng(9)
        payload = (
            b"framed device-encoded payload " * 3000
            + rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
        )
        frame = lz4tpu.compress(payload, backend="device")
        assert lz4tpu.decompress(frame, backend="host") == payload

    def test_linked_blocks_history(self):
        # block 2 should find matches in block 1 via the 64 KiB history
        part = b"0123456789abcdef" * 64
        payload = part * 80                      # > one 64 KiB block
        frame = lz4tpu.compress(payload, backend="device",
                                block_max_code=4)
        assert lz4tpu.decompress(frame) == payload

    def test_ratio_close_to_host(self):
        text = open("/root/repo/README.md", "rb").read() * 8
        dev = lz4tpu.compress(text, backend="device")
        host = lz4tpu.compress(text)
        # depth-4 sorted-gram chain vs depth-64 hash chain: allow 10%
        assert len(dev) <= len(host) * 1.10

    def test_deeper_candidates_improve_ratio(self):
        rng = np.random.default_rng(15)
        words = [b"red", b"green", b"blue", b"cyan"]
        payload = b" ".join(
            words[int(rng.integers(0, 4))] for _ in range(50_000)
        )
        s1 = len(de.compress_block_device(payload, k_cands=1))
        s4 = len(de.compress_block_device(payload, k_cands=4))
        assert s4 <= s1
        from lz4tpu.block import decode_block
        got = decode_block(
            np.frombuffer(de.compress_block_device(payload, k_cands=4),
                          np.uint8),
            len(payload),
        )
        assert bytes(got) == payload


class TestShardedEncode:
    def test_padding_never_referenced(self):
        # Regression: the staging buffer zero-pads before the real
        # history; the emitter's backward match extension must not walk
        # into it (it would emit back-references before frame start).
        import jax
        from lz4tpu.dist import compress_sharded, make_mesh

        payload = (b"\x00ABCDEFGH\x00\x00ABCDEFGH"
                   + b"the rest of the payload " * 40)
        mesh = make_mesh(min(8, len(jax.devices())))
        frame = compress_sharded(payload, mesh, block_max_code=4)
        assert lz4tpu.decompress(frame) == payload
        seq = lz4tpu.compress(payload, backend="device", block_max_code=4,
                              content_checksum=True)
        assert frame == seq

    def test_empty_input(self):
        import jax
        from lz4tpu.dist import compress_sharded, make_mesh

        mesh = make_mesh(min(8, len(jax.devices())))
        frame = compress_sharded(b"", mesh)
        assert lz4tpu.decompress(frame) == b""
        assert frame == lz4tpu.compress(b"", backend="device",
                                        content_checksum=True)

    def test_matches_single_device(self):
        import jax
        from lz4tpu.dist import compress_sharded, make_mesh

        rng = np.random.default_rng(11)
        payload = (
            b"sharded encoding payload with plenty of repetition " * 2000
            + rng.integers(0, 256, 50000, dtype=np.uint8).tobytes()
        )
        mesh = make_mesh(min(8, len(jax.devices())))
        frame = compress_sharded(payload, mesh, block_max_code=4)
        assert lz4tpu.decompress(frame) == payload
        # block-parallel output must match the sequential device encoder
        seq = lz4tpu.compress(payload, backend="device", block_max_code=4,
                              content_checksum=True)
        assert frame == seq


class TestCompactCandidates:
    def test_shipped_bytes_per_payload_byte(self):
        """The compact stream ships <= 4 B of candidates per payload
        byte (round-2 verdict next-#5; the depth-8 chain shipped 32)."""
        rng = np.random.default_rng(21)
        payload = (b"compact candidate stream payload " * 3000
                   + rng.integers(0, 256, 30000, dtype=np.uint8).tobytes())
        data = np.frombuffer(payload, np.uint8)
        d = de.compact_candidates(data)
        assert d.dtype == np.uint16 and d.shape == (2, data.size)
        assert d.nbytes <= 4 * data.size

    def test_compact_positions_are_valid_predecessors(self):
        """Every compact candidate must be a true same-4-gram
        predecessor within the window (8-gram row implies 4-gram)."""
        rng = np.random.default_rng(22)
        data = rng.integers(0, 4, 6000, dtype=np.uint8)
        cand = de.deltas_to_positions(de.compact_candidates(data))
        n = data.size
        for row in range(2):
            need = 4 if row == 0 else 8
            for p in range(0, n - need, 97):
                c = cand[row, p]
                if c < 0:
                    continue
                assert 0 < p - c <= 65535
                assert bytes(data[c:c + need]) == bytes(data[p:p + need])

    def test_compact_ratio_close_to_depth8(self):
        """4 B/byte compact stream compresses within 2% of the 32 B/byte
        depth-8 chain on text (the 8-gram row reaches long matches at
        any chain depth, which is where the ratio lives)."""
        text = open("/root/repo/README.md", "rb").read() * 6
        compact = de.compress_block_device(text)
        deep = de.compress_block_device(text, k_cands=8)
        assert len(compact) <= len(deep) * 1.02
        from lz4tpu.block import decode_block
        got = decode_block(np.frombuffer(compact, np.uint8), len(text))
        assert bytes(got) == text


class TestDeviceEmission:
    """Device token-emission prototype (round-2 verdict next-#6): all
    match SEARCH on device (gram ladder + log-doubling run combining);
    the host does only the linear token splice (no search, no byte
    compares, no extension — native lz4tpu_emit_quantized)."""

    def payloads(self):
        rng = np.random.default_rng(31)
        yield b"the quick brown fox jumps over the lazy dog. " * 1400
        yield bytes(65536)                       # long run
        yield rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()
        yield (b"abcdef" * 5000 + bytes(8000)
               + rng.integers(0, 256, 9000, dtype=np.uint8).tobytes())
        yield b"x" * 7                            # tiny
        yield b""                                 # empty

    def test_round_trips_bit_exact(self):
        from lz4tpu.block import decode_block

        for payload in self.payloads():
            comp = de.compress_block_device_emit(payload)
            if not payload:
                assert comp == b""
                continue
            got = decode_block(np.frombuffer(comp, np.uint8),
                               len(payload))
            assert bytes(got) == payload

    def test_emit_inputs_are_true_matches(self):
        """Every device decision (length, offset) must be a REAL match
        — the host emitter never verifies, so this is the contract."""
        rng = np.random.default_rng(33)
        data = np.frombuffer(
            b"".join([b"periodic!" * 300, bytes(500),
                      rng.integers(0, 8, 4000, dtype=np.uint8).tobytes()]),
            np.uint8)
        elen, eoff = de.emit_inputs(np.array(data))
        n = data.size
        for p in range(n):
            L, d = int(elen[p]), int(eoff[p])
            if L == 0:
                continue
            assert d > 0 and p - d >= 0 and p + L <= n
            assert bytes(data[p - d:p - d + L]) == bytes(data[p:p + L])

    def test_ratio_vs_search_encoder(self):
        """Quantized+combined+extended lengths stay within 5% of the
        search encoder on text and runs (measured 1.00-1.03x with the
        8-level scheme + bounded forward extension)."""
        from lz4tpu import corpus

        text = corpus.log_text(np.random.default_rng(300), 307_200)
        for payload in (b"lorem ipsum dolor sit amet " * 2000,
                        bytes(50000) + b"tail " * 400, text):
            emit = de.compress_block_device_emit(payload)
            search = de.compress_block_device(payload)
            assert len(emit) <= len(search) * 1.05

    def test_one_sort_scheme_matches_exact_ladder_quality(self):
        """The one-sort emit-inputs scheme (segmented scans instead of
        per-level sorts) must stay within 2% of the EXACT per-level
        ladder's compressed sizes — including a buffer big enough that
        the 64 KiB window edge matters (real text, ~100 KiB)."""
        import jax
        import jax.numpy as jnp

        from lz4tpu import corpus

        t100k = corpus.log_text(np.random.default_rng(100), 102_400)
        rng = np.random.default_rng(44)
        mixed = (b"the quick brown fox %d | " * 1 % 0) + b"".join(
            b"var%d = value_%d; " % (i % 97, i % 31)
            for i in range(6000)
        ) + rng.integers(0, 256, 8000, dtype=np.uint8).tobytes()
        for payload in (t100k, mixed):
            data = np.frombuffer(payload, np.uint8)
            n = data.size
            n_pad = (n + 1023) // 1024 * 1024
            buf = np.zeros(n_pad, np.uint8)
            buf[:n] = data

            def sizes(fn):
                elen, eoff = fn(jnp.asarray(buf), np.int32(n),
                                n_pad=n_pad)
                elen = np.array(jax.device_get(elen)[:n])
                eoff = np.array(jax.device_get(eoff)[:n])
                from lz4tpu.native import emit_quantized
                return len(emit_quantized(data, 0, n, elen, eoff))

            new_sz = sizes(de._emit_inputs_device)
            old_sz = sizes(de._emit_inputs_device_ladder)
            assert new_sz <= old_sz * 1.02, (new_sz, old_sz)

    def test_history_matches(self):
        from lz4tpu.block import decode_block_ring_py

        hist = b"shared dictionary content " * 100
        payload = b"shared dictionary content " * 50 + b"new tail"
        comp = de.compress_block_device_emit(payload, hist=hist)
        buf = np.zeros(len(hist) + len(payload) + 8, np.uint8)
        buf[:len(hist)] = np.frombuffer(hist, np.uint8)
        end = decode_block_ring_py(
            np.frombuffer(comp, np.uint8), buf, len(hist), 0)
        assert bytes(buf[len(hist):end]) == payload

    def test_splice_merges_same_offset_runs(self):
        """The splice's arithmetic run merge (adjacent decisions at one
        offset concatenate; prefix-truncation at the end-literal zone)
        makes pure runs match the search encoder exactly: log-doubling
        alone leaves a 992-byte run as 512+256+128+64+32 tokens."""
        from lz4tpu.block import decode_block

        for payload in (bytes(992), bytes(1024), b"\xaa" * 100,
                        b"ab" * 3000):
            emit = de.compress_block_device_emit(payload)
            search = de.compress_block_device(payload)
            got = decode_block(np.frombuffer(emit, np.uint8),
                               len(payload))
            assert bytes(got) == payload
            assert len(emit) <= len(search)

    def test_frame_backend_device_emit(self):
        """Public frame path: compress(backend="device-emit") writes
        standard frames (linked blocks, history across blocks) that
        round-trip through the host engine."""
        import lz4tpu

        rng = np.random.default_rng(71)
        payload = (b"emit backend end to end " * 5000
                   + rng.integers(0, 256, 20000, dtype=np.uint8).tobytes())
        frame = lz4tpu.compress(payload, backend="device-emit",
                                block_max_code=4, block_checksum=True)
        assert lz4tpu.decompress(frame) == payload
