"""Pipelined decode session (lz4tpu/serve.py).

Reference analog: the synchronous pull loop of tool_unlz4ada
(unlz4ada.adb:25-61) — here the host stage and device stage overlap,
and these tests pin ordering, correctness, and error propagation of
that pipeline.
"""

import os

import numpy as np
import pytest

import lz4tpu
from lz4tpu.serve import DecodeSession
from lz4tpu import errors


def _vec(vectors_dir, name):
    data = (vectors_dir / f"{name}.lz4").read_bytes()
    bin_path = vectors_dir / f"{name}.bin"
    if bin_path.exists():
        ref = bin_path.read_bytes()
    else:  # z9m ground truth is absent upstream
        ref = b"\x00" * 9437166
    return data, ref


class TestSessionRoundTrip:
    def test_vectors_through_session(self, vectors_dir):
        names = ["t100k", "z100", "concat390", "skipz100",
                 "z101legacyplus", "emptycraft", "empty"]
        blobs, refs = [], []
        for n in names:
            d, r = _vec(vectors_dir, n)
            blobs.append(d)
            refs.append(r)
        with DecodeSession() as s:
            outs = s.decode_all(blobs)
        assert [len(o) for o in outs] == [len(r) for r in refs]
        for n, o, r in zip(names, outs, refs):
            assert o == r, n

    def test_compressed_roundtrips_interleaved_sizes(self):
        rng = np.random.default_rng(17)
        payloads = []
        for k in range(12):
            n = int(rng.integers(0, 50000))
            if k % 3 == 0:
                p = bytes(rng.integers(0, 256, n, dtype=np.uint8))
            elif k % 3 == 1:
                p = (b"the quick brown fox %d " % k) * (n // 20 + 1)
            else:
                p = b"\x00" * n
            payloads.append(p)
        blobs = [lz4tpu.compress(p) for p in payloads]
        # max_inflight >= len(blobs): all may be submitted before any
        # collection, so out-of-order collection can be exercised
        with DecodeSession(max_inflight=len(blobs)) as s:
            tickets = [s.submit(b) for b in blobs]
            # collect out of submission order: results must still match
            for i in reversed(range(len(tickets))):
                assert tickets[i].result() == payloads[i], i

    def test_result_on_device(self, vectors_dir):
        import jax

        d, r = _vec(vectors_dir, "t100k")
        with DecodeSession() as s:
            t = s.submit(d)
            arr = t.result_on_device()
            assert arr.dtype.name == "uint8"
            assert bytes(jax.device_get(arr).tobytes()) == r
            # repeated + mixed collection stays consistent
            assert t.result_on_device() is arr
            assert t.result() == r
        with DecodeSession() as s:
            t = s.submit(d)
            assert t.result() == r            # bytes first
            arr = t.result_on_device()        # then device
            assert bytes(jax.device_get(arr).tobytes()) == r

    def test_result_on_device_verify_contract(self, vectors_dir):
        # a corrupted content checksum must surface no matter how the
        # ticket is collected: verify="device" raises immediately;
        # verify="none" defers, but a later result() still raises
        bad = bytearray((vectors_dir / "t100k.lz4").read_bytes())
        bad[-1] ^= 0xFF
        with DecodeSession() as s:
            t = s.submit(bytes(bad))
            with pytest.raises(errors.Lz4Error):
                t.result_on_device()
        with DecodeSession() as s:
            t = s.submit(bytes(bad))
            arr = t.result_on_device(verify="none")
            assert arr.shape[0] == 102400     # bytes delivered unverified
            with pytest.raises(errors.Lz4Error):
                t.result()
        with DecodeSession() as s:
            t = s.submit(b"x")
            with pytest.raises(ValueError):
                t.result_on_device(verify="host")

    def test_capacity_fallback_result_on_device(self, vectors_dir,
                                                monkeypatch):
        # BatchCapacityExceeded tickets must deliver the host-engine
        # output through result_on_device too, not an empty array
        import lz4tpu.pipeline as plmod

        d, r = _vec(vectors_dir, "t2")

        def boom(*a, **k):
            raise plmod.BatchCapacityExceeded(1 << 40)

        monkeypatch.setattr(plmod, "build_seq_table", boom)
        import jax
        with DecodeSession() as s:
            t = s.submit(d)
            arr = t.result_on_device()
            assert bytes(jax.device_get(arr).tobytes()) == r

    def test_result_is_idempotent(self, vectors_dir):
        d, r = _vec(vectors_dir, "t2")
        with DecodeSession() as s:
            t = s.submit(d)
            assert t.result() == r
            assert t.result() == r

    def test_session_survives_many_submissions(self, vectors_dir):
        # decode_all windows submissions under the in-flight bound, so
        # any blob count works with a tiny max_inflight
        d, r = _vec(vectors_dir, "z1k")
        with DecodeSession(max_inflight=2) as s:
            assert s.decode_all([d] * 25) == [r] * 25

    def test_submit_blocks_at_inflight_bound(self, vectors_dir):
        # the documented bound: submit blocks once max_inflight results
        # are pending, and unblocks when one is collected
        import threading
        import time

        d, r = _vec(vectors_dir, "z1k")
        with DecodeSession(max_inflight=2) as s:
            t1, t2 = s.submit(d), s.submit(d)
            state = {}

            def third():
                state["t3"] = s.submit(d)
                state["done"] = True

            th = threading.Thread(target=third, daemon=True)
            th.start()
            time.sleep(0.3)
            assert "done" not in state       # blocked at the bound
            assert t1.result() == r          # frees a slot
            th.join(timeout=10)
            assert state.get("done")
            assert t2.result() == r
            assert state["t3"].result() == r


class TestSessionErrors:
    def test_error_propagates_with_parity_message(self, vectors_dir):
        bad = (vectors_dir / "corruptedblockchcksm.err").read_bytes()
        expected = (
            (vectors_dir / "corruptedblockchcksm.eds")
            .read_text().splitlines()[0]
        )
        with DecodeSession() as s:
            t = s.submit(bad)
            with pytest.raises(errors.Lz4Error) as ei:
                t.result()
        assert ei.value.ada_image() == expected

    def test_error_does_not_poison_session(self, vectors_dir):
        bad = (vectors_dir / "corruptedmagic.err").read_bytes()
        good, ref = _vec(vectors_dir, "t389")
        with DecodeSession() as s:
            t_bad = s.submit(bad)
            t_good = s.submit(good)
            with pytest.raises(errors.Lz4Error):
                t_bad.result()
            assert t_good.result() == ref

    def test_submit_after_close_raises(self):
        s = DecodeSession()
        s.close()
        s.close()  # idempotent
        with pytest.raises(RuntimeError):
            s.submit(b"")

    def test_empty_input(self):
        with DecodeSession() as s:
            assert s.submit(b"").result() == b""


class TestTicketEdges:
    def test_result_on_device_rejects_bad_verify_mode(self, vectors_dir):
        d, ref = _vec(vectors_dir, "t2")
        with DecodeSession() as s:
            t = s.submit(d)
            with pytest.raises(ValueError, match="'device' or 'none'"):
                t.result_on_device(verify="bogus")
            assert t.result() == ref

    def test_empty_input_device_result(self, vectors_dir):
        """A zero-output stream still yields a (0,) device array and an
        empty host result, through both collection orders."""
        d, _ = _vec(vectors_dir, "empty")
        with DecodeSession() as s:
            t = s.submit(d)
            arr = t.result_on_device()
            assert np.asarray(arr).size == 0
            assert t.result() == b""
        with DecodeSession() as s:
            t = s.submit(d)
            assert t.result() == b""
            assert np.asarray(t.result_on_device()).size == 0

    def test_deferred_verify_settles_on_host_result(self, vectors_dir):
        """verify="none" defers the checksum contract; a later host
        result() must still settle it (clean stream: no error)."""
        d, ref = _vec(vectors_dir, "t100k")
        with DecodeSession() as s:
            t = s.submit(d)
            t.result_on_device(verify="none")
            assert t.result() == ref

    def test_result_timeout_zero_on_unfinished(self, vectors_dir):
        """timeout=0 raises TimeoutError unless the decode already
        finished (large vector, checked immediately after submit)."""
        d, ref = _vec(vectors_dir, "b3444k")
        with DecodeSession() as s:
            t = s.submit(d)
            try:
                out = t.result(timeout=0.0)
                # rare on this box, legal: decode won the race
                assert out == ref
            except TimeoutError:
                assert t.result() == ref


def test_ticket_device_timeout_and_error_paths():
    # Deterministic ticket-level checks (no live session): a never-
    # finishing ticket times out without releasing its slot; a failed
    # ticket re-raises through result_on_device and releases exactly
    # once.
    from lz4tpu.errors import DataCorruption
    from lz4tpu.serve import DecodeTicket

    class _Slots:
        released = 0

        def release(self):
            type(self).released += 1

    class _Sess:
        _slots = _Slots()

    t = DecodeTicket(_Sess())
    with pytest.raises(TimeoutError, match="not finished"):
        t.result_on_device(timeout=0.01)
    assert _Slots.released == 0
    t._fail(DataCorruption("boom"))
    with pytest.raises(DataCorruption, match="boom"):
        t.result_on_device()
    with pytest.raises(DataCorruption, match="boom"):
        t.result(timeout=1)
    assert _Slots.released == 1
