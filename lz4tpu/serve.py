"""Pipelined decode service: overlap host preprocessing with device
execution.

A decode request passes through two stages with very different
resources:

  host   frame parse -> native token scan -> plan -> staging
         (lz4tpu/native C++ and numpy)
  device sparse XLA programs / the byte-parallel resolver
         (lz4tpu/device; dispatched asynchronously)

The reference is a synchronous pull parser — one `Update` call does
both jobs on one core (lib/lz4ada.adb:383-418).  With an accelerator
the idiomatic shape is a two-stage pipeline: JAX dispatch is
asynchronous, so as soon as request N's programs are enqueued the host
is free to parse and scan request N+1 while the GPU decodes N.
``DecodeSession`` packages that: a background thread runs the host
stage and enqueues device work; callers collect results in submission
order.

Usage::

    with DecodeSession() as s:
        tickets = [s.submit(blob) for blob in blobs]
        outputs = [t.result() for t in tickets]
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from .constants import Reservation, FOR_ALL
from .errors import Lz4Error
from . import pipeline as pl


class DecodeTicket:
    """Handle for one submitted buffer; ``result()`` blocks until the
    decoded bytes are ready (or re-raises the decode error with
    reference-parity diagnostics)."""

    def __init__(self, session: "DecodeSession"):
        self._session = session
        self._done = threading.Event()
        self._release_lock = threading.Lock()
        self._released = False
        self._error: BaseException | None = None
        # set by the prep thread on success:
        self._buf: np.ndarray | None = None
        self._parsed = None
        self._table = None
        self._out_dev = None             # device result (None: no output)
        self._comp_dev = None            # staged input (block checksums)
        self._out_np: bytes | None = None
        self._verified = False           # checksums checked (either path)

    # -- prep-thread side -------------------------------------------------
    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._done.set()

    def _finish(self, buf, parsed, table, out_dev, comp_dev) -> None:
        self._buf = buf
        self._parsed = parsed
        self._table = table
        self._out_dev = out_dev
        self._comp_dev = comp_dev
        self._done.set()

    # -- caller side --------------------------------------------------------
    def _release_slot_once(self) -> None:
        """Free the session's in-flight slot exactly once (result() and
        result_on_device() may race from different threads; the session
        semaphore must not be double-released)."""
        with self._release_lock:
            if self._released:
                return
            self._released = True
        self._session._slots.release()

    def _wait(self, timeout: float | None) -> None:
        if not self._done.wait(timeout):
            raise TimeoutError("decode not finished")
        self._release_slot_once()
        if self._error is not None:
            raise self._error

    def result(self, timeout: float | None = None) -> bytes:
        self._wait(timeout)
        if self._out_np is None:
            import jax

            out = b""
            if self._out_dev is not None:
                out = np.asarray(jax.device_get(self._out_dev)).tobytes()
            if not self._verified:
                if self._table is not None:
                    self._session._verify(self._buf, self._parsed, out,
                                          self._table)
                self._mark_verified()
            self._out_np = out
        return self._out_np

    def _mark_verified(self) -> None:
        """Checksum contract settled: drop the inputs kept for it."""
        self._verified = True
        self._buf = None
        self._parsed = None
        self._comp_dev = None

    def result_on_device(self, timeout: float | None = None,
                         verify: str = "device"):
        """Like result(), but the decoded bytes stay a device-resident
        uint8 jax.Array (the GPU consumer path, cf.
        decompress_to_device).  verify: "device" (block and content
        checksums through the xxh32 kernel, no output fetch) or "none"
        (skip for now; a later result() on the same ticket still
        verifies before returning bytes).
        """
        if verify not in ("device", "none"):
            raise ValueError(
                f"result_on_device verify must be 'device' or 'none', "
                f"got {verify!r}"
            )
        self._wait(timeout)
        import jax.numpy as jnp

        if self._out_dev is None:
            # host bytes (the host-engine fallback, already verified) or
            # an empty output
            out = self._out_np or b""
            self._out_dev = jnp.asarray(np.frombuffer(out, np.uint8))
        if verify == "device" and not self._verified:
            from .pipeline import _verify_checksums_device

            if self._comp_dev is not None:
                _verify_checksums_device(
                    self._parsed, self._out_dev, self._table, self._comp_dev)
            elif self._table is not None:
                # nothing decoded: the empty output verifies on host
                self._session._verify(self._buf, self._parsed, b"",
                                      self._table)
            self._mark_verified()
        return self._out_dev


class DecodeSession:
    """Two-stage pipelined decoder (host prep thread + async device
    dispatch).  Results come back in submission order via tickets.

    max_inflight bounds the number of requests that have been submitted
    but whose results have not been collected yet — that is, it bounds
    the HBM held by pending outputs.  ``submit`` blocks once the bound
    is reached until a ``result()`` call frees a slot, so every ticket
    must eventually be collected.
    """

    def __init__(self, reservation: Reservation = FOR_ALL,
                 max_inflight: int = 4):
        self.reservation = Reservation(reservation)
        self._q: "queue.Queue" = queue.Queue()
        self._max_inflight = max(1, max_inflight)
        self._slots = threading.BoundedSemaphore(self._max_inflight)
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(
            target=self._prep_loop, name="lz4tpu-prep", daemon=True
        )
        self._thread.start()

    # -- submission ---------------------------------------------------------
    def submit(self, data, stats: pl.DecodeStats | None = None
               ) -> DecodeTicket:
        """Queue one buffer for decoding; ``stats`` (filled by the prep
        thread before the ticket completes) counts its layers and
        engines like ``decompress_to_device(stats=...)``."""
        self._slots.acquire()
        t = DecodeTicket(self)
        with self._lock:
            if self._closed:
                self._slots.release()
                raise RuntimeError("session closed")
            self._q.put((t, bytes(data), stats))
        return t

    def decode_all(self, blobs) -> list[bytes]:
        tickets = []
        outs = []
        # keep the submission window below the in-flight bound by
        # collecting the oldest result first, so this never deadlocks
        # against a blocking submit for any blob count
        for b in blobs:
            while len(tickets) >= self._max_inflight:
                outs.append(tickets.pop(0).result())
            tickets.append(self.submit(b))
        outs.extend(t.result() for t in tickets)
        return outs

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._thread.join()

    def __enter__(self) -> "DecodeSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- prep thread ----------------------------------------------------------
    def _prep_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            ticket, data, stats = item
            try:
                self._prep_one(ticket, data, stats)
            except BaseException as e:          # noqa: BLE001
                ticket._fail(e)

    def _prep_one(self, ticket: DecodeTicket, data: bytes,
                  stats: pl.DecodeStats | None) -> None:
        buf = np.frombuffer(data, dtype=np.uint8)
        if buf.size == 0:
            ticket._finish(buf, None, None, None, None)
            return
        try:
            parsed, table, out_dev, comp_dev = pl._decode_on_device(
                buf, data, self.reservation, stats)
        except pl.BatchCapacityExceeded:
            from .api import decompress_host

            # the streaming host engine fully verifies checksums itself
            ticket._out_np = decompress_host(data, self.reservation)
            if stats is not None:
                stats.note_engine("host", 0, len(ticket._out_np))
            ticket._verified = True
            ticket._done.set()
            return
        # Device work is enqueued (dispatch is async): the GPU decodes
        # this request while the thread scans the next one.
        ticket._finish(buf, parsed, table, out_dev, comp_dev)

    # -- result-side checksum verification --------------------------------
    @staticmethod
    def _verify(buf, parsed, out: bytes, table) -> None:
        pl._verify_checksums(
            buf, parsed, np.frombuffer(out, np.uint8), table
        )


__all__ = ["DecodeSession", "DecodeTicket", "Lz4Error"]
