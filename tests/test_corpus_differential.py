"""Differential suite: every seeded corpus case through every decode
path of the device pipeline, bit for bit against the host engine.

Paths: ``decompress(backend="device")``; ``decompress_to_device`` with
host, device and no checksum verification; a ``DecodeSession`` ticket
collected as bytes and as a device array; ``decompress_sharded`` on a
4-device mesh.  Cases come from ``lz4tpu.corpus`` (frames from this
package's encoder plus hand-built legacy, skippable, concatenated,
stored-block, empty and checksum/content-size frames).
"""

import jax
import numpy as np
import pytest

import lz4tpu
from lz4tpu import corpus
from lz4tpu.pipeline import DecodeStats


def _to_device(verify):
    def run(frame, st):
        out = lz4tpu.decompress_to_device(frame, verify=verify, stats=st)
        assert isinstance(out, jax.Array) and out.dtype == np.uint8
        return np.asarray(out).tobytes()

    return run


def _session(on_device):
    def run(frame, st):
        with lz4tpu.DecodeSession() as s:
            ticket = s.submit(frame, st)
            if on_device:
                return np.asarray(ticket.result_on_device()).tobytes()
            return ticket.result()

    return run


def _sharded(frame, st):
    from lz4tpu.dist import decompress_sharded, make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    return decompress_sharded(frame, make_mesh(4), stats=st)


PATHS = {
    "device": lambda frame, st: lz4tpu.decompress(frame, backend="device",
                                                  stats=st),
    "to_device_verify_host": _to_device("host"),
    "to_device_verify_device": _to_device("device"),
    "to_device_verify_none": _to_device("none"),
    "session_bytes": _session(False),
    "session_device": _session(True),
    "sharded_4": _sharded,
}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("case", corpus.case_names())
def test_decode_matches_host_engine(case, path):
    """Bit for bit, and decoded by the device engines: every path falls
    back to the host engine on an error, so a device fault that raised
    on a good frame would otherwise pass unseen."""
    frame, payload = corpus.cases()[case]
    assert lz4tpu.decompress_host(frame) == payload
    st = DecodeStats()
    assert PATHS[path](frame, st) == payload
    assert "host" not in st.engine_bytes
    assert sum(st.engine_bytes.values()) == len(payload)


def test_corpus_is_seeded():
    """Same seed, same frames; another seed, other payloads."""
    a = corpus._case_frames(np.random.default_rng(0))
    assert a == corpus.cases(0)
    b = corpus._case_frames(np.random.default_rng(1))
    assert list(a) == list(b)
    assert a["text_cli_default"] != b["text_cli_default"]
