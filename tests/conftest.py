"""Test config: JAX on a virtual 8-device CPU mesh unless told otherwise.

Device-path tests exercise the same sharding code that runs across
GPUs; here there is no card, so XLA's host-platform device trick gives
the CPU backend eight devices.  ``JAX_PLATFORMS`` set by the caller
wins (``chip_smoke.py`` runs the ``gpu``-marked tests with
``JAX_PLATFORMS=cuda``).  Must run before the first ``import jax``.
"""

import functools
import os
import pathlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402

VECTORS = pathlib.Path(
    os.environ.get("LZ4TPU_VECTORS", "/root/reference/test_vectors_lz4")
)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is an NVIDIA GPU.  Decided here,
    at run time, never at import: every xdist worker must collect the
    same tests."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs these on one)")


@pytest.fixture(scope="session")
def vectors_dir() -> pathlib.Path:
    if not VECTORS.is_dir():
        pytest.skip(f"test vector directory not found: {VECTORS}")
    return VECTORS


def good_vector_names():
    if not VECTORS.is_dir():
        return []
    return sorted(
        p.stem
        for p in VECTORS.glob("*.lz4")
        if (VECTORS / (p.stem + ".bin")).exists()
    )


def error_vector_names():
    if not VECTORS.is_dir():
        return []
    return sorted(
        p.stem
        for p in VECTORS.glob("*.err")
        if (VECTORS / (p.stem + ".eds")).exists()
    )


@functools.lru_cache(maxsize=None)
def stand_in(name: str) -> tuple[bytes, bytes]:
    """(frame, payload) standing in for the reference vector ``name``:
    the same frame kind and header layout (so header dumps match the
    reference's golden text), with payloads from the seeded corpus."""
    import numpy as np

    from lz4tpu import compress, corpus

    rng = np.random.default_rng(sum(name.encode()))

    def legacy(p):
        return compress(p, frame_format="legacy"), p

    builders = {
        "t2": lambda: (compress(b"hi"), b"hi"),
        "t389": lambda: (lambda p: (compress(p), p))(
            corpus.log_text(rng, 389)),
        "t100k": lambda: (lambda p: (compress(p), p))(
            corpus.log_text(rng, 102_400)),
        "t1111k": lambda: (lambda p: (compress(
            p, block_independence=True, block_checksum=True), p))(
            corpus.log_text(rng, 1_137_664)),
        "z100": lambda: (compress(bytes(100)), bytes(100)),
        "z2841": lambda: (compress(bytes(2841), block_max_code=4),
                          bytes(2841)),
        "z100legacy": lambda: legacy(bytes(100)),
        "hellolegacy": lambda: legacy(b"Hello, legacy world!\n"),
        "concat390": lambda: (lambda a, b: (compress(a) + compress(b),
                                            a + b))(
            corpus.log_text(rng, 200), corpus.log_text(rng, 190)),
        "concatlegacy": lambda: (lambda a, b: (
            legacy(a)[0] + legacy(b)[0], a + b))(
            corpus.log_text(rng, 300), bytes(50)),
        "z101legacyplus": lambda: (lambda a, b: (
            legacy(a)[0] + compress(b), a + b))(
            bytes(101), corpus.log_text(rng, 500)),
        "skippable": lambda: (corpus.skippable_frame(bytes(19), 9), b""),
        "skipz100": lambda: (corpus.skippable_frame(b"skip me", 0)
                             + compress(bytes(100)), bytes(100)),
        "emptycraft": lambda: (compress(b"", content_size=True), b""),
    }
    return builders[name]()
