"""Device layer: the platform decision and the compile cache.

The device path runs on one accelerator, an NVIDIA GPU.  JAX's CPU
backend runs the same programs for tests, with the one Pallas kernel
(``device/xxh32.py``) in interpret mode.  :func:`platform` is the only
place that reads the platform; every engine choice and the interpret
flag ask it.
"""

from __future__ import annotations

import os


def platform() -> str:
    """``"gpu"`` or ``"cpu"``: the platform of JAX's default device.

    Raises ``RuntimeError`` on any other platform — the device path has
    no engine for it, and a silent fallback would hide that."""
    import jax

    name = jax.devices()[0].platform
    if name not in ("gpu", "cpu"):
        raise RuntimeError(
            f"lz4tpu's device path runs on an NVIDIA GPU (or on the CPU "
            f"for tests); JAX's default device is {name!r}"
        )
    return name


def interpret() -> bool:
    """Pallas kernels run in interpret mode exactly when the platform
    is the CPU; on the GPU they are compiled, never interpreted."""
    return platform() == "cpu"


def use_compile_cache(fallback: str | None = None) -> str | None:
    """Turn on JAX's persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself);
    otherwise the cache goes to ``fallback``, a directory the caller
    owns, and without one no cache is set.  Every program is cached,
    however fast it compiled."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or fallback
    if not path:
        return None
    if path == fallback:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
