#!/usr/bin/env python3
"""Smoke test of the device decode path on an NVIDIA GPU.

Drives the served decode path through the entry points a user calls,
at full size, and checks every result bit for bit against the native
host engine.  Inputs are generated from ``--seed`` (lz4tpu.corpus).

    python chip_smoke.py            # one GPU: phases (f), (a)-(e)
    python chip_smoke.py --four     # four GPUs: the sharded decode only

Phases:
  (f) the ``gpu``-marked tests, in a child process that finishes before
      this process touches JAX (one process on the card at a time);
  (a) ``decompress_to_device``: a 64 MiB log-text frame with the lz4
      CLI defaults (4 MiB independent blocks, content checksum,
      verify="device"); a 16 MiB linked-block (-BD) frame with block
      checksums (one dependent chain); a 64 MiB zeros frame (its rate
      beside the card's copy rate); a 32 MiB incompressible frame;
  (b) ``DecodeSession``: 256 message-broker batches (frames of 64 KiB
      independent blocks, 16 KiB-1 MiB each), half collected with
      ``result_on_device()``, half with ``result()``;
  (c) ``decompress(backend="auto")``: 1 MiB goes to the device, 4 KiB
      to the host;
  (d) the Triton xxh32 kernel against native xxh32, with a Triton
      custom call asserted in the lowered HLO;
  (e) ``compress(backend="device")`` on 4 MiB with a host round trip.

``--four``: ``decompress_sharded`` on a 64 MiB independent-block frame
(chain-parallel) and a 16 MiB linked chain (span-sharded resolver),
each against the host engine and one-device ``decompress_to_device``.

Earlier lines report the card (nvidia-smi name and power limit), each
phase's compile and run seconds, the bytes each engine decoded, the
largest resolver program's memory analysis, peak device memory and the
compile-cache counters.  The last line is one JSON object; the exit
code is non-zero, with no JSON line, on any failure or without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
MiB = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def run_gpu_tests() -> None:
    """Phase (f): the gpu-marked tests, run on the card by a child."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-rs",
         "-p", "no:cacheprovider", os.path.join(HERE, "tests")],
        capture_output=True, text=True, env=env, cwd=HERE, timeout=600)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    log(f"(f) gpu tests: rc={r.returncode} {tail} "
        f"({time.perf_counter() - t0:.1f} s)")
    if r.returncode != 0 or "skipped" in tail or "passed" not in tail:
        sys.stdout.write(r.stdout[-6000:] + r.stderr[-3000:])
        raise RuntimeError("gpu-marked tests did not all pass on the card")


class Smoke:
    def __init__(self, seed: int):
        import numpy as np

        self.np = np
        self.seed = seed
        self.failed: list[str] = []
        self.launches: list = []

    def rng(self, k: int):
        return self.np.random.default_rng([self.seed, k])

    def phase(self, name: str, fn) -> None:
        try:
            fn()
        except Exception:       # noqa: BLE001 — report, run the rest
            self.failed.append(name)
            log(f"{name}: FAILED\n{traceback.format_exc()}")

    def timed(self, fn):
        """(first-call seconds, warm-call seconds, warm result): the
        first call compiles whatever it has not seen."""
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        out = fn()
        t2 = time.perf_counter()
        return t1 - t0, t2 - t1, out

    def check(self, name, got: bytes, host: bytes, payload: bytes) -> None:
        if not (got == host == payload):
            raise AssertionError(f"{name}: output differs from the host "
                                 "engine")

    # -- (a) ------------------------------------------------------------
    def to_device(self, name, frame, payload, verify="device"):
        import jax

        import lz4tpu
        from lz4tpu.pipeline import DecodeStats

        stats = []

        def run():
            st = DecodeStats()
            out = lz4tpu.decompress_to_device(frame, verify=verify,
                                              stats=st)
            out.block_until_ready()
            stats.append(st)
            return out

        first, warm, out = self.timed(run)
        got = self.np.asarray(jax.device_get(out)).tobytes()
        self.check(name, got, lz4tpu.decompress_host(frame), payload)
        st = stats[-1]
        self.launches += st.resolve_launches
        host = {k: v for k, v in st.engine_bytes.items() if k == "host"}
        if host:
            raise AssertionError(f"{name}: host engine decoded {host}")
        log(f"(a) {name}: {len(payload)} B from {len(frame)} B, "
            f"compile+run {first:.3f} s, run {warm:.4f} s "
            f"({len(payload) / warm / 1e9:.2f} GB/s), "
            f"engine_bytes={st.engine_bytes}, bit-exact vs host engine; "
            f"host clock: parse {st.parse_s:.4f} s, scan {st.scan_s:.4f} s, "
            f"plan {st.plan_s:.4f} s, enqueue {st.device_s:.4f} s, "
            f"verify {st.verify_s:.4f} s")
        return warm

    def phase_a(self) -> None:
        from bench import copy_rate
        from lz4tpu import compress, corpus

        text = corpus.log_text(self.rng(1), 64 * MiB)
        self.to_device("text 64 MiB, lz4 CLI defaults",
                       compress(text, block_independence=True), text)
        linked = text[:16 * MiB]
        self.to_device("text 16 MiB -BD + block checksums",
                       compress(linked, block_checksum=True), linked)
        zeros = corpus.zeros(64 * MiB)
        t_zero = self.to_device("zeros 64 MiB",
                                compress(zeros, block_independence=True),
                                zeros)
        rnd = corpus.incompressible(self.rng(2), 32 * MiB)
        self.to_device("incompressible 32 MiB",
                       compress(rnd, block_independence=True), rnd)

        log(f"(a) zeros 64 MiB decode: {64 * MiB / t_zero / 1e9:.2f} GB/s "
            f"end to end; card copy rate (read+write, 64 MiB, timed "
            f"in-program): {copy_rate(64 * MiB, 5):.1f} GB/s")

    # -- (b) ------------------------------------------------------------
    def phase_b(self) -> None:
        import jax

        import lz4tpu
        from lz4tpu import corpus
        from lz4tpu.pipeline import DecodeStats

        rng = self.rng(3)
        sizes = self.np.exp(rng.uniform(self.np.log(16 << 10),
                                        self.np.log(1 << 20), 256))
        reqs = [corpus.kafka_frame(rng, int(n)) for n in sizes]
        st = DecodeStats()
        t0 = time.perf_counter()
        with lz4tpu.DecodeSession(max_inflight=8) as s:
            pending = []
            for i, (frame, _payload) in enumerate(reqs):
                if len(pending) == 8:
                    self.collect(reqs, *pending.pop(0))
                pending.append((i, s.submit(frame, stats=st)))
            for item in pending:
                self.collect(reqs, *item)
        jax.effects_barrier()
        dt = time.perf_counter() - t0
        total = sum(len(p) for _f, p in reqs)
        if "host" in st.engine_bytes:
            raise AssertionError(f"host engine decoded {st.engine_bytes}")
        log(f"(b) DecodeSession: 256 requests, {total} B in {dt:.2f} s "
            f"(first use, compiles included), "
            f"engine_bytes={st.engine_bytes}, all bit-exact vs host engine")

    def collect(self, reqs, j, ticket) -> None:
        """Odd requests stay on the device, even ones come back as
        bytes."""
        import lz4tpu

        frame, payload = reqs[j]
        if j % 2:
            got = self.np.asarray(ticket.result_on_device()).tobytes()
        else:
            got = ticket.result()
        self.check(f"request {j}", got, lz4tpu.decompress_host(frame),
                   payload)

    # -- (c) ------------------------------------------------------------
    def phase_c(self) -> None:
        import lz4tpu
        from lz4tpu import corpus
        from lz4tpu.pipeline import DecodeStats

        for size, engine_ok in ((1 * MiB, lambda e: "host" not in e),
                                (4 << 10, lambda e: set(e) == {"host"})):
            payload = corpus.log_text(self.rng(4), size)
            frame = lz4tpu.compress(payload)
            st = DecodeStats()
            got = lz4tpu.decompress(frame, backend="auto", stats=st)
            self.check(f"auto {size}", got, lz4tpu.decompress_host(frame),
                       payload)
            if not engine_ok(st.engine_bytes):
                raise AssertionError(f"auto {size}: {st.engine_bytes}")
            log(f"(c) decompress(auto) {size} B -> engine_bytes="
                f"{st.engine_bytes}, bit-exact vs host engine")

    # -- (d) ------------------------------------------------------------
    def phase_d(self) -> None:
        import jax

        from lz4tpu import native
        from lz4tpu.device import interpret
        from lz4tpu.device import xxh32 as dx

        rng = self.rng(5)
        data = rng.integers(0, 256, 64 * MiB + 37, dtype=self.np.uint8)
        offs = [0, 1, 3, 5, 17, 1000, 0]
        lens = [64 * MiB + 37, 0, 15, 16, 4 * MiB + 9, 65536, 129]
        d, st, ns = dx.prepare_ranges(data, offs, lens)
        hlo = dx.lane_states.lower(d, st, ns,
                                   interpret=interpret()).as_text()
        if "__gpu$xla.gpu.triton" not in hlo:
            raise AssertionError("no Triton custom call in the lowered HLO")
        first, warm, got = self.timed(lambda: dx.xxh32_ranges(d, offs, lens))
        want = [native.native_xxh32(data[o:o + n]) for o, n in zip(offs, lens)]
        if got != want:
            raise AssertionError(f"xxh32 kernel {got} != native {want}")
        log(f"(d) xxh32 Triton kernel (custom call __gpu$xla.gpu.triton in "
            f"HLO): {len(lens)} ranges up to 64 MiB match native xxh32; "
            f"compile+run {first:.3f} s, run {warm:.4f} s")
        jax.effects_barrier()

    # -- (e) ------------------------------------------------------------
    def phase_e(self) -> None:
        import lz4tpu
        from lz4tpu import corpus

        payload = corpus.log_text(self.rng(6), 4 * MiB)
        first, warm, frame = self.timed(
            lambda: lz4tpu.compress(payload, backend="device"))
        host = lz4tpu.decompress_host(frame)
        self.check("device encode round trip", host, host, payload)
        log(f"(e) compress(backend='device') 4 MiB -> {len(frame)} B, "
            f"compile+run {first:.3f} s, run {warm:.3f} s, host decode "
            f"round trip bit-exact")

    # -- --four ---------------------------------------------------------
    def phase_four(self) -> None:
        import lz4tpu
        from lz4tpu import corpus
        from lz4tpu.dist import decompress_sharded, make_mesh

        mesh = make_mesh(4)
        text = corpus.log_text(self.rng(7), 64 * MiB)
        for name, frame, payload in (
                ("chain-parallel: 64 MiB, 4 MiB independent blocks",
                 lz4tpu.compress(text, block_independence=True), text),
                ("span-sharded resolver: 16 MiB linked chain",
                 lz4tpu.compress(text[:16 * MiB], block_checksum=True),
                 text[:16 * MiB])):
            first, warm, got = self.timed(
                lambda: decompress_sharded(frame, mesh))
            one = self.np.asarray(
                lz4tpu.decompress_to_device(frame)).tobytes()
            self.check(name, got, lz4tpu.decompress_host(frame), payload)
            self.check(name + " (one device)", one, payload, payload)
            log(f"(4) {name}: compile+run {first:.3f} s, run {warm:.4f} s "
                f"({len(payload) / warm / 1e9:.2f} GB/s to host bytes); "
                f"bit-exact vs host engine and one-device "
                f"decompress_to_device")

    def report_memory(self) -> None:
        import jax
        import jax.numpy as jnp

        from lz4tpu.device import decode as dev

        if self.launches:
            n_out, s_pad, comp, rounds = max(self.launches)
            ma = dev.resolve.lower(
                jax.ShapeDtypeStruct((comp,), jnp.uint8),
                jax.ShapeDtypeStruct((len(dev.COLS), s_pad), jnp.int32),
                jax.ShapeDtypeStruct((), jnp.int32),
                n_out=n_out, rounds=rounds).compile().memory_analysis()
            log(f"largest resolver program n_out={n_out} n_seqs={s_pad} "
                f"n_comp={comp} rounds={rounds}: memory_analysis "
                f"argument={ma.argument_size_in_bytes} "
                f"output={ma.output_size_in_bytes} "
                f"temp={ma.temp_size_in_bytes} B")
        for d in jax.devices():
            log(f"device {d.id} peak_bytes_in_use="
                f"{(d.memory_stats() or {}).get('peak_bytes_in_use')}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded decode")
    args = ap.parse_args()

    try:
        card = card_line()
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"chip_smoke: no NVIDIA GPU ({exc})", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import lz4tpu  # noqa: F401 — fails outside a checkout of the repo

    if not args.four:
        try:
            run_gpu_tests()
        except Exception as exc:    # noqa: BLE001
            print(f"chip_smoke: {exc}", file=sys.stderr)
            return 1

    import jax
    from jax import monitoring

    from lz4tpu.device import platform, use_compile_cache

    cache_dir = use_compile_cache(os.path.join(HERE, ".jax_cache"))
    counts: dict = {}
    monitoring.register_event_listener(
        lambda event, **kw: counts.__setitem__(event, counts.get(event, 0) + 1))
    if platform() != "gpu":
        print("chip_smoke: JAX found no GPU", file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if len(jax.devices()) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 1

    smoke = Smoke(args.seed)
    t0 = time.perf_counter()
    if args.four:
        smoke.phase("four", smoke.phase_four)
    else:
        for name in ("a", "b", "c", "d", "e"):
            smoke.phase(name, getattr(smoke, f"phase_{name}"))
    smoke.phase("memory", smoke.report_memory)
    hits = counts.get("/jax/compilation_cache/cache_hits", 0)
    misses = counts.get("/jax/compilation_cache/cache_misses", 0)
    log(f"compile cache {cache_dir}: {hits} hits, {misses} misses; "
        f"phases took {time.perf_counter() - t0:.1f} s")
    log(f"card: {card}")
    if smoke.failed:
        print(f"chip_smoke: failed phases {smoke.failed}", file=sys.stderr)
        return 1
    dev0 = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev0.platform, "kind": dev0.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
