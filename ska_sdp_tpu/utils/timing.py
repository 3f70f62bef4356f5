"""Phase timing / observability.

The reference exposes Accelerate's debug-flag system (compile/exec phase
timings, ``dump_phases`` etc. — SURVEY §5, ``app/Main.hs:80-112``).  The
equivalent here: lightweight wall-clock phase timers that are also the
hook point for ``jax.profiler`` traces, behind one env/CLI surface.

Set ``SKA_SDP_TPU_DUMP_PHASES=1`` (or pass ``-dphases`` on the CLI) to print
per-phase wall-clock lines; ``SKA_SDP_TPU_TRACE_DIR=<dir>`` additionally
captures a ``jax.profiler`` trace around each phase for xprof/tensorboard.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict


class PhaseTimer:
    def __init__(self, enabled: bool | None = None, trace_dir: str | None = None):
        if enabled is None:
            enabled = os.environ.get("SKA_SDP_TPU_DUMP_PHASES", "0") == "1"
        if trace_dir is None:
            trace_dir = os.environ.get("SKA_SDP_TPU_TRACE_DIR") or None
        self.enabled = enabled
        self.trace_dir = trace_dir
        self.times: Dict[str, float] = {}
        # non-time observables (e.g. drop counts) — kept out of `times`
        # so report()/metrics never render a count with an "ms" suffix
        self.counters: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        ctx = contextlib.nullcontext()
        if self.trace_dir:
            import jax

            ctx = jax.profiler.trace(self.trace_dir)
        t0 = time.perf_counter()
        with ctx:
            yield
        dt = time.perf_counter() - t0
        self.times[name] = self.times.get(name, 0.0) + dt
        if self.enabled:
            print(f"[phase] {name:<28s} {dt*1e3:10.2f} ms", flush=True)

    def report(self) -> str:
        return "\n".join(
            f"{k:<28s} {v*1e3:10.2f} ms" for k, v in self.times.items()
        )

    # ---- device-time attribution --------------------------
    #
    # The single-jit pipelines give one opaque "h2d+compile+grid+fft" wall
    # time; a user cannot attribute a slow step to binning vs kernel vs
    # FFT.  device_stage() runs one pipeline stage as its own synchronized
    # dispatch and records its wall time under "device/<name>" — the
    # practical equivalent of the reference's Accelerate phase dumps
    # (app/Main.hs:84 dump_phases).  NOTE: each stage's time includes one
    # host→device dispatch round trip; dispatch_floor() measures it once
    # so readers can subtract.

    def device_stage(self, name: str, fn, *args, **kwargs):
        """Run ``fn(*args)`` twice — a warmup (traces + compiles) and a
        timed re-run — block until the device finishes each, record the
        re-run wall time as ``device/<name>`` (and the first call as
        ``device/<name>+compile``), and return the result."""
        import jax

        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        dt_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        dt = time.perf_counter() - t0
        self.times[f"device/{name}+compile"] = (
            self.times.get(f"device/{name}+compile", 0.0) + dt_first
        )
        key = f"device/{name}"
        self.times[key] = self.times.get(key, 0.0) + dt
        if self.enabled:
            print(f"[device-phase] {name:<24s} {dt*1e3:10.2f} ms "
                  f"(first call incl. compile: {dt_first*1e3:.2f} ms)",
                  flush=True)
        return out

    def dispatch_floor(self) -> float:
        """One-time measurement of the per-dispatch round-trip latency
        (a trivial jitted op, fully synchronized)."""
        import jax
        import jax.numpy as jnp

        @jax.jit
        def tiny(x):
            return jnp.sum(jnp.sin(x))

        jax.block_until_ready(tiny(jnp.arange(8.0)))       # compile
        t0 = time.perf_counter()
        jax.block_until_ready(tiny(jnp.arange(8.0) + 1.0))
        dt = time.perf_counter() - t0
        self.times["device/dispatch-floor"] = dt
        if self.enabled:
            print(f"[device-phase] {'dispatch-floor':<24s} {dt*1e3:10.2f} ms"
                  " (per-stage host round-trip; subtract from each stage)",
                  flush=True)
        return dt
