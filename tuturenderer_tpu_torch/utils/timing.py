"""Device time of a call on the card, between CUDA events."""
from __future__ import annotations

import time

import torch

SPIN_CYCLES_PER_MS = 2.0e6   # at most the card's clock: a hold no shorter


def device_ms(fn, reps: int = 20, warm: int = 3, hold_ms: float = 50.0,
              tries: int = 3) -> float:
    """Mean device time of one call, between CUDA events recorded around
    ``reps`` back-to-back calls after ``warm`` untimed ones.

    A spin kernel holds the stream for at least ``hold_ms`` while the host
    enqueues the calls, so the host's overhead between them does not count.
    If enqueueing took longer than the hold (the device would have waited
    on the host), the measurement is taken again with a longer hold, up to
    ``tries`` times, then this raises. Pass ``hold_ms=0`` for a call that
    synchronises inside (it cannot be held): its time then counts the
    host's time between device work too.

    (The profiler's CUDA trace is not used: on an H100 it dropped most of
    a trace's kernel records after long runs.)"""
    for _ in range(warm):
        fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        held = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        held.record()
        if hold_ms:
            torch.cuda._sleep(int(hold_ms * SPIN_CYCLES_PER_MS))
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if not hold_ms or host_ms < held.elapsed_time(start):
            return start.elapsed_time(end) / reps
        hold_ms = 2.0 * host_ms
    raise RuntimeError(f"the host took longer to enqueue {reps} calls than "
                       f"a hold of {hold_ms / 2.0:.1f} ms, {tries} times: "
                       "does the call synchronise (pass hold_ms=0)?")
