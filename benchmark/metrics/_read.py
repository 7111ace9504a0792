"""The arithmetic the per-layer readers share. Each reader returns None
where its cell's stretch has nothing for it to read (another traffic, no
device time in the trace), and never 0 for a share."""

from __future__ import annotations

from typing import Optional

from benchmark.work import counts


def busy_ms(st, kind: str) -> Optional[float]:
    """Device busy ms a unit (step, pass, request) of the profiled stretch."""
    if st.kind != kind or st.busy_s <= 0 or not st.units:
        return None
    return st.busy_s / st.units * 1e3


def mfu(st, kind: str) -> Optional[float]:
    """% of the chip's peak matmul rate the model's FLOPs a unit reach over
    an unprofiled stretch's wall time."""
    if st.kind != kind or st.wall_s <= 0 or not st.unit_flops:
        return None
    return (st.unit_flops * st.wall_units / st.wall_s
            / counts.PEAKS["matmul_flops_per_s"] * 100.0)


def roofline(st, kind: str) -> Optional[float]:
    """% of the profiled stretch's device busy time that its work's least
    time (each item at its bound: FLOPs at peak or bytes at bandwidth)
    takes."""
    if st.kind != kind or st.busy_s <= 0 or not st.work:
        return None
    return counts.least_s(st.work) / st.busy_s * 100.0


def idle(st, kind: str) -> Optional[float]:
    """% of the profiled window with no device operation running."""
    if st.kind != kind or st.busy_s <= 0 or st.window_s <= 0:
        return None
    return max(0.0, st.window_s - st.busy_s) / st.window_s * 100.0


def window_idle(st, kind: str) -> Optional[float]:
    """% of the unprofiled stretch's wall time with no device operation
    running: 1 - (the profiled stretch's busy seconds a unit x the
    unprofiled stretch's units) / its seconds. Where the loop is paced by
    the host, the profiler's recording of host events slows the profiled
    stretch, and its own idle share reads the profiler, not the card."""
    if (st.kind != kind or st.busy_s <= 0 or not st.units
            or st.wall_s <= 0 or not st.wall_units):
        return None
    busy = st.busy_s / st.units * st.wall_units
    return max(0.0, st.wall_s - busy) / st.wall_s * 100.0


def span_ms(st, kind: str, name: str) -> Optional[float]:
    """Mean ms of the benchmark's span `name` over the unprofiled stretch."""
    vals = st.spans.get(name) if st.kind == kind else None
    if not vals:
        return None
    return sum(vals) / len(vals) * 1e3
