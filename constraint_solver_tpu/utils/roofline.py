"""Roofline accounting from XLA's compiled-program cost analysis.

The reference has no perf accounting at all (SURVEY.md §5 tracing row); here
each solver program reports:

- achieved FLOP/s as a fraction of the device's tensor-core (bf16, TF32)
  and non-tensor-core float32 peaks,
- device-memory traffic as a fraction of peak bandwidth,
- arithmetic intensity (flops/byte).

Flop/byte counts come from ``compiled.cost_analysis()`` -- XLA's own
accounting of the optimized HLO.  Peaks come from ``PEAKS``, keyed by
``jax.Device.device_kind``; a device that is not in the table is an error,
never a default.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    device_kind: str
    bf16: float    # FLOP/s, tensor cores, dense
    tf32: float    # FLOP/s, tensor cores, dense
    f32: float     # FLOP/s outside the tensor cores
    hbm_bw: float  # bytes/s
    source: str


PEAKS = {
    p.device_kind: p
    for p in (
        DevicePeaks(
            "NVIDIA H100 80GB HBM3", 989e12, 495e12, 67e12, 3.35e12,
            source="NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense",
        ),
    )
}


def peaks_for(device_kind: str) -> DevicePeaks:
    """The peaks of ``device_kind``; raises ``KeyError`` for any device the
    table does not list (the CPU included)."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}")
    return PEAKS[device_kind]


def cost_analysis(jitted, *args) -> dict[str, float]:
    """XLA-accounted flops / device-memory bytes of one call of a jitted
    program."""
    ca = jitted.lower(*args).compile().cost_analysis()
    return {
        "flops": float(ca.get("flops", 0.0)),
        "bytes": float(ca.get("bytes accessed", 0.0)),
    }


def roofline(
    flops_per_call: float,
    bytes_per_call: float,
    calls: int,
    wall_s: float,
    peaks: DevicePeaks,
) -> dict[str, Any]:
    """Measured roofline point: achieved FLOP/s + fractions of each peak."""
    f = flops_per_call * calls / wall_s
    b = bytes_per_call * calls / wall_s
    return {
        "device_kind": peaks.device_kind,
        "flops_per_sec": f,
        "hbm_bytes_per_sec": b,
        "frac_bf16": f / peaks.bf16,
        "frac_tf32": f / peaks.tf32,
        "frac_f32": f / peaks.f32,
        "hbm_frac": b / peaks.hbm_bw,
        "intensity_flops_per_byte": (flops_per_call / bytes_per_call)
        if bytes_per_call
        else float("inf"),
    }


def chunk_roofline(
    chunk_jit,
    state,
    rounds: int,
    wall_s: float,
    peaks: DevicePeaks,
    chunk: int = 2,
) -> dict[str, Any]:
    """Roofline of a solver's jitted chunk program over a measured solve.

    XLA's cost analysis of one ``chunk_jit(state, chunk)`` call gives
    flops/bytes per round; scaling by the solve's executed ``rounds`` over
    its measured ``wall_s`` yields the achieved FLOP/s / bandwidth point.
    Lowers and compiles one fresh program instance (the live jit cache is
    not reachable through ``.lower()``), so call this after a solve, never
    inside one.
    """
    ca = cost_analysis(chunk_jit, state, chunk)
    per_round_flops = ca["flops"] / chunk
    per_round_bytes = ca["bytes"] / chunk
    out = roofline(
        per_round_flops, per_round_bytes, max(rounds, 1), max(wall_s, 1e-9), peaks
    )
    out["flops_per_round"] = per_round_flops
    out["hbm_bytes_per_round"] = per_round_bytes
    out["rounds"] = rounds
    out["wall_s"] = wall_s
    return out


def format_roofline(r: dict[str, Any]) -> str:
    return (
        f"[{r['device_kind']}] {r['flops_per_sec']:.3g} FLOP/s "
        f"(bf16 {100 * r['frac_bf16']:.2f}%, TF32 {100 * r['frac_tf32']:.2f}%, "
        f"f32 {100 * r['frac_f32']:.2f}% of peak), "
        f"HBM {r['hbm_bytes_per_sec'] / 1e9:.1f} GB/s "
        f"({100 * r['hbm_frac']:.1f}% of peak), "
        f"intensity {r['intensity_flops_per_byte']:.2f} flop/B"
    )
