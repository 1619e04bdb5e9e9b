"""Concave throughput-vs-GPUs scaling curves.

Real DNN training does not scale linearly: past a per-job saturation
point the marginal GPU buys less and less step-time (gradient
synchronization, pipeline bubbles, shrinking per-device batch).  The
seed model priced elasticity as *linear* efficiency up to ``2 x
demand_gpus`` (``Job.rate``), so the policy's expansion gate
systematically over-valued extra GPUs — the exact failure mode the
marginal-utility allocators of "Effective Elastic Scaling of Deep
Learning Workloads" (arXiv:2006.13878) and "An Optimal Resource
Allocator of Elastic Training" (arXiv:2109.03389) are built to avoid.

This module is the single home of the curve family both the policy's
water-filling passes and the simulator's progress accounting consume, so
charged speedup always equals allocated speedup:

* **Two-segment piecewise-linear efficiency.**  A job's efficiency at
  ``g`` GPUs (in demand-equivalents: ``eff(demand_gpus) == 1``) rises at
  slope ``1/demand`` up to the saturation knee ``knee_gpus``, then at
  ``sat_slope/demand`` (``0 <= sat_slope <= 1``) up to the ``2x`` cap.
  ``knee_gpus == 0`` is the *flat* (linear) sentinel — the seed model
  exactly, which keeps every pre-curve trace, decision digest and bench
  budget byte-identical.
* **Splice overhead stays multiplicative below demand** (Fig. 4 of the
  paper measures time-slicing, not scaling), matching the seed's
  ``rate``; the *pricing* helpers used by the policy's gates are
  overhead-free, like the seed's ``extra * interval`` gate was.
* **Derivation for real model configs**: ``fit_knee`` least-squares
  fits the family to (world size, throughput) samples, and
  ``curve_from_step_seconds`` feeds it from the per-world step-time
  estimates that ``analysis/roofline.py`` reports and
  ``launch/hillclimb.py`` searches over (throughput ~ 1/step_seconds at
  fixed global batch).  Synthetic traces draw a parametric
  (``knee``, ``sat_slope``) pair per job from a *separate* seeded
  stream (``simulator.synth_workload(curves=True)``) so the base trace
  stays byte-identical with curves off.

A copy of ``repro.scheduler.curves``: only the import prefix differs
(``tests/test_torch_copies.py`` holds the two equal).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

# efficiency is capped at this multiple of demand, like the seed model
MAX_SCALE = 2.0


def scaling_eff(
    g: int,
    demand: int,
    knee: int = 0,
    sat_slope: float = 1.0,
) -> float:
    """Demand-equivalent efficiency of running at ``g`` GPUs, before
    splice overhead.  ``knee == 0`` (the flat sentinel) or ``g`` at or
    below the knee reproduce the seed's linear ``min(g/demand, 2)``."""
    gf = min(float(g), MAX_SCALE * demand)
    if knee <= 0 or gf <= knee:
        return min(gf / demand, MAX_SCALE)
    return min((knee + sat_slope * (gf - knee)) / demand, MAX_SCALE)


def scaling_eff_vec(
    g: np.ndarray,
    demand: np.ndarray,
    knee: np.ndarray,
    sat_slope: np.ndarray,
) -> np.ndarray:
    """Vectorized ``scaling_eff`` (float64, overhead-free)."""
    d = demand.astype(np.float64)
    gf = np.minimum(g.astype(np.float64), MAX_SCALE * d)
    lin = np.minimum(gf / d, MAX_SCALE)
    over = (knee > 0) & (gf > knee)
    if not over.any():
        return lin
    kf = knee.astype(np.float64)
    curved = np.minimum((kf + sat_slope * (gf - kf)) / d, MAX_SCALE)
    return np.where(over, curved, lin)


def validate_curve(demand: int, knee: int, sat_slope: float) -> None:
    """Raise ``ValueError`` unless the (knee, slope) pair is a member of
    the concave family: the knee sits at or above demand (below it the
    job could never reach its nominal rate and every SLA computation
    keyed on ``ideal_seconds`` would silently lie) and the post-knee
    slope does not exceed the pre-knee slope (concavity)."""
    if knee < 0:
        raise ValueError(f"knee_gpus must be >= 0 (0 = linear), got {knee}")
    if knee and knee < demand:
        raise ValueError(
            f"knee_gpus {knee} below demand_gpus {demand}: the job could "
            "never reach its nominal rate; knee must be >= demand"
        )
    if not 0.0 <= sat_slope <= 1.0:
        raise ValueError(
            f"sat_slope must be in [0, 1] (concavity), got {sat_slope}"
        )


def fit_knee(
    worlds: Sequence[int],
    throughputs: Sequence[float],
    demand: int,
) -> Tuple[int, float]:
    """Fit ``(knee_gpus, sat_slope)`` to measured/estimated throughput
    samples.

    ``throughputs`` are in any consistent unit (tokens/s, steps/s);
    they are normalized so the sample nearest ``demand`` has efficiency
    1.  Every sampled world at or above demand is tried as the knee; the
    post-knee slope is the least-squares slope of the samples beyond it
    (clamped into [0, 1]), and the pair with the lowest squared error
    over the whole curve wins.  Fewer than two distinct samples above
    demand degenerate to the flat sentinel ``(0, 1.0)``."""
    w = np.asarray(worlds, np.float64)
    t = np.asarray(throughputs, np.float64)
    if w.size != t.size or w.size == 0:
        raise ValueError("worlds and throughputs must align and be non-empty")
    order = np.argsort(w)
    w, t = w[order], t[order]
    ref = int(np.argmin(np.abs(w - demand)))
    if t[ref] <= 0:
        return 0, 1.0
    eff = t / t[ref] * (w[ref] / demand)  # efficiency in demand units
    above = w >= demand
    if np.count_nonzero(above) < 2:
        return 0, 1.0
    best: Tuple[float, int, float] = (np.inf, 0, 1.0)
    for k in w[above]:
        tail = w > k
        if tail.any():
            dw = w[tail] - k
            de = eff[tail] - k / demand
            slope = float(np.dot(dw, de) / np.dot(dw, dw)) * demand
            slope = min(1.0, max(0.0, slope))
        else:
            slope = 1.0
        knee = np.full_like(w, k)
        sat = np.full_like(w, slope)
        model = scaling_eff_vec(w, np.full_like(w, demand), knee, sat)
        err = float(np.sum((model - eff) ** 2))
        if err < best[0] - 1e-12:
            best = (err, int(round(k)), slope)
    _, knee_g, sat = best
    if knee_g >= MAX_SCALE * demand or (sat >= 1.0 - 1e-9 and knee_g <= demand):
        return 0, 1.0  # indistinguishable from linear: flat sentinel
    return max(int(demand), knee_g), sat


def curve_from_step_seconds(
    step_seconds_by_world: Mapping[int, float],
    demand: int,
) -> Tuple[int, float]:
    """Derive a job curve from per-world step-time estimates — the form
    ``analysis/roofline.py`` reports (``RooflineReport.step_seconds``
    per mesh) and ``launch/hillclimb.py``'s analytic search produces.
    At fixed global batch, throughput ~ 1/step_seconds."""
    worlds = sorted(step_seconds_by_world)
    thr = []
    for wsize in worlds:
        s = float(step_seconds_by_world[wsize])
        if s <= 0:
            raise ValueError(f"non-positive step_seconds at world {wsize}")
        thr.append(1.0 / s)
    return fit_knee(worlds, thr, demand)


def synth_curve_params(
    rng: np.random.Generator,
    demand: np.ndarray,
    knee_range: Tuple[float, float] = (1.0, 1.6),
    sat_range: Tuple[float, float] = (0.05, 0.5),
) -> Tuple[np.ndarray, np.ndarray]:
    """Parametric concave family for synthetic traces: per-job knee at
    ``uniform(knee_range) x demand`` (clamped into [demand, 2 demand])
    and post-knee slope ``uniform(sat_range)``.  The caller owns the
    generator so the draw order is isolated from the trace's own
    stream."""
    d = np.asarray(demand, np.int64)
    frac = rng.uniform(knee_range[0], knee_range[1], d.size)
    knee = np.clip(np.rint(d * frac), d, MAX_SCALE * d).astype(np.int64)
    sat = rng.uniform(sat_range[0], sat_range[1], d.size)
    return knee, sat


def curves_for_reports(reports, demand: int) -> Dict[str, Tuple[int, float]]:
    """(knee, sat_slope) per model arch from ``RooflineReport`` rows —
    group by ``arch`` and fit over each group's (chips, 1/step_seconds)
    samples.  Accepts the dataclasses from ``analysis/roofline.py``
    without importing them (duck-typed: ``arch``/``chips``/
    ``step_seconds``), so this stays importable without jax."""
    by_arch: Dict[str, Dict[int, float]] = {}
    for r in reports:
        by_arch.setdefault(r.arch, {})[int(r.chips)] = float(r.step_seconds)
    return {
        arch: curve_from_step_seconds(samples, demand)
        for arch, samples in by_arch.items()
    }
