"""Arithmetic the per-layer readers share (`benchmark/metrics/`).

A reader takes the run's facts (`core.result`: the entry's facts, the
traced stretch's summary under `trace`, the run's `ctx`) and returns its
number, or None where the run has nothing to read: no traced stretch,
no device activity in it, or a card with no row in the peaks table.  A
share of a roofline is never reported as 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import work


def traced(facts) -> Optional[dict]:
    """The traced stretch's summary, where it saw device activity."""
    s = facts.get("trace")
    return s if s and s["busy_s"] > 0 and s["window_s"] > 0 else None


def idle_share(facts) -> Optional[float]:
    """Per cent of the traced stretch in which the device ran nothing."""
    s = traced(facts)
    return None if s is None else 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def peak(facts) -> Optional[dict]:
    dev = facts["ctx"].device
    if dev.type != "cuda":
        return None
    return work.peaks(torch.cuda.get_device_name(dev))


def roofline(facts, work_key: str, units_key: str) -> Optional[float]:
    """Per cent of the bound: the least time the chip needs for one unit
    of work (`facts[work_key]`), over the device time a unit took in the
    traced stretch (every device operation's duration summed, over
    `facts[units_key]` units)."""
    s, p = traced(facts), peak(facts)
    units = facts.get(units_key)
    if s is None or p is None or not units or s["device_sum_s"] <= 0:
        return None
    per_unit = s["device_sum_s"] / units
    return 100.0 * work.bound_s(facts[work_key], p) / per_unit
