"""Plain host-side reference scorers, independent of the device code.

Each is a direct transcription of the reference semantics in Python/numpy,
used by the tests and by ``chip_smoke.py`` to check what the solver returns.
"""

from __future__ import annotations

import datetime
from collections import Counter

import numpy as np


def nqueens_conflicts(rows) -> int:
    """Total conflicts of a board (``rows[col] = row``), counting each
    attacking pair twice (reference examples/nqueens/src/lib.rs:74-87
    summed): sum of k * (k - 1) over rows, diagonals and anti-diagonals."""
    rows = np.asarray(rows, np.int64)
    n = len(rows)
    cols = np.arange(n)
    total = 0
    for line in (rows, rows - cols + (n - 1), rows + cols):
        k = np.bincount(line, minlength=2 * n)
        total += int(np.sum(k * (k - 1)))
    return total


def scheduling_score(start_date, assign, holidays_by_emp):
    """(hard, soft) per the reference scorer, built from dates like the
    original (kept deliberately different in structure from the jnp path).
    ``holidays_by_emp`` maps employee index -> list of dates."""
    days = [start_date + datetime.timedelta(days=i) for i in range(len(assign))]
    is_weekend = [d.weekday() >= 5 for d in days]
    hard = 0.0
    soft = 0.0

    # H1 holidays
    for emp, hols in holidays_by_emp.items():
        for hol in hols:
            idx = (hol - start_date).days
            if 0 <= idx < len(assign) and assign[idx] == emp:
                hard += 1

    # H2 consecutive days
    for i in range(len(assign) - 1):
        if assign[i] == assign[i + 1]:
            hard += 1

    # H3 consecutive weekends (windows of 9)
    for i in range(len(assign) - 8):
        if not (is_weekend[i] and is_weekend[i + 1]):
            continue
        for a in (i, i + 1):
            for b in (i + 7, i + 8):
                if assign[a] == assign[b]:
                    hard += 1

    # H4 > 3 per 14-day window
    for i in range(len(assign) - 13):
        counts = Counter(assign[i : i + 14])
        hard += sum(1 for c in counts.values() if c > 3)

    # S1 > 2 per 7-day window
    for i in range(len(assign) - 6):
        counts = Counter(assign[i : i + 7])
        soft += sum(1 for c in counts.values() if c > 2)

    # S2 weekday consistency (Mon-Fri)
    day_counts = {}
    for d, emp in zip(days, assign):
        if d.weekday() >= 5:
            continue
        day_counts.setdefault(d.weekday(), Counter())[emp] += 1
    for counts in day_counts.values():
        if len(counts) > 1:
            soft += min(counts.values())

    # S3/S4 spreads over employees with >= 1 day
    emp_days = {}
    for d, emp in zip(days, assign):
        emp_days.setdefault(emp, []).append(d)
    if len(emp_days) >= 2:
        totals = [len(v) for v in emp_days.values()]
        soft += max(totals) - min(totals)
        weekends = [sum(1 for d in v if d.weekday() >= 5) for v in emp_days.values()]
        soft += max(weekends) - min(weekends)

    return hard, soft
