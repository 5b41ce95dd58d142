"""Time-quantum view naming and range decomposition.

Behavioral mirror of the reference's time.go:28-216: a quantum is a subset of
"YMDH"; a timestamped write lands in up to 4 views (one per unit); a time
range is decomposed into a minimal cover of views by walking up from the
smallest unit to aligned boundaries, then back down.
"""

from __future__ import annotations

import datetime as dt
from typing import List

VALID_QUANTUMS = {"Y", "YM", "YMD", "YMDH", "M", "MD", "MDH", "D", "DH", "H", ""}


def valid_quantum(q: str) -> bool:
    return q in VALID_QUANTUMS


_FORMATS = {"Y": "%Y", "M": "%Y%m", "D": "%Y%m%d", "H": "%Y%m%d%H"}


def view_by_time_unit(name: str, t: dt.datetime, unit: str) -> str:
    fmt = _FORMATS.get(unit)
    if fmt is None:
        return ""
    return f"{name}_{t.strftime(fmt)}"


def views_by_time(name: str, t: dt.datetime, quantum: str) -> List[str]:
    """All views a write at time t lands in for the given quantum."""
    out = []
    for unit in quantum:
        v = view_by_time_unit(name, t, unit)
        if v:
            out.append(v)
    return out


def _add_month(t: dt.datetime) -> dt.datetime:
    # Mirrors time.go addMonth: clamp to day 1 for day > 28 to avoid
    # Jan 31 + 1mo = Mar 2 style double-hops, then plain AddDate(0,1,0).
    if t.day > 28:
        t = t.replace(day=1, minute=0, second=0, microsecond=0)
    return _go_add_date(t, 0, 1)


def _go_add_date(t: dt.datetime, years: int, months: int) -> dt.datetime:
    """Go time.AddDate semantics: overflow days normalize into the next
    month (Jan 31 + 1mo = Mar 2/3), rather than clamping."""
    y = t.year + years
    m = t.month + months
    y += (m - 1) // 12
    m = (m - 1) % 12 + 1
    # Normalize day overflow the way Go does.
    day = t.day
    first = t.replace(year=y, month=m, day=1)
    return first + dt.timedelta(days=day - 1)


def _add_years(t: dt.datetime, n: int) -> dt.datetime:
    return _go_add_date(t, n, 0)


def _next_year_gte(t: dt.datetime, end: dt.datetime) -> bool:
    nxt = _go_add_date(t, 1, 0)
    return nxt.year == end.year or end > nxt


def _next_month_gte(t: dt.datetime, end: dt.datetime) -> bool:
    nxt = _go_add_date(t, 0, 1)
    return (nxt.year, nxt.month) == (end.year, end.month) or end > nxt


def _next_day_gte(t: dt.datetime, end: dt.datetime) -> bool:
    nxt = t + dt.timedelta(days=1)
    return (nxt.year, nxt.month, nxt.day) == (end.year, end.month, end.day) or end > nxt


def views_by_time_range(
    name: str, start: dt.datetime, end: dt.datetime, quantum: str
) -> List[str]:
    """Minimal view cover of [start, end) for the given quantum."""
    has_year = "Y" in quantum
    has_month = "M" in quantum
    has_day = "D" in quantum
    has_hour = "H" in quantum
    t = start
    results: List[str] = []

    # Walk up from smallest units to largest-aligned boundaries.
    if has_hour or has_day or has_month:
        while t < end:
            if has_hour:
                if not _next_day_gte(t, end):
                    break
                elif t.hour != 0:
                    results.append(view_by_time_unit(name, t, "H"))
                    t = t + dt.timedelta(hours=1)
                    continue
            if has_day:
                if not _next_month_gte(t, end):
                    break
                elif t.day != 1:
                    results.append(view_by_time_unit(name, t, "D"))
                    t = t + dt.timedelta(days=1)
                    continue
            if has_month:
                if not _next_year_gte(t, end):
                    break
                elif t.month != 1:
                    results.append(view_by_time_unit(name, t, "M"))
                    t = _add_month(t)
                    continue
            break

    # Walk back down from largest units to smallest.
    while t < end:
        if has_year and _next_year_gte(t, end):
            results.append(view_by_time_unit(name, t, "Y"))
            t = _add_years(t, 1)
        elif has_month and _next_month_gte(t, end):
            results.append(view_by_time_unit(name, t, "M"))
            t = _add_month(t)
        elif has_day and _next_day_gte(t, end):
            results.append(view_by_time_unit(name, t, "D"))
            t = t + dt.timedelta(days=1)
        elif has_hour:
            results.append(view_by_time_unit(name, t, "H"))
            t = t + dt.timedelta(hours=1)
        else:
            break

    return results


def parse_timestamp(s: str) -> dt.datetime:
    """Parse PQL's timestamp format YYYY-MM-DDTHH:MM."""
    return dt.datetime.strptime(s, "%Y-%m-%dT%H:%M")
