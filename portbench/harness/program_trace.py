"""The program's own host spans and capture counters, for the per-layer
metrics that read them.

The program records its spans (``smc_tpu_torch/utils/metrics.py``:
``spans``) only while a ``torch.profiler`` session records, and a run of
the harness opens one session over program code: the traced slice. So
the spans read here are the slice's. Its capture counters
(``smc_tpu_torch/smc/graphs.py``: ``stats["shapes"]``) are kept at every
capture, which a run makes at set-up.

This module imports nothing of the program: ``program.py`` stays the
harness's one importer. It reads the two records from the program's
modules that ``program.py`` has loaded (``sys.modules``). A program
without them gives None, and so does a run whose record is empty.
"""
from __future__ import annotations

import sys

MS = 1e-6           # milliseconds per nanosecond


def spans():
    """The recorded spans as ``(name, start ns, end ns, parent index)``,
    in the order they opened; None where the program has no record or
    recorded nothing."""
    rec = getattr(sys.modules.get("smc_tpu_torch.utils.metrics"), "spans",
                  None)
    if not rec:
        return None
    return [(s.name, s.start, s.end, s.parent) for s in rec]


def shapes():
    """Per captured shape, ``{"pieces": {piece: [warm-up s, capture s]},
    "pool_bytes": n}``; None where the program keeps no such counter or
    captured nothing."""
    stats = getattr(sys.modules.get("smc_tpu_torch.smc.graphs"), "stats",
                    None)
    return (stats or {}).get("shapes") or None


def total_ns(recorded, name: str) -> int:
    """The summed durations of the spans called ``name``, or of every span
    under it where ``name`` ends in a dot."""
    return sum(b - a for n, a, b, _ in recorded if _named(n, name))


def count(recorded, name: str) -> int:
    return sum(1 for n, *_ in recorded if _named(n, name))


def self_ns(recorded, name: str) -> int:
    """The summed self time of the spans ``name`` (as in
    :func:`total_ns`): each one's duration less the part of it that its
    children's intervals cover."""
    children = {}
    for n, a, b, parent in recorded:
        if parent >= 0:
            children.setdefault(parent, []).append((a, b))
    out = 0
    for i, (n, a, b, _) in enumerate(recorded):
        if _named(n, name):
            out += (b - a) - _cover(children.get(i, ()), a, b)
    return out


def _named(n: str, name: str) -> bool:
    return n.startswith(name) if name.endswith(".") else n == name


def _cover(intervals, lo: int, hi: int) -> int:
    """The length of the union of ``intervals`` clipped to [lo, hi]."""
    out, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            out += b - a
            end = b
    return out


def per_posterior_ms(run, ns: int):
    """``ns`` of the traced slice in milliseconds per posterior that the
    slice completed; None without a slice or a posterior in it."""
    sl = run.slice
    if not sl or not sl.get("posteriors"):
        return None
    return ns * MS / sl["posteriors"]
