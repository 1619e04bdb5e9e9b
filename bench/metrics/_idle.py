"""The device's idle time inside host spans, for the readers of the
program's spans (``slice_idle_ms.train``, ``boundary_idle_ms.train``).

The idle time is the gaps between the pieces of the union of the device's
operations (``bench.trace.gaps``).  A gap counts where it overlaps a span,
not by the span open at its start, so a gap that straddles a span's edge
is split between the two sides."""
from bench.trace import gaps


def idle_within(trace, inside, outside=()):
    """Seconds of the device's idle time that lie inside a host interval
    named in ``inside`` and outside every one named in ``outside``; None
    where one of those names is not in the trace."""
    names = {name for name, _, _ in trace.host}
    if not names.issuperset(inside) or not names.issuperset(outside):
        return None
    # a sweep over the edges: (time, kind, +1 at a start or -1 at an end),
    # kind 0 a gap, 1 an inside span, 2 an outside one
    edges = []
    for start, length in gaps([(a, b) for _, a, b in trace.device]):
        edges += [(start, 0, 1), (start + length, 0, -1)]
    for name, a, b in trace.host:
        kind = 1 if name in inside else 2 if name in outside else None
        if kind is not None:
            edges += [(a, kind, 1), (b, kind, -1)]
    edges.sort(key=lambda e: e[0])
    depth, total, last = [0, 0, 0], 0.0, None
    for t, kind, step in edges:
        if last is not None and depth[0] and depth[1] and not depth[2]:
            total += t - last
        depth[kind] += step
        last = t
    return total
