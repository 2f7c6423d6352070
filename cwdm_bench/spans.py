"""The program's own spans (``fast_cwdm_tpu_torch.utils.profiling``), for
the readers of the traced block.

The traced block (``devtrace.traced``) runs ``trace_items`` items traced on
the device alone, then as many with the host traced too; the program's
spans are on in both. An item is a root span of each of the given names (a
synthesis request: ``cwdm.condition`` and ``cwdm.synthesize``; a training
step: ``cwdm.train.step``), the i-th root of each name together. The readers
take the last 2 × ``trace_items`` roots of each name and use the first half:
the device-only block, whose host is not slowed by host tracing. They give
the median over its items, so that one slow item (a pageable copy that
stalls) does not set the value. A program that keeps no spans, or a run
that recorded fewer roots, gives nothing to read.
"""

from __future__ import annotations

import statistics


def device_items(rec: dict, roots: tuple[str, ...]) -> list[list[dict]] | None:
    """The spans of each of the device-only block's items, or None."""
    from fast_cwdm_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    n = rec.get("trace_items")
    if read is None or not n:
        return None
    spans = read()
    item_of = {}
    for name in roots:
        ids = [s["id"] for s in spans if s["parent"] is None and s["name"] == name]
        if len(ids) < 2 * n:
            return None
        item_of.update({rid: i for i, rid in enumerate(ids[-2 * n:-n])})
    items = [[] for _ in range(n)]
    for s in spans:
        if s["root"] in item_of:
            items[item_of[s["root"]]].append(s)
    return items


def median_item(rec: dict, roots: tuple[str, ...], value) -> float | None:
    """The median over the device-only block's items of ``value(spans of an
    item)``; None where there is no block or ``value`` gives None for an
    item."""
    values = [value(item) for item in device_items(rec, roots) or ()]
    if not values or any(v is None for v in values):
        return None
    return statistics.median(values)


def per_item(rec: dict, roots: tuple[str, ...], names: tuple[str, ...],
             key: str) -> float | None:
    """The median over the device-only block's items of Σ ``key``
    (``host_ms`` or ``device_ms``) of the spans named ``names``; None where
    an item has none, or one has no such time (no device events: the
    CPU)."""
    def total(item):
        values = [s[key] for s in item if s["name"] in names]
        return None if not values or None in values else sum(values)

    return median_item(rec, roots, total)
