"""The program's own spans and counters (``manifold_gp_torch.utils.metrics``),
as the per-layer readers take them: the traced registry, which holds what
the traced window recorded (the run profiles only its window), and the
always-on totals of the set-up spans. A program without them (an older
tree) gives None, and the readers then leave their metric out."""

from __future__ import annotations


def _metrics():
    try:
        from manifold_gp_torch.utils import metrics
    except ImportError:
        return None
    if not all(hasattr(metrics, name) for name in ("traced", "totals", "counter_sum")):
        return None
    return metrics


def counter(prefix: str) -> int:
    """The traced counters under ``prefix`` summed (``prefix`` and
    ``prefix.*``), or None where none was recorded."""
    metrics = _metrics()
    if metrics is None:
        return None
    counters = metrics.traced()["counters"]
    if not any(k == prefix or k.startswith(prefix + ".") for k in counters):
        return None
    return metrics.counter_sum(counters, prefix)


def span_seconds(name: str, totals: bool = False) -> float:
    """Host seconds of the span ``name``, traced or (``totals``) over the
    whole run, or None where it was not recorded."""
    metrics = _metrics()
    if metrics is None:
        return None
    row = (metrics.totals() if totals else metrics.traced()["spans"]).get(name)
    return None if row is None else row["seconds"]
