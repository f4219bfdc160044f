"""Round observability records (counterpart of the host round pipeline's
part of ``fedml_tpu/utils/metrics.py``)."""

from __future__ import annotations


def round_stats(rows, depth: int = 0) -> dict:
    """Per-round stage timings of the host round pipeline
    (``data/pipeline.CohortPrefetcher``) as one record.

    Each row is one executed round: ``materialize_ms`` (the cohort built and
    cast on the host), ``h2d_ms`` (host to device), ``compute_ms`` (the
    round's training call), ``wait_ms`` (how long the consumer blocked on
    the round's inputs: the exposed part of the host stages; the serial path
    records wait = materialize + h2d). ``overlap_frac`` is the share of the
    host stages hidden behind compute, ``1 - wait / (materialize + h2d)``:
    0 on the serial path."""
    rows = list(rows)
    keys = ("materialize_ms", "h2d_ms", "compute_ms", "wait_ms")
    if not rows:
        return {"rounds": 0, "pipeline_depth": int(depth), "overlap_frac": 0.0,
                **{k: 0.0 for k in keys}}
    tot = {k: float(sum(r.get(k, 0.0) for r in rows)) for k in keys}
    host = tot["materialize_ms"] + tot["h2d_ms"]
    overlap = max(0.0, 1.0 - tot["wait_ms"] / host) if host > 0 else 0.0
    out = {k: round(tot[k] / len(rows), 3) for k in keys}
    out["rounds"] = len(rows)
    out["pipeline_depth"] = int(depth)
    out["overlap_frac"] = round(overlap, 4)
    return out
