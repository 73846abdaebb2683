"""Delta encoding of metric snapshots (counterpart of the delta half of
elasticdl_tpu/observability/push.py).

The JAX package's workers and PS push their registries to the master's
ReportTelemetry RPC instead of being scraped: each reporter ships only the
samples whose values changed since its last snapshot (`snapshot_delta`),
and the master merges them back into per-origin state (`apply_delta`).
The reporter, its knobs and the master's ingestion come with the port's
transport, which carries the RPC; in one process the master's aggregator
reads the registry directly.

Deltas never need tombstones: a MetricsRegistry only ever grows samples
(counters/gauges persist once created), so "changed or new" covers the
whole state evolution.
"""

import collections

from elasticdl_tpu_torch.observability import promtext


def snapshot_delta(prev_families, cur_families):
    """Families holding only the samples that changed (or are new) in
    `cur_families` relative to `prev_families`; families with no changed
    samples are omitted entirely. Both sides are promtext-style ordered
    {name: MetricFamily} dicts; the inputs are not mutated."""
    prev_values = {}
    for family in prev_families.values():
        for s in family.samples:
            prev_values[(s.name, s.labels)] = s.value
    delta = collections.OrderedDict()
    for name, family in cur_families.items():
        changed = [
            s for s in family.samples
            if prev_values.get((s.name, s.labels)) != s.value
        ]
        if changed:
            out = promtext.MetricFamily(family.name, family.type, family.help)
            out.samples = changed
            delta[name] = out
    return delta


def apply_delta(state_families, delta_families):
    """Merge a delta into `state_families` in place (and return it).
    Changed samples replace their (name, labels) slot; new samples and
    families append, preserving the order both sides emitted them in."""
    for name, family in delta_families.items():
        cur = state_families.get(name)
        if cur is None:
            cur = promtext.MetricFamily(family.name, family.type, family.help)
            state_families[name] = cur
        index = {
            (s.name, s.labels): i for i, s in enumerate(cur.samples)
        }
        for s in family.samples:
            i = index.get((s.name, s.labels))
            if i is None:
                cur.samples.append(s)
            else:
                cur.samples[i] = s
    return state_families
