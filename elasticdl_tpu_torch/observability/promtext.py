"""Prometheus text-exposition parser — the exact inverse of
`MetricsRegistry.expose()` (counterpart of
elasticdl_tpu/observability/promtext.py; each package parses the other's
exposition).

The aggregator (observability/aggregator.py) scrapes every per-role
`/metrics` endpoint of a job and needs the samples back as structured data;
this module parses the plain-text v0.0.4 format with stdlib only, the same
zero-dependency stance as the writer side (metrics.py).

Contract with the writer: `parse(registry.expose())` yields one
`MetricFamily` per registered metric, each carrying the samples the
registry holds, and `to_text(parse(text)) == text` for any text the
registry emits (families stay in input order, values re-format through the
writer's own number formatter). Histogram families own their `_bucket` /
`_sum` / `_count` sample lines.
"""

import collections
import re

from elasticdl_tpu_torch.observability.metrics import _format_value

# One exposition sample: the sample's full name (family name, or
# family name + _bucket/_sum/_count for histograms), its labels as an
# ordered (name, value) tuple, and the float value.
Sample = collections.namedtuple("Sample", ("name", "labels", "value"))

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_LABEL_RE = re.compile(
    r'\s*([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"\s*(,)?'
)

# Sample-name suffixes a histogram family owns.
_HISTOGRAM_SUFFIXES = ("_bucket", "_sum", "_count")


class MetricFamily:
    def __init__(self, name, type="untyped", help=""):
        self.name = name
        self.type = type
        self.help = help
        self.samples = []

    def __repr__(self):
        return (
            f"MetricFamily({self.name!r}, type={self.type!r}, "
            f"samples={len(self.samples)})"
        )


class ParseError(ValueError):
    pass


def _unescape_label_value(value):
    # Inverse of metrics._format_labels: \\ -> \, \" -> ", \n -> newline.
    out = []
    i = 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            else:
                out.append(ch)
                out.append(nxt)
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _parse_labels(text):
    """'k="v",k2="v2"' (brace contents) -> ordered ((k, v), ...)."""
    labels = []
    pos = 0
    while pos < len(text):
        m = _LABEL_RE.match(text, pos)
        if m is None:
            raise ParseError(f"bad label syntax at {text[pos:]!r}")
        labels.append((m.group(1), _unescape_label_value(m.group(2))))
        pos = m.end()
    return tuple(labels)


def _parse_sample(line):
    m = _NAME_RE.match(line)
    if m is None:
        raise ParseError(f"bad sample line {line!r}")
    name = m.group(0)
    rest = line[m.end():]
    labels = ()
    if rest.startswith("{"):
        close = _find_brace_close(rest)
        labels = _parse_labels(rest[1:close])
        rest = rest[close + 1:]
    value_text = rest.strip()
    if not value_text:
        raise ParseError(f"sample {name!r} has no value")
    try:
        value = float(value_text)
    except ValueError as e:
        raise ParseError(f"bad value {value_text!r} for {name!r}") from e
    return Sample(name, labels, value)


def _find_brace_close(text):
    """Index of the '}' closing text's leading '{', skipping quoted label
    values (a '}' inside a label value must not terminate the block)."""
    in_quotes = False
    i = 1
    while i < len(text):
        ch = text[i]
        if in_quotes:
            if ch == "\\":
                i += 2
                continue
            if ch == '"':
                in_quotes = False
        elif ch == '"':
            in_quotes = True
        elif ch == "}":
            return i
        i += 1
    raise ParseError(f"unterminated label block in {text!r}")


def _family_for(families, order, sample_name):
    """The family owning a sample line; histogram suffixes resolve to the
    base family. Samples without HELP/TYPE get an implicit untyped family
    (the format allows them; the registry never emits them)."""
    if sample_name in families:
        return families[sample_name]
    for suffix in _HISTOGRAM_SUFFIXES:
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            fam = families.get(base)
            if fam is not None and fam.type == "histogram":
                return fam
    fam = MetricFamily(sample_name)
    families[sample_name] = fam
    order.append(sample_name)
    return fam


def parse(text):
    """Exposition text -> ordered {family_name: MetricFamily}."""
    families = {}
    order = []
    for raw in text.splitlines():
        line = raw.rstrip("\r")
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                name = parts[2]
                if name not in families:
                    families[name] = MetricFamily(name)
                    order.append(name)
                if parts[1] == "HELP":
                    families[name].help = parts[3] if len(parts) > 3 else ""
                else:
                    families[name].type = (
                        parts[3].strip() if len(parts) > 3 else "untyped"
                    )
            continue  # other comments are legal and ignored
        sample = _parse_sample(line)
        _family_for(families, order, sample.name).samples.append(sample)
    return collections.OrderedDict(
        (name, families[name]) for name in order
    )


def samples(text):
    """Flat [(name, {label: value}, value)] view of `parse(text)`."""
    out = []
    for family in parse(text).values():
        for s in family.samples:
            out.append((s.name, dict(s.labels), s.value))
    return out


def _format_label_block(labels):
    if not labels:
        return ""
    parts = []
    for name, value in labels:
        escaped = (
            str(value)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
        )
        parts.append(f'{name}="{escaped}"')
    return "{" + ",".join(parts) + "}"


def to_text(families):
    """Families -> exposition text (`to_text(parse(t)) == t` for registry
    output — the round-trip property test's anchor)."""
    lines = []
    for family in families.values():
        lines.append(f"# HELP {family.name} {family.help}")
        lines.append(f"# TYPE {family.name} {family.type}")
        for s in family.samples:
            labels = _format_label_block(s.labels)
            lines.append(f"{s.name}{labels} {_format_value(s.value)}")
    return "\n".join(lines) + "\n"


def sample_value(families, name, labels=None):
    """The value of one sample (labels as a dict subset match), or None."""
    want = dict(labels or {})
    for family in families.values():
        for s in family.samples:
            if s.name != name:
                continue
            have = dict(s.labels)
            if all(have.get(k) == v for k, v in want.items()):
                return s.value
    return None
