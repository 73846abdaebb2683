"""Row initializers of PS-resident embedding tables (counterpart of
elasticdl_tpu/ps/initializers.py:23-112).

An initializer is named by a spec string carried in EmbeddingTableInfo:
either a bare name ("uniform", "normal", "truncated_normal", "zeros") or a
parameterized form ("uniform(-0.05,0.05)", "normal(0,0.01)",
"constant(0.3)"). Every spec resolves to a descriptor the host library's
bulk initializers take (native/idmap.cc), which fill each row from its own
seed, as the JAX package's native path does; the JAX package's per-row
numpy stream is its fallback without the library and has no counterpart
here.
"""

import re

_SPEC_RE = re.compile(r"^\s*([a-zA-Z_]+)\s*(?:\(([^)]*)\))?\s*$")

DEFAULT_UNIFORM_LOW, DEFAULT_UNIFORM_HIGH = -0.05, 0.05
DEFAULT_NORMAL_MEAN, DEFAULT_NORMAL_STD = 0.0, 0.05


def parse_initializer_spec(spec):
    """'name' or 'name(a,b,...)' -> (name, [float args])."""
    m = _SPEC_RE.match(spec or "uniform")
    if not m:
        raise ValueError(f"bad initializer spec {spec!r}")
    name = m.group(1).lower()
    args = []
    if m.group(2):
        args = [float(a) for a in m.group(2).split(",") if a.strip()]
    return name, args


def resolve_native_init(spec):
    """spec string -> the flat descriptor the bulk initializers take:

    ("uniform", low, high) | ("normal", mean, std, truncated) |
    ("constant", value) | ("zeros",)
    """
    name, args = parse_initializer_spec(spec)
    if name in ("zero", "zeros"):
        return ("zeros",)
    if name == "constant":
        return ("constant", args[0] if args else 0.0)
    if name in ("uniform", "random_uniform"):
        low = args[0] if args else DEFAULT_UNIFORM_LOW
        high = args[1] if len(args) > 1 else DEFAULT_UNIFORM_HIGH
        return ("uniform", low, high)
    if name in ("normal", "random_normal", "truncated_normal"):
        mean = args[0] if args else DEFAULT_NORMAL_MEAN
        std = args[1] if len(args) > 1 else DEFAULT_NORMAL_STD
        return ("normal", mean, std, name == "truncated_normal")
    raise ValueError(f"unknown initializer {name!r} (spec {spec!r})")
