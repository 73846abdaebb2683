"""Observability plane of the port (counterpart of elasticdl_tpu/observability).

Components use `default_registry()` (process-local metrics), `emit_event()`
(the structured event log, a no-op until a log is installed with
events.set_event_log) and `tracing.span()`. The JAX package's `setup()`,
which wires the exporter, the trace and event files and the flight recorder
for a process, comes with the process entry points.
"""

from elasticdl_tpu_torch.observability import events as _events
from elasticdl_tpu_torch.observability.metrics import default_registry  # noqa: F401

emit_event = _events.emit
