"""Deterministic fault injection (counterpart of elasticdl_tpu/chaos): the
seeded FaultSchedule and its local injection points. The gRPC interceptors
and the process helpers (chaos/process.py) come with the port's transport
and process entry points.

Processes pick schedules up from the ELASTICDL_CHAOS environment variable
(JSON, see injection.schedule_from_env).
"""

from elasticdl_tpu_torch.chaos.injection import (  # noqa: F401
    CHAOS_ENV,
    FaultRule,
    FaultSchedule,
    inject_local,
    schedule_from_env,
)
