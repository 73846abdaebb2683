"""Deterministic fault injection (counterpart of elasticdl_tpu/chaos): the
seeded FaultSchedule, applied to the transport's calls and at the local
injection points, and the process helpers of chaos/process.py.

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
