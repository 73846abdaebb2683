"""Framework-wide constants (counterpart of
elasticdl_tpu/common/constants.py)."""


class DistributionStrategy:
    LOCAL = "Local"
    PARAMETER_SERVER = "ParameterServerStrategy"
    ALLREDUCE = "AllreduceStrategy"


class JobType:
    TRAINING_ONLY = "training_only"
    EVALUATION_ONLY = "evaluation_only"
    PREDICTION_ONLY = "prediction_only"
    TRAINING_WITH_EVALUATION = "training_with_evaluation"


class PodStatus:
    INITIAL = "Initial"
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    DELETED = "Deleted"


# Per-minibatch retry cap (reference worker/worker.py:37).
DEFAULT_MAX_MINIBATCH_RETRY_NUM = 64

# Per-task retry cap in the dispatcher (reference master/task_dispatcher.py).
MAX_TASK_RETRIES = 3

# Membership re-check cadence in AllReduce training, in steps
# (reference worker/allreduce_trainer.py:141-148).
COMM_WORLD_CHECK_STEPS = 20

# Allreduce communication retry cap (reference allreduce_trainer.py:125-139).
MAX_ALLREDUCE_RETRY_NUM = 5

# Width of the jax.distributed coordination-port rotation window: across
# membership epochs rank 0 binds coordinator_port + (epoch % width), so the
# job reserves the block [coordinator_port, coordinator_port + width - 1]
# (master/membership.py:get_comm_rank; validate_args keeps master_port out).
COORDINATOR_PORT_ROTATION = 16
