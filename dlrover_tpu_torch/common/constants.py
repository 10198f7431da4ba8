"""Core enums and constants for the TPU-native elastic training stack.

Parity reference: dlrover/python/common/constants.py:15-250 (NodeType,
NodeStatus, NodeExitReason, DistributionStrategy, RendezvousName, NodeEnv).
Re-designed for a TPU fleet: node types are TPU-host-centric (no PS role in
the compute path; the "chief" concept collapses into rank-0 of the mesh),
and the env contract carries JAX coordinator info instead of TF_CONFIG.
"""


class PlatformType:
    LOCAL = "local"
    KUBERNETES = "kubernetes"
    TPU_VM = "tpu_vm"


class NodeType:
    """Roles inside an elastic TPU job.

    WORKER  -- one per TPU host (a TPU-VM worker process group).
    MASTER  -- the job master (control plane, no accelerator).
    COWORKER -- CPU-only data/preproc host feeding workers (atorch coworker
                analogue, atorch/data/shm_context.py).
    EVALUATOR -- side evaluation host.
    """

    MASTER = "master"
    WORKER = "worker"
    COWORKER = "coworker"
    EVALUATOR = "evaluator"


class NodeStatus:
    INITIAL = "initial"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    FINISHED = "finished"
    DELETED = "deleted"
    UNKNOWN = "unknown"
    BREAKDOWN = "breakdown"  # network-check decided the host is bad

    @classmethod
    def terminal(cls):
        return {cls.SUCCEEDED, cls.FAILED, cls.FINISHED, cls.DELETED}


class NodeEventType:
    ADDED = "added"
    MODIFIED = "modified"
    DELETED = "deleted"


class NodeExitReason:
    SUCCEEDED = "succeeded"
    KILLED = "killed"
    OOM = "oom"
    FATAL_ERROR = "fatal_error"
    HARDWARE_ERROR = "hardware_error"  # TPU chip / ICI failure
    PREEMPTED = "preempted"  # spot/maintenance preemption of a TPU VM
    UNKNOWN = "unknown"

    #: reasons where relaunching the same node cannot help
    UNRECOVERABLE = {FATAL_ERROR}


class JobExitReason:
    SUCCEEDED = "succeeded"
    CODE_ERROR = "code_error"
    OOM_ERROR = "oom_error"
    HARDWARE_ERROR = "hardware_error"
    UNKNOWN_ERROR = "unknown_error"
    PENDING_TIMEOUT = "pending_timeout"
    HANG_ERROR = "hang_error"


class DistributionStrategy:
    """How the job parallelises.

    ALLREDUCE -- SPMD data-parallel-rooted mesh job (the TPU flagship path).
    LOCAL     -- single process, no master RPC needed.
    CUSTOM    -- user drives process placement; master only does sharding.
    """

    ALLREDUCE = "allreduce"
    LOCAL = "local"
    CUSTOM = "custom"


class RendezvousName:
    TRAINING = "elastic-training"
    NETWORK_CHECK = "network-check"


class NetworkFailureReason:
    NO_INIT = "not_initialized"
    NODE_FAILURE = "node_failure"
    WAITING_NODE = "waiting_node"


class TrainingExceptionLevel:
    RDZV_ERROR = "rdzv_error"
    PROCESS_ERROR = "process_error"
    NODE_ERROR = "node_error"
    HANG = "hang"
    WARNING = "warning"
    INFO = "info"


class NodeAction:
    """Master -> agent directives carried on the heartbeat response
    (parity: the reference's DiagnosisAction piggybacked on heartbeats,
    dlrover/python/elastic_agent/master_client.py report_heart_beat)."""

    RESTART_WORKER = "restart"
    STOP = "stop"
    # graceful drain ahead of a platform reclaim (maintenance event):
    # the agent SIGTERMs the worker group so its DrainCoordinator runs
    # the notice-window sequence; the agent itself keeps running to
    # observe and classify the rc-21 death
    DRAIN = "drain"


class NodeEnv:
    """Env-var contract between scaler/operator and worker agents.

    Parity: dlrover/python/common/constants.py:190 (NodeEnv) — TF_CONFIG is
    replaced by the JAX coordinator contract.
    """

    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    NODE_TYPE = "DLROVER_TPU_NODE_TYPE"
    NODE_ID = "DLROVER_TPU_NODE_ID"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    # JAX distributed bootstrap (filled in by the agent after rendezvous)
    COORDINATOR_ADDR = "DLROVER_TPU_COORDINATOR_ADDR"
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"
    NUM_PROCESSES = "DLROVER_TPU_NUM_PROCESSES"
    # restart bookkeeping
    RESTART_COUNT = "DLROVER_TPU_RESTART_COUNT"
    # the rendezvous round the worker was launched under: globally
    # consistent across hosts of one world incarnation (unlike
    # RESTART_COUNT, which is per-agent) — used as the checkpoint
    # persist tier's save-attempt id
    RDZV_ROUND = "DLROVER_TPU_RDZV_ROUND"
    # data sharding
    AUTO_SHARDING = "DLROVER_TPU_AUTO_SHARDING"
    # host-local persistent XLA compilation cache directory shared by
    # every worker incarnation on this host (trainer/compile_cache.py);
    # "off" disables
    COMPILE_CACHE_DIR = "DLROVER_TPU_COMPILE_CACHE_DIR"
    # host-local persistent kernel tuning cache, co-located with the
    # compile cache (ops/tuning.py); "off" disables persistence
    TUNING_CACHE_DIR = "DLROVER_TPU_TUNING_CACHE_DIR"
    # seconds of reclaim notice a preempted node can count on; the
    # drain sequence (fault_tolerance/drain.py) budgets its emergency
    # checkpoint + shard relinquish inside this window
    PREEMPT_NOTICE_BUDGET = "DLROVER_TPU_PREEMPT_NOTICE_BUDGET"


class TaskType:
    """Data-shard task types (master/shard)."""

    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"
    WAIT = "wait"
    NONE = "none"


class RendezvousConstant:
    JOIN_TIMEOUT = 600.0
    POLL_INTERVAL = 1.0
    MAX_ROUND = 1_000_000


class GRPC:
    MAX_SEND_MESSAGE_LENGTH = 256 * 1024 * 1024
    MAX_RECEIVE_MESSAGE_LENGTH = 256 * 1024 * 1024


class DefaultPorts:
    MASTER = 0  # 0 = pick a free port
    COORDINATOR = 8476  # jax.distributed coordinator on rank-0 host


class JobOptStage:
    """Resource-optimization stages of a job lifecycle.

    Parity: dlrover/python/common/constants.py (JobOptStage).
    """

    CREATE = "job_stage_create"
    WORKER_INITIAL = "job_stage_worker_initial"
    RUNNING = "job_stage_running"


class OptimizeMode:
    MANUAL = "manual"
    SINGLE_JOB = "single-job"
    CLUSTER = "cluster"


class MemoryUnit:
    MB = 1024 * 1024
    GB = 1024 * 1024 * 1024


class TpuChip:
    """Peak bf16 matmul FLOP/s per chip for MFU accounting."""

    PEAK_FLOPS = {
        "TPU v4": 275e12,
        "TPU v5 lite": 197e12,
        "TPU v5e": 197e12,
        "TPU v5": 459e12,
        "TPU v5p": 459e12,
        "TPU v6 lite": 918e12,
        "TPU v6e": 918e12,
        "cpu": 1e12,  # nominal, for tests
    }

    @classmethod
    def peak_flops(cls, device_kind: str) -> float:
        for k, v in cls.PEAK_FLOPS.items():
            if device_kind.lower().startswith(k.lower()):
                return v
        return 1e12
