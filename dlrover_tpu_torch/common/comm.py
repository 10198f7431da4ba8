"""Wire messages between agents and the job master.

The reference defines these in protobuf (dlrover/proto/elastic_training.proto:
243-299) and generates gRPC stubs. We keep gRPC as the transport (it is
device-agnostic control plane) but carry typed dataclasses over a single
generic "Request/Response" envelope — no protoc step, same RPC surface.
Every master RPC from the reference servicer
(dlrover/python/master/servicer.py:62) has a message here.

Codec: a schema'd JSON encoding, NOT pickle. Anything that can reach the
master port is untrusted, and ``pickle.loads`` of network bytes executes
arbitrary code; JSON can only produce primitives, and message
construction goes through an explicit class registry — an unknown or
malformed message raises :class:`WireError` instead of instantiating
anything. Like protobuf, unknown *fields* on a known message are
ignored (rolling-upgrade tolerance: an old master can parse a newer
agent's message), while unknown message *types* are rejected.

Wire forms (all JSON):
  message   -> {"__msg__": "ClassName", "f": {field: value, ...}}
  bytes     -> {"__b64__": "<base64>"}
  dict      -> {"__map__": [[key, value], ...]}   (preserves int keys)
  list/tuple-> [ ... ]        primitives -> as-is

Container contract: the only sequence type on the wire is ``list`` —
tuples are ACCEPTED on encode but always DECODE as lists (JSON has one
array type). A message field typed ``Tuple[...]``, or any code that
``is``-compares / unpacks a tuple-valued metric, would silently change
type after one RPC hop; declare sequence fields as ``List`` and compare
by value.
"""

import base64
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class WireError(ValueError):
    """A network payload failed schema validation; never executed."""


try:
    from numpy import generic as _np_generic
except ImportError:  # pragma: no cover - numpy is a hard dep in practice
    class _np_generic:  # type: ignore
        pass


#: message-type registry: populated by ``BaseMessage.__init_subclass__``
#: — only classes defined in this module (imported before any decode)
#: can ever be constructed from network bytes
_REGISTRY: Dict[str, type] = {}

#: per-class field defaults, for the sparse encoding (built lazily;
#: default_factory values are materialized once and never mutated)
_DEFAULTS: Dict[type, Dict[str, object]] = {}


def _class_defaults(cls) -> Dict[str, object]:
    cached = _DEFAULTS.get(cls)
    if cached is None:
        cached = {}
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                cached[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                cached[f.name] = f.default_factory()
        _DEFAULTS[cls] = cached
    return cached


def _is_default(value, default) -> bool:
    # strict type match: True == 1 and 0 == 0.0 in Python, but dropping
    # the field would RE-TYPE it on decode (default comes back instead)
    return type(value) is type(default) and value == default


def _encode(obj):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, _np_generic):
        # numpy scalars (np.float32 loss values etc.) flow in through
        # free-form metric dicts; coerce to the Python scalar
        return obj.item()
    if isinstance(obj, bytes):
        return {"__b64__": base64.b64encode(obj).decode("ascii")}
    if isinstance(obj, BaseMessage):
        # sparse encoding: omit fields still at their dataclass default
        # — the decoder reconstructs them, so round-trips are identity
        # and old peers (which also default missing fields) read the
        # message unchanged. At fleet fan-in this is most of the bytes:
        # a delta NodeStatusReport is ~20 declared fields, ~5 live ones.
        defaults = _class_defaults(type(obj))
        fields_out = {}
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            if f.name in defaults and _is_default(value, defaults[f.name]):
                continue
            fields_out[f.name] = _encode(value)
        return {"__msg__": type(obj).__name__, "f": fields_out}
    if isinstance(obj, dict):
        for k in obj:
            # map keys must survive a JSON round trip AND be hashable
            # on decode — primitives only, enforced symmetrically here
            # and in _decode so a payload we emit is always readable
            # (numpy scalar keys coerce like values do)
            if k is not None and not isinstance(
                k, (bool, int, float, str, _np_generic)
            ):
                raise WireError(
                    f"map key of type {type(k).__name__} not wire-safe"
                )
        return {
            "__map__": [[_encode(k), _encode(v)] for k, v in obj.items()]
        }
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    raise WireError(f"unencodable wire value of type {type(obj).__name__}")


def _decode(obj):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    if isinstance(obj, dict):
        if "__b64__" in obj:
            try:
                return base64.b64decode(obj["__b64__"])
            except Exception as e:
                raise WireError(f"bad base64 payload: {e}")
        if "__map__" in obj:
            pairs = obj["__map__"]
            if not isinstance(pairs, list):
                raise WireError("__map__ payload is not a pair list")
            out = {}
            for pair in pairs:
                if not isinstance(pair, list) or len(pair) != 2:
                    raise WireError("__map__ entry is not a [k, v] pair")
                key = _decode(pair[0])
                if key is not None and not isinstance(
                    key, (bool, int, float, str)
                ):
                    raise WireError(
                        f"map key of type {type(key).__name__} "
                        "not wire-safe"
                    )
                out[key] = _decode(pair[1])
            return out
        if "__msg__" in obj:
            name = obj["__msg__"]
            cls = _REGISTRY.get(name)
            if cls is None:
                raise WireError(f"unknown message type {name!r}")
            fields_in = obj.get("f", {})
            if not isinstance(fields_in, dict):
                raise WireError(f"malformed fields for {name!r}")
            known = {f.name for f in dataclasses.fields(cls)}
            kwargs = {
                k: _decode(v) for k, v in fields_in.items() if k in known
            }
            try:
                return cls(**kwargs)
            except TypeError as e:
                raise WireError(f"cannot construct {name!r}: {e}")
        raise WireError(
            f"unrecognized wire object (keys: {sorted(obj)[:4]})"
        )
    raise WireError(f"undecodable wire value of type {type(obj).__name__}")


def serialize(msg) -> bytes:
    return json.dumps(_encode(msg), separators=(",", ":")).encode("utf-8")


def deserialize(data: bytes):
    if not data:
        return None
    try:
        doc = json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"payload is not valid JSON: {e}")
    return _decode(doc)


class BaseMessage:
    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        _REGISTRY[cls.__name__] = cls

    def serialize(self) -> bytes:
        return serialize(self)


@dataclass
class BaseRequest(BaseMessage):
    node_id: int = -1
    node_type: str = ""


@dataclass
class Response(BaseMessage):
    success: bool = True
    reason: str = ""


# ---------------------------------------------------------------- data shards


@dataclass
class Shard(BaseMessage):
    name: str = ""
    start: int = 0
    end: int = 0
    record_indices: Optional[List[int]] = None


@dataclass
class Task(BaseMessage):
    task_id: int = -1
    task_type: str = ""
    shard: Shard = field(default_factory=Shard)

    @property
    def exists(self) -> bool:
        return self.task_id >= 0


@dataclass
class TaskRequest(BaseRequest):
    dataset_name: str = ""
    #: the worker PROCESS incarnation (agent restart count): a fetch
    #: from a newer incarnation proves the older one is dead, so its
    #: in-flight shards are reclaimed immediately instead of waiting
    #: out the task timeout; -1 = unknown (no reclaim)
    incarnation: int = -1


@dataclass
class TaskBatchRequest(BaseRequest):
    dataset_name: str = ""
    incarnation: int = -1
    #: upper bound on shards per round-trip; the master may return fewer
    #: (queue short) or a single WAIT/invalid task when nothing is ready
    max_tasks: int = 1


@dataclass
class TaskBatch(BaseMessage):
    tasks: List[Task] = field(default_factory=list)


@dataclass
class TaskResult(BaseRequest):
    dataset_name: str = ""
    task_id: int = -1
    err_message: str = ""


@dataclass
class DatasetShardParams(BaseRequest):
    batch_size: int = 0
    num_epochs: int = 1
    dataset_size: int = 0
    shuffle: bool = False
    num_minibatches_per_shard: int = 2
    dataset_name: str = ""
    task_type: str = ""
    storage_type: str = "table"


@dataclass
class ShardCheckpointRequest(BaseRequest):
    dataset_name: str = ""


@dataclass
class ShardCheckpoint(BaseMessage):
    content: str = ""  # JSON


@dataclass
class DatasetEpochRequest(BaseRequest):
    dataset_name: str = ""


@dataclass
class DatasetEpoch(BaseMessage):
    epoch: int = 0


# ---------------------------------------------------------------- rendezvous


@dataclass
class RendezvousParams(BaseRequest):
    min_nodes: int = 1
    max_nodes: int = 1
    waiting_timeout: float = 30.0
    node_unit: int = 1
    joint_timeout: float = 600.0


@dataclass
class JoinRendezvousRequest(BaseRequest):
    local_world_size: int = 1
    rdzv_name: str = ""


@dataclass
class RendezvousRound(BaseMessage):
    round: int = 0


@dataclass
class CommWorldRequest(BaseRequest):
    rdzv_name: str = ""


@dataclass
class CommWorld(BaseMessage):
    rdzv_round: int = 0
    group: int = 0
    world: Dict[int, int] = field(default_factory=dict)  # node_rank -> slots


@dataclass
class WaitingNodeNumRequest(BaseRequest):
    rdzv_name: str = ""


@dataclass
class WaitingNodeNum(BaseMessage):
    waiting_num: int = 0


@dataclass
class NetworkReadyRequest(BaseRequest):
    pass


@dataclass
class NetworkCheckResult(BaseMessage):
    success: bool = False
    reason: str = ""


@dataclass
class NodeCheckStatus(BaseRequest):
    rdzv_round: int = 0
    normal: bool = True
    elapsed_time: float = 0.0


# ---------------------------------------------------------------- kv store


@dataclass
class KVStoreSetRequest(BaseMessage):
    key: str = ""
    value: bytes = b""


@dataclass
class KVStoreGetRequest(BaseMessage):
    key: str = ""


@dataclass
class KVStoreAddRequest(BaseMessage):
    key: str = ""
    amount: int = 0


@dataclass
class KVStoreKeysRequest(BaseMessage):
    prefix: str = ""


@dataclass
class KVStoreValue(BaseMessage):
    value: bytes = b""


@dataclass
class KVStoreKeys(BaseMessage):
    keys: List[str] = field(default_factory=list)


@dataclass
class KVStoreAddResult(BaseMessage):
    value: int = 0


# ---------------------------------------------------------------- node status


@dataclass
class NodeStatusRequest(BaseRequest):
    status: str = ""
    exit_reason: str = ""
    restart_count: int = 0


@dataclass
class NodeFailure(BaseRequest):
    error_data: str = ""
    level: str = ""
    restart_count: int = 0


@dataclass
class NodeAddressRequest(BaseRequest):
    address: str = ""


@dataclass
class PreemptionNotice(BaseRequest):
    """Drain step 1 (fault_tolerance/drain.py): the node received a
    reclaim notice and will die within ``notice_budget_s`` — the master
    marks it PREEMPTED, evicts it from rendezvous immediately, and
    relaunches without charging the relaunch budget."""

    reason: str = ""  # "sigterm" | "maintenance" | ...
    notice_budget_s: float = 0.0
    deadline_ts: float = 0.0
    restart_count: int = 0


@dataclass
class RelinquishShardsRequest(BaseRequest):
    """Drain step 3: hand every in-flight shard of this node back to
    the todo queue NOW instead of waiting out the task-timeout
    watchdog. Empty ``dataset_name`` = all datasets."""

    dataset_name: str = ""


@dataclass
class RelinquishShardsResponse(BaseMessage):
    requeued: int = 0


@dataclass
class AnomalyReport(BaseRequest):
    """Sentinel trip (fault_tolerance/sentinel.py): this rank saw a
    non-finite or spiking training signal. ``last_good_step`` is the
    newest checkpoint the reporter's sentinel window was clean for
    (-1 = none) — the master's rollback order targets it."""

    kind: str = ""  # "nonfinite_loss" | "nonfinite_grad" | "loss_spike"
    step: int = 0
    value: float = 0.0
    zscore: float = 0.0
    host: str = ""
    last_good_step: int = -1
    restart_count: int = 0


@dataclass
class AnomalyResponse(BaseMessage):
    """Master verdict on an anomaly report: coordinate a rollback,
    carry on (duplicate report for an in-flight rollback), or fail the
    job (rollback budget exhausted)."""

    action: str = "none"  # "rollback" | "none" | "job_failed"
    rollback_id: int = 0
    rollback_step: int = -1
    quarantined: bool = False


@dataclass
class ReshardReport(BaseRequest):
    """Worker progress on a mesh-transition order (reshard/): the
    survivor reached ``phase`` ("adopted" | "migrated" | "completed" |
    "aborted") of the order it adopted from the KV broadcast."""

    order_id: int = 0
    phase: str = ""
    detail: str = ""


@dataclass
class ReshardResponse(BaseMessage):
    """Coordinator verdict on a reshard progress report: carry on
    (``ok``), drop the order (``stale`` — it is no longer the active
    transition), or fall back to restart-the-world (``abort``)."""

    action: str = "ok"  # "ok" | "stale" | "abort" | "none"


@dataclass
class HeartBeat(BaseRequest):
    timestamp: float = 0.0


@dataclass
class HeartbeatResponse(BaseMessage):
    action: str = ""  # "", "restart", "stop"


@dataclass
class ResourceStats(BaseRequest):
    cpu_percent: float = 0.0
    memory_mb: int = 0
    tpu_stats: List[Dict] = field(default_factory=list)


# ---------------------------------------------------------------- metrics


@dataclass
class GlobalStep(BaseRequest):
    timestamp: float = 0.0
    step: int = 0
    # goodput ledger piggyback (telemetry/goodput.py): cumulative
    # per-phase seconds for this process incarnation. Empty when the
    # reporting process has no ledger armed — an old agent's message
    # parses unchanged, and an old master ignores the fields.
    goodput_phases: Dict = field(default_factory=dict)
    goodput_elapsed_s: float = 0.0
    goodput_start_ts: float = 0.0
    goodput_phase: str = ""
    # incarnations are keyed (node_id, pid): a relaunched worker is a
    # new ledger, and the gap between the two is restart badput
    pid: int = 0


@dataclass
class GoodputReport(BaseRequest):
    """A full ledger snapshot outside the step cadence (process exit
    sends ``final=True`` so the master closes the incarnation)."""

    pid: int = 0
    host: str = ""
    goodput_phases: Dict = field(default_factory=dict)
    goodput_elapsed_s: float = 0.0
    goodput_start_ts: float = 0.0
    goodput_phase: str = ""
    final: bool = False


@dataclass
class NodeStatusReport(BaseRequest):
    """Coalesced per-interval agent report: heartbeat + (optionally)
    global step, goodput snapshot, and resource stats in ONE rpc, with
    delta semantics — ``has_*`` gates mark which sections are present,
    and the agent only includes a section when it changed since the
    last *acked* report. ``full=True`` resends everything (first report
    of an incarnation, reconnect, or master-requested resync). Old
    masters reject the unknown method at the app layer; the agent then
    falls back to the per-rpc paths, so mixed fleets keep working."""

    timestamp: float = 0.0  # heartbeat: always present
    #: agent restart count; a new incarnation implies a full report
    incarnation: int = -1
    #: per-incarnation monotonic report number; lets the master detect
    #: gaps (missed interval => ask for a resync of delta'd sections)
    seq: int = 0
    full: bool = False
    has_step: bool = False
    step: int = 0
    step_ts: float = 0.0
    pid: int = 0
    has_goodput: bool = False
    goodput_phases: Dict = field(default_factory=dict)
    goodput_elapsed_s: float = 0.0
    goodput_start_ts: float = 0.0
    goodput_phase: str = ""
    host: str = ""
    final: bool = False
    has_resource: bool = False
    cpu_percent: float = 0.0
    memory_mb: int = 0
    #: fleet metric digest: counter deltas + mergeable
    #: histogram sketches since the last ACKED report
    #: (telemetry/fleet.py wire format). Sparse: omitted entirely when
    #: the process produced no samples this interval.
    has_metrics: bool = False
    metrics: Dict = field(default_factory=dict)
    #: serving-replica stats section: ServingWorker counters
    #: ride the same delta lane as goodput/resource, so 1k-replica
    #: pools stop unary-polling serve_stats at the master
    has_serve: bool = False
    serve_served: int = 0
    serve_rejected: int = 0
    serve_model_ms: float = 0.0
    serve_batch_fill: float = 0.0
    #: job namespace: which job this reporter belongs to.
    #: Sparse encoding omits the default, so single-job wires (and old
    #: peers) are byte-identical to the pre-job format.
    job_id: str = "default"


@dataclass
class NodeStatusAck(BaseMessage):
    """Reply to NodeStatusReport. ``accepted=False`` is load-shed: the
    master did NOT apply the report; retry the same payload after
    ``retry_after_s`` (jittered). ``resync=True`` asks the agent to
    send ``full=True`` next interval (master restarted / lost its
    per-reporter delta baseline)."""

    accepted: bool = True
    retry_after_s: float = 0.0
    action: str = ""  # pending NodeAction piggyback, same as heartbeat
    resync: bool = False
    acked_seq: int = -1


@dataclass
class RelayBatchReport(BaseRequest):
    """An aggregator relay's coalesced upstream interval:
    one RPC carrying its agents' re-delta'd NodeStatusReports. The
    relay's own identity rides the BaseRequest node fields; each
    sub-report keeps its ORIGINAL reporter identity, so the master's
    per-agent ledger (the exactly-once proof) is tier-agnostic."""

    reports: List[NodeStatusReport] = field(default_factory=list)
    #: relay restart count — diagnostics only; per-agent delta state
    #: rides each sub-report's own (incarnation, seq)
    relay_incarnation: int = -1
    #: pre-merged metric digest across this relay's agents for the
    #: interval: the master folds ONE mergeable summary per
    #: relay instead of K per-agent digests. Sub-reports carry no
    #: per-agent digest when this is set. Legacy single-job field — a
    #: relay that only saw default-job agents still uses it; the master
    #: attributes it to job "default".
    digest: Dict = field(default_factory=dict)
    #: per-job pre-merged digests: job_id -> digest. Set
    #: instead of ``digest`` when the relay saw a non-default job this
    #: interval; sparse encoding keeps single-job wires unchanged.
    digests: Dict = field(default_factory=dict)


@dataclass
class RelayBatchAck(BaseMessage):
    """Reply to RelayBatchReport. ``accepted=False`` is a batch-level
    shed (no sub-report applied — retry the SAME batch after
    ``retry_after_s``); otherwise ``acks`` aligns with
    ``reports`` by index and each entry carries that agent's
    resync/action/acked_seq exactly as a direct report would."""

    accepted: bool = True
    retry_after_s: float = 0.0
    acks: List[NodeStatusAck] = field(default_factory=list)


@dataclass
class ModelInfo(BaseRequest):
    param_count: int = 0
    flops_per_step: float = 0.0
    batch_size: int = 0
    seq_len: int = 0
    extra: Dict = field(default_factory=dict)


@dataclass
class CustomData(BaseRequest):
    """Free-form metrics into the stats pipeline (evaluator results,
    user counters) — parity: report_customized_data."""

    data: Dict = field(default_factory=dict)


# ---------------------------------------------------------------- sync


@dataclass
class SyncJoin(BaseRequest):
    sync_name: str = ""


@dataclass
class SyncFinish(BaseRequest):
    sync_name: str = ""


@dataclass
class SyncBarrier(BaseRequest):
    barrier_name: str = ""
    notify: bool = False


# ---------------------------------------------------------------- cluster


@dataclass
class ClusterVersionRequest(BaseRequest):
    version_type: str = ""  # "local" | "global" | "restored"


@dataclass
class ClusterVersion(BaseMessage):
    version: int = 0


@dataclass
class RunningNodesRequest(BaseRequest):
    pass


@dataclass
class RunningNodes(BaseMessage):
    nodes: List[Dict] = field(default_factory=list)


@dataclass
class ScaleRequest(BaseRequest):
    """Manual scale trigger (parity: ScalePlan CRD manualScaling)."""

    node_num: int = 0


@dataclass
class ElasticRunConfigRequest(BaseRequest):
    pass


@dataclass
class ElasticRunConfig(BaseMessage):
    configs: Dict[str, str] = field(default_factory=dict)


# ---------------------------------------------------------------- serving
# The inference request plane (serving/router.py): requests are leased
# to serving workers exactly like data shards, with redelivery on
# worker death and exactly-once responses keyed by request id.


@dataclass
class ServeSubmit(BaseRequest):
    """Admit one inference request. Empty ``req_id`` lets the router
    assign one; a client-chosen id makes retries idempotent.
    ``tenant`` buys deficit-round-robin fairness against the other
    tenants of its ``priority`` class; the defaults keep
    the old global-FIFO wire byte-identical (sparse encoding)."""

    req_id: str = ""
    payload: bytes = b""
    tenant: str = ""
    priority: int = 0


@dataclass
class ServeSubmitResult(BaseMessage):
    accepted: bool = True
    req_id: str = ""
    reason: str = ""  # "backpressure" | "sealed" | "duplicate"


@dataclass
class ServePoll(BaseRequest):
    req_id: str = ""


@dataclass
class ServeResponse(BaseMessage):
    done: bool = False
    req_id: str = ""
    payload: bytes = b""
    worker_id: int = -1
    latency_s: float = 0.0


@dataclass
class ServeLeaseRequest(BaseRequest):
    """Pull up to ``max_requests`` queued requests. ``incarnation``
    carries the worker's restart count: a lease from a newer
    incarnation reclaims the dead predecessor's in-flight requests
    immediately (same contract as TaskBatchRequest)."""

    max_requests: int = 1
    incarnation: int = -1


@dataclass
class ServeWireRequest(BaseMessage):
    req_id: str = ""
    payload: bytes = b""


@dataclass
class ServeLease(BaseMessage):
    """A micro-batch of leased requests. ``sealed=True`` with an empty
    batch is the worker's end-of-stream signal."""

    requests: List[ServeWireRequest] = field(default_factory=list)
    sealed: bool = False


@dataclass
class ServeComplete(BaseRequest):
    req_id: str = ""
    payload: bytes = b""


@dataclass
class ServeRelinquishRequest(BaseRequest):
    """Replica rotation: return this worker's unprocessed leases to
    the queue NOW instead of waiting out the lease-timeout watchdog
    (the serving analog of RelinquishShardsRequest)."""


@dataclass
class ServeRelinquishResponse(BaseMessage):
    requeued: int = 0


@dataclass
class ServeSealRequest(BaseRequest):
    pass


@dataclass
class ServeStatsRequest(BaseRequest):
    pass


@dataclass
class ServeStats(BaseMessage):
    queue_depth: int = 0
    in_flight: int = 0
    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    duplicates: int = 0
    redelivered: int = 0
    workers: int = 0
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    #: attributed split of the same latency window: time in
    #: queue awaiting the winning lease vs time on the worker — the
    #: autoscaler/SLO evaluator's "would one more replica help?" signal
    queue_wait_p99_ms: float = 0.0
    model_time_p99_ms: float = 0.0
    sealed: bool = False
    drained: bool = False
    # the sharded router plane
    shards: int = 1
    tenants: int = 0
    #: delivered done-store entries GC'd after DLROVER_TPU_SERVE_DONE_TTL
    done_evicted: int = 0
    #: replica-reported serve sections alive on the delta-report plane
    replicas_reporting: int = 0
    replica_served: int = 0
    #: per-shard {queue_depth, in_flight, completed}, keyed by shard index
    per_shard: Dict = field(default_factory=dict)
