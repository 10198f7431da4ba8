"""Declarative job spec -> JobArgs (the CRD-ingestion equivalent).

Parity reference: dlrover/python/scheduler/job.py:79 (JobArgs) and
kubernetes.py:314 (K8sJobArgs.initilize parsing the ElasticJob CR's
replicaSpecs/resources). The TPU shape replaces pod templates with TPU-VM
fleet parameters (accelerator type, runtime version, preemptible) and
keeps the elastic knobs (min/max replicas, node_unit slice granularity,
relaunch policy).

Spec example (YAML or JSON)::

    apiVersion: dlrover-tpu/v1
    kind: ElasticTpuJob
    metadata:
      name: llama-pretrain
    spec:
      distributionStrategy: allreduce
      nodeUnit: 4                 # hosts per ICI slice
      relaunchStrategy: always
      heartbeatTimeout: 30
      worker:
        replicas: 16
        minReplicas: 8
        acceleratorType: v5litepod-16
        runtimeVersion: tpu-ubuntu2204-base
        preemptible: true
        maxRelaunchCount: 3
        resource: {cpu: 96, memory: 180Gi}
        env: {WANDB_MODE: offline}

A copy of ``dlrover_tpu/scheduler/job_spec.py``. As in JAX, a spec file
is read as JSON first and as YAML only when it is not JSON, which needs
the ``yaml`` module: where it is missing, a YAML spec raises its
``ImportError`` and a JSON spec reads as ever. The Brain's fields
(``brainAddr``, ``brainStorePath``) are parsed, and the distributed
master refuses them (ROADMAP.md, queue A.2.4).
"""

import dataclasses
import json
import re
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource

_MEM_UNITS = {
    "": 1 / (1024 * 1024), "k": 1 / 1024, "ki": 1 / 1024,
    "m": 1, "mi": 1, "g": 1024, "gi": 1024, "t": 1024 * 1024,
    "ti": 1024 * 1024,
}


def parse_memory_mb(value) -> int:
    """'180Gi' / '512Mi' / 1073741824 (bytes) -> MB."""
    if isinstance(value, (int, float)):
        return int(value / (1024 * 1024))
    m = re.fullmatch(r"\s*([0-9.]+)\s*([A-Za-z]*)\s*", str(value))
    if not m:
        raise ValueError(f"unparseable memory quantity: {value!r}")
    num, unit = float(m.group(1)), m.group(2).lower().rstrip("b")
    if unit not in _MEM_UNITS:
        raise ValueError(f"unknown memory unit in {value!r}")
    return int(num * _MEM_UNITS[unit])


def parse_critical_worker_index(value, max_relaunch: int,
                                replicas: int) -> Dict[int, int]:
    """parity: get_critical_worker_index (dlrover common/global_context
    usage). ``"default"`` -> {0: max_relaunch}; ``"all"`` -> every rank;
    ``"none"``/'' -> {}; else "rank:budget,rank:budget"."""
    # YAML users naturally write true/false; honor both spellings
    if value in ("", "none", None, False):
        return {}
    if value in ("default", True):
        return {0: max_relaunch}
    if value == "all":
        return {i: max_relaunch for i in range(replicas)}
    out: Dict[int, int] = {}
    for part in str(value).split(","):
        rank, _, budget = part.strip().partition(":")
        out[int(rank)] = int(budget) if budget else max_relaunch
    return out


@dataclasses.dataclass
class JobArgs:
    """Everything the master needs to run one elastic TPU job."""

    job_name: str = "job"
    platform: str = "local"
    namespace: str = "default"  # GCP: project/zone live here too
    project: str = ""
    zone: str = ""
    distribution_strategy: str = "allreduce"
    node_num: int = 1
    min_node_num: int = 1
    #: elasticity ceiling (maxReplicas): throughput-driven autoscaling
    #: may grow the fleet past the initial ``replicas`` up to this
    #: (parity role: the DeepRec scale-up story — the reference's
    #: AllreduceTrainingAutoScaler adds workers off observed speed)
    max_node_num: int = 0
    node_unit: int = 1
    relaunch_always: bool = False
    heartbeat_timeout: Optional[float] = None
    # worker fleet parameters
    node_resource: NodeResource = dataclasses.field(
        default_factory=NodeResource
    )
    accelerator_type: str = ""
    runtime_version: str = ""
    preemptible: bool = False
    max_relaunch_count: int = 3
    worker_env: Dict[str, str] = dataclasses.field(default_factory=dict)
    worker_command: List[str] = dataclasses.field(default_factory=list)
    # rank -> relaunch budget for nodes whose permanent loss fails the
    # job fast (parity: critical_worker_index, training_node.py:40-104);
    # rank 0 is critical by default for allreduce jobs (it owns
    # checkpoint writes and the jax coordinator)
    critical_worker_index: Dict[int, int] = dataclasses.field(
        default_factory=dict
    )
    # evaluator side-job role (parity: the reference's EvaluatorManager,
    # master/node/worker.py EvaluatorManager role): an eval loop on a
    # spare host consuming the job's flash checkpoints; never part of
    # the training rendezvous, relaunched independently
    evaluator_num: int = 0
    evaluator_command: List[str] = dataclasses.field(
        default_factory=list
    )
    evaluator_env: Dict[str, str] = dataclasses.field(
        default_factory=dict
    )
    evaluator_resource: NodeResource = dataclasses.field(
        default_factory=NodeResource
    )
    # cross-run/cross-job learning (brain/): the cluster service's
    # address wins over the in-process file-archive path
    brain_addr: str = ""
    brain_store_path: str = ""

    @property
    def worker_group(self) -> NodeGroupResource:
        return NodeGroupResource(self.node_num, self.node_resource)

    @classmethod
    def from_dict(cls, doc: Dict,
                  platform: Optional[str] = None) -> "JobArgs":
        """Build JobArgs from a parsed ElasticTpuJob document. The spec
        may declare its own ``spec.platform``; an explicit ``platform``
        argument (CLI flag) overrides it."""
        spec = doc.get("spec", doc)
        meta = doc.get("metadata", {})
        worker = spec.get("worker", {})
        res = worker.get("resource", {})
        args = cls(
            job_name=meta.get("name", spec.get("jobName", "job")),
            platform=platform or spec.get("platform", "tpu_vm"),
            namespace=meta.get("namespace", "default"),
            project=spec.get("project", ""),
            zone=spec.get("zone", ""),
            distribution_strategy=spec.get(
                "distributionStrategy", "allreduce"),
            node_num=int(worker.get("replicas", 1)),
            min_node_num=int(
                worker.get("minReplicas", worker.get("replicas", 1))),
            max_node_num=int(
                worker.get("maxReplicas", worker.get("replicas", 1))),
            node_unit=int(spec.get("nodeUnit", 1)),
            relaunch_always=spec.get("relaunchStrategy", "") == "always",
            heartbeat_timeout=spec.get("heartbeatTimeout"),
            node_resource=NodeResource(
                cpu=float(res.get("cpu", 0)),
                memory=parse_memory_mb(res.get("memory", 0)),
                tpu_type=worker.get("acceleratorType", ""),
                priority=worker.get("priority", ""),
            ),
            accelerator_type=worker.get("acceleratorType", ""),
            runtime_version=worker.get("runtimeVersion", ""),
            preemptible=bool(worker.get("preemptible", False)),
            max_relaunch_count=int(worker.get("maxRelaunchCount", 3)),
            worker_env=dict(worker.get("env", {})),
            worker_command=list(worker.get("command", [])),
            critical_worker_index=parse_critical_worker_index(
                worker.get("criticalWorkerIndex", "default"),
                int(worker.get("maxRelaunchCount", 3)),
                int(worker.get("replicas", 1)),
            ),
            brain_addr=spec.get("brainAddr", ""),
            brain_store_path=spec.get("brainStorePath", ""),
        )
        evaluator = spec.get("evaluator", {})
        if evaluator:
            eres = evaluator.get("resource", {})
            args.evaluator_num = int(evaluator.get("replicas", 1))
            args.evaluator_command = list(evaluator.get("command", []))
            args.evaluator_env = dict(evaluator.get("env", {}))
            args.evaluator_resource = NodeResource(
                cpu=float(eres.get("cpu", 0)),
                memory=parse_memory_mb(eres.get("memory", 0)),
                tpu_type=evaluator.get("acceleratorType", ""),
            )
        return args

    @classmethod
    def from_file(cls, path: str,
                  platform: Optional[str] = None) -> "JobArgs":
        with open(path) as f:
            text = f.read()
        try:
            doc = json.loads(text)
        except ValueError:
            import yaml

            doc = yaml.safe_load(text)
        return cls.from_dict(doc, platform=platform)
