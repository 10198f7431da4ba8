"""Local heuristic resource optimizer for TPU jobs.

Parity reference: dlrover/python/master/resource/local_optimizer.py:66
(PSLocalOptimizer: stats-window heuristics, OptimizerParams
min_worker_speed_ratio) and resource/job.py:511
(AllreduceJobResourceOptimizer), adjust_oom_resource resource/job.py:301.

TPU shape: the tunable resource is the WORKER (TPU host) count and host
RAM, and the decision input is the stats pipeline's RuntimeMetric speed
window (master/stats). Heuristics:
 - worker count: when running below the target, grow back in node_unit
   multiples — UNLESS the speed window proves a throughput plateau
   (samples at the higher count showed each extra worker keeping less
   than ``MIN_WORKER_SPEED_RATIO`` of the per-worker throughput, i.e.
   growing buys nothing but churn);
 - straggler shrink: drop network-check-identified stragglers when the
   remaining world still satisfies min_nodes and node_unit alignment;
 - OOM: grow host memory 1.5x up to a cap (the reference's
   oom_memory_up_rate).

Counterpart of ``dlrover_tpu/master/resource/local_optimizer.py``
without the Brain (ROADMAP.md, queue A.2.4): the JAX class's brain paths
(``_brain_memory_plan``, ``_brain_warm_start``, ``report_node_event``)
act only with a brain client, and a client given here raises. Without
one the JAX paths are no-ops, so the plans are the same.
"""

from typing import Dict, List

from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource
from dlrover_tpu_torch.master.resource.optimizer import (
    ResourceOptimizer,
    ResourcePlan,
)

OOM_MEMORY_UP_RATE = 1.5
MAX_HOST_MEMORY_MB = 512 * 1024
#: each extra worker must retain at least this fraction of per-worker
#: throughput for growth to be worthwhile (parity: OptimizerParams
#: min_worker_speed_ratio, local_optimizer.py:54)
MIN_WORKER_SPEED_RATIO = 0.5
#: samples needed at a worker count before trusting its speed estimate
MIN_SPEED_SAMPLES = 2


class TPULocalOptimizer(ResourceOptimizer):
    def __init__(self, job_args=None, speed_monitor=None,
                 node_unit: int = 1, stats_reporter=None,
                 brain_client=None):
        self._job_args = job_args
        self._speed_monitor = speed_monitor
        self._node_unit = max(1, node_unit)
        self._stats_reporter = stats_reporter
        if brain_client is not None:
            raise NotImplementedError(
                "a brain client waits for the port of brain/ "
                "(ROADMAP.md, queue A.2.4)")

    def init_job_resource(self, job_resource=None) -> ResourcePlan:
        plan = ResourcePlan(comment="initial")
        node_num = getattr(self._job_args, "node_num", 0) or 0
        resource = getattr(self._job_args, "node_resource", None)
        if node_num:
            plan.node_group_resources[NodeType.WORKER] = (
                NodeGroupResource(node_num, resource or NodeResource())
            )
        return plan

    # -- speed-window scaling --------------------------------------------

    def _speed_per_worker(self) -> Dict[int, float]:
        """worker_num -> mean steps/sec/worker from the runtime window."""
        if self._stats_reporter is None:
            return {}
        samples = self._stats_reporter.speed_samples_by_worker_num()
        return {
            n: (sum(v) / len(v)) / n
            for n, v in samples.items()
            if len(v) >= MIN_SPEED_SAMPLES
        }

    def _growth_plateaued(self, current: int, proposed: int) -> bool:
        """True when the speed window shows that running at (or beyond)
        ``proposed`` workers kept less than MIN_WORKER_SPEED_RATIO of the
        per-worker throughput measured at the CURRENT size — the extra
        workers were not pulling their weight, so re-growing is churn
        without speedup. Comparison uses the sample counts nearest to
        current/proposed (a stale tiny-world startup sample must not veto
        a healthy restore)."""
        spw = self._speed_per_worker()
        low_ns = [n for n in spw if n <= current]
        high_ns = [n for n in spw if n >= proposed]
        if not low_ns or not high_ns:
            return False  # no evidence: default to restoring capacity
        low = spw[max(low_ns)]  # closest to the current world size
        high = spw[min(high_ns)]  # closest to the proposed size
        return high < MIN_WORKER_SPEED_RATIO * low

    def generate_job_resource_plan(self) -> ResourcePlan:
        plan = ResourcePlan()
        if self._speed_monitor is None:
            return plan
        target = self._speed_monitor._target_worker_num
        running = len(self._speed_monitor.running_workers)
        if not target:
            return plan
        if running >= target:
            return self._maybe_throughput_grow(running)
        # restore to the node_unit-aligned target (a partial slice
        # cannot run; never over-provision past the rounded target)
        unit = self._node_unit
        total = ((target + unit - 1) // unit) * unit
        if self._growth_plateaued(running, total):
            logger.info(
                "Not growing %d -> %d workers: speed window shows a "
                "throughput plateau", running, total,
            )
            return plan
        plan.node_group_resources[NodeType.WORKER] = (
            NodeGroupResource(total, NodeResource())
        )
        plan.comment = (
            f"restore to {total} workers ({running}/{target} running)"
        )
        logger.info("Resource plan: %s", plan.comment)
        return plan

    def _maybe_throughput_grow(self, running: int) -> ResourcePlan:
        """DeepRec-style throughput scale-UP (parity:
        docs/blogs/deeprec_autoscale_cn.md:223 — 30 -> 100 steps/s by
        adding workers off observed speed; AllreduceTrainingAutoScaler
        job_auto_scaler.py:251): with headroom below maxReplicas and a
        MEASURED speed window at the current size, grow one node_unit
        at a time; the next round needs fresh samples at the grown
        size, and plateau evidence (the marginal worker stopped
        pulling its weight) ends the climb."""
        plan = ResourcePlan()
        max_nodes = getattr(self._job_args, "max_node_num", 0) or 0
        unit = self._node_unit
        proposed = min(running + unit, max_nodes)
        proposed = (proposed // unit) * unit
        if proposed <= running:
            return plan
        spw = self._speed_per_worker()
        measured_le = sorted(n for n in spw if n <= running)
        if not measured_le or measured_le[-1] != running:
            # growth is driven by speed measured AT the current size —
            # accepting smaller-world samples would let consecutive
            # grows climb to maxReplicas with zero fresh evidence
            return plan
        cur = measured_le[-1]
        if len(measured_le) > 1 and spw[cur] < (
            MIN_WORKER_SPEED_RATIO * spw[measured_le[-2]]
        ):
            # retrospective: the PREVIOUS growth's marginal workers are
            # not pulling their weight — the climb already hit the wall
            logger.info(
                "Not growing %d -> %d workers: last growth's marginal "
                "throughput gone (plateau)", running, proposed,
            )
            return plan
        if self._growth_plateaued(running, proposed):
            # forward-looking: history at >= proposed (e.g. before a
            # shrink) already showed it doesn't pay
            logger.info(
                "Not growing %d -> %d workers: marginal throughput "
                "gone (plateau)", running, proposed,
            )
            return plan
        plan.node_group_resources[NodeType.WORKER] = (
            NodeGroupResource(proposed, NodeResource())
        )
        plan.grow_target = proposed
        plan.comment = (
            f"throughput grow {running} -> {proposed} workers "
            f"(max {max_nodes})"
        )
        logger.info("Resource plan: %s", plan.comment)
        return plan

    def generate_straggler_shrink_plan(
        self, straggler_ranks: List[int], running_num: int,
        min_nodes: int = 0,
    ) -> ResourcePlan:
        """Shrink the world past stragglers when the remainder still
        forms a valid node_unit-aligned world (parity role: the
        reference's straggler handling off the network-check list,
        rdzv_manager.py:368)."""
        plan = ResourcePlan()
        if not straggler_ranks:
            return plan
        if not min_nodes:
            min_nodes = getattr(self._job_args, "min_node_num", 1) or 1
        remaining = running_num - len(straggler_ranks)
        unit = self._node_unit
        aligned = (remaining // unit) * unit
        if aligned < max(min_nodes, 1) or aligned == 0:
            logger.info(
                "Keeping %d stragglers: shrinking to %d breaks "
                "min_nodes=%d/node_unit=%d", len(straggler_ranks),
                aligned, min_nodes, unit,
            )
            return plan
        plan.node_group_resources[NodeType.WORKER] = (
            NodeGroupResource(aligned, NodeResource())
        )
        plan.remove_ranks = list(straggler_ranks)
        plan.comment = (
            f"shrink past stragglers {straggler_ranks} -> {aligned}"
        )
        logger.info("Resource plan: %s", plan.comment)
        return plan

    def adjust_oom_resource(self, node) -> None:
        """parity: resource/job.py:301."""
        res = node.config_resource or NodeResource()
        old = res.memory or 16 * 1024
        res.memory = int(min(old * OOM_MEMORY_UP_RATE,
                             MAX_HOST_MEMORY_MB))
        node.config_resource = res
        logger.info(
            "OOM on %s: host memory %d -> %d MB", node.name, old,
            res.memory,
        )
