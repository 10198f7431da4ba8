"""Job auto-scaler: periodic resource optimization -> ScalePlan execution.

Parity reference: dlrover/python/master/node/job_auto_scaler.py:40
(new_job_auto_scaler factory, AllreduceTrainingAutoScaler:251 — the
allreduce variant adjusts worker count; the PS variant's migration logic
has no TPU analogue).

A copy of ``dlrover_tpu/master/node/job_auto_scaler.py``: every
executed plan counts in ``dlrover_scale_plans_total`` and journals
``scale.plan``.
"""

import threading
from typing import Optional

from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource
from dlrover_tpu_torch.master.resource.optimizer import (
    ResourceOptimizer,
    ResourcePlan,
)
from dlrover_tpu_torch.master.scaler.base_scaler import ScalePlan, Scaler


class AllreduceTrainingAutoScaler:
    """Executes ResourcePlans for the worker group (parity:
    job_auto_scaler.py:251)."""

    def __init__(
        self,
        job_manager,
        job_optimizer: ResourceOptimizer,
        scaler: Optional[Scaler] = None,
        interval: float = 60.0,
        straggler_fn=None,
        min_nodes: int = 0,
        max_nodes: int = 0,
    ):
        self._job_manager = job_manager
        self._job_optimizer = job_optimizer
        self._scaler = scaler
        self._interval = interval
        #: zero-arg callable -> straggler rank list (wired to the
        #: network-check rendezvous manager by the master)
        self._straggler_fn = straggler_fn
        self._min_nodes = min_nodes
        self._max_nodes = max_nodes  # 0 = no ceiling
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # plan generation + execution must be atomic: manual_scale
        # arrives on the gRPC servicer thread while the periodic loop
        # may hold a plan computed against the OLD target — without
        # exclusion the stale plan would undo the manual request (or
        # both paths double-launch from the same bookkeeping read)
        self._plan_lock = threading.Lock()
        # an operator's manual_scale is an explicit decision about the
        # world size; the throughput-grow loop must not override it
        # minutes later (the reference's manualScaling wins over auto)
        self._manual_override = False

    def start_auto_scaling(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._periodic_optimize, daemon=True,
                name="auto-scaler",
            )
            self._thread.start()

    def stop(self):
        self._stopped.set()

    def _periodic_optimize(self):
        while not self._stopped.wait(self._interval):
            try:
                with self._plan_lock:
                    plan = (
                        self._job_optimizer.generate_job_resource_plan()
                    )
                    if (
                        plan is not None
                        and plan.grow_target
                        and self._manual_override
                    ):
                        logger.info(
                            "Skipping throughput grow to %d: operator "
                            "manually scaled this job",
                            plan.grow_target,
                        )
                        plan = None
                    if plan and not plan.empty():
                        self.execute_job_optimization_plan(plan)
                        monitor = getattr(
                            self._job_optimizer, "_speed_monitor", None
                        )
                        new_target = plan.grow_target
                        if self._max_nodes > 0:
                            new_target = min(
                                new_target, self._max_nodes
                            )
                        if (
                            new_target
                            and monitor is not None
                            and new_target
                            > (monitor._target_worker_num or 0)
                        ):
                            # ONLY a throughput grow RAISES the
                            # target (plan.grow_target — a restore
                            # plan's node_unit round-up must not
                            # ratchet it): a grown worker that later
                            # dies is then restored at the grown
                            # size, never past maxReplicas
                            monitor.set_target_worker_num(new_target)
                    self._maybe_shrink_stragglers()
            except Exception as e:
                logger.error("auto-scale iteration failed: %s", e)

    def _maybe_shrink_stragglers(self):
        """Straggler shrink off the network-check list (local_optimizer
        generate_straggler_shrink_plan), evicting exactly the slow
        ranks when the remaining world stays valid. Verdicts are
        filtered against the LIVE world first — an already-evicted
        straggler's stale verdict must not shrink healthy capacity —
        and a executed shrink lowers the speed monitor's target so the
        restore heuristic doesn't immediately re-grow the world
        (shrink/regrow churn)."""
        if self._straggler_fn is None or not hasattr(
            self._job_optimizer, "generate_straggler_shrink_plan"
        ):
            return
        # never shrink a world that has not trained a step yet: the
        # pre-flight check's verdicts should reshape a RUNNING job, not
        # race its first rendezvous (drill: test_four_node_drill.py)
        monitor = getattr(self._job_optimizer, "_speed_monitor", None)
        if monitor is not None and monitor.completed_global_step <= 0:
            return
        mgr = self._job_manager._node_managers.get(NodeType.WORKER)
        if mgr is None:
            return
        live = mgr.unfinished_nodes()
        live_ranks = {n.rank_index for n in live}
        hints = set(self._straggler_fn() or [])
        # the speed monitor's step-cadence scorer feeds a second hint
        # stream: hosts whose own report cadence ran over the
        # fleet median for a sustained window. Network-check verdicts
        # see link slowness before training; the cadence scorer sees
        # host-local slowness DURING training — union them.
        speed_hint_fn = getattr(monitor, "straggler_ranks", None)
        if speed_hint_fn is not None:
            try:
                speed_hints = set(speed_hint_fn() or [])
            except Exception:
                speed_hints = set()
            fresh = speed_hints - hints
            if fresh:
                from dlrover_tpu_torch.telemetry import record

                record(
                    "straggler.hint", source="speed_monitor",
                    nodes=sorted(fresh),
                )
            hints |= speed_hints
        stragglers = sorted(r for r in hints if r in live_ranks)
        if not stragglers:
            return
        plan = self._job_optimizer.generate_straggler_shrink_plan(
            stragglers, len(live), min_nodes=self._min_nodes,
        )
        if plan and not plan.empty():
            executed = self.execute_job_optimization_plan(plan)
            monitor = getattr(
                self._job_optimizer, "_speed_monitor", None
            )
            if executed.remove_nodes and monitor is not None:
                monitor.reduce_target_worker_num(
                    [(n.type, n.id) for n in executed.remove_nodes]
                )
            # (JAX feeds evicted stragglers to the brain's node-health
            # log here; the port has no brain, ROADMAP.md queue A.2.4)

    def manual_scale(self, node_num: int) -> bool:
        """Operator-requested scale (parity: the ScalePlan CRD's
        manualScaling): align to node_unit, floor at min_nodes,
        retarget the speed monitor (so the periodic restore loop
        respects the new size instead of growing back), and reconcile
        immediately."""
        unit = max(
            1, getattr(self._job_optimizer, "_node_unit", 1) or 1
        )
        aligned = (max(node_num, 0) // unit) * unit
        aligned = max(aligned, self._min_nodes)
        if self._max_nodes > 0:
            # one bad RPC must not provision past the job's declared
            # ceiling (agents rendezvous with --nnodes min:max anyway)
            aligned = min(aligned, self._max_nodes)
        with self._plan_lock:
            self._manual_override = True
            monitor = getattr(
                self._job_optimizer, "_speed_monitor", None
            )
            if monitor is not None:
                monitor.set_target_worker_num(aligned)
            plan = ResourcePlan(comment=f"manual scale to {aligned}")
            plan.node_group_resources[NodeType.WORKER] = (
                NodeGroupResource(aligned, NodeResource())
            )
            logger.info("Manual scale request: %d -> %d workers",
                        node_num, aligned)
            self.execute_job_optimization_plan(plan)
        return True

    def execute_job_optimization_plan(self, plan: ResourcePlan):
        """Diff the plan against current bookkeeping and scale. A plan
        carrying ``remove_ranks`` (straggler shrink) removes exactly
        those nodes before the generic count reconcile, so the newest-id
        shrink never evicts healthy workers in a straggler's place."""
        scale_plan = ScalePlan()
        for node_type, group in plan.node_group_resources.items():
            if node_type != NodeType.WORKER:
                continue
            mgr = self._job_manager._node_managers.get(node_type)
            if mgr is None:
                continue
            if plan.remove_ranks:
                targeted = [
                    n for n in mgr.unfinished_nodes()
                    if n.rank_index in plan.remove_ranks
                ]
                for node in targeted:
                    node.is_released = True
                    node.relaunchable = False
                scale_plan.remove_nodes.extend(targeted)
            have = len(mgr.unfinished_nodes())
            want = group.count
            if want > have:
                new_nodes = mgr.scale_up_nodes(
                    want - have, group.node_resource,
                    # replacements inherit the job's relaunch budget,
                    # same as the initial fleet (dist_job_manager.start)
                    max_relaunch_count=getattr(
                        self._job_manager, "_max_relaunch_count", None
                    ),
                )
                scale_plan.launch_nodes.extend(new_nodes)
            elif want < have:
                removed = mgr.scale_down_nodes(have - want)
                scale_plan.remove_nodes.extend(removed)
            scale_plan.node_group_resources[node_type] = group
        if not scale_plan.empty() and self._scaler:
            logger.info(
                "Execute plan: +%d -%d workers (%s)",
                len(scale_plan.launch_nodes),
                len(scale_plan.remove_nodes), plan.comment,
            )
            from dlrover_tpu_torch.telemetry import counter, record

            direction = (
                "up" if len(scale_plan.launch_nodes)
                >= len(scale_plan.remove_nodes) else "down"
            )
            counter(
                "dlrover_scale_plans_total",
                "Executed scale plans", ["direction"],
            ).labels(direction=direction).inc()
            record(
                "scale.plan", direction=direction,
                launch=len(scale_plan.launch_nodes),
                remove=len(scale_plan.remove_nodes),
                comment=str(plan.comment)[:200],
            )
            self._scaler.scale(scale_plan)
        return scale_plan


def new_job_auto_scaler(job_manager, job_optimizer, scaler=None,
                        interval: float = 60.0, straggler_fn=None,
                        min_nodes: int = 0, max_nodes: int = 0):
    """parity: job_auto_scaler.py:40."""
    return AllreduceTrainingAutoScaler(
        job_manager, job_optimizer, scaler, interval,
        straggler_fn=straggler_fn, min_nodes=min_nodes,
        max_nodes=max_nodes,
    )
