"""First-class fault injection for failover drills and tests.

Counterpart of ``dlrover_tpu/fault_tolerance/injection.py``: every drill
(crash-resume, hang-restart) speaks this one grammar rather than growing
ad-hoc ``--crash-at-step``-style flags per workload.

Two triggers:

* env ``DLROVER_FAULT_INJECT`` — comma-separated ``kind@step[:arg]``:

  - ``crash@15`` / ``crash@15:3``   os._exit at step 15 (default rc 17)
  - ``hang@8`` / ``hang@8:120``     stop stepping after step 8 (sleep
                                    forever / for 120 s)
  - ``oom@5``                       raise MemoryError at step 5
  - ``error@5:msg``                 raise RuntimeError(msg) at step 5

  The JAX package's other kinds (``preempt``, ``nan``, ``sdc``,
  ``master_crash``, ``serve_kill``, ``node_lost``, ``node_join``) parse
  the same way, but a due one raises ``NotImplementedError`` naming the
  module it waits for (:data:`WAITS_FOR`): the drain, the sentinel, the
  master's failover, serving and resharding are not ported yet
  (ROADMAP.md, queue A).

  Env injections fire only on the *first* incarnation (restart count 0
  from ``NodeEnv.RESTART_COUNT``), so a drill hits once and the relaunch
  runs clean — append ``!`` (``crash@15!``) to fire on every incarnation.

* master KV store key ``fault_inject/<node_rank>`` — polled every
  ``poll_every`` steps, so a live job can be injected over RPC
  (``master_client.kv_store_set``) with the same grammar; ``now`` is
  accepted as the step (``hang@now:30``). The key is consumed (reset)
  when read, so one RPC injects exactly one fault.
"""

import os
import time
from dataclasses import dataclass
from typing import List, Optional

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import record

ENV_SPEC = "DLROVER_FAULT_INJECT"
KV_PREFIX = "fault_inject"

KINDS = (
    "crash", "hang", "oom", "error", "preempt", "master_crash",
    "nan", "sdc", "serve_kill", "node_lost", "node_join",
)

#: the JAX package's module each kind not acted on here waits for
WAITS_FOR = {
    "preempt": "fault_tolerance/drain.py",
    "nan": "fault_tolerance/sentinel.py",
    "sdc": "fault_tolerance/sentinel.py",
    "master_crash": "master/state_journal.py",
    "serve_kill": "serving/worker.py",
    "node_lost": "reshard/coordinator.py",
    "node_join": "reshard/coordinator.py",
}


@dataclass
class Fault:
    kind: str
    step: int  # -1 == "now"
    arg: str = ""
    every_incarnation: bool = False
    fired: bool = False

    def due(self, step: int) -> bool:
        return not self.fired and (self.step < 0 or step >= self.step)


def parse_spec(spec: str) -> List[Fault]:
    faults = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        every = part.endswith("!")
        if every:
            part = part[:-1]
        if "@" not in part:
            # a ``k=v`` continuation of the previous fault's arg — the
            # spec splits on commas, but so do kv args
            # (``sdc@5:flip=2,host=1``), so a comma chunk without "@"
            # extends the fault before it
            if not faults or "=" not in part:
                raise ValueError(
                    f"fault spec {part!r}: expected kind@step"
                )
            prev = faults[-1]
            prev.arg = f"{prev.arg},{part}" if prev.arg else part
            prev.every_incarnation = prev.every_incarnation or every
            continue
        kind, rest = part.split("@", 1)
        if kind not in KINDS:
            raise ValueError(
                f"fault kind {kind!r} not one of {KINDS}"
            )
        step_s, _, arg = rest.partition(":")
        step = -1 if step_s == "now" else int(step_s)
        faults.append(Fault(kind, step, arg, every_incarnation=every))
    return faults


class FaultInjector:
    """Injects faults into a training loop at step boundaries."""

    def __init__(
        self,
        spec: str = "",
        master_client=None,
        node_rank: int = 0,
        restart_count: int = 0,
        poll_every: int = 10,
    ):
        self._node_rank = node_rank
        self._faults = parse_spec(spec) if spec else []
        # first-incarnation gating for env faults
        if restart_count > 0:
            self._faults = [
                f for f in self._faults if f.every_incarnation
            ]
        self._client = master_client
        self._poll_every = max(1, poll_every)

    @classmethod
    def from_env(cls, master_client=None) -> Optional["FaultInjector"]:
        """Build from the process env; None when nothing is configured
        and there is no master to poll."""
        spec = os.environ.get(ENV_SPEC, "")
        if not spec and master_client is None:
            return None
        return cls(
            spec,
            master_client=master_client,
            node_rank=int(os.environ.get(NodeEnv.NODE_RANK, "0")),
            restart_count=int(
                os.environ.get(NodeEnv.RESTART_COUNT, "0")
            ),
        )

    # -- trigger -----------------------------------------------------------

    def maybe_inject(self, step: int) -> None:
        """Call once per completed step; executes any due fault."""
        if self._client is not None and step % self._poll_every == 0:
            self._poll_remote()
        for fault in self._faults:
            if fault.due(step):
                fault.fired = True
                self._execute(fault, step)

    def _poll_remote(self) -> None:
        try:
            raw = self._client.kv_store_get(
                f"{KV_PREFIX}/{self._node_rank}"
            )
            if not raw:
                return
            # consume: one RPC == one injection
            self._client.kv_store_set(
                f"{KV_PREFIX}/{self._node_rank}", b""
            )
            self._faults.extend(parse_spec(raw.decode()))
        except Exception as e:
            logger.warning("fault-inject poll failed: %s", e)

    # -- execution ---------------------------------------------------------

    def _execute(self, fault: Fault, step: int) -> None:
        if fault.kind in WAITS_FOR:
            raise NotImplementedError(
                f"fault kind {fault.kind!r} waits for the port of "
                f"{WAITS_FOR[fault.kind]} (ROADMAP.md, queue A)"
            )
        logger.warning(
            "FAULT INJECTION: %s at step %d (arg=%r)",
            fault.kind, step, fault.arg,
        )
        # journaled BEFORE executing: a crash never returns, and the
        # drill's timeline needs the cause ahead of the effect
        record(
            "fault.injected", fault=fault.kind, step=step,
            arg=fault.arg, node_rank=self._node_rank,
        )
        if fault.kind == "crash":
            rc = int(fault.arg) if fault.arg else 17
            print(f"INJECTED CRASH rc={rc} at step {step}", flush=True)
            os._exit(rc)
        elif fault.kind == "hang":
            duration = float(fault.arg) if fault.arg else float("inf")
            print(f"INJECTED HANG at step {step}", flush=True)
            deadline = time.monotonic() + duration
            while time.monotonic() < deadline:
                time.sleep(min(1.0, deadline - time.monotonic()))
        elif fault.kind == "oom":
            raise MemoryError(
                f"injected OOM at step {step} {fault.arg}"
            )
        elif fault.kind == "error":
            raise RuntimeError(
                fault.arg or f"injected error at step {step}"
            )
