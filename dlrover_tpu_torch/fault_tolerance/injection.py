"""First-class fault injection for failover drills and tests.

Counterpart of ``dlrover_tpu/fault_tolerance/injection.py``: every drill
(crash-resume, hang-restart) speaks this one grammar rather than growing
ad-hoc ``--crash-at-step``-style flags per workload.

Two triggers:

* env ``DLROVER_FAULT_INJECT`` — comma-separated ``kind@step[:arg]``:

  - ``crash@15`` / ``crash@15:3``   os._exit at step 15 (default rc 17)
  - ``crash@15:host=1``             only on node rank 1 (``rc=3,host=1``
                                    sets the code too): a multi-node
                                    drill loses exactly one host
  - ``hang@8`` / ``hang@8:120``     stop stepping after step 8 (sleep
                                    forever / for 120 s)
  - ``oom@5``                       raise MemoryError at step 5
  - ``error@5:msg``                 raise RuntimeError(msg) at step 5
  - ``preempt@5``                   SIGTERM own process group (spot-VM
                                    reclaim shape: the agent sees a
                                    signal death or the drain's rc 21,
                                    not a Python traceback)
  - ``preempt@5:notice=5``          SIGTERM now, hard SIGKILL reclaim
                                    5 s later — the termination-notice
                                    window the graceful drain
                                    (fault_tolerance/drain.py) must
                                    beat
  - ``nan@5`` / ``nan@5:host=0``    replace the step-5 loss scalar with
                                    NaN (silent corruption; the
                                    sentinel must trip). ``host=H``
                                    restricts the fault to node rank H
                                    so a multi-worker drill poisons
                                    exactly one host.
  - ``sdc@5:flip=2``                flip 2 exponent bits of the step-5
                                    loss scalar (finite but grossly
                                    wrong — the MAD spike detector's
                                    case); accepts ``host=H`` too:
                                    a comma chunk without ``@``
                                    (``sdc@5:flip=2,host=1``) extends
                                    the previous fault's kv arg rather
                                    than starting a new fault.

  - ``node_lost@8`` / ``node_lost@8:host=2``  SIGKILL the worker's
                                    process group at step 8 with NO
                                    relaunch: the master's
                                    TransitionCoordinator
                                    (reshard/coordinator.py) turns the
                                    loss into an online mesh shrink
                                    instead of restarting the world.
                                    ``host=H`` restricts the kill to
                                    node rank H.
  - ``node_join@12``                marker only: prints and journals
                                    the join point so a drill harness
                                    can launch the joining rank there;
                                    the joiner announces itself through
                                    the node-running path and the
                                    coordinator cuts a grow order.

  The JAX package's other kinds (``master_crash``, ``serve_kill``)
  parse the same way, but a due one raises ``NotImplementedError``
  naming the module that acts on it (:data:`WAITS_FOR`): the
  distributed master and serving are not ported yet (ROADMAP.md,
  queue A).

  Where the JAX ``preempt`` sleeps after its SIGTERM until the drain or
  the reclaim ends the process, the port's returns: the drain inside a
  step waits for the step's end (fault_tolerance/drain.py), and
  SIGTERM's default action has ended an unarmed process already.

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
import signal
import struct
import threading
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

#: silent-corruption kinds: they do not kill the process — the trainer
#: feeds its loss scalar through ``corrupt_loss`` and the sentinel
#: (fault_tolerance/sentinel.py) must notice the poisoned value
CORRUPTION_KINDS = frozenset({"nan", "sdc"})

#: reshard-drill kinds: also honor ``host=H`` scoping so one shared
#: spec loses (or joins) exactly one node rank of a multi-worker drill
RESHARD_KINDS = frozenset({"node_lost", "node_join"})

#: the JAX package's module that acts on each kind not acted on here
WAITS_FOR = {
    "master_crash": "master/dist_master.py",
    "serve_kill": "serving/worker.py",
}


def _signal_own_group(sig: int) -> None:
    """Signal the whole process group, like a real node preemption
    (coworker loaders die with the trainer) — but ONLY when this
    process leads its own group (the agent spawns workers with
    start_new_session); in a shared group, group-wide delivery would
    kill the supervisor that must observe the death."""
    try:
        if os.getpgid(0) == os.getpid():
            os.killpg(os.getpgid(0), sig)
        else:
            os.kill(os.getpid(), sig)
    except (OSError, PermissionError):
        os.kill(os.getpid(), sig)


def _reclaim_after(notice: float) -> None:
    """The platform's hard deadline: nothing the process does extends
    it. SIGKILL, so not even a signal handler can intercept."""
    time.sleep(notice)
    print(
        f"INJECTED RECLAIM after {notice}s notice window", flush=True,
    )
    _signal_own_group(signal.SIGKILL)


def _arg_kv(arg: str, key: str) -> Optional[str]:
    """Value of ``key=`` in a comma-separated kv arg, or None."""
    for kv in arg.split(","):
        k, _, v = kv.partition("=")
        if k.strip() == key and v.strip():
            return v.strip()
    return None


def _flip_bits(x: float, nbits: int) -> float:
    """Flip ``nbits`` low exponent bits of the float64 — an SDC-shaped
    corruption: finite (bit 62 is never touched, so the exponent can't
    saturate to inf/nan for a normal input) but orders of magnitude
    wrong, the gross-but-plausible value the MAD detector exists for."""
    nbits = max(1, min(10, int(nbits)))
    (bits,) = struct.unpack("<Q", struct.pack("<d", float(x)))
    bits ^= ((1 << nbits) - 1) << 52
    (y,) = struct.unpack("<d", struct.pack("<Q", bits))
    return y


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
        self._faults = self._host_filter(parse_spec(spec) if spec else [])
        # first-incarnation gating for env faults
        if restart_count > 0:
            self._faults = [
                f for f in self._faults if f.every_incarnation
            ]
        self._client = master_client
        self._poll_every = max(1, poll_every)

    def _host_filter(self, faults: List[Fault]) -> List[Fault]:
        """Corruption kinds, ``crash`` and the reshard kinds honor
        ``host=H``, so one shared spec hits exactly one node rank."""
        kept = []
        for f in faults:
            if (f.kind in CORRUPTION_KINDS or f.kind == "crash"
                    or f.kind in RESHARD_KINDS):
                host = _arg_kv(f.arg, "host")
                if host is not None and int(host) != self._node_rank:
                    continue
            kept.append(f)
        return kept

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
        """Call once per completed step; executes any due fault.
        Corruption kinds are NOT executed here — they fire from
        ``corrupt_loss`` on the step's loss scalar instead."""
        if self._client is not None and step % self._poll_every == 0:
            self._poll_remote()
        for fault in self._faults:
            if fault.kind not in CORRUPTION_KINDS and fault.due(step):
                fault.fired = True
                self._execute(fault, step)

    def corrupt_loss(self, step: int, loss: float) -> float:
        """Apply any due nan/sdc fault to this step's loss scalar —
        the trainer routes the value it is about to hand the sentinel
        through here, so the corruption rides the normal signal path
        instead of a side channel."""
        for fault in self._faults:
            if fault.kind not in CORRUPTION_KINDS or not fault.due(step):
                continue
            fault.fired = True
            logger.warning(
                "FAULT INJECTION: %s at step %d (arg=%r)",
                fault.kind, step, fault.arg,
            )
            record(
                "fault.injected", fault=fault.kind, step=step,
                arg=fault.arg, node_rank=self._node_rank,
            )
            if fault.kind == "nan":
                print(f"INJECTED NAN LOSS at step {step}", flush=True)
                return float("nan")
            flip = int(_arg_kv(fault.arg, "flip") or 2)
            corrupted = _flip_bits(loss, flip)
            print(
                f"INJECTED SDC at step {step}: loss {loss!r} -> "
                f"{corrupted!r} (flip={flip})", flush=True,
            )
            return corrupted
        return loss

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
            self._faults.extend(self._host_filter(parse_spec(raw.decode())))
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
        # journaled BEFORE executing: crash/preempt never return, and
        # the drill's timeline needs the cause ahead of the effect
        record(
            "fault.injected", fault=fault.kind, step=step,
            arg=fault.arg, node_rank=self._node_rank,
        )
        if fault.kind == "crash":
            rc = int(fault.arg if fault.arg.strip().isdigit()
                     else _arg_kv(fault.arg, "rc") or 17)
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
        elif fault.kind == "preempt":
            # arg ``notice=N``: the platform's termination-notice
            # window — SIGTERM now, hard SIGKILL reclaim N seconds
            # later, the spot-VM preemption shape the drain sequence
            # (fault_tolerance/drain.py) must beat. Without it the
            # process only gets the SIGTERM.
            notice = _arg_kv(fault.arg, "notice")
            notice = float(notice) if notice is not None else None
            print(
                f"INJECTED PREEMPTION at step {step} "
                f"(notice={notice})", flush=True,
            )
            if notice is not None:
                threading.Thread(
                    target=_reclaim_after, args=(notice,),
                    name="preempt-reclaim", daemon=True,
                ).start()
            # delivered to this process before the call returns: the
            # handler has run when it does (see the module docstring)
            _signal_own_group(signal.SIGTERM)
        elif fault.kind == "node_lost":
            # SIGKILL with NO relaunch expectation: a hard node death
            # the master's TransitionCoordinator adopts as an online
            # mesh shrink (reshard/coordinator.py) -- survivors migrate
            # in place; nothing comes back on this rank
            print(f"INJECTED NODE LOST at step {step}", flush=True)
            _signal_own_group(signal.SIGKILL)
            time.sleep(30)  # await delivery; SIGKILL cannot be handled
        elif fault.kind == "node_join":
            # marker only: the joining process does not exist yet. The
            # drill harness watches this line (and the journaled
            # fault.injected) to launch the joining rank, which
            # announces itself through the node-running path so the
            # coordinator cuts a grow order
            print(f"INJECTED NODE JOIN at step {step}", flush=True)
