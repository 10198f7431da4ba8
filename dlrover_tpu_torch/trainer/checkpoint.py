"""Flash checkpoint: async two-tier save for fast failover restore.

Counterpart of ``dlrover_tpu/trainer/checkpoint.py`` for processes that
train on one GPU each. Training state is staged to host RAM first (a
tmpfs such as ``/dev/shm``) so a restarted process restores in seconds,
while a background worker persists the same archive to durable storage
at a lower cadence.

  * RAM tier -- the state tree's tensors are copied into pinned host
    buffers and streamed as one archive (``ckpt_store``'s format v2,
    which the JAX package reads too) to ``ram_dir``, atomically through
    tmp + ``os.rename``.
  * Persist tier -- the same archive streamed into an
    :class:`~dlrover_tpu_torch.trainer.ckpt_store.ObjectStore` (a
    directory on shared storage), committed by a COMMIT marker written
    after the data object.

Zero-stall save pipeline, as in the JAX package:

    train thread          serializer lane           persist worker
    ------------          ---------------           --------------
    stage (enqueue    ->  wait for the copies,  ->  stream archive to
    D2H copies on a       stream the archive to     the store, COMMIT,
    side stream)          tmpfs, gc RAM tier        gc

Staging: each state layout (the tree's paths, dtypes and shapes) gets
pinned host memory once, one page-locked block with a view per tensor,
and every save of that layout reuses it. Page-locking gigabytes takes
seconds, so :meth:`FlashCheckpointer.prepare` can allocate the block on
a background thread before the first save. ``save()`` makes a side
stream wait for the work already queued on the current stream (so the
copies read the state the producing kernels wrote), enqueues one
``non_blocking`` device-to-host copy per tensor there, marks every
source tensor with ``record_stream`` and records a CUDA event; the
serializer thread waits on that event before it writes the archive from
the block. A save whose block is still being written waits for it. A
CPU tensor is cloned on the train thread.

The donation contract of the JAX package (``wait_staged`` before the
dispatch that invalidates the buffers) becomes an ordering on the
device: the port's optimizer writes parameters and moments in place, and
:meth:`FlashCheckpointer.wait_staged` makes the current stream wait on
the last save's copy event, so the next in-place write cannot run before
the copies have read the old values. The host does not block.

Failures are loud: a copy that cannot be enqueued raises in ``save()``,
a copy that fails on the device raises at the next ``save()``,
``wait_staged()`` or ``wait()``, and no save quietly falls back to a
synchronous copy. A restore that finds checkpoints but can read none of
them raises.

Several processes (the ranks of a process group, or ``process_index``
and ``n_processes`` given): every rank writes its own state to its
own RAM-tier file (``step-{s}-proc-{i}``), advertises it to the peer
registry and serves it over ``/ckpt/shard`` (``checkpoint/peer.py``).
A replicated tensor has one domain with every rank as a replica; a
sharded strategy's leaf (``ckpt_store.ShardedLeaf``, in the JAX
parameter tree's coordinates) carries the global map of every rank's
boxes, so a leaf has several domains, each with the ranks that hold
that box as its replicas -- a norm under tp, for one, is replicated
over ``tensor``. ``manifest.elect_owner`` picks, among a domain's
replicas only, the rank that persists it: the persist tier gets each
rank's owned-only subset and index piece (``checkpoint/saver.py``), and
rank 0 merges the pieces and writes COMMIT only when every rank's
objects have landed.
An automatic restore is agreed: the ranks all-gather their newest 16
restorable steps (RAM, store and the peers' advertisements) and take
the newest step every rank holds, then all-gather whether each one
restored it; a failed collective or a failed rank means a fresh start
everywhere, never a rank on its own latest. These two collectives run
on the gloo group of ``trainer/distributed.host_group`` (NCCL cannot
take host tensors). A multi-process step restores through the
format-v2 catalog (``checkpoint/loader.py``) in the order RAM, peer,
store, each shard held to its digest. A single-process archive is
complete and is read whole. The Orbax branches of the JAX checkpointer
belong to a JAX library and have no counterpart.

The sentinel's verdict (:meth:`FlashCheckpointer.set_clean_fn`) tags
each save ``last_good`` in its archive and COMMIT doc; a restore that
picks its step itself walks past a step tagged False, and an explicit
``step=`` is restored as asked.
"""

import atexit
import io
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import (
    counter,
    gauge,
    histogram,
    record,
    tracing,
)
from dlrover_tpu_torch.trainer import ckpt_store

#: DLROVER_TPU_CKPT_QUEUE_DEPTH -- max persist archives in flight
#: (queued + running); DLROVER_TPU_CKPT_STAGE -- "async" (default: the
#: serializer thread waits for the copies) or "sync" (save() waits for
#: the copies on the train thread; serialization/persist still async).
ENV_QUEUE_DEPTH = "DLROVER_TPU_CKPT_QUEUE_DEPTH"
ENV_STAGE = "DLROVER_TPU_CKPT_STAGE"

#: RAM-tier saves take seconds at full size; persist commits can run
#: minutes
_CKPT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 300.0,
)

#: the zero-stall budget: staging dispatch is expected in the
#: millisecond buckets; anything above ~25ms means back-pressure or a
#: first save's buffer allocation
_STALL_BUCKETS = (
    0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 5.0, 30.0,
)

#: saves whose timings ``FlashCheckpointer.save_stats`` keeps
_STATS_KEPT = 8
#: byte alignment of each tensor's view in a pinned block
_ALIGN = 256
#: cudaHostRegisterPortable
_HOST_REGISTER_PORTABLE = 1


def _observe_ckpt(op: str, tier: str, step: int, seconds: float,
                  ok: bool = True, **extra) -> None:
    """One checkpoint save/restore outcome -> metrics + journal."""
    counter(
        "dlrover_checkpoint_ops_total",
        "Checkpoint saves/restores by tier and outcome",
        ["op", "tier", "outcome"],
    ).labels(op=op, tier=tier, outcome="ok" if ok else "error").inc()
    histogram(
        "dlrover_checkpoint_seconds",
        "Checkpoint save/restore wall time", ["op", "tier"],
        buckets=_CKPT_BUCKETS,
    ).labels(op=op, tier=tier).observe(seconds)
    record(
        f"checkpoint.{op}", tier=tier, step=step,
        duration_s=round(seconds, 4), ok=ok, **extra,
    )


def default_ram_dir(job_name: str = "job") -> str:
    base = "/dev/shm" if os.path.isdir("/dev/shm") else "/tmp"
    return os.path.join(base, f"dlrover_tpu_ckpt_{job_name}")


class RestoreError(RuntimeError):
    """Checkpoints exist, but none of them could be restored."""


# ----------------------------------------------------------------- staging


class _PinnedSet:
    """Page-locked host memory for one state layout: one block with a
    view per tensor. The block is a numpy allocation registered with the
    CUDA runtime (``cudaHostRegister``), so it is exactly the layout's
    size and the serializer hands its views to numpy without a copy."""

    def __init__(self, specs: List[Tuple[torch.dtype, Tuple[int, ...]]]):
        offsets, total = [], 0
        for dtype, shape in specs:
            offsets.append(total)
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            total += -(-n // _ALIGN) * _ALIGN
        self.nbytes = total
        self._block = np.empty(max(total, _ALIGN), dtype=np.uint8)
        host = torch.from_numpy(self._block)
        # portable: pinned for every CUDA context, whichever thread
        # registers it
        rc = torch.cuda.cudart().cudaHostRegister(
            host.data_ptr(), self._block.nbytes, _HOST_REGISTER_PORTABLE)
        if int(rc) != 0 or not host.is_pinned():
            raise RuntimeError(
                f"cudaHostRegister of {self._block.nbytes} bytes failed "
                f"({rc}): a checkpoint cannot stage without pinned memory"
            )
        self._registered = True
        self.views = []
        for (dtype, shape), off in zip(specs, offsets):
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            self.views.append(
                host[off:off + n].view(dtype).view(shape))

    def free(self) -> None:
        if self._registered:
            self._registered = False
            torch.cuda.cudart().cudaHostUnregister(
                self._block.ctypes.data)
            self.views = []
            self._block = None


class _PinnedPool:
    """One pinned set per state layout, allocated once -- at the layout's
    first save, or ahead of it by :meth:`reserve` on a background thread
    -- and reused by every save. A save whose set is still being written
    by the serializer waits for it (back-pressure, as the lane gives)."""

    def __init__(self):
        self._cond = threading.Condition()
        #: layout -> its set; None while the allocation runs, or the
        #: exception it raised
        self._sets: Dict[Any, Any] = {}
        self._busy: set = set()
        #: pinned sets allocated so far, and the seconds that took
        self.allocations = 0
        self.alloc_seconds = 0.0

    def reserve(self, layout, specs, background: bool = True) -> None:
        with self._cond:
            if layout in self._sets:
                return
            self._sets[layout] = None

        def allocate():
            t0 = time.perf_counter()
            try:
                pinned = _PinnedSet(specs)
            except BaseException as e:  # raised at the save that needs it
                pinned = e
            with self._cond:
                self._sets[layout] = pinned
                if isinstance(pinned, _PinnedSet):
                    self.allocations += 1
                    self.alloc_seconds += time.perf_counter() - t0
                self._cond.notify_all()

        if background:
            threading.Thread(target=allocate, daemon=True,
                             name="ckpt-pin").start()
        else:
            allocate()

    def acquire(self, layout, specs) -> _PinnedSet:
        self.reserve(layout, specs, background=False)
        with self._cond:
            while self._sets[layout] is None or layout in self._busy:
                self._cond.wait()
            pinned = self._sets[layout]
            if isinstance(pinned, BaseException):
                del self._sets[layout]
                raise pinned
            self._busy.add(layout)
            return pinned

    def release(self, layout) -> None:
        with self._cond:
            self._busy.discard(layout)
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            while any(v is None for v in self._sets.values()):
                self._cond.wait()
            for pinned in self._sets.values():
                if isinstance(pinned, _PinnedSet):
                    pinned.free()
            self._sets, self._busy = {}, set()


@dataclass
class _Staged:
    """One save's host snapshot in the making: the tree with every tensor
    replaced by its host copy, the event after which the device copies
    have landed, and the pinned set to hand back once it is written."""

    tree: Any
    event: Optional[torch.cuda.Event] = None
    layout: Any = None
    pinned: Optional[_PinnedSet] = None
    #: recorded on the copy stream before the copies (timing only)
    start: Optional[torch.cuda.Event] = None
    #: seconds the save waited for its pinned block (allocation, or the
    #: previous save's archive still being written from it)
    pin_wait_s: float = 0.0


def _device_layout(flat):
    """The CUDA tensors of a flattened state as ``[(leaf index, piece
    index, tensor)]`` (a ShardedLeaf's pieces each, a tensor leaf as its
    piece 0), and their layout: (device, paths, [(dtype, shape)]); None
    for a state without CUDA tensors."""
    cuda = [(i, j, t) for i, (_, leaf) in enumerate(flat)
            for j, t in enumerate(ckpt_store.leaf_tensors(leaf))
            if t.is_cuda]
    if not cuda:
        return cuda, None
    devices = {t.device for _, _, t in cuda}
    if len(devices) != 1:
        raise ValueError(f"state spans devices {sorted(map(str, devices))}"
                         "; one process saves one device's tensors")
    specs = tuple((t.dtype, tuple(t.shape)) for _, _, t in cuda)
    paths = tuple(f"{ckpt_store._path_json(flat[i][0])}#{j}"
                  for i, j, _ in cuda)
    return cuda, (devices.pop(), paths, specs)


def _stage(state, pool: _PinnedPool, sync: bool, streams: Dict) -> _Staged:
    """Start the device-to-host snapshot of ``state`` (nested dicts,
    lists and tuples of tensors, numpy arrays and JSON primitives)."""
    flat = ckpt_store.flatten_with_path(state)
    cuda, layout = _device_layout(flat)
    leaves = []
    for _, leaf in flat:
        if isinstance(leaf, torch.Tensor) and not leaf.is_cuda:
            leaf = leaf.detach().clone()
        elif isinstance(leaf, ckpt_store.ShardedLeaf):
            leaf = leaf.with_tensors([
                t if t.is_cuda else t.detach().clone()
                for t in leaf.tensors()])
        elif isinstance(leaf, np.ndarray):
            leaf = leaf.copy()
        leaves.append(leaf)
    staged = _Staged(tree=None, layout=layout)
    if cuda:
        device = layout[0]
        t0 = time.perf_counter()
        staged.pinned = pool.acquire(layout, layout[2])
        staged.pin_wait_s = time.perf_counter() - t0
        stream = streams.get(device)
        if stream is None:
            stream = streams[device] = torch.cuda.Stream(device)
        # the copies read what the kernels queued so far wrote
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            staged.start = torch.cuda.Event(enable_timing=True)
            staged.start.record(stream)
            for (i, j, src), dst in zip(cuda, staged.pinned.views):
                dst.copy_(src.detach(), non_blocking=True)
                src.record_stream(stream)
                if isinstance(leaves[i], ckpt_store.ShardedLeaf):
                    pieces = leaves[i].tensors()
                    pieces[j] = dst
                    leaves[i] = leaves[i].with_tensors(pieces)
                else:
                    leaves[i] = dst
            staged.event = torch.cuda.Event(enable_timing=True)
            staged.event.record(stream)
        if sync:
            staged.event.synchronize()
    staged.tree = ckpt_store.unflatten_like(state, leaves)
    return staged


def _complete(man) -> bool:
    """Whether an archive holds every member of its state: not an
    owned-only subset, and each tensor one shard covering the whole
    tensor with its member (what every rank's RAM tier writes)."""
    if man.get("subset"):
        return False
    for entry in man.get("leaves", []):
        if entry.get("kind") == "shards":
            shape = entry.get("shape", [])
            shards = entry.get("shards") or []
            if len(shards) != 1 or "a" not in shards[0] or shards[0].get(
                    "idx") != [[0, int(n)] for n in shape]:
                return False
        elif entry.get("kind") == "array" and "a" not in entry:
            return False
    return True


def _owned(tree):
    """``tree`` with every tensor copied out of the pinned buffers."""
    flat = ckpt_store.flatten_with_path(tree)
    return ckpt_store.unflatten_like(tree, [
        leaf.clone() if isinstance(leaf, torch.Tensor)
        else leaf.with_tensors([t.clone() for t in leaf.tensors()])
        if isinstance(leaf, ckpt_store.ShardedLeaf) else leaf
        for _, leaf in flat
    ])


@dataclass
class _SaveJob:
    """One save() handed to the serializer lane."""

    step: int
    staged: _Staged
    persist_due: bool
    force: bool
    #: the sentinel's verdict at save() time (None: no sentinel)
    last_good: Optional[bool] = None
    #: set once the snapshot is on the host
    staged_evt: threading.Event = field(default_factory=threading.Event)


@dataclass
class _PersistJob:
    """One persist handed to the bounded persist queue.

    ``payload`` is ``("store", ram_file_path)`` -- the worker streams
    the already-serialized tmpfs archive into the object store (never
    a full in-memory copy) -- or ``("snapshot", snapshot)`` holding the
    host snapshot captured at save() time (never re-read from the live
    state on the background thread: the train loop has updated it in
    place since). The ``"snapshot"`` kind is the RAM-write-failure
    fallback: the worker builds the archive in memory so a due persist
    is never silently lost."""

    step: int
    payload: Tuple[str, Any]
    force: bool
    abandon: Callable[[], None] = lambda: None
    last_good: Optional[bool] = None


class _SerializerLane:
    """Depth-1 background serializer: at most one snapshot being
    serialized plus one staged save pending. A third concurrent save()
    BLOCKS in submit -- honest back-pressure instead of staged
    snapshots piling up when serialization can't keep up."""

    def __init__(self, run_fn: Callable[[Any], None], name: str):
        self._run = run_fn
        self._cond = threading.Condition()
        self._pending: Optional[Any] = None
        self._busy = False
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=name
        )
        self._thread.start()

    def submit(self, job) -> None:
        with self._cond:
            while self._pending is not None and not self._closed:
                self._cond.wait()
            if self._closed:
                raise RuntimeError("checkpointer is closed")
            self._pending = job
            self._cond.notify_all()

    def drain(self) -> None:
        if threading.current_thread() is self._thread:
            return
        with self._cond:
            while self._pending is not None or self._busy:
                if self._closed:
                    return
                self._cond.wait(timeout=0.2)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=10.0)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait()
                if self._pending is None and self._closed:
                    return
                job, self._pending = self._pending, None
                self._busy = True
                self._cond.notify_all()
            try:
                self._run(job)
            except Exception as e:  # never kill the lane
                logger.error("checkpoint serializer failed: %s", e)
            with self._cond:
                self._busy = False
                self._cond.notify_all()


class _PersistQueue:
    """Single persist worker behind a bounded queue.

    In-flight persists (queued + running) never exceed ``depth`` — a
    slow store can pin at most ``depth`` archives, not one per save.
    Overflow policy: a same-step entry is superseded in place; else the
    oldest NON-forced queued entry is dropped and counted
    (``dlrover_checkpoint_persist_skipped_total`` — newest data wins);
    if nothing is skippable the incoming non-forced save is the one
    skipped. Forced saves are never dropped: their submitter blocks
    until there is room (back-pressure on ``force_persist``)."""

    def __init__(self, run_fn: Callable[[_PersistJob], None],
                 depth: int, on_skip: Callable[[_PersistJob, str], None]):
        self._run = run_fn
        self._depth = max(1, int(depth))
        self._on_skip = on_skip
        self._cond = threading.Condition()
        self._q: List[_PersistJob] = []
        self._busy = False
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ckpt-persist"
        )
        self._thread.start()

    @property
    def depth(self) -> int:
        return self._depth

    def _inflight_locked(self) -> int:
        return len(self._q) + (1 if self._busy else 0)

    def inflight(self) -> int:
        with self._cond:
            return self._inflight_locked()

    def _gauge_locked(self) -> None:
        gauge(
            "dlrover_checkpoint_persist_queue_depth",
            "Persist archives in flight (queued + running)",
        ).set(self._inflight_locked())

    def submit(self, job: _PersistJob) -> bool:
        """Returns True when the job was accepted (queued or
        superseded a queued same-step entry), False when skipped."""
        with self._cond:
            if self._closed:
                job.abandon()
                return False
            for i, queued in enumerate(self._q):
                if queued.step == job.step:
                    self._q[i] = job
                    self._cond.notify_all()
                    self._on_skip(queued, "superseded")
                    return True
            if job.force:
                while (
                    self._inflight_locked() >= self._depth
                    and not self._closed
                ):
                    self._cond.wait(timeout=0.5)
                if self._closed:
                    job.abandon()
                    return False
            elif self._inflight_locked() >= self._depth:
                idx = next(
                    (i for i, e in enumerate(self._q) if not e.force),
                    None,
                )
                if idx is None:
                    self._on_skip(job, "queue_full")
                    return False
                self._on_skip(self._q.pop(idx), "overflow")
            self._q.append(job)
            self._gauge_locked()
            self._cond.notify_all()
            return True

    def drain(self) -> None:
        if threading.current_thread() is self._thread:
            return
        with self._cond:
            while self._q or self._busy:
                if self._closed:
                    return
                self._cond.wait(timeout=0.2)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=10.0)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._closed:
                    self._cond.wait()
                if not self._q and self._closed:
                    return
                job = self._q.pop(0)
                self._busy = True
                self._gauge_locked()
                self._cond.notify_all()
            try:
                self._run(job)
            except Exception as e:  # worker survives any one failure
                logger.error(
                    "persist worker failed for step %d: %s", job.step, e
                )
            with self._cond:
                self._busy = False
                self._gauge_locked()
                self._cond.notify_all()


class FlashCheckpointer:
    """Two-tier async checkpointer with a zero-stall save path.

    save(step, state): enqueues the device-to-host copies of the state
    tree and returns; the serializer lane waits for them and streams the
    archive to the RAM tier (tmpfs), then hands the persistent save to a
    bounded persist worker when ``step % persist_interval == 0`` (or
    force_persist).

    ``queue_depth`` bounds in-flight persist archives (default 2, env
    ENV_QUEUE_DEPTH); ``stage`` picks async (default) or sync staging
    (env ENV_STAGE). The state is a tree of nested dicts, lists and
    tuples whose leaves are tensors (on one GPU, or the CPU), numpy
    arrays or JSON primitives. ``process_index`` and ``n_processes``
    default to the process group's rank and size (0 and 1 without a
    group); given, they make virtual processes that share one real one.
    ``peer_registry`` (``checkpoint.peer.PeerRegistry``) advertises the
    RAM-tier steps and finds the peers at restore. ``commit_timeout``
    bounds rank 0's wait for the other ranks' persist objects.
    """

    def __init__(
        self,
        persist_dir: str,
        ram_dir: Optional[str] = None,
        persist_interval: int = 100,
        max_ram_keep: int = 2,
        max_persist_keep: int = 3,
        queue_depth: Optional[int] = None,
        stage: Optional[str] = None,
        commit_timeout: float = 300.0,
        process_index: Optional[int] = None,
        n_processes: Optional[int] = None,
        peer_registry=None,
    ):
        self.persist_dir = (
            persist_dir if ckpt_store.is_url(persist_dir)
            else os.path.abspath(persist_dir)
        )
        self.ram_dir = ram_dir or default_ram_dir(
            os.path.basename(persist_dir.rstrip("/")) or "job"
        )
        self.persist_interval = persist_interval
        self.max_ram_keep = max_ram_keep
        self.max_persist_keep = max_persist_keep
        self.commit_timeout = commit_timeout
        grouped = dist.is_available() and dist.is_initialized()
        self._process_index = (
            int(process_index) if process_index is not None
            else dist.get_rank() if grouped else 0)
        self._n_processes = (
            int(n_processes) if n_processes is not None
            else dist.get_world_size() if grouped else 1)
        #: checkpoint.peer.PeerRegistry advertising this process's
        #: RAM-tier steps and resolving peers at restore (optional)
        self._peer_registry = peer_registry
        # the save-attempt id in the archive's key: the rendezvous
        # round, else "0"
        from dlrover_tpu_torch.common.constants import NodeEnv

        self._attempt = os.getenv(NodeEnv.RDZV_ROUND, "0")
        os.makedirs(self.ram_dir, exist_ok=True)
        if queue_depth is None:
            queue_depth = int(os.getenv(ENV_QUEUE_DEPTH, "2") or 2)
        self.queue_depth = max(1, queue_depth)
        if stage is None:
            stage = os.getenv(ENV_STAGE, "async")
        if stage not in ("async", "sync"):
            raise ValueError(f"stage must be async|sync, got {stage!r}")
        self._stage_sync = stage == "sync"
        # workers start lazily on the first save(): restore-only
        # instances never spawn threads
        self._workers_lock = threading.Lock()
        self._serializer: Optional[_SerializerLane] = None
        self._persistq: Optional[_PersistQueue] = None
        self._last_save: Optional[_SaveJob] = None
        #: (device, event) of the newest save's device-to-host copies
        self._last_copy: Optional[Tuple[Any, torch.cuda.Event]] = None
        self._closed = False
        self._pool = _PinnedPool()
        self._streams: Dict[Any, torch.cuda.Stream] = {}
        #: a copy that failed on the device, raised at the next call
        self._stage_error: Optional[BaseException] = None
        # RAM-tier files referenced by queued/running persist jobs must
        # survive _gc_ram until the upload finished
        self._pin_lock = threading.Lock()
        self._pinned: Dict[str, int] = {}
        self._store = ckpt_store.get_store(self.persist_dir)
        #: step -> that save's timings (the newest few saves): the
        #: train-thread stall and the pinned allocation in it, the
        #: copies' device time, when the snapshot was on the host, the
        #: serialize and persist seconds and the archive bytes
        self.save_stats: Dict[int, Dict[str, Any]] = {}
        #: the newest restore's tier, step and seconds
        self.last_restore_stats: Optional[Dict[str, Any]] = None
        # the sentinel's clean verdict: archives saved inside an
        # anomaly window are tagged last_good=False and skipped by the
        # restore walk-down
        self._clean_fn: Optional[Callable[[], bool]] = None

    def _save_topology(self) -> Dict[str, int]:
        return {
            "n_processes": self._n_processes,
            "process_index": self._process_index,
        }

    def shard_provider(self) -> Callable[[int], Optional[str]]:
        """The ``/ckpt/shard`` backing for this process: step -> its
        RAM-tier archive path when held. Wire it with
        ``telemetry.http.set_shard_provider(ckpt.shard_provider())``."""

        def provide(step: int) -> Optional[str]:
            path = self._ram_path(int(step))
            return path if os.path.exists(path) else None

        return provide

    @property
    def pinned_allocations(self) -> int:
        """Pinned blocks allocated so far (one per state layout)."""
        return self._pool.allocations

    def prepare(self, state: Any) -> None:
        """Allocate the pinned host block for ``state``'s layout now, on
        a background thread, so that the first save of a state of that
        layout does not page-lock it on the train thread. Only the
        layout of ``state`` counts, not its values."""
        _, layout = _device_layout(ckpt_store.flatten_with_path(state))
        if layout is not None:
            self._pool.reserve(layout, layout[2])

    def set_clean_fn(self, fn: Optional[Callable[[], bool]]) -> None:
        """Install the sentinel's clean-verdict callback. Called on the
        train thread at save() time; its answer tags the archive
        (``last_good``) so a coordinated rollback never restores a step
        saved while an anomaly window was open."""
        self._clean_fn = fn

    def _raise_stage_error(self) -> None:
        err, self._stage_error = self._stage_error, None
        if err is not None:
            raise RuntimeError(
                f"a checkpoint's device-to-host copy failed: {err}"
            ) from err

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: Any,
             force_persist: bool = False,
             durable: bool = False) -> float:
        """Stage the snapshot and return; serialization and both tier
        writes happen behind the step loop. Returns the train-thread
        stall in milliseconds: the copies' dispatch, plus any wait for
        the layout's pinned block (its allocation, unless
        :meth:`prepare` made it ahead, or the previous save's archive
        still being written from it).

        ``durable=True`` additionally blocks until the RAM-tier archive
        is on tmpfs (surviving an immediate hard kill of this process);
        the returned stall then covers that drain, while the stall
        histogram keeps recording staging only."""
        self._raise_stage_error()
        t0 = time.perf_counter()
        ts_wall = time.time()
        self._ensure_workers()
        staged = _stage(state, self._pool, self._stage_sync, self._streams)
        # verdict captured on the train thread, at save() time: the
        # background lanes must tag the archive with what the sentinel
        # knew when the state was snapshotted, not when it lands
        last_good = None
        if self._clean_fn is not None:
            try:
                last_good = bool(self._clean_fn())
            except Exception:
                last_good = None
        job = _SaveJob(
            step=step,
            staged=staged,
            persist_due=force_persist or (
                self.persist_interval > 0
                and step % self.persist_interval == 0
            ),
            force=force_persist,
            last_good=last_good,
        )
        if self._stage_sync or staged.event is None:
            job.staged_evt.set()  # host copies already owned
        self._last_save = job
        if staged.event is not None:
            self._last_copy = (staged.layout[0], staged.event)
        self._serializer.submit(job)  # blocks only when the lane is full
        stall_s = time.perf_counter() - t0
        histogram(
            "dlrover_checkpoint_save_stall_seconds",
            "Train-thread stall per checkpoint save (staging only)",
            buckets=_STALL_BUCKETS,
        ).observe(stall_s)
        tracing.add_span(
            "ckpt.stage", ts_wall, stall_s, attrs={"step": step}
        )
        self.save_stats[step] = {
            "stall_s": stall_s,
            "pin_wait_s": staged.pin_wait_s, "t0": t0,
        }
        for old in sorted(self.save_stats)[:-_STATS_KEPT]:
            del self.save_stats[old]
        if durable:
            self._serializer.drain()
            total_s = time.perf_counter() - t0
            logger.info(
                "Flash save step %d: staged in %.2f ms, durable on "
                "tmpfs in %.0f ms", step, stall_s * 1e3, total_s * 1e3,
            )
            return total_s * 1e3
        logger.info(
            "Flash save step %d: staged in %.2f ms (train-thread stall)",
            step, stall_s * 1e3,
        )
        return stall_s * 1e3

    def wait_staged(self) -> bool:
        """THE IN-PLACE UPDATE SYNC POINT: order the current stream after
        the most recent save()'s device-to-host copies, so that nothing
        queued from here on (the optimizer's in-place writes) overwrites
        a tensor before its copy has read it. The host does not wait.
        Without a save in flight this is a no-op; a CPU snapshot was
        cloned at save() and needs no wait."""
        self._raise_stage_error()
        if self._last_copy is not None:
            device, event = self._last_copy
            torch.cuda.current_stream(device).wait_event(event)
        return True

    def _ensure_workers(self) -> None:
        if self._serializer is not None:
            return
        with self._workers_lock:
            if self._serializer is not None:
                return
            if self._closed:
                raise RuntimeError("checkpointer is closed")
            self._persistq = _PersistQueue(
                self._run_persist, self.queue_depth, self._skip_persist
            )
            self._serializer = _SerializerLane(
                self._serialize_job, "ckpt-serialize"
            )
            atexit.register(self._atexit_flush)

    def _atexit_flush(self) -> None:
        # daemon workers die with the interpreter; a clean exit right
        # after a save must still land it
        try:
            self.wait()
        except Exception:
            pass

    def _serialize_job(self, job: _SaveJob) -> None:
        """Serializer lane: wait for the staged copies, stream the archive
        to the RAM tier, then hand off persistence. A RAM-tier write
        failure must NOT drop a due persist -- the snapshot is still
        good, so the persist proceeds from it; a failed copy loses the
        save, is counted, and is raised on the train thread at its next
        checkpoint call."""
        with tracing.span("ckpt.serialize", {"step": job.step}):
            self._serialize_job_inner(job)

    def _serialize_job_inner(self, job: _SaveJob) -> None:
        t0 = time.perf_counter()
        staged = job.staged
        try:
            if staged.event is not None:
                staged.event.synchronize()
            t_staged = time.perf_counter()
            job.staged_evt.set()
        except Exception as e:
            self._stage_error = e
            job.staged_evt.set()
            self._release(staged)
            logger.error(
                "staging snapshot for step %d failed: %s", job.step, e
            )
            _observe_ckpt(
                "save", "ram", job.step, time.perf_counter() - t0,
                ok=False, reason=str(e)[:200],
            )
            if job.persist_due:
                self._skip_persist(
                    _PersistJob(job.step, ("none", None), job.force,
                                last_good=job.last_good),
                    "stage_failed",
                )
            return
        snapshot = staged.tree
        ram_ok = True
        try:
            nbytes = self._write_ram(job.step, snapshot, job.last_good)
            t_ram = time.perf_counter()
            logger.info(
                "Flash save step %d: RAM tier in %.0f ms (pipelined)",
                job.step, (t_ram - t0) * 1e3,
            )
            _observe_ckpt("save", "ram", job.step, t_ram - t0,
                          bytes=nbytes)
            if self._peer_registry is not None:
                # the archive is servable over /ckpt/shard now: tell the
                # master KV so that restoring peers find it
                self._peer_registry.advertise(job.step)
            stats = self.save_stats.get(job.step)
            if stats is not None:
                if staged.start is not None:
                    stats["copy_s"] = staged.start.elapsed_time(
                        staged.event) / 1e3
                stats.update(
                    staged_after_s=t_staged - stats["t0"],
                    serialize_s=t_ram - t_staged, archive_bytes=nbytes,
                )
            self._gc_ram()
        except Exception as e:
            ram_ok = False
            logger.error(
                "RAM-tier save step %d failed: %s", job.step, e
            )
            _observe_ckpt(
                "save", "ram", job.step, time.perf_counter() - t0,
                ok=False, reason=str(e)[:200],
            )
        if job.persist_due and not ram_ok:
            # the persist outlives the pinned buffers' next use
            snapshot = _owned(snapshot)
        self._release(staged)
        job.staged = None
        if job.persist_due:
            self._enqueue_persist(job.step, snapshot, job.force, ram_ok,
                                  job.last_good)

    def _release(self, staged: _Staged) -> None:
        if staged.pinned is not None:
            self._pool.release(staged.layout)
            staged.pinned = None

    def _ram_path(self, step: int) -> str:
        return os.path.join(
            self.ram_dir, f"step-{step}-proc-{self._process_index}"
        )

    def _write_ram(self, step: int, snapshot: Any,
                   last_good: Optional[bool] = None) -> int:
        path = self._ram_path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            nbytes = ckpt_store.snapshot_to_file(
                snapshot, step, f, last_good=last_good,
                topology=self._save_topology(),
            )
        os.replace(tmp, path)
        counter(
            "dlrover_ckpt_shard_bytes_total",
            "Checkpoint shard bytes moved, by tier", ["tier"],
        ).labels(tier="ram").inc(max(0, nbytes))
        return nbytes

    def _pin(self, path: str) -> None:
        with self._pin_lock:
            self._pinned[path] = self._pinned.get(path, 0) + 1

    def _unpin(self, path: str) -> None:
        with self._pin_lock:
            n = self._pinned.get(path, 0) - 1
            if n <= 0:
                self._pinned.pop(path, None)
            else:
                self._pinned[path] = n

    def _gc_ram(self):
        records = self._list_ram()
        with self._pin_lock:
            pinned = set(self._pinned)
        for step, path in records[: -self.max_ram_keep]:
            if path in pinned:
                continue  # a persist upload still streams from it
            try:
                os.remove(path)
            except OSError:
                continue
            if self._peer_registry is not None:
                # stop advertising what is no longer held
                self._peer_registry.withdraw(step)

    def _list_ram(self):
        # let queued saves land first so listings see every save already
        # issued; no-op when called from the serializer lane itself
        self._drain_saves()
        records = []
        suffix = f"-proc-{self._process_index}"
        try:
            for name in os.listdir(self.ram_dir):
                if name.startswith("step-") and name.endswith(suffix):
                    try:
                        step = int(name.split("-")[1])
                    except ValueError:
                        continue
                    records.append(
                        (step, os.path.join(self.ram_dir, name))
                    )
        except FileNotFoundError:
            pass
        return sorted(records)

    def _enqueue_persist(self, step: int, snapshot: Any,
                         force: bool, ram_ok: bool,
                         last_good: Optional[bool] = None) -> None:
        """Serializer lane -> persist queue handoff. A queued persist
        references the RAM-tier file (pinned against gc); when the RAM
        write failed it carries the host snapshot and the worker builds
        the archive in memory."""
        if ram_ok:
            path = self._ram_path(step)
            self._pin(path)
            job = _PersistJob(
                step, ("store", path), force,
                abandon=lambda: self._unpin(path), last_good=last_good,
            )
        else:
            logger.warning(
                "RAM tier for step %d unavailable; persisting from "
                "the in-memory snapshot", step,
            )
            job = _PersistJob(step, ("snapshot", snapshot), force,
                              last_good=last_good)
        self._persistq.submit(job)

    def _put_owned_subset(self, step: int, src) -> None:
        """The persist upload of a multi-process save: the OWNED subset
        of the full archive (each replicated tensor goes up once, from
        its elected owner) plus this process's index piece (the subset
        manifest) for rank 0's merge."""
        import json

        from dlrover_tpu_torch.checkpoint import saver as ckpt_saver

        if isinstance(src, str):
            with open(src, "rb") as f:
                sub_bytes, sub_man, stats = ckpt_saver.subset_archive(
                    f, self._process_index)
        else:
            sub_bytes, sub_man, stats = ckpt_saver.subset_archive(
                src, self._process_index)
        ckpt_store.put_shard_stream(
            self._store, step, self._process_index,
            io.BytesIO(sub_bytes), attempt=self._attempt,
            size=len(sub_bytes),
        )
        self._store.put(
            ckpt_store.index_key(step, self._process_index, self._attempt),
            json.dumps(sub_man, separators=(",", ":")).encode("utf-8"),
        )
        counter(
            "dlrover_ckpt_shard_bytes_total",
            "Checkpoint shard bytes moved, by tier", ["tier"],
        ).labels(tier="persistent").inc(len(sub_bytes))
        record("ckpt.dedup", step=step,
               process_index=self._process_index, **stats)
        if step in self.save_stats:
            self.save_stats[step].update(
                owned_bytes=stats["bytes_owned"],
                full_bytes=stats["bytes_full"])

    def _skip_persist(self, job: _PersistJob, reason: str) -> None:
        job.abandon()
        counter(
            "dlrover_checkpoint_persist_skipped_total",
            "Persistent saves dropped by the bounded queue",
            ["reason"],
        ).labels(reason=reason).inc()
        record(
            "checkpoint.persist_skipped", step=job.step, reason=reason,
            queue_depth=self.queue_depth,
        )
        logger.warning(
            "Persistent save step %d skipped (%s; queue depth %d)",
            job.step, reason, self.queue_depth,
        )

    def _run_persist(self, job: _PersistJob) -> None:
        with tracing.span(
            "ckpt.persist", {"step": job.step, "kind": job.payload[0]}
        ):
            self._run_persist_inner(job)

    def _run_persist_inner(self, job: _PersistJob) -> None:
        t0 = time.time()
        step = job.step
        kind, payload = job.payload
        sharded = self._n_processes > 1
        try:
            extra = {}
            if kind == "store":
                try:
                    if sharded:
                        self._put_owned_subset(step, payload)
                    else:
                        with open(payload, "rb") as f:
                            size = os.fstat(f.fileno()).st_size
                            ckpt_store.put_shard_stream(
                                self._store, step, self._process_index, f,
                                attempt=self._attempt, size=size,
                            )
                finally:
                    job.abandon()  # upload done/failed: unpin RAM file
            else:  # "snapshot": RAM tier failed -- archive from memory
                buf = io.BytesIO()
                size = ckpt_store.snapshot_to_file(
                    payload, step, buf, last_good=job.last_good,
                    topology=self._save_topology(),
                )
                buf.seek(0)
                if sharded:
                    self._put_owned_subset(step, buf)
                else:
                    ckpt_store.put_shard_stream(
                        self._store, step, self._process_index, buf,
                        attempt=self._attempt, size=size,
                    )
                extra = {"source": "memory"}
            if self._process_index != 0:
                # only rank 0 knows whether the step commits
                logger.info("Persistent save step %d: shard uploaded "
                            "(awaiting rank-0 commit)", step)
                if step in self.save_stats:
                    self.save_stats[step]["persist_s"] = time.time() - t0
                return
            if sharded:
                committed = ckpt_store.commit_step_sharded(
                    self._store, step, self._n_processes,
                    attempt=self._attempt, timeout=self.commit_timeout,
                    last_good=job.last_good,
                )
                if committed:
                    record("ckpt.manifest_committed", step=step,
                           n_processes=self._n_processes,
                           attempt=self._attempt)
            else:
                committed = ckpt_store.commit_step(
                    self._store, step, attempt=self._attempt,
                    last_good=job.last_good,
                )
            dt = time.time() - t0
            if not committed:
                logger.error(
                    "Persistent save step %d NOT committed: peer objects "
                    "missing after %.0fs", step, self.commit_timeout)
                _observe_ckpt("save", "persistent", step, dt, ok=False,
                              reason="commit_timeout")
                return
            ckpt_store.gc_steps(self._store, self.max_persist_keep)
            logger.info("Persistent save step %d done", step)
            _observe_ckpt(
                "save", "persistent", step, dt, backend="store", **extra,
            )
            if step in self.save_stats:
                self.save_stats[step]["persist_s"] = dt
        except Exception as e:
            logger.error("Persistent save step %d failed: %s", step, e)
            _observe_ckpt(
                "save", "persistent", step, time.time() - t0,
                ok=False, reason=str(e)[:200],
            )

    def wait(self):
        """Block until EVERY in-flight save -- staged, serializing, and
        queued/running persists -- has finished; raise if a staged copy
        failed on the device."""
        if self._serializer is not None:
            self._serializer.drain()
        if self._persistq is not None:
            self._persistq.drain()
        self._raise_stage_error()

    # --------------------------------------------------------------- restore

    def _drain_saves(self) -> None:
        """Make queued-but-unserialized saves visible to readers (no-op
        from the pipeline's own threads)."""
        if self._serializer is not None:
            self._serializer.drain()

    def latest_step(self) -> Optional[int]:
        self._drain_saves()
        ram = self._list_ram()
        ram_step = ram[-1][0] if ram else None
        # per-process availability, not just COMMITs: a step that lost
        # its shard object must not be chosen over an older one
        steps = ckpt_store.available_steps(self._store, self._process_index)
        persist_step = steps[-1] if steps else None
        candidates = [s for s in (ram_step, persist_step) if s is not None]
        return max(candidates) if candidates else None

    def restore(self, target: Any = None, step: Optional[int] = None,
                extra_sources: Optional[List[Any]] = None):
        """Restore ``(state, step)``, preferring the RAM tier; ``(None,
        None)`` when there is no checkpoint.

        ``target``: a tree of the state's structure; every tensor comes
        back on its target tensor's device, after its shape and dtype
        were checked. ``step=None`` picks the newest step and walks down
        the persist tier past unreadable ones and past steps saved
        inside a sentinel anomaly window (``last_good=False``); an
        explicit step is restored as asked and never falls back. Raises
        :class:`RestoreError` when checkpoints exist but none could be
        restored. ``last_restore_stats`` then holds the tier, the step,
        the seconds the restore took and the bytes it read (and, for a
        multi-process step, the shards and bytes each tier served).

        With several processes and ``step=None`` the outcome is agreed:
        every process restores the newest step all of them hold, or
        every process starts fresh, never a mix. The ranks run the same
        two collectives whatever fails locally: the consensus gather,
        then the agreement gather.

        ``extra_sources``: shard sources the format-v2 assembly consults
        BEFORE every checkpoint tier (``reshard/migrate.py``'s live
        tier, a hot spare's pre-warmed cache). A source carrying a
        ``step`` attribute is consulted only when the candidate step
        matches it: a walk-down to an older step is never served another
        step's bytes. ``last_restore_stats`` counts what each served
        under its tier (``live`` beside ``local``, ``peer`` and
        ``store``).
        """
        self._drain_saves()
        self.last_restore_stats = None
        if self._peer_registry is not None:
            self._advertise_held()
        if not (step is None and self._n_processes > 1):
            return self._restore_once(target, step, extra_sources)
        step = self._consensus_step(self._local_candidate_steps())
        state, got = None, None
        if step is not None:
            try:
                state, got = self._restore_once(target, step,
                                                extra_sources)
            except Exception as e:
                logger.warning("restore attempt failed: %s", e)
                state, got = None, None
        if not self._agree_restored(state is not None):
            if state is not None:
                logger.warning(
                    "A peer failed to restore step %s; starting fresh "
                    "everywhere for a consistent world", got)
            self.last_restore_stats = None
            return None, None
        return state, got

    def _advertise_held(self) -> None:
        """Advertise every RAM-tier step this process holds, under its
        current URL: a restarted survivor serves its archives to the
        peers that restore with it."""
        try:
            for held, _ in self._list_ram():
                self._peer_registry.advertise(held)
        except Exception as e:
            logger.warning("peer re-advertise failed: %s", e)

    def _gather_ints(self, values: List[int], k: int) -> List[List[int]]:
        """Every process's ``values`` (at most ``k``), over the gloo
        group of ``trainer/distributed.host_group``. Without a process
        group (virtual processes in one real one) the gather is over
        this process alone, as the JAX package's gather is over one
        process."""
        from dlrover_tpu_torch.trainer.distributed import host_group

        mine = torch.full((k,), -1, dtype=torch.int64)
        mine[:len(values)] = torch.tensor(values[:k], dtype=torch.int64)
        group = host_group()
        if group is None:
            rows = [mine]
        else:
            rows = [torch.empty_like(mine)
                    for _ in range(dist.get_world_size(group))]
            dist.all_gather(rows, mine, group=group)
        return [[int(v) for v in row if v >= 0] for row in rows]

    def _consensus_step(self, local_steps) -> Optional[int]:
        """The newest step EVERY process can restore: the ranks
        all-gather their newest 16 candidates and take the newest one
        all of them hold. After a world change the ranks' RAM tiers can
        hold different histories; each restoring its own latest would
        mix training states without an error. A failed gather votes for
        a fresh start, never for the local latest: if it failed on only
        some ranks, their local answers could differ while every rank
        still agrees afterwards."""
        local_steps = set(local_steps or ())
        if self._n_processes <= 1:
            return max(local_steps) if local_steps else None
        try:
            rows = self._gather_ints(sorted(local_steps)[-16:], 16)
            common = set.intersection(*(set(r) for r in rows))
            return max(common) if common else None
        except Exception as e:
            logger.error(
                "cross-process checkpoint consensus failed (%s); voting "
                "for a fresh start -- a partial collective failure must "
                "not produce a mixed-step restore", e)
            return None

    def _agree_restored(self, ok: bool) -> bool:
        """True only when EVERY process restored: one rank dropping to
        scratch (or an older step) while the others restore is a mixed
        world."""
        if self._n_processes <= 1:
            return ok
        try:
            rows = self._gather_ints([1 if ok else 0], 1)
            return all(r == [1] for r in rows)
        except Exception as e:
            logger.warning("restore agreement check failed: %s", e)
            return ok

    def _local_candidate_steps(self) -> set:
        """This process's restorable steps: its RAM tier, the store's
        steps and the peers' advertisements. A listing error gives an
        empty part instead of raising, so that every rank reaches the
        consensus collective."""
        steps: set = set()
        try:
            steps |= set(dict(self._list_ram()))
        except Exception as e:
            logger.warning("RAM-tier listing failed: %s", e)
        try:
            steps |= set(ckpt_store.available_steps(
                self._store, self._process_index))
        except Exception as e:
            logger.warning("persist-tier listing failed: %s", e)
        if self._peer_registry is not None:
            # steps the survivors hold in RAM: the catalog restore
            # assembles them over /ckpt/shard even with this process's
            # tmpfs gone and the store down
            try:
                steps |= set(self._peer_registry.advertised_steps())
            except Exception as e:
                logger.warning("peer step listing failed: %s", e)
        return steps

    def _restore_once(self, target: Any = None,
                      step: Optional[int] = None,
                      extra_sources: Optional[List[Any]] = None):
        t0 = time.perf_counter()
        ram = dict(self._list_ram())
        auto_step = step is None
        avail: List[int] = []
        if auto_step:
            # an unreachable store must not end the attempt: the RAM
            # tier can still restore
            try:
                avail = ckpt_store.available_steps(
                    self._store, self._process_index)
            except Exception as e:
                logger.warning("persist-tier listing failed: %s", e)
            local = set(ram) | set(avail)
            step = max(local) if local else None
        if step is None:
            return None, None
        failures: List[str] = []
        if step in ram:
            tainted = False
            try:
                with open(ram[step], "rb") as f:
                    man = ckpt_store.read_manifest(f)
                    # an auto-selected step saved inside an anomaly
                    # window must not be restored -- the corruption the
                    # sentinel tripped on may already be in it. An
                    # explicit step is the caller's (master's) choice.
                    tainted = auto_step and man.get("last_good") is False
                    if not tainted:
                        state = self._restore_local_archive(
                            f, man, step, target, t0, extra_sources)
                        if self.last_restore_stats is None:
                            self._restored("ram", step, t0, f)
                        return state, step
            except (ckpt_store.ArchiveError, OSError, KeyError) as e:
                failures.append(f"RAM tier step {step}: {e}")
                logger.warning(
                    "RAM restore failed (%s); trying persistent", e)
            if tainted:
                self._note_tainted(step, step, tier="ram")
        # auto-selection may land on a step whose persist shard is gone
        # (a RAM-tier step never persisted): walk down the restorable
        # persist steps. An explicit step never falls back, and neither
        # does a multi-process world: a rank quietly restoring an older
        # step than its peers is the mixed state the consensus prevents.
        candidates = [step]
        if auto_step and self._n_processes <= 1:
            candidates += [s for s in reversed(avail) if s < step]
        for cand in candidates:
            if (auto_step and
                    ckpt_store.step_last_good(self._store, cand) is False):
                self._note_tainted(cand, step, tier="persistent")
                continue
            # format v2 first: the catalog from the peers and the
            # store's step manifest, each shard from any tier
            try:
                state, stats = self._restore_v2(
                    cand, target, extra_sources=extra_sources)
            except Exception as e:
                state, stats = None, None
                logger.info("step %d not v2-restorable (%s); trying the "
                            "one-process archive", cand, e)
                if self._n_processes > 1:
                    failures.append(f"step {cand} over the catalog: {e}")
            if state is not None:
                tier = ("peer" if stats.get("peer") and not stats.get(
                    "store") and not stats.get("local") else "persistent")
                self._restored(tier, cand, t0, int(stats.get("bytes", 0)),
                               requested_step=step, shards=stats)
                return state, cand
            try:
                with ckpt_store.open_step(
                    self._store, cand, self._process_index
                ) as f:
                    man = ckpt_store.read_manifest(f)
                    state = self._restore_local_archive(
                        f, man, cand, target, t0)
                    nbytes = f.seek(0, os.SEEK_END)
            except (KeyError, ckpt_store.ArchiveError) as e:
                # missing OR corrupt: keep walking down
                if isinstance(e, ckpt_store.DigestMismatchError):
                    reason = "digest_mismatch"
                elif isinstance(e, ckpt_store.ArchiveError):
                    reason = "archive_error"
                else:
                    reason = "missing"
                if reason != "missing" or cand in avail:
                    failures.append(f"persist tier step {cand}: {e}")
                record(
                    "checkpoint.restore_fallback", step=cand,
                    requested_step=step, reason=reason,
                    error=str(e)[:200],
                )
                counter(
                    "dlrover_ckpt_restore_fallbacks_total",
                    "Persist-tier restore candidates rejected during "
                    "the walk-down", ["reason"],
                ).labels(reason=reason).inc()
                logger.warning(
                    "Persist step %d unusable (%s); trying older", cand, e,
                )
                continue
            if cand != step:
                logger.warning(
                    "Step %d not restorable from persist tier; "
                    "restored older step %d", step, cand,
                )
            self._restored("persistent", cand, t0, nbytes,
                           requested_step=step)
            return state, cand
        if failures:
            raise RestoreError(
                "no checkpoint could be restored: " + "; ".join(failures))
        return None, None

    def _note_tainted(self, cand: int, requested: int,
                      tier: str) -> None:
        """Journal an auto-restore candidate rejected for carrying the
        ``last_good=False`` tag (saved inside a sentinel anomaly
        window) -- same vocabulary as every other walk-down rejection."""
        record(
            "checkpoint.restore_fallback", step=cand,
            requested_step=requested, reason="anomaly_window",
            tier=tier,
        )
        counter(
            "dlrover_ckpt_restore_fallbacks_total",
            "Persist-tier restore candidates rejected during "
            "the walk-down", ["reason"],
        ).labels(reason="anomaly_window").inc()
        logger.warning(
            "Step %d (%s tier) was saved inside an anomaly window; "
            "skipping it for restore", cand, tier,
        )

    def _restored(self, tier: str, step: int, t0: float, archive,
                  shards: Optional[Dict[str, int]] = None,
                  **extra) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()  # the state is on its device
        total = time.perf_counter() - t0
        nbytes = (archive if isinstance(archive, int)
                  else archive.seek(0, os.SEEK_END))
        logger.info("Restored step %d from %s tier in %.2f s",
                    step, tier, total)
        _observe_ckpt("restore", tier, step, total, bytes=nbytes, **extra)
        self.last_restore_stats = {
            "tier": tier, "step": step, "seconds": total,
            "archive_bytes": nbytes}
        if shards is not None:
            # shards and bytes each tier served (format-v2 catalog)
            self.last_restore_stats.update(shards)

    def _restore_local_archive(self, f, man, step: int, target,
                               t0: float, extra_sources=None):
        """The RAM tier's (or a one-process persist) archive. A complete
        archive -- one process's, or a rank's RAM tier of a replicated
        state -- is read whole, each tensor streamed to
        its target's card; a subset, or a rank's archive with a member
        that fails its digest, is assembled through the format-v2
        catalog, this archive first, then the peers and the store."""
        version = int(man.get("version", 1))
        topo_n = int((man.get("topology") or {}).get("n_processes", 1))
        if version < 2:
            record("checkpoint.legacy_format", step=man.get("step"),
                   version=version)
        if version < 2 or (topo_n <= 1 and not man.get("subset")):
            state, _ = ckpt_store.snapshot_from_file(f, target)
            return state
        if _complete(man):
            try:
                state, _ = ckpt_store.snapshot_from_file(f, target)
                return state
            except ckpt_store.DigestMismatchError as e:
                # the catalog takes each bad shard from the next tier
                logger.warning("RAM-tier step %d: %s; assembling it "
                               "shard by shard", step, e)
        state, stats = self._restore_v2(step, target, local_file=f,
                                        extra_sources=extra_sources)
        self._restored("ram", step, t0, int(stats.get("bytes", 0)),
                       shards=stats)
        return state

    def _restore_v2(self, step: int, target, local_file=None,
                    extra_sources=None):
        """The format-v2 catalog restore: the widest catalog the
        surviving metadata allows (this process's archive manifest, the
        peers' manifests, the store's step manifest), then every leaf
        through the sources local -> peer -> store, each shard held to
        its digest. Returns ``(state, stats)``; raises when the step has
        no v2 metadata or cannot be assembled whole."""
        from dlrover_tpu_torch.checkpoint import loader as ckpt_loader
        from dlrover_tpu_torch.checkpoint import peer as ckpt_peer

        catalog = None
        sources: List[Any] = []
        for src in extra_sources or []:
            # the live and pre-warmed tiers outrank every checkpoint
            # tier, but a source that declares its step serves ONLY that
            # step: an older walk-down candidate than the live state is
            # assembled from the checkpoint tiers instead
            if src is None:
                continue
            src_step = getattr(src, "step", None)
            if src_step is not None and int(src_step) != int(step):
                continue
            sources.append(src)
        if local_file is not None:
            man = ckpt_store.read_manifest(local_file)
            catalog = ckpt_loader.StepCatalog.from_archive_manifest(man)
            sources.append(ckpt_loader.LocalArchiveSource(local_file))
        peers: Dict[int, str] = {}
        if self._peer_registry is not None:
            try:
                peers = {p: u for p, u in
                         self._peer_registry.peers(step).items()
                         if p != self._process_index}
            except Exception as e:
                logger.warning("peer lookup failed: %s", e)
            for p in sorted(peers):
                try:
                    man = ckpt_peer.fetch_manifest(peers[p], step)
                except Exception as e:
                    logger.warning(
                        "peer manifest from proc %d failed: %s", p, e)
                    continue
                if man is None:
                    continue
                if catalog is None:
                    catalog = ckpt_loader.StepCatalog.from_archive_manifest(
                        man)
                else:
                    catalog.absorb(man)
            if peers:
                sources.append(ckpt_loader.PeerSource(
                    peers, step, process_index=self._process_index))
        man2 = None
        try:
            man2 = ckpt_store.step_manifest(self._store, step)
        except Exception as e:
            logger.info("no step manifest for step %d in the store: %s",
                        step, e)
        else:
            if man2 is None and self._process_index != 0:
                # a step of a one-process world: its archive, with the
                # manifest inside, is process 0's object; another
                # process of a grown world assembles its boxes from it
                try:
                    whole = ckpt_loader.StoreArchiveSource(
                        ckpt_store.open_step(self._store, step, 0))
                except (KeyError, ckpt_store.ArchiveError) as e:
                    logger.info("step %d: no one-process archive in the "
                                "store: %s", step, e)
                else:
                    if catalog is None:
                        catalog = ckpt_loader.StepCatalog.\
                            from_archive_manifest(whole.manifest)
                    else:
                        catalog.absorb(whole.manifest)
                    sources.append(whole)
        if man2 is not None:
            store_cat = ckpt_loader.StepCatalog.from_step_manifest(man2)
            if catalog is None:
                catalog = store_cat
            else:
                for k, loc in store_cat.locations.items():
                    catalog.locations.setdefault(k, loc)
                for k, v in store_cat.digests.items():
                    catalog.digests.setdefault(k, v)
                for k, v in store_cat.encodings.items():
                    catalog.encodings.setdefault(k, v)
            sources.append(ckpt_loader.StoreSource(
                self._store, step, str(man2.get("attempt", "0")),
                store_cat.locations))
        if catalog is None:
            raise KeyError(f"step {step}: no format-v2 metadata reachable")
        try:
            state, _, stats = ckpt_loader.restore_from_catalog(
                catalog, target, sources)
        finally:
            for s in sources:
                close = getattr(s, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        pass
        record(
            "ckpt.topology_restore", step=step,
            saved_processes=int(
                (catalog.topology or {}).get("n_processes", 1)),
            restore_processes=self._n_processes,
            local=stats.get("local", 0), peer=stats.get("peer", 0),
            store=stats.get("store", 0), live=stats.get("live", 0),
            digest_mismatch=stats.get("digest_mismatch", 0),
            bytes=stats.get("bytes", 0),
        )
        return state, dict(stats)

    def close(self):
        """Flush every in-flight save, stop the pipeline threads and free
        the pinned buffers. Idempotent; the instance refuses new saves
        afterwards."""
        try:
            self.wait()
        finally:
            with self._workers_lock:
                if self._closed:
                    return
                self._closed = True
                serializer, self._serializer = self._serializer, None
                persistq, self._persistq = self._persistq, None
            if serializer is not None:
                serializer.close()
            if persistq is not None:
                persistq.close()
            if serializer is not None or persistq is not None:
                try:
                    atexit.unregister(self._atexit_flush)
                except Exception:
                    pass
            self._pool.close()
