"""Worker-side data shard clients, copied from
``dlrover_tpu/agent/sharding/client.py``.

Parity reference: dlrover/python/elastic_agent/sharding/client.py:31,249
(ShardingClient, IndexShardingClient with prefetch thread).

Beyond parity, the dispatch path is batched and buffered: one
``get_tasks(n)`` round-trip can pull several shards (the master
group-commits its ledger once for the whole batch), and an optional
background lookahead thread keeps a bounded window of fetched-but-
unconsumed shards so WAIT polls and RPC latency are absorbed off the
training thread. Exactly-once semantics are unchanged: every buffered
shard is journaled in the master's doing set before the reply leaves,
so shards buffered by a worker that dies are requeued by the task
watchdog (or reclaimed immediately on the successor's first fetch via
the incarnation handshake).

The JAX client also feeds each dispatch round trip's latency to the
fleet roll-up (``telemetry/fleet.py``); that observation comes with the
fleet module (ROADMAP.md, queue A).
"""

import threading
import time
from collections import deque
from queue import Empty, Full, Queue
from typing import List, Optional

import numpy as np

from dlrover_tpu_torch.agent.master_client import get_master_client
from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import counter, gauge, record

#: default ceiling on one fetch_shard WAIT poll. The master's task
#: watchdog requeues a dead peer's shard within its task timeout
#: (minutes); an hour of WAIT means the watchdog itself is gone — stop
#: depending on it instead of spinning forever.
DEFAULT_WAIT_DEADLINE_SECS = 3600.0

#: sentinel for "the master answered WAIT" inside _request_tasks
_WAIT = object()


class ShardingClient:
    """Fetch shard tasks and report completion by accumulated minibatches."""

    def __init__(
        self,
        dataset_name: str,
        batch_size: int,
        num_epochs: int = 1,
        dataset_size: int = 0,
        shuffle: bool = False,
        task_type: str = TaskType.TRAINING,
        num_minibatches_per_shard: int = 2,
        storage_type: str = "table",
        master_client=None,
        fetch_batch: Optional[int] = None,
        lookahead: Optional[int] = None,
    ):
        import os

        from dlrover_tpu_torch.common.constants import NodeEnv

        self._master_client = master_client or get_master_client()
        self._batch_size = batch_size
        self._dataset_name = dataset_name
        self._count_minibatches_per_shard = num_minibatches_per_shard
        self._pending_tasks = deque()
        # records (samples) of the HEAD pending shard already consumed.
        # Counted in records, not minibatches: a mid-shard resize
        # (reshard re-arms the batch geometry) changes the minibatch
        # count of an in-flight shard, and a minibatch counter would
        # report the head task done before (or after) its records were
        # actually consumed — losing the tail to exactly-once if the
        # worker then dies
        self._records_done = 0
        self._lock = threading.Lock()
        self._current_task = None
        self._stopped = False
        # this process's incarnation (agent restart count): lets the
        # master reclaim a dead predecessor's in-flight shards on our
        # first fetch instead of waiting out the task timeout
        self._incarnation = int(
            os.getenv(NodeEnv.RESTART_COUNT, "-1") or -1
        )
        # ---- batched dispatch + lookahead window ---------------------
        if fetch_batch is None:
            fetch_batch = int(
                os.getenv("DLROVER_TPU_SHARD_FETCH_BATCH", "1") or 1
            )
        if lookahead is None:
            lookahead = int(
                os.getenv("DLROVER_TPU_SHARD_LOOKAHEAD", "0") or 0
            )
        self._fetch_batch = max(1, fetch_batch)
        self._lookahead = max(0, lookahead)
        #: shards fetched from the master but not yet handed to the
        #: training thread; guarded by _buf_cond (NOT self._lock — the
        #: buffer must stay reachable while a completion RPC is slow)
        self._ready: deque = deque()
        self._buf_cond = threading.Condition()
        self._drained = False  # master said: dataset done
        self._fetch_error: Optional[BaseException] = None
        self._batch_supported = True
        # hot-path instruments resolved once, not per poll tick
        self._wait_counter = counter(
            "dlrover_shard_wait_polls_total",
            "WAIT answers received while polling for a shard",
            ["dataset"],
        ).labels(dataset=dataset_name)
        self._prefetch_gauge = gauge(
            "dlrover_shard_prefetch_depth",
            "Shards fetched from the master but not yet consumed by "
            "the training thread", ["dataset"],
        ).labels(dataset=dataset_name)
        self._lookahead_thread: Optional[threading.Thread] = None
        self._dataset_params = dict(
            batch_size=batch_size,
            num_epochs=num_epochs,
            dataset_size=dataset_size,
            shuffle=shuffle,
            num_minibatches_per_shard=num_minibatches_per_shard,
            dataset_name=dataset_name,
            task_type=task_type,
            storage_type=storage_type,
        )
        self._master_client.report_dataset_shard_params(
            **self._dataset_params
        )
        # re-hello: a master that came back WITHOUT a state journal has
        # never heard of this dataset — re-report the params on every
        # reconnect (idempotent: new_dataset is a no-op when the master
        # restored the dataset from its journal)
        add_hook = getattr(self._master_client, "add_reconnect_hook", None)
        if add_hook is not None:
            add_hook(
                f"dataset:{dataset_name}",
                lambda: self._master_client.report_dataset_shard_params(
                    **self._dataset_params
                ),
            )
        if self._lookahead > 0:
            self._lookahead_thread = threading.Thread(
                target=self._lookahead_loop, daemon=True,
                name="shard-lookahead",
            )
            self._lookahead_thread.start()

    @property
    def dataset_name(self):
        return self._dataset_name

    # ------------------------------------------------------------ dispatch

    def _request_tasks(self, n: int):
        """One master round-trip for up to ``n`` shards.

        Returns a list of real tasks (empty = dataset exhausted), or
        the ``_WAIT`` sentinel when the master answered WAIT. Uses the
        batched RPC when available; a master that predates it rejects
        the unknown message with an APPLICATION error — that flips the
        client into single-fetch fallback for good. Connection-class
        errors (including MasterLostError after a reconnect deadline)
        are NOT protocol rejections and propagate to the caller.
        """
        mc = self._master_client
        if n > 1 and self._batch_supported and hasattr(mc, "get_tasks"):
            try:
                tasks = mc.get_tasks(
                    self._dataset_name, max_tasks=n,
                    incarnation=self._incarnation,
                )
            except (ConnectionError, OSError):
                raise  # outage, not an old master
            except Exception as e:
                self._batch_supported = False
                logger.warning(
                    "master rejected batched get_tasks for dataset %s "
                    "(%s); falling back to single-task fetch",
                    self._dataset_name, e,
                )
                record(
                    "shard.batch_rpc_fallback",
                    dataset=self._dataset_name, error=str(e)[:120],
                )
                tasks = None
            if tasks is not None:
                real = [
                    t for t in tasks if t is not None and t.task_id >= 0
                ]
                if real:
                    return real
                if any(
                    t is not None and t.task_type == TaskType.WAIT
                    for t in tasks
                ):
                    return _WAIT
                return []
        task = mc.get_task(
            self._dataset_name, incarnation=self._incarnation
        )
        if task is not None and task.task_type == TaskType.WAIT:
            return _WAIT
        if task is None or task.task_id < 0:
            return []
        return [task]

    def _push_ready(self, tasks: List) -> None:
        with self._buf_cond:
            self._ready.extend(tasks)
            self._prefetch_gauge.set(len(self._ready))
            self._buf_cond.notify_all()

    def _pop_ready_locked(self):
        """Pop one buffered task, or None; caller holds _buf_cond."""
        if not self._ready:
            return None
        task = self._ready.popleft()
        self._prefetch_gauge.set(len(self._ready))
        self._buf_cond.notify_all()  # wake the lookahead refill
        return task

    def _deliver(self, task):
        with self._lock:
            self._pending_tasks.append(task)
            self._current_task = task
        return task.shard

    def _lookahead_loop(self):
        """Keep the ready buffer at the lookahead depth, absorbing RPC
        latency and WAIT polls off the training thread."""
        try:
            while True:
                with self._buf_cond:
                    while (
                        len(self._ready) >= self._lookahead
                        and not self._stopped
                    ):
                        self._buf_cond.wait()
                    if self._stopped or self._drained:
                        return
                    want = min(
                        self._fetch_batch,
                        self._lookahead - len(self._ready),
                    )
                got = self._request_tasks(max(1, want))
                if got is _WAIT:
                    self._wait_counter.inc()
                    if self._stopped:
                        return
                    time.sleep(0.5)
                    continue
                if not got:
                    with self._buf_cond:
                        self._drained = True
                        self._buf_cond.notify_all()
                    return
                self._push_ready(got)
        except BaseException as e:  # surfaced to the training thread
            with self._buf_cond:
                self._fetch_error = e
                self._buf_cond.notify_all()

    def fetch_shard(self, poll_interval: float = 0.5,
                    max_wait: Optional[float] =
                    DEFAULT_WAIT_DEADLINE_SECS):
        """Fetch the next shard, or None when the dataset is exhausted.

        A WAIT task (queue drained, a PEER's work still in flight)
        polls instead of returning None — reading it as end-of-dataset
        would lose the re-delivery of a dead peer's orphaned shard.
        The master never WAITs us on our own unreported tail (see
        DatasetManger.pending_for_others), and a fetch from a
        restarted worker reclaims its dead predecessor's shards
        immediately (reclaim_stale_incarnation, keyed on the
        incarnation this client sends).

        The poll is BOUNDED: liveness must not hinge on the master's
        watchdog requeueing the peer's shard — if WAIT persists past
        ``max_wait`` seconds (None = unbounded), log and return None
        rather than blocking the training thread forever. stop()
        interrupts the poll at the next tick.

        With ``fetch_batch > 1`` shards arrive several-per-round-trip
        and queue in a local buffer; with ``lookahead > 0`` a
        background thread keeps that buffer full and this call only
        dequeues (errors from the thread re-raise here)."""
        deadline = (
            time.monotonic() + max_wait if max_wait is not None else None
        )
        if self._lookahead_thread is not None:
            return self._fetch_from_lookahead(poll_interval, deadline,
                                              max_wait)
        while True:
            with self._buf_cond:
                task = self._pop_ready_locked()
            if task is not None:
                return self._deliver(task)
            if self._drained:
                return None
            got = self._request_tasks(self._fetch_batch)
            if got is _WAIT:
                # a sustained climb here = workers starving on a peer's
                # in-flight shard (dead peer / stuck watchdog)
                self._wait_counter.inc()
                if self._stopped:
                    return None
                if deadline is not None and time.monotonic() > deadline:
                    logger.error(
                        "fetch_shard waited >%.0fs on dataset %s with "
                        "the master still answering WAIT (stuck "
                        "watchdog or never-expiring task?); giving up "
                        "on the in-flight peer shard",
                        max_wait, self._dataset_name,
                    )
                    return None
                time.sleep(poll_interval)
                continue
            if not got:
                self._drained = True
                return None
            self._push_ready(got)

    def _fetch_from_lookahead(self, poll_interval, deadline, max_wait):
        with self._buf_cond:
            while True:
                task = self._pop_ready_locked()
                if task is not None:
                    break
                if self._fetch_error is not None:
                    raise self._fetch_error
                if self._drained or self._stopped:
                    return None
                if deadline is not None and time.monotonic() > deadline:
                    logger.error(
                        "fetch_shard waited >%.0fs on dataset %s with "
                        "no shard surfacing from the lookahead window",
                        max_wait, self._dataset_name,
                    )
                    return None
                self._buf_cond.wait(timeout=poll_interval)
        return self._deliver(task)

    def stop(self):
        """Interrupt any in-progress WAIT poll; subclasses extend."""
        self._stopped = True
        with self._buf_cond:
            self._buf_cond.notify_all()
        remove = getattr(
            self._master_client, "remove_reconnect_hook", None
        )
        if remove is not None:
            remove(f"dataset:{self._dataset_name}")

    def resize(self, batch_size: int) -> None:
        """Re-arm the batch geometry after a world resize (reshard
        transition): future completion accounting and index chunking
        use the new per-host batch size. Safe mid-shard — completion
        is counted in records, which a geometry change cannot skew;
        call between steps, after the mesh transition lands."""
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive: {batch_size}")
        with self._lock:
            self._batch_size = batch_size
            # the reconnect re-hello replays _dataset_params: a master
            # that lost its journal would otherwise re-create the
            # dataset under the PRE-resize geometry
            self._dataset_params["batch_size"] = batch_size

    def report_batch_done(self, batch_size: Optional[int] = None) -> bool:
        """Accumulate batch completions; report the oldest pending task
        done once its shard's records are consumed
        (parity: sharding/client.py:146). ``batch_size`` overrides the
        client's configured size for THIS batch (short final batches,
        mixed geometry across a resize).

        The completion RPC runs OUTSIDE the lock: a slow or
        reconnecting master must not stall stop()/report_task_done()
        behind this call."""
        task = None
        with self._lock:
            if not self._pending_tasks:
                return False
            head = self._pending_tasks[0]
            records = head.shard.end - head.shard.start
            self._records_done += batch_size or self._batch_size
            if self._records_done >= records:
                self._pending_tasks.popleft()
                # carry the overflow: an index-stream chunk straddles
                # shard boundaries, so its tail belongs to (and must
                # credit) the NEXT head
                self._records_done -= records
                task = head
        if task is None:
            return False
        resp = self._master_client.report_task_result(
            self._dataset_name, task.task_id
        )
        # the master may REJECT the completion (the watchdog already
        # requeued this task to someone else): the caller must not
        # account the range as its own
        return bool(getattr(resp, "success", True))

    def report_task_done(self, task_id: int, err: str = "") -> bool:
        """Report completion; returns whether the master ACCEPTED it.
        False means the task was unknown or already requeued (watchdog
        reassignment, a shard-ledger rewind) — the caller must not
        count the range as its own exactly-once consumption."""
        resp = self._master_client.report_task_result(
            self._dataset_name, task_id, err
        )
        with self._lock:
            if (
                self._pending_tasks
                and self._pending_tasks[0].task_id == task_id
            ):
                # the partially-counted head is gone: a stale record
                # count must not leak onto the next head shard
                self._records_done = 0
            self._pending_tasks = deque(
                t for t in self._pending_tasks if t.task_id != task_id
            )
        return bool(getattr(resp, "success", True))

    def get_shard_checkpoint(self) -> str:
        return self._master_client.get_shard_checkpoint(self._dataset_name)

    def restore_shard_from_checkpoint(self, content: str):
        return self._master_client.report_shard_checkpoint(content)

    def get_current_epoch(self) -> int:
        return self._master_client.get_dataset_epoch(self._dataset_name)


class IndexShardingClient(ShardingClient):
    """Per-sample index stream over shards with a prefetch thread
    (parity: sharding/client.py:249).

    Indices travel from the prefetch thread to consumers as
    batch-sized numpy chunks (one queue op per ~batch_size samples),
    not per-sample puts — ``fetch_batch_indices`` hands out whole
    slices and ``fetch_sample_index`` cursors through the current
    chunk without touching the queue."""

    #: chunks buffered between prefetch and consumer (in units of
    #: ~batch_size samples; 8 matches the old per-sample queue bound)
    QUEUE_CHUNKS = 8

    def __init__(self, dataset_name: str, batch_size: int,
                 num_epochs: int = 1, dataset_size: int = 0,
                 shuffle: bool = False,
                 task_type: str = TaskType.TRAINING,
                 num_minibatches_per_shard: int = 2,
                 storage_type: str = "table",
                 num_workers: int = 1,
                 master_client=None,
                 fetch_batch: Optional[int] = None,
                 lookahead: Optional[int] = None):
        super().__init__(
            dataset_name, batch_size, num_epochs, dataset_size, shuffle,
            task_type, num_minibatches_per_shard, storage_type,
            master_client=master_client, fetch_batch=fetch_batch,
            lookahead=lookahead,
        )
        self._sample_queue: Queue = Queue(maxsize=self.QUEUE_CHUNKS)
        self._exhausted = False
        self._failed = False
        # consumer-side cursor over the chunk most recently dequeued
        self._consume_lock = threading.Lock()
        self._chunk: Optional[np.ndarray] = None
        self._chunk_pos = 0
        self._prefetch_thread = threading.Thread(
            target=self._prefetch_loop, daemon=True,
            name="shard-index-prefetch",
        )
        self._prefetch_thread.start()

    def _put_chunk(self, chunk: np.ndarray) -> bool:
        """Bounded put that aborts on stop() instead of blocking forever."""
        while not self._stopped:
            try:
                self._sample_queue.put(chunk, timeout=0.1)
                return True
            except Full:
                continue
        return False

    def _prefetch_loop(self):
        clean = False
        try:
            while not self._stopped:
                shard = self.fetch_shard()
                if shard is None:
                    clean = True  # master says: dataset done
                    break
                if shard.record_indices is not None:
                    arr = np.asarray(
                        shard.record_indices, dtype=np.int64
                    )
                else:
                    arr = np.arange(
                        shard.start, shard.end, dtype=np.int64
                    )
                stopped_mid_shard = False
                for off in range(0, arr.size, self._batch_size):
                    if not self._put_chunk(
                        arr[off:off + self._batch_size]
                    ):
                        stopped_mid_shard = True
                        break
                if stopped_mid_shard:
                    break
            else:
                clean = True  # stop() requested; not a failure
        except Exception as e:
            logger.error("Shard prefetch thread failed: %s", e)
        finally:
            # record WHY iteration ended, then unblock consumers. A
            # deliberate stop() is neither exhaustion nor failure — the
            # master may still hold undispatched shards.
            if not self._stopped:
                if clean:
                    self._exhausted = True
                else:
                    self._failed = True
            try:
                self._sample_queue.put_nowait(None)
            except Full:
                pass  # consumers drain and then hit the timeout path

    @property
    def exhausted(self) -> bool:
        """True only when the dataset cleanly ran out (not on stop() or a
        prefetch failure)."""
        return self._exhausted

    @property
    def failed(self) -> bool:
        """True when the prefetch thread died on an error (RPC loss etc.);
        samples may remain undispatched on the master."""
        return self._failed

    def _next_chunk(self) -> Optional[np.ndarray]:
        """Dequeue the next chunk, or None when iteration ended;
        caller holds _consume_lock."""
        while True:
            try:
                chunk = self._sample_queue.get(timeout=0.1)
            except Empty:
                # no sentinel needed: a dead/stopped producer + empty
                # queue means iteration is over
                if self._stopped or not self._prefetch_thread.is_alive():
                    return None
                continue
            if chunk is None:
                try:
                    self._sample_queue.put_nowait(None)  # re-signal
                except Full:
                    pass
                return None
            return chunk

    def fetch_sample_index(self) -> Optional[int]:
        """Next sample index, or None when iteration ended — check
        ``exhausted`` / ``failed`` to distinguish dataset end from a
        deliberate stop or an error."""
        with self._consume_lock:
            if (
                self._chunk is not None
                and self._chunk_pos < self._chunk.size
            ):
                idx = int(self._chunk[self._chunk_pos])
                self._chunk_pos += 1
                return idx
            chunk = self._next_chunk()
            if chunk is None:
                return None
            self._chunk = chunk
            self._chunk_pos = 1
            return int(chunk[0])

    def fetch_batch_indices(
        self, batch_size: Optional[int] = None
    ) -> Optional[np.ndarray]:
        """A batch of indices as one numpy array (possibly short on
        epoch end), or None when iteration ended. The common case is a
        zero-copy handoff of a whole prefetched chunk."""
        n = batch_size or self._batch_size
        with self._consume_lock:
            parts = []
            got = 0
            while got < n:
                if (
                    self._chunk is None
                    or self._chunk_pos >= self._chunk.size
                ):
                    chunk = self._next_chunk()
                    if chunk is None:
                        break
                    self._chunk = chunk
                    self._chunk_pos = 0
                take = min(n - got, self._chunk.size - self._chunk_pos)
                parts.append(
                    self._chunk[self._chunk_pos:self._chunk_pos + take]
                )
                self._chunk_pos += take
                got += take
            if not parts:
                return None
            if len(parts) == 1:
                return parts[0]
            return np.concatenate(parts)

    def stop(self):
        super().stop()
        try:
            # best-effort wakeup; consumers also poll _stopped on timeout,
            # so a full queue cannot deadlock the stopping thread
            self._sample_queue.put_nowait(None)
        except Full:
            pass
