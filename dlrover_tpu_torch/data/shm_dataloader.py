"""Coworker data loading over the native shm ring, and device prefetch
on a CUDA copy stream.

Counterpart of ``dlrover_tpu/data/shm_dataloader.py``.
``_producer_main`` and ``ShmDataLoader`` are copies: coworker PROCESSES
(spawn context) produce batches into the C++ ring, and the trainer
iterates them. ``DevicePrefetch`` keeps ``depth`` batches staged on the
GPU: where the JAX one relies on ``jax.device_put`` being asynchronous,
this one copies each batch from page-locked host memory with
``non_blocking`` copies on a CUDA stream of its own, records an event
per batch, and the consuming iterator makes the current stream wait on
that event and marks every tensor with ``record_stream`` before it
hands the batch on. ``device`` takes the place of JAX's ``sharding``.

This module imports torch only inside ``DevicePrefetch``: the spawned
producers unpickle ``_producer_main`` from here, and must neither pay a
torch import nor ever make a CUDA context.
"""

import multiprocessing as mp
import os
import threading
import time
from queue import Empty, Queue
from typing import Any, Callable, Iterable, Iterator, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.data.shm_ring import SEGMENT_PREFIX, RingClosed, ShmRing


def _producer_main(ring_name: str, dataset_fn, worker_id: int,
                   num_workers: int, pre_sharded: bool):
    """Runs in a coworker process: iterate dataset_fn(), push batches.

    With ``pre_sharded`` each worker's dataset_fn already yields a
    disjoint stream (e.g. master-coordinated shards via ShardingClient)
    and the round-robin filter is skipped. A failure exits the process
    with code 1, which the loader's watcher turns into an error in the
    consumer (the JAX producer logs it and exits 0, and the epoch ends
    early without a word)."""
    ring = ShmRing.attach(ring_name)
    try:
        for i, batch in enumerate(dataset_fn()):
            if not pre_sharded and i % num_workers != worker_id:
                continue
            ring.push(batch)
    except RingClosed:
        pass
    except Exception:
        logger.exception("shm producer %d failed", worker_id)
        raise SystemExit(1)


class ShmDataLoader:
    """Iterate batches produced by coworker processes over the shm ring.

    ``dataset_fn`` must be a picklable zero-arg callable returning an
    iterable of batches (numpy arrays / tuples / pytrees). It must be
    defined in a module that imports no torch: each coworker imports
    that module (and, under spawn, the parent's ``__main__``). A
    producer that fails or dies before the loader is closed ends the
    stream with a ``RuntimeError`` in the consumer, after the batches
    already in the ring.
    """

    def __init__(
        self,
        dataset_fn: Callable[[], Iterable],
        num_workers: int = 1,
        slot_bytes: int = 64 << 20,
        num_slots: int = 8,
        name: Optional[str] = None,
        pre_sharded: bool = False,
    ):
        # pid + random suffix: id(self) repeats across processes, and
        # create() unlinks same-named stale segments -- two jobs on one
        # host must never collide on the default name. The pid lets the
        # agent unlink the rings of a worker that died holding them.
        default_name = (
            f"/{SEGMENT_PREFIX}{os.getpid():x}_{os.urandom(4).hex()}"
        )
        self._ring = ShmRing(
            name or default_name,
            slot_bytes=slot_bytes, num_slots=num_slots, create=True,
        )
        #: why the stream failed (a producer's exit), raised at its end
        self._failure: Optional[str] = None
        self._closing = False
        ctx = mp.get_context("spawn")
        self._procs = [
            ctx.Process(
                target=_producer_main,
                args=(self._ring.name, dataset_fn, w, num_workers,
                      pre_sharded),
                daemon=True,
            )
            for w in range(num_workers)
        ]
        #: when the producers were started (``time.perf_counter``)
        self.started_at = time.perf_counter()
        for p in self._procs:
            p.start()
        self._watcher = threading.Thread(
            target=self._close_when_done, daemon=True,
            name="shm-ring-watcher",
        )
        self._watcher.start()

    @property
    def ring_name(self) -> str:
        return self._ring.name

    @property
    def pids(self) -> List[int]:
        """The coworker processes' pids."""
        return [p.pid for p in self._procs]

    @property
    def in_ring(self) -> int:
        """Batches pushed and not yet popped."""
        return len(self._ring)

    def _close_when_done(self):
        from multiprocessing.connection import wait

        pending = {p.sentinel: (w, p) for w, p in enumerate(self._procs)}
        while pending:
            for sentinel in wait(list(pending)):
                w, p = pending.pop(sentinel)
                p.join()
                if (p.exitcode != 0 and not self._closing
                        and self._failure is None):
                    self._failure = (f"shm producer {w} (pid {p.pid}) "
                                     f"exited with code {p.exitcode}")
                    logger.error("%s; closing the ring", self._failure)
                    self._ring.close()
        self._ring.close()  # EOF after every producer finished

    def __iter__(self) -> Iterator[Any]:
        while True:
            try:
                yield self._ring.pop()
            except RingClosed:
                if self._failure is not None:
                    raise RuntimeError(self._failure)
                return

    def close(self):
        """EOF the ring: blocked consumers drain and see RingClosed."""
        self._closing = True
        self._ring.close()

    def shutdown(self, destroy: bool = True):
        self._closing = True
        self._ring.close()
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=5.0)
        # the watcher thread calls ring.close() after the producers
        # exit; let it finish before unmapping the ring under it
        self._watcher.join(timeout=10.0)
        if destroy:
            if self._watcher.is_alive():
                logger.error(
                    "shm watcher still alive; leaking ring %s instead "
                    "of unmapping under a live thread", self._ring.name,
                )
                return
            self._ring.destroy()


def _map_arrays(fn, tree):
    """``fn`` over the numpy arrays and tensors of a tree of tuples,
    lists and dicts; every other leaf (a shard's row range, a step
    number) is kept as it is, on the host."""
    import numpy as np
    import torch

    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_arrays(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map_arrays(fn, v) for k, v in tree.items()}
    return tree


def _tensors(tree) -> List[Any]:
    out = []
    _map_arrays(out.append, tree)
    return out


class DevicePrefetch:
    """Wrap a batch iterator, keeping ``depth`` batches staged on
    ``device`` (parity: GpuPreLoader preloader.py:8, the CUDA-stream H2D
    overlap).

    ``device``: ``None`` is ``"cuda"`` (the current GPU), and raises
    without one; ``"cpu"`` copies on the host (the tests). On a GPU a
    fill thread pins each array of a batch (the caching host allocator's
    page-locked memory) and copies it with ``non_blocking=True`` under a
    copy stream of this prefetcher's own, then records an event; the
    consuming iterator makes the current stream wait on the event and
    calls ``record_stream(current_stream)`` on each tensor, so the step
    reads the batch only after it has landed, and the allocator does not
    hand its memory to a later batch while the step still reads it.
    numpy arrays and tensors are staged; other leaves pass through.

    ``transform`` (e.g. the trainer's microbatch reshape and the token
    cast) runs on the fill thread, between fetching a batch from the
    source (span ``data.fetch``) and staging it (span ``data.stage``,
    the transform included). An exception of the source, the transform
    or the copy is re-raised in the CONSUMING iterator instead of
    truncating the epoch into a silent EOF."""

    def __init__(self, it: Iterable, depth: int = 2, device=None,
                 transform: Optional[Callable[[Any], Any]] = None):
        import torch

        self._device = torch.device("cuda" if device is None else device)
        self._stream = None
        if self._device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DevicePrefetch: no CUDA device (pass device='cpu' "
                    "to stage on the host)")
            if self._device.index is None:
                self._device = torch.device(
                    "cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(device=self._device)
        self._it = iter(it)
        self._depth = depth
        self._transform = transform
        self._queue: "Queue" = Queue(maxsize=depth)
        self._done = object()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._fill, daemon=True, name="prefetch-fill"
        )
        self._thread.start()

    @property
    def device(self):
        return self._device

    def _stage(self, batch):
        """(batch with its arrays on the device, the copy's event or
        None)."""
        import torch

        def host(x):
            return torch.as_tensor(x) if not torch.is_tensor(x) else x

        if self._stream is None:
            return _map_arrays(
                lambda x: host(x).to(self._device, copy=True), batch), None

        def copy(x):
            t = host(x)
            if t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            return t.to(self._device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            staged = _map_arrays(copy, batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event

    def _fill(self):
        from dlrover_tpu_torch.telemetry import tracing

        try:
            while True:
                with tracing.span("data.fetch"):
                    try:
                        batch = next(self._it)
                    except StopIteration:
                        break
                with tracing.span("data.stage"):
                    if self._transform is not None:
                        batch = self._transform(batch)
                    staged = self._stage(batch)
                self._queue.put(staged)
        except BaseException as e:
            self._error = e
        finally:
            self._queue.put(self._done)

    def _check_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _ready(self, item):
        staged, event = item
        if event is not None:
            import torch

            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in _tensors(staged):
                if t.device.type == "cuda":
                    t.record_stream(current)
        return staged

    def __iter__(self):
        while True:
            try:
                item = self._queue.get(timeout=0.5)
            except Empty:
                # resilient to a swallowed _done sentinel (join()'s
                # drain) -- a dead fill thread means the stream is over
                if not self._thread.is_alive():
                    self._check_error()
                    return
                continue
            if item is self._done:
                self._check_error()
                return
            yield self._ready(item)

    def join(self, timeout: float = 10.0) -> bool:
        """Wait for the fill thread to exit (it does once the source
        iterator ends, e.g. after the shm ring is closed). MUST be
        called before destroying a ring this prefetcher reads: pop()
        runs in this thread against the ring's mapping, and unmapping
        under it is a native crash, not an exception. Drains the queue
        while waiting so a fill thread blocked in put() (consumer
        stopped early) can reach the source's EOF. Returns False if the
        thread is still alive at the deadline -- the caller must then
        NOT unmap the source."""
        deadline = time.monotonic() + timeout
        while self._thread.is_alive():
            if time.monotonic() > deadline:
                return False
            try:
                self._queue.get_nowait()
            except Empty:
                pass
            self._thread.join(timeout=0.05)
        return True
