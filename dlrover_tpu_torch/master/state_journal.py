"""Durable master job-state journal.

The distributed master holds the whole job's coordination state in
memory — the shard todo/doing ledger, the bootstrap KV store, rendezvous
round counters, the speed monitor's global step. A master pod eviction
therefore used to end the run even though every worker was healthy. This
module write-through-journals that state into the pluggable
``util/state_store.py`` FileStore (parity: the reference's
``util/state/store_mananger.py`` kept exactly this door open), so a
restarted master resumes the job behind the workers' reconnect
supervision instead of restarting it.

Layout under the state dir (one JSON file per key):

    master/<job>/meta                 {"job_name": ..., "saved_at": ...}
    master/<job>/dataset/<name>/params      raw shard params (rebuild splitter)
    master/<job>/dataset/<name>/checkpoint  DatasetShardCheckpoint JSON
    master/<job>/kv                   KV store contents (latin-1 strings)
    master/<job>/rdzv/<name>          {"round": n}
    master/<job>/rdzv_params/<name>   {"min_nodes": ..., "max_nodes": ...}
    master/<job>/speed                {"step": n, "batch_feed": bool}
    master/<job>/goodput              goodput aggregator ledger checkpoint

Enabled by ``DLROVER_TPU_MASTER_STATE_DIR`` (or ``--state_dir``); off by
default. ``--fresh`` wipes the job's prior state instead of restoring.

Group commit: at fleet scale the per-event write-through
melts the master — every KV mutation snapshots the whole KV map to
disk, every step/goodput advance is another fsync. The journal now
carries a write-behind commit lane (same shape as the shard dispatcher's
group commit in ``shard/task_manager.py``): mutations are staged
per-key (last writer wins) and flushed within
``DLROVER_TPU_JOURNAL_FLUSH_WINDOW`` seconds as ONE FileStore
transaction (redo-log ``set_many``), so journal commits/sec is bounded
by the window, not the report rate. Paths whose exactly-once argument
requires commit-before-reply — the shard ledger — keep write-through
ordering; any lane write can opt back in with ``durable=True``, which
flushes the lane (including that write) before returning.

Counterpart of ``dlrover_tpu/master/state_journal.py``, under the same names.
"""

import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry.journal import record
from dlrover_tpu_torch.telemetry.registry import counter
from dlrover_tpu_torch.util.state_store import StateBackend, build_state_store

ENV_STATE_DIR = "DLROVER_TPU_MASTER_STATE_DIR"
#: write-behind coalescing window (seconds) for non-ledger state; 0
#: disables the lane (write-through, as before group commit)
ENV_FLUSH_WINDOW = "DLROVER_TPU_JOURNAL_FLUSH_WINDOW"
DEFAULT_FLUSH_WINDOW_S = 0.05


def _safe_name(name: str) -> str:
    """Job/dataset names become path components in the FileStore."""
    return re.sub(r"[^A-Za-z0-9._-]", "_", name) or "job"


class MasterStateJournal:
    """Persistence for one job's recoverable master state: write-through
    for the shard ledger, write-behind group commit (when
    ``commit_window > 0``) for everything else."""

    def __init__(self, store: StateBackend, job_name: str,
                 commit_window: float = 0.0):
        self._store = store
        self._prefix = f"master/{_safe_name(job_name)}"
        self._job_name = job_name
        self._window = max(0.0, float(commit_window))
        # staged lane mutations, last writer wins per key
        self._pending: Dict[str, Any] = {}
        self._mutex = threading.Lock()
        self._wake_cv = threading.Condition(self._mutex)
        # serializes actual store commits so a durable flush can't be
        # overtaken by an in-flight lane flush carrying a stale value
        self._commit_lock = threading.Lock()
        self._events = 0
        self._commits = 0
        self._closed = False
        self._flusher: Optional[threading.Thread] = None
        if self._window > 0:
            self._flusher = threading.Thread(
                target=self._flush_loop,
                name="journal-commit-lane",
                daemon=True,
            )
            self._flusher.start()

    def _key(self, *parts: str) -> str:
        return "/".join((self._prefix,) + parts)

    # --------------------------------------------------- group-commit lane

    @property
    def coalescing(self) -> bool:
        """True when the write-behind lane is on — callers holding
        their own per-event rate limits (the 1/s step throttle) can
        drop them and let the lane do the coalescing."""
        return self._window > 0

    def _put(self, key: str, value: Any, durable: bool = False):
        """Stage one lane mutation. ``durable=True`` (or lane off)
        commits before returning — the escape hatch for replies whose
        exactly-once argument needs the state on disk first."""
        if self._window <= 0:
            with self._commit_lock:
                self._store.set(key, value)
                self._events += 1
                self._commits += 1
            return
        with self._wake_cv:
            self._pending[key] = value
            self._events += 1
            counter(
                "dlrover_journal_events_total",
                "state mutations staged on the journal commit lane",
            ).inc()
            if not durable:
                self._wake_cv.notify()
        if durable:
            self.flush()

    def _get(self, key: str, default: Any = None) -> Any:
        # read-your-writes: a staged value is the newest value
        with self._mutex:
            if key in self._pending:
                return self._pending[key]
        return self._store.get(key, default)

    def _keys(self, prefix: str) -> List[str]:
        with self._mutex:
            staged = [k for k in self._pending if k.startswith(prefix)]
        return sorted(set(self._store.keys(prefix)) | set(staged))

    def _flush_loop(self):
        while True:
            with self._wake_cv:
                while not self._pending and not self._closed:
                    self._wake_cv.wait(timeout=1.0)
                if self._closed and not self._pending:
                    return
            if not self._closed:
                # the coalescing window: absorb the burst before
                # paying for one commit
                time.sleep(self._window)
            self.flush()

    def flush(self):
        """Commit everything staged as one FileStore transaction. On a
        store error the batch is retained (newer stages win) and
        retried next window — the lane must not die mid-run."""
        with self._commit_lock:
            with self._mutex:
                batch = dict(self._pending)
                self._pending.clear()
            if not batch:
                return
            try:
                self._store.set_many(batch)
            except Exception as e:  # noqa: BLE001 — keep the lane alive
                with self._mutex:
                    for k, v in batch.items():
                        self._pending.setdefault(k, v)
                logger.warning("journal group commit failed (%s); "
                               "retaining %d key(s)", e, len(batch))
                return
            self._commits += 1
            counter(
                "dlrover_journal_commits_total",
                "FileStore transactions committed by the journal",
            ).inc()

    def commit_stats(self) -> Dict[str, int]:
        """events = mutations staged; commits = store transactions.
        events/commits is the coalescing ratio the swarm bench gates."""
        with self._mutex:
            return {"events": self._events, "commits": self._commits}

    def close(self):
        """Stop the lane and commit whatever is staged."""
        with self._wake_cv:
            self._closed = True
            self._wake_cv.notify_all()
        if self._flusher is not None:
            self._flusher.join(timeout=5.0)
            self._flusher = None
        self.flush()

    # ------------------------------------------------------------ lifecycle

    def has_state(self) -> bool:
        return bool(self._keys(self._prefix + "/"))

    def clear(self):
        with self._mutex:
            self._pending.clear()
        for key in self._store.keys(self._prefix + "/"):
            self._store.delete(key)

    def mark_started(self):
        self._store.set(
            self._key("meta"),
            {"job_name": self._job_name, "saved_at": time.time()},
        )

    # ------------------------------------------------------- dataset ledger

    def save_dataset_params(self, name: str, params: dict):
        self._store.set(self._key("dataset", _safe_name(name), "params"),
                        params)

    def save_dataset_checkpoint(self, name: str, checkpoint_json: str):
        self._store.set(
            self._key("dataset", _safe_name(name), "checkpoint"),
            checkpoint_json,
        )

    def saved_datasets(self) -> List[str]:
        """Dataset names (as persisted in params) with saved state."""
        names = []
        prefix = self._key("dataset") + "/"
        for key in self._keys(prefix):
            if key.endswith("/params"):
                params = self._get(key) or {}
                name = params.get("dataset_name")
                if name:
                    names.append(name)
        return sorted(set(names))

    def load_dataset(self, name: str) -> Tuple[Optional[dict],
                                               Optional[str]]:
        safe = _safe_name(name)
        params = self._store.get(self._key("dataset", safe, "params"))
        ckpt = self._store.get(self._key("dataset", safe, "checkpoint"))
        return params, ckpt

    # ------------------------------------------------------------- KV store

    def save_kv(self, data: Dict[str, bytes], durable: bool = False):
        # JSON can't carry bytes: latin-1 maps every byte 1:1 to a
        # codepoint, round-tripping arbitrary values losslessly
        self._put(
            self._key("kv"),
            {k: v.decode("latin-1") for k, v in data.items()},
            durable=durable,
        )

    def load_kv(self) -> Dict[str, bytes]:
        data = self._get(self._key("kv")) or {}
        return {k: v.encode("latin-1") for k, v in data.items()}

    # ----------------------------------------------------------- rendezvous

    def save_rdzv_round(self, rdzv_name: str, rdzv_round: int,
                        durable: bool = False):
        self._put(
            self._key("rdzv", _safe_name(rdzv_name)),
            {"round": int(rdzv_round)},
            durable=durable,
        )

    def load_rdzv_rounds(self) -> Dict[str, int]:
        rounds = {}
        prefix = self._key("rdzv") + "/"
        for key in self._keys(prefix):
            value = self._get(key) or {}
            rounds[key[len(prefix):]] = int(value.get("round", 0))
        return rounds

    def save_rdzv_params(self, rdzv_name: str, params: dict,
                         durable: bool = False):
        """min/max nodes, waiting timeout, node unit — without them a
        restarted master can never complete a round (completion is
        gated on params having been reported)."""
        self._put(
            self._key("rdzv_params", _safe_name(rdzv_name)), params,
            durable=durable,
        )

    def load_rdzv_params(self) -> Dict[str, dict]:
        out = {}
        prefix = self._key("rdzv_params") + "/"
        for key in self._keys(prefix):
            value = self._get(key)
            if value:
                out[key[len(prefix):]] = value
        return out

    # ---------------------------------------------------------- global step

    def save_global_step(self, step: int, batch_feed: bool = False,
                         durable: bool = False):
        self._put(
            self._key("speed"),
            {"step": int(step), "batch_feed": bool(batch_feed)},
            durable=durable,
        )

    def load_global_step(self) -> Tuple[int, bool]:
        value = self._get(self._key("speed")) or {}
        return int(value.get("step", 0)), bool(value.get("batch_feed"))

    # -------------------------------------------------------------- goodput

    def save_goodput(self, state: dict, durable: bool = False):
        """The goodput aggregator's ledger checkpoint
        (telemetry/goodput.py to_state()): per-incarnation phase
        totals + fault windows. Restoring it after a master kill keeps
        MTTR/MTBF honest across the restart — the persist gap itself
        becomes the master's own fault window."""
        self._put(self._key("goodput"), state, durable=durable)

    def load_goodput(self) -> Optional[dict]:
        return self._get(self._key("goodput"))


def _flush_window() -> float:
    raw = os.getenv(ENV_FLUSH_WINDOW, "")
    if not raw:
        return DEFAULT_FLUSH_WINDOW_S
    try:
        return max(0.0, float(raw))
    except ValueError:
        return DEFAULT_FLUSH_WINDOW_S


def build_master_state_journal(
    job_name: str,
    state_dir: Optional[str] = None,
    fresh: bool = False,
    commit_window: Optional[float] = None,
) -> Optional[MasterStateJournal]:
    """Build the journal when a state dir is configured; None otherwise.

    ``fresh=True`` wipes the job's prior state (deliberate restart from
    scratch against a dirty state dir). ``commit_window`` overrides the
    env-configured group-commit window (0 = write-through)."""
    state_dir = state_dir or os.getenv(ENV_STATE_DIR, "")
    if not state_dir:
        return None
    store = build_state_store("file", state_dir)
    recovered = getattr(store, "recovered_txn_keys", [])
    if recovered:
        # an interrupted group commit was replayed to its post-batch
        # state by the FileStore redo log — surface it for the drills
        record("control.journal_recovered", keys=len(recovered))
        store.recovered_txn_keys = []  # the singleton outlives us
    window = _flush_window() if commit_window is None else commit_window
    journal = MasterStateJournal(store, job_name, commit_window=window)
    if fresh and journal.has_state():
        logger.info(
            "--fresh: discarding prior master state for job %r under %s",
            job_name, state_dir,
        )
        journal.clear()
    return journal
