"""Evaluator side-job: an eval loop on a spare host consuming the
training job's flash checkpoints.

Counterpart of ``dlrover_tpu/trainer/evaluator.py`` (parity reference:
dlrover/python/master/node/worker.py:32, EvaluatorManager -- the
estimator evaluator replica -- and the eval loop it supervises). The
evaluator watches the flash checkpoint's tiers (trainer/checkpoint.py)
for new steps, restores each new state, runs a user ``eval_fn`` (on the
GPU, a forward through the flash kernels) and reports the results to
the master's custom-metric channel, into the job metric collector.

The evaluator never joins the training rendezvous: it registers as
NodeType.EVALUATOR, heartbeats like any node, and is relaunched by the
master independently of the worker fleet. No torch at import: the
state's tensors come from the checkpointer.
"""

import time
from typing import Any, Callable, Optional

from dlrover_tpu_torch.common.log import default_logger as logger


class CheckpointEvaluator:
    """Poll a FlashCheckpointer's store for new steps and evaluate.

    ``eval_fn(state, step) -> dict`` runs the user's eval (loss,
    accuracy, ...); results are reported via ``report_fn(step, results)``
    when given (typically the master client's custom-data RPC).
    """

    def __init__(
        self,
        checkpointer,
        eval_fn: Callable[[Any, int], dict],
        target: Any = None,
        report_fn: Optional[Callable[[int, dict], None]] = None,
        poll_interval: float = 10.0,
    ):
        self._ckpt = checkpointer
        self._eval_fn = eval_fn
        self._target = target
        self._report_fn = report_fn
        self._poll = poll_interval
        self._last_step: Optional[int] = None
        self._stopped = False

    def poll_once(self) -> Optional[dict]:
        """Evaluate the newest unseen checkpoint; None if nothing new."""
        step = self._ckpt.latest_step()
        if step is None or step == self._last_step:
            return None
        state, got = self._ckpt.restore(
            target=self._target, step=step
        )
        if state is None:
            return None
        self._last_step = got
        t0 = time.time()
        results = self._eval_fn(state, got)
        logger.info(
            "Evaluated step %d in %.1fs: %s", got, time.time() - t0,
            results,
        )
        if self._report_fn is not None:
            try:
                self._report_fn(got, results)
            except Exception as e:
                logger.warning("eval report failed: %s", e)
        return results

    def run(self, max_evals: Optional[int] = None,
            deadline: Optional[float] = None) -> int:
        """Loop until stopped / max_evals / deadline; returns #evals."""
        n = 0
        while not self._stopped:
            if self.poll_once() is not None:
                n += 1
                if max_evals is not None and n >= max_evals:
                    break
            if deadline is not None and time.time() > deadline:
                break
            time.sleep(self._poll)
        return n

    def stop(self):
        self._stopped = True


def run_evaluator_from_env(eval_fn, target=None, ckpt_dir: str = "",
                           poll_interval: float = 10.0,
                           max_evals: Optional[int] = None) -> int:
    """Entry for an evaluator process launched by the scaler: build the
    master client from NodeEnv (an evaluator unless the env names
    another type), report node status, wire eval results into the
    master's custom metrics, and run the loop."""
    import os

    from dlrover_tpu_torch.agent.master_client import build_master_client
    from dlrover_tpu_torch.common.constants import (
        NodeEnv,
        NodeStatus,
        NodeType,
    )
    from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer

    client = build_master_client(
        node_type=os.getenv(NodeEnv.NODE_TYPE) or NodeType.EVALUATOR)
    try:
        client.update_node_status(NodeStatus.RUNNING)
    except Exception:
        pass
    ckpt_dir = ckpt_dir or os.getenv("DLROVER_TPU_CKPT_DIR", "")
    ckpt = FlashCheckpointer(
        persist_dir=os.path.join(ckpt_dir, "persist"),
        ram_dir=os.path.join(ckpt_dir, "ram"),
        persist_interval=0,
    )

    evaluator = CheckpointEvaluator(
        ckpt, eval_fn, target=target, report_fn=report_to(client),
        poll_interval=poll_interval,
    )
    n = evaluator.run(max_evals=max_evals)
    try:
        client.update_node_status(NodeStatus.SUCCEEDED)
    except Exception:
        pass
    return n


def report_to(client) -> Callable[[int, dict], None]:
    """A ``report_fn`` that sends ``{"eval_step": step, "eval_<k>": v}``
    through the master client's custom-data RPC."""

    def report(step, results):
        client.report_custom_data({
            "eval_step": step, **{
                f"eval_{k}": v for k, v in results.items()
            },
        })

    return report
