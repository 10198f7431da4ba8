"""Model/step profiler: FLOP counting -> stats pipeline.

Counterpart of ``dlrover_tpu/trainer/profiler.py`` (parity reference:
atorch/atorch/utils/prof.py:41, AProfiler, and the TF profile extractor
the reference feeds into report_model_metric). The JAX package reads
the whole-program FLOPs of the compiled step from XLA's cost analysis,
lowering the step from shapes alone. Eager PyTorch has no compiled
program to ask, so :func:`profile_step` *runs* one forward and backward
under ``torch.utils.flop_counter.FlopCounterMode``, which counts the
matmuls (and convolutions, attention calls) that the ATen dispatcher
sees, remat recompute included: hardware FLOPs, the HFU numerator.

What the counter cannot see is a kernel called from outside ATen. The
port's flash kernels are launched through ``ctypes`` inside an
``autograd.Function``, so on the card the count leaves attention out and
is a floor, as XLA's counter leaves out the Pallas custom calls in the
JAX package (``bench.py``'s HFU caveat). On the CPU the kernels' plain
versions run as ATen einsums, and the count includes them.
:attr:`StepProfile.device` says which device counted.

The profile must leave the training state as it found it: the step
function computes gradients with ``torch.autograd.grad`` (never into
``.grad``) and takes no optimizer step; :func:`profile_step` restores
the random generators and the flash kernels' launch counts.

Two consumers:
 - ``ElasticTrainer.report_model_profile`` sends the profile to the
   master over the ``report_model_info`` RPC -> JobMetricCollector ->
   LocalStatsReporter (master/stats);
 - ``measure_step_time`` gives the wall-clock side for MFU/HFU.
"""

import os
import socket
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import default_journal

# ---------------------------------------------------------------- tuning
# Kernel-tuning events: each block-size decision writes through the
# structured event journal (telemetry/journal.py) as kind
# ``tuning.decision``, so the decisions land on the same attributable
# timeline as rendezvous/checkpoint/fault events. ``tuning_events()``
# returns them as flat dicts, read back out of the journal ring.

_TUNING_KIND = "tuning.decision"


def record_tuning_event(**fields) -> None:
    """Record one kernel-tuning decision."""
    evt = dict(fields)
    evt.setdefault("time", time.time())
    default_journal().record(_TUNING_KIND, **evt)
    logger.info("kernel tuning event: %s", evt)


def tuning_events() -> List[Dict[str, Any]]:
    """All tuning decisions made by this process, oldest first (journal
    envelope stripped)."""
    out = []
    for event in default_journal().events(_TUNING_KIND):
        evt = dict(event.get("data") or {})
        evt.setdefault("time", event["ts"])
        out.append(evt)
    return out


@dataclass
class StepProfile:
    """One train step's profile, from the FLOP counter."""

    flops: float = 0.0  # counted FLOPs per step (incl. remat recompute)
    hbm_bytes: float = 0.0  # not counted by the port (no cost analysis)
    peak_memory_bytes: float = 0.0  # the allocator's peak after the step
    param_count: int = 0
    variable_count: int = 0
    max_variable_size: int = 0
    #: the device that ran the counted step: on "cuda" the count is a
    #: floor that leaves out the hand-written flash kernels
    device: str = ""
    extra: Dict[str, float] = field(default_factory=dict)

    def to_model_info_kwargs(self, batch_size: int = 0,
                             seq_len: int = 0) -> Dict[str, Any]:
        """kwargs for MasterClient.report_model_info."""
        return dict(
            param_count=self.param_count,
            flops_per_step=self.flops,
            batch_size=batch_size,
            seq_len=seq_len,
            extra={
                "hbm_bytes": self.hbm_bytes,
                "peak_memory_bytes": self.peak_memory_bytes,
                "variable_count": self.variable_count,
                "max_variable_size": self.max_variable_size,
                "profile_device": self.device,
                **self.extra,
            },
        )


def _tensor_stats(params: Iterable[torch.Tensor]) -> Tuple[int, int, int]:
    sizes = [p.numel() for p in params]
    return (len(sizes), int(sum(sizes)), int(max(sizes, default=0)))


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def profile_step(step_fn: Callable, *args, params: Any = None,
                 **kwargs) -> StepProfile:
    """Run ``step_fn(*args, **kwargs)`` once under the FLOP counter and
    profile it.

    ``step_fn`` is one forward and backward that leaves the training
    state alone (gradients through ``torch.autograd.grad``, no
    optimizer step); see ``ElasticTrainer.report_model_profile``. The
    CPU and CUDA random generators and the flash kernels' launch counts
    (``ops.cuda.flash_attention.LAUNCHES``) are as before on return.
    ``params`` (a module, a tensor tree or an iterable of tensors) fills
    the tensor statistics and names the device."""
    from dlrover_tpu_torch.ops.cuda import flash_attention

    if isinstance(params, torch.nn.Module):
        params = list(params.parameters())
    tensors = _tensors(params) if params is not None else []
    if not tensors:
        tensors = _tensors(list(args) + list(kwargs.values()))
    device = tensors[0].device if tensors else torch.device("cpu")
    launches = dict(flash_attention.LAUNCHES)
    cuda_devices = [device] if device.type == "cuda" else []
    counter = FlopCounterMode(display=False)
    try:
        with torch.random.fork_rng(devices=cuda_devices), counter:
            step_fn(*args, **kwargs)
        if cuda_devices:
            torch.cuda.synchronize(device)
    finally:
        flash_attention.LAUNCHES.update(launches)
    prof = StepProfile(flops=float(counter.get_total_flops()),
                       device=device.type)
    if cuda_devices:
        prof.peak_memory_bytes = float(
            torch.cuda.max_memory_allocated(device))
    if params is not None:
        (prof.variable_count, prof.param_count,
         prof.max_variable_size) = _tensor_stats(tensors)
    return prof


def measure_step_time(run_once: Callable[[], Any], steps: int = 10,
                      warmup: int = 2) -> float:
    """Mean wall-clock seconds per step. ``run_once`` returns a tensor;
    on the card the timing waits for its device
    (``torch.cuda.synchronize``) after the warm-up and after the steps."""

    def sync(out):
        for t in _tensors(out):
            if t.is_cuda:
                torch.cuda.synchronize(t.device)

    out = None
    for _ in range(warmup):
        out = run_once()
    sync(out)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = run_once()
    sync(out)
    return (time.perf_counter() - t0) / steps


def utilization(flops_per_step: float, step_time_s: float,
                peak_flops: float) -> float:
    """Percent of peak: ``100 * (flops/step / step_time) / peak``.

    Feed it analytic model flops for MFU, or the counted hardware flops
    from :class:`StepProfile` (remat recompute included) for HFU — same
    wall-clock denominator, so the two are directly comparable."""
    if step_time_s <= 0 or peak_flops <= 0:
        return 0.0
    return 100.0 * (flops_per_step / step_time_s) / peak_flops


def report_profile(master_client, prof: StepProfile,
                   batch_size: int = 0, seq_len: int = 0) -> bool:
    """Send the profile to the master's stats pipeline; False on error
    (profiling must never take training down)."""
    try:
        master_client.report_model_info(
            **prof.to_model_info_kwargs(batch_size, seq_len)
        )
        return True
    except Exception as e:
        logger.warning("report_model_info failed: %s", e)
        return False


class TraceCapture:
    """Timeline capture around training steps (parity role: AProfiler's
    timeline export, atorch/atorch/utils/prof.py, and the reference's
    torch-profiler trace dumps): wraps ``torch.profiler`` so a window of
    steps lands in a Chrome trace file (``trace-<host>-<pid>-<n>.json``)
    in the trace directory, loadable in Perfetto / chrome://tracing.
    The card's kernels are traced where a CUDA device is present.

    Usage::

        with TraceCapture("/tmp/trace", start_step=10, num_steps=3) as tc:
            for step in range(100):
                run_step()
                tc.step(step)

    Or drive it manually with start()/stop(). Env trigger for zero-code
    capture: DLROVER_TRACE_DIR [+ DLROVER_TRACE_START/_STEPS].
    """

    def __init__(self, trace_dir: str, start_step: int = 1,
                 num_steps: int = 3):
        self._dir = trace_dir
        self._start = start_step
        self._stop_after = start_step + num_steps
        self._prof = None
        self._windows = 0
        self._atexit_registered = False
        #: the trace files written so far
        self.paths: List[str] = []

    @classmethod
    def from_env(cls) -> "TraceCapture | None":
        trace_dir = os.environ.get("DLROVER_TRACE_DIR", "")
        if not trace_dir:
            return None
        return cls(
            trace_dir,
            start_step=int(os.environ.get("DLROVER_TRACE_START", "1")),
            num_steps=int(os.environ.get("DLROVER_TRACE_STEPS", "3")),
        )

    def start(self):
        if self._prof is not None:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        # a window still open when the process ends (short run,
        # restart action mid-window) must still flush the trace.
        # Registered ONCE per capture object: stop() is idempotent
        if not self._atexit_registered:
            import atexit

            atexit.register(self.stop)
            self._atexit_registered = True
        logger.info("Trace capture started -> %s", self._dir)

    def stop(self):
        prof, self._prof = self._prof, None
        if prof is None:
            return
        prof.__exit__(None, None, None)
        os.makedirs(self._dir, exist_ok=True)
        path = os.path.join(
            self._dir,
            f"trace-{socket.gethostname()}-{os.getpid()}-"
            f"{self._windows}.json",
        )
        self._windows += 1
        prof.export_chrome_trace(path)
        self.paths.append(path)
        logger.info("Trace capture written to %s", path)

    def step(self, step: int):
        """Call once per completed step; starts/stops the window."""
        if step >= self._start and self._prof is None and (
                step < self._stop_after):
            self.start()
        elif step >= self._stop_after and self._prof is not None:
            self.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
