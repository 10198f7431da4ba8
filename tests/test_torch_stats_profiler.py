"""The master's job metric collector and its reporters, the device
memory monitor, and the worker's step profile, in the port.

The collector and the reporters get the same inputs as the JAX
package's and must store equal metrics (cases of
``tests/test_stats_pipeline.py`` run once per package too); the
resource monitor publishes the same gauges and peak events as the JAX
one from the same samples; ``report_model_info``,
``report_custom_data`` and ``report_goodput`` go through a real
loopback master into its collector and aggregator; ``profile_step`` on
``llama_tiny`` counts the analytic matmul FLOPs of forward, backward and
remat recompute exactly, and leaves the training state, the random
generators and the flash kernels' launch counts bitwise as they were;
``TraceCapture`` writes a Chrome trace."""

import dataclasses
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from dlrover_tpu import telemetry as jax_telemetry
from dlrover_tpu.agent.monitor import resource as jax_resource
from dlrover_tpu.common.node import Node as JaxNode
from dlrover_tpu.master import stats as jax_stats
from dlrover_tpu.master.monitor.speed_monitor import (
    SpeedMonitor as JaxSpeedMonitor,
)
from dlrover_tpu.telemetry.journal import EventJournal as JaxEventJournal
from dlrover_tpu_torch import telemetry
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.monitor import resource
from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master import stats
from dlrover_tpu_torch.master.local_master import LocalJobMaster
from dlrover_tpu_torch.master.monitor.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops.cuda import flash_attention as fa
from dlrover_tpu_torch.telemetry import goodput
from dlrover_tpu_torch.telemetry.journal import EventJournal
from dlrover_tpu_torch.trainer import profiler
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.sharded import adamw, make_trainer_for_llama

from tests.test_torch_control_plane import PACKAGES, run_repointed

T0 = 1_700_000_000.0

STATS_CASES = [
    "test_runtime_stats_sampled_on_step_advance",
    "test_model_and_dataset_metrics_stored",
    "test_batch_done_feed_defers_to_step_reports",
    "test_runtime_stats_throttled_by_time",
]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("name", STATS_CASES)
def test_jax_stats_case_in_both_packages(name, pkg, request):
    run_repointed("test_stats_pipeline.py", pkg, name, request)


# ------------------------------------------------------------ collector

PKG = {
    "dlrover_tpu": (jax_stats, JaxSpeedMonitor, JaxNode),
    "dlrover_tpu_torch": (stats, SpeedMonitor, Node),
}


class _Broken:
    """A reporter whose every call fails: the tee must go on."""

    def __getattr__(self, name):
        def fail(*args):
            raise RuntimeError(f"{name} down")
        return fail


def _feed(pkg, seed: int):
    st, monitor_cls, node_cls = PKG[pkg]
    meta = st.JobMeta(uuid="job-u", name="job")
    primary = st.LocalStatsReporter(meta)
    secondary = st.LocalStatsReporter(meta)
    tee = st.reporter.TeeStatsReporter(meta, [primary, _Broken(),
                                              secondary])
    collector = st.JobMetricCollector(meta, tee, min_sample_interval=0.0)
    rng = np.random.default_rng(seed)
    sm = monitor_cls()
    nodes = [node_cls(NodeType.WORKER, i, status="running")
             for i in range(3)]
    for i in range(3):
        sm.add_running_worker(NodeType.WORKER, i)
    collector.collect_dataset_metric("corpus", int(rng.integers(1e6)))
    collector.collect_training_hyper_params(epoch=2, batch_size=24)
    collector.collect_model_metric(types.SimpleNamespace(
        param_count=1_100_048_384,
        flops_per_step=float(rng.uniform(1e12, 1e13)),
        batch_size=3, seq_len=2048,
        extra={"hbm_bytes": 0.0, "peak_memory_bytes": 1.5e10,
               "variable_count": 201, "max_variable_size": 65_536_000}))
    step, ts = 0, T0
    for _ in range(20):
        step += int(rng.integers(0, 4))
        ts += float(rng.uniform(0.1, 2.0))
        sm.collect_global_step(step, ts)
        collector.collect_runtime_stats(
            sm, (lambda: nodes) if rng.random() < 0.5 else nodes)
    collector.collect_custom_data("recovery_seconds", 25.3)
    collector.collect_custom_metrics({"eval_loss": 5.4, "step": step})
    collector.collect_job_exit_reason("succeeded")

    def stored(r):
        return {
            "dataset": dataclasses.asdict(r.dataset_metric),
            "hyper": dataclasses.asdict(r.hyper_params),
            "model": dataclasses.asdict(r.model_metric),
            "runtime": [dataclasses.asdict(m) for m in r.runtime_stats],
            "exit": r.exit_reason, "custom": dict(r.custom_data),
            "by_workers": r.speed_samples_by_worker_num(),
        }

    return stored(primary), stored(secondary)


@pytest.mark.parametrize("seed", [0, 1])
def test_collector_and_reporters_store_what_jax_stores(seed, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)
    want = _feed("dlrover_tpu", seed)
    got = _feed("dlrover_tpu_torch", seed)
    assert got == want
    primary, secondary = got
    assert primary == secondary  # the broken reporter between them
    assert primary["runtime"] and primary["model"]["op_stats"]["flops"] > 0


def test_the_brain_reporter_is_not_ported():
    with pytest.raises(NotImplementedError):
        stats.StatsReporter.new_stats_reporter(stats.JobMeta(),
                                               reporter="brain")


# ------------------------------------------------------ resource monitor


def _monitor_run(pkg, probe_name, samples, monkeypatch):
    mod, tel, journal_cls = {
        "dlrover_tpu": (jax_resource, jax_telemetry, JaxEventJournal),
        "dlrover_tpu_torch": (resource, telemetry, EventJournal),
    }[pkg]
    reg = tel.set_default_registry(None)
    jr = tel.set_default_journal(journal_cls(None))
    it = iter(samples)
    monkeypatch.setattr(mod, probe_name, lambda: next(it))
    monkeypatch.setattr(mod, "get_process_cpu_percent", lambda: 12.5)
    monkeypatch.setattr(mod, "get_used_memory_mb", lambda: 2048)
    reports = []
    client = types.SimpleNamespace(
        report_used_resource=lambda *a: reports.append(a))
    kwargs = ({"collect_tpu": True} if pkg == "dlrover_tpu"
              else {"collect_device": True})
    mon = mod.ResourceMonitor(client, **kwargs)
    for _ in samples:
        mon.report_resource()
    peaks = [e["data"] for e in jr.events("resource.hbm_peak")]
    out = (reg.to_dict(), peaks, reports)
    tel.set_default_registry(None)
    tel.set_default_journal(journal_cls(None))
    return out


def test_resource_monitor_publishes_what_jax_publishes(monkeypatch):
    samples = [
        [{"device": "cuda:0", "bytes_in_use": 100, "bytes_limit": 1000,
          "peak_bytes_in_use": 0}],
        [{"device": "cuda:0", "bytes_in_use": 50, "bytes_limit": 1000,
          "peak_bytes_in_use": 400}],
        [{"device": "cuda:0", "bytes_in_use": 30, "bytes_limit": 1000,
          "peak_bytes_in_use": 0}],
    ]
    want = _monitor_run("dlrover_tpu", "get_tpu_stats", samples,
                        monkeypatch)
    got = _monitor_run("dlrover_tpu_torch", "get_device_stats", samples,
                       monkeypatch)
    assert got == want
    assert [e["bytes"] for e in got[1]] == [100, 400]


def test_the_device_probe_reads_the_allocator_and_only_on_a_card():
    stats_now = resource.get_device_stats()
    if not torch.cuda.is_available():
        assert stats_now == []
        return
    x = torch.empty(1 << 20, device="cuda")
    s = resource.get_device_stats()[0]
    assert s["bytes_in_use"] == torch.cuda.memory_allocated(0)
    assert s["peak_bytes_in_use"] == torch.cuda.max_memory_allocated(0)
    del x


# ---------------------------------------------------- loopback master


def test_model_info_custom_data_and_goodput_reach_a_loopback_master(
        monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_METRICS_PORT", "off")
    goodput.reset_default_ledger()
    master = LocalJobMaster(port=0)
    master.prepare()
    client = MasterClient(master.addr, node_id=0,
                          node_type=NodeType.WORKER)
    try:
        client.update_node_status("running")
        t = time.time()
        client.report_global_step(50, t)
        client.report_global_step(100, t + 10)
        client.report_model_info(
            param_count=123, flops_per_step=4.5e9, batch_size=8,
            seq_len=128, extra={"peak_memory_bytes": 1e9,
                                "profile_device": "cpu"})
        client.report_custom_data({"eval_loss": 1.5, "step": 100})
        assert client.report_goodput(final=True) is None  # no ledger
        goodput.install()
        client.report_global_step(105, t + 11)
        client.report_goodput(final=True)
        reporter = master.stats_reporter
        assert reporter.runtime_stats[-1].global_step >= 100
        assert reporter.model_metric.op_stats.flops == 4.5e9
        assert reporter.model_metric.op_stats.peak_memory_bytes == 1e9
        assert reporter.model_metric.seq_len == 128
        assert {k: reporter.custom_data[k] for k in ("eval_loss", "step")
                } == {"eval_loss": 1.5, "step": 100}
        account = master.goodput_aggregator.summary()
        assert account["job"]["procs"] == 1
        assert goodput.http_payload()["job"] == account["job"]
        proc = master.goodput_aggregator.to_state()["procs"][
            f"0:{os.getpid()}"]
        assert proc["final_seen"]
    finally:
        client.close()
        master.stop()
        goodput.reset_default_ledger()
    assert goodput.http_payload().get("job") is None  # provider cleared


# ----------------------------------------------------------- profile_step

B, S = 2, 64


def _trainer(remat: str, loss_chunk: int, seed: int = 0):
    cfg = llama.llama_tiny(remat=remat, loss_chunk=loss_chunk)
    trainer = make_trainer_for_llama(cfg, device="cpu",
                                     optimizer=adamw(1e-3))
    trainer.init(seed=seed)
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int64)
    batch = trainer.shard_batch(trainer.microbatch((tokens, tokens)))
    return cfg, trainer, batch


def _analytic_flops(cfg, remat: str, loss_chunk: int) -> float:
    """Matmul FLOPs (2 per multiply-add) of one step: each matmul once
    forward and twice backward (input and weight gradients), plus what
    the remat policy runs again: attention's two products under "dots"
    (its matmul outputs are the only saved tensors), every product of
    the block but its last under "minimal" (a non-reentrant checkpoint
    stops its recompute at the last tensor the backward needs, and no
    backward needs w_down's output), and the lm_head's with a chunked
    loss."""
    h, m, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tokens = B * S
    linear = cfg.num_layers * 2 * tokens * (
        h * nh * hd + 2 * h * nkv * hd + nh * hd * h + 3 * h * m)
    # the plain attention on the CPU: S = QK^T and PV over whole rows
    attention = cfg.num_layers * 2 * 2 * B * nh * S * S * hd
    head = 2 * tokens * h * v
    w_down = cfg.num_layers * 2 * tokens * m * h
    redo = {"dots_attn_out": 0, "dots": attention,
            "minimal": attention + linear - w_down}[remat]
    if loss_chunk:
        redo += head
    return 3 * (linear + attention + head) + redo


def _state(trainer):
    st = trainer.train_state()
    flat = {f"model/{k}": v for k, v in st["model"].items()}
    flat.update({f"mu/{k}": v for k, v in st["optimizer"]["mu"].items()})
    flat.update({f"nu/{k}": v for k, v in st["optimizer"]["nu"].items()})
    return ({k: v.detach().clone() for k, v in flat.items()},
            st["optimizer"]["count"])


def _bitwise(a, b):
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)


@pytest.mark.parametrize("remat,loss_chunk", [
    ("dots_attn_out", 0), ("dots", 0), ("minimal", 0),
    ("dots_attn_out", 32)])
def test_profile_step_counts_the_analytic_matmul_flops(remat, loss_chunk):
    """Exact: the counter sees every matmul the step runs on the CPU."""
    cfg, trainer, batch = _trainer(remat, loss_chunk)
    prof = profiler.profile_step(trainer.forward_backward, batch,
                                 params=trainer.model)
    assert prof.flops == _analytic_flops(cfg, remat, loss_chunk)
    assert prof.device == "cpu"
    assert prof.param_count == llama.param_count(cfg)
    assert prof.variable_count == len(list(trainer.model.parameters()))
    kw = prof.to_model_info_kwargs(batch_size=B, seq_len=S)
    assert kw["flops_per_step"] == prof.flops
    assert kw["extra"]["profile_device"] == "cpu"


def test_report_model_profile_leaves_the_state_bitwise(monkeypatch):
    """Two trainers from one seed take a step; one is profiled through
    ElasticTrainer.report_model_profile. Parameters, both AdamW moments,
    the step count, the generators, the launch counts and ``.grad`` are
    bitwise as before, and the next step of both is bitwise equal."""
    monkeypatch.setenv("DLROVER_HANG_DETECTION", "0")
    sent = []
    client = types.SimpleNamespace(
        report_model_info=lambda **kw: sent.append(kw),
        report_global_step=lambda *a, **k: None)
    _, trainer, batch = _trainer("dots_attn_out", 0)
    _, twin, _ = _trainer("dots_attn_out", 0)
    elastic = ElasticTrainer(trainer, max_nodes=1, cur_nodes=1,
                             master_client=client)
    try:
        for t in (trainer, twin):
            t.train_step(batch)
        before, count = _state(trainer)
        rng = torch.get_rng_state()
        fa.LAUNCHES.update({"fwd": 7, "dq": 8, "dkv": 9})
        prof = elastic.report_model_profile(batch, batch_size=B,
                                            seq_len=S)
        after, count_after = _state(trainer)
        assert _bitwise(before, after) and count_after == count == 1
        assert torch.equal(torch.get_rng_state(), rng)
        assert fa.LAUNCHES == {"fwd": 7, "dq": 8, "dkv": 9}
        assert all(p.grad is None for p in trainer.model.parameters())
        assert prof is not None and prof.flops > 0
        assert sent and sent[0]["flops_per_step"] == prof.flops
        assert sent[0]["batch_size"] == B and sent[0]["seq_len"] == S
        loss = trainer.train_step(batch)
        loss_twin = twin.train_step(batch)
        assert torch.equal(loss, loss_twin)
        assert _bitwise(_state(trainer)[0], _state(twin)[0])
    finally:
        elastic.drain.disarm()
        fa.reset_launches()


def test_measure_step_time_and_utilization():
    calls = []

    def run_once():
        calls.append(1)
        return torch.ones(2)

    t = profiler.measure_step_time(run_once, steps=3, warmup=1)
    assert t >= 0 and len(calls) == 4
    assert profiler.utilization(2e12, 2.0, 1e12) == 100.0
    assert profiler.utilization(1.0, 0.0, 1.0) == 0.0


def test_trace_capture_writes_a_chrome_trace(tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    with profiler.TraceCapture(str(trace_dir), start_step=2,
                               num_steps=2) as tc:
        x = torch.ones(8, 8)
        for step in range(1, 6):
            x = x @ x / 8.0
            tc.step(step)
    assert len(tc.paths) == 1
    trace = json.loads(open(tc.paths[0]).read())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    monkeypatch.delenv("DLROVER_TRACE_DIR", raising=False)
    assert profiler.TraceCapture.from_env() is None
    monkeypatch.setenv("DLROVER_TRACE_DIR", str(trace_dir))
    monkeypatch.setenv("DLROVER_TRACE_STEPS", "5")
    tc = profiler.TraceCapture.from_env()
    assert tc is not None and tc._stop_after == 6


def test_tuning_events_round_trip_through_the_journal():
    telemetry.set_default_journal(EventJournal(None))
    try:
        profiler.record_tuning_event(kernel="fwd", block=128,
                                     source="heuristic")
        events = profiler.tuning_events()
    finally:
        telemetry.set_default_journal(EventJournal(None))
    assert events[0]["kernel"] == "fwd" and "time" in events[0]
