"""The port's strategy search (``dlrover_tpu_torch/auto/``) against the
JAX package's on the same inputs, in this process.

Exact parity: ``enumerate_strategies`` over 1, 2, 4 and 8 devices, long
context or not, 0 or 4 experts; the memory and step-time estimates of
every candidate of six models with JAX's constants passed (relative
1e-12); ``bo_search`` on one deterministic time table (the same measured
sequence and winner) and with failing candidates; the ranking of
``auto_accelerate(dryrun_top_k=0)`` at 8 and 2 devices (the port's
``rank_candidates``, a pure function of the device count, against JAX's
search over as many virtual CPU devices): the same reports in the same
order with the same ``fits``, and the same winner, for the 16k envelope
(JAX's 8192 and 15.75e9 passed), the Ulysses gate, DLRM's rowwise extras
and the CNN's collapsed remat twins; ``adjust_strategy``, the load fast
path and the warm start, with one fake brain client for both packages
and a fixed dryrun time. The port's own search at one rank on the CPU
trains its winner; its constants are the card's, not the TPU's.
"""

import dataclasses
import math

import jax
import pytest
import torch

from dlrover_tpu.auto import accelerate as jax_acc
from dlrover_tpu.auto import analyser as jax_analyser
from dlrover_tpu.auto import bo as jax_bo
from dlrover_tpu.auto import strategy as jax_strategy
from dlrover_tpu.models import cnn as jax_cnn
from dlrover_tpu.models import dlrm as jax_dlrm
from dlrover_tpu.models import gpt as jax_gpt
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu_torch.auto import accelerate, analyser, bo, planner, strategy
from dlrover_tpu_torch.auto.device_context import DeviceContext
from dlrover_tpu_torch.models import cnn, dlrm, gpt, llama
from dlrover_tpu_torch.parallel import sharding

from tests.test_torch_llama import one_thread  # noqa: F401

#: the JAX package's TPU constants, passed to both sides
JAX_PEAK, JAX_LINK, JAX_MAX_SEQ, JAX_HBM = 197e12, 4.5e10, 8192, 15.75e9

#: (port config, JAX config) by name
MODELS = {
    "llama_tiny": (llama.llama_tiny, jax_llama.llama_tiny),
    "llama_1b": (llama.llama_1b, jax_llama.llama_1b),
    "llama_moe_tiny": (llama.llama_moe_tiny, jax_llama.llama_moe_tiny),
    "gpt2_small": (gpt.gpt2_small, jax_gpt.gpt2_small),
    "gpt2_xl": (gpt.gpt2_xl, jax_gpt.gpt2_xl),
    "criteo_wide_deep": (dlrm.criteo_wide_deep, jax_dlrm.criteo_wide_deep),
}


def _same(port_list, jax_list):
    return [s.to_json() for s in port_list] == [s.to_json() for s in jax_list]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_enumeration_equals_jax(n):
    for long in (False, True):
        for experts in (0, 4):
            got = strategy.enumerate_strategies(
                n, 8, context_lengths_long=long, num_experts=experts)
            want = jax_strategy.enumerate_strategies(
                n, 8, context_lengths_long=long, num_experts=experts)
            assert got and _same(got, want), (n, long, experts)


def test_strategy_json_and_envelope():
    s = strategy.Strategy(mesh_spec=(("data", 2), ("fsdp", 2)),
                          sharding="zero1", remat="minimal", accum_steps=2)
    assert strategy.Strategy.from_json(s.to_json()) == s
    assert jax_strategy.Strategy.from_json(s.to_json()).to_json() == \
        s.to_json()
    with pytest.raises(ValueError):
        strategy.Strategy(mesh_spec=(("data", 1),), remat="full")
    for h, layers in ((2048, 22), (64, 2), (1600, 48)):
        assert strategy.envelope_max_seq(h, layers) / \
            strategy.SINGLE_CHIP_MAX_SEQ == pytest.approx(
                jax_strategy.envelope_max_seq(h, layers) / JAX_MAX_SEQ)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_estimates_equal_jax_for_every_candidate(name):
    make, jax_make = MODELS[name]
    cfg, jcfg = make(), jax_make()
    cands = strategy.enumerate_strategies(
        8, 8, context_lengths_long=True, num_experts=4)
    jcands = jax_strategy.enumerate_strategies(
        8, 8, context_lengths_long=True, num_experts=4)
    for seq in (2048, 16384):
        p = analyser.ModelProfile.from_config(cfg, seq)
        jp = jax_analyser.ModelProfile.from_config(jcfg, seq)
        assert dataclasses.asdict(p) == dataclasses.asdict(jp)
        for s, js in zip(cands, jcands):
            for gb in (8, 16):
                mem = analyser.estimate_memory(p, s, gb, seq)
                jmem = jax_analyser.estimate_memory(jp, js, gb, seq)
                for k, v in dataclasses.asdict(jmem).items():
                    assert getattr(mem, k) == pytest.approx(v, rel=1e-12), k
                for overlap in (0.0, 0.5):
                    t = analyser.estimate_step_time(
                        p, s, gb, seq, peak_flops=JAX_PEAK, mfu=0.4,
                        link_bandwidth=JAX_LINK, comm_overlap=overlap)
                    jt = jax_analyser.estimate_step_time(
                        jp, js, gb, seq, comm_overlap=overlap)
                    assert t == pytest.approx(jt, rel=1e-12), (s, gb, seq)


def test_card_constants_are_the_h100s():
    """The defaults are the card's: none of the JAX package's TPU
    numbers (197e12, 4.5e10, 5e-6, 8192) is the port's."""
    assert analyser.PEAK_FLOPS == 989e12
    assert analyser.LINK_BANDWIDTH == 450e9
    assert strategy.SINGLE_CHIP_MAX_SEQ != JAX_MAX_SEQ
    assert planner._COLLECTIVE_LATENCY != 5e-6
    p = analyser.ModelProfile.from_config(llama.llama_1b(), 2048)
    s = strategy.Strategy(mesh_spec=(("fsdp", 8),), sharding="fsdp")
    assert analyser.estimate_step_time(p, s, 8, 2048) == \
        analyser.estimate_step_time(p, s, 8, 2048, peak_flops=989e12,
                                    link_bandwidth=450e9)


def _time_table(s):
    """A deterministic step time: tensor axes hurt, minimal remat hurts,
    fsdp helps a bit (JAX's test landscape)."""
    return (1.0 + 0.5 * (s.axis("tensor") - 1) + 0.4 * (s.remat == "minimal")
            - 0.1 * (s.axis("fsdp") > 1) + 0.05 * s.axis("data"))


def test_bo_search_equals_jax():
    cands = strategy.enumerate_strategies(8, 8)
    jcands = jax_strategy.enumerate_strategies(8, 8)
    calls, jcalls = [], []

    def measure(s):
        calls.append(s.to_json())
        return _time_table(s)

    def jmeasure(s):
        jcalls.append(s.to_json())
        return _time_table(s)

    best, measured = bo.bo_search(cands, measure, n_init=3, n_iters=6)
    jbest, jmeasured = jax_bo.bo_search(jcands, jmeasure, n_init=3,
                                        n_iters=6)
    assert calls == jcalls and len(calls) <= 9 < len(cands)
    assert best.to_json() == jbest.to_json()
    assert {s.to_json(): t for s, t in measured.items()} == {
        s.to_json(): t for s, t in jmeasured.items()}
    for s in cands:
        assert (bo.featurize(s) == jax_bo.featurize(
            jax_strategy.Strategy.from_json(s.to_json()))).all()

    def failing(s):
        if s.remat == "minimal":
            raise RuntimeError("out of memory")
        return 1.0 + 0.1 * s.axis("tensor")

    best, measured = bo.bo_search(cands[:6], failing, n_init=2, n_iters=8)
    jbest, jmeasured = jax_bo.bo_search(jcands[:6], failing, n_init=2,
                                        n_iters=8)
    assert best.to_json() == jbest.to_json() and best.remat != "minimal"
    assert sorted(s.to_json() for s in measured) == sorted(
        s.to_json() for s in jmeasured)


#: (name, port config, JAX config, global batch, seq, hbm, device counts)
RANKINGS = [
    ("envelope_16k", llama.llama_1b(), jax_llama.llama_1b(), 8, 16384,
     JAX_HBM, (8,)),
    ("envelope_8k", llama.llama_1b(), jax_llama.llama_1b(), 8, 8192,
     JAX_HBM, (8,)),
    ("ulysses_gate", llama.llama_tiny(hidden_size=96, num_heads=6,
                                      num_kv_heads=3, max_seq_len=16384),
     jax_llama.llama_tiny(hidden_size=96, num_heads=6, num_kv_heads=3,
                          max_seq_len=16384), 8, 16384, JAX_HBM, (8,)),
    ("dlrm_rowwise", dlrm.criteo_wide_deep(), jax_dlrm.criteo_wide_deep(),
     64, 1, 16e9, (8, 2)),
    ("cnn_twins", cnn.mnist_cnn(), jax_cnn.mnist_cnn(), 64, 1, 16e9,
     (8, 2)),
    ("gpt2_small", gpt.gpt2_small(), jax_gpt.gpt2_small(), 8, 1024, 16e9,
     (8, 2)),
    ("llama_moe", llama.llama_moe_tiny(), jax_llama.llama_moe_tiny(), 8, 64,
     16e9, (8, 2)),
    ("llama_1b_2", llama.llama_1b(), jax_llama.llama_1b(), 8, 2048, 16e9,
     (2,)),
]


@pytest.fixture
def jax_constants(monkeypatch):
    monkeypatch.setattr(strategy, "SINGLE_CHIP_MAX_SEQ", JAX_MAX_SEQ)


@pytest.mark.parametrize("case", RANKINGS, ids=[r[0] for r in RANKINGS])
def test_ranking_equals_jax_auto_accelerate(case, jax_constants):
    _, cfg, jcfg, gb, seq, hbm, counts = case
    for n in counts:
        reports, fitting = accelerate.rank_candidates(
            cfg, gb, seq, n, None, hbm, 0.4, JAX_PEAK, JAX_LINK)
        result = jax_acc.auto_accelerate(
            jcfg, global_batch=gb, seq_len=seq, devices=jax.devices()[:n],
            hbm_bytes=hbm, dryrun_top_k=0)
        assert [r.strategy.to_json() for r in reports] == [
            r.strategy.to_json() for r in result.reports]
        for r, jr in zip(reports, result.reports):
            assert r.fits == jr.fits
            assert r.memory_bytes == pytest.approx(jr.memory_bytes,
                                                   rel=1e-12)
            assert r.est_step_seconds == pytest.approx(jr.est_step_seconds,
                                                       rel=1e-12)
        assert fitting[0].strategy.to_json() == result.strategy.to_json()
    if case[0] == "envelope_16k":
        assert fitting[0].strategy.context_parallel == "ring"
        assert all(r.strategy.context_parallel for r in reports if r.fits)
    if case[0] == "ulysses_gate":
        assert {r.strategy.axis("seq") for r in reports
                if r.strategy.context_parallel == "ulysses"} == {2}
    if case[0] == "dlrm_rowwise":
        assert any(r.strategy.sharding == "rowwise" for r in reports)
    if case[0] == "cnn_twins":
        assert len({(r.strategy.mesh_spec, r.strategy.sharding)
                    for r in reports}) == len(reports)


def test_adjust_strategy_equals_jax():
    s = strategy.Strategy(mesh_spec=(("data", 4), ("fsdp", 2),
                                     ("tensor", 2)), sharding="tp_fsdp")
    js = jax_strategy.Strategy.from_json(s.to_json())
    for n in (4, 8, 16):
        assert accelerate.adjust_strategy(s, n, 8).to_json() == \
            jax_acc.adjust_strategy(js, n, 8).to_json()
    with pytest.raises(ValueError, match="multiple of 4"):
        accelerate.adjust_strategy(s, 6, 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        jax_acc.adjust_strategy(js, 6, 8)


class FakeBrain:
    """The brain client both packages' searches archive to and read."""

    def __init__(self):
        self.docs = {}

    def get_job_runs(self, job_name):
        return sorted(u for j, u in self.docs if j == job_name)

    def get_strategy(self, job_name, uuid):
        return self.docs.get((job_name, uuid))

    def report_strategy(self, job, strategy_json, measured_seconds):
        self.docs[(job.name, f"{len(self.docs):04d}")] = {
            "strategy_json": strategy_json,
            "measured_seconds": measured_seconds}


def _context():
    return DeviceContext(
        platform="cpu", device_kind="cpu", num_devices=1, num_hosts=1,
        devices_per_host=1, hbm_bytes=16e9, peak_flops=JAX_PEAK,
        link_bandwidth=JAX_LINK, host_cpu_count=1, host_memory_mb=1)


def test_warm_start_and_load_path_equal_jax(monkeypatch, tmp_path,
                                            one_thread):  # noqa: F811
    """Cold BO search, then a warm start from its archive, both packages
    on one device with the same fixed dryrun times: the same dryruns in
    the same order, the same winners; the saved winner loads back
    through the fast path, refit to the device count."""
    monkeypatch.setattr(accelerate, "get_device_context",
                        lambda device=None: _context())
    cfg, jcfg = llama.llama_tiny(), jax_llama.llama_tiny()
    calls, jcalls = [], []

    def fixed(log):
        def dryrun(cfg_, s, gb, seq, *a, **kw):
            log.append(s.to_json())
            return {"dots": 0.03, "dots_attn_out": 0.02,
                    "minimal": 0.025}[s.remat]
        return dryrun

    monkeypatch.setattr(accelerate, "dryrun_strategy", fixed(calls))
    monkeypatch.setattr(jax_acc, "dryrun_strategy", fixed(jcalls))
    client, jclient = FakeBrain(), FakeBrain()
    for round_ in ("cold", "warm"):
        calls.clear(), jcalls.clear()
        got = accelerate.auto_accelerate(
            cfg, 8, 32, device="cpu", bo_iters=2, dryrun_top_k=2,
            hbm_bytes=16e9, job_name="job", brain_client=client)
        want = jax_acc.auto_accelerate(
            jcfg, 8, 32, devices=jax.devices()[:1], bo_iters=2,
            dryrun_top_k=2, hbm_bytes=16e9, job_name="job",
            brain_client=jclient)
        assert calls == jcalls and calls, round_
        assert got.strategy.to_json() == want.strategy.to_json()
        assert got.strategy.remat == "dots_attn_out"
    assert len(calls) <= 2
    assert [d["strategy_json"] for d in client.docs.values()] == [
        d["strategy_json"] for d in jclient.docs.values()]
    path = tmp_path / "s.json"
    saved = strategy.Strategy(mesh_spec=(("data", 4), ("fsdp", 1)),
                              sharding="fsdp", remat="minimal")
    strategy.save_strategy(saved, str(path))
    loaded = accelerate.auto_accelerate(cfg, 8, 32, device="cpu",
                                        load_strategy_path=str(path))
    assert loaded.reports == [] and loaded.strategy == \
        accelerate.adjust_strategy(saved, 1, 8)
    assert loaded.strategy.mesh_spec == (("data", 1), ("fsdp", 1))


def test_search_at_one_rank_trains_its_winner(one_thread):  # noqa: F811
    """The port's own search on the CPU: real dryruns of the top 2, the
    winner measured and built, its step finite; ``dryrun_abstract``
    raises here for its temp part, and ``abstract_bytes`` counts the
    held state and the batch."""
    import numpy as np

    cfg = llama.llama_tiny()
    result = accelerate.auto_accelerate(cfg, 4, 32, device="cpu",
                                        dryrun_top_k=2, hbm_bytes=16e9)
    measured = [r for r in result.reports
                if r.measured_step_seconds is not None]
    assert len(measured) == 2 and not any(r.error for r in result.reports)
    assert result.strategy in {r.strategy for r in measured}
    t = result.trainer
    t.init(seed=0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32))
    loss = t.train_step(t.shard_batch(t.microbatch((tokens, tokens))))
    assert math.isfinite(loss.item())
    args, out = accelerate.abstract_bytes(cfg, result.strategy, 4, 32,
                                          device="cpu")
    state = 3 * sum(p.numel() * p.element_size()
                    for p in t.model.parameters())
    assert args == state + 2 * 4 * 32 * 8 and out == state + 4
    with pytest.raises(RuntimeError, match="on the card"):
        accelerate.dryrun_abstract(cfg, result.strategy, 4, 32,
                                   device="cpu")


def test_failed_dryrun_lands_in_error(monkeypatch, one_thread):  # noqa: F811
    """A dryrun that raises disqualifies its candidate, with the reason
    in ``error``; the next one wins."""
    real = accelerate._measure

    def measure(cfg, s, *a, **kw):
        if s.remat == "dots_attn_out":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(cfg, s, *a, **kw)

    monkeypatch.setattr(accelerate, "_measure", measure)
    result = accelerate.auto_accelerate(llama.llama_tiny(), 4, 32,
                                        device="cpu", dryrun_top_k=2,
                                        hbm_bytes=16e9)
    bad = [r for r in result.reports if r.error]
    assert len(bad) == 1 and not bad[0].fits
    assert "out of memory" in bad[0].error
    assert result.strategy.remat != "dots_attn_out"


def test_indivisible_heads_are_unfit_with_the_reason():
    """GPT-2 XL's 25 heads do not split over 2 or 4 tensor ranks: the
    flash kernels take whole heads, so building the held tp layout
    raises, with the reason the search files as an expected failure;
    fsdp, which gathers the heads' dims, builds."""
    from tests.test_torch_sharding import _Shape

    for t in (2, 4):
        for strategy in ("tp", "tp_fsdp"):
            with pytest.raises(ValueError, match="do not split over") as e:
                gpt.make_trainer(gpt.gpt2_xl(), device="cpu",
                                 strategy=strategy,
                                 mesh=_Shape((("tensor", t),)))
            assert any(x in str(e.value)
                       for x in accelerate.EXPECTED_FAILURES)
    llama.check_heads(gpt.gpt2_xl(), sharding.get_rules("fsdp"),
                      _Shape((("fsdp", 2),)))
    llama.check_heads(gpt.gpt2_small(), sharding.get_rules("tp"),
                      _Shape((("tensor", 2),)))
