"""The port's elastic loop on the CPU: ElasticTrainer over the
ShardedTrainer fed by the master's shards, crash and resume through the
flash checkpoint, the same loop against the JAX ElasticTrainer from the
same weights, and the process-group bootstrap."""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.agent.master_client import (
    LocalMasterClient as JaxLocalMasterClient,
)
from dlrover_tpu.agent.sharding.client import (
    ShardingClient as JaxShardingClient,
)
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.trainer.elastic import ElasticTrainer as JaxElasticTrainer
from dlrover_tpu.trainer.elastic import (
    compute_accum_steps as jax_compute_accum_steps,
)
from dlrover_tpu_torch.agent.master_client import LocalMasterClient
from dlrover_tpu_torch.agent.sharding.client import ShardingClient
from dlrover_tpu_torch.common import log
from dlrover_tpu_torch.examples import llama_train
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.trainer import distributed
from dlrover_tpu_torch.trainer.elastic import (
    ElasticTrainer,
    compute_accum_steps,
)
from dlrover_tpu_torch.trainer.sharded import (
    Fp32GradAdamW,
    adamw,
    make_trainer_for_llama,
)

from tests.test_torch_llama import _as_port_layout
from tests.test_torch_trainer import _assert_adam_close, _port_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("max_nodes,cur_nodes", [
    (4, 4), (4, 3), (4, 2), (4, 1), (1, 1), (3, 0), (8, 3)])
def test_compute_accum_steps_matches_jax(max_nodes, cur_nodes):
    assert compute_accum_steps(max_nodes, cur_nodes) == \
        jax_compute_accum_steps(max_nodes, cur_nodes)


class _Crash(Exception):
    pass


def test_crash_and_resume_replays_the_same_shards_bitwise(tmp_path,
                                                          monkeypatch):
    """Run 1 trains 8 steps. Run 2 crashes while it makes step 5's batch,
    after its step-4 checkpoint; run 3 resumes from that checkpoint:
    steps 5-8 see the same shards as run 1, with the same losses to the
    last bit."""
    kw = dict(batch_size=4, seq_len=32, device="cpu", save_interval=4)
    full = llama_train.run(8, str(tmp_path / "a"), **kw)
    synth = llama_train.synth_batch

    def crash_at_step_5(start, end, *a):
        if start == 16:
            raise _Crash
        return synth(start, end, *a)

    monkeypatch.setattr(llama_train, "synth_batch", crash_at_step_5)
    with pytest.raises(_Crash):
        llama_train.run(8, str(tmp_path / "b"), **kw)
    monkeypatch.setattr(llama_train, "synth_batch", synth)
    resumed = llama_train.run(8, str(tmp_path / "b"), **kw)
    assert full["start_step"] == 0 and resumed["start_step"] == 4
    assert full["shards"][:2] == [(0, 4), (4, 8)]
    assert resumed["shards"] == full["shards"][4:]
    assert resumed["losses"] == full["losses"][4:]
    assert resumed["step"] == 8


def test_example_prints_restored_and_final(tmp_path, capsys):
    args = ["--steps", "3", "--batch-size", "2", "--seq-len", "16",
            "--save-interval", "2", "--ckpt-dir", str(tmp_path),
            "--device", "cpu", "--out", str(tmp_path / "out.txt")]
    assert llama_train.main(args) == 0
    out = capsys.readouterr().out
    assert "FINAL step=3 loss=" in out and "RESTORED" not in out
    args[1] = "5"
    assert llama_train.main(args) == 0
    out = capsys.readouterr().out
    assert "RESTORED from step 2" in out and "FINAL step=5 loss=" in out
    step, loss, start = (tmp_path / "out.txt").read_text().split(",")
    assert (int(step), int(start)) == (5, 2) and np.isfinite(float(loss))


#: (cur_nodes before the step) of max_nodes=2: accum 1, 2 (set_world 2 ->
#: 1), then 1 again
WORLDS = (2, 1, 2)


def _shard_batches(master_cls, client_cls, cfg, n, seq=32):
    client = client_cls("elastic", 4, num_epochs=1, dataset_size=4 * n,
                        shuffle=False, num_minibatches_per_shard=1,
                        master_client=master_cls())
    out = []
    for _ in range(n):
        shard = client.fetch_shard()
        tokens, _ = llama_train.synth_batch(shard.start, shard.end, seq,
                                            cfg.vocab_size)
        targets = np.roll(tokens, -1, axis=1)
        targets[:, -1] = -1
        out.append(((shard.start, shard.end), tokens, targets))
        client.report_batch_done()
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The JAX ElasticTrainer over the JAX package's shards: three steps
    at the worlds of WORLDS, fp32, AdamW(1e-3, 0.9, 0.95)."""
    jcfg = jax_llama.llama_tiny(dtype=np.float32, remat="off")
    params = jax_llama.init_params(jax.random.key(0), jcfg)
    start = jax.tree.map(np.array, params)
    optimizer = optax.adamw(1e-3, b1=0.9, b2=0.95)
    opt_state = optimizer.init(params)
    elastic = JaxElasticTrainer(
        lambda p, b: jax_llama.next_token_loss(p, b, jcfg), optimizer,
        max_nodes=2, cur_nodes=WORLDS[0])
    batches = _shard_batches(JaxLocalMasterClient, JaxShardingClient,
                             jcfg, len(WORLDS))
    losses = []
    for world, (_, tokens, targets) in zip(WORLDS, batches):
        elastic.set_world(world)
        params, opt_state, loss = elastic.train_step(
            params, opt_state, elastic.microbatch((tokens, targets)))
        losses.append(float(loss))
    final = _as_port_layout(jax.tree.map(np.asarray, params), jcfg)
    return start, [b[0] for b in batches], losses, final


def test_loop_matches_the_jax_elastic_trainer(jax_run):
    jax_start, jax_shards, jax_losses, want = jax_run
    cfg = llama.llama_tiny(dtype=torch.float32, remat="off")
    trainer = make_trainer_for_llama(
        cfg, device="cpu", optimizer=adamw(1e-3, b1=0.9, b2=0.95))
    trainer.init(model=llama.params_from_jax(jax_start, cfg, device="cpu"))
    start = _port_params(trainer)
    elastic = ElasticTrainer(trainer, max_nodes=2, cur_nodes=WORLDS[0])
    batches = _shard_batches(LocalMasterClient, ShardingClient, cfg,
                             len(WORLDS))
    assert [b[0] for b in batches] == jax_shards
    losses, accums = [], []
    for world, (_, tokens, targets) in zip(WORLDS, batches):
        elastic.set_world(world)
        accums.append(elastic.accum_steps)
        batch = trainer.shard_batch(elastic.microbatch(
            (tokens.astype(np.int64), targets.astype(np.int64))))
        losses.append(elastic.report_step(loss=elastic.train_step(batch)))
    assert accums == [1, 2, 1]
    assert losses[0] == pytest.approx(jax_losses[0], rel=1e-5)
    assert losses == pytest.approx(jax_losses, rel=1e-4)
    _assert_adam_close(_port_params(trainer), want, start, lr=1e-3)


def _moments(trainer):
    mu, nu, count = trainer._moments()
    return [m.clone() for m in mu], [v.clone() for v in nu], count


def _step(trainer, elastic, seed):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, trainer.model.cfg.vocab_size, (4, 16),
                           generator=gen)
    elastic.train_step(trainer.shard_batch(elastic.microbatch(
        (tokens, tokens))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_set_world_carries_moments_and_count(dtype):
    cfg = llama.llama_tiny(dtype=dtype)
    trainer = make_trainer_for_llama(cfg, device="cpu",
                                     optimizer=adamw(1e-3))
    trainer.init(seed=0)
    elastic = ElasticTrainer(trainer, max_nodes=2, cur_nodes=2)
    _step(trainer, elastic, 0)
    assert isinstance(trainer.optimizer, torch.optim.AdamW)
    mu, nu, count = _moments(trainer)
    assert count == 1 and mu[0].dtype == dtype
    elastic.set_world(1)  # accum 2: fp32 moments, as optax's become
    assert isinstance(trainer.optimizer, Fp32GradAdamW)
    mu2, nu2, count2 = _moments(trainer)
    assert count2 == 1 and mu2[0].dtype == torch.float32
    assert all(torch.equal(a.float(), b) for a, b in zip(mu + nu,
                                                          mu2 + nu2))
    _step(trainer, elastic, 1)
    elastic.set_world(2)
    _, _, count3 = _moments(trainer)
    assert count3 == 2
    # fp32 moments stay fp32, as optax's do; for fp32 parameters that
    # is torch's AdamW again
    want = torch.optim.AdamW if dtype == torch.float32 else Fp32GradAdamW
    assert isinstance(trainer.optimizer, want)
    _step(trainer, elastic, 2)
    assert _moments(trainer)[2] == 3


def test_in_place_update_waits_for_the_checkpoint_copies():
    calls = []

    class SpyCkpt:
        def wait_staged(self, timeout=None):
            calls.append("wait_staged")
            return True

        def save(self, step, state, force_persist=False, durable=False):
            calls.append(("save", step, sorted(state)))
            return 0.5

    cfg = llama.llama_tiny()
    trainer = make_trainer_for_llama(cfg, device="cpu",
                                     optimizer=adamw(1e-3))
    trainer.init(seed=0)
    step_fn = trainer.optimizer.step

    def spy_step(*a, **kw):
        calls.append("optimizer.step")
        return step_fn(*a, **kw)

    trainer.optimizer.step = spy_step
    elastic = ElasticTrainer(trainer, max_nodes=1, cur_nodes=1)
    _step(trainer, elastic, 0)  # nothing attached: no sync point
    elastic.attach_checkpointer(SpyCkpt(), save_interval=2)
    stalls = []
    for step in (1, 2, 3):
        _step(trainer, elastic, step)
        elastic.report_step(step)
        stalls.append(elastic.maybe_checkpoint(
            lambda: {"model": 1, "step": elastic.global_step}))
    assert stalls == [None, 0.5, None]
    assert calls == ["optimizer.step"] + [
        "wait_staged", "optimizer.step"] * 2 + [
        ("save", 2, ["model", "step"]), "wait_staged", "optimizer.step"]


def test_report_step_reports_the_global_step_every_interval():
    class Master:
        steps = []

        def report_global_step(self, step, timestamp=None):
            self.steps.append(step)

    trainer = make_trainer_for_llama(llama.llama_tiny(), device="cpu")
    trainer.init(seed=0)
    elastic = ElasticTrainer(trainer, 1, 1, master_client=Master(),
                             report_interval=3)
    losses = [elastic.report_step(loss=torch.tensor(float(i)))
              for i in range(7)]
    assert Master.steps == [3, 6] and elastic.global_step == 7
    assert losses == [float(i) for i in range(7)]


def test_init_from_env_single_process(monkeypatch):
    for var in ("DLROVER_TPU_NUM_PROCESSES", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DLROVER_TPU_PROCESS_ID", "0")
    monkeypatch.setattr(log, "_process_index", None)
    env = distributed.init_from_env()  # no group, no device needed
    assert (env.rank, env.world_size, env.is_distributed) == (0, 1, False)
    assert not torch.distributed.is_initialized()
    assert log.current_process_index() == 0


def test_init_from_env_without_coordinator_raises(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_NUM_PROCESSES", "2")
    monkeypatch.delenv("DLROVER_TPU_COORDINATOR_ADDR", raising=False)
    with pytest.raises(ValueError, match="COORDINATOR_ADDR"):
        distributed.init_from_env(device="cpu")


_WORKER = textwrap.dedent("""
    import torch, torch.distributed as dist
    from dlrover_tpu_torch.trainer.distributed import init_from_env
    env = init_from_env(timeout_s=60, device="cpu")
    t = torch.tensor([float(env.rank)])
    dist.all_reduce(t)
    print(env.rank, env.world_size, dist.get_backend(), int(t.item()))
    dist.destroy_process_group()
""")


def test_init_from_env_forms_a_gloo_group_of_four():
    """Two hosts of two processes each: rank = process_id x local_world +
    local_rank over a tcp:// rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        for local in range(2):
            env = {**os.environ, "PYTHONPATH": REPO,
                   "DLROVER_TPU_COORDINATOR_ADDR": f"localhost:{port}",
                   "DLROVER_TPU_PROCESS_ID": str(pid),
                   "DLROVER_TPU_NUM_PROCESSES": "2",
                   "LOCAL_RANK": str(local), "LOCAL_WORLD_SIZE": "2"}
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-500:] for o in outs]
    got = sorted(o[0].split() for o in outs)
    assert got == [[str(r), "4", "gloo", "6"] for r in range(4)]
