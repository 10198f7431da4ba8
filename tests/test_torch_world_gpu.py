"""Two ranks sharing the card: a gloo group of two processes on ``cuda:0``
(NCCL refuses two ranks on one device) runs the ddp step through the
flash kernels, and the ranks' parameters stay bitwise equal after each
of 2 steps; a second process of one host on a one-card machine raises.
Marked ``gpu``: it skips on a machine without one; run it on a GPU with
``python -m pytest --noconftest tests/test_torch_world_gpu.py -m gpu``
(the repo's conftest imports JAX, which a GPU machine need not have)."""

import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RANK = textwrap.dedent("""
    import hashlib, json, torch
    from dlrover_tpu_torch.examples import llama_train
    from dlrover_tpu_torch.ops.cuda import flash_attention
    from dlrover_tpu_torch.trainer.distributed import init_from_env
    from dlrover_tpu_torch.trainer.sharded import make_trainer_for_llama
    env = init_from_env(timeout_s=120, backend="gloo")

    def digest(model):
        return hashlib.sha256(b"".join(
            p.detach().view(torch.uint8).cpu().numpy().tobytes()
            for p in model.parameters())).hexdigest()

    cfg, optimizer = llama_train.model_config("tiny")
    trainer = make_trainer_for_llama(cfg, optimizer=optimizer)
    trainer.init(seed=0)
    digests, losses = [digest(trainer.model)], []
    before = dict(flash_attention.LAUNCHES)
    for step in range(2):
        start = (2 * step + env.rank) * 2
        batch = llama_train.synth_batch(start, start + 2, 128,
                                        cfg.vocab_size)
        loss = trainer.train_step(trainer.shard_batch(
            trainer.microbatch(batch)))
        losses.append(loss.item())
        digests.append(digest(trainer.model))
    print("RESULT " + json.dumps({
        "rank": env.rank, "device": str(next(
            trainer.model.parameters()).device),
        "digests": digests, "losses": losses,
        "launches": {k: n - before[k]
                     for k, n in flash_attention.LAUNCHES.items()}}))
""")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks share the card")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(code, local_ranks, timeout=300):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code],
        env={**os.environ, "PYTHONPATH": REPO,
             "DLROVER_TPU_COORDINATOR_ADDR": f"localhost:{port}",
             "DLROVER_TPU_PROCESS_ID": str(pid),
             "DLROVER_TPU_NUM_PROCESSES": str(len(local_ranks)),
             "LOCAL_RANK": str(local), "LOCAL_WORLD_SIZE": "1"},
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid, local in enumerate(local_ranks)]
    return procs, [p.communicate(timeout=timeout) for p in procs]


def test_two_ranks_sharing_the_card_stay_bitwise_equal(cuda):
    import json

    procs, outs = _ranks(_RANK, [0, 0])
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    results = [json.loads(next(line[7:] for line in o[0].splitlines()
                               if line.startswith("RESULT "))) for o in outs]
    assert [r["device"] for r in results] == ["cuda:0", "cuda:0"]
    assert results[0]["digests"] == results[1]["digests"]
    assert results[0]["losses"] == results[1]["losses"]
    assert len(set(results[0]["digests"])) == 3  # each step moved them
    # 2 steps of the example's llama_tiny (2 layers, remat "dots": the
    # backward runs the forward kernel again)
    for r in results:
        assert r["launches"] == {"fwd": 8, "dq": 4, "dkv": 4}


def test_a_second_local_rank_on_a_one_card_host_raises(cuda):
    if torch.cuda.device_count() != 1:
        pytest.skip("the host has more than one card")
    code = ("from dlrover_tpu_torch.trainer.distributed import "
            "init_from_env\ninit_from_env(timeout_s=30)\n")
    port = _free_port()
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO,
             "DLROVER_TPU_COORDINATOR_ADDR": f"localhost:{port}",
             "DLROVER_TPU_PROCESS_ID": "0",
             "DLROVER_TPU_NUM_PROCESSES": "1",
             "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"})
    assert proc.returncode != 0
    assert "LOCAL_RANK 1 but 1 card" in proc.stderr
