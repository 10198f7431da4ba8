"""Elastic training workload: Llama fed by the master's data shards.

    python -m dlrover_tpu_torch.examples.llama_train --steps 50 \
        --ckpt-dir /tmp/llama_ckpt              # on the GPU
    python -m dlrover_tpu_torch.examples.llama_train --steps 50 \
        --ckpt-dir /tmp/llama_ckpt --device cpu
    python -m dlrover_tpu_torch.trainer.elastic_run --standalone \
        --nnodes 1:1 dlrover_tpu_torch/examples/llama_train.py -- \
        --model llama_1b --batch-size 3 --seq-len 2048 --steps 12 \
        --save-interval 4 --ckpt-dir /tmp/llama_ckpt --num-workers 2
    # two ranks sharing one card: two launchers against one master
    python -m dlrover_tpu_torch.trainer.elastic_run --master_addr \
        localhost:<p> --nnodes 2:2 --node_rank R --network-check \
        dlrover_tpu_torch/examples/llama_train.py -- --dist-backend gloo \
        --ram-dir /tmp/llama_ram_R --persist-interval 4 ...

Counterpart of ``examples/llama_train.py``: master dataset sharding ->
the feed -> ElasticTrainer driving the ShardedTrainer step ->
FlashCheckpointer. Each shard's tokens are made from its sample index
(``data/synth.py``, the JAX example's ``synth_batch``), so every shard
is reproducible. Two feeds:

* ``--num-workers 0`` (the default): a ShardingClient in this process
  fetches each shard when its step starts and acks it when the step is
  done; the checkpoint's ``"data"`` holds the shard ledger, and a
  restore or a rollback rewinds the master to it, so a restart replays
  the same shards bitwise (the drills gate on that).
* ``--num-workers N``: the JAX example's feed, the shm data plane.
  ``ElasticShmDataLoader`` runs N coworker processes, each pulling
  shards from the master and pushing their batches into the shm ring;
  ``DevicePrefetch`` reshapes each batch into microbatches, casts the
  int32 tokens to int64 on its fill thread and stages them on the GPU
  on a copy stream. It needs the master's address (the launcher
  exports it). A producer acks a shard once it has pushed it, so the
  data position lives in the master's ledger, as in the JAX example:
  the checkpoint's ``"data"`` stays empty, a restart does not rewind
  the ledger, and a rollback restores the model and the optimizer only.
  A crash skips the batches in flight (ROADMAP.md, section C). Under
  spawn each coworker imports this module, and with it torch, but none
  touches the card.

Under the launcher the master client is
the RPC one (``build_master_client`` reads the master address the agent
exports), and the ElasticTrainer arms the hang detector, the fault
injector of the drills, the sentinel and the preemption drain. The drain
gets this loop's step and state: a SIGTERM (``preempt@k:notice=N``)
lands an emergency save of the step it ended inside the notice window
and the worker exits 21. A rollback order from the master (the sentinel
tripped on ``nan@k`` or ``sdc@k``) restores the ordered step, rewinds the
shard ledger to it and prints ``ROLLBACK to step k``; training goes on
in the same process. ``--model`` picks llama_tiny (the default) or
llama_1b at full width with ``bench.py``'s optimizer. Prints ``step k
loss x`` per step (the loss's full repr), ``RESTORED from step k`` after
a restore and ``FINAL step=N loss=...`` at the end, as the JAX example
does; ``--out`` gets ``step,loss,start_step``. The journal gets
``train.model_ready`` (the model on its device) and ``train.step`` per
step (with the flash kernels' launches so far), the marks a recovery's
timeline is read from. After each incarnation's first step the
ElasticTrainer profiles the step (trainer/profiler.py) and reports it to
the master's job metric collector; ``train.profile`` journals its FLOPs
and seconds.

``--strategy`` (default ``fsdp``, the JAX example's) picks the
``ShardedTrainer`` strategy on the JAX example's mesh, ``[(data, 1),
(fsdp, world)]``: every rank is a data-parallel rank there, so ``tp``
and ``tp_fsdp`` degrade to replication on it, as in JAX. At world > 1
(the launcher's ranks; ``--dist-backend gloo`` for ranks that share one
card) each rank fetches its own shards of ``--batch-size`` rows from the
master, and the loss and its gradients are the masked mean over the
global batch, reduced over the ranks. Each rank
serves its RAM tier over ``/ckpt/shard`` from a telemetry server of its
own and advertises it in the master KV (``PeerRegistry``), as the JAX
``examples/dist_train.py`` does, so a rank that lost its RAM tier
restores over the peer tier; the restore is agreed by consensus. The
ranks meet at a barrier before and after each cadence save takes the
shard ledger, so every rank's ``"data"`` holds the same ledger, and
rank 0 alone rewinds the master to it at a restore. Progress lines
carry the world (``step k loss x world w``) above one rank, and the
``FINAL`` line always does.

The checkpointed state is ``{"model": {name: parameter}, "optimizer":
{"mu": ..., "nu": ..., "count": ...}, "step": N, "data": <the shard
checkpoint JSON>}``; under a strategy other than ddp the names are the
JAX parameter tree's and each rank saves its own shards
(``ShardedTrainer.train_state``).
"""

import argparse
import dataclasses
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch.agent.master_client import build_master_client
from dlrover_tpu_torch.agent.sharding.client import ShardingClient
from dlrover_tpu_torch.common.constants import NodeStatus
from dlrover_tpu_torch.data import synth
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops.cuda import flash_attention
from dlrover_tpu_torch.parallel.mesh import create_mesh, data_parallel_size
from dlrover_tpu_torch.telemetry import record
from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
from dlrover_tpu_torch.trainer.ckpt_store import state_checksums
from dlrover_tpu_torch.trainer.distributed import host_group, init_from_env
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.sharded import (
    STRATEGIES,
    adamw,
    make_trainer_for_llama,
)

DATASET = "llama-train"


def model_config(name: str, num_layers: int = 0):
    """``--model``: the config and the AdamW learning rate. llama_tiny is
    cut to the flash kernels' head_dim of 64, so that it runs on the card
    too (``seq_len`` a multiple of 128 there); llama_1b is ``bench.py``'s
    default model with its AdamW(1e-4, 0.9, 0.95). ``num_layers`` above
    0 cuts the depth, the widths stay."""
    if name == "tiny":
        cfg, opt = llama.llama_tiny(hidden_size=128, num_heads=2,
                                    num_kv_heads=1), adamw(1e-3)
    elif name == "llama_1b":
        cfg, opt = (llama.llama_1b(remat="dots_attn_out"),
                    adamw(1e-4, b1=0.9, b2=0.95))
    else:
        raise ValueError(f"unknown model {name!r}")
    if num_layers > 0:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    return cfg, opt


def synth_batch(start: int, end: int, seq_len: int = 128,
                vocab: int = 256):
    """One shard's batch, the tokens as int64 (``synth.synth_batch``)."""
    tokens, _ = synth.synth_batch(start, end, seq_len, vocab)
    tokens = tokens.astype(np.int64)
    return tokens, tokens


def checkpoint_state(trainer, step: int,
                     sharding: Optional[ShardingClient]) -> Dict:
    """The state a save archives; ``"data"`` is empty under the shm feed
    (``sharding`` None), whose data position is the master's ledger."""
    return {**trainer.train_state(), "step": step,
            "data": (sharding.get_shard_checkpoint()
                     if sharding is not None else "")}


def shm_transform(elastic):
    """DevicePrefetch's transform for ``synth.ShardBatch`` batches, on
    the fill thread: (tokens, targets, rows) -> (the int64 microbatches,
    the shard's (start, end) on the host)."""

    def transform(batch):
        tokens, targets, rows = batch
        return (elastic.microbatch((tokens.astype(np.int64),
                                    targets.astype(np.int64))),
                (int(rows[0]), int(rows[1])))

    return transform


def shm_loader(client, trainer, elastic, cfg, batch_size: int,
               seq_len: int, dataset_rows: int, num_workers: int):
    """The shm feed: ``num_workers`` coworkers over the master at the
    client's address (the in-process client has none, and the loader
    raises), batches staged on the trainer's device."""
    from dlrover_tpu_torch.data.elastic_shm import ElasticShmDataLoader

    return ElasticShmDataLoader(
        synth.ShardBatch(seq_len, cfg.vocab_size), dataset_name=DATASET,
        batch_size=batch_size, dataset_size=dataset_rows,
        num_epochs=10**6,  # stream until --steps
        num_workers=num_workers,
        master_addr=getattr(client, "master_addr", None),
        slot_bytes=max(1 << 20, 4 * batch_size * seq_len * 2 + 4096),
        device=trainer.device, transform=shm_transform(elastic),
    )


def barrier() -> None:
    """All ranks meet here (nothing at one rank)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier(group=host_group())


def peer_tier(client, ckpt_kwargs: Dict):
    """At world > 1 under a master: a telemetry server of this rank's own
    for ``/ckpt/shard`` (returned), and the checkpointer's peer registry
    with its URL (the JAX ``examples/dist_train.py`` wiring)."""
    if not (dist.is_available() and dist.is_initialized()
            and getattr(client, "master_addr", "")):
        return None
    from dlrover_tpu_torch.agent.elastic.training import _local_ip
    from dlrover_tpu_torch.checkpoint.peer import PeerRegistry
    from dlrover_tpu_torch.telemetry.http import MetricsServer

    server = MetricsServer(port=0).start()
    url = f"http://{_local_ip(client.master_addr)}:{server.port}"
    ckpt_kwargs["peer_registry"] = PeerRegistry(
        client, dist.get_rank(), url)
    return server


def rollback(order, trainer, sharding, ckpt, client, sentinel) -> int:
    """Restore the master-ordered last clean step, as the JAX loop
    does: the model and optimizer from its archive, the shard ledger
    rewound to its ``"data"`` so the voided steps see their shards
    again (the in-process feed only; under the shm feed ``sharding`` is
    None and the ledger stays). Returns the restored step."""
    rolled, _ = ckpt.restore(
        target={**trainer.train_state(), "step": 0, "data": ""},
        step=order["step"])
    if rolled is None:
        raise RuntimeError(f"rollback step {order['step']} not found")
    trainer.load_train_state(rolled)
    if sharding is not None and rolled["data"] and not \
            sharding.restore_shard_from_checkpoint(rolled["data"]):
        raise RuntimeError("the master refused the shard checkpoint")
    step = int(rolled["step"])
    sentinel.note_restored(step, order["id"])
    # the RUNNING re-report closes the rollback window on the master
    update = getattr(client, "update_node_status", None)
    if update is not None:
        update(NodeStatus.RUNNING)
    print(f"ROLLBACK to step {step}", flush=True)
    return step


def run(steps: int, ckpt_dir: str, batch_size: int = 8, seq_len: int = 128,
        device: Optional[str] = None, save_interval: int = 10,
        seed: int = 0, model: str = "tiny", num_workers: int = 0,
        dataset_rows: int = 0, ram_dir: str = "",
        persist_interval: int = 0, num_layers: int = 0,
        checksums: bool = False, strategy: str = "fsdp") -> Dict:
    """Train to ``steps``, resuming from ``ckpt_dir`` when it holds a
    checkpoint; ``num_workers`` > 0 feeds the steps through the shm data
    plane. ``dataset_rows`` (default ``steps * batch_size`` per rank) is
    the dataset the master shards, in epochs, until ``steps``. The RAM
    tier is ``ram_dir`` (default ``<ckpt_dir>/ram``); every
    ``persist_interval``-th step is persisted too (0: none). Above one
    rank such a save waits until this rank's owned part is in the store
    (and rank 0's commit, at rank 0): every rank writes only what it
    owns, so a rank lost before its part lands would leave the step out
    of the store for all. ``num_layers`` above 0 cuts the model's
    depth. ``checksums`` journals ``state_checksums`` of each saved and
    each restored state. ``strategy`` is the ShardedTrainer's, on the
    mesh ``[(data, 1), (fsdp, world)]``. Returns what happened: the start
    step, each step's (start, end) shard and loss, the final step and
    the world."""
    cfg, optimizer = model_config(model, num_layers)
    world = dist.get_world_size() if dist.is_initialized() else 1
    client = build_master_client()
    mesh = create_mesh([("data", 1), ("fsdp", -1)], device=device)
    trainer = make_trainer_for_llama(cfg, device=device, strategy=strategy,
                                     optimizer=optimizer, mesh=mesh)
    trainer.init(seed=seed)
    # the parameters' device carries its index (cuda:0)
    on = next(trainer.model.parameters()).device
    if on.type == "cuda":
        torch.cuda.synchronize(on)
    record("train.model_ready", model=model, device=str(on))
    print(f"DEVICE {on}", flush=True)
    # the fixed global batch counts the mesh's data-parallel ranks
    elastic = ElasticTrainer(trainer, master_client=client,
                             report_interval=5)
    dataset_rows = dataset_rows or (
        steps * batch_size * data_parallel_size(mesh))
    sharding = None
    if num_workers == 0:
        sharding = ShardingClient(
            DATASET, batch_size, num_epochs=10**6,  # stream until --steps
            dataset_size=dataset_rows, shuffle=False,
            num_minibatches_per_shard=1, master_client=client,
        )
    ckpt_kwargs: Dict = {}
    shard_server = peer_tier(client, ckpt_kwargs)
    ckpt = FlashCheckpointer(
        persist_dir=os.path.join(ckpt_dir, "persist"),
        ram_dir=ram_dir or os.path.join(ckpt_dir, "ram"),
        persist_interval=persist_interval, **ckpt_kwargs,
    )
    if shard_server is not None:
        from dlrover_tpu_torch.telemetry.http import set_shard_provider

        set_shard_provider(ckpt.shard_provider())
    restored, _ = ckpt.restore(
        target={**trainer.train_state(), "step": 0, "data": ""})
    start_step = 0
    if restored is not None:
        trainer.load_train_state(restored)
        start_step = int(restored["step"])
        # one rank rewinds the master's ledger; every rank's copy is
        # the same (the barriers around each cadence save)
        if (sharding is not None and restored["data"]
                and (not dist.is_initialized() or dist.get_rank() == 0)
                and not sharding.restore_shard_from_checkpoint(
                    restored["data"])):
            raise RuntimeError("the master refused the shard checkpoint")
        stats = ckpt.last_restore_stats or {}
        record("train.restored", step=start_step, tier=stats.get("tier"),
               seconds=stats.get("seconds"),
               bytes=stats.get("archive_bytes"),
               peer_bytes=stats.get("peer_bytes", 0),
               rank=dist.get_rank() if dist.is_initialized() else 0,
               checksums=(state_checksums(restored) if checksums
                          else None))
        print(f"RESTORED from step {start_step}", flush=True)
    # no rank fetches a shard before the ledger is rewound
    barrier()
    elastic.attach_checkpointer(ckpt, save_interval=save_interval)

    def cadence_state():
        # every rank has reported its step's shard before any takes the
        # ledger, and none fetches the next before all have taken it
        barrier()
        state = checkpoint_state(trainer, step, sharding)
        barrier()
        if checksums:
            record("train.checksums", step=step,
                   rank=dist.get_rank() if dist.is_initialized() else 0,
                   sums=state_checksums(state))
        return state

    # page-lock the staging block while the first steps run
    ckpt.prepare(checkpoint_state(trainer, start_step, sharding))

    # the flash kernels launched from here on (none on the CPU)
    launched_before = dict(flash_attention.LAUNCHES)
    step, loss = start_step, float("nan")
    # the emergency save of a preemption: ``step`` is the last step
    # whose update and shard report are done (the drain runs between
    # steps, or at a step's end), and the state is built when it runs
    elastic.drain.set_state_provider(lambda: (
        step, lambda: checkpoint_state(trainer, step, sharding)))
    sentinel = elastic.sentinel
    shards: List = []
    losses: List[float] = []
    loader = batches = None
    if num_workers > 0:
        loader = shm_loader(client, trainer, elastic, cfg, batch_size,
                            seq_len, dataset_rows, num_workers)
        batches = iter(loader)
        record("data.coworkers", pids=loader.producer_pids,
               ring=loader.ring_name)
        print(f"DATA shm workers={num_workers}", flush=True)
    try:
        while step < steps:
            if batches is not None:
                item = next(batches, None)
                if item is None:
                    break
                batch, rows = item
            else:
                shard = sharding.fetch_shard()
                if shard is None:
                    break
                rows = (shard.start, shard.end)
                batch = trainer.shard_batch(elastic.microbatch(
                    synth_batch(shard.start, shard.end, seq_len,
                                cfg.vocab_size)))
            t_step = time.perf_counter()
            loss = elastic.report_step(step + 1,
                                       loss=elastic.train_step(batch))
            step_s = time.perf_counter() - t_step
            step += 1
            if sharding is not None:
                sharding.report_batch_done()
            shards.append(rows)
            losses.append(loss)
            record("train.step", step=step, loss=loss, rows=list(rows),
                   launches={k: n - launched_before[k]
                             for k, n in flash_attention.LAUNCHES.items()},
                   world=world, step_s=round(step_s, 6),
                   reduce_s=round(trainer.reduce_seconds, 6))
            print(f"step {step} loss {loss!r}"
                  + (f" world {world}" if world > 1 else ""), flush=True)
            if step == start_step + 1:
                t0 = time.perf_counter()
                prof = elastic.report_model_profile(
                    batch, batch_size=batch_size, seq_len=seq_len)
                if prof is not None:
                    record("train.profile", flops=prof.flops,
                           device=prof.device,
                           seconds=round(time.perf_counter() - t0, 3))
            order = (sentinel.pending_rollback()
                     if sentinel is not None else None)
            if order is not None:
                # the poisoned steps never reach a save; a notice during
                # the restore drains at the next step's dispatch
                step = rollback(order, trainer, sharding, ckpt, client,
                                sentinel)
                continue
            # durable: a crash drill hard-kills shortly after a cadence
            # step -- the archive must already be on the RAM tier
            stall_ms = elastic.maybe_checkpoint(cadence_state, durable=True)
            if stall_ms is not None:
                persist_wait_ms = 0.0
                if (world > 1 and persist_interval > 0
                        and step % persist_interval == 0):
                    t_wait = time.perf_counter()
                    ckpt.wait()
                    persist_wait_ms = (time.perf_counter() - t_wait) * 1e3
                stats = ckpt.save_stats.get(step, {})
                record("train.saved", step=step, stall_ms=stall_ms,
                       persist_wait_ms=persist_wait_ms,
                       archive_bytes=stats.get("archive_bytes"),
                       owned_bytes=stats.get("owned_bytes"),
                       rank=dist.get_rank() if dist.is_initialized() else 0)
    finally:
        if loader is not None:
            loader.shutdown()
        if sharding is not None:
            sharding.stop()
        elastic.drain.disarm()
        # flush the async save pipeline before exit
        ckpt.close()
        if shard_server is not None:
            shard_server.stop()
    return {"start_step": start_step, "step": step, "loss": loss,
            "shards": shards, "losses": losses, "world": world}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=("tiny", "llama_1b"),
                        default="tiny")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--save-interval", type=int, default=10)
    parser.add_argument("--ckpt-dir", type=str, default="/tmp/llama_ckpt")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the GPU")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num-workers", type=int, default=0,
                        help="coworker processes of the shm feed; 0 "
                             "fetches shards in this process")
    parser.add_argument("--dataset-rows", type=int, default=0,
                        help="rows the master shards (default: steps x "
                             "batch size x ranks)")
    parser.add_argument("--num-layers", type=int, default=0,
                        help="cut the model's depth (0: the config's)")
    parser.add_argument("--checksums", action="store_true",
                        help="journal the state's checksums at each save "
                             "and restore")
    parser.add_argument("--ram-dir", type=str, default="",
                        help="the RAM tier (default: <ckpt-dir>/ram)")
    parser.add_argument("--persist-interval", type=int, default=0,
                        help="persist every N-th step too (0: never)")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"),
                        default=None,
                        help="the process group's backend above one rank "
                             "(default: nccl on cards, gloo on the CPU; "
                             "gloo for ranks that share one card)")
    parser.add_argument("--strategy", choices=STRATEGIES, default="fsdp",
                        help="the ShardedTrainer strategy (the JAX "
                             "example's default: fsdp over all ranks)")
    parser.add_argument("--out", type=str, default="")
    args = parser.parse_args(argv)

    t0 = time.time()
    init_from_env(device=args.device, backend=args.dist_backend)
    result = run(args.steps, args.ckpt_dir, batch_size=args.batch_size,
                 seq_len=args.seq_len, device=args.device,
                 save_interval=args.save_interval, seed=args.seed,
                 model=args.model, num_workers=args.num_workers,
                 dataset_rows=args.dataset_rows, ram_dir=args.ram_dir,
                 persist_interval=args.persist_interval,
                 num_layers=args.num_layers, checksums=args.checksums,
                 strategy=args.strategy)
    print(f"FINAL step={result['step']} loss={result['loss']:.6f} "
          f"world={result['world']}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(f"{result['step']},{result['loss']:.6f},"
                    f"{result['start_step']}")
    print(f"elapsed {time.time() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
