"""Drill worker for the port's master-kill failover test (not a test
module): ``tests/_master_failover_worker.py`` over the port's
``MasterClient`` and ``ShardingClient``, with the rendezvous wait
bounded by ``--rdzv_timeout``.

Speaks the real agent protocol against a live master: joins the
training rendezvous, consumes data shards via ShardingClient (which
registers the dataset re-hello reconnect hook), reports the global
step (the master's fault injector counts these), and — the moment its
connection supervisor reconnects to the restarted master — re-joins
the rendezvous mid-epoch so the test can assert the round counter
stayed monotonic across the restart.

Every consumed shard range is appended to --out as ``SHARD <start>
<end>`` the moment the task arrives; the test unions both workers'
ranges to prove exactly-once delivery across the crash.
"""

import argparse
import sys
import threading
import time


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--master_addr", required=True)
    p.add_argument("--node_id", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--dataset_size", type=int, default=96)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--shard_secs", type=float, default=0.08,
                   help="simulated train time per shard")
    p.add_argument("--rdzv_timeout", type=float, default=60.0,
                   help="seconds a rendezvous may take before the "
                        "worker gives up")
    args = p.parse_args()

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.agent.sharding.client import ShardingClient
    from dlrover_tpu_torch.common.constants import RendezvousName

    out = open(args.out, "w", buffering=1)

    def emit(line: str):
        out.write(line + "\n")
        print(f"[worker {args.node_id}] {line}", flush=True)

    client = MasterClient(
        args.master_addr, node_id=args.node_id, node_type="worker",
    )
    reconnected = threading.Event()
    client.add_reconnect_hook("drill-flag", reconnected.set)

    def rendezvous(tag: str, min_round: int = 0) -> int:
        client.join_rendezvous(args.node_id, 1)
        deadline = time.monotonic() + args.rdzv_timeout
        while True:
            rdzv_round, _, world = client.get_comm_world(
                RendezvousName.TRAINING, args.node_id
            )
            if (world and args.node_id in world
                    and rdzv_round >= min_round):
                emit(f"{tag} {rdzv_round}")
                return rdzv_round
            if time.monotonic() > deadline:
                emit(f"ERROR {tag} timeout")
                raise TimeoutError(tag)
            time.sleep(0.2)

    # ---- rendezvous round 1 (pre-crash) -----------------------------
    client.report_rdzv_params(
        min_nodes=2, max_nodes=2, waiting_timeout=0.5, node_unit=1,
    )
    round1 = rendezvous("ROUND1")

    # ---- consume the dataset ---------------------------------------
    # fetch_batch puts the batched get_tasks RPC (and its group-commit
    # journal write) on the drill's hot path: shards buffered when the
    # master dies are restored in its doing set under THIS worker, and
    # the exactly-once partition assert covers them
    sharding = ShardingClient(
        dataset_name="failover-drill",
        batch_size=args.batch_size,
        num_epochs=1,
        dataset_size=args.dataset_size,
        shuffle=False,
        num_minibatches_per_shard=1,
        master_client=client,
        fetch_batch=3,
    )
    step = 0
    round2_done = False
    while True:
        if reconnected.is_set() and not round2_done:
            # master restarted under us: prove the restored round
            # counter never regressed by completing a fresh rendezvous
            # mid-epoch (both workers reconnect, so both re-join)
            rendezvous("ROUND2", min_round=round1 + 1)
            round2_done = True
        shard = sharding.fetch_shard(poll_interval=0.2, max_wait=120.0)
        if shard is None:
            break
        emit(f"SHARD {shard.start} {shard.end}")
        time.sleep(args.shard_secs)
        step += 1
        # the master-side fault injector triggers off these reports
        client.report_global_step(step)
        assert sharding._current_task is not None
        sharding.report_task_done(sharding._current_task.task_id)

    if not round2_done:
        emit("ERROR never reconnected (master crash not observed)")
        return 5
    emit("DONE")
    client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
