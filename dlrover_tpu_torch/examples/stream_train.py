"""Streaming-source elastic workload (unbounded-splitter partitions).

    python -m dlrover_tpu_torch.trainer.elastic_run --standalone \
        --nnodes 1:1 --max_restarts 2 \
        dlrover_tpu_torch/examples/stream_train.py -- \
        --total 2000 --batch-size 100 --progress /tmp/progress.txt \
        --crash-after 5

The master-side streaming pipeline (StreamingDatasetSplitter partition
offsets -> StreamingDatasetManager tasks) consumed end to end through
the launcher: the worker fetches partition-offset shards, simulates
train time, and records completed ranges. ``--crash-after N`` makes
incarnation 0 FETCH one more shard and die WITHOUT reporting it — the
orphaned in-flight offset range must be re-delivered (task-timeout
watchdog / node-failure recovery) to the restarted worker, never lost
and never duplicated. Right before dying it snapshots the master's
shard checkpoint (the get_shard_checkpoint RPC) so the drill can
assert the orphan really was tracked as in-flight.

Counterpart of ``examples/stream_train.py``, over the port's launcher,
master and sharding client; it touches no device.
"""

import argparse
import os
import sys
import time

from dlrover_tpu_torch.agent.master_client import build_master_client
from dlrover_tpu_torch.agent.sharding.client import ShardingClient
from dlrover_tpu_torch.common.constants import NodeEnv


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--total", type=int, default=2000,
                        help="bounded stream length (so the run ends)")
    parser.add_argument("--batch-size", type=int, default=100)
    parser.add_argument("--batch-seconds", type=float, default=0.05)
    parser.add_argument("--crash-after", type=int, default=0,
                        help="incarnation 0 dies after N completions "
                             "with one shard fetched but unreported")
    parser.add_argument("--progress", type=str, required=True)
    args = parser.parse_args(argv)

    restart = int(os.getenv(NodeEnv.RESTART_COUNT, "0"))
    client = build_master_client()
    sharding = ShardingClient(
        dataset_name="stream-e2e", batch_size=args.batch_size,
        num_epochs=1, dataset_size=args.total,
        num_minibatches_per_shard=1, master_client=client,
        storage_type="stream",
    )
    print(f"WORLD restart={restart}", flush=True)

    done = 0
    while True:
        shard = sharding.fetch_shard()
        if shard is None:
            break
        if args.crash_after and restart == 0 and done >= args.crash_after:
            # die with this shard IN FLIGHT (fetched, never reported):
            # the master must re-deliver exactly this offset range
            ckpt = sharding.get_shard_checkpoint()
            print(f"SHARD_CKPT {ckpt}", flush=True)
            print(
                f"CRASH holding {shard.name}:{shard.start}-{shard.end}",
                flush=True,
            )
            os._exit(17)
        time.sleep(args.batch_seconds)
        if not sharding.report_batch_done():
            continue
        done += 1
        with open(args.progress, "a") as f:
            f.write(
                f"{shard.name},{shard.start},{shard.end},{restart},"
                f"{time.time()}\n"
            )
    print(f"FINAL restart={restart} shards={done}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
