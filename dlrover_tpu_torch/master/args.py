"""Master CLI args (parity: dlrover/python/master/args.py:19-95).

Counterpart of ``dlrover_tpu/master/args.py`` with the flags of the
local platform. The distributed master's flags (host, namespace, job
spec, heartbeat timeout, auto-scaling, Brain, state journal) come with
the distributed master (ROADMAP.md, queue A).
"""

import argparse


def parse_master_args(argv=None):
    parser = argparse.ArgumentParser(description="dlrover-tpu job master")
    parser.add_argument("--port", type=int, default=0,
                        help="RPC port; 0 picks a free port")
    parser.add_argument("--platform", type=str, default="local",
                        choices=["local", "process", "tpu_vm"],
                        help="only 'local' is ported")
    parser.add_argument("--node_num", type=int, default=1,
                        help="expected number of worker nodes")
    parser.add_argument("--check_interval", type=float, default=3.0,
                        help="seconds between master run-loop checks "
                             "(job completion)")
    return parser.parse_args(argv)
