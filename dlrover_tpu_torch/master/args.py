"""Master CLI args (parity: dlrover/python/master/args.py:19-95).

Counterpart of ``dlrover_tpu/master/args.py``, with its full flag set.
The Brain's flags (``--brain_addr``, ``--brain_store_path``) parse, and
the distributed master refuses them (ROADMAP.md, queue A.2.4).
"""

import argparse


def str2bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "t", "y")


def parse_master_args(argv=None):
    parser = argparse.ArgumentParser(description="dlrover-tpu job master")
    parser.add_argument("--port", type=int, default=0,
                        help="RPC port; 0 picks a free port")
    parser.add_argument("--job_name", type=str, default="local-job")
    parser.add_argument("--platform", type=str, default=None,
                        choices=["local", "process", "tpu_vm"],
                        help="default: the job spec's platform, else "
                             "local")
    parser.add_argument("--host", type=str, default="",
                        help="externally-reachable master host baked into "
                             "worker metadata (default: this host's "
                             "primary IP; 'localhost' for local runs)")
    parser.add_argument("--distribution_strategy", type=str,
                        default="allreduce")
    parser.add_argument("--node_num", type=int, default=None,
                        help="expected number of worker nodes; "
                             "overrides the job spec when given")
    parser.add_argument("--namespace", type=str, default="default")
    parser.add_argument("--pending_timeout", type=int, default=900)
    parser.add_argument("--relaunch_always", type=str2bool, default=False)
    parser.add_argument("--heartbeat_timeout", type=float, default=None,
                        help="seconds without an agent heartbeat before "
                             "the master declares the node dead "
                             "(default 90)")
    parser.add_argument("--job_spec", type=str, default="",
                        help="path to a declarative ElasticTpuJob "
                             "JSON (or YAML, where yaml imports) spec "
                             "(scheduler/job_spec.py)")
    parser.add_argument("--autoscale_interval", type=float, default=60.0,
                        help="seconds between auto-scaler optimize "
                             "passes (speed-window + straggler shrink)")
    parser.add_argument("--brain_store_path", type=str, default="",
                        help="directory for the durable cross-run "
                             "stats archive; refused until brain/ is "
                             "ported")
    parser.add_argument("--state_dir", type=str, default="",
                        help="directory for the durable master "
                             "job-state journal (master failover); "
                             "overrides DLROVER_TPU_MASTER_STATE_DIR. "
                             "Off when neither is set")
    parser.add_argument("--fresh", action="store_true",
                        help="discard any prior journaled state for "
                             "this job instead of restoring it")
    parser.add_argument("--check_interval", type=float, default=3.0,
                        help="seconds between master run-loop checks "
                             "(job completion, hang, fault injection)")
    parser.add_argument("--brain_addr", type=str, default="",
                        help="host:port of the standalone Brain "
                             "service; refused until brain/ is ported")
    return parser.parse_args(argv)
