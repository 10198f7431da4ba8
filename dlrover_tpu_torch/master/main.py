"""Master entry (parity: dlrover/python/master/main.py:36).

Counterpart of ``dlrover_tpu/master/main.py``: ``--platform local`` runs
a :class:`~dlrover_tpu_torch.master.local_master.LocalJobMaster`;
``--platform process`` runs a :class:`~dlrover_tpu_torch.master.
dist_master.DistributedJobMaster` with the process scaler and watcher
from ``scheduler/factory.py``, whose ``tpu_vm`` raises (no counterpart
this round, ROADMAP.md). ``--job_spec`` ingests a declarative
ElasticTpuJob document (scheduler/job_spec.py) and CLI flags override
it. The bound port is printed as ``DLROVER_TPU_MASTER_PORT=<port>`` for
the launcher; a failed job exits with :data:`JOB_FAILED_EXIT_CODE`.

    python -m dlrover_tpu_torch.master.main --platform process \\
        --job_spec job.json --state_dir state --port 50051
"""

import sys

from dlrover_tpu_torch.common.grpc_utils import find_free_port
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.args import parse_master_args
from dlrover_tpu_torch.scheduler.job_spec import JobArgs


def build_job_args(args) -> JobArgs:
    if getattr(args, "job_spec", ""):
        # --platform (when given) overrides the spec's own platform
        job_args = JobArgs.from_file(args.job_spec,
                                     platform=args.platform)
        # CLI overrides for the handful of flags that also exist here
        if args.node_num is not None:
            job_args.node_num = args.node_num
        if args.heartbeat_timeout is not None:
            job_args.heartbeat_timeout = args.heartbeat_timeout
        if args.namespace != "default":
            job_args.namespace = args.namespace
        if getattr(args, "brain_addr", ""):
            job_args.brain_addr = args.brain_addr
        if getattr(args, "brain_store_path", ""):
            job_args.brain_store_path = args.brain_store_path
        return job_args
    return JobArgs(
        job_name=args.job_name,
        platform=args.platform or "local",
        namespace=args.namespace,
        node_num=args.node_num if args.node_num is not None else 1,
        distribution_strategy=args.distribution_strategy,
        heartbeat_timeout=args.heartbeat_timeout,
        relaunch_always=args.relaunch_always,
        brain_addr=getattr(args, "brain_addr", "") or "",
        brain_store_path=getattr(args, "brain_store_path", "") or "",
    )


def _master_host(args) -> str:
    """The address workers dial. JAX defaults to this host's outbound IP
    for the cloud platforms; the port's platforms (``process``,
    ``local``) run on one host, so ``localhost`` unless ``--host``."""
    return args.host or "localhost"


def run(args) -> int:
    # arm the lock-order watchdog FIRST (no-op unless
    # DLROVER_TPU_LOCKWATCH=1): the wrap only catches locks created
    # after install, so it must precede master construction
    from dlrover_tpu_torch.telemetry import lockwatch

    lockwatch.install()
    job_args = build_job_args(args)
    if job_args.platform == "local":
        from dlrover_tpu_torch.master.local_master import LocalJobMaster

        master = LocalJobMaster(port=args.port, job_args=job_args)
    else:
        from dlrover_tpu_torch.master.dist_master import DistributedJobMaster
        from dlrover_tpu_torch.scheduler.factory import build_platform

        # The scaler bakes the master address into worker metadata, so
        # the port must be fixed before the platform is built. Probing a
        # free port then binding is racy, so retry on bind failure.
        master = None
        for attempt in range(3):
            port = args.port or find_free_port()
            scaler, watcher = build_platform(
                job_args,
                f"{_master_host(args)}:{port}",
            )
            try:
                master = DistributedJobMaster(
                    port=port, job_args=job_args, scaler=scaler,
                    watcher=watcher,
                    autoscale_interval=args.autoscale_interval,
                    state_dir=args.state_dir or None,
                    fresh=args.fresh,
                )
                break
            except Exception as e:
                if args.port or attempt == 2:
                    raise
                logger.warning(
                    "port %d lost to a race (%s); retrying", port, e
                )
        assert master is not None
    master.prepare()
    # print the bound port so a parent launcher can discover it
    print(f"DLROVER_TPU_MASTER_PORT={master.port}", flush=True)
    return master.run(check_interval=args.check_interval or 3.0)


#: deliberate job failure (workers failed / critical node lost / hang
#: verdict) — distinct from a master CRASH (python traceback rc=1,
#: signals <0) so the operator fails the job instead of relaunching a
#: doomed run
JOB_FAILED_EXIT_CODE = 3


def main(argv=None) -> int:
    args = parse_master_args(argv)
    logger.info("Starting master: %s", vars(args))
    rc = run(args)
    return JOB_FAILED_EXIT_CODE if rc else 0


if __name__ == "__main__":
    sys.exit(main())
