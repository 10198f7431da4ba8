"""Master entry (parity: dlrover/python/master/main.py:36).

Counterpart of ``dlrover_tpu/master/main.py`` for the local platform:
``--platform local`` runs a :class:`~dlrover_tpu_torch.master.
local_master.LocalJobMaster` and prints ``DLROVER_TPU_MASTER_PORT=<port>``
for the launcher; the distributed platforms raise until the distributed
master is ported (ROADMAP.md, queue A).

    python -m dlrover_tpu_torch.master.main --platform local --node_num 1
"""

import sys

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.args import parse_master_args


def run(args) -> int:
    if args.platform != "local":
        raise NotImplementedError(
            f"--platform {args.platform}: only the local master is "
            "ported (ROADMAP.md, queue A)"
        )
    from dlrover_tpu_torch.master.local_master import LocalJobMaster

    # the local job manager reads only ``node_num`` from its job args
    master = LocalJobMaster(port=args.port, job_args=args)
    master.prepare()
    # print the bound port so a parent launcher can discover it
    print(f"DLROVER_TPU_MASTER_PORT={master.port}", flush=True)
    return master.run(check_interval=args.check_interval)


#: deliberate job failure (workers failed) — distinct from a master
#: CRASH (python traceback rc=1, signals <0)
JOB_FAILED_EXIT_CODE = 3


def main(argv=None) -> int:
    args = parse_master_args(argv)
    logger.info("Starting master: %s", vars(args))
    rc = run(args)
    return JOB_FAILED_EXIT_CODE if rc else 0


if __name__ == "__main__":
    sys.exit(main())
