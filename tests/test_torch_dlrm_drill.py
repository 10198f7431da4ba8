"""The DLRM example under the port's launcher on the CPU: ``crash@12``
kills the worker after step 12, the agent restarts it, it restores the
durable step-10 save (model and Adagrad state) and trains to step 14."""

import os
import subprocess
import sys

from tests.test_torch_launcher import REPO, step_losses

EXAMPLE = os.path.join(REPO, "dlrover_tpu_torch", "examples", "dlrm_train.py")


def test_crash_drill_restores_step_10(tmp_path):
    out = str(tmp_path / "out.txt")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DLROVER_TPU_", "DLROVER_FAULT"))}
    env["DLROVER_FAULT_INJECT"] = "crash@12"
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
         "--standalone", "--nnodes", "1:1", "--monitor_interval", "0.3",
         "--max_restarts", "2", EXAMPLE, "--", "--steps", "14",
         "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"),
         "--out", out],
        cwd=REPO, env=env, timeout=120, capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    assert proc.returncode == 0, text[-3000:]
    assert "INJECTED CRASH rc=17 at step 12" in proc.stdout
    assert "RESTORED from step 10" in proc.stdout
    assert "FINAL step=14" in proc.stdout
    first, second = step_losses(proc.stdout)
    # the crash fires inside step 12's report, before its line
    assert max(first) == 11 and sorted(second) == [11, 12, 13, 14]
    step, loss, acc, start = open(out).read().split(",")
    assert (int(step), int(start)) == (14, 10)
    assert 0 < float(loss) < 1 and 0 <= float(acc) <= 1
