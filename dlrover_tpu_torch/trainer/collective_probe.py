"""Which collectives a backend takes CUDA tensors for, probed on a card.

    python -m dlrover_tpu_torch.trainer.collective_probe [--backend gloo]

Each op runs in a pair of rank processes of its own on ``cuda:0`` (all
pairs at once), so an op that crashes its processes leaves the other
answers standing. A rank holds a CUDA tensor of known values, runs the
op and checks what arrives. Prints one JSON line, ``{op: "ok" | "wrong
values" | "error: ..." | "exit N"}``: what ``trainer/distributed.py``'s
``collective_route`` table is written from.
"""

import argparse
import json
import os
import socket
import subprocess
import sys

OPS = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
       "send_recv", "all_to_all_single")

_RANK = """
import datetime, sys, torch, torch.distributed as dist
op, backend, port, rank = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
    int(sys.argv[4])
store = dist.TCPStore("localhost", port, 2, is_master=rank == 0,
                      timeout=datetime.timedelta(seconds=60))
dist.init_process_group(backend, store=store, world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
dev = torch.device("cuda:0")
x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
try:
    if op == "all_reduce":
        dist.all_reduce(x)
        want = torch.arange(4.0) * 2 + 10
    elif op == "reduce_scatter_tensor":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        x, want = out, (torch.arange(4.0) * 2 + 10)[2 * rank:2 * rank + 2]
    elif op == "all_gather_into_tensor":
        out = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(out, x)
        x, want = out, torch.cat([torch.arange(4.0), torch.arange(4.0) + 10])
    elif op == "send_recv":
        out = torch.empty(4, device=dev)
        req = dist.isend(x, 1 - rank)
        dist.recv(out, 1 - rank)
        req.wait()
        x, want = out, torch.arange(4.0) + 10 * (1 - rank)
    elif op == "all_to_all_single":
        out = torch.empty(4, device=dev)
        dist.all_to_all_single(out, x)
        want = torch.cat([torch.arange(4.0)[2 * rank:2 * rank + 2],
                          torch.arange(4.0)[2 * rank:2 * rank + 2] + 10])
        x = out
    torch.cuda.synchronize()
    print("RESULT", "ok" if torch.equal(x.cpu(), want) else "wrong values")
except Exception as e:
    print("RESULT", "error: " + str(e).splitlines()[0][:200])
sys.stdout.flush()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def probe(backend: str = "gloo", timeout_s: float = 120.0) -> dict:
    """{op: answer} for :data:`OPS` under ``backend`` on ``cuda:0``."""
    procs = {}
    for op in OPS:
        port = _free_port()
        procs[op] = [subprocess.Popen(
            [sys.executable, "-c", _RANK, op, backend, str(port), str(r)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "OMP_NUM_THREADS": "1"})
            for r in range(2)]
    out = {}
    for op, ps in procs.items():
        answers = []
        for p in ps:
            try:
                log = p.communicate(timeout=timeout_s)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                log = p.communicate()[0]
            lines = [ln for ln in log.splitlines()
                     if ln.startswith("RESULT ")]
            answers.append(lines[-1][7:] if lines
                           else f"exit {p.returncode}")
        out[op] = next((a for a in answers if a != "ok"), "ok")
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--backend", default="gloo")
    args = parser.parse_args()
    import torch

    print(json.dumps({"backend": args.backend, "device": "cuda:0",
                      "torch": torch.__version__,
                      "ops": probe(args.backend)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
