"""Local multi-process launcher for torch.distributed (torchrun-style).

Port of ``deplex_tpu.parallel.launcher``. Starts N processes on this host
as one process group and gives each the env contract that
``parallel.distributed.initialize`` reads:

    MASTER_ADDR=127.0.0.1, MASTER_PORT   process 0's rendezvous endpoint
    WORLD_SIZE, RANK, LOCAL_RANK          group size, rank, index on the host
    DEPLEX_DEVICE                         --device (cuda or cpu), if given
    DEPLEX_BACKEND                        --backend (nccl or gloo), if given

A CUDA rank takes card LOCAL_RANK % device_count, so N ranks share a card
when there are fewer cards than ranks; that needs gloo (NCCL refuses two
ranks on one device). Each rank's output goes to a file, not a pipe, so no
rank blocks on a full pipe while another waits for it in a collective. When
a rank fails, or at the timeout, every rank still running is killed and
``launch`` raises with each failed rank's output tail.

CLI:

    python -m deplex_tpu_torch.parallel.launcher --nprocs 2 --device cuda \\
        --backend gloo -- python -m deplex_tpu_torch.parallel.verify --out DIR
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass


def find_free_port() -> int:
    """A free TCP port on the loopback interface (the rendezvous endpoint)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class ProcessResult:
    process_id: int
    returncode: int
    stdout: str
    stderr: str


def launch(cmd: list[str], num_processes: int, *, device: str | None = None,
           backend: str | None = None, port: int | None = None,
           extra_env: dict[str, str] | None = None,
           timeout: float = 600.0) -> list[ProcessResult]:
    """Run `cmd` in `num_processes` local processes forming one process
    group; returns their results in rank order. Raises if a rank failed or
    the group outlived `timeout` seconds (the ranks still running are
    killed).

    cmd: the worker's argv (a `python` prefix is added when cmd[0] ends in
    .py). device, backend: exported as DEPLEX_DEVICE, DEPLEX_BACKEND."""
    if num_processes < 1:
        raise ValueError("num_processes must be >= 1")
    if port is None:
        port = find_free_port()
    if cmd and cmd[0].endswith(".py"):
        cmd = [sys.executable] + list(cmd)

    procs, files = [], []
    try:
        for rank in range(num_processes):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(num_processes), RANK=str(rank), LOCAL_RANK=str(rank),
                       LOCAL_WORLD_SIZE=str(num_processes))
            if device:
                env["DEPLEX_DEVICE"] = device
            if backend:
                env["DEPLEX_BACKEND"] = backend
            env.update(extra_env or {})
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            files.append((out, err))
            procs.append(subprocess.Popen(cmd, env=env, stdout=out, stderr=err, text=True))

        deadline = time.monotonic() + timeout
        timed_out = False
        while None in (codes := [p.poll() for p in procs]):
            if any(c not in (None, 0) for c in codes):
                break           # a rank failed: the others would wait for it
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        results = []
        for rank, (p, (out, err)) in enumerate(zip(procs, files)):
            out.seek(0)
            err.seek(0)
            results.append(ProcessResult(rank, p.returncode, out.read(), err.read()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()

    failed = [r for r in results if r.returncode != 0]
    if failed:
        detail = "\n".join(f"--- process {r.process_id} (rc={r.returncode}) ---\n"
                           f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}" for r in failed)
        why = f"timed out after {timeout} s; " if timed_out else ""
        raise RuntimeError(f"{why}{len(failed)}/{num_processes} launched processes "
                           f"failed:\n{detail}")
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Launch N local processes as one torch.distributed group.")
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="device of every rank (DEPLEX_DEVICE; default: the card)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend (DEPLEX_BACKEND; default: nccl on "
                         "cuda, gloo on cpu)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER, help="worker command (after --)")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no worker command given")
    results = launch(cmd, args.nprocs, device=args.device, backend=args.backend,
                     timeout=args.timeout)
    for r in results:
        sys.stdout.write(r.stdout)
        sys.stderr.write(r.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
