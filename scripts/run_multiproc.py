#!/usr/bin/env python
"""Launch a REAL two-process ``jax.distributed`` job on this host and verify
the cross-process sharded solve (scripts/multiproc_worker.py).

This is the executable proof of the multi-host communication layer
(dist/multihost.py): two OS processes, a localhost coordinator, gloo CPU
collectives, one global 8-device mesh (4 virtual devices per process), a
psum crossing the process boundary, and ``sharded_minimize`` returning the
same answer as a single-process solve.  The same program shape runs across
GPU hosts with NCCL collectives instead of gloo.

Usage:
    python scripts/run_multiproc.py [--num-processes 2] [--out MULTIPROC.json]

Exit code 0 iff every worker passed all its assertions.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(num_processes: int = 2, timeout_s: float = 300.0) -> dict:
    port = free_port()
    coordinator = f"localhost:{port}"
    worker = REPO / "scripts" / "multiproc_worker.py"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)           # worker sets its own device count
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs, outs = [], []
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        for pid in range(num_processes):
            out = Path(td) / f"worker{pid}.json"
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, str(worker), str(pid), str(num_processes),
                 coordinator, str(out)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env, cwd=str(REPO)))
        logs, rcs = [], []
        for p in procs:
            try:
                stdout, _ = p.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, _ = p.communicate()
                stdout += "\n[launcher] TIMEOUT"
            logs.append(stdout)
            rcs.append(p.returncode)
        wall = time.perf_counter() - t0
        workers = []
        for out in outs:
            workers.append(json.loads(out.read_text()) if out.exists()
                           else None)
    ok = (all(rc == 0 for rc in rcs)
          and all(w is not None and w.get("ok") for w in workers))
    return {
        "ok": ok,
        "num_processes": num_processes,
        "coordinator": coordinator,
        "wall_s": round(wall, 1),
        "return_codes": rcs,
        "workers": workers,
        "logs_tail": ["\n".join(l.strip().splitlines()[-6:]) for l in logs],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args()
    record = run(args.num_processes, args.timeout)
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps({k: record[k] for k in
                      ("ok", "num_processes", "wall_s", "return_codes")}))
    if not record["ok"]:
        for log in record["logs_tail"]:
            print("--- worker log tail ---\n" + log, file=sys.stderr)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
