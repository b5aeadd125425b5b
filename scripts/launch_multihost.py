#!/usr/bin/env python3
"""CPU rehearsal of an N-process multi-host decode job on one machine, or
print the per-host commands for a real cluster.

The local run is pinned to the CPU (JAX_PLATFORMS=cpu, NDS_FORCE_CPU=1):
each process gets --xla_force_host_platform_device_count=<devices-per-host>
virtual devices, connected through a local coordinator — the same code
path as N GPU hosts, without touching a card.

    python scripts/launch_multihost.py --num-processes 2 \
        --post-dir POSTS --outdir LISTS --experiment 7
"""
import argparse
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--devices-per-host", type=int, default=2)
    ap.add_argument("--post-dir", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--experiment", type=int, default=7)
    ap.add_argument("--list-size", type=int, default=8)
    ap.add_argument("--max-deviation", type=int, default=20)
    ap.add_argument("--local-batch", type=int, default=4)
    ap.add_argument("--print-only", action="store_true",
                    help="print per-host commands for a real cluster")
    args = ap.parse_args()

    port = free_port()
    base = [sys.executable, "-m",
            "nanopore_dna_storage.parallel.multihost",
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(args.num_processes),
            "--post-dir", args.post_dir, "--outdir", args.outdir,
            "--experiment", str(args.experiment),
            "--list-size", str(args.list_size),
            "--max-deviation", str(args.max_deviation),
            "--local-batch", str(args.local_batch)]
    if args.print_only:
        for i in range(args.num_processes):
            print(" ".join(base + ["--process-id", str(i)]))
        return

    procs = []
    for i in range(args.num_processes):
        env = dict(os.environ,
                   JAX_PLATFORMS="cpu",
                   NDS_FORCE_CPU="1",
                   XLA_FLAGS=("--xla_force_host_platform_device_count="
                              f"{args.devices_per_host}"),
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            base + ["--process-id", str(i)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    rc = 0
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=1800)
        print(f"--- process {i} (rc={p.returncode}) ---")
        print(out[-2000:])
        rc |= p.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
