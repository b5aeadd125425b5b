"""Multi-host decode driver test: 2 simulated processes on CPU.

Spawns two coordinator-connected jax.distributed processes (2 virtual CPU
devices each = a 4-device global mesh), runs the full multi-host decode job
over a shared .post directory, and checks the merged list files against a
single-process decode of the same posts. This exercises the exact code path
an N-host GPU cluster would run (global mesh, process-local feeding,
cross-host reduction) — the replacement for the reference's shard-and-merge
scripts (util/extra/generate_read_id_files.py, merge_lists.py).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["oracle", "traceback"])
def test_multihost_decode_job(tmp_path, backend):
    from nanopore_dna_storage.config import ConvCodeConfig
    from nanopore_dna_storage.coding.conv import (conv_encode_bases,
                                                      make_conv_code)
    from nanopore_dna_storage.coding.framing import frame_oligos
    from nanopore_dna_storage.config import ExperimentConfig
    from nanopore_dna_storage.ops.synthetic import synthetic_post
    from nanopore_dna_storage.io.post import write_post

    exp = ExperimentConfig(bytes_per_oligo=4, rs_redundancy=0.3,
                           conv_mem=6, conv_rate=1)
    msg_len = exp.msg_len()
    cfg = ConvCodeConfig(mem=6, rate=1, msg_len=msg_len)
    code = make_conv_code(cfg)
    rng = np.random.default_rng(7)
    n_reads = 6
    payloads = rng.integers(0, 256, (n_reads, exp.bytes_per_oligo), np.uint8)
    msgs = frame_oligos(payloads, exp.framing, pad=exp.pad)
    bases = conv_encode_bases(code, msgs)
    post_dir = tmp_path / "posts"
    post_dir.mkdir()
    for i, b in enumerate(bases):
        write_post(str(post_dir / f"read_{i}.post"),
                   synthetic_post(b, rng, noise=0.8))

    outdir = tmp_path / "lists"
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ,
                   JAX_PLATFORMS="cpu", NDS_FORCE_CPU="1",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "nanopore_dna_storage.parallel.multihost",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "--post-dir", str(post_dir), "--outdir", str(outdir),
             "--experiment", "-1", "--list-size", "2",
             "--max-deviation", "16", "--local-batch", "2",
             "--bytes-per-oligo", str(exp.bytes_per_oligo),
             "--mem", "6", "--rate", "1", "--backend", backend],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=1500)
        outs.append(out)
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)

    # every read decodes to its true message in the top list entry
    from nanopore_dna_storage.io.lists import read_list_file
    want = ["".join(map(str, m)) for m in msgs]
    got_top = []
    for i in range(n_reads):
        lst = read_list_file(str(outdir), i)
        assert lst, f"missing list_{i}"
        got_top.append(lst[0])
    assert got_top == want

    # global crc count reported identically by both processes
    crcs = [l for o in outs for l in o.splitlines() if "crc_pass=" in l]
    assert len(crcs) == 2
    vals = {l.split("crc_pass=")[1] for l in crcs}
    assert vals == {str(n_reads)}
