#!/usr/bin/env python3
"""Generate golden test vectors from the reference C++ viterbi binary.

Run once in the build environment (requires the reference binary compiled from
/root/reference/viterbi/viterbi_convolutional_code.cpp at /tmp/refbin/). The
outputs are committed under tests/golden so the test suite is hermetic.

Golden sets:
  encode/: for each (mem, rate): random messages + reference-encoded oligos.
  decode/: for each (mem, rate, rc, list_size): a synthetic .post file plus the
           reference decoded list. The synthetic posterior is built by emitting
           the true base sequence through a toy flip-flop channel with noise,
           so the decode is non-trivial but reproducible.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
REF_BIN = os.environ.get("REF_VITERBI", "/tmp/refbin/viterbi_nanopore.out")
GOLDEN = REPO / "tests" / "golden"

from nanopore_dna_storage.coding.conv import (  # noqa: E402
    ConvCodeConfig, make_conv_code, conv_encode_bases, bases_to_str,
)
from nanopore_dna_storage.ops.synthetic import synthetic_post  # noqa: E402


def pick_msg_len(mem: int, rate: int, target: int = 100) -> int:
    """Smallest msg_len >= target with an even encoded bit count."""
    for msg_len in range(target, target + 4):
        try:
            make_conv_code(ConvCodeConfig(mem=mem, rate=rate, msg_len=msg_len))
            return msg_len
        except ValueError:
            continue
    raise AssertionError("no valid msg_len found")


def run_ref_encode(msgs, mem, rate, msg_len, outdir):
    infile = outdir / "msgs.txt"
    outfile = outdir / "oligos.txt"
    with open(infile, "w") as f:
        for m in msgs:
            f.write("".join(map(str, m)) + "\n")
    subprocess.run(
        [REF_BIN, "-m", "encode", "-i", str(infile), "-o", str(outfile),
         "--mem-conv", str(mem), "--msg-len", str(msg_len), "-r", str(rate)],
        check=True, capture_output=True)
    return outfile.read_text().split()


def main():
    rng = np.random.default_rng(20260817)
    enc_dir = GOLDEN / "encode"
    enc_dir.mkdir(parents=True, exist_ok=True)
    manifest = []
    for mem in (6, 8, 11, 14):
        for rate in (1, 2, 3, 4, 5, 7):
            msg_len = pick_msg_len(mem, rate)
            msgs = rng.integers(0, 2, size=(8, msg_len), dtype=np.uint8)
            oligos = run_ref_encode(msgs, mem, rate, msg_len, enc_dir)
            name = f"m{mem}_r{rate}"
            np.save(enc_dir / f"{name}_msgs.npy", msgs)
            with open(enc_dir / f"{name}_oligos.txt", "w") as f:
                f.write("\n".join(oligos) + "\n")
            manifest.append({"mem": mem, "rate": rate, "msg_len": msg_len,
                             "name": name})
    with open(enc_dir / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"encode goldens: {len(manifest)} configs")

    # decode goldens: synthetic posts decoded by the reference binary
    dec_dir = GOLDEN / "decode"
    dec_dir.mkdir(parents=True, exist_ok=True)
    cases = []
    for mem, rate, rc, list_size, dev in [
        (6, 1, False, 1, None), (6, 1, False, 4, None), (6, 1, True, 4, None),
        (6, 3, False, 4, None), (6, 5, False, 8, None), (6, 5, True, 8, None),
        (6, 2, False, 2, None), (6, 4, False, 2, None), (6, 7, True, 2, None),
        (8, 1, False, 4, 8), (8, 5, False, 8, 8), (8, 5, True, 8, 8),
        (8, 3, True, 4, 8), (11, 5, False, 8, 8), (11, 5, True, 8, 8),
        (14, 1, False, 2, 6),
    ]:
        msg_len = pick_msg_len(mem, rate, 48 if mem <= 8 else 60)
        code = make_conv_code(ConvCodeConfig(mem=mem, rate=rate, msg_len=msg_len))
        msg = rng.integers(0, 2, size=(1, msg_len), dtype=np.uint8)
        bases = conv_encode_bases(code, msg)[0]
        seq = bases_to_str(bases)[0]
        post = synthetic_post(bases, rng, rc=rc, noise=1.0, stay_prob=0.35)
        name = f"m{mem}_r{rate}_rc{int(rc)}_l{list_size}"
        post_file = dec_dir / f"{name}.post"
        post.astype("<f4").tofile(post_file)
        out_file = dec_dir / f"{name}.lists"
        cmd = [REF_BIN, "-m", "decode", "-i", str(post_file), "-o", str(out_file),
               "--mem-conv", str(mem), "--msg-len", str(msg_len),
               "-l", str(list_size), "-r", str(rate), "-t", "2"]
        if rc:
            cmd.append("--rc")
        if dev is not None:
            cmd += ["--max-deviation", str(dev)]
        subprocess.run(cmd, check=True, capture_output=True)
        lists = out_file.read_text().split()
        cases.append({"mem": mem, "rate": rate, "rc": rc, "list_size": list_size,
                      "msg_len": msg_len, "max_deviation": dev, "name": name,
                      "true_msg": "".join(map(str, msg[0])), "seq": seq,
                      "n_lists": len(lists),
                      "top_is_true": lists[0] == "".join(map(str, msg[0]))})
    with open(dec_dir / "manifest.json", "w") as f:
        json.dump(cases, f, indent=1)
    n_top = sum(c["top_is_true"] for c in cases)
    print(f"decode goldens: {len(cases)} cases, {n_top} with true top-1")

    sync_goldens(rng)
    m14_production_goldens()


def m14_production_goldens():
    """Production-shaped m=14 goldens: r=5/6, L=4, msg_len=181 (the 1 pad
    bit, BASELINE.md Table 1 / experiment 8), fwd and RC — the largest
    trellis (C=16384) at its real message length, so the int8 selection
    codes and the pad path are exercised against the reference binary.
    Beam dev=8 keeps the reference decode tractable (~minutes)."""
    rng = np.random.default_rng(1402)
    dec_dir = GOLDEN / "decode14"
    dec_dir.mkdir(parents=True, exist_ok=True)
    cases = []
    mem, rate, list_size = 14, 5, 4
    # (dev, msg_len, tag): the full production message length validates on
    # the GPU (chip_smoke.py phase b); the shorter pair keeps the CPU
    # slow-suite parity test under ~15 min per case on a 2-vCPU runner
    # (the full pair takes >50 min each).
    for dev, msg_len, tag in [(8, 181, "prod"), (6, 101, "cpu")]:
      for rc in (False, True):
        code = make_conv_code(
            ConvCodeConfig(mem=mem, rate=rate, msg_len=msg_len))
        msg = rng.integers(0, 2, size=(1, msg_len), dtype=np.uint8)
        bases = conv_encode_bases(code, msg)[0]
        if rc:
            bases = (3 - bases)[::-1]
        post = synthetic_post(bases, rng, rc=False, noise=1.0,
                              stay_prob=0.35)
        name = f"m{mem}_r{rate}_rc{int(rc)}_l{list_size}_{tag}"
        post_file = dec_dir / f"{name}.post"
        post.astype("<f4").tofile(post_file)
        out_file = dec_dir / f"{name}.lists"
        cmd = [REF_BIN, "-m", "decode", "-i", str(post_file),
               "-o", str(out_file), "--mem-conv", str(mem),
               "--msg-len", str(msg_len), "-l", str(list_size),
               "-r", str(rate), "-t", "8", "--max-deviation", str(dev)]
        if rc:
            cmd.append("--rc")
        subprocess.run(cmd, check=True, capture_output=True)
        lists = out_file.read_text().split()
        cases.append({"mem": mem, "rate": rate, "rc": rc,
                      "list_size": list_size, "msg_len": msg_len,
                      "max_deviation": dev, "name": name,
                      "true_msg": "".join(map(str, msg[0])),
                      "n_lists": len(lists),
                      "top_is_true":
                          lists[0] == "".join(map(str, msg[0]))})
    with open(dec_dir / "manifest.json", "w") as f:
        json.dump(cases, f, indent=1)
    print(f"m14 production goldens: {len(cases)} cases, "
          f"{sum(c['top_is_true'] for c in cases)} with true top-1")


def sync_goldens(rng):
    """Decode goldens with periodic sync markers (--sync-marker/--sync-period,
    viterbi_convolutional_code.cpp:388-414, 968-975).

    Sync markers constrain *decode* state validity only; the encoder is
    unchanged, so the message itself must embed the marker every period
    (forward-strand positions, also under RC)."""
    dec_dir = GOLDEN / "sync"
    dec_dir.mkdir(parents=True, exist_ok=True)
    cases = []
    for mem, rate, rc, list_size, dev, marker, period in [
        (6, 1, False, 1, None, "110", 9),
        (6, 1, False, 4, None, "110", 9),
        (6, 1, True, 4, None, "110", 9),
        (6, 3, False, 4, 8, "10", 12),
        (6, 5, True, 8, 8, "0", 7),
        (8, 1, False, 4, 8, "110", 9),
        (8, 5, True, 8, 8, "01", 10),
    ]:
        msg_len = pick_msg_len(mem, rate, 48)
        code = make_conv_code(ConvCodeConfig(mem=mem, rate=rate,
                                             msg_len=msg_len))
        msg = rng.integers(0, 2, size=(1, msg_len), dtype=np.uint8)
        mk = np.array([int(c) for c in marker], np.uint8)
        for i in range(0, msg_len, period):
            n = min(len(mk), msg_len - i)
            msg[0, i: i + n] = mk[:n]
        bases = conv_encode_bases(code, msg)[0]
        post = synthetic_post(bases, rng, rc=rc, noise=1.0, stay_prob=0.35)
        name = f"m{mem}_r{rate}_rc{int(rc)}_l{list_size}_s{marker}p{period}"
        post_file = dec_dir / f"{name}.post"
        post.astype("<f4").tofile(post_file)
        out_file = dec_dir / f"{name}.lists"
        cmd = [REF_BIN, "-m", "decode", "-i", str(post_file),
               "-o", str(out_file), "--mem-conv", str(mem),
               "--msg-len", str(msg_len), "-l", str(list_size),
               "-r", str(rate), "-t", "2",
               "--sync-marker", marker, "--sync-period", str(period)]
        if rc:
            cmd.append("--rc")
        if dev is not None:
            cmd += ["--max-deviation", str(dev)]
        subprocess.run(cmd, check=True, capture_output=True)
        lists = out_file.read_text().split()
        cases.append({"mem": mem, "rate": rate, "rc": rc,
                      "list_size": list_size, "msg_len": msg_len,
                      "max_deviation": dev, "sync_marker": marker,
                      "sync_period": period, "name": name,
                      "true_msg": "".join(map(str, msg[0])),
                      "n_lists": len(lists),
                      "top_is_true": lists[0] == "".join(map(str, msg[0]))})
    with open(dec_dir / "manifest.json", "w") as f:
        json.dump(cases, f, indent=1)
    n_top = sum(c["top_is_true"] for c in cases)
    print(f"sync goldens: {len(cases)} cases, {n_top} with true top-1")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "sync":
        sync_goldens(np.random.default_rng(20260820))
    else:
        main()
