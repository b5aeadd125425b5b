#!/usr/bin/env python3
"""Benchmark: reads/s list-Viterbi-decoded on one GPU.

Headline config: m=11, r=5/6, msg_len=180, list_size=8, max_deviation=20 —
the production decode of generate_decoded_lists.py (experiment 7).

Prints ONE JSON line naming the device it ran on:
  {"metric": ..., "value": N, "unit": "reads/s", "device": {...}, ...}

With ``--ref-binary`` (a build of the reference
viterbi_convolutional_code.cpp) it also reports vs_baseline = (reads/s) /
(single-core C++ reads/s), cached in .bench_baseline.json, and checks the
decoded lists against the binary's. Fails when JAX finds no GPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
BASELINE_CACHE = REPO / ".bench_baseline.json"


def gen_posts(cfg, n_reads: int, seed: int):
    from nanopore_dna_storage.coding.conv import (
        make_conv_code, conv_encode_bases)
    from nanopore_dna_storage.ops.synthetic import synthetic_post

    rng = np.random.default_rng(seed)
    code = make_conv_code(cfg)
    msgs = rng.integers(0, 2, (n_reads, cfg.msg_len), dtype=np.uint8)
    bases = conv_encode_bases(code, msgs)
    posts = [synthetic_post(b, rng, noise=1.0) for b in bases]
    return posts, msgs


def _ref_decode(binary: str, post, cfg, list_size: int, dev: int,
                threads: int, td: pathlib.Path, i: int) -> pathlib.Path:
    pf = td / f"{i}.post"
    post.astype("<f4").tofile(pf)
    of = td / f"{i}.out"
    subprocess.run(
        [binary, "-m", "decode", "-i", str(pf), "-o", str(of),
         "--mem-conv", str(cfg.mem), "--msg-len", str(cfg.msg_len),
         "-l", str(list_size), "-r", str(cfg.rate), "-t", str(threads),
         "--max-deviation", str(dev)],
        check=True, capture_output=True)
    return of


def measure_cpp(binary: str, posts, cfg, list_size: int, dev: int,
                max_reads: int = 3) -> float:
    """Single-core C++ seconds per read."""
    td = pathlib.Path(tempfile.mkdtemp())
    times = []
    for i, post in enumerate(posts[:max_reads]):
        t0 = time.perf_counter()
        _ref_decode(binary, post, cfg, list_size, dev, 1, td, i)
        times.append(time.perf_counter() - t0)
    return float(np.mean(times))


def verify_lists(binary: str, dec, packed, nblks, posts, cfg, list_size,
                 dev, n_verify: int) -> bool:
    """Decode the first reads with the reference binary on the SAME posts
    and require bit-for-bit identical lists."""
    td = pathlib.Path(tempfile.mkdtemp())
    m, sc, v = dec.decode(packed[:n_verify], nblks[:n_verify])
    match = True
    for i in range(n_verify):
        of = _ref_decode(binary, posts[i], cfg, list_size, dev, 4, td, i)
        ref = [ln.strip() for ln in of.read_text().splitlines()
               if ln.strip()]
        got = ["".join(map(str, mm)) for mm, vv in zip(m[i], v[i]) if vv]
        if ref != got:
            match = False
            print(f"# verify MISMATCH read {i}: ref {len(ref)} lists, "
                  f"got {len(got)}", flush=True)
    return match


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny m=6 config")
    ap.add_argument("--config", default="m11",
                    choices=["m11", "m14", "m14best", "m8"],
                    help="m11 = headline production decode; m14 = the "
                         "largest-trellis config (m=14 r=5/6 L=4, C=16384); "
                         "m14best = the best-reading-cost config (m=14 "
                         "r=1/2 L=4, supplementary Table 2); m8 = the "
                         "large-list config (m=8 r=1/2 L=64, experiment 0)")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--reads", type=int, default=0)
    ap.add_argument("--backend", default="traceback",
                    choices=["traceback", "oracle"])
    ap.add_argument("--merge-rounds", type=int, default=None)
    ap.add_argument("--sharded", action="store_true",
                    help="decode through ShardedDecoder on a data mesh of "
                         "all devices (the scale-out path) instead of the "
                         "bare LVADecoder; m11/m14/m8 configs only")
    ap.add_argument("--ref-binary",
                    help="built reference decoder: adds the single-core "
                         "C++ baseline and a list check (lists_match)")
    args = ap.parse_args()

    from nanopore_dna_storage.config import ConvCodeConfig, DecodeConfig
    from nanopore_dna_storage.ops.lva import LVADecoder
    from nanopore_dna_storage.io.post import pack_posts
    from nanopore_dna_storage.runtime import (device_info,
                                              enable_compile_cache,
                                              require_gpu)

    require_gpu()
    enable_compile_cache()

    if args.smoke:
        cfg = ConvCodeConfig(mem=6, rate=1, msg_len=100)
        list_size, dev = 4, 16
        batch = args.batch or 8
        n_reads = args.reads or 16
        metric = "reads_per_s_m6_r1_l4_smoke"
    elif args.config == "m14":
        # the largest trellis (C=16384): m=14 r=5/6 L=4 with the 1 pad bit
        # (msg_len 181, BASELINE.md Table 1)
        cfg = ConvCodeConfig(mem=14, rate=5, msg_len=181)
        list_size, dev = 4, 20
        batch = args.batch or 1
        n_reads = args.reads or 2
        metric = "reads_per_s_m14_r5l6_l4"
    elif args.config == "m14best":
        # the best-reading-cost config: m=14 r=1/2 L=4, 4.42 bases/bit
        # (supplementary Table 2; experiment 2 uses msg_len 100)
        cfg = ConvCodeConfig(mem=14, rate=1, msg_len=100)
        list_size, dev = 4, 20
        batch = args.batch or 1
        n_reads = args.reads or 2
        metric = "reads_per_s_m14_r1l2_l4"
    elif args.config == "m8":
        # the large-list config: m=8 r=1/2 L=64 (default list size 64 for
        # m=8, supplementary §5.2; experiment 0 msg_len 100)
        cfg = ConvCodeConfig(mem=8, rate=1, msg_len=100)
        list_size, dev = 64, 20
        batch = args.batch or 1
        n_reads = args.reads or 2
        metric = "reads_per_s_m8_r1l2_l64"
    else:
        cfg = ConvCodeConfig(mem=11, rate=5, msg_len=180)
        list_size, dev = 8, 20
        batch = args.batch or 1
        n_reads = args.reads or 4
        metric = "reads_per_s_m11_r5l6_l8"

    metric_base = metric
    if args.sharded:
        metric += "_sharded"
    posts, _ = gen_posts(cfg, n_reads, seed=42)
    packed, nblks = pack_posts(posts)

    def make_decoder():
        if not args.sharded:
            return LVADecoder(DecodeConfig(code=cfg, list_size=list_size,
                                           max_deviation=dev,
                                           backend=args.backend,
                                           merge_rounds=args.merge_rounds))
        # the scale-out path: the chunk programs under shard_map over a
        # data mesh + device-side CRC/index classify
        from nanopore_dna_storage.parallel.mesh import (
            ShardedDecoder, data_mesh)
        from nanopore_dna_storage.pipeline.experiments import experiment
        exp_id = {"m11": 7, "m14": 8, "m8": 0}.get(args.config)
        if exp_id is None or args.smoke:
            raise SystemExit("--sharded supports configs m11/m14/m8 only")
        exp = experiment(exp_id)
        assert exp.msg_len() == cfg.msg_len
        sd = ShardedDecoder(exp, list_size=list_size, rc=False,
                            max_deviation=dev, mesh=data_mesh(),
                            backend=args.backend)
        num_oligos = 1 << exp.framing.index_len

        class _Shim:
            def decode(self, posts, nblks):
                res = sd.decode(posts, nblks, num_oligos)
                return res.msgs, res.scores, res.scores > -np.inf

        return _Shim()

    dec = make_decoder()
    dec.decode(packed[:batch], nblks[:batch])  # warmup/compile
    t0 = time.perf_counter()
    done = 0
    while done < n_reads:
        sel = slice(done, min(done + batch, n_reads))
        nsel = sel.stop - sel.start
        if nsel < batch:  # keep a fixed compiled shape
            idx = list(range(sel.start, sel.stop)) + [0] * (batch - nsel)
            dec.decode(packed[idx], nblks[idx])
        else:
            dec.decode(packed[sel], nblks[sel])
        done += nsel
    rps = n_reads / (time.perf_counter() - t0)

    out = {
        "metric": metric,
        "value": rps,
        "unit": "reads/s",
        "device": device_info(),
        "backend": args.backend,
        "batch": batch,
        "s_per_read": 1.0 / rps,
    }
    if args.ref_binary:
        key = f"{metric_base}_cpp"
        baseline = {}
        if BASELINE_CACHE.exists():
            baseline = json.loads(BASELINE_CACHE.read_text())
        if key not in baseline:
            # m=14 takes ~15 min/read single-core; one read is enough for
            # the denominator (decode time is data-independent to ~1%)
            spr = measure_cpp(args.ref_binary, posts, cfg, list_size, dev,
                              max_reads=1 if cfg.mem >= 14 else 3)
            baseline[key] = 1.0 / spr
            BASELINE_CACHE.write_text(json.dumps(baseline))
        out["vs_baseline"] = rps / baseline[key]
        out["cpp_s_per_read"] = 1.0 / baseline[key]
        nver = 1 if cfg.mem >= 14 else min(n_reads, 2)
        out["lists_match"] = verify_lists(
            args.ref_binary, dec, packed, nblks, posts, cfg, list_size, dev,
            nver)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
