"""Command-line drivers, mirroring the reference's script surface:

  nds encode            <- encode_experiments.py / helper.encode
  nds simulate          <- simulator.py (inner-code Monte-Carlo)
  nds sim-decode        <- helper.simulate_and_decode (full file loop)
  nds decode-lists      <- generate_decoded_lists.py (real reads)
  nds error-rate        <- compute_error_rate_from_decoded_lists.py
  nds rs-recover        <- decode_RS_from_decoded_lists.py
  nds bench             <- bench.py

One typed config surface (config.py) replaces the reference's argparse /
cxxopts / argp / edit-the-source constants mix.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np


def _add_exp_args(p: argparse.ArgumentParser):
    p.add_argument("--experiment", type=int, default=None,
                   help="published experiment id 0..12")
    p.add_argument("--bytes-per-oligo", type=int, default=20)
    p.add_argument("--rs-redundancy", type=float, default=0.3)
    p.add_argument("--mem", type=int, default=11)
    p.add_argument("--rate", type=int, default=5)
    p.add_argument("--pad", action="store_true")


def _experiment(args):
    from .pipeline.experiments import experiment
    from .config import ExperimentConfig

    if args.experiment is not None:
        return experiment(args.experiment)
    return ExperimentConfig(
        bytes_per_oligo=args.bytes_per_oligo,
        rs_redundancy=args.rs_redundancy,
        conv_mem=args.mem, conv_rate=args.rate, pad=args.pad)


def cmd_encode(args):
    from .pipeline.encode import encode_file, write_fasta

    exp = _experiment(args)
    res = encode_file(args.infile, exp)
    out = pathlib.Path(args.outfile)
    with open(out, "w") as f:
        for o in res.oligos:
            f.write(o + "\n")
    if args.fasta:
        write_fasta(args.fasta, res.oligos_barcoded)
    print(json.dumps({
        "oligo_len": res.oligo_len, "msg_len": res.msg_len,
        "num_oligos_data": res.num_oligos_data,
        "num_oligos_RS": res.num_oligos_rs,
        "writing_rate_bits_per_base": round(res.writing_rate, 4)}))


def cmd_simulate(args):
    """Inner-code Monte-Carlo accuracy trial (simulator.py equivalent)."""
    from .config import ConvCodeConfig, DecodeConfig
    from .coding.conv import (make_conv_code, conv_encode_bases,
                              reverse_complement_bases)
    from .signal.channel import simulate_indelsubs
    from .ops.synthetic import synthetic_post
    from .ops.lva import LVADecoder
    from .io.post import pack_posts
    from .signal.barcode import levenshtein

    rng = np.random.default_rng(args.seed)
    cfg = ConvCodeConfig(mem=args.mem, rate=args.rate, msg_len=args.msg_len)
    code = make_conv_code(cfg)
    decs = {rc: LVADecoder(DecodeConfig(
        code=ConvCodeConfig(mem=args.mem, rate=args.rate,
                            msg_len=args.msg_len, rc=rc),
        list_size=args.list_size, max_deviation=args.max_deviation))
        for rc in (False, True)}
    stats = dict(top=0, lst=0, hamming=[], edit=[])
    for lo in range(0, args.num_trials, args.batch):
        n = min(args.batch, args.num_trials - lo)
        msgs = rng.integers(0, 2, (n, args.msg_len), dtype=np.uint8)
        bases = conv_encode_bases(code, msgs)
        posts, rcs = [], []
        for b in bases:
            rc = bool(rng.integers(2))
            seq = reverse_complement_bases(b) if rc else b
            noisy = simulate_indelsubs(seq, rng, args.sub, args.del_p,
                                       args.ins)
            posts.append(synthetic_post(noisy, rng))
            rcs.append(rc)
        batch, nblks = pack_posts(posts)
        rcs = np.asarray(rcs)
        for rc in (False, True):
            sel = np.nonzero(rcs == rc)[0]
            if not len(sel):
                continue
            out, _, valid = decs[rc].decode(batch[sel], nblks[sel])
            for j, gi in enumerate(sel):
                want = msgs[gi]
                lst = [m for m, v in zip(out[j], valid[j]) if v]
                if len(lst) and (lst[0] == want).all():
                    stats["top"] += 1
                if any((m == want).all() for m in lst):
                    stats["lst"] += 1
                if len(lst):
                    stats["hamming"].append(int((lst[0] != want).sum()))
    print(json.dumps({
        "num_trials": args.num_trials,
        "top_correct": stats["top"] / args.num_trials,
        "list_correct": stats["lst"] / args.num_trials,
        "mean_hamming": float(np.mean(stats["hamming"]))
        if stats["hamming"] else None}))


def cmd_simulate_signal(args):
    """Signal-fidelity Monte-Carlo decode accuracy (simulator.py:59-116):
    squiggle -> basecaller (trained from scratch on the hermetic pore
    model) -> fwd-bwd -> list-Viterbi -> CRC/index."""
    from .pipeline.encode import encode_bytes
    from .pipeline.simulate import simulate_and_decode_signal

    exp = _experiment(args)
    rng = np.random.default_rng(args.seed)
    data = rng.integers(0, 256, args.data_size, dtype=np.uint8).tobytes()
    enc = encode_bytes(data, exp)
    stats, _ = simulate_and_decode_signal(
        enc, exp, num_reads=args.num_reads, list_size=args.list_size,
        seed=args.seed, max_deviation=args.max_deviation,
        train_steps=args.train_steps, kmer=args.kmer)
    print(json.dumps({
        "num_reads": stats.num_reads,
        "crc_pass": stats.crc_pass,
        "list_correct": stats.list_correct,
        "top_correct": stats.top_correct,
        "unique_indices": stats.unique_indices}))


def cmd_sim_decode(args):
    from .pipeline.encode import encode_file
    from .pipeline.simulate import simulate_and_decode

    exp = _experiment(args)
    enc = encode_file(args.infile, exp)
    size = pathlib.Path(args.infile).stat().st_size
    ok, data, stats = simulate_and_decode(
        enc, exp, args.num_reads, size, list_size=args.list_size,
        seed=args.seed, sub_prob=args.sub, del_prob=args.del_p,
        ins_prob=args.ins)
    if args.outfile:
        pathlib.Path(args.outfile).write_bytes(data)
    print(json.dumps({"recovered": bool(ok),
                      "byte_exact": data == pathlib.Path(
                          args.infile).read_bytes(),
                      "reads": stats.num_reads,
                      "crc_pass": stats.crc_pass,
                      "unique_indices": stats.unique_indices}))


def cmd_error_rate(args):
    """Scan decoded list files (compute_error_rate_from_decoded_lists.py)."""
    from .io.lists import read_list_file, decoded_indices
    from .coding.framing import check_and_extract, extract_payload
    from .config import FramingConfig

    exp = _experiment(args)
    with open(args.oligos) as f:
        oligo_msgs = [l.rstrip("\n") for l in f]
    counts = dict(num_reads=0, num_correct=0, num_erasure_CRC=0,
                  num_error_CRC=0)
    num_oligos = len(oligo_msgs)
    # index -> {msg: count}, the reference's decoded_index_dict
    # (compute_error_rate_from_decoded_lists.py:22-51): per recovered index,
    # vote over the per-read chosen messages.
    index_dict: dict = {}
    for i in decoded_indices(args.lists_dir):
        lst = read_list_file(args.lists_dir, i, args.list_size)
        counts["num_reads"] += 1
        msgs = np.asarray([[int(c) for c in m] for m in lst], np.uint8)
        ok, idx = check_and_extract(msgs, exp.framing, num_oligos,
                                    pad=exp.pad)
        if not ok.any():
            counts["num_erasure_CRC"] += 1
            continue
        first = int(np.argmax(ok))
        index = int(idx[first])
        votes = index_dict.setdefault(index, {})
        votes[lst[first]] = votes.get(lst[first], 0) + 1
        if lst[first] == oligo_msgs[index]:
            counts["num_correct"] += 1
        else:
            counts["num_error_CRC"] += 1
    # majority stats: per recovered index, does the top-voted message match?
    maj_correct = sum(
        1 for index, votes in index_dict.items()
        if max(votes.items(), key=lambda kv: kv[1])[0] == oligo_msgs[index])
    counts["num_indices_recovered"] = len(index_dict)
    counts["num_indices_majority_correct"] = maj_correct
    print(json.dumps(counts))


def cmd_rs_recover(args):
    """Subsampled RS recovery trials (decode_RS_from_decoded_lists.py)."""
    import random

    from .io.lists import read_list_file, decoded_indices
    from .pipeline.decode import majority_vote, recover_file
    from .coding.framing import check_and_extract, extract_payload

    import math

    exp = _experiment(args)
    size = args.data_size
    # num_oligos derives from the padded data size exactly as the reference
    # does (decode_RS_from_decoded_lists.py:20-22 via compute_parameters)
    padded = math.ceil(size / exp.bytes_per_oligo) * exp.bytes_per_oligo
    _, _, num_oligos = exp.oligo_counts(padded)
    all_ids = decoded_indices(args.lists_dir)
    rnd = random.Random(args.seed)
    successes = 0
    for trial in range(args.num_trials):
        ids = rnd.sample(all_ids, min(args.num_reads, len(all_ids)))
        idxs, pls = [], []
        for i in ids:
            lst = read_list_file(args.lists_dir, i, args.list_size)
            if not lst:
                continue
            msgs = np.asarray([[int(c) for c in m] for m in lst], np.uint8)
            ok, idx = check_and_extract(
                msgs, exp.framing, num_oligos, pad=exp.pad)
            if not ok.any():
                continue
            first = int(np.argmax(ok))
            idxs.append(int(idx[first]))
            pls.append(extract_payload(msgs[first], exp.framing,
                                       exp.bytes_per_oligo, pad=exp.pad))
        voted = majority_vote(np.asarray(idxs), np.asarray(pls))
        ok, data = recover_file(voted, exp, size)
        want = pathlib.Path(args.infile).read_bytes() if args.infile else None
        if ok and (want is None or data == want):
            successes += 1
    print(json.dumps({"trials": args.num_trials, "successes": successes}))


def cmd_read_cost(args):
    """Reading-cost sweep (supplementary Table 2 methodology): the minimum
    number of reads, in steps of --step, for which --num-trials/--num-trials
    random subsampling trials all recover the file via RS, reported as
    bases/bit = min_reads * oligo_len / (8 * data_size).

    Reproduces decode_RS_from_decoded_lists.py:29-68 run over a read-count
    sweep (BASELINE.md 'Reading cost vs list size')."""
    import math
    import random

    from .io.lists import read_list_file, decoded_indices
    from .pipeline.decode import majority_vote, recover_file
    from .coding.framing import check_and_extract, extract_payload

    exp = _experiment(args)
    size = args.data_size
    padded = math.ceil(size / exp.bytes_per_oligo) * exp.bytes_per_oligo
    _, _, num_oligos = exp.oligo_counts(padded)
    want = pathlib.Path(args.infile).read_bytes() if args.infile else None
    all_ids = decoded_indices(args.lists_dir)

    # pre-classify every read once (CRC+index per list); the sweep then just
    # subsamples the classification results
    classified = {}
    for i in all_ids:
        lst = read_list_file(args.lists_dir, i, args.list_size)
        if not lst:
            continue
        msgs = np.asarray([[int(c) for c in m] for m in lst], np.uint8)
        ok, idx = check_and_extract(msgs, exp.framing, num_oligos,
                                    pad=exp.pad)
        if not ok.any():
            continue
        first = int(np.argmax(ok))
        classified[i] = (int(idx[first]),
                         extract_payload(msgs[first], exp.framing,
                                         exp.bytes_per_oligo, pad=exp.pad))

    def trials_pass(n_reads: int) -> int:
        rnd = random.Random(args.seed)
        succ = 0
        for _ in range(args.num_trials):
            ids = rnd.sample(all_ids, min(n_reads, len(all_ids)))
            hits = [classified[i] for i in ids if i in classified]
            voted = majority_vote(
                np.asarray([h[0] for h in hits], np.int64),
                np.asarray([h[1] for h in hits], np.uint8).reshape(
                    -1, exp.bytes_per_oligo))
            ok, data = recover_file(voted, exp, size)
            if ok and (want is None or data == want):
                succ += 1
        return succ

    result = None
    sweep = []
    for n in range(args.step, len(all_ids) + args.step, args.step):
        n_eff = min(n, len(all_ids))
        succ = trials_pass(n_eff)
        sweep.append({"num_reads": n_eff, "successes": succ})
        if succ == args.num_trials:
            result = n_eff
            break
        if n_eff == len(all_ids):
            break
    oligo_len = args.oligo_len
    cost = (result * oligo_len / (8.0 * size)) if result and oligo_len \
        else None
    print(json.dumps({"min_reads": result, "sweep": sweep,
                      "reading_cost_bases_per_bit":
                      round(cost, 3) if cost else None}))


def cmd_decode_posts(args):
    """Decode flappie-produced artifacts (post [+fastq+trans]) to list files
    (generate_decoded_lists.py equivalent for pre-basecalled reads)."""
    import glob
    import os

    from .pipeline.real_data import (
        decode_posts_with_barcodes, write_decoded_lists,
        load_flappie_artifacts, ReadDecodeRecord,
    )
    from .pipeline.decode import PipelineDecoder
    from .io.post import read_post

    exp = _experiment(args)
    post_files = sorted(glob.glob(os.path.join(args.post_dir, "*.post")))
    if not post_files:
        raise SystemExit(f"no .post files in {args.post_dir}")
    if args.with_barcodes:
        ids, posts, calls, transes = [], [], [], []
        for pf in post_files:
            stem = pf[: -len(".post")]
            post, call, trans = load_flappie_artifacts(
                pf, stem + ".fastq", stem + ".trans")
            ids.append(os.path.basename(stem))
            posts.append(post)
            calls.append(call)
            transes.append(trans)
        records = decode_posts_with_barcodes(
            ids, posts, calls, transes, exp, args.list_size,
            max_deviation=args.max_deviation)
    else:
        # posts already truncated to the payload window; decode fwd + rc and
        # keep the orientation whose best path score wins
        dec = PipelineDecoder(exp, args.list_size, args.max_deviation)
        posts = [read_post(pf) for pf in post_files]
        records = []
        out, use_rc = dec.decode_posts_auto_orientation(
            posts, 1 << exp.framing.index_len)
        for i, pf in enumerate(post_files):
            rid = os.path.basename(pf)[: -len(".post")]
            msgs = ["".join(map(str, m))
                    for m, v in zip(out.msgs[i], out.valid[i]) if v]
            records.append(ReadDecodeRecord(rid, "ok", bool(use_rc[i]),
                                            msgs=msgs))
    os.makedirs(args.outdir, exist_ok=True)
    write_decoded_lists(args.outdir, records)
    ok = sum(1 for r in records if r.status == "ok")
    print(json.dumps({"reads": len(records), "decoded": ok}))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="nds")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("encode")
    _add_exp_args(p)
    p.add_argument("-i", "--infile", required=True)
    p.add_argument("-o", "--outfile", required=True)
    p.add_argument("--fasta")
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("simulate")
    p.add_argument("--mem", type=int, default=11)
    p.add_argument("--rate", type=int, default=5)
    p.add_argument("--msg-len", type=int, default=180)
    p.add_argument("--list-size", type=int, default=8)
    p.add_argument("--num-trials", type=int, default=32)
    p.add_argument("--max-deviation", type=int, default=20)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--sub", type=float, default=0.004)
    p.add_argument("--del-p", type=float, default=0.0085)
    p.add_argument("--ins", type=float, default=0.0005)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("simulate-signal")
    _add_exp_args(p)
    p.add_argument("--data-size", type=int, default=24)
    p.add_argument("--num-reads", type=int, default=32)
    p.add_argument("--list-size", type=int, default=4)
    p.add_argument("--max-deviation", type=int, default=16)
    p.add_argument("--train-steps", type=int, default=300)
    p.add_argument("--kmer", type=int, default=1,
                   help="pore-model context (1 = quickly learnable, "
                        "6 = production model, needs long training)")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_simulate_signal)

    p = sub.add_parser("sim-decode")
    _add_exp_args(p)
    p.add_argument("-i", "--infile", required=True)
    p.add_argument("-o", "--outfile")
    p.add_argument("--num-reads", type=int, default=100)
    p.add_argument("--list-size", type=int, default=8)
    p.add_argument("--sub", type=float, default=0.004)
    p.add_argument("--del-p", type=float, default=0.0085)
    p.add_argument("--ins", type=float, default=0.0005)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_sim_decode)

    p = sub.add_parser("decode-posts")
    _add_exp_args(p)
    p.add_argument("--post-dir", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--list-size", type=int, default=8)
    p.add_argument("--max-deviation", type=int, default=20)
    p.add_argument("--with-barcodes", action="store_true",
                   help="expect .fastq/.trans next to each .post and locate "
                        "barcodes (generate_decoded_lists.py flow)")
    p.set_defaults(fn=cmd_decode_posts)

    p = sub.add_parser("error-rate")
    _add_exp_args(p)
    p.add_argument("--lists-dir", required=True)
    p.add_argument("--oligos", required=True,
                   help="file of true message bit strings")
    p.add_argument("--list-size", type=int, default=8)
    p.set_defaults(fn=cmd_error_rate)

    p = sub.add_parser("read-cost")
    _add_exp_args(p)
    p.add_argument("--lists-dir", required=True)
    p.add_argument("--data-size", type=int, required=True)
    p.add_argument("--infile", help="original file for byte comparison")
    p.add_argument("--list-size", type=int, default=8)
    p.add_argument("--step", type=int, default=500,
                   help="read-count sweep step (supplementary Table 2)")
    p.add_argument("--num-trials", type=int, default=10)
    p.add_argument("--oligo-len", type=int, default=0,
                   help="oligo length incl. any padding, for bases/bit")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_read_cost)

    p = sub.add_parser("rs-recover")
    _add_exp_args(p)
    p.add_argument("--lists-dir", required=True)
    p.add_argument("--data-size", type=int, required=True)
    p.add_argument("--infile", help="original file for byte comparison")
    p.add_argument("--num-reads", type=int, default=5000)
    p.add_argument("--num-trials", type=int, default=10)
    p.add_argument("--list-size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_rs_recover)

    args = ap.parse_args(argv)
    from .runtime import enable_compile_cache
    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
