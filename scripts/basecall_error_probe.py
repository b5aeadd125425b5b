#!/usr/bin/env python3
"""Measure basecall error rate of a from-scratch-trained flip-flop model
on the hermetic pore model — the diagnostic between "the signal loop is
wired" and "the signal loop decodes" (production-config
fidelity was 0/48; the reference's real-data basecall error is 8.4%,
supplementary §7, and decode accuracy collapses well before ~15%).

Usage: python scripts/basecall_error_probe.py --steps 4000 --kmer 6
       [--hidden 64 --filters 32 --layers bfb] [--cpu]
"""
import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from nanopore_dna_storage.runtime import enable_compile_cache  # noqa: E402

import numpy as np  # noqa: E402


def edit_distance(a, b):
    la, lb = len(a), len(b)
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[lb]


def main():
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--kmer", type=int, default=6)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--filters", type=int, default=32)
    ap.add_argument("--layers", default="bfb")
    ap.add_argument("--winlen", type=int, default=11)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=60)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--schedule", action="store_true",
                    help="warmup + cosine decay instead of constant LR")
    ap.add_argument("--eval-reads", type=int, default=32)
    ap.add_argument("--eval-len", type=int, default=120)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--save", default="",
                    help="save trained params to this .npz")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    from nanopore_dna_storage.models import flipflop as ff
    from nanopore_dna_storage.models import train as trainmod
    from nanopore_dna_storage.ops.crf_decode import (
        basecall_from_path, viterbi_flipflop_batch)
    from nanopore_dna_storage.signal.normalize import medmad_normalize

    cfg = ff.FlipflopConfig(winlen=args.winlen, stride=2,
                            conv_filters=args.filters, hidden=args.hidden,
                            layer_dirs=tuple(args.layers))
    orig = trainmod.simulate_raw_signal
    trainmod.simulate_raw_signal = (
        lambda seq, rng, deepsim_dwell=True:
        orig(seq, rng, deepsim_dwell=deepsim_dwell, kmer=args.kmer))
    t0 = time.perf_counter()
    try:
        state, losses = trainmod.train_on_synthetic(
            cfg, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
            seed=args.seed, learning_rate=args.lr,
            schedule=args.schedule)
    finally:
        trainmod.simulate_raw_signal = orig
    t_train = time.perf_counter() - t0

    # held-out eval at decode-time read length
    rng = np.random.default_rng(args.seed + 777)
    T = args.eval_len * 12
    sig = np.zeros((args.eval_reads, T), np.float32)
    ns = np.zeros(args.eval_reads, np.int32)
    seqs = []
    for i in range(args.eval_reads):
        seq = rng.integers(0, 4, args.eval_len).astype(np.uint8)
        raw = orig(seq, rng, deepsim_dwell=False, kmer=args.kmer)
        raw = medmad_normalize(raw)[:T]
        sig[i, : len(raw)] = raw
        ns[i] = len(raw)
        seqs.append(seq)
    trans = ff.flipflop_transitions(state.params, cfg, jnp.asarray(sig),
                                    jnp.asarray(ns))
    nblk = -(-ns // cfg.stride)
    paths, _ = viterbi_flipflop_batch(
        trans.reshape(args.eval_reads, -1, 5, 8), jnp.asarray(nblk))
    paths = np.asarray(paths)
    b2i = {b: i for i, b in enumerate("ACGT")}
    errs, tot = 0, 0
    for i in range(args.eval_reads):
        call, _ = basecall_from_path(paths[i], int(nblk[i]))
        errs += edit_distance([b2i[c] for c in call],
                              list(map(int, seqs[i])))
        tot += args.eval_len
    out = {"steps": args.steps, "kmer": args.kmer, "hidden": args.hidden,
           "filters": args.filters, "layers": args.layers,
           "final_loss": round(float(np.mean(losses[-50:])), 4),
           "basecall_err_pct": round(100.0 * errs / tot, 2),
           "train_s": round(t_train, 1)}
    print(json.dumps(out))
    if args.save:
        np.savez(args.save, **{k: np.asarray(v)
                               for k, v in state.params.items()})


if __name__ == "__main__":
    main()
