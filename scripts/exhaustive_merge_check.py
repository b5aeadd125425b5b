#!/usr/bin/env python3
"""Device check: default merge rounds ≡ exhaustive at m >= 11 (the
oracle's 2L+2 default is proven equal to the exhaustive (1+32)*L heap
bound at m <= 8 by the test suite; exhaustive rounds are impractically
slow on a few CPU cores).

Decodes the same synthetic posts with the oracle at default rounds, the
oracle at exhaustive rounds (exact reference-heap semantics,
cpp:744-799), and the traceback backend (whose suppression merge is
exact by construction) — all three lists must be bit-identical. Writes
docs/EXHAUSTIVE_CHECK.json.

Usage: python scripts/exhaustive_merge_check.py [--configs m11,m14]
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

CONFIGS = {
    "m11": dict(mem=11, rate=5, msg_len=180, list_size=8),
    "m14": dict(mem=14, rate=5, msg_len=181, list_size=4),
    # Reduced-payload variants: the merge structure (NQ sorted lists, L
    # slots, conv-state count C, dup/tie patterns) is independent of
    # msg_len, so these close the m>=11 merge-equivalence gap on CPU
    # where the full-length oracle compile is impractical (2 vCPUs). The
    # payloads are sized so the 264-round m=11 exhaustive decode stays
    # within ~1 h on the 2-vCPU box (msg_len 37 measured ~5.4 h).
    "m11cpu": dict(mem=11, rate=5, msg_len=25, list_size=8, dev=6,
                   reads=1),
    "m14cpu": dict(mem=14, rate=5, msg_len=19, list_size=4, dev=6,
                   reads=1),
}


def main():
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="m11,m14")
    ap.add_argument("--reads", type=int, default=2)
    ap.add_argument("--dev", type=int, default=20)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None,
                    help="output JSON (default docs/EXHAUSTIVE_CHECK.json, "
                         "or _CPU.json with --cpu so the CPU run never "
                         "clobbers the device artifact)")
    args = ap.parse_args()
    if args.out is None:
        name = "EXHAUSTIVE_CHECK_CPU.json" if args.cpu \
            else "EXHAUSTIVE_CHECK.json"
        args.out = str(REPO / "docs" / name)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from nanopore_dna_storage.config import (ConvCodeConfig,
                                                 DecodeConfig)
    from nanopore_dna_storage.ops.lva import LVADecoder, NQ
    from nanopore_dna_storage.coding.conv import (make_conv_code,
                                                      conv_encode_bases)
    from nanopore_dna_storage.ops.synthetic import synthetic_post
    from nanopore_dna_storage.io.post import pack_posts

    results = {}
    for name in args.configs.split(","):
        c = CONFIGS[name]
        L = c["list_size"]
        dev = c.get("dev", args.dev)
        nreads = c.get("reads", args.reads)
        rng = np.random.default_rng(args.seed)
        cfg = ConvCodeConfig(mem=c["mem"], rate=c["rate"],
                             msg_len=c["msg_len"])
        code = make_conv_code(cfg)
        msgs = rng.integers(0, 2, (nreads, c["msg_len"]), np.uint8)
        bases = conv_encode_bases(code, msgs)
        posts = [synthetic_post(b, rng, noise=1.0) for b in bases]
        packed, nblks = pack_posts(posts)

        lists = {}
        timing = {}
        runs = [("oracle_default", "oracle", None),
                ("oracle_exhaustive", "oracle", (1 + NQ - 1) * L),
                ("traceback", "traceback", None)]
        for label, backend, rounds in runs:
            dec = LVADecoder(DecodeConfig(
                code=cfg, list_size=L, max_deviation=dev,
                backend=backend, merge_rounds=rounds))
            t0 = time.perf_counter()
            m, sc, v = dec.decode(packed, nblks)
            timing[label] = round(time.perf_counter() - t0, 1)
            lists[label] = [
                ["".join(map(str, mm)) for mm, vv in zip(m[i], v[i]) if vv]
                for i in range(nreads)]
            print(f"{name}/{label}: {timing[label]}s", flush=True)
            del dec

        eq_def = lists["oracle_default"] == lists["oracle_exhaustive"]
        eq_tb = lists["traceback"] == lists["oracle_exhaustive"]
        results[name] = {
            "config": c, "reads": nreads, "max_deviation": dev,
            "exhaustive_rounds": NQ * L,
            "default_rounds": 2 * L + 2,
            "default_eq_exhaustive": eq_def,
            "traceback_eq_exhaustive": eq_tb,
            "wall_s": timing,
            "n_lists": [len(x) for x in lists["oracle_exhaustive"]],
        }
        print(json.dumps({name: results[name]}), flush=True)
        # write incrementally: a partial run still leaves a valid artifact
        pathlib.Path(args.out).write_text(
            json.dumps(results, indent=1) + "\n")
        assert eq_def and eq_tb, f"{name}: merge-round mismatch"

    print("EXHAUSTIVE CHECK OK", flush=True)


if __name__ == "__main__":
    main()
