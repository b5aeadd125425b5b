#!/usr/bin/env python3
"""Paper-scale end-to-end file recovery.

Encodes an 11,280-byte file (the published file size, supplementary §5.1)
at a production experiment, simulates thousands of channel-fidelity reads,
decodes them through ShardedDecoder (traceback backend, reads sharded
over the mesh), classifies (CRC -> index vote), RS-
recovers at production fec and byte-compares — the full
decode_RS_from_decoded_lists.py:7-64 acceptance flow in one run.

Writes docs/FILE_RECOVERY.json. Progress is checkpointed to a shard
manifest (--state), so an interrupted run resumes where it stopped.

Usage:
  python scripts/file_recovery_report.py --experiment 7 --reads 2200 \
      [--backend traceback] [--batch 1] [--state STATE.npz]
"""
import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from nanopore_dna_storage.runtime import enable_compile_cache  # noqa: E402

import numpy as np  # noqa: E402

FILE_SIZE = 11280  # bytes (supplementary §5.1)


def main():
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--experiment", type=int, default=7,
                    help="7 = m=11 r=5/6 fec=169 (564/169/733 oligos)")
    ap.add_argument("--reads", type=int, default=2200)
    ap.add_argument("--list-size", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1,
                    help="reads per decode step (per orientation)")
    ap.add_argument("--backend", default="traceback",
                    choices=["traceback", "oracle"])
    ap.add_argument("--max-deviation", type=int, default=20)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--sub", type=float, default=0.004)
    ap.add_argument("--del", dest="dels", type=float, default=0.0085)
    ap.add_argument("--ins", type=float, default=0.0005)
    ap.add_argument("--state", default=os.path.join(tempfile.gettempdir(),
                                         "file_recovery_state.npz"))
    ap.add_argument("--out", default=str(REPO / "docs" /
                                         "FILE_RECOVERY.json"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from nanopore_dna_storage.pipeline.experiments import experiment
    from nanopore_dna_storage.pipeline.encode import encode_bytes
    from nanopore_dna_storage.pipeline.simulate import simulate_posts
    from nanopore_dna_storage.pipeline.decode import (majority_vote,
                                                          recover_file)
    from nanopore_dna_storage.parallel.mesh import (ShardedDecoder,
                                                        data_mesh)
    from nanopore_dna_storage.coding.framing import extract_payload
    from nanopore_dna_storage.io.post import pack_posts

    exp = experiment(args.experiment)
    rng = np.random.default_rng(args.seed)
    data = rng.integers(0, 256, FILE_SIZE, np.uint8).tobytes()
    t_enc0 = time.perf_counter()
    enc = encode_bytes(data, exp)
    t_enc = time.perf_counter() - t_enc0
    num_oligos = enc.num_oligos_data + enc.num_oligos_rs
    print(f"encoded: {enc.num_oligos_data}/{enc.num_oligos_rs}/"
          f"{num_oligos} oligos, len {enc.oligo_len}, {t_enc:.1f}s",
          flush=True)

    # per-read truth for the Table-3-style breakdown
    mesh = data_mesh()
    mk = lambda rc: ShardedDecoder(  # noqa: E731
        exp, args.list_size, rc, max_deviation=args.max_deviation,
        mesh=mesh, backend=args.backend)
    dec_f, dec_r = mk(False), mk(True)

    state_path = pathlib.Path(args.state)
    if state_path.exists():
        st = dict(np.load(state_path))
        done = int(st["done"])
        idx_acc = st["idx"].tolist()
        pay_acc = st["pay"].tolist()
        counters = {k: int(st[k]) for k in
                    ("num_correct", "num_erasure_CRC", "num_error_CRC")}
        wall_acc = float(st["wall"])
        print(f"resuming at read {done}", flush=True)
    else:
        done, idx_acc, pay_acc = 0, [], []
        counters = dict(num_correct=0, num_erasure_CRC=0, num_error_CRC=0)
        wall_acc = 0.0

    B = args.batch
    while done < args.reads:
        n = min(B, args.reads - done)
        # deterministic per-chunk rng so resume does not replay reads
        crng = np.random.default_rng((args.seed, done))
        posts, rcs, ids = simulate_posts(
            enc.oligos, n, crng, sub_prob=args.sub, del_prob=args.dels,
            ins_prob=args.ins)
        t0 = time.perf_counter()
        packed, nblks = pack_posts(posts)
        for rc, dec in ((False, dec_f), (True, dec_r)):
            sel = np.nonzero(rcs == rc)[0]
            if not len(sel):
                continue
            res = dec.decode(packed[sel], nblks[sel], num_oligos)
            first = np.argmax(res.ok, axis=1)
            any_ok = res.ok.any(axis=1)
            for j, r in enumerate(sel):
                if not any_ok[j]:
                    counters["num_erasure_CRC"] += 1
                    continue
                midx = int(res.index[j, first[j]])
                chosen = res.msgs[j, first[j]]
                pay = extract_payload(chosen[None], exp.framing,
                                      exp.bytes_per_oligo,
                                      pad=exp.pad)[0]
                idx_acc.append(midx)
                pay_acc.append(pay)
                true_pay = enc.payloads[ids[r]]
                if midx == int(ids[r]) and (pay == true_pay).all():
                    counters["num_correct"] += 1
                else:
                    counters["num_error_CRC"] += 1
        wall_acc += time.perf_counter() - t0
        done += n
        np.savez(state_path, done=done, idx=np.asarray(idx_acc, np.int64),
                 pay=np.asarray(pay_acc, np.uint8), wall=wall_acc,
                 **counters)
        if done % (B * 16) < B or done >= args.reads:
            uniq = len(set(idx_acc))
            print(f"[{done}/{args.reads}] correct={counters['num_correct']}"
                  f" erasure={counters['num_erasure_CRC']} "
                  f"error={counters['num_error_CRC']} unique_idx={uniq} "
                  f"({wall_acc / max(done, 1):.2f} s/read)", flush=True)

    voted = majority_vote(np.asarray(idx_acc),
                          np.asarray(pay_acc, np.uint8))
    missing = num_oligos - len(voted)
    t0 = time.perf_counter()
    ok, recovered = recover_file(voted, exp, FILE_SIZE)
    t_rs = time.perf_counter() - t0
    byte_ok = recovered == data
    out = {
        "experiment": args.experiment,
        "config": f"m={exp.conv_mem} r_index={exp.conv_rate} "
                  f"L={args.list_size} max_dev={args.max_deviation}",
        "backend": args.backend,
        "file_size_bytes": FILE_SIZE,
        "oligos": {"data": enc.num_oligos_data, "rs": enc.num_oligos_rs,
                   "total": num_oligos},
        "reads_used": done,
        **counters,
        "unique_indices_voted": len(voted),
        "missing_indices_erased": missing,
        "rs_decode_ok": bool(ok),
        "file_bytes_match": bool(byte_ok),
        "decode_wall_s": round(wall_acc, 1),
        "s_per_read": round(wall_acc / max(done, 1), 2),
        "rs_recover_s": round(t_rs, 1),
        "channel": {"sub": args.sub, "del": args.dels, "ins": args.ins},
    }
    pathlib.Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out), flush=True)
    assert byte_ok, "file recovery FAILED"


if __name__ == "__main__":
    main()
