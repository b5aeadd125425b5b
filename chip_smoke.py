#!/usr/bin/env python3
"""Bring-up smoke test of the decode pipeline on NVIDIA GPUs.

Drives the production path (packed posteriors -> list-Viterbi traceback
decode -> CRC/index -> vote -> RS, plus the basecaller) once through the
user entry points (``LVADecoder``, ``PipelineDecoder``,
``simulate_and_decode``), at production widths, on one card:

  (a) device guard: a GPU must be JAX's default device;
  (b) every reference-binary decode golden (tests/golden/decode,
      tests/golden/decode14), lists equal list for list;
  (c) m=11 r=5/6 L=8 beam 20 msg_len=180 (experiment 7) on 32 synthetic
      reads: lists equal the oracle backend on the card; warm s/read,
      compile time and peak device memory are printed;
  (d) experiment 7 end to end: a ~1 KB file -> reads on the iid channel
      -> auto-orientation decode -> CRC/index -> vote -> RS == the file;
  (e) the flip-flop basecaller (conv 256, 5x256 GRU) + forward-backward
      posteriors vs the same function on the host CPU.

``--four`` runs only the sharded decode (``ShardedDecoder`` over a 4-card
data mesh) and the same decode on one card, and requires equal results.

Every phase raises on failure; the last line of standard output is the
JSON result. Usage: ``python chip_smoke.py [--four]``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import numpy as np

import jax

from nanopore_dna_storage.config import ConvCodeConfig, DecodeConfig
from nanopore_dna_storage.ops.lva import LVADecoder
from nanopore_dna_storage.runtime import (device_info, enable_compile_cache,
                                          require_gpu)

REPO = pathlib.Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden"
# TF32 keeps 10 mantissa bits (relative input rounding 2^-11 ~ 5e-4); six
# matmul layers and the x5 CRF scaling keep transition weights within a
# few 1e-2 of the float32 result, so posteriors (probabilities) agree to
# 0.02 absolute while a real fault (wrong layout, wrong direction, NaN)
# moves them by O(1).
POST_ATOL = 0.02


def _log(msg: str) -> None:
    print(msg, flush=True)


def _peak_bytes():
    """Peak device memory of the process so far (None off the card)."""
    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def _lists(msgs, valid):
    return [["".join(map(str, m)) for m, v in zip(mr, vr) if v]
            for mr, vr in zip(msgs, valid)]


def _golden_cases():
    for sub in ("decode", "decode14"):
        for case in json.loads((GOLDEN / sub / "manifest.json").read_text()):
            yield sub, case


def phase_goldens(names=None):
    """(b) traceback decode of the reference goldens, list for list."""
    for sub, case in _golden_cases():
        name = case["name"]
        if names is not None and name not in names:
            continue
        post = np.fromfile(GOLDEN / sub / f"{name}.post",
                           dtype="<f4").reshape(-1, 5, 8)
        want = (GOLDEN / sub / f"{name}.lists").read_text().split()
        dec = LVADecoder(DecodeConfig(
            code=ConvCodeConfig(mem=case["mem"], rate=case["rate"],
                                msg_len=case["msg_len"], rc=case["rc"]),
            list_size=case["list_size"],
            max_deviation=case["max_deviation"]))
        t0 = time.perf_counter()
        got = _lists(*dec.decode(post[None])[::2])[0]
        dt = time.perf_counter() - t0
        if got != want:
            raise AssertionError(f"golden {name}: lists differ from the "
                                 f"reference binary")
        _log(f"phase b ok: {name} ({len(got)} entries, {dt:.2f} s incl. "
             f"compile)")


def _synthetic_posts(cfg: ConvCodeConfig, n_reads: int, seed: int):
    """Random messages of ``cfg`` rendered as synthetic posteriors."""
    from nanopore_dna_storage.coding.conv import (conv_encode_bases,
                                                  make_conv_code)
    from nanopore_dna_storage.io.post import pack_posts
    from nanopore_dna_storage.ops.synthetic import synthetic_post

    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (n_reads, cfg.msg_len), dtype=np.uint8)
    bases = conv_encode_bases(make_conv_code(cfg), msgs)
    packed, nblks = pack_posts(
        [synthetic_post(b, rng, noise=1.0) for b in bases])
    return msgs, packed, nblks


def phase_m11(n_reads=32, batch=8, n_oracle=2, msg_len=180,
              max_deviation=20, seed=7):
    """(c) experiment 7's decode: traceback vs oracle, warm timing."""
    cfg = ConvCodeConfig(mem=11, rate=5, msg_len=msg_len)
    msgs, packed, nblks = _synthetic_posts(cfg, n_reads, seed)
    mk = lambda backend: LVADecoder(DecodeConfig(  # noqa: E731
        code=cfg, list_size=8, max_deviation=max_deviation,
        backend=backend))
    dec = mk("traceback")
    t0 = time.perf_counter()
    dec.decode(packed[:batch], nblks[:batch])
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = [dec.decode(packed[i:i + batch], nblks[i:i + batch])
           for i in range(0, n_reads, batch)]
    warm = (time.perf_counter() - t0) / n_reads
    m = np.concatenate([o[0] for o in out])
    sc = np.concatenate([o[1] for o in out])
    valid = np.concatenate([o[2] for o in out])
    if not (np.isfinite(sc[valid]).all() and valid[:, 0].all()):
        raise AssertionError("m11: empty list or non-finite scores")
    top1 = float((m[:, 0] == msgs).all(axis=1).mean())
    compile_s = first - warm * batch
    _log(f"phase c: m11 traceback batch {batch}: warm "
         f"{warm:.4f} s/read over {n_reads} reads; compile "
         f"{compile_s:.1f} s (first call {first:.1f} s); top-1 correct "
         f"{top1:.3f}; peak_bytes_in_use {_peak_bytes()}")
    orc = mk("oracle")
    for i in range(n_oracle):
        t0 = time.perf_counter()
        mo, so, vo = orc.decode(packed[i:i + 1], nblks[i:i + 1])
        dt = time.perf_counter() - t0
        if _lists(mo, vo)[0] != _lists(m[i:i + 1], valid[i:i + 1])[0] \
                or not np.array_equal(so[vo], sc[i][valid[i]]):
            raise AssertionError(f"m11 read {i}: traceback != oracle")
        _log(f"phase c ok: read {i} traceback == oracle "
             f"(oracle {dt:.1f} s incl. compile)")
    _log(f"phase c: peak_bytes_in_use {_peak_bytes()}")
    return warm


def phase_file(data_size=1000, num_reads=144, seed=3, batch=1):
    """(d) experiment 7 end to end with auto-orientation decode.

    Batch 1: the CRC-gated re-decode splits each batch into subsets of any
    size, and every new size compiles its own programs; at batch 1 both
    orientations meet one batch shape. (s/read at m=11 is within 8% of
    batch 8, and batch 32 does not fit the selections in 80 GB.)
    """
    from nanopore_dna_storage.pipeline.encode import encode_bytes
    from nanopore_dna_storage.pipeline.experiments import (
        DEFAULT_LIST_SIZE, experiment)
    from nanopore_dna_storage.pipeline.simulate import simulate_and_decode

    exp = experiment(7)
    data = np.random.default_rng(seed).integers(
        0, 256, data_size, dtype=np.uint8).tobytes()
    enc = encode_bytes(data, exp)
    t0 = time.perf_counter()
    ok, got, stats = simulate_and_decode(
        enc, exp, num_reads, data_size,
        list_size=DEFAULT_LIST_SIZE[exp.conv_mem], seed=seed, batch=batch,
        auto_orientation=True)
    dt = time.perf_counter() - t0
    if not ok or got != data:
        raise AssertionError(
            f"file recovery failed: rs_ok={ok}, crc_pass={stats.crc_pass}"
            f"/{stats.num_reads}, indices {stats.unique_indices}/"
            f"{enc.num_oligos_data + enc.num_oligos_rs}")
    _log(f"phase d ok: {data_size} B file recovered byte-exact from "
         f"{stats.num_reads} reads (crc_pass {stats.crc_pass}, indices "
         f"{stats.unique_indices}/{enc.num_oligos_data + enc.num_oligos_rs})"
         f" in {dt:.1f} s")


def phase_basecaller(n_reads=64, n_samples=4096, seed=0):
    """(e) basecaller + forward-backward on the card vs the host CPU."""
    from nanopore_dna_storage.models import flipflop as ff
    from nanopore_dna_storage.ops.fwdbwd import batched_transition_posteriors

    cfg = ff.FlipflopConfig()

    def fn(params, signal, nsamples):
        trans = ff.flipflop_transitions(params, cfg, signal, nsamples)
        return batched_transition_posteriors(trans, -(-nsamples // cfg.stride))

    rng = np.random.default_rng(seed)
    signal = rng.standard_normal((n_reads, n_samples)).astype(np.float32)
    nsamples = rng.integers(n_samples // 2, n_samples + 1,
                            n_reads).astype(np.int32)
    nsamples[0] = n_samples
    params = ff.init_params(cfg, seed=seed)
    t0 = time.perf_counter()
    post = np.asarray(jax.jit(fn)(params, signal, nsamples))
    dt = time.perf_counter() - t0
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(fn)(jax.device_put(params, cpu),
                                     jax.device_put(signal, cpu),
                                     jax.device_put(nsamples, cpu)))
    if post.shape != (n_reads, n_samples // cfg.stride, 5, 8):
        raise AssertionError(f"basecaller: shape {post.shape}")
    if not np.isfinite(post).all():
        raise AssertionError("basecaller: non-finite posteriors")
    err = float(np.abs(post - ref).max())
    if err > POST_ATOL:
        raise AssertionError(f"basecaller: max |gpu - cpu| {err} > "
                             f"{POST_ATOL}")
    _log(f"phase e ok: basecaller+fwdbwd {n_reads}x{n_samples} samples: "
         f"max |gpu(TF32) - cpu(f32 highest)| = {err:.3g} <= {POST_ATOL} "
         f"({dt:.1f} s incl. compile)")


def phase_four(exp=None, list_size=8, n_reads=8, max_deviation=20,
               seed=11):
    """--four: ShardedDecoder over a 4-card mesh == the same decode on one
    card (default: experiment 7, m=11 r=5/6 L=8)."""
    from nanopore_dna_storage.coding import conv as convmod
    from nanopore_dna_storage.io.post import pack_posts
    from nanopore_dna_storage.ops.synthetic import synthetic_post
    from nanopore_dna_storage.parallel.mesh import ShardedDecoder, data_mesh
    from nanopore_dna_storage.pipeline.encode import encode_bytes
    from nanopore_dna_storage.pipeline.experiments import experiment

    devs = jax.devices()
    if len(devs) != 4:
        raise RuntimeError(f"--four needs 4 devices, found {len(devs)}")
    exp = exp or experiment(7)
    # forward reads of framed oligos, so the CRC/index counters see passes
    enc = encode_bytes(bytes(range(4 * exp.bytes_per_oligo)), exp)
    rng = np.random.default_rng(seed)
    oligos = convmod.str_to_bases(enc.oligos)
    packed, nblks = pack_posts([
        synthetic_post(oligos[i % len(oligos)], rng, noise=1.0)
        for i in range(n_reads)])
    num_oligos = 1 << exp.framing.index_len
    res = {}
    for n in (4, 1):
        dec = ShardedDecoder(exp, list_size=list_size, rc=False,
                             max_deviation=max_deviation,
                             mesh=data_mesh(devs[:n]))
        t0 = time.perf_counter()
        dec.decode(packed, nblks, num_oligos)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res[n] = dec.decode(packed, nblks, num_oligos)
        _log(f"phase four: {n}-card mesh decoded {n_reads} reads in "
             f"{time.perf_counter() - t0:.3f} s warm (first call "
             f"{first:.1f} s incl. compile)")
    for field in ("msgs", "scores", "ok", "index"):
        if not np.array_equal(getattr(res[4], field), getattr(res[1], field)):
            raise AssertionError(f"sharded {field} != single-card")
    if res[4].crc_pass_total != res[1].crc_pass_total:
        raise AssertionError("sharded crc_pass_total != single-card")
    if res[4].crc_pass_total < n_reads // 2:
        raise AssertionError(f"only {res[4].crc_pass_total}/{n_reads} "
                             f"reads passed CRC")
    _log(f"phase four ok: 4-card lists, scores, ok, index equal the "
         f"1-card decode; crc_pass_total {res[4].crc_pass_total}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded decode check")
    args = ap.parse_args(argv)
    devs = require_gpu()
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    _log(f"device: {devs[0].device_kind} x{len(devs)}")
    for line in smi.splitlines():
        _log(f"nvidia-smi: {line}")
    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_goldens()
        phase_m11()
        phase_file()
        phase_basecaller()
    _log(f"all phases ok in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device_info()}))


if __name__ == "__main__":
    main()
