#!/usr/bin/env python3
"""Basecaller parity vs the reference flappie implementation.

The pretrained .mdl weights are git-LFS pointers in this mount, so parity is
established with SYNTHETIC weights: random parameters are written in the
flappie model-header format (models/weights.py), the reference's own compute
chain (networks.c, layers.c, decode.c — compiled unmodified from
/root/reference) is driven by parity_main.c on a synthetic raw signal, and
every stage is compared against the JAX rebuild:

  medmad normalize        vs signal/normalize.py
  flipflop_transitions    vs models/flipflop.py:flipflop_transitions
  transpost_crf_flipflop  vs ops/fwdbwd.py:transition_posteriors
  decode_crf_flipflop     vs ops/crf_decode.py (path + change positions)

Usage: python scripts/flappie_parity/run_parity.py [--hidden 16]
Prints one JSON line with per-stage max abs deviations and pass/fail.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
FLAPPIE_SRC = pathlib.Path("/root/reference/flappie/src")

C_SOURCES = ["networks.c", "layers.c", "flappie_matrix.c", "util.c",
             "nnfeatures.c", "flappie_common.c", "decode.c"]


def build_harness(build: pathlib.Path, header_params, stride: int) -> str:
    """Generate model headers + compile the parity driver against the
    unmodified reference sources."""
    from nanopore_dna_storage.models.weights import write_model_header

    models = build / "models"
    models.mkdir(parents=True, exist_ok=True)
    # networks.c includes all three model headers; emit the same synthetic
    # weights under each model id (distinct symbol names per id)
    for mid, fname in [("r941native", "flipflop_r941native.h"),
                       ("r941native5mC", "flipflop_r941native5mC.h"),
                       ("r10Cpcr", "flipflop_r10Cpcr.h")]:
        write_model_header(str(models / fname), header_params, model_id=mid,
                           stride=stride)
    exe = build / "parity_main"
    here = pathlib.Path(__file__).parent
    # networks.c's quoted #include "models/..." resolves relative to the
    # including file's directory, which in the reference tree holds git-LFS
    # pointer stubs; compile a build-dir copy so it picks up the generated
    # synthetic-weight headers instead.
    import shutil

    shutil.copy(FLAPPIE_SRC / "networks.c", build / "networks.c")
    srcs = [str(build / "networks.c")] + \
        [str(FLAPPIE_SRC / s) for s in C_SOURCES if s != "networks.c"]
    cmd = ["gcc", "-O2", "-march=native", "-std=c99", "-DUSE_SSE2",
           "-D_GNU_SOURCE",
           str(here / "parity_main.c")] + srcs + \
        ["-I", str(build), "-I", str(here), "-I", str(FLAPPIE_SRC),
         "-o", str(exe), "-l:libblas.so.3", "-lm"]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"build failed:\n{r.stderr[-3000:]}")
    return str(exe)


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--filters", type=int, default=12)
    ap.add_argument("--winlen", type=int, default=7)
    ap.add_argument("--nsamples", type=int, default=1000)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)

    from nanopore_dna_storage.models.flipflop import (
        FlipflopConfig, flipflop_transitions, init_params)
    from nanopore_dna_storage.ops.fwdbwd import transition_posteriors
    from nanopore_dna_storage.ops.crf_decode import (
        viterbi_flipflop, basecall_from_path)
    from nanopore_dna_storage.signal.normalize import medmad_normalize

    cfg = FlipflopConfig(winlen=args.winlen, stride=2,
                         conv_filters=args.filters, hidden=args.hidden,
                         temperature=args.temperature)
    params = {k: np.asarray(v) for k, v in
              init_params(cfg, seed=args.seed).items()}

    rng = np.random.default_rng(args.seed)
    raw = (rng.standard_normal(args.nsamples) * 20 + 100).astype(np.float32)

    td = pathlib.Path(tempfile.mkdtemp(prefix="flappie_parity_"))
    exe = build_harness(td, params, cfg.stride)
    raw_f = td / "raw.f32"
    raw.tofile(raw_f)
    out = subprocess.run([exe, str(raw_f), str(td / "out"),
                          str(args.temperature)],
                         capture_output=True, text=True, check=True)

    ref_norm = np.fromfile(td / "out.norm.f32", dtype="<f4")
    nblock = -(-args.nsamples // cfg.stride)
    ref_trans = np.fromfile(td / "out.trans.f32", dtype="<f4").reshape(
        nblock, 40)
    ref_post = np.fromfile(td / "out.post.f32", dtype="<f4").reshape(
        nblock, 40)
    ref_path = np.fromfile(td / "out.path.i32", dtype="<i4")
    ref_chpos = np.fromfile(td / "out.chpos.i32", dtype="<i4")

    # --- JAX chain on the same raw samples --------------------------------
    norm = np.asarray(medmad_normalize(raw))
    trans = np.asarray(flipflop_transitions(
        params, cfg, norm[None, :])).reshape(nblock, 40)
    post = np.asarray(transition_posteriors(np.asarray(trans)))
    path, _score = viterbi_flipflop(post)
    path = np.asarray(path)
    _call, chpos = basecall_from_path(path, nblock)

    devs = {
        "norm": float(np.abs(norm - ref_norm).max()),
        "trans": float(np.abs(trans - ref_trans.reshape(trans.shape)).max()),
        "post": float(np.abs(post.reshape(-1) - ref_post.reshape(-1)).max()),
    }
    path_eq = bool(np.array_equal(path, ref_path))
    chpos_eq = bool(np.array_equal(np.asarray(chpos), ref_chpos))
    ok = devs["norm"] < 1e-5 and devs["trans"] < 2e-3 and \
        devs["post"] < 2e-3 and path_eq and chpos_eq
    print(json.dumps({"ok": ok, "devs": devs, "path_eq": path_eq,
                      "chpos_eq": chpos_eq, "nblock": int(nblock),
                      "ref_stdout": out.stdout.strip()}))
    if not args.keep:
        import shutil

        shutil.rmtree(td, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
