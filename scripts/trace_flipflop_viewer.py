#!/usr/bin/env python3
"""Flip-flop posterior trace viewer.

Equivalent of the reference's matplotlib trace viewer
(/root/reference/flappie/misc/trace_flipflop.py), reading the HDF5
layout that ``utils.profiling.dump_trace_hdf5`` writes (one uint8
dataset per read, [blocks, 40] = probability * 255, matching flappie's
trace output, fast5_interface.c:126-143). For each read it renders the
flip rows, flop rows, and the stay-mass trace to a PNG — headless
(Agg), since compute hosts have no display.

Usage: python scripts/trace_flipflop_viewer.py TRACE.h5 [--out DIR]
       [--reads id1,id2] [--upper | --no-upper]
"""
import argparse
import pathlib

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

BASES = "ACGT"


def plot_read(rid: str, trace: np.ndarray, out_dir: pathlib.Path,
              upper: bool = True) -> pathlib.Path:
    """One figure per read: 4 flip traces, 4 flop traces (dashed), and
    total stay mass. trace is uint8 [T, 40]; flip states are columns
    0..19 (base = col % 4 within the 4x5 layout used by the CRF head),
    flops 20..39; 'stay' mass = flop-state probability (a flop only
    follows itself or its flip, decode.c:377-497)."""
    p = trace.astype(np.float32) / 255.0
    T = p.shape[0]
    x = np.arange(T)
    fig, (ax0, ax1) = plt.subplots(
        2, 1, figsize=(max(8, T / 40), 6), sharex=True,
        gridspec_kw={"height_ratios": [3, 1]})
    half = p.shape[1] // 2
    for b in range(4):
        flip = p[:, b::4][:, : half // 4].sum(axis=1)
        flop = p[:, half + b::4][:, : half // 4].sum(axis=1) \
            if p.shape[1] > half else None
        ax0.plot(x, flip, label=BASES[b], linewidth=0.8)
        if upper and flop is not None:
            ax0.plot(x, flop, linestyle="--", linewidth=0.8,
                     label=BASES[b].lower())
    ax0.set_ylabel("posterior mass")
    ax0.set_ylim(0, 1.05)
    ax0.legend(ncol=4, fontsize=7)
    ax0.set_title(rid)
    ax1.plot(x, p[:, half:].sum(axis=1), color="gray", linewidth=0.8)
    ax1.set_ylabel("stay (flop) mass")
    ax1.set_xlabel("block")
    fig.tight_layout()
    out = out_dir / f"trace_{rid}.png"
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_h5")
    ap.add_argument("--out", default=".")
    ap.add_argument("--reads", default=None,
                    help="comma-separated read ids (default: all)")
    ap.add_argument("--upper", dest="upper", action="store_true",
                    default=True, help="also draw flop (stay) traces")
    ap.add_argument("--no-upper", dest="upper", action="store_false")
    args = ap.parse_args()

    import h5py

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    with h5py.File(args.trace_h5, "r") as f:
        rids = args.reads.split(",") if args.reads else list(f.keys())
        for rid in rids:
            path = plot_read(rid, f[rid][()], out_dir, upper=args.upper)
            print(path)


if __name__ == "__main__":
    main()
