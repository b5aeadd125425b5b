"""Tracing / profiling utilities.

The reference's observability is a per-read posterior trace dump
(flappie --trace, decode.c:499-543 + fast5_interface.c:126-143, viewed with
misc/trace_flipflop.py) and ad-hoc gprof. Device-side equivalents:

* ``profile(logdir)``: context manager around jax.profiler for device traces
  (view with TensorBoard / xprof).
* ``timed``: wall-clock section timing with a global registry.
* ``dump_trace_hdf5``: posterior heatmap dump in an HDF5 layout compatible in
  spirit with flappie's trace output (dataset per read, blocks x states).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterable, Optional

import numpy as np

_TIMINGS: Dict[str, list] = defaultdict(list)


@contextlib.contextmanager
def profile(logdir: Optional[str]):
    """jax.profiler trace when logdir is set; no-op otherwise."""
    if not logdir:
        yield
        return
    import jax

    with jax.profiler.trace(logdir):
        yield


@contextlib.contextmanager
def timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _TIMINGS[name].append(time.perf_counter() - t0)


def timing_summary() -> Dict[str, Dict[str, float]]:
    return {k: {"n": len(v), "total_s": float(np.sum(v)),
                "mean_s": float(np.mean(v))}
            for k, v in _TIMINGS.items()}


def reset_timings() -> None:
    _TIMINGS.clear()


def dump_trace_hdf5(path: str, posteriors: Dict[str, np.ndarray],
                    scale: float = 255.0) -> None:
    """Posterior trace dump: per read, uint8 heatmap [T, 40] like flappie's
    trace output (probability * 255, fast5_interface.c:126-143)."""
    import h5py

    with h5py.File(path, "w") as f:
        for rid, post in posteriors.items():
            p = np.exp(np.asarray(post, np.float32).reshape(post.shape[0], -1))
            f.create_dataset(rid, data=np.clip(p * scale, 0, 255)
                             .astype(np.uint8))


def read_length_histogram(fastq_path: str) -> Dict[int, int]:
    """Read-length histogram from a fastq (util/read_length_distribution.cpp)."""
    hist: Dict[int, int] = defaultdict(int)
    with open(fastq_path) as f:
        for i, line in enumerate(f):
            if i % 4 == 1:
                hist[len(line.rstrip("\n"))] += 1
    return dict(hist)
