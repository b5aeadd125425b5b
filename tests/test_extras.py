"""util/extra equivalents: Raptor symbol check + trace viewer.

Reference: /root/reference/util/extra/vocab/check_raptor.py (symbol-diff
semantics) and /root/reference/flappie/misc/trace_flipflop.py (trace
plot) — the historical-experiment odds and ends from SURVEY §2.
"""
import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))


def _write_symbols(path, pairs):
    path.write_text(json.dumps({"symbols": [list(p) for p in pairs]}))


def test_check_raptor_symbol_diff(tmp_path):
    """Out-of-range symbols are dropped before the error count, matching
    the reference script's two-pass semantics."""
    from check_raptor import compare_symbol_files

    orig = tmp_path / "orig.json"
    recon = tmp_path / "recon.json"
    _write_symbols(orig, [(0, "aa"), (1, "bb"), (2, "cc")])
    # one correct, one erroneous, one out-of-range
    _write_symbols(recon, [(0, "aa"), (1, "XX"), (9, "zz")])
    s = compare_symbol_files(str(orig), str(recon))
    assert s == {"num_original": 3, "num_reconstruction": 3,
                 "num_out_of_range": 1, "num_erroneous": 1, "ok": False}

    _write_symbols(recon, [(0, "aa"), (2, "cc")])
    s = compare_symbol_files(str(orig), str(recon))
    assert s["ok"] and s["num_erroneous"] == 0


def test_trace_viewer_renders_png(tmp_path):
    """dump_trace_hdf5 -> viewer -> a PNG per read (headless Agg)."""
    h5py = __import__("h5py")  # noqa: F841 — skip cleanly if absent
    from nanopore_dna_storage.utils.profiling import dump_trace_hdf5
    from trace_flipflop_viewer import plot_read

    rng = np.random.default_rng(3)
    post = np.log(rng.dirichlet(np.ones(40), size=32).astype(np.float32))
    trace_path = tmp_path / "trace.h5"
    dump_trace_hdf5(str(trace_path), {"read_0": post})

    import h5py

    with h5py.File(trace_path, "r") as f:
        arr = f["read_0"][()]
    assert arr.dtype == np.uint8 and arr.shape == (32, 40)
    out = plot_read("read_0", arr, tmp_path)
    assert out.exists() and out.stat().st_size > 1000
