"""Sync-marker decode parity vs reference golden lists.

Periodic known bits (--sync-marker/--sync-period) restrict which conv states
are valid at each message position (viterbi_convolutional_code.cpp:388-414,
968-975), including the forward-strand position mapping under RC. Each golden
case was decoded by the reference binary on a synthetic posterior; we require
identical decoded bit lists.
"""
import json

import numpy as np
import pytest

from nanopore_dna_storage.config import ConvCodeConfig, DecodeConfig
from nanopore_dna_storage.ops.lva import LVADecoder


def _cases(golden_dir):
    with open(golden_dir / "sync" / "manifest.json") as f:
        return json.load(f)


def _run_sync_case(golden_dir, case, backend="oracle"):
    cfg = DecodeConfig(
        code=ConvCodeConfig(mem=case["mem"], rate=case["rate"],
                            msg_len=case["msg_len"], rc=case["rc"],
                            sync_marker=case["sync_marker"],
                            sync_period=case["sync_period"]),
        list_size=case["list_size"],
        max_deviation=case["max_deviation"],
        backend=backend,
    )
    dec = LVADecoder(cfg)
    raw = np.fromfile(golden_dir / "sync" / f"{case['name']}.post",
                      dtype="<f4").reshape(-1, 5, 8)
    msgs, _, valid = dec.decode(raw[None])
    got = ["".join(map(str, m)) for m, v in zip(msgs[0], valid[0]) if v]
    want = (golden_dir / "sync" / f"{case['name']}.lists").read_text().split()
    assert got == want, f"sync decode mismatch for {case['name']}"
    assert got[0] == case["true_msg"]


@pytest.mark.parametrize("idx", range(7))
def test_sync_golden_parity(golden_dir, idx):
    cases = _cases(golden_dir)
    if idx >= len(cases):
        pytest.skip("no such case")
    case = cases[idx]
    if case["mem"] >= 8:
        pytest.skip("m>=8 sync cases run in the slow suite (1-2 min each)")
    _run_sync_case(golden_dir, case)


@pytest.mark.parametrize("idx", range(5))
def test_sync_golden_parity_traceback(golden_dir, idx):
    """The production traceback backend on the m=6 sync goldens: the
    sync-restricted valid-state masks gate its write-back."""
    case = [c for c in _cases(golden_dir) if c["mem"] == 6][idx]
    _run_sync_case(golden_dir, case, backend="traceback")


@pytest.mark.slow
@pytest.mark.parametrize("idx", range(7))
def test_sync_golden_parity_large(golden_dir, idx):
    cases = _cases(golden_dir)
    if idx >= len(cases):
        pytest.skip("no such case")
    case = cases[idx]
    if case["mem"] < 8:
        pytest.skip("covered by the fast suite")
    _run_sync_case(golden_dir, case)
