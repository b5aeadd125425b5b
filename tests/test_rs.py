"""GF(2^16) Reed-Solomon codec parity vs schifra golden vectors, plus
oligo-level (MainEncoder/MainDecoder-equivalent) roundtrips."""
import json

import numpy as np
import pytest

from nanopore_dna_storage.coding.rs import (
    RS16, rs_encode_oligos, rs_decode_oligos, gf_mul, gf_inv, alpha_pow,
)


def _run_schifra_golden(golden_dir, fname):
    with open(golden_dir / "rs" / fname) as f:
        g = json.load(f)
    rs = RS16(g["fec"])
    parity = rs.encode_shortened(np.array(g["data"]))
    assert np.concatenate([g["data"], parity]).tolist() == g["codeword"]
    for case in g["decode_cases"]:
        ok, fixed = rs.decode_shortened(np.array(case["recv"]),
                                        case["erasures"])
        assert ok == case["ok"], case["name"]
        if ok:
            assert fixed[: g["num"]].tolist() == case["decoded"], case["name"]


@pytest.mark.parametrize("fname", ["rs_golden.json", "rs_golden_f37.json"])
def test_schifra_parity(golden_dir, fname):
    _run_schifra_golden(golden_dir, fname)


@pytest.mark.slow
@pytest.mark.parametrize("fname", ["rs_golden_f169.json",
                                   "rs_golden_f338.json"])
def test_schifra_parity_production_fec(golden_dir, fname):
    """Production-scale codecs: 564 data oligos at fec=169 and 1128 at
    fec=338 over 65535-symbol shortened codewords (BASELINE.md Table 1) —
    including max-erasure, max-error, mixed e+2t=fec and beyond-capacity
    failure cases, all bit-compared against the reference schifra CLI
    (scripts/make_rs_goldens.py). A full codeword-column decode is timed:
    the pipeline decodes bytes_per_oligo/2 such columns per file
    (RSCode_16bit_fileio.py:289-299)."""
    import time
    with open(golden_dir / "rs" / fname) as f:
        g = json.load(f)
    t0 = time.perf_counter()
    _run_schifra_golden(golden_dir, fname)
    dt = time.perf_counter() - t0
    # 5 decode cases + 1 encode; a full recovery runs ~10 columns. Keep a
    # sanity bound so a superlinear regression in the fec-scaling paths
    # (Lagrange parity, Chien scan) cannot land silently.
    print(f"\n{fname}: encode+5 decodes in {dt:.1f}s")
    assert dt < 300, f"production-fec codec too slow: {dt:.1f}s"


def test_gf_axioms():
    rng = np.random.default_rng(0)
    a = rng.integers(1, 65536, 100)
    b = rng.integers(1, 65536, 100)
    assert (gf_mul(a, gf_inv(a)) == 1).all()
    assert (gf_mul(a, b) == gf_mul(b, a)).all()
    assert (alpha_pow(np.arange(5)) == [1, 2, 4, 8, 16]).all()


def test_oligo_roundtrip_with_missing_and_errors():
    rng = np.random.default_rng(5)
    num_data, red, bpo = 40, 12, 10
    payloads = rng.integers(0, 256, (num_data, bpo), dtype=np.uint8)
    enc = rs_encode_oligos(payloads, red)
    assert enc.shape == (num_data + red, bpo)
    assert (enc[:num_data] == payloads).all()
    total = num_data + red
    # drop 6 oligos (erasures), corrupt 2 (errors): 2*2 + 6 <= 12
    keep = np.setdiff1d(np.arange(total), [3, 7, 20, 33, 44, 50])
    obs = enc[keep].copy()
    obs[0] ^= 0xFF
    obs[10, 4] ^= 0x55
    ok, dec = rs_decode_oligos(keep, obs, red, total)
    assert ok
    assert (dec == payloads).all()


def test_oligo_decode_failure_fills_zeros():
    rng = np.random.default_rng(6)
    num_data, red, bpo = 20, 4, 6
    enc = rs_encode_oligos(
        rng.integers(0, 256, (num_data, bpo), dtype=np.uint8), red)
    total = num_data + red
    keep = np.arange(total - 6)  # 6 erasures > fec 4
    ok, dec = rs_decode_oligos(keep, enc[keep], red, total)
    assert not ok
