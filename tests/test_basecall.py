"""Standalone basecalling pipeline (flappie CLI parity surface)."""
import numpy as np

from nanopore_dna_storage.models import flipflop as ff
from nanopore_dna_storage.pipeline.basecall import (
    Basecaller, write_fastq, phred_char,
)


def test_basecall_batch_and_fastq(tmp_path):
    cfg = ff.FlipflopConfig(winlen=5, stride=2, conv_filters=8, hidden=8)
    bc = Basecaller(cfg=cfg, seed=0)
    rng = np.random.default_rng(0)
    sigs = [rng.standard_normal(600).astype(np.float32),
            rng.standard_normal(420).astype(np.float32)]
    calls = bc.basecall(["r1", "r2"], sigs, trim=False, keep_posterior=True)
    assert len(calls) == 2
    for c in calls:
        assert len(c.sequence) == len(c.quality)
        assert set(c.sequence) <= set("ACGT")
        assert c.posterior.shape[0] == c.nblocks
        assert (np.diff(c.block_index) > 0).all()
    # variable lengths: padded read must match its solo basecall
    solo = bc.basecall(["r2"], [sigs[1]], trim=False)[0]
    assert solo.sequence == calls[1].sequence
    out = tmp_path / "out.fastq"
    write_fastq(str(out), calls)
    lines = out.read_text().splitlines()
    assert lines[0] == "@r1" and lines[4] == "@r2"
    assert len(lines) == 8


def test_phred_range():
    q = phred_char(np.asarray([0.0, 0.5, 0.99999, 1.0]))
    assert q[0] == 33
    assert (q >= 33).all() and (q <= 126).all()
    assert q[-1] == q[-2]  # clipped
