"""Signal-fidelity end-to-end simulation (simulator.py:59-116 parity):

    msg -> conv encode -> squiggle synthesis -> basecaller (trained from
    scratch on the hermetic pore model) -> fwd-bwd posteriors ->
    list-Viterbi -> CRC/index classification.

No synthetic-posterior shortcut anywhere — this drives the entire signal
path: squiggle.py, normalize.py, flipflop.py, train.py, fwdbwd.py, lva.py,
framing.py. Asserts substantial decode accuracy.
"""
import numpy as np
import pytest

from nanopore_dna_storage.config import ExperimentConfig
from nanopore_dna_storage.pipeline.encode import encode_bytes
from nanopore_dna_storage.pipeline.simulate import (
    simulate_and_decode_signal)


@pytest.mark.slow
def test_signal_fidelity_decode_accuracy():
    exp = ExperimentConfig(bytes_per_oligo=4, rs_redundancy=0.5,
                           conv_mem=6, conv_rate=1)
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, 24, dtype=np.uint8).tobytes()
    enc = encode_bytes(data, exp)
    stats, params = simulate_and_decode_signal(
        enc, exp, num_reads=24, list_size=4, seed=3, max_deviation=16,
        train_steps=300, kmer=1)
    assert stats.num_reads == 24
    # the from-scratch basecaller + LVA must decode most reads correctly
    assert stats.list_correct >= stats.num_reads * 0.5, vars(stats)
    assert stats.crc_pass >= stats.list_correct
    assert stats.unique_indices >= 3
