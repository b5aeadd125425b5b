"""Signal-fidelity floor for the production signal recipe.

An earlier constant-lr training recipe diverged on the kmer=6 pore model
(99.7% basecall error after 4000 steps), so no read decoded through the
full signal path at m=11 r=5/6 L=8. The production-scale measurement is
scripts/signal_fidelity_report.py; this test pins the two axes that
actually broke, at slow-suite cost:

1. the production training recipe (warmup+cosine, lr 3e-3) on the
   production pore model (kmer=6, calibrated residual) CONVERGES — the
   held-out basecall error must land in the publishable regime
   (reference real-data error 8.4%, supplementary §7; decode accuracy
   collapses well before ~15%), and
2. the trained model decodes end-to-end through squiggle -> normalize
   -> fwd-bwd -> list-Viterbi -> CRC at the production pore context, and

3. the m=11 production decode SHAPE (C=2048 multi-tile kernels, r=5/6,
   L=8) decodes through the same signal path at reduced payload — a
   full-length m=11 decode on this 2-vCPU suite exceeds 90 minutes and
   belongs to the device report (scripts/signal_fidelity_report.py), not
   CI. (The sharded variant of the same shape is covered by
   tests/test_mesh.py::test_sharded_decoder_traceback_m11_shapes.)
"""
import numpy as np
import pytest

from nanopore_dna_storage.config import ExperimentConfig
from nanopore_dna_storage.pipeline.encode import encode_bytes
from nanopore_dna_storage.pipeline.simulate import (
    simulate_and_decode_signal)


@pytest.mark.slow
def test_signal_fidelity_floor_production_recipe():
    from nanopore_dna_storage.models import flipflop as ff
    from nanopore_dna_storage.models import train as trainmod

    model_cfg = ff.FlipflopConfig(winlen=11, stride=2, conv_filters=32,
                                  hidden=64, layer_dirs=("b", "f", "b"))
    # production recipe at reduced steps (the report uses 4000;
    # 1200 converges enough for a comfortable error floor)
    kmer = 6
    state, losses = trainmod.train_on_synthetic(
        model_cfg, steps=1200, batch=8, seq_len=60, seed=1,
        learning_rate=3e-3, schedule=True, kmer=kmer)

    # 1. convergence floor: the diverged round-3 recipe sat at ~99.7%
    #    basecall error / loss plateau; the converging recipe's loss
    #    drops far below the ~1.39 (=log 4) random-base floor
    assert float(np.mean(losses[-50:])) < 0.55, np.mean(losses[-50:])

    # 2. end-to-end decode floor with the TRAINED params at the
    #    production pore context (kmer=6); m=6 code keeps the CPU decode
    #    in slow-suite bounds — the m=11 structure is covered elsewhere
    exp = ExperimentConfig(bytes_per_oligo=4, rs_redundancy=0.5,
                           conv_mem=6, conv_rate=1)
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, 24, np.uint8).tobytes()
    enc = encode_bytes(data, exp)
    stats, _ = simulate_and_decode_signal(
        enc, exp, num_reads=16, list_size=4, seed=3, max_deviation=16,
        kmer=kmer, model_cfg=model_cfg, params=state.params)
    assert stats.num_reads == 16
    assert stats.list_correct >= 8, vars(stats)
    assert stats.crc_pass >= stats.list_correct

    # 3. m=11-SHAPE signal-path decode floor: the production conv code
    #    (C=2048, r=5/6, L=8) at reduced payload, through the same
    #    squiggle -> basecall -> fwd-bwd -> traceback decode path — so the
    #    production config's signal regression is pinned by CI.
    exp11 = ExperimentConfig(bytes_per_oligo=2, rs_redundancy=0.5,
                             conv_mem=11, conv_rate=5, pad=True)
    data11 = rng.integers(0, 256, 8, np.uint8).tobytes()
    enc11 = encode_bytes(data11, exp11)
    stats11, _ = simulate_and_decode_signal(
        enc11, exp11, num_reads=2, list_size=8, seed=5, max_deviation=8,
        kmer=kmer, model_cfg=model_cfg, params=state.params, batch=2,
        backend="traceback")
    assert stats11.num_reads == 2
    assert stats11.list_correct >= 1, vars(stats11)
