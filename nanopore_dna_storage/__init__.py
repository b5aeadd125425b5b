"""Nanopore DNA storage encode/decode engine in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
shubhamchandak94/nanopore_dna_storage: convolutional inner code over DNA,
list-Viterbi decoding fused with flip-flop basecaller transition posteriors,
CRC8/PRP framing, and a GF(2^16) Reed-Solomon outer code.
"""

__version__ = "0.1.0"
