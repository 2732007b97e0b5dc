"""spaln_tpu — a spliced-alignment engine for JAX accelerators.

A from-scratch JAX/XLA framework with the capabilities of ogotoh/spaln:
genome-wide mapping and spliced alignment of
cDNA/EST and protein queries onto whole genomes via block-based k-mer seed
search, Wilber-Lipman HSP chaining, and banded spliced DP with splice-signal
PSSMs, coding-potential and intron-length-distribution scoring — implemented
as batched anti-diagonal wavefront scans on the device (one NVIDIA GPU,
or several with the query batch sharded).

Package layout:
  seq/      sequence codec, FASTA IO, formatted genome store
  score/    substitution matrices, splice PSSMs, intron-length model, potentials
  ops/      DP alignment kernels (scalar oracles + batched wavefront engines)
  seed/     spaced-seed k-mer machinery, Wilber-Lipman HSP chains, block index
  align/    seeded-recursive alignment driver, gene-structure extraction
  out/      GFF3/exon/intron/SAM/... writers, sortgrcd-style locus merge
  parallel/ device-mesh sharding, batched dispatch
"""

__version__ = "0.1.0"
