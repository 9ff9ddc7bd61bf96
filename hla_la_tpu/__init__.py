"""hla_la_tpu — an HLA typing engine in JAX with a GPU device path.

A JAX/XLA framework with the capabilities of HLA*LA (graph-based HLA typing
at G-group resolution from WGS reads): a population reference graph (PRG) of
the MHC compiled to dense arrays, read alignment via linear-projection
seeding plus banded affine-gap extension, and a diploid pair-likelihood
model over exon allele clusters — built around fixed-shape batches (an
XLA scan for the extension DP, matmuls for the allele likelihood model,
an XLA scan for the pair reduction, sharding for multi-device
scale-out).  `device.py` makes every device choice.

Layer map (mirrors SURVEY.md §1):
  cli            — orchestration (reference: HLA-LA.pl + HLA-LA.cpp dispatcher)
  models/        — pipelines: read alignment, HLA typing (ref: processBAM, HLATyper)
  ops/           — device kernels: extension DP, cluster LL matmul, pair reduction
  mapping/       — native k-mer seeding (+optional external bwa wrapper; ref: mapper/bwa)
  graph/         — PRG core, dense compilation, data-package I/O (ref: Graph/)
  io/            — BAM/FASTA/FASTQ host I/O (ref: BamTools usage)
  sim/           — graph & read simulators, truth evaluation (ref: simulator/)
  parallel/      — mesh/sharding helpers (replaces OpenMP; ref: SURVEY §2.3)
  utils/         — phred/log-space helpers, config, stats
"""

__version__ = "0.1.0"
