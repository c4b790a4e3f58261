"""ngsld_tpu — GPU linkage-disequilibrium engine.

A from-scratch JAX/XLA/Pallas rebuild with the full capability surface of
fgvieira/ngsLD v1.2.1 (pairwise LD from genotype likelihoods), designed for
device meshes rather than pthread pools.
"""

__version__ = "0.1.0"
