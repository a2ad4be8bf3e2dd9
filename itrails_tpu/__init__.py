"""itrails-tpu: a JAX coalescent-HMM engine for GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``trails-phylogeny/itrails`` (reference mounted read-only at /root/reference):
inference of speciation times, effective population sizes, recombination rate
(and optionally migration) for 3 species + outgroup under a
coalescent-with-recombination HMM along the genome, plus Viterbi / posterior
decoding of gene-tree paths.

Design (not a port):

* The combinatorics of the two-locus ancestral process (set partitions, omega
  masks, path fan-out of the interval DP, Van Loan / deepest-time-interval
  path enumeration) are compiled ONCE per ``(n_int_AB, n_int_ABC)`` topology
  into static index/mask tensors on the host (``core.statespace``,
  ``core.schedule``).  The reference re-enumerates them per optimizer
  evaluation (``get_joint_prob_mat.py:85-93``).
* All parameter-dependent math — batched matrix exponentials, the masked
  interval DP, Van Loan block integrals, the t->inf solves, and the JC69
  emission integrals — is a single jitted function ``params -> (a, b, pi)``
  (``core.model``) built from dense padded arrays, batched matmuls and
  ``lax.scan``.
* The genome-scale HMM decoders (forward/backward/posterior/Viterbi) are
  log-space scans batched over alignment windows with ``vmap`` and sharded
  data-parallel over a ``jax.sharding.Mesh`` (``hmm``), with ``psum`` merging
  per-shard log-likelihoods; on a CUDA device the forward value and its
  gradient run as Pallas-Triton kernels (``hmm.triton_hmm``).
"""

__version__ = "0.1.0"
