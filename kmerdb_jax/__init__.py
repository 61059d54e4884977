"""kmerdb_jax — a k-mer analysis engine on JAX, for NVIDIA GPUs.

A from-scratch re-design of the capabilities of refresh-bio/kmer-db
(v2.3.1) for accelerators:

* k-mer extraction / minhash filtering as vectorized ops
  (reference: src/kmer_extract.h, src/filter.h),
* the k-mer -> sample-set-pattern database as sorted k-mer arrays
  plus pattern/incidence tensors (replacing src/prefix_kmer_db.{h,cpp}
  hashtables + Elias-gamma pattern forest),
* common-k-mer counting (all2all / new2all / db2db) as weighted
  Gram-matrix contractions on the tensor cores (ops/gram.py,
  replacing src/similarity_calculator.cpp + src/simd/row_add*),
* multi-device scaling via jax.sharding meshes and psum collectives
  (replacing thread pools / queues in src/queue.h).

The algebraic core: each *pattern* p (a distinct set of samples
sharing some k-mers) with w_p k-mers contributes
``w_p * outer(b_p, b_p)`` to the common-k-mer count matrix, where
b_p is the 0/1 incidence vector over samples.  Hence

    C = B^T diag(w) B

which maps directly onto matrix units.
"""

# jax is imported lazily (kmerdb_jax/_jaxinit.py): CLI modes that never
# touch a device (distance, minhash, host-path queries) skip the
# multi-second jax import entirely.

__version__ = "0.3.0"
