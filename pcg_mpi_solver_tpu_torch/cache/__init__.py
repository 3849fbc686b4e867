"""The partition cache: content-addressed on-disk partitions.

The port's counterpart of the JAX package's ``cache/`` for what
``Solver`` serves from ``RunConfig.cache_dir``: the structured, general
and hybrid partitions, the hybrid's float64 refresh partition, the mg
hierarchy and the mg fine bound, each under one monolithic key.

* ``keys``            — content-addressed keys: model fingerprint +
                        (n_parts, backend, dtype, partition knobs),
                        versioned by a hash of the code that shapes an
                        entry, ``CACHE_SCHEMA``, the port's
                        ``__version__`` and its package name (so a cache
                        directory shared with the JAX package never hands
                        one package the other's pickles).
* ``partition_cache`` — the on-disk store (atomic zlib-pickled writes via
                        ``utils/io.py``, LRU eviction, stats).

The JAX package's ``aot`` (its compiled-program cache) has no
counterpart: the port's kernels are already keyed by a hash of their
sources (``ops/kernels.py``).  Its shard-addressed store
(``cache/shards.py``) belongs to the multi-process build, ROADMAP queue
1 item 12.
"""

from pcg_mpi_solver_tpu_torch.cache.keys import (
    CACHE_SCHEMA, array_hash, model_fingerprint, partition_cache_key)
from pcg_mpi_solver_tpu_torch.cache.partition_cache import (
    cache_stats, cached_partition, format_stats, load_partition,
    store_partition)

__all__ = [
    "CACHE_SCHEMA",
    "array_hash",
    "model_fingerprint",
    "partition_cache_key",
    "cache_stats",
    "cached_partition",
    "format_stats",
    "load_partition",
    "store_partition",
]
