"""The partition cache: content-addressed on-disk partitions.

The port's counterpart of the JAX package's ``cache/`` for what
``Solver`` serves from ``RunConfig.cache_dir``: the structured, general
and hybrid partitions, the hybrid's float64 refresh partition, the mg
hierarchy and the mg fine bound, under one monolithic key, or, for the
structured and general partitions and the mg hierarchy of a solve over
several processes, as a glue entry plus one entry a part.

* ``keys``            — content-addressed keys: model fingerprint +
                        (n_parts, backend, dtype, partition knobs),
                        versioned by a hash of the code that shapes an
                        entry, ``CACHE_SCHEMA``, the port's
                        ``__version__`` and its package name (so a cache
                        directory shared with the JAX package never hands
                        one package the other's pickles).
* ``partition_cache`` — the on-disk store (atomic zlib-pickled writes via
                        ``utils/io.py``, LRU eviction, stats) and its
                        shard-addressed load-or-build.
* ``shards``          — split a partition (or an mg hierarchy) into its
                        glue and per-part entries, and join them back.

The JAX package's ``aot`` (its compiled-program cache) has no
counterpart: the port's kernels are already keyed by a hash of their
sources (``ops/kernels.py``).
"""

from pcg_mpi_solver_tpu_torch.cache.keys import (
    CACHE_SCHEMA, array_hash, model_fingerprint, partition_cache_key,
    partition_glue_key, partition_shard_key)
from pcg_mpi_solver_tpu_torch.cache.partition_cache import (
    cache_stats, cached_partition, cached_partition_shards, format_stats,
    load_partition, store_partition)

__all__ = [
    "CACHE_SCHEMA",
    "array_hash",
    "model_fingerprint",
    "partition_cache_key",
    "partition_glue_key",
    "partition_shard_key",
    "cache_stats",
    "cached_partition",
    "cached_partition_shards",
    "format_stats",
    "load_partition",
    "store_partition",
]
