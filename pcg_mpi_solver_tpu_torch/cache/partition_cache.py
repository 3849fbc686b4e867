"""On-disk partition cache: content-addressed serialized partitions.

A hit turns a host partition build (seconds to minutes of numpy on a
large octree) into a pickle load.  Entries
are written atomically (a unique tmp file + ``os.replace``,
``utils/io.py::write_atomic``) so solvers sharing one directory never
read a half-written entry; a corrupt or unreadable entry is a miss and
is removed.  Layout: ``<cache_dir>/partition/<key>.zpkl``.

The port of ``pcg_mpi_solver_tpu/cache/partition_cache.py``'s monolithic
store (``load_partition``, ``store_partition``, ``evict_lru``,
``cached_partition``, ``cache_stats``, ``format_stats``) and its
shard-addressed ``cached_partition_shards``: a glue entry plus one entry
a part (``cache/shards.py``), so each process of a multi-process run
loads only its own parts.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

from pcg_mpi_solver_tpu_torch.utils import io as uio

# the port's cache has partitions only (the JAX package's aot/ and xla/
# hold its compiled programs)
SUBDIRS = ("partition",)
# Entries are zlib containers stored without compression: deflating a
# flagship partition (about a GB of index arrays) takes longer than
# building it, and inflating it dominates a warm load; disk space is the
# cheaper resource (the LRU cap bounds it).
ZLIB_LEVEL = 0


def _entry_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, "partition", f"{key}.zpkl")


def load_partition(cache_dir: str, key: str):
    """The entry for ``key``, or None on a miss.  A corrupt entry (a
    failed unpickle) is removed and is a miss."""
    path = _entry_path(cache_dir, key)
    if not os.path.exists(path):
        return None
    try:
        pm = uio.importz(path)
    except Exception:                                   # noqa: BLE001
        # any failure to decode (zlib, pickle, a missing class) is a miss
        try:
            os.remove(path)
        except OSError:
            pass
        return None
    try:
        os.utime(path)                                  # LRU touch
    except OSError:
        pass
    return pm


def store_partition(cache_dir: str, key: str, pm,
                    cap_bytes: Optional[float] = None) -> bool:
    """Publish ``pm`` under ``key`` atomically; best-effort (a full disk
    must not fail the solve that built the partition): returns whether
    it was stored.  LRU-evicts old entries past ``PCG_TPU_CACHE_GB``
    (default 8)."""
    path = _entry_path(cache_dir, key)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        uio.exportz_atomic(path, pm, level=ZLIB_LEVEL)
        evict_lru(os.path.dirname(path), keep=path, cap_bytes=cap_bytes)
        return True
    except Exception:                                   # noqa: BLE001
        return False


def evict_lru(entry_dir: str, keep: str,
              cap_bytes: Optional[float] = None,
              suffix: str = ".zpkl") -> None:
    """Remove the least recently used ``*suffix`` entries until the
    directory fits the size cap (never ``keep``); tmp files orphaned by a
    killed writer an hour ago go too.  Entries removed concurrently by
    another process are skipped."""
    if cap_bytes is None:
        cap_bytes = float(os.environ.get("PCG_TPU_CACHE_GB", 8)) * 2**30
    try:
        entries = []
        for fn in os.listdir(entry_dir):
            p = os.path.join(entry_dir, fn)
            try:
                if fn.endswith(suffix):
                    st = os.stat(p)
                    entries.append((st.st_mtime, st.st_size, p))
                elif fn.endswith(".tmp") and \
                        time.time() - os.stat(p).st_mtime > 3600:
                    os.remove(p)
            except OSError:
                continue
        total = sum(s for _, s, _ in entries)
        for _, size, p in sorted(entries):              # oldest first
            if total <= cap_bytes:
                break
            if os.path.abspath(p) == os.path.abspath(keep):
                continue
            try:
                os.remove(p)
            except OSError:
                pass
            total -= size
    except OSError:
        pass                                            # best-effort


def cached_partition(cache_dir: str, key: str, build: Callable[[], Any],
                     recorder=None, label: str = "partition"):
    """Load or build: a hit bumps ``cache.partition.hit`` and emits a
    ``cache`` event (``build`` never runs); a miss builds, stores, bumps
    ``cache.partition.miss`` and emits the event with ``stored``."""
    t0 = time.perf_counter()
    pm = load_partition(cache_dir, key)
    if pm is not None:
        if recorder is not None:
            recorder.inc("cache.partition.hit")
            recorder.event("cache", name=f"partition.{label}", hit=True,
                           key=key,
                           wall_s=round(time.perf_counter() - t0, 6))
        return pm
    pm = build()
    stored = store_partition(cache_dir, key, pm)
    if recorder is not None:
        recorder.inc("cache.partition.miss")
        recorder.event("cache", name=f"partition.{label}", hit=False,
                       key=key, stored=stored,
                       wall_s=round(time.perf_counter() - t0, 6))
    return pm


def cached_partition_shards(cache_dir: str, *, glue_key: str,
                            part_keys: Dict[int, str], builder,
                            split, join,
                            legacy_key: Optional[str] = None,
                            comm=None, recorder=None,
                            label: str = "partition"):
    """Shard-addressed load-or-build.

    Warm path: load the glue entry + ONLY the entries named in
    ``part_keys`` (this process's parts) and ``join`` them — zero build
    work, and the bytes read scale with parts-per-process, not model
    size.  Legacy shim: when any shard entry misses but ``legacy_key``
    (the monolithic :func:`partition_cache_key`) hits, the monolithic
    object is served as-is — pre-shard caches stay warm.  Cold path:
    ``builder()`` builds (possibly only this process's part range), then
    ``split`` publishes the glue + one entry per key in ``part_keys``
    (each process persists exactly the parts it built; under a
    multi-process cold start the processes collectively tile the whole
    partition).

    ``comm`` (``parallel/distributed.HostComm`` across processes): the
    warm-vs-cold decision GATES a collective code path (the cold
    builder runs the layout exchange), so it must be AGREED across the
    group — a process whose entries were concurrently evicted (or whose
    store failed on a full disk) must not build-and-exchange while its
    peers skip ahead to later collectives (mispaired allgathers hang
    the group).  With ``comm`` set, one small reduce decides: warm only
    if EVERY process can serve warm (shard entries or the legacy
    monolithic); otherwise every process builds.

    Emits ONE ``cache`` event (hit = fully-warm) with the per-entry read
    accounting the sharded-warm-start tests assert on; counters follow
    :func:`cached_partition` (`cache.partition.hit`/`miss`)."""
    t0 = time.perf_counter()
    glue = load_partition(cache_dir, glue_key)
    shards, missing = {}, []
    if glue is not None:
        for p, key in part_keys.items():
            sh = load_partition(cache_dir, key)
            if sh is None:
                missing.append(p)
                break
            shards[p] = sh
    shard_warm = glue is not None and not missing
    legacy_pm = None
    if not shard_warm and legacy_key is not None:
        legacy_pm = load_partition(cache_dir, legacy_key)
    can_serve = shard_warm or legacy_pm is not None
    if comm is not None and getattr(comm, "n_procs", 1) > 1:
        # warm/cold gates collective code paths — group-agreed (min:
        # all ranks must be able to serve warm)
        from pcg_mpi_solver_tpu_torch.parallel.consensus import agree_flag

        can_serve = agree_flag(comm, can_serve)
    if can_serve and shard_warm:
        pm = join(glue, shards)
        if recorder is not None:
            recorder.inc("cache.partition.hit")
            recorder.event("cache", name=f"partition.{label}", hit=True,
                           key=glue_key, shard=True,
                           entries=1 + len(shards),
                           parts=sorted(part_keys),
                           wall_s=round(time.perf_counter() - t0, 6))
        return pm
    if can_serve and legacy_pm is not None:
        if recorder is not None:
            recorder.inc("cache.partition.hit")
            recorder.event("cache", name=f"partition.{label}",
                           hit=True, key=legacy_key, shard=False,
                           legacy=True,
                           wall_s=round(time.perf_counter() - t0, 6))
        return legacy_pm
    pm = builder()
    glue, built = split(pm)
    keys = dict(part_keys)
    stored = store_partition(cache_dir, glue_key, glue)
    for p, key in keys.items():
        if p in built:
            stored = store_partition(cache_dir, key, built[p]) and stored
    if recorder is not None:
        recorder.inc("cache.partition.miss")
        recorder.event("cache", name=f"partition.{label}", hit=False,
                       key=glue_key, shard=True, stored=stored,
                       parts=sorted(keys),
                       wall_s=round(time.perf_counter() - t0, 6))
    return pm


def cache_stats(cache_dir: str) -> Dict[str, Dict[str, Any]]:
    """{section: {entries, bytes, newest_age_s}} of each cache subdir."""
    out: Dict[str, Dict[str, Any]] = {}
    now = time.time()
    for sub in SUBDIRS:
        d = os.path.join(cache_dir, sub)
        entries, size, newest = 0, 0, None
        if os.path.isdir(d):
            for root, _dirs, files in os.walk(d):
                for fn in files:
                    if fn.endswith(".tmp"):
                        continue
                    try:
                        st = os.stat(os.path.join(root, fn))
                    except OSError:
                        continue
                    entries += 1
                    size += st.st_size
                    age = now - st.st_mtime
                    newest = age if newest is None else min(newest, age)
        out[sub] = {"entries": entries, "bytes": size,
                    "newest_age_s": None if newest is None
                    else round(newest, 1)}
    return out


def format_stats(cache_dir: str) -> str:
    """Human-readable cache table (the CLI's ``cache-stats``)."""
    stats = cache_stats(cache_dir)
    lines = [f"cache dir: {cache_dir}",
             f"{'section':<12} {'entries':>8} {'size':>10} {'newest':>10}"]
    for sub in SUBDIRS:
        st = stats[sub]
        mb = st["bytes"] / 2**20
        age = ("-" if st["newest_age_s"] is None
               else f"{st['newest_age_s']:.0f}s ago")
        lines.append(f"{sub:<12} {st['entries']:>8} {mb:>9.1f}M {age:>10}")
    return "\n".join(lines)
