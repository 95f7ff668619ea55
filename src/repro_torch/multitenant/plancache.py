"""Cross-job plan cache: amortize profiling probes across tenants.

The paper amortizes its profiling steps across the *steps of one job*
(§IV-A: the same step graph repeats for thousands of iterations).  A
multi-tenant pool adds a second amortization axis: distinct jobs share op
classes and input sizes — a ResNet step and an Inception step both spend
most of their time in ``Conv2DBackpropFilter`` at Table-II sizes — so a
curve one tenant paid hill-climb probes for is valid for every other
tenant on the same machine (the curve measures the machine, not the job).
Entries are keyed by ``repro_torch.core.perfmodel.cross_graph_key`` — the op's
full analytic profile, not just the paper's ``(op_class, input_shape)``
unit — because across independently-built graphs the same class+shape can
hide different cost parameters (e.g. transformer depth lives in flops).

``PlanCache`` implements the ``repro_torch.core.perfmodel.CurveCache`` protocol
consulted by ``HillClimbProfiler.profile_graph``; it additionally keeps
hit/probe accounting so benchmarks can report how many probes the pool
saved versus profiling every job in isolation.

Persistence: the cache is the curve BACKEND of the closed-loop plan API
(``repro_torch.core.planstore``), and curves measure the machine — so they are
worth keeping across process restarts.  ``dump(path)``/``load(path)``
serialize the full cache state (curves, LRU recency order, hit/probe/
eviction accounting, per-entry machine-fingerprint namespaces) as
versioned JSON.  A corrupted, truncated, or version-mismatched file
degrades to an empty cache with a warning — a cold cache re-measures, a
wrong curve would mis-schedule silently, so load NEVER guesses.

Machine binding: curves measure a (machine, probe-interval) context, so
every lookup/insert is namespaced under the fingerprint most recently
passed to ``bind_machine``.  One cache (and one cache FILE) can therefore
serve a heterogeneous cluster: machine A's curves can never answer
machine B's lookups, while two pools on identical machines share hits.
Binding used to be whole-cache (first binder wins, mismatch raised) —
that made cross-machine sharing impossible and, worse, was only compared
at dump/load, so lookups themselves were never actually guarded.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import tempfile
from typing import Hashable

from repro_torch.core.perfmodel import CurveModel
from repro_torch.obs.log import get_logger

logger = get_logger(__name__)

# bump whenever the on-disk layout changes; load() refuses other versions
# (v2 added per-entry fingerprint namespaces; v1 files are still read,
# with their entries placed under the file's whole-cache fingerprint)
SCHEMA_VERSION = 2
_LEGACY_SCHEMA_VERSIONS = (1,)


def atomic_write_text(path: str | pathlib.Path, text: str) -> None:
    """Write-temp-then-rename so readers NEVER see a partial file.

    A crash mid-write used to truncate the target in place: ``load``
    would then degrade to an empty cache, silently discarding every
    probe already paid for.  Writing to a tempfile in the same directory
    and ``os.replace``-ing it over the target is atomic on POSIX — a
    crash leaves either the old complete file or the new complete file,
    and a stray ``.tmp`` is ignored by every loader.  The service-daemon
    job store persists through the same helper."""
    path = pathlib.Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # never leave the tempfile behind on failure; the target is
        # untouched either way
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _freeze(x):
    """JSON arrays -> tuples, recursively (cache keys are tuples —
    ``cross_graph_key`` — and JSON round-trips them as lists)."""
    if isinstance(x, list):
        return tuple(_freeze(v) for v in x)
    return x


def _curve_to_json(curve: CurveModel) -> dict:
    return {
        # bool dict keys become "true"/"false" strings explicitly (json
        # would coerce them anyway, but implicitly — be deliberate)
        "samples": {str(v).lower(): [[t, y] for t, y in pts]
                    for v, pts in curve.samples.items()},
        "case_lists": {str(v).lower(): list(cases)
                       for v, cases in curve.case_lists.items()},
        "probes": curve.probes,
    }


def _curve_from_json(d: dict) -> CurveModel:
    return CurveModel(
        samples={k == "true": [(int(t), float(y)) for t, y in pts]
                 for k, pts in d["samples"].items()},
        case_lists={k == "true": [int(t) for t in cases]
                    for k, cases in d["case_lists"].items()},
        probes=int(d["probes"]),
    )


@dataclasses.dataclass
class PlanCache:
    """Shared cross_graph_key(op) -> CurveModel store with accounting.

    Key with ``repro_torch.core.perfmodel.cross_graph_key`` (the op's full
    analytic profile), NOT ``op.size_key`` — see the module docstring.

    ``max_entries`` bounds the cache (the ROADMAP's "unbounded today"
    item): beyond the bound the least-recently-USED curve is evicted —
    dict insertion order doubles as the LRU list, with every hit
    reinserting its key at the back.  An evicted curve is simply
    re-measured on its next miss, so eviction never changes results,
    only probe counts (``evictions`` tracks how often that price was
    paid)."""

    curves: dict[Hashable, CurveModel] = dataclasses.field(
        default_factory=dict)
    max_entries: int | None = None   # None = unbounded (the old behavior)
    hits: int = 0
    misses: int = 0
    probes_saved: int = 0       # probes a hit avoided re-paying
    evictions: int = 0          # LRU evictions (bounded caches only)
    probes_evicted: int = 0     # probes paid for curves later evicted
    # the profiling context (machine fingerprint + probe interval) whose
    # namespace lookups/inserts currently resolve under; None = the bare
    # un-namespaced keyspace (direct CurveCache use outside a runtime)
    machine_fingerprint: Hashable | None = None
    # repr of the fingerprint this cache was last PERSISTED under (a
    # loaded cache can't reconstruct live tuples — spec objects don't
    # survive JSON — so namespaces are canonical reprs on disk)
    loaded_fingerprint: str | None = None

    def bind_machine(self, fingerprint: Hashable) -> None:
        """Select the profiling context (timing function + probe protocol
        — see ConcurrencyRuntime.profile) whose curve namespace subsequent
        lookups and inserts resolve under.  Curves measure a machine
        through a probe grid, so every entry is keyed by the context it
        was measured in: one cache can serve a whole heterogeneous
        cluster (each machine's runtime re-binds before profiling) and a
        lookup can never be answered by another machine's curve."""
        self.machine_fingerprint = fingerprint

    def _nskey(self, key: Hashable) -> tuple:
        """Internal storage key: ``(namespace, key)`` where the namespace
        is the bound context's canonical repr (``None`` when unbound).
        Reprs, not live tuples, so that an entry persisted to JSON and
        reloaded answers the same machine's lookups again.  Every entry
        is wrapped — even unbound ones — so dump/load never has to guess
        whether a tuple-shaped raw key is itself a namespace."""
        fp = self.machine_fingerprint
        return (repr(fp) if fp is not None else None, key)

    def warm_keys(self, fingerprint: Hashable) -> frozenset:
        """Raw keys already cached under ``fingerprint``'s namespace —
        the curves a job routed to that machine would NOT re-pay probes
        for.  Read-only: consulted by the cluster router for cache
        affinity, so it must not perturb hit/miss accounting."""
        ns = repr(fingerprint)
        return frozenset(k for n, k in self.curves if n == ns)

    # ---- CurveCache protocol -----------------------------------------
    def lookup(self, key: Hashable) -> CurveModel | None:
        skey = self._nskey(key)
        curve = self.curves.get(skey)
        if curve is None:
            self.misses += 1
            return None
        self.hits += 1
        self.probes_saved += curve.probes
        # refresh LRU position: pop + reinsert moves the key to the back
        del self.curves[skey]
        self.curves[skey] = curve
        return curve

    def insert(self, key: Hashable, curve: CurveModel) -> None:
        skey = self._nskey(key)
        self.curves.pop(skey, None)       # reinsertion refreshes recency
        self.curves[skey] = curve
        if self.max_entries is not None:
            while len(self.curves) > self.max_entries:
                oldest = next(iter(self.curves))
                # the evicted curve's probes were really measured; keep
                # them in probes_spent so eviction (which forces a future
                # re-measure) can never make the cache LOOK cheaper
                self.probes_evicted += self.curves[oldest].probes
                del self.curves[oldest]
                self.evictions += 1

    # ---- persistence --------------------------------------------------
    def dump(self, path: str | pathlib.Path) -> None:
        """Serialize the full cache state as versioned JSON.

        Entries are written in dict order = LRU order (oldest first), so
        a load re-inserts them in the same order and recency survives the
        round trip.  Floats round-trip exactly through ``json`` (Python
        serializes shortest-repr doubles), so a reloaded curve predicts
        bit-identical times."""
        fp = (repr(self.machine_fingerprint)
              if self.machine_fingerprint is not None
              else self.loaded_fingerprint)
        payload = {
            "schema": SCHEMA_VERSION,
            "machine_fingerprint": fp,
            "max_entries": self.max_entries,
            "stats": {
                "hits": self.hits, "misses": self.misses,
                "probes_saved": self.probes_saved,
                "evictions": self.evictions,
                "probes_evicted": self.probes_evicted,
            },
            # json serializes tuples as arrays recursively; _freeze on
            # load restores them (non-tuple keys pass through untouched).
            # each entry records its fingerprint namespace so one file
            # can carry a whole heterogeneous cluster's curves
            "entries": [{"ns": ns, "key": k, "curve": _curve_to_json(c)}
                        for (ns, k), c in self.curves.items()],
        }
        # atomic: a crash mid-dump must leave the previous good cache,
        # not a truncated file that load() degrades to empty
        atomic_write_text(path, json.dumps(payload))

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "PlanCache":
        """Deserialize a cache ``dump`` wrote.

        Any failure — unreadable file, malformed JSON, wrong schema
        version, mangled entries — degrades to an EMPTY cache with a
        warning rather than raising: persistence is an optimization, and
        a cold cache merely re-measures, while crashing the launcher (or
        worse, half-loading curves) would cost more than it saves."""
        try:
            payload = json.loads(pathlib.Path(path).read_text())
            if not isinstance(payload, dict):
                raise ValueError("top-level JSON is not an object")
            schema = payload.get("schema")
            if schema != SCHEMA_VERSION and schema not in _LEGACY_SCHEMA_VERSIONS:
                raise ValueError(
                    f"schema version {schema!r} != {SCHEMA_VERSION}")
            stats = payload["stats"]
            cache = cls(
                max_entries=payload["max_entries"],
                hits=int(stats["hits"]), misses=int(stats["misses"]),
                probes_saved=int(stats["probes_saved"]),
                evictions=int(stats["evictions"]),
                probes_evicted=int(stats["probes_evicted"]),
                loaded_fingerprint=payload["machine_fingerprint"],
            )
            for entry in payload["entries"]:
                # v1 entries carried no namespace: they were measured
                # under the file's whole-cache fingerprint, so that is
                # the namespace they belong to
                ns = (entry["ns"] if schema == SCHEMA_VERSION
                      else payload["machine_fingerprint"])
                cache.curves[(ns, _freeze(entry["key"]))] = _curve_from_json(
                    entry["curve"])
            return cache
        except Exception as e:  # noqa: BLE001 - degrade, never crash
            logger.warning(
                "PlanCache.load(%s): %r — falling back to an "
                "empty cache (curves will be re-measured)", path, e)
            return cls()

    # ---- accounting ---------------------------------------------------
    @property
    def probes_spent(self) -> int:
        """Probes actually measured: every resident curve's cost plus the
        cost of curves measured and later evicted (an evicted curve that
        re-misses is re-measured, and both payments count)."""
        return (sum(c.probes for c in self.curves.values())
                + self.probes_evicted)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict[str, float]:
        return {
            "curves": len(self.curves),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "probes_spent": self.probes_spent,
            "probes_saved": self.probes_saved,
            "evictions": self.evictions,
        }
