"""Topology-aware thread placement: width -> concrete core set.

The paper's scheduler divides MCDRAM bandwidth among co-running ops but
places threads on a flat 68-core pool.  On the real KNL socket the cores
sit on 34 shared-L2 tiles grouped into mesh quadrants, and co-runs that
straddle quadrants contend far harder than quadrant-local ones — so under
``topology="quadrant"`` placement becomes a first-class scheduling
decision.  ``place`` maps a launch's width to concrete core ids:

1. prefer an EMPTY quadrant that fits the width (best fit among empties,
   so big empty quadrants stay open for wide launches);
2. else pack quadrant-local: the single quadrant with enough free cores
   and the fewest co-resident busy cores (least local contention);
3. else bounded spill: fill from the freest quadrants so the launch
   touches as few quadrants as possible — the straddle is priced by the
   cost oracle (``SimMachine.quadrant_bw_share``), not forbidden.

A ``prefer`` quadrant hint (pool tenant affinity) wins ties at every
tier, and ``avoid`` quadrants (co-residents whose class pair is
blacklisted under the cross-quadrant relation) are never allocated —
when avoiding them leaves too few cores, placement fails and the caller
skips the launch.

Core selection inside the chosen quadrants is tile-aware: cache-sharing
launches take whole shared-L2 tile pairs first (the paper's two-threads-
per-tile affinity variant), falling back to singleton free cores only
when the pairs run out.  Everything is deterministic: same occupancy in,
same core set out.

``topology="flat"`` bypasses this module entirely — flat timelines stay
bit-for-bit identical to the pre-topology scheduler, which is what the
differential/golden suites lock down.
"""

from __future__ import annotations

from typing import Iterable

from repro_torch.hw.spec import KnlLikeSpec

Relation = str          # "any" (flat topology) | "local" | "cross"

#: the legacy single-key relation used by flat topology: every co-run
#: observation lands in one bucket, exactly the pre-topology recorder
REL_ANY = "any"
#: quadrant-local co-run: the two launches occupy disjoint quadrants
REL_LOCAL = "local"
#: cross-quadrant co-run: the launches straddle into shared quadrants
#: (or either side is an unplaced hyper-lane launch riding busy cores)
REL_CROSS = "cross"


def quadrants_of(spec: KnlLikeSpec, cores: Iterable[int]) -> frozenset[int]:
    return frozenset(spec.quadrant_of_core(c) for c in cores)


def placement_relation(spec: KnlLikeSpec, cores_a: tuple[int, ...],
                       cores_b: tuple[int, ...]) -> Relation:
    """How two co-running placements relate: disjoint quadrant sets are a
    quadrant-LOCAL co-run (each op's traffic stays home), any overlap —
    or an unplaced side, which rides everyone's cores — is CROSS."""
    if not cores_a or not cores_b:
        return REL_CROSS
    if quadrants_of(spec, cores_a) & quadrants_of(spec, cores_b):
        return REL_CROSS
    return REL_LOCAL


def free_cores_by_quadrant(spec: KnlLikeSpec,
                           busy: frozenset[int]) -> dict[int, list[int]]:
    """quadrant -> ascending free core ids (busy = union of running
    placements, so a preemption revoke frees its cores implicitly)."""
    return {q: [c for c in spec.quadrant_cores(q) if c not in busy]
            for q in range(spec.quadrants)}


def _take(spec: KnlLikeSpec, free: list[int], width: int,
          cache_sharing: bool) -> list[int]:
    """Pick ``width`` cores from one quadrant's free list, whole shared-L2
    tile pairs first for cache-sharing launches (both threads of a pair
    share the tile's 1MB L2 — the paper's sharing affinity)."""
    if not cache_sharing:
        return free[:width]
    fs = set(free)
    pairs = [c for c in free if (c ^ 1) in fs]      # c^1 = the tile-mate
    singles = [c for c in free if (c ^ 1) not in fs]
    return (pairs + singles)[:width]


def place(spec: KnlLikeSpec, width: int, busy: frozenset[int],
          cache_sharing: bool = True, prefer: int | None = None,
          avoid: frozenset[int] = frozenset()) -> tuple[int, ...] | None:
    """Concrete core ids for a ``width``-thread launch, or ``None`` when
    the avoid constraints leave too few free cores (the caller treats
    that launch as incompatible at this instant)."""
    free = {q: f for q, f in free_cores_by_quadrant(spec, busy).items()
            if q not in avoid}
    if sum(len(f) for f in free.values()) < width:
        return None

    def tiered(q: int) -> tuple:
        # smaller tuple = better; prefer-hint beats everything in a tier
        n_busy = len(spec.quadrant_cores(q)) - len(free[q])
        return (q != prefer, n_busy, len(free[q]), q)

    # 1. empty quadrant, best fit (smallest capacity that holds width)
    empties = [q for q, f in free.items()
               if len(f) >= width and len(f) == len(spec.quadrant_cores(q))]
    if empties:
        q = min(empties, key=lambda q: (q != prefer, len(free[q]), q))
        return tuple(_take(spec, free[q], width, cache_sharing))
    # 2. quadrant-local packing: fewest co-residents
    fitting = [q for q, f in free.items() if len(f) >= width]
    if fitting:
        q = min(fitting, key=tiered)
        return tuple(_take(spec, free[q], width, cache_sharing))
    # 3. bounded spill: freest quadrants first, so the launch straddles as
    #    few quadrants as possible (the straddle is priced, not forbidden)
    order = sorted(free, key=lambda q: (q != prefer, -len(free[q]), q))
    out: list[int] = []
    for q in order:
        if len(out) >= width:
            break
        out.extend(_take(spec, free[q], width - len(out), cache_sharing))
    return tuple(out)
