"""Bucket-ladder autotuning: fold observed request-shape and
padding-waste telemetry back into a refined BucketTable.

The serving tradeoff the ladder encodes: more buckets = tighter padding
(less wasted device compute per dispatch) but more compiled programs
(compile time, executable memory, colder caches). The default
power-of-two auto ladder is shape-agnostic, so a workload concentrated
at, say, (10, 48) pays for a (16, 64) bucket forever — 53% of every
A-cell is padding. This pass rebuilds the ladder from what the service
actually saw:

1. aggregate per-request shapes from the telemetry JSONL the service
   writes (``request`` events carry ``m``/``n``/``bucket``/``padding_waste``);
2. quantize shapes up to a ``quantum`` grid → candidate buckets, counted
   by traffic (this is what *splits* a hot, wasteful bucket: its member
   shapes become their own tighter candidates);
3. *merge* cold candidates (below ``min_share`` of traffic) and the
   cheapest-to-merge pairs until the program cap (``max_programs``)
   holds — merge cost = added padded cells across the merged traffic;
4. enforce the serving constraints: every observed shape still fits
   somewhere (pad-column rule ``N − n ≥ M − m`` included) and every
   bucket batch divides the mesh device count.

Offline: ``cli.py autotune --telemetry serve.jsonl --out ladder.json``
writes the refined ladder; ``cli.py serve --buckets ladder.json`` serves
it. Online: ``SolveService.apply_ladder(specs)`` swaps at a safe epoch
boundary (drain → swap → warm), preserving the zero-warm-recompile
invariant across the swap.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from distributedlpsolver_tpu_torch.serve.buckets import BucketSpec, BucketTable


@dataclasses.dataclass(frozen=True)
class AutotuneConfig:
    """Knobs of the ladder refinement pass."""

    # Buckets whose mean shape-level padding waste exceeds this are
    # considered hot-and-wasteful: their member shapes seed their own
    # candidates (the "split" move).
    waste_threshold: float = 0.35
    # Candidates serving less than this fraction of requests merge into
    # their cheapest cover (the "merge cold" move).
    min_share: float = 0.02
    # Cap on compiled bucket programs after refinement.
    max_programs: int = 12
    # Shape rounding grain for candidate buckets (keeps the candidate set
    # small and the programs reusable across near-identical shapes).
    quantum: int = 8
    # Slots per bucket; None keeps the table/service default.
    batch: Optional[int] = None
    # Batch-axis mesh width bucket batches must divide (mesh dispatch).
    devices: int = 1


def load_request_shapes(path: str) -> List[Tuple[int, int]]:
    """(m, n) per bucketed request from a service telemetry JSONL file
    (solo-path requests carry no bucket and are skipped — the ladder
    doesn't serve them)."""
    shapes: List[Tuple[int, int]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                continue
            if (
                e.get("event") == "request"
                and e.get("bucket")
                and e.get("m", 0) > 0
                and e.get("n", 0) > 0
            ):
                shapes.append((int(e["m"]), int(e["n"])))
    return shapes


def _roundup(v: int, q: int) -> int:
    return -(-v // q) * q


def _candidate_for(m: int, n: int, q: int) -> Tuple[int, int]:
    """Smallest quantum-grid bucket shape that holds (m, n), pad-column
    rule included."""
    M = _roundup(max(m, 1), q)
    N = _roundup(max(n, 1), q)
    while (N - n) < (M - m):
        N += q
    return (M, N)


def _cover(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    """Smallest shape covering both candidate shapes. Elementwise max
    preserves the pad-column rule for all members: N* − n ≥ N_a − n ≥
    M_a − m when N* ≥ N_a and similarly for b's members."""
    return (max(a[0], b[0]), max(a[1], b[1]))


def _shape_waste(m: int, n: int, spec_mn: Tuple[int, int]) -> float:
    return 1.0 - (m * n) / float(spec_mn[0] * spec_mn[1])


def autotune_ladder(
    shapes: Iterable[Tuple[int, int]],
    current: Optional[Sequence[BucketSpec]] = None,
    config: Optional[AutotuneConfig] = None,
) -> Tuple[List[BucketSpec], dict]:
    """Refine a bucket ladder from observed request shapes.

    Returns ``(specs, report)``: the refined ladder (deterministic for a
    given input) and a report dict with before/after program counts and
    predicted shape-level padding waste (slot-occupancy waste depends on
    traffic arrival and is out of scope here).
    """
    cfg = config or AutotuneConfig()
    counts: Dict[Tuple[int, int], int] = {}
    for m, n in shapes:
        counts[(m, n)] = counts.get((m, n), 0) + 1
    total = sum(counts.values())
    if total == 0:
        specs = list(current) if current else []
        return specs, {
            "requests": 0,
            "note": "no bucketed request telemetry; ladder unchanged",
            "ladder": [list(s.key()) for s in specs],
        }

    # -- 1/2: candidates from observed shapes (the split move) ----------
    # groups: candidate shape -> [(m, n, count), ...]
    groups: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}
    for (m, n), cnt in sorted(counts.items()):
        cand = _candidate_for(m, n, cfg.quantum)
        groups.setdefault(cand, []).append((m, n, cnt))

    # Current-ladder waste for the report (and the split decision trace):
    # shapes whose current bucket wastes below threshold could stay put,
    # but a tighter candidate never hurts shape-waste, so the rebuild
    # keeps them only when the program budget allows — the merge pass
    # below is what re-coarsens.
    waste_before = None
    split_from: List[dict] = []
    if current:
        table = BucketTable(list(current), devices=1)
        num, errs = 0.0, 0
        per_bucket: Dict[Tuple[int, int, int], List[float]] = {}
        for (m, n), cnt in sorted(counts.items()):
            try:
                s = table.spec_for(m, n)
            except ValueError:
                errs += cnt
                continue
            w = _shape_waste(m, n, (s.m, s.n))
            num += w * cnt
            agg = per_bucket.setdefault(s.key(), [0.0, 0])
            agg[0] += w * cnt
            agg[1] += cnt
        waste_before = num / max(total - errs, 1)
        for bkey, (wsum, csum) in sorted(per_bucket.items()):
            w_mean = wsum / max(csum, 1)
            if w_mean > cfg.waste_threshold:
                split_from.append(
                    {"bucket": list(bkey), "mean_shape_waste": round(w_mean, 4)}
                )

    # -- 3: merge cold candidates, then enforce the program cap ---------
    def merge_into(src: Tuple[int, int], dst: Tuple[int, int]) -> None:
        cover = _cover(src, dst)
        members = groups.pop(src) + groups.pop(dst, [])
        existing = groups.get(cover)
        if existing is not None and cover not in (src, dst):
            members = members + existing
        groups[cover] = members

    def group_count(g: Tuple[int, int]) -> int:
        return sum(cnt for _, _, cnt in groups[g])

    def cheapest_merge(g: Tuple[int, int]) -> Tuple[int, int]:
        """The partner whose cover costs the fewest added padded cells."""
        best, best_cost = None, None
        for other in groups:
            if other == g:
                continue
            cover = _cover(g, other)
            cost = (
                cover[0] * cover[1] * (group_count(g) + group_count(other))
                - g[0] * g[1] * group_count(g)
                - other[0] * other[1] * group_count(other)
            )
            # Deterministic tie-break on the shape key.
            if best_cost is None or (cost, cover) < (best_cost, best):
                best, best_cost = cover, cost
                best_partner = other
        return best_partner

    merged: List[dict] = []
    changed = True
    while changed and len(groups) > 1:
        changed = False
        for g in sorted(groups, key=lambda g: (group_count(g), g)):
            if group_count(g) < cfg.min_share * total and len(groups) > 1:
                partner = cheapest_merge(g)
                merged.append(
                    {"cold": list(g), "into": list(_cover(g, partner))}
                )
                merge_into(g, partner)
                changed = True
                break
    while len(groups) > max(1, cfg.max_programs):
        # Merge the pair that adds the least padding — scan the smallest
        # groups first; one merge per pass keeps the loop simple and the
        # candidate count is tiny (bounded by distinct quantized shapes).
        g = min(groups, key=lambda g: (group_count(g), g))
        partner = cheapest_merge(g)
        merged.append({"cap": list(g), "into": list(_cover(g, partner))})
        merge_into(g, partner)

    # -- 4: serving constraints -----------------------------------------
    devices = max(1, cfg.devices)
    batch = cfg.batch if cfg.batch else (current[0].batch if current else 16)
    batch = -(-batch // devices) * devices
    specs = [
        BucketSpec(m=mn[0], n=mn[1], batch=batch) for mn in sorted(groups)
    ]
    check = BucketTable(specs, devices=devices)
    for (m, n) in counts:
        check.spec_for(m, n)  # raises if refinement broke coverage

    num = sum(
        _shape_waste(m, n, spec_mn) * cnt
        for spec_mn, members in groups.items()
        for m, n, cnt in members
    )
    report = {
        "requests": total,
        "distinct_shapes": len(counts),
        "programs_before": len(current) if current else None,
        "programs_after": len(specs),
        "mean_shape_waste_before": (
            round(waste_before, 4) if waste_before is not None else None
        ),
        "mean_shape_waste_after": round(num / total, 4),
        "split_buckets": split_from,
        "merges": merged,
        "batch": batch,
        "devices": devices,
        "ladder": [list(s.key()) for s in specs],
    }
    return specs, report


def autotune_from_jsonl(
    path: str,
    current: Optional[Sequence[BucketSpec]] = None,
    config: Optional[AutotuneConfig] = None,
) -> Tuple[List[BucketSpec], dict]:
    """Offline entry point: refine a ladder from a service telemetry
    file (the ``log_jsonl`` stream a previous serving run wrote)."""
    return autotune_ladder(load_request_shapes(path), current, config)


def ladder_to_json(specs: Sequence[BucketSpec]) -> str:
    return json.dumps([{"m": s.m, "n": s.n, "batch": s.batch} for s in specs])


def ladder_from_json(text: str) -> List[BucketSpec]:
    """Parse a ladder file: a JSON list of {"m","n","batch"} objects (the
    autotune output) or [m, n, batch] triples."""
    raw = json.loads(text)
    specs = []
    for item in raw:
        if isinstance(item, dict):
            specs.append(
                BucketSpec(int(item["m"]), int(item["n"]), int(item["batch"]))
            )
        else:
            m, n, b = item
            specs.append(BucketSpec(int(m), int(n), int(b)))
    return specs
