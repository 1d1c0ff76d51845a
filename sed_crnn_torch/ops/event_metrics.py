"""Event-based SED metrics (Mesaros et al. 2016) over decoded event lists,
with sed_eval's evaluation semantics.

Counterpart of the JAX package's `ops/event_metrics.py`, the same algorithm
line for line, so that both give identical results:

* a system event is a true positive when a same-class reference event has
  its onset within ``t_collar`` (and, with ``offset_condition``, its offset
  within ``max(t_collar, offset_collar_frac * ref_duration)``);
* ``matching="optimal"`` (default) pairs true positives, and then the
  substitutions (an unmatched reference and an unmatched system event of
  another class meeting the same temporal conditions), by maximum bipartite
  matching: order-independent, never undercounting in crowded collars;
  ``matching="greedy"`` is sed_eval's first-eligible-in-list-order pairing;
* deletions and insertions are what remains; ER = (S + D + I) / N_ref.

Matching is irregular control flow over host tuples: the frame
probabilities stay on the device, and only the decoded events come here.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Event = Tuple[float, float, int]  # (onset_s, offset_s, class_id)


def events_from_roll(roll: np.ndarray, frame_hop_s: float, threshold=0.5) -> List[Event]:
    """Binary/probability frame roll (frames, classes) -> event list of
    ``(start_s, end_s, class)``. ``threshold``: one global float, or a
    per-class vector (n_classes,)."""
    events: List[Event] = []
    active = np.asarray(roll) > np.asarray(threshold)
    for cls in range(active.shape[1]):
        col = active[:, cls].astype(np.int8)
        edges = np.flatnonzero(np.diff(np.concatenate([[0], col, [0]])))
        for s, e in zip(edges[::2], edges[1::2]):
            events.append((s * frame_hop_s, e * frame_hop_s, cls))
    return events


def _temporal_hit(r: Event, s: Event, t_collar: float, offset_condition: bool,
                  offset_collar_frac: float) -> bool:
    """Collar conditions relative to the reference event; the offset collar
    stretches with the reference's duration."""
    if abs(s[0] - r[0]) > t_collar:
        return False
    if offset_condition:
        off_collar = max(t_collar, offset_collar_frac * (r[1] - r[0]))
        if abs(s[1] - r[1]) > off_collar:
            return False
    return True


def _max_bipartite(adj: List[List[int]], n_right: int) -> Tuple[int, List[int]]:
    """Kuhn's augmenting-path maximum matching, breadth-first and iterative
    (a recursive search overflows Python's stack on thousands of
    collar-chained events). ``adj[u]`` lists the right nodes eligible for
    left node ``u``; returns (size, right -> left assignment)."""
    match_r = [-1] * n_right

    def augment(root: int) -> bool:
        parent = {}            # right v -> left u that discovered it
        origin = {root: None}  # left u -> right v through which u was reached
        frontier = [root]
        seen_r = set()
        while frontier:
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if v in seen_r:
                        continue
                    seen_r.add(v)
                    parent[v] = u
                    w = match_r[v]
                    if w == -1:
                        # a free right node: flip the matches back along the path
                        while v is not None:
                            u_ = parent[v]
                            match_r[v] = u_
                            v = origin[u_]
                        return True
                    if w not in origin:
                        origin[w] = v
                        nxt.append(w)
            frontier = nxt
        return False

    size = 0
    for u in range(len(adj)):
        if augment(u):
            size += 1
    return size, match_r


def _greedy_match(adj: List[List[int]], n_right: int) -> Tuple[int, List[int]]:
    """sed_eval's pairing: each left node takes the first still-unmatched
    eligible right node, in list order."""
    match_r = [-1] * n_right
    size = 0
    for u in range(len(adj)):
        for v in adj[u]:
            if match_r[v] == -1:
                match_r[v] = u
                size += 1
                break
    return size, match_r


_MATCHERS = {"optimal": _max_bipartite, "greedy": _greedy_match}


def event_scores(
    ref_events: Sequence[Event],
    sys_events: Sequence[Event],
    t_collar: float = 0.2,
    offset_condition: bool = False,
    offset_collar_frac: float = 0.5,
    matching: str = "optimal",
) -> Dict[str, float]:
    """Event-based F1 and ER with their counts. ``matching``: "optimal"
    (maximum bipartite) or "greedy" (sed_eval's pairing)."""
    if matching not in _MATCHERS:
        raise ValueError(f"matching must be one of {sorted(_MATCHERS)}, got {matching!r}")
    matcher = _MATCHERS[matching]
    ref = list(ref_events)
    sys = list(sys_events)
    n_ref, n_sys = len(ref), len(sys)

    def hit(r: Event, s: Event) -> bool:
        return _temporal_hit(r, s, t_collar, offset_condition, offset_collar_frac)

    adj = [[j for j, s in enumerate(sys) if s[2] == r[2] and hit(r, s)] for r in ref]
    tp, match_r = matcher(adj, n_sys)

    matched_ref = {u for u in match_r if u != -1}
    un_ref = [i for i in range(n_ref) if i not in matched_ref]
    un_sys = [j for j in range(n_sys) if match_r[j] == -1]

    # Substitutions: a matching of the leftover (ref, sys) pairs that meet
    # the temporal conditions but carry different labels.
    sub_adj = [
        [k for k, j in enumerate(un_sys) if sys[j][2] != ref[i][2] and hit(ref[i], sys[j])]
        for i in un_ref
    ]
    subs, _ = matcher(sub_adj, len(un_sys))

    deletions = len(un_ref) - subs
    insertions = len(un_sys) - subs
    return _scores_from_counts(tp, subs, deletions, insertions, n_ref, n_sys)


def _scores_from_counts(
    tp: int, subs: int, deletions: int, insertions: int, n_ref: int, n_sys: int
) -> Dict[str, float]:
    eps = np.finfo(np.float64).eps
    prec = tp / (n_sys + eps)
    rec = tp / (n_ref + eps)
    f1 = 2 * prec * rec / (prec + rec + eps)
    er = (subs + deletions + insertions) / n_ref if n_ref else float("nan")
    return {
        "f1_event": float(f1),
        "er_event": float(er),
        "precision": float(prec),
        "recall": float(rec),
        "tp": tp,
        "substitutions": subs,
        "deletions": deletions,
        "insertions": insertions,
        "n_ref": n_ref,
        "n_sys": n_sys,
    }


def class_wise_event_scores(
    ref_events: Sequence[Event],
    sys_events: Sequence[Event],
    n_classes: int = None,
    **kwargs,
) -> Dict:
    """Per-class event scores: matching within each class, so a class's ER
    has no substitution term. ``n_classes`` fixes the class set (an absent
    class reports n_ref = n_sys = 0); by default the classes present in
    either list."""
    if n_classes is None:
        classes = sorted({e[2] for e in ref_events} | {e[2] for e in sys_events})
    else:
        classes = range(n_classes)
    return {
        c: event_scores([e for e in ref_events if e[2] == c],
                        [e for e in sys_events if e[2] == c], **kwargs)
        for c in classes
    }


def aggregate_event_scores(per_file: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Micro-average across files: sum the counts (no match crosses a file
    boundary), then recompute F1/ER from the totals."""
    return _scores_from_counts(
        sum(s["tp"] for s in per_file),
        sum(s["substitutions"] for s in per_file),
        sum(s["deletions"] for s in per_file),
        sum(s["insertions"] for s in per_file),
        sum(s["n_ref"] for s in per_file),
        sum(s["n_sys"] for s in per_file),
    )


def event_scores_from_rolls(
    pred_roll: np.ndarray,
    ref_roll: np.ndarray,
    frame_hop_s: float,
    threshold: float = 0.5,
    **kwargs,
) -> Dict[str, float]:
    """Frame rolls (frames, classes) -> event-based scores."""
    return event_scores(
        events_from_roll(ref_roll, frame_hop_s, 0.5),
        events_from_roll(pred_roll, frame_hop_s, threshold),
        **kwargs,
    )
