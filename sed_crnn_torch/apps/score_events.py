"""Score a system's event list against reference annotations: two
delimited event-list files in, event-based F1/ER out. Host only.

Both files use the DCASE / sed_eval interchange rows
(``[filename<TAB>]onset<TAB>offset<TAB>event_label``; the TUT meta form with
a scene column parses too, `data/eventio.py`). When rows carry filenames,
matching is per file and the counts add up across files as sed_eval does
(no match crosses a file); file-less lists score as one stream.

  python -m sed_crnn_torch.apps.score_events --ref meta.txt --est system_output.txt
"""

from __future__ import annotations

import argparse
import json

from sed_crnn_torch.data.eventio import events_by_file, read_event_list
from sed_crnn_torch.ops.event_metrics import aggregate_event_scores, event_scores


def score_event_lists(
    ref_path: str,
    est_path: str,
    t_collar: float = 0.2,
    offset_condition: bool = False,
    offset_collar_frac: float = 0.5,
    matching: str = "optimal",
):
    """-> ``(overall, per_file)``: micro-averaged scores and the per-file
    breakdown (every file in either list; a file without reference events
    still counts its insertions)."""
    ref = events_by_file(read_event_list(ref_path))
    est = events_by_file(read_event_list(est_path))
    if (None in ref) != (None in est) and (ref and est):
        raise ValueError(
            "one list carries filenames and the other does not — matching "
            "would silently cross file boundaries; add the filename column "
            "to both or strip it from both"
        )
    per_file = {}
    for fname in sorted(set(ref) | set(est), key=lambda x: (x is None, x)):
        per_file[fname or ""] = event_scores(
            ref.get(fname, []), est.get(fname, []), t_collar=t_collar,
            offset_condition=offset_condition, offset_collar_frac=offset_collar_frac,
            matching=matching,
        )
    return aggregate_event_scores(list(per_file.values())), per_file


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ref", required=True, help="reference annotations file")
    p.add_argument("--est", required=True, help="system output file")
    p.add_argument("--collar", type=float, default=0.2,
                   help="onset collar in seconds (sed_eval t_collar)")
    p.add_argument("--offset-condition", action="store_true",
                   help="also require offset proximity (max(collar, frac*ref_duration))")
    p.add_argument("--offset-collar-frac", type=float, default=0.5)
    p.add_argument("--matching", choices=("optimal", "greedy"), default="optimal",
                   help="'greedy' mirrors sed_eval's first-eligible pairing exactly; "
                        "'optimal' is maximum bipartite matching")
    p.add_argument("--per-file", action="store_true",
                   help="include the per-file breakdown in the output")
    p.add_argument("--out", help="write the JSON report here (default stdout)")
    args = p.parse_args(argv)

    overall, per_file = score_event_lists(args.ref, args.est, args.collar,
                                          args.offset_condition, args.offset_collar_frac,
                                          args.matching)
    payload = {"overall": overall, "n_files": len(per_file)}
    if args.per_file:
        payload["per_file"] = per_file
    text = json.dumps(payload, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out} (ER {overall['er_event']:.3f}, F1 {overall['f1_event']:.3f})")
    else:
        print(text)


if __name__ == "__main__":
    main()
