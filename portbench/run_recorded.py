"""A traced run of one cell that also reads the program's own record.

    python3 portbench/run_recorded.py --workload <cell> --seed <n> \\
        --seconds <s>

is `run.py --trace 1` with the windows of benchlib/recorded.py (window 4
between two recorder-off windows, then window 5) after the three of
`serve._traced`, which run as they do there.  Its last line is
run.py's, whose metrics also hold those of `recorded.METRICS` that list the
cell, and whose breakdown also holds `idle_by_span` (window 5's device-idle
seconds by innermost program span, "-" for none) and `syncs_by_span`
(window 4's `host_syncs` by span) and `ms_a_step` (the host-clock ms a
step of window 1, of the off windows and of window 4).  To standard error
it writes those, what tracing costs when on (window 4 against the off
windows around it), how much slower the host runs after the profiled
windows (the off windows against window 1), and the share of window 5's
idle time that falls inside a program span.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import run as RUN  # noqa: E402


class RecordCtx:
    """What a reader of `recorded.METRICS` reads: the cell's kind and the
    windows' `Recorded`."""

    def __init__(self, kind, recorded):
        self.kind, self.recorded = kind, recorded


def per_layer(cell, out, base=RUN.per_layer):
    """run.per_layer (`base`), then the readers of `recorded.METRICS` that
    list the cell, and the breakdown's two record keys."""
    from benchlib import recorded, spec

    rec = out.pop("recorded")
    base(cell, out)
    ctx = RecordCtx(cell.traffic["kind"], rec)
    for m in recorded.METRICS:
        if cell.name in m["workloads"]:
            v = spec.reader(m["name"], cell.root)(ctx)
            if v is not None:
                out["metrics"][m["name"]] = {"value": float(v),
                                             "unit": m["unit"]}
    out["breakdown"].update(rec.breakdown())
    idle = rec.idle
    inside = (100.0 * (1.0 - idle.outside_s / idle.idle_s) if idle.idle_s
              else float("nan"))
    ms = rec.ms_a_step
    print(f"recorded: ms a step: window 1 {ms['window1']:.4f}, off "
          f"{ms['off']:.4f}, window 4 {ms['window4']:.4f}; tracing on costs "
          f"{rec.tracing_cost_pct():+.2f}% (window 4 against off); the host "
          f"runs {rec.slowdown_pct():+.2f}% after the profiled windows (off "
          f"against window 1); window 5 idle {idle.idle_s:.6f} s of "
          f"{idle.window_s:.6f} s, {inside:.2f}% inside a program span",
          file=sys.stderr)

def main(argv=None):
    RUN._setup_paths()
    from benchlib import recorded, serve

    serve._traced = recorded.traced(serve._traced)
    RUN.per_layer = per_layer
    args = list(sys.argv[1:] if argv is None else argv)
    return RUN.main(args + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
