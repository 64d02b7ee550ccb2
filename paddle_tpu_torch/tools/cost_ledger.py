"""Device-cost ledger CLI (counterpart ``tools/cost_ledger.py``): capture
one ledger record (``Executor.cost_record``) for each program of a small
probe fleet, print where the FLOPs and bytes go by Fluid op, and diff
the records against the checked-in baseline
(``paddle_tpu_torch/tools/cost_baseline.json``) with ratio budgets.

Usage::

    python -m paddle_tpu_torch.tools.cost_ledger            # table
    python -m paddle_tpu_torch.tools.cost_ledger --check    # exit 1 on a
                                                            # regression
    python -m paddle_tpu_torch.tools.cost_ledger --update   # rewrite the
                                                            # baseline
    python -m paddle_tpu_torch.tools.cost_ledger --json
    python -m paddle_tpu_torch.tools.cost_ledger --only mlp_k1 --check

A record regresses when an extensive figure (``flops``,
``bytes_accessed``, ``peak_bytes``, ``temp_bytes``, ``aten_calls``,
``hand_kernel_calls``) exceeds ``ratio`` times its baseline, when the
step adds a collective, or when a collective's wire bytes move by more
than 1%.  A regression names the probe and the Fluid ops whose
attribution moved.  Refresh the baseline with ``--update`` when a cost
change is intended, and say why in the commit message.

The probes run on the CPU, as the JAX ledger's do: the counts of a step
(FLOPs, bytes, aten calls) are the same on the card and deterministic,
and the baseline is the CPU's (its ``temp_bytes`` and ``peak_bytes`` are
null: the CPU has no allocator peak).  ``Executor.cost_record`` takes
the same records of a program on the card, peak included.  ``dp_allreduce`` is the
``GradAllReduce`` program in a world of one, where the all-reduce is the
identity; the ledger counts the bytes it would put on the wire per rank
(twice its payload), as the JAX ledger counts them at trace time.
"""

import argparse
import json
import os
import sys

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "cost_baseline.json")

# extensive fields under the ratio budget; collectives match exactly
RATIO_FIELDS = ("flops", "bytes_accessed", "peak_bytes", "temp_bytes",
                "aten_calls", "hand_kernel_calls")
# the dp probe's wire precision, from the environment as a FLAGS_* knob
# reaches a job
PRECISION_ENV = "FLAGS_allreduce_precision"


# ---------------------------------------------------------------------------
# The probe fleet (the JAX ledger's programs), keyed by name
# ---------------------------------------------------------------------------

def _probe_mlp(k=None):
    import numpy as np
    import paddle_tpu_torch.fluid as fluid

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[64], dtype="float32")
        h = fluid.layers.fc(x, size=64, act="gelu")
        out = fluid.layers.fc(h, size=32, act="tanh")
        loss = fluid.layers.mean(out)
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    feed = {"x": np.zeros((16, 64), np.float32)}
    if k:
        feed = {n: np.stack([v] * k) for n, v in feed.items()}
    return main, startup, feed, loss, k


def _probe_dp_allreduce():
    import numpy as np
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.transpiler import GradAllReduce

    precision = os.environ.get(PRECISION_ENV, "fp32")
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[64], dtype="float32")
        y = fluid.layers.data(name="y", shape=[64], dtype="float32")
        pred = fluid.layers.fc(x, size=64)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    GradAllReduce(allreduce_precision=precision).transpile(
        startup_program=startup, main_program=main, rank=0,
        endpoints=[], nranks=0)
    feed = {"x": np.zeros((16, 64), np.float32),
            "y": np.zeros((16, 64), np.float32)}
    return main, startup, feed, loss, None


def _probe_infer(batch=8):
    import numpy as np
    import paddle_tpu_torch.fluid as fluid

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[32], dtype="float32")
        h = fluid.layers.fc(x, size=64, act="relu")
        out = fluid.layers.fc(h, size=8, act="softmax")
    feed = {"x": np.zeros((batch, 32), np.float32)}
    return main, startup, feed, out, None


PROBES = {
    "mlp_k1": lambda: _probe_mlp(),             # one training step
    "mlp_k16": lambda: _probe_mlp(16),          # a window of 16 of them
    "dp_allreduce": _probe_dp_allreduce,        # GradAllReduce's step
    "infer_b8": _probe_infer,                   # a serving bucket
}


def collect(names=None, stamp=False):
    """``{probe name: ledger record}`` of the probe fleet on the CPU; each
    record carries ``top_ops``."""
    import paddle_tpu_torch.fluid as fluid

    records = {}
    for name in sorted(names or PROBES):
        main, startup, feed, fetch, k = PROBES[name]()
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        rec = exe.cost_record(main, feed=feed, fetch_list=[fetch],
                              scope=scope, steps_per_run=k, tag=name,
                              stamp=stamp)
        if rec is None:
            raise RuntimeError("FLAGS_cost_ledger=0: the ledger tool "
                               "needs the ledger on")
        records[name] = rec
    return records


# ---------------------------------------------------------------------------
# Baseline and diff
# ---------------------------------------------------------------------------

def load_baseline(path):
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def save_baseline(path, records):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(records, f, indent=1, sort_keys=True)
        f.write("\n")


def _op_deltas(cur_rec, base_rec):
    """The Fluid ops whose attribution moved, current against baseline:
    the "responsible ops" named beside a regression."""
    cur = {t["op"]: t for t in cur_rec.get("top_ops", [])}
    base = {t["op"]: t for t in base_rec.get("top_ops", [])}
    zero = {"flops_est": 0, "bytes": 0, "aten_calls": 0}
    deltas = []
    for op in set(cur) | set(base):
        c, b = cur.get(op, zero), base.get(op, zero)
        df = c["flops_est"] - b["flops_est"]
        db = c["bytes"] - b["bytes"]
        da = c["aten_calls"] - b["aten_calls"]
        if df or db or da:
            deltas.append((abs(df) + abs(db), op, df, db, da))
    deltas.sort(reverse=True)
    return ["%s (flops %+d, bytes %+d, aten calls %+d)"
            % (op, df, db, da) for _w, op, df, db, da in deltas[:4]]


def diff(current, baseline, ratio=1.25):
    """``(regressions, notes)`` of the current records against the
    baseline.  Regressions: an extensive field above ``ratio`` times its
    baseline, an added collective, or wire bytes off by more than 1%.
    Notes: improvements, new probes, probes that vanished."""
    regressions, notes = [], []
    for name in sorted(current):
        cur = current[name]
        base = baseline.get(name)
        if base is None:
            notes.append("NEW        %-14s no baseline entry (run "
                         "--update to adopt)" % name)
            continue
        culprits = None

        def responsible():
            return ("; responsible ops: " + "; ".join(culprits)) \
                if culprits else ""

        for f in RATIO_FIELDS:
            c, b = cur.get(f), base.get(f)
            if c is None or b is None:
                continue
            c, b = float(c), float(b)
            if b and c > ratio * b:
                if culprits is None:
                    culprits = _op_deltas(cur, base)
                regressions.append(
                    "REGRESSION %-14s %s %.4g > budget %.4g "
                    "(baseline %.4g, x%.2f)%s"
                    % (name, f, c, ratio * b, b, c / b, responsible()))
            elif b and c < b / ratio:
                notes.append("improved   %-14s %s %.4g (baseline %.4g)"
                             % (name, f, c, b))
        c_coll = cur.get("collectives") or {}
        b_coll = base.get("collectives") or {}
        for species in sorted(set(c_coll) | set(b_coll)):
            cn, bn = int(c_coll.get(species, 0)), int(b_coll.get(species, 0))
            if cn > bn:
                if culprits is None:
                    culprits = _op_deltas(cur, base)
                regressions.append(
                    "REGRESSION %-14s adds collective %s (%d -> %d)%s"
                    % (name, species, bn, cn, responsible()))
            elif cn < bn:
                notes.append("improved   %-14s drops collective %s "
                             "(%d -> %d)" % (name, species, bn, cn))
        cb = cur.get("collective_bytes") or {}
        bb = base.get("collective_bytes") or {}
        for key in sorted(set(cb) | set(bb)):
            cv, bv = int(cb.get(key, 0)), int(bb.get(key, 0))
            if (bv and abs(cv - bv) > 0.01 * bv) or (bv == 0 and cv):
                if culprits is None:
                    culprits = _op_deltas(cur, base)
                regressions.append(
                    "REGRESSION %-14s collective wire %s: %d B vs "
                    "baseline %d B%s" % (name, key, cv, bv, responsible()))
    for name in sorted(set(baseline) - set(current)):
        notes.append("MISSING    %-14s baselined probe not collected"
                     % name)
    return regressions, notes


def _num(v, fmt):
    return "-" if v is None else fmt % v


def format_records(records):
    hdr = ("%-14s %3s %12s %12s %12s %6s %4s %12s %12s"
           % ("probe", "k", "flops/step", "bytes/step", "peak_bytes",
              "aten", "kern", "coll_B/step", "est_step_us"))
    lines = [hdr, "-" * len(hdr)]
    for name, r in sorted(records.items()):
        lines.append(
            "%-14s %3d %12.4g %12.4g %12s %6d %4d %12d %12.4f"
            % (name, r["k"], r["flops"], r["bytes_accessed"],
               _num(r["peak_bytes"], "%d"), r["aten_calls"],
               r["hand_kernel_calls"],
               r.get("collective_bytes_per_step", 0),
               r["estimated_step_s"] * 1e6))
        for t in r.get("top_ops", [])[:5]:
            lines.append("    %-28s flops %-12d bytes %-10d (%d aten calls)"
                         % (t["op"], t["flops_est"], t["bytes"],
                            t["aten_calls"]))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="device-cost ledger: per-step cost records, Fluid-op "
                    "attribution, baseline diff")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--ratio", type=float, default=1.25,
                    help="regression threshold on the extensive fields "
                         "(default 1.25)")
    ap.add_argument("--check", action="store_true",
                    help="diff against the baseline, exit 1 on any "
                         "regression")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the baseline from this run and exit")
    ap.add_argument("--json", action="store_true",
                    help="print the raw records as JSON")
    ap.add_argument("--only", action="append", default=None,
                    metavar="PROBE",
                    help="restrict to named probe(s): %s"
                         % ", ".join(sorted(PROBES)))
    args = ap.parse_args(argv)
    if args.only:
        unknown = set(args.only) - set(PROBES)
        if unknown:
            print("unknown probe(s): %s" % ", ".join(sorted(unknown)),
                  file=sys.stderr)
            return 2
    records = collect(args.only)
    if args.json:
        print(json.dumps(records, indent=1, sort_keys=True))
        return 0
    if args.update:
        if args.only:
            merged = load_baseline(args.baseline)
            merged.update(records)
            records = merged
        save_baseline(args.baseline, records)
        print("baseline updated: %s (%d probes)"
              % (args.baseline, len(records)))
        return 0
    baseline = load_baseline(args.baseline)
    print(format_records(records))
    regressions, notes = diff(records, baseline, ratio=args.ratio)
    print("\ncost ledger: %d probe(s) vs %d baselined"
          % (len(records), len(baseline)))
    for line in notes:
        print(line)
    if regressions:
        for line in regressions:
            print(line)
        if args.check:
            return 1
    else:
        print("all within budget")
    return 0


if __name__ == "__main__":
    sys.exit(main())
