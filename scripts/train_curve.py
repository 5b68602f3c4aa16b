"""Hold a training run's curve against reference runs' curves, by epoch.

    python scripts/train_curve.py RUN/metrics.jsonl \
        --ref log/r4_rb2d_4x_e900/metrics.jsonl \
        --ref log/r5_rb2d_4x_e900/metrics.jsonl --steps_per_epoch 256

Reads the ``metrics.jsonl`` that the train CLIs of either package write
(one record a logged step: ``train/loss`` and ``train/grad_norm`` beside
the other step metrics, ``eval/rel_l2`` in a record of its own at the
same step). A record's epoch is its step / the steps an epoch, counted
from 1; where a run logged a step twice (a cliff recovery restores an
earlier step), the later record counts. The epochs are binned into the
windows ``WINDOWS``, cut at the run's last epoch, and for each window
the script prints the run's median ``eval/rel_l2`` and ``train/loss``
beside each reference's over the same epochs, the run's largest
``train/grad_norm``, and the run's epochs whose loss or gradient norm is
not finite or whose loss is more than ``SPIKE`` times the median of the
epochs before it. It also counts the loss spikes of the run and of each
reference up to the run's last epoch: epochs whose ``train/loss`` is
above ``SPIKE_LOSS``, consecutive ones one event.

The rule: from the second window on, each of the run's two medians lies
within ``[CURVE_LOW x min(refs), CURVE_HIGH x max(refs)]``. The first
window is reported, not held: it depends most on the initialisation. A
non-finite value sorts above every finite one in a median. The script
exits 1 when a held window falls outside, and prints a last line of
JSON, ``{"curve": {...}}``, with every number it printed.

``--keys_only`` checks instead that every epoch of the run has every key
the rule reads (``KEYS``), each finite (a short smoke run's check).

numpy and json only.
"""

import argparse
import json
import math
import os
import sys

import numpy as np

# Epoch windows, first and last epoch, both included.
WINDOWS = ((1, 10), (11, 20), (21, 30), (31, 40), (41, 60), (61, 90),
           (91, 120), (121, 150))
# The band a held window's medians must lie in, against the references'
# medians. Fixed before any run of the port was read.
CURVE_LOW, CURVE_HIGH = 0.8, 1.25
# An epoch whose loss exceeds SPIKE x the median of the epochs before it
# is flagged.
SPIKE = 100.0
KEYS = ("eval/rel_l2", "train/loss", "train/grad_norm")
# A loss spike: an epoch whose train/loss is above SPIKE_LOSS (the turb3d
# runs train at ~0.03-0.06 from epoch 10 on; a spike reads 0.3-100).
SPIKE_LOSS = 0.3


def load_epochs(path, steps_per_epoch):
    """{epoch: {key: value}} of ``KEYS`` from a ``metrics.jsonl``; a later
    record of the same step replaces an earlier one's keys."""
    by_step = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            step = int(rec["step"])
            by_step.setdefault(step, {}).update(
                {k: float(rec[k]) for k in KEYS if k in rec})
    return {-(-step // steps_per_epoch): v
            for step, v in sorted(by_step.items()) if step > 0}


def _median(values):
    """Median with NaN counted as +inf (above every finite value)."""
    if not values:
        return float("nan")
    return float(np.median([v if not math.isnan(v) else math.inf
                            for v in values]))


def flagged(epochs):
    """The epochs whose loss or grad norm is not finite, or whose loss is
    more than SPIKE x the median of the finite losses before it."""
    out, seen = [], []
    for e in sorted(epochs):
        rec = epochs[e]
        loss, gn = rec.get("train/loss"), rec.get("train/grad_norm")
        why = []
        if loss is not None and not math.isfinite(loss):
            why.append(f"loss {loss}")
        elif loss is not None and seen and \
                loss > SPIKE * float(np.median(seen)):
            why.append(f"loss {loss:.6g} = "
                       f"{loss / float(np.median(seen)):.4g} x the median "
                       "before it")
        if gn is not None and not math.isfinite(gn):
            why.append(f"grad_norm {gn}")
        if why:
            out.append({"epoch": e, "why": "; ".join(why)})
        if loss is not None and math.isfinite(loss):
            seen.append(loss)
    return out


def spike_events(epochs, last=None):
    """The loss spikes of ``epochs`` ({epoch: record}) up to ``last``:
    [[first, last epoch]] of each run of consecutive epochs whose loss is
    above SPIKE_LOSS (a non-finite loss counts)."""
    events = []
    for e in sorted(epochs):
        if last is not None and e > last:
            break
        loss = epochs[e].get("train/loss")
        if loss is None or not (math.isnan(loss) or loss > SPIKE_LOSS):
            continue
        if events and events[-1][1] == e - 1:
            events[-1][1] = e
        else:
            events.append([e, e])
    return events


def curve(run, refs):
    """The window table of ``run`` ({epoch: record}) against ``refs``
    ({name: {epoch: record}}), cut at the run's last epoch: a list of
    windows, each with the run's and each reference's medians, the band
    and whether it holds."""
    last = max(run)
    flags = flagged(run)
    rows = []
    for i, (a, b) in enumerate(WINDOWS):
        if a > last:
            break
        b = min(b, last)

        def medians(epochs, key):
            return _median([r[key] for e, r in epochs.items()
                            if a <= e <= b and key in r])

        norms = [r["train/grad_norm"] for e, r in run.items()
                 if a <= e <= b and "train/grad_norm" in r]
        row = {"window": [a, b], "held": i > 0,
               "epochs": sum(1 for e in run if a <= e <= b),
               # NaN where any epoch's norm is NaN (or none was logged).
               "max_grad_norm": (float(np.max(norms)) if norms
                                 else math.nan),
               "flagged": [f for f in flags if a <= f["epoch"] <= b],
               "ok": True}
        for key in ("eval/rel_l2", "train/loss"):
            got = medians(run, key)
            want = {name: medians(ref, key) for name, ref in refs.items()}
            finite = [v for v in want.values() if math.isfinite(v)]
            band = ([CURVE_LOW * min(finite), CURVE_HIGH * max(finite)]
                    if finite else [float("nan")] * 2)
            inside = bool(finite) and band[0] <= got <= band[1]
            row[key] = {"run": got, "refs": want, "band": band,
                        "inside": inside}
            if row["held"] and not inside:
                row["ok"] = False
        rows.append(row)
    return rows


def keys_only(run):
    """The epochs 1..last that miss a key of ``KEYS`` or hold a
    non-finite one: [(epoch, [keys])]."""
    bad = []
    for e in range(1, max(run) + 1):
        rec = run.get(e, {})
        miss = [k for k in KEYS if not (k in rec and math.isfinite(rec[k]))]
        if miss:
            bad.append((e, miss))
    return bad


def _name(path):
    return os.path.basename(os.path.dirname(os.path.abspath(path)))


def main(argv=None):
    """Print the report; returns ``{"curve": {...}}`` with ``ok``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run", help="the run's metrics.jsonl")
    p.add_argument("--ref", action="append", default=[],
                   help="a reference run's metrics.jsonl (repeat)")
    p.add_argument("--steps_per_epoch", type=int, required=True)
    p.add_argument("--keys_only", action="store_true",
                   help="check only that every epoch has every key the "
                        "rule reads, finite")
    args = p.parse_args(argv)

    run = load_epochs(args.run, args.steps_per_epoch)
    if not run:
        raise SystemExit(f"{args.run}: no epoch logged")
    if args.keys_only:
        bad = keys_only(run)
        print(f"curve keys: {len(run)} epochs of {args.run}, every key of "
              f"{list(KEYS)} present and finite: {not bad}"
              + (f"; missing or non-finite: {bad}" if bad else ""))
        out = {"curve": {"keys_only": True, "epochs": len(run),
                         "ok": not bad, "bad": bad}}
        print(json.dumps(out), flush=True)
        return out
    refs = {_name(r): load_epochs(r, args.steps_per_epoch)
            for r in args.ref}
    rows = curve(run, refs)
    print(f"curve of {args.run} ({len(run)} epochs, last {max(run)}) "
          f"against {', '.join(refs)}; band [{CURVE_LOW} x min, "
          f"{CURVE_HIGH} x max] of the references' medians, held from "
          f"epoch {WINDOWS[1][0]} on")
    for row in rows:
        a, b = row["window"]
        cells = []
        for key in ("eval/rel_l2", "train/loss"):
            c = row[key]
            cells.append(
                f"{key} {c['run']:.4f} ("
                + ", ".join(f"{n} {v:.4f}" for n, v in c["refs"].items())
                + f"; band {c['band'][0]:.4f}-{c['band'][1]:.4f}: "
                + ("inside" if c["inside"] else "OUTSIDE") + ")")
        print(f"epochs {a:>3}-{b:<3} ({row['epochs']:>2} run epochs, "
              + ("held" if row["held"] else "not held") + "): "
              + "; ".join(cells)
              + f"; max grad_norm {row['max_grad_norm']:.4g}"
              + "".join(f"; epoch {f['epoch']}: {f['why']}"
                        for f in row["flagged"]))
    last = max(run)
    spikes = {"loss_above": SPIKE_LOSS, "to_epoch": last,
              "run": spike_events(run),
              "refs": {n: spike_events(r, last) for n, r in refs.items()}}
    print(f"loss spikes (epochs with train/loss > {SPIKE_LOSS}, consecutive "
          f"ones one event) to epoch {last}: run {len(spikes['run'])} "
          f"{spikes['run']}"
          + "".join(f"; {n} {len(v)} {v}" for n, v in spikes["refs"].items()))
    ok = all(row["ok"] for row in rows)
    outside = [row["window"] for row in rows if not row["ok"]]
    print(f"curve: every held window inside the band: {ok}"
          + (f"; outside: {outside}" if outside else ""))
    out = {"curve": {"run": args.run, "refs": list(refs),
                     "steps_per_epoch": args.steps_per_epoch,
                     "band": [CURVE_LOW, CURVE_HIGH], "windows": rows,
                     "spikes": spikes, "ok": ok}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["curve"]["ok"] else 1)
