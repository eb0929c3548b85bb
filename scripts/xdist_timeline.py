"""Where a pytest-xdist run's wall time goes: which worker ran which tests
when, and a replay of ``--dist load``'s schedule.

As a pytest plugin it appends one JSON line per test phase (worker, test
id, phase, seconds, end time) to ``$XDIST_TIMELINE`` (default
``xdist_timeline.jsonl``):

    PYTHONPATH=scripts python -m pytest tests/ -p xdist_timeline -n 6 \
        --dist load ...

Then

    python scripts/xdist_timeline.py LOG.jsonl [--order IDS.txt]

prints, per worker, the files it ran with their start and end seconds;
with ``--order`` (the ids of ``pytest --collect-only -q``, one a line, in
collection order) it also replays xdist's ``LoadScheduling`` with the
logged seconds of each test: the first chunk of ``N // workers // 4``
consecutive tests to each worker, later ones as workers run low, never
moved once sent; ``--extra K`` replays it with K tests of 0.5 s added
after the port's test files (as a PR that adds tests would).
"""
from __future__ import annotations

import argparse
import collections
import heapq
import json
import os
import time


def pytest_runtest_logreport(report):
    worker = os.environ.get("PYTEST_XDIST_WORKER")
    if worker is None:  # the controller sees every worker's reports again
        return
    with open(os.environ.get("XDIST_TIMELINE", "xdist_timeline.jsonl"),
              "a") as f:
        f.write(json.dumps({"w": worker, "id": report.nodeid,
                            "when": report.when, "d": report.duration,
                            "t": time.time()}) + "\n")


def load(path: str):
    """(rows, t0): the log's rows and the earliest start."""
    rows = [json.loads(line) for line in open(path)]
    return rows, min(r["t"] - r["d"] for r in rows)


def timeline(rows, t0) -> None:
    spans = collections.defaultdict(lambda: [1e18, 0.0, 0.0])
    for r in rows:
        f = r["id"].split("::")[0].replace("tests/", "")
        s = spans[(r["w"], f)]
        s[0] = min(s[0], r["t"] - r["d"] - t0)
        s[1] = max(s[1], r["t"] - t0)
        s[2] += r["d"]
    by_worker = collections.defaultdict(list)
    for (w, f), (a, b, d) in spans.items():
        by_worker[w].append((a, b, d, f))
    for w in sorted(by_worker):
        parts = sorted(by_worker[w])
        print(f"{w} ends {parts[-1][1]:.0f} s: " + " | ".join(
            f"{f} {a:.0f}-{b:.0f} ({d:.0f})" for a, b, d, f in parts))


def replay(order, seconds, workers: int = 6):
    """Each worker's end under LoadScheduling with ``seconds[test]``."""
    pending = list(range(len(order)))
    queue = {n: [] for n in range(workers)}
    chunk = max(len(order) // workers // 4, 2)
    for n in range(workers):
        queue[n], pending = pending[:chunk], pending[chunk:]
    events = [(seconds(order[queue[n][0]]), n) for n in range(workers)
              if queue[n]]
    heapq.heapify(events)
    end = dict.fromkeys(range(workers), 0.0)
    while events:
        now, n = heapq.heappop(events)
        done = queue[n].pop(0)
        end[n] = now
        if pending:
            low = max(2, len(pending) // workers // 4)
            high = max(2, len(pending) // workers // 2)
            busy = seconds(order[done]) >= 0.1 and len(queue[n]) >= 2
            if len(queue[n]) < low and not busy:
                k = high - len(queue[n])
                queue[n] += pending[:k]
                pending = pending[k:]
        if queue[n]:
            heapq.heappush(events, (now + seconds(order[queue[n][0]]), n))
    return end


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log")
    ap.add_argument("--order")
    ap.add_argument("--extra", type=int, default=0)
    args = ap.parse_args(argv)
    rows, t0 = load(args.log)
    timeline(rows, t0)
    if args.order:
        secs = collections.defaultdict(float)
        for r in rows:
            secs[r["id"]] += r["d"]
        order = [line.strip() for line in open(args.order) if "::" in line]
        last = max(i for i, o in enumerate(order) if "test_torch_port_" in o)
        order = (order[:last] + [f"extra::{i}" for i in range(args.extra)]
                 + order[last:])
        end = replay(order, lambda t: secs.get(t, 0.5))
        print(f"replay of N = {len(order)}: workers end at "
              + ", ".join(f"{e:.0f}" for e in sorted(end.values())) + " s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
