"""Seconds of test time per test file, summed from pytest's junit XML.

    python scripts/junit_file_times.py PARENT.xml [CHANGE.xml] [--match S]

Each testcase's ``time`` (its setup, call and teardown, so a module
fixture's build lands on the test that first needs it in each xdist worker)
is added to its file's total. With two files, the two columns and their
difference; ``--match`` keeps the files whose name holds S (default
``test_torch_port_``, the port's CPU tests). The last line is the sum over
the files shown.
"""
from __future__ import annotations

import argparse
import collections
import xml.etree.ElementTree as ET


def file_times(path: str) -> dict:
    """{test file: [seconds, number of testcases]} of one junit XML."""
    out = collections.defaultdict(lambda: [0.0, 0])
    for case in ET.parse(path).getroot().iter("testcase"):
        name = case.get("classname", "").split(".")
        # "tests.test_x" or "tests.test_x.TestClass": the file is the first
        # component that starts with "test_"
        mod = next((p for p in name if p.startswith("test_")), ".".join(name))
        entry = out[mod + ".py"]
        entry[0] += float(case.get("time", 0.0))
        entry[1] += 1
    return dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("xml", nargs="+", help="one or two junit XML files")
    ap.add_argument("--match", default="test_torch_port_")
    args = ap.parse_args(argv)
    runs = [file_times(p) for p in args.xml[:2]]
    names = sorted({n for r in runs for n in r if args.match in n})
    totals = [0.0] * len(runs)
    for n in names:
        cols = []
        for i, r in enumerate(runs):
            secs, count = r.get(n, (0.0, 0))
            totals[i] += secs
            cols.append(f"{secs:9.1f} s {count:4d}")
        diff = (f" {runs[1].get(n, (0.0,))[0] - runs[0].get(n, (0.0,))[0]:+9.1f} s"
                if len(runs) == 2 else "")
        print(f"{n:44s} " + "  ".join(cols) + diff)
    diff = f" {totals[1] - totals[0]:+9.1f} s" if len(runs) == 2 else ""
    print(f"{'sum':44s} " + "  ".join(f"{t:9.1f} s     " for t in totals)
          + diff)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
