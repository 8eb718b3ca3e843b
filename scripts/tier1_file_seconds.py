#!/usr/bin/env python3
"""Per-file seconds of a tier-1 run, and the worker layout they give.

Reads the ``--junitxml`` file of ROADMAP.md's "Tier-1 verify" command
(``/tmp/_t1.xml`` there), sums each test file's test seconds (a module
fixture's set-up lands on its first test), and lays the files out the way
``--dist loadfile`` hands them to the workers: files in collection (name)
order, each worker holding the file it runs and one queued, taking the next
file when one ends.  The junit file records no worker, so the layout is a
simulation from the seconds.

    python scripts/tier1_file_seconds.py /tmp/_t1.xml [--workers 6] [--top 20]
"""

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def file_seconds(path: str) -> collections.Counter:
    seconds: collections.Counter = collections.Counter()
    for case in ET.parse(path).getroot().iter("testcase"):
        module = case.get("classname", "").split(".")
        name = module[1] if module[0] == "tests" and len(module) > 1 else module[0]
        seconds[name + ".py"] += float(case.get("time", 0.0))
    return seconds


def loadfile_layout(seconds: collections.Counter, workers: int) -> list:
    """(busy seconds, files) of each worker."""
    queue = sorted(seconds)
    pending = [[] for _ in range(workers)]
    for _ in range(2):
        for worker in range(workers):
            if queue:
                pending[worker].append(queue.pop(0))
    done = [[0.0, []] for _ in range(workers)]
    events = [(seconds[pending[w][0]], w, pending[w].pop(0)) for w in range(workers) if pending[w]]
    heapq.heapify(events)
    while events:
        end, worker, name = heapq.heappop(events)
        done[worker][0] = end
        done[worker][1].append(name)
        if queue:
            pending[worker].append(queue.pop(0))
        if pending[worker]:
            following = pending[worker].pop(0)
            heapq.heappush(events, (end + seconds[following], worker, following))
    return done


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("junit")
    parser.add_argument("--workers", type=int, default=6)
    parser.add_argument("--top", type=int, default=20)
    args = parser.parse_args()
    seconds = file_seconds(args.junit)
    port = sum(v for k, v in seconds.items() if k.startswith("test_torch_"))
    print(f"{len(seconds)} files, {sum(seconds.values()):.1f} s summed; the port's "
          f"{sum(k.startswith('test_torch_') for k in seconds)} files {port:.1f} s")
    for name, value in seconds.most_common(args.top):
        print(f"{value:8.1f}  {name}")
    for worker, (busy, names) in enumerate(loadfile_layout(seconds, args.workers)):
        longest = sorted(names, key=lambda n: -seconds[n])[:3]
        print(f"gw{worker}: {busy:7.1f} s, {len(names)} files; longest " +
              ", ".join(f"{n[:-3]} {seconds[n]:.0f}" for n in longest))


if __name__ == "__main__":
    main()
