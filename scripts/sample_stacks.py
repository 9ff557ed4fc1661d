#!/usr/bin/env python3
"""Where a script's host time goes: runs it as ``__main__`` while a thread
samples the main thread's stack.

    python3 scripts/sample_stacks.py OUT.json SCRIPT [ARGS...]

Every PERIOD seconds the sampler reads the main thread's frames and
counts, for the functions defined in SCRIPT: each function on the stack
(``incl``: its inclusive time), the innermost one with its line
(``own``), and that line with the frame it was waiting in (``leaf``: a
subprocess's ``select``, a CUDA synchronisation, the profiler's parser).
OUT.json holds the 150 largest of each, in samples; times are samples x
PERIOD. The overhead is one stack walk a period.
Used on ``chip_smoke.py`` to find the host time its phases spend outside
the card.
"""
import argparse
import collections
import json
import os
import runpy
import sys
import threading
import time

PERIOD = 0.2


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out", help="the JSON file written at the script's end")
    p.add_argument("script", help="the script, run as __main__")
    p.add_argument("args", nargs=argparse.REMAINDER)
    args = p.parse_args()

    sys.argv = [args.script, *args.args]
    main_thread = threading.get_ident()
    name = os.path.basename(args.script)
    incl, own, leaf = (collections.Counter() for _ in range(3))
    done = threading.Event()

    def sample():
        while not done.wait(PERIOD):
            frame = sys._current_frames().get(main_thread)
            if frame is None:
                continue
            waiting = (f"{os.path.basename(frame.f_code.co_filename)}:"
                       f"{frame.f_code.co_name}")
            names, inner = set(), None
            while frame is not None:
                if os.path.basename(frame.f_code.co_filename) == name:
                    names.add(frame.f_code.co_name)
                    if inner is None:
                        inner = f"{frame.f_code.co_name}:{frame.f_lineno}"
                frame = frame.f_back
            incl.update(names)
            if inner:
                own[inner] += 1
                leaf[f"{inner} <- {waiting}"] += 1

    threading.Thread(target=sample, daemon=True).start()
    start = time.perf_counter()
    try:
        runpy.run_path(args.script, run_name="__main__")
    finally:
        done.set()
        with open(args.out, "w") as f:
            json.dump({"period": PERIOD,
                       "seconds": time.perf_counter() - start,
                       "incl": incl.most_common(150),
                       "own": own.most_common(150),
                       "leaf": leaf.most_common(150)}, f, indent=0)


if __name__ == "__main__":
    main()
