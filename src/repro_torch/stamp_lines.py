"""Prefix each line of standard input with the seconds since this reader
started, flushing each line: a clock on a program that prints as it goes,
such as ``chip_smoke.py``, whether or not it stamps its own lines.

    python3 chip_smoke.py 2>&1 | python3 src/repro_torch/stamp_lines.py
"""
import sys
import time

if __name__ == "__main__":
    t0 = time.time()
    for line in sys.stdin:
        print(f"{time.time() - t0:8.1f} {line}", end="", flush=True)
