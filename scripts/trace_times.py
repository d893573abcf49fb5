"""Time each of ``chip_smoke.py``'s phase i traces alone on a core of this
host: the same commands the check queues, ``N`` at a time, nothing else
running; each trace's wall and CPU seconds and peak resident memory,
printed and written to ``OUT/times.json`` beside the records.  The CPU
seconds order the check's queue (``TRACE_COST_S``).

    python3 scripts/trace_times.py OUT [N [KEY_PREFIX ...]]

With KEY_PREFIXes only the traces whose key (its parts joined by "/", as
the chain line prints it: ``llama3-405b/prefill_32k/single/L2``) starts
with one of them run.

i1 fakes CUDA tensors, so it needs a PyTorch built with CUDA; the others
trace host fake tensors and run anywhere.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def name_of(key) -> str:
    return "/".join(key) if isinstance(key, tuple) else key


def main() -> int:
    out = Path(sys.argv[1]).resolve()
    slots = int(sys.argv[2]) if len(sys.argv) > 2 else os.cpu_count() or 1
    out.mkdir(parents=True, exist_ok=True)
    todo = chip_smoke.phase_i_traces(str(out))
    prefixes = tuple(sys.argv[3:])
    if prefixes:
        todo = [t for t in todo if name_of(t.key).startswith(prefixes)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    running, times = {}, {}
    t0 = time.time()
    while todo or running:
        while todo and len(running) < slots:
            trace = todo.pop(0)
            with open(trace.log_path, "w") as log_file:
                proc = subprocess.Popen(trace.cmd, cwd=ROOT, env=env, stdout=log_file,
                                        stderr=subprocess.STDOUT)
            running[proc.pid] = (trace.key, time.time())
        pid, status, usage = os.wait4(-1, 0)
        key, start = running.pop(pid)
        name = name_of(key)
        times[name] = dict(rc=os.waitstatus_to_exitcode(status), start_s=round(start - t0, 1),
                           wall_s=round(time.time() - start, 1),
                           cpu_s=round(usage.ru_utime + usage.ru_stime, 1),
                           maxrss_gb=round(usage.ru_maxrss / 1e6, 2))
        print(name, times[name], flush=True)
    print(f"{len(times)} traces in {time.time() - t0:.1f} s, {slots} at once, "
          f"{sum(t['cpu_s'] for t in times.values()):.1f} CPU-s; os.cpu_count() {os.cpu_count()}")
    (out / "times.json").write_text(json.dumps(times, indent=1))
    return 1 if any(t["rc"] for t in times.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
