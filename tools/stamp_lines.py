"""Run a command and print each line of its output (stdout and stderr
merged), prefixed by the seconds since the command started, then its exit
code: where the time of a script that prints no times of its own goes.

    python3 tools/stamp_lines.py -- python3 -u chip_smoke.py

Exits with the command's exit code.
"""

from __future__ import annotations

import subprocess
import sys
import time


def main(argv) -> int:
    if argv[:1] == ["--"]:
        argv = argv[1:]
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for line in proc.stdout:
        print(f"{time.perf_counter() - t0:9.2f} {line}", end="", flush=True)
    rc = proc.wait()
    print(f"{time.perf_counter() - t0:9.2f} exit {rc}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
