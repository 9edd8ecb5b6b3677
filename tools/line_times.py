"""Run a command and stamp each line of its standard output with the
seconds since the command started.

    python3 tools/line_times.py OUT -- python3 chip_smoke.py

Each line of the command's standard output is written to OUT as
``<seconds> <line>`` (seconds to the millisecond) and echoed unchanged;
standard error passes through. The command runs with
``PYTHONUNBUFFERED=1``, so a Python script's lines arrive as printed.
The last line of OUT is ``<seconds> EXIT <code>``, and the command's exit
code is this script's. It lets two runs of a script that prints as it
goes (an older commit's ``chip_smoke.py``, which does not time its
phases, and a newer one) be set side by side line by line.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time


def main(argv: list) -> int:
    if len(argv) < 3 or argv[1] != '--':
        print(__doc__, file=sys.stderr)
        return 2
    out_path, cmd = argv[0], argv[2:]
    t0 = time.perf_counter()
    with open(out_path, 'w') as out:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, bufsize=1,
                                env={**os.environ, 'PYTHONUNBUFFERED': '1'})
        for line in proc.stdout:
            out.write(f'{time.perf_counter() - t0:.3f} {line}')
            out.flush()
            sys.stdout.write(line)
        rc = proc.wait()
        out.write(f'{time.perf_counter() - t0:.3f} EXIT {rc}\n')
    return rc


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
