"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload flow_k20.day8 --seed 7 \\
        --seconds 40 --trace 0

Run from the root of a checkout; the last line of standard output is
the result's JSON object, and the numbers that decided `correct` are
the last lines of standard error. Without a CUDA card, or where a
cell's files or the program are missing, it prints no result and
exits with another code than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # Run as a script, the harness's own folder heads sys.path; its
    # modules are imported as portbench.*, never by their bare names.
    if sys.path and pathlib.Path(sys.path[0]).resolve() == ROOT / "portbench":
        sys.path.pop(0)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import harness
    for key, val in harness.cache_env(ROOT).items():
        os.environ[key] = val
    try:
        return harness.run(args, T_START)
    except harness.Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    except ImportError as e:
        print(f"portbench: the program cannot be loaded: {e}",
              file=sys.stderr)
        return 4


if __name__ == "__main__":
    sys.exit(main())
