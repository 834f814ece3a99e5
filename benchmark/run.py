"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the program (``bonsai_tpu_torch``).
The run needs a CUDA card: without one, or with fewer than the cell asks
for, it exits 2 and prints no result.  Its last line on standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last: each
number the check compared beside its limit); the same numbers are the
last lines on standard error.  Build caches (the program's kernels and
host library under ``build/``, a configuration's probe image under
``.benchmark_cache/``) stay inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches() -> None:
    """Keep every kernel cache a library could write inside the checkout,
    at fixed paths."""
    base = os.path.join(ROOT, ".benchmark_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()
    sys.path.insert(0, ROOT)
    if not os.path.isdir(os.path.join(ROOT, "bonsai_tpu_torch")):
        print("error: the checkout holds no bonsai_tpu_torch", file=sys.stderr)
        return 2
    import torch

    from benchmark import harness

    # one intra-op thread: the program's host work is its three pipeline
    # threads, and torch's pool of one thread a core beside them spins on
    # the host's shared cores (some 3x the process's CPU time a pass)
    torch.set_num_threads(1)

    bench = harness.load_bench(ROOT)
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"error: no cell {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    try:
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), device="cuda", root=ROOT,
                          bench=bench, t_start=T_START)
        harness.no_forbidden_modules()
    except harness.ForbiddenModules as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
