"""The control of a cell's check: the reference put in the program's
place with one guarantee of the configuration broken (each k-mer keeps
the taxon of the first genome that holds it, not the LCA of all of
them), judged by the cell's own comparison at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

prints, a line a seed, the number the cell's check compares, for one
pass (or build) of the control; a sound check reads above its limit
there.  The benchmark's runs never run it.  It runs on the card where
there is one, else on the CPU, and needs no program: only the deployment
and the reference.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload: str, seed: int, root: str = ROOT, bench=None,
             bench_dir=None, device=None) -> dict:
    import numpy as np
    import torch

    from benchmark import deploy, harness, reference, traffic
    from benchmark.kinds import classify

    bench = harness.load_bench(root) if bench is None else bench
    bench_dir = bench_dir or harness.HERE
    cell = {c["name"]: c for c in bench["workloads"]}[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(bench_dir, "traffic",
                           f"{cell['traffic']}.json")) as fh:
        tr = json.load(fh)
    path = os.path.join(root, cfg["file"])
    dep = deploy.load(path, root)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if tr["kind"] == "build":
        k, v = reference.lca_map(dep, dev)
        ck, cv = reference.lca_map(dep, dev, control=True)
        if not np.array_equal(ck, k):
            raise AssertionError("the control's map holds other keys")
        return {"kmers_differ": reference.map_differ(v, cv, ck.size)}
    pool = traffic.make_pool(tr, dep, seed, root)
    judged = classify.judged_reads(pool, tr, seed)
    ref = reference.kraken_lines(dep, pool, judged, dev)
    ctl = reference.kraken_lines(dep, pool, judged, dev, control=True)
    return {"lines_differ": sum(ref[n] != ctl[n] for n in ref),
            "judged": len(ref)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    for s in args.seeds.split(","):
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "control": readings(args.workload, int(s))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
