"""The sharded classifier across OS processes: ``python -m
bonsai_tpu_torch.tools.dist_smoke`` starts two processes joined by
torch.distributed (``gloo`` on the CPU, its own free port), runs
``classify --db-shards 2 --distributed -o DIR`` over both routes and
from a sharded directory, merges each run's parts with ``merge-parts``
and checks the merged text against the one-process text; each process
also checks the sequence-parallel encode and the sharded fold across
the processes against the unsharded functions, and that a mesh of more
ranks than processes is refused.  The counterpart of
``tests/test_distributed.py``."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_sharded_classify_merges_to_the_one_process_text():
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "bonsai_tpu_torch.tools.dist_smoke",
         "--nproc", "2"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]
    assert "dist_smoke: OK" in r.stdout
    assert r.stdout.count("merged text equals the one-process text") == 3
    assert r.stdout.count("refused:") == 2  # ranks beside processes
    assert r.stdout.count("sp encode and sharded fold equal") == 2
