"""The harness: run one cell of ``BENCHMARK.json`` once and make its
result line.

Everything is found by name.  A cell (``workloads`` entry) names a
configuration (``configs/<config>.json``, read by ``deploy.py``) and a
traffic mix (``traffic/<traffic>.json``); the mix's ``kind`` names the
module under ``kinds/`` that sets the cell up, times its window and
checks what the window produced.  Every metric, end to end or per
layer, is a reader of its own, ``metrics/<name>.py``: a function
``read(record)`` that returns the metric's value from the run's
``Record``, or None where it finds nothing to read, and ``MOVES``, the
end-to-end metric it moves (itself, for an end-to-end metric).

A ``Record`` holds what a run measured; a kind fills it and the readers
take from it:

* ``kind``, ``cell``, ``config``, ``traffic``: the names' data;
* ``setup_s``: from the start of the process to the window's start;
* ``window_s``: the window's seconds by the host clock; ``units``: the
  passes over the pool (classify) or the builds (build) it holds;
* ``bases``: the bases a pass classifies; ``kmers``: the distinct
  k-mers a build places;
* ``peak_bytes``: ``torch.cuda.max_memory_allocated()`` of the run;
* ``stage_seconds``: the classifier's ``stage_seconds`` summed over the
  window's passes;
* ``trace``: the traced window (``trace.Trace``), in a ``--trace 1`` run;
* ``pool``, ``k``, ``batch``: the reads of a pass, the seed's k and the
  reads a batch; ``valid_kmers()`` and ``distinct_hit_taxa()`` give, per
  read, its k-mers without an N and the distinct taxa its record lists.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = ".benchmark_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "bonsai_tpu")


def forbidden_modules(names) -> List[str]:
    """The loaded modules whose top-level name is one that no run may load
    (compared whole: ``bonsai_tpu_torch`` is not ``bonsai_tpu``)."""
    return sorted({n.split(".", 1)[0] for n in names}
                  & set(FORBIDDEN))


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Record:
    kind: str
    cell: dict
    config: dict
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0
    bases: int = 0
    kmers: int = 0
    peak_bytes: int = 0
    stage_seconds: Dict[str, float] = field(default_factory=dict)
    trace: object = None
    pool: object = None
    k: int = 0
    batch: int = 0
    attempted: int = 0
    failed: int = 0
    checks: List[Check] = field(default_factory=list)
    text: Optional[List[str]] = None  # the first pass's output
    _memo: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def mbases(self) -> float:
        return self.units * self.bases / 1e6

    def valid_kmers(self) -> np.ndarray:
        if "valid" not in self._memo:
            self._memo["valid"] = self.pool.valid_kmers(self.k)
        return self._memo["valid"]

    def distinct_hit_taxa(self) -> np.ndarray:
        """Per read, the distinct taxa of the hit runs its Kraken record
        lists (0 for a read without a record): the program's text of a
        pass, which the run's check holds to the reference."""
        if "distinct" not in self._memo:
            d = np.zeros(self.pool.n, dtype=np.int64)
            for line in "".join(self.text).splitlines():
                cols = line.split("\t")
                if cols[0] != "C":
                    continue
                runs = {c.split(":", 1)[0] for c in cols[4:]
                        if not c.startswith(("M:", "A:"))}
                d[int(cols[1][1:])] = len(runs)
            self._memo["distinct"] = d
        return self._memo["distinct"]


@dataclass
class Context:
    """What a kind's ``run`` is given."""

    cell: dict
    config_path: str
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    root: str
    cache_dir: str
    t_start: float
    log: Callable[[str], None] = lambda s: print(s, file=sys.stderr)


def load_bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench_dir: str = HERE):
    """The reader module of metric ``name`` (``metrics/<name>.py``)."""
    mod = _module(os.path.join(bench_dir, "metrics", f"{name}.py"),
                  "benchmark_metric_" + re.sub(r"\W", "_", name))
    if not callable(getattr(mod, "read", None)) or not hasattr(mod, "MOVES"):
        raise ValueError(f"metric {name}: its file has no read() or MOVES")
    return mod


def cell_metrics(bench: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``--trace 0``, else the per-layer metrics that list it (or, listing
    no cell, move an end-to-end metric it reports)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]


def device_info(device: str, peak: int, rec: Record, traced: bool) -> dict:
    import torch

    if device.startswith("cuda"):
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": int(peak)}
        try:
            got = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader", "-i", "0"],
                capture_output=True, text=True, timeout=30)
            out["power_limit"] = got.stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            out["power_limit"] = f"not read: {e}"
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": int(peak)}
    if traced and rec.trace is not None:
        out["busy_s"] = rec.trace.busy_s
        out["window_s"] = rec.trace.window_s
    return out


def run(workload: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", root: str = ROOT, bench: Optional[dict] = None,
        bench_dir: str = HERE, cache_root: Optional[str] = None,
        t_start: Optional[float] = None) -> dict:
    """One run of cell ``workload`` -> its result dict (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
    traced, and ``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_bench(root) if bench is None else bench
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise ValueError(f"no cell {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[cell["config"]]
    with open(os.path.join(bench_dir, "traffic",
                           f"{cell['traffic']}.json")) as fh:
        traffic = json.load(fh)
    from . import deploy

    config_path = os.path.join(root, cfg_entry["file"])
    cache_dir = os.path.join(
        cache_root or os.path.join(root, CACHE),
        f"{cell['config']}-{deploy.config_digest(config_path)}")
    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    ctx = Context(cell, config_path, traffic, seed, seconds, traced, device,
                  root, cache_dir, t_start)
    rec: Record = kind.run(ctx)
    metrics = {}
    for m in cell_metrics(bench, workload, traced):
        mod = reader(m["name"], bench_dir)
        if mod.MOVES != m.get("moves", m["name"]):
            raise ValueError(f"metric {m['name']}: its file says it moves "
                             f"{mod.MOVES}, BENCHMARK.json {m.get('moves')}")
        value = mod.read(rec)
        if value is None:
            if not traced:
                raise RuntimeError(f"{workload}: end-to-end metric "
                                   f"{m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {
        "correct": all(c.ok for c in rec.checks),
        "attempted": int(rec.attempted),
        "failed": int(rec.failed),
        "metrics": metrics,
        "device": device_info(device, rec.peak_bytes, rec, traced),
    }
    if traced and rec.trace is not None:
        ops = sorted(rec.trace.device_ops().items(), key=lambda x: -x[1])
        out["breakdown"] = {"device_ops": [list(o) for o in ops[:10]],
                            "idle_gaps": rec.trace.idle_gaps(10)}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in rec.checks}
    return out


# -- shared by the kinds -----------------------------------------------------------

def phases(marks) -> str:
    """"# setup: a 1.234 s, b ..." of [(name, time)] marks."""
    return "# setup: " + ", ".join(
        f"{n} {t - marks[i][1]:.3f} s" for i, (n, t) in enumerate(marks[1:]))


def memfile(data: bytes, name: str):
    """(fd, path) of an in-memory file holding ``data``: the program opens
    the path as it opens any file, and nothing reaches a disk."""
    fd = os.memfd_create(name)
    view = memoryview(data)
    while view:
        view = view[os.write(fd, view):]
    return fd, f"/proc/self/fd/{fd}"


def cuda_peak(device: str) -> int:
    import torch

    return torch.cuda.max_memory_allocated() if device.startswith(
        "cuda") else 0


def reset_peak(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def free(device: str) -> None:
    import gc

    import torch

    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def profiler(device: str):
    """A ``torch.profiler.profile`` of the CPU and, on a card, CUDA, in
    every thread the window starts (the classifier's producer and
    writer)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=acts, experimental_config=cfg)


def no_forbidden_modules() -> None:
    """Raise where the process has loaded JAX or the JAX package."""
    bad = forbidden_modules(list(sys.modules))
    if bad:
        raise ForbiddenModules(bad)


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("loaded modules no run may load: " + ", ".join(names))
        self.names = names
