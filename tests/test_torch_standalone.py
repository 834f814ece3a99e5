"""The port stands alone: a copy of ``bonsai_tpu_torch/`` without the rest
of the repository imports every module, builds its host C++ library from
its own ``native/src/`` and parses FASTA as the in-repo port does.

The copy runs in a subprocess in which ``jax`` and ``bonsai_tpu`` cannot
be imported, with the copy's parent as its only path into the repository.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from bonsai_tpu_torch import native
from bonsai_tpu_torch.core.alphabet import DNA4
from bonsai_tpu_torch.io import fastx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHIX = os.path.join(ROOT, "tests", "data", "phix.fa")

_CHILD = """
import sys
sys.modules["jax"] = None
sys.modules["bonsai_tpu"] = None
import hashlib, importlib, json, os, pkgutil
import bonsai_tpu_torch
from bonsai_tpu_torch import native
names = [m.name for m in pkgutil.walk_packages(bonsai_tpu_torch.__path__,
                                                "bonsai_tpu_torch.")
         if not m.name.endswith("__main__")]
for n in names:
    importlib.import_module(n)
lib = native.get_lib()
from bonsai_tpu_torch.core.alphabet import DNA4
from bonsai_tpu_torch.io import fastx
h = hashlib.sha256()
for b in fastx.batch_reads(sys.argv[1], DNA4.lut, batch_size=7):
    h.update(b"".join(b.names) + b"".join(b.seqs))
    h.update(b.codes.tobytes() + b.lengths.tobytes())
from bonsai_tpu_torch import api
_FORMATS_SRC
seq = b"ACGTTGCAAGGCTTAACGNNACGTACGGATCCATGCAAGT" * 3
kmers = api.get_kmers(seq, k=13, w=29, scheme="entropy", device="cpu")
hashes = api.rolling_hashes(seq, 21, True, device="cpu")
_SHARDED_SRC
print(json.dumps({
    "api": [kmers.tolist(), hashes.tolist()],
    "sharded": _sharded(),
    "formats": _formats(sys.argv[2]),
    "package": os.path.dirname(bonsai_tpu_torch.__file__),
    "modules": names,
    "src_dir": native.SRC_DIR,
    "lib_path": native.LIB_PATH,
    "lib_exists": os.path.exists(native.LIB_PATH),
    "loaded": [n for n in sys.modules if n.startswith(("jax", "bonsai_tpu."))
               and sys.modules[n] is not None],
    "phix": h.hexdigest(),
}))
"""

# the formats of the port in a directory: a sharded directory and a khash
# image of a small table, and 128-bit k-mers; the sha256 of what they
# write and pack
_FORMATS = """
def _formats(out):
    import numpy as np, torch
    from bonsai_tpu_torch.core import encode128
    from bonsai_tpu_torch.db import formats, table
    keys = np.arange(1, 4001, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    keys = np.unique(keys)
    db = formats.Database(table=table.KmerTable(keys, (keys % np.uint64(7))
                                                .astype(np.uint32)),
                          k=31, w=31, gaps=[0] * 30)
    formats.save_database_sharded(db, os.path.join(out, "sh"), 3,
                                  device="cpu")
    formats.write_bonsai_database(db, os.path.join(out, "kh.db"))
    h = hashlib.sha256()
    for f in sorted(os.listdir(os.path.join(out, "sh"))) + ["../kh.db"]:
        h.update(open(os.path.join(out, "sh", f), "rb").read())
    codes = torch.arange(300, dtype=torch.int8).remainder(4)[None, :]
    for t in encode128.pack_kmers128(codes, 50, canon=True):
        h.update(t.numpy().tobytes())
    return h.hexdigest()
"""
# the sharded classifier over in-process ranks on the CPU, both routes,
# and the sharded build: the taxa it gives and the digest of the table
_SHARDED = """
def _sharded():
    import numpy as np
    from bonsai_tpu_torch.db import build_device, formats, table
    from bonsai_tpu_torch.parallel.mesh import make_mesh
    from bonsai_tpu_torch.parallel.sharded import ShardedClassifier
    from bonsai_tpu_torch.taxonomy.tree import TaxTree
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 3000).astype(np.int8)
    reads = np.stack([genome[s:s + 90] for s in range(0, 2880, 90)])
    keys = np.unique(np.array([int("".join("%d" % c for c in genome[i:i + 21]),
                                   4) for i in range(0, 2980, 3)], np.uint64))
    tree = TaxTree({1: 0, 2: 1, 11: 2, 12: 2})
    db = formats.Database(table=table.KmerTable(
        keys, np.where(keys % np.uint64(2) == 0, 11, 12).astype(np.uint32)),
        k=21, w=21, gaps=[0] * 20, canonicalize=False)
    out = []
    for route in ("a2a", "psum"):
        sc = ShardedClassifier(db, tree, make_mesh({"dp": 2, "db": 2}, ["cpu"]),
                               canonicalize=False, route=route)
        out.append(sc.step(reads, np.full(32, 90, np.int32))[0].tolist())
    return out
"""
_CHILD = _CHILD.replace("_FORMATS_SRC", _FORMATS).replace("_SHARDED_SRC",
                                                          _SHARDED)


def _digest(path):
    h = hashlib.sha256()
    for b in fastx.batch_reads(path, DNA4.lut, batch_size=7):
        h.update(b"".join(b.names) + b"".join(b.seqs))
        h.update(b.codes.tobytes() + b.lengths.tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def copy_run(tmp_path_factory):
    """The package copied alone into a temporary directory, and what the
    child process reports from that copy."""
    top = tmp_path_factory.mktemp("standalone")
    pkg = top / "bonsai_tpu_torch"
    shutil.copytree(os.path.join(ROOT, "bonsai_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = top / "formats"
    out.mkdir()
    proc = subprocess.run([sys.executable, "-c", _CHILD, PHIX, str(out)],
                          cwd=top,
                          env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    return str(top), json.loads(proc.stdout.strip().splitlines()[-1])


def test_copy_imports_every_module_without_jax(copy_run):
    top, rep = copy_run
    assert rep["package"] == os.path.join(top, "bonsai_tpu_torch")
    assert rep["loaded"] == []
    assert {"bonsai_tpu_torch.native", "bonsai_tpu_torch.kernels",
            "bonsai_tpu_torch.db.build_device", "bonsai_tpu_torch.api",
            "bonsai_tpu_torch.core.rolling", "bonsai_tpu_torch.db.formats",
            "bonsai_tpu_torch.db.diskarray",
            "bonsai_tpu_torch.core.encode128",
            "bonsai_tpu_torch.parallel.mesh", "bonsai_tpu_torch.parallel.route",
            "bonsai_tpu_torch.parallel.sharded",
            "bonsai_tpu_torch.tools.dist_smoke"} <= set(rep["modules"])


def test_copy_runs_the_sharded_classifier_without_jax(copy_run):
    """Both routes over in-process ranks on the CPU in the copy give what
    they give in the repository, and classify the reads cut from the
    database's genome."""
    _, rep = copy_run
    ns = {}
    exec(_SHARDED, ns)
    assert rep["sharded"] == ns["_sharded"]()
    assert rep["sharded"][0] == rep["sharded"][1]
    assert all(t in (2, 11, 12) for t in rep["sharded"][0])


def test_copy_writes_the_formats_without_jax(copy_run, tmp_path):
    """The copy's sharded directory, khash image and 128-bit k-mers are
    the repository port's, byte for byte."""
    _, rep = copy_run
    ns = {}
    exec("import hashlib, os\n" + _FORMATS, ns)
    assert rep["formats"] == ns["_formats"](str(tmp_path))


def test_copy_runs_the_api_without_jax(copy_run):
    """get_kmers (the scheme entropy) and rolling_hashes in the copy, on
    the CPU, give what they give in the repository."""
    from bonsai_tpu_torch import api

    _, rep = copy_run
    seq = b"ACGTTGCAAGGCTTAACGNNACGTACGGATCCATGCAAGT" * 3
    assert rep["api"][0] == api.get_kmers(seq, k=13, w=29, scheme="entropy",
                                          device="cpu").tolist()
    assert rep["api"][1] == api.rolling_hashes(seq, 21, True,
                                               device="cpu").tolist()
    assert rep["api"][0] and rep["api"][1]


def test_copy_builds_its_host_library_from_its_own_sources(copy_run):
    top, rep = copy_run
    assert rep["src_dir"] == os.path.join(top, "bonsai_tpu_torch", "native",
                                          "src")
    assert rep["lib_path"].startswith(os.path.join(top, "build") + os.sep)
    assert rep["lib_exists"]


def test_copy_parses_fasta_as_the_repo_port(copy_run):
    _, rep = copy_run
    assert rep["phix"] == _digest(PHIX)


def test_host_sources_lie_inside_the_package():
    pkg = os.path.dirname(os.path.abspath(native.__file__))
    assert os.path.commonpath([native.SRC_DIR, pkg]) == pkg
    srcs = sorted(f for f in os.listdir(native.SRC_DIR) if f.endswith(".cpp"))
    assert srcs == ["fastx.cpp", "kmers.cpp", "kraken_out.cpp", "pack.cpp",
                    "sortops.cpp"]
    lib = native.get_lib()
    assert os.path.commonpath([native.LIB_PATH, ROOT]) == ROOT
    assert lib.btpu_sort_dedup_u64 is not None
    keys = np.array([5, 3, 5, 2**64 - 1, 3], dtype=np.uint64)
    n = lib.btpu_sort_dedup_u64(keys.ctypes.data, keys.size)
    assert keys[:n].tolist() == [3, 5, 2**64 - 1]
