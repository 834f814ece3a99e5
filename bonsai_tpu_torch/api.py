"""Python API: the reference's pybind11 ``bns`` module, on the card.

Counterpart of ``bonsai_tpu/api.py`` (python/bns.cpp:10-40): k-mers or
minimizers of one sequence (``get_kmers``), of every record of a
FASTA/FASTQ file (``seqdict``), and cyclic rolling hashes of any k
(``rolling_hashes``), returned as numpy ``uint64``.  A sequence is one
(1, L) row: ``get_kmers`` runs ``BatchEncoder.emissions`` (kernels KB1
and KB4, ``core/encoder.py``) and ``rolling_hashes`` runs
``RollingEncoder.hashes`` (kernel KR1, ``core/rolling.py``).  Each takes
``device``: ``"cuda"`` (the default) runs the kernels and raises where
no card is present; ``"cpu"`` runs their plain torch versions.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .core.alphabet import DNA4, InputType, alphabet_of
from .core.encoder import BatchEncoder
from .core.rolling import RollingEncoder
from .core.spacer import Spacer, parse_spacing
from .io import fastx


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda': no CUDA device is available "
                           "(device='cpu' runs the plain torch versions)")
    return dev


def _fetch(values: torch.Tensor, keep: torch.Tensor) -> np.ndarray:
    return values[keep].cpu().numpy().view(np.uint64)


def get_kmers(
    seq: bytes,
    k: int = 31,
    spacing: str = "",
    w: Optional[int] = None,
    canonicalize: bool = True,
    unique: bool = False,
    input_type: InputType = InputType.DNA,
    scheme: str = "lex",
    device="cuda",
) -> np.ndarray:
    """Emitted k-mers/minimizers of one sequence as np.uint64, in
    emission order, or sorted and distinct with ``unique``
    (bns.get_kmers, python/bns.cpp:10-40)."""
    dev = _device(device)
    if isinstance(seq, str):
        seq = seq.encode()
    gaps = parse_spacing(spacing, k)
    sp = Spacer(k, w if w and w > 0 else k, gaps)
    enc = BatchEncoder(sp, canonicalize, scheme, input_type)
    codes = fastx.encode_contig(seq, alphabet_of(InputType(input_type)).lut)
    if codes.size < sp.c:
        return np.empty(0, dtype=np.uint64)
    em = enc.emissions(torch.from_numpy(codes[None, :]).to(dev),
                       torch.tensor([codes.size], dtype=torch.int32,
                                    device=dev))
    vals = _fetch(em.values[0], em.mask[0])
    return np.unique(vals) if unique else vals


def seqdict(
    path: str,
    k: int = 31,
    spacing: str = "",
    w: Optional[int] = None,
    canonicalize: bool = True,
    unique: bool = False,
    input_type: InputType = InputType.DNA,
    device="cuda",
) -> Dict[bytes, np.ndarray]:
    """{contig name: kmer array} over a FASTA/FASTQ file (bns.seqdict),
    each contig through ``get_kmers`` with the scheme ``lex``."""
    _device(device)
    out: Dict[bytes, np.ndarray] = {}
    for name, seq, _ in fastx.read_fastx(path):
        out[name] = get_kmers(seq, k, spacing, w, canonicalize, unique,
                              input_type, device=device)
    return out


def rolling_hashes(
    seq: bytes,
    k: int,
    canonicalize: bool = False,
    seed1: int = 1337,
    seed2: int = 137,
    device="cuda",
) -> np.ndarray:
    """Cyclic rolling hashes of every k-window without an ambiguous base
    (RollingHasher path of bns.cpp / encoder.h:644+), unbounded k."""
    dev = _device(device)
    if isinstance(seq, str):
        seq = seq.encode()
    codes = fastx.encode_contig(seq, DNA4.lut)
    if codes.size < k:
        return np.empty(0, dtype=np.uint64)
    enc = RollingEncoder(k, canonicalize, seed1=seed1, seed2=seed2)
    vals, invalid = enc.hashes(torch.from_numpy(codes[None, :]).to(dev))
    return _fetch(vals[0], ~invalid[0])
