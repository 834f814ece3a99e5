"""Per-contig, per-chunk HyperLogLog cardinality profiles of a genome.

Counterpart of ``bonsai_tpu/sketch/gchunk.py`` (the reference's
bns::GenomeChunker, gchunk.h:6-52): each contig is cut into chunks of
``chunk_size`` bases, and every valid contiguous k-mer (canonical by
default) goes into the HyperLogLog of the chunk its first base lies in
(the reference divides the position after the window, gchunk.h:37; the
JAX package and this one the start, c - 1 earlier).  A contig's k-mers
come from KB1 at W = 1 (``core/encoder.py`` ``minimizers``) and each
chunk's sketch is filled by KS1 (``sketch/hll.py``), on ``device``
("cuda", the default, raises without a card; "cpu" runs their plain
versions).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core.alphabet import DNA4
from ..core.encoder import minimizers
from ..core.spacer import Spacer
from ..db.build_device import as_device
from ..io import fastx
from .hll import HyperLogLog


@dataclass
class ContigChunks:
    name: bytes
    hlls: List[HyperLogLog]

    def profile(self) -> np.ndarray:
        return np.array([h.report() for h in self.hlls])


class GenomeChunker:
    def __init__(self, path: str, chunk_size: int, sp: Spacer, p: int = 16,
                 canonical: bool = True, lut=None, device="cuda"):
        dev = as_device(device)
        lut = DNA4.lut if lut is None else lut
        self.path = path
        self.chunk_size = int(chunk_size)
        self.contigs: List[ContigChunks] = []
        for name, seq, _ in fastx.read_fastx(path):
            codes = fastx.encode_contig(seq, lut)
            n_chunks = (codes.size + chunk_size - 1) // chunk_size
            cd = ContigChunks(name, [HyperLogLog(p, dev)
                                     for _ in range(n_chunks)])
            self.contigs.append(cd)
            if codes.size < sp.c:
                continue
            em = minimizers(torch.from_numpy(codes[None, :]).to(dev),
                            torch.tensor([codes.size], dtype=torch.int32,
                                         device=dev), sp.k, 1, canonical)
            kmers, valid = em.values[0], em.mask[0]
            ci = torch.arange(kmers.numel(), device=dev) // chunk_size
            for c in range(n_chunks):
                sel = (ci == c) & valid
                cd.hlls[c].addh(kmers[sel])

    def for_each(self, fn):
        for cd in self.contigs:
            fn(cd)
