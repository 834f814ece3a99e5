"""Metatree: data-driven taxonomy restructuring.

Counterpart of ``bonsai_tpu/metatree/`` (the reference's kgset_t /
bitmap_t / veccmp / FlexMap / FMEmitter / TaxonomyReformation,
include/bonsai/{kgset,bitmap,bitcmp,flextree,tx}.h): per-taxon k-mer
sets from KB1 on the device, the k-mer x taxon bit matrix and its
distinct patterns and the all-pairs subset compares as torch calls on
the device, and the scoring and emission of candidate nodes on the host.
"""

from .bitsets import (  # noqa: F401
    BitCmp,
    KmerGenomeSets,
    adjacency,
    bitmap_patterns,
    pairwise_veccmp,
    score_node_addn,
    vec_popcnt,
    veccmp,
)
from .flextree import FlexMap, FMEmitter  # noqa: F401
from .tx import TaxonomyReformation  # noqa: F401
