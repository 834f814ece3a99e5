"""Port parity: the plain versions of the two gather microbenchmarks.

G1 ``row_gather`` and G2 ``take_along`` (``bonsai_tpu_torch/tools/
gather_bench.py``) port the JAX package's two Pallas experiments
(``tools/probe_microbench.py`` variant F, ``tools/vmem_gather_bench2.py``).
Those Pallas kernels run only on a TPU (Mosaic DMA and semaphores, called
without ``interpret``), so the plain versions are held here against what
their bodies compute: ``tbl[idx]`` and ``jnp.take_along_axis``, at the
shapes of their ``build_*`` cases.  The kernels themselves are held
against the plain versions on the card (``tests/test_torch_kernels.py``).
Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonsai_tpu_torch.tools import gather_bench as gb

torch.set_num_threads(1)


@pytest.mark.parametrize("R,C,Q", [(1 << 12, 32, 1 << 11), (1 << 14, 8, 5000),
                                   (5, 4, 0)])
def test_row_gather_plain_is_a_row_gather(R, C, Q):
    rng = np.random.default_rng(R)
    tbl = rng.integers(0, 2**32, (R, C), dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, R, Q).astype(np.int32)
    got = gb.row_gather(torch.from_numpy(tbl.view(np.int32)),
                        torch.from_numpy(idx))  # a CPU tensor: the plain one
    np.testing.assert_array_equal(got.numpy().view(np.uint32), tbl[idx])
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        np.asarray(jnp.asarray(tbl)[jnp.asarray(idx)]))


@pytest.mark.parametrize("case", range(4))
def test_take_along_plain_matches_jax(case):
    name, tab, idx, axis = gb.take_cases("cpu")[case]
    want = jnp.take_along_axis(jnp.asarray(tab.numpy().view(np.uint32)),
                               jnp.asarray(idx.numpy()), axis=axis)
    got = gb.take_along(tab, idx, axis)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_take_along_plain_on_random_indices():
    rng = np.random.default_rng(2)
    tab = rng.integers(0, 2**32, (64, 48), dtype=np.uint64).astype(np.uint32)
    for axis, shape in ((0, (100, 48)), (1, (64, 70))):
        idx = rng.integers(0, tab.shape[axis], shape).astype(np.int32)
        got = gb.take_along_plain(torch.from_numpy(tab.view(np.int32)),
                                  torch.from_numpy(idx), axis)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.take_along_axis(tab, idx, axis))


def test_f_case_has_variant_f_shape():
    tbl, idx = gb.f_case("cpu")
    assert tbl.shape == (1 << 21, 32) and tbl.dtype == torch.int32
    assert idx.shape == (1 << 19,) and int(idx.max()) < (1 << 21)


def test_bench_needs_a_card():
    with pytest.raises(RuntimeError):
        gb.run("cpu")
    if not torch.cuda.is_available():
        assert gb.main() == 2
