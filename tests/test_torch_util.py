"""Port parity: the host helpers of ``bonsai_tpu_torch/util.py``
(``bitvec2str``, ``Timer``, ``time_code``, ``get_logger``) against
``bonsai_tpu/util.py`` and ``tests/test_api_util.py:71-78``.  Tolerance:
equal strings."""

import io
import logging

import numpy as np
import pytest

from bonsai_tpu import util as jutil

from bonsai_tpu_torch import util


def test_timer_and_time_code(capsys):
    with util.time_code("unit"):
        sum(range(1000))
    err = capsys.readouterr().err
    assert "[unit]" in err and "ns" in err


def test_timer_stop_restart_and_report():
    fh = io.StringIO()
    t = util.Timer("a", fh)
    assert t.stop() >= 0 and t.elapsed_ns is not None
    t.restart("b")
    t.report()
    assert fh.getvalue().startswith("[b] ") and fh.getvalue().endswith(" ns\n")
    with util.Timer(fh=fh) as t2:
        pass
    assert "[Timer] " in fh.getvalue() and t2.elapsed_ns >= 0


@pytest.mark.parametrize("row", [[1], [0], [2**64 - 1, 5], [2**63, 1, 0]])
def test_bitvec2str_matches_jax(row):
    v = np.array(row, dtype=np.uint64)
    s = util.bitvec2str(v)
    assert s == jutil.bitvec2str(v)
    assert len(s) == 64 * len(row)
    if row == [1]:
        assert s.endswith("1") and s.count("1") == 1


def test_get_logger():
    log = util.get_logger()
    assert log is util.get_logger()
    assert log.name == "bonsai_tpu_torch" and log.level == logging.INFO
    fmt = log.handlers[0].formatter._fmt
    assert fmt == jutil.get_logger().handlers[0].formatter._fmt
