"""A cell on several cards: one process per rank, joined over
``tcp://localhost``; here two ranks over gloo on the CPU."""

import sys

from benchmark import ranks


def test_two_ranks_over_gloo(capfd):
    code = ranks.spawn([sys.executable, "-m", "benchmark.ranks"], 2, timeout=120)
    out = capfd.readouterr()
    assert code == 0, out.err
    assert out.out.strip() == "3.0"  # 1 + 2, all-reduced; rank 0 alone prints
    assert "rank 1 of 2: 3.0" in out.err


def test_a_rank_that_fails_fails_the_run():
    code = ranks.spawn([sys.executable, "-c", "import os, sys; sys.exit(int(os.environ['BENCH_RANK']) * 7)"], 2, timeout=60)
    assert code == 7
