"""The traffic generator: the same seed gives the same requests, every
seed the same amount of work at the asked rate."""

import numpy as np

from benchmark import traffic


def test_poisson_schedule_repeats_from_the_seed():
    a = traffic.poisson_schedule(3_000_000_019, 1.5, 51)
    b = traffic.poisson_schedule(3_000_000_019, 1.5, 51)
    c = traffic.poisson_schedule(3_000_000_021, 1.5, 51)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_poisson_schedule_has_the_asked_rate():
    for seed in range(5):
        t = traffic.poisson_schedule(2**33 + seed, 1.5, 51)
        assert len(t) == round(1.5 * 51)
        assert np.all(np.diff(t) >= 0) and t[0] >= 0 and t[-1] < 51
    # the gaps of a Poisson process: exponential, mean 1 / rate
    gaps = np.concatenate([np.diff(traffic.poisson_schedule(seed, 2.0, 500))
                           for seed in range(20)])
    assert abs(gaps.mean() - 0.5) < 0.02
    assert abs(np.median(gaps) - 0.5 * np.log(2)) < 0.03


def test_caption_lengths_are_the_same_work_in_another_order():
    a = traffic.caption_lengths(1, 77, 32, 256)
    b = traffic.caption_lengths(2, 77, 32, 256)
    assert sorted(a) == sorted(b) and a.min() == 32 and a.max() == 256
    assert not np.array_equal(a, b)


def test_zipf_choice_favours_the_first_avatars():
    draws = traffic.zipf_choice(7, 4000, 8, 1.1)
    counts = np.bincount(draws, minlength=8)
    assert counts[0] > counts[1] > counts[4] > counts[7] > 0


def test_sub_seeds_fit_a_generator_and_differ():
    seeds = traffic.request_seeds(2**40 + 5, 100)
    assert len(set(seeds)) == 100 and all(0 <= s < 2**62 for s in seeds)
