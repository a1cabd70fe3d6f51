"""The yardstick's arithmetic against hand counts: model FLOP and computed
bytes per row, least times, percentiles, rates, and what the traffic
generator draws from a seed."""

import math

import numpy as np
import pytest

import bench_helpers  # noqa: F401  (puts the checkout on sys.path)
from benchmark import flops, spec, stats, traffic

DIRECT = spec.load_data("configs", "direct-21cmvae")
AE = spec.load_data("configs", "ae-21cmvae")
H100 = {"bf16_dense_flop_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}


def test_model_flop_per_row_hand_counts():
    # 7·288 + 288·352 + 352·288 + 288·224 + 224·451 = 370,304 MACs
    assert flops.model_flop_per_row(DIRECT, "predict") == 740_608
    # emulator 7·352 + 2·352·352 + 352·224 + 224·9 = 331,136; decoder
    # 9·32 + 32·352 + 352·451 = 170,304
    assert flops.model_flop_per_row(AE, "loglik") == 1_002_880
    assert flops.model_flop_per_row(DIRECT, "valgrad") == 2 * 740_608


def test_computed_bytes_per_row_hand_counts():
    # forward: every layer's input read and output written, float32
    # direct: (7+288) + (288+352) + (352+288) + (288+224) + (224+451)
    assert flops.computed_bytes_per_row(DIRECT, "predict") == 4 * 2762
    # backward adds, per layer, 2·out (upstream gradient + saved
    # activation) + in (gradient written)
    back = 2 * (288 + 352 + 288 + 224 + 451) + (7 + 288 + 352 + 288 + 224)
    assert flops.computed_bytes_per_row(DIRECT, "valgrad") == 4 * (
        2762 + back)


def test_least_time_sums_the_bound_of_each_layer():
    rows = 1 << 20
    t, bound = flops.least_time_s(DIRECT, "predict", rows, H100)
    assert bound == "hbm"  # every layer of the direct chain is HBM-bound
    assert t == pytest.approx(rows * 4 * 2762 / 3.35e12)
    # a peak 1000x slower makes every layer FLOP-bound
    slow = dict(H100, bf16_dense_flop_per_s=989e9)
    t, bound = flops.least_time_s(DIRECT, "predict", rows, slow)
    assert bound == "flop"
    assert t == pytest.approx(rows * 740_608 / 989e9)


@pytest.mark.parametrize("values,q,want", [
    ([1, 2, 3, 4, 5], 50, 3.0),
    ([1, 2, 3, 4], 50, 2.5),
    (list(range(1, 101)), 95, 95.05),
    ([7.0], 95, 7.0),
])
def test_percentile_matches_hand_values_and_numpy(values, q, want):
    assert stats.percentile(values, q) == pytest.approx(want)
    assert stats.percentile(values, q) == pytest.approx(
        float(np.percentile(values, q)))


def test_percentile_counts_failed_requests_as_missing():
    lat = [1.0] * 90 + [math.inf] * 10
    assert stats.percentile(lat, 95) == math.inf
    assert stats.percentile(lat, 50) == 1.0


def test_rate_is_work_over_the_whole_window():
    assert stats.rate(4 * (1 << 20), 2.0) == 2 * (1 << 20)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_prior_rows_ranges_and_fx_zero_share():
    rows = traffic.prior_rows(200_000, traffic.rng_for(3))
    lo, hi = traffic.PAR_RANGES[:, 0], traffic.PAR_RANGES[:, 1]
    fx_zero = rows[:, 2] == 0.0
    assert abs(fx_zero.mean() - 0.05) < 0.005
    kept = rows[~fx_zero]
    assert (kept >= lo).all() and (kept <= hi).all()


def test_seeds_large_negative_and_reproducible():
    a = traffic.prior_rows(8, traffic.rng_for(2**31 + 17))
    b = traffic.prior_rows(8, traffic.rng_for(2**31 + 17))
    c = traffic.prior_rows(8, traffic.rng_for(-5))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_request_sizes_same_multiset_for_every_seed():
    mix = spec.load_data("traffic", "serve-predict")
    one = traffic.shuffled_sizes(mix, traffic.rng_for(1))
    two = traffic.shuffled_sizes(mix, traffic.rng_for(2))
    assert one != two and sorted(one) == sorted(two)
    assert len(one) == mix["cycle"]
    assert one.count(1) == round(mix["cycle"] * mix["single_row_share"])
    multi = [n for n in one if n > 1]
    assert min(multi) == 2 and 120 <= max(multi) <= 128


def test_observation_is_fixed_by_the_traffic_file():
    mix = spec.load_data("traffic", "mh-loglik")
    t1, n1, v1 = traffic.observation_rows(mix)
    t2, n2, v2 = traffic.observation_rows(mix)
    np.testing.assert_array_equal(n1, n2)
    assert v1 == v2 == 25.0 and t1.shape == (1, 7)
    assert abs(n1.std() - 5.0) < 0.5
