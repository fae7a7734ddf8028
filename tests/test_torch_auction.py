"""skix_torch's exact assignment (the auction) against skix's and scipy's.

- On costs whose optimum is unique, checked by its gap to the second-best
  assignment (scipy), the port's ``auction_assign`` gives skix's pairs:
  one-to-one and one-to-many (``repeats`` 3), more queries than gt, more gt
  than queries, and no valid gt; several problems in one batched call.
  Where the gt slots fit the queries the pairs are scipy's optimum; where
  they do not, skix's auction stops once every query is owned, which is not
  the optimum (the port gives skix's pairs all the same).
- On random costs (ties allowed) its total cost is scipy's
  ``linear_sum_assignment`` optimum within 1e-6 of the cost range.
- ``hungarian_assign_host`` is skix's.
"""

import numpy as np
import pytest
import torch

import jax
from scipy.optimize import linear_sum_assignment

from _torch_parity import jit0

from skix.tracking import matcher as SM
from skix_torch.tracking import matcher as TM

_SKIX = {}


def _skix_auction(cost, valid, repeats):
    if repeats not in _SKIX:
        _SKIX[repeats] = jit0(jax.vmap(
            lambda c, v: SM.auction_assign(c, v, repeats=repeats)))
    return np.asarray(_SKIX[repeats](cost, valid))


def _tiled(cost, valid, repeats):
    """The one-to-many problem as scipy's: columns tiled ``repeats`` times,
    the invalid ones dropped; returns (cost, column → gt)."""
    cols = np.tile(np.arange(cost.shape[1]), repeats)
    keep = np.tile(valid, repeats)
    return np.tile(cost, (1, repeats))[:, keep], cols[keep]


def _total(cost, assign, repeats):
    """The cost of ``assign`` (Q,) as a tiled-column assignment."""
    return float(sum(cost[q, g] for q, g in enumerate(assign) if g >= 0))


def _optimum_and_gap(cost, valid, repeats):
    """scipy's optimal total and its gap to the second-best assignment (each
    matched pair forbidden in turn)."""
    sub, _ = _tiled(cost, valid, repeats)
    if sub.shape[1] == 0:
        return 0.0, np.inf
    r, c = linear_sum_assignment(sub)
    best = sub[r, c].sum()
    second = np.inf
    for i, j in zip(r, c):
        alt = sub.copy()
        alt[i, j] = 1e6
        # a tiled copy of the same gt at another column is the same pair
        alt[i, np.flatnonzero(np.isclose(sub[i], sub[i, j]))] = 1e6
        rr, cc = linear_sum_assignment(alt)
        second = min(second, alt[rr, cc].sum())
    return float(best), float(second - best)


CASES = {   # name: (Q, G, repeats, valid pattern)
    "queries_over_gt": (10, 4, 1, [1, 1, 0, 1]),
    "o2m_repeats3": (12, 4, 3, [1, 0, 1, 1]),
    "gt_over_queries": (3, 6, 1, [1, 1, 1, 1, 0, 1]),
    "o2m_slots_over_queries": (5, 3, 3, [1, 1, 1]),
    "no_valid_gt": (6, 3, 1, [0, 0, 0]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_auction_matches_skix_on_a_unique_optimum(case):
    Q, G, repeats, pattern = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    valid = np.array(pattern, bool)
    costs = rng.uniform(-1.0, 3.0, (4, Q, G)).astype(np.float32)
    for c in costs:
        _, gap = _optimum_and_gap(c.astype(np.float64), valid, repeats)
        assert gap > 1e-3 * (c.max() - c.min()), gap   # a unique optimum
    valids = np.broadcast_to(valid, (4, G)).copy()
    want = _skix_auction(costs, valids, repeats)
    got = TM.auction_assign(torch.tensor(costs), torch.tensor(valids),
                            repeats=repeats).numpy()
    np.testing.assert_array_equal(got, want)
    feasible = repeats * int(valid.sum()) <= Q
    for c, a in zip(costs, got):
        best, _ = _optimum_and_gap(c.astype(np.float64), valid, repeats)
        if feasible:
            assert abs(_total(c, a, repeats) - best) <= 1e-5
        else:
            assert (a >= 0).all()        # stopped once every query is owned
        counts = np.bincount(a[a >= 0], minlength=G)
        assert (counts[~valid] == 0).all() and counts.max(initial=0) <= \
            repeats


@pytest.mark.parametrize("repeats", [1, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auction_total_cost_is_scipys(seed, repeats):
    """Random costs, the optimum not checked for uniqueness: the port's
    total is scipy's optimum within 1e-6 of the cost range, and every
    valid gt slot is taken."""
    rng = np.random.default_rng(seed)
    Q, G = 16, 5
    costs = rng.uniform(0, 2, (3, Q, G)).astype(np.float32)
    valids = rng.random((3, G)) > 0.3
    got = TM.auction_assign(torch.tensor(costs), torch.tensor(valids),
                            repeats=repeats).numpy()
    for c, v, a in zip(costs, valids, got):
        best, _ = _optimum_and_gap(c.astype(np.float64), v, repeats) \
            if v.any() else (0.0, 0.0)
        assert abs(_total(c, a, repeats) - best) <= 1e-6 * (c.max() - c.min())
        assert (a >= 0).sum() == min(Q, repeats * int(v.sum()))


def test_hungarian_assign_host_matches_skix():
    rng = np.random.default_rng(7)
    cost = rng.uniform(0, 1, (7, 4)).astype(np.float32)
    for valid in (np.array([1, 0, 1, 1], bool), np.zeros(4, bool)):
        np.testing.assert_array_equal(
            TM.hungarian_assign_host(cost, valid),
            SM.hungarian_assign_host(cost, valid))


def test_auction_records_its_rounds():
    """Nine ε phases a call, each with its round count."""
    TM.AUCTION_ROUNDS.update(phases=0, rounds=0, max_per_phase=0)
    rng = np.random.default_rng(3)
    TM.auction_assign(torch.tensor(rng.uniform(0, 1, (2, 6, 3)),
                                   dtype=torch.float32),
                      torch.ones(2, 3, dtype=torch.bool))
    st = TM.AUCTION_ROUNDS
    assert st["phases"] == 9 and 0 < st["max_per_phase"] <= 512
    assert st["phases"] <= st["rounds"] <= 9 * st["max_per_phase"]
