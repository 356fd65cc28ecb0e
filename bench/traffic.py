"""The one traffic generator: every mix is a data file of parameters under
``bench/traffic/<mix>.json`` that this module reads.

Two loops take their inputs from here, drawn from ``--seed`` alone:

* ``closed``: batches of ``batch`` sources, each batch sent when the last
  one returned (callers that wait for their answers);
* ``open``: queries due on a schedule whatever the system does
  (independent users).  The mean rate is ``rate_qps``; ``modulation`` (a
  list of ``[seconds, multiplier]`` segments, repeated) shapes it into on
  and off bursts, and is a constant rate when absent.

Every seed gets the same work in another order, so that runs of two seeds
differ by no more than two runs of one seed.  The graph is the
configuration's instance (its ``instance_seed``), and so is the pool of
sources, uniform over the vertices: a closed loop's ``pool_batches``
batches (a batch's cost is its slowest row's, so the batches themselves are
fixed), an open loop's one source a query.  The seed orders the pool.  An
open schedule holds the same number of queries and the same set of gaps
for every seed: the gaps are the quantiles of the exponential law at the
mix's rate, in an order drawn from the seed.
"""

from __future__ import annotations

import numpy as np

#: the random streams of one run, apart from the generators' (stream 1)
SOURCES, WARM, ORDER, SAMPLE, CHECK, PARTITION = 2, 3, 4, 5, 6, 7


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), int(stream)])


def batch_sources(n: int, batch: int, seed: int, stream: int = SOURCES):
    """An endless run of batches of ``batch`` sources uniform over ``[0, n)``."""
    draw = rng(seed, stream)
    while True:
        yield draw.integers(0, n, size=batch, dtype=np.int64)


def pool_batches(traffic: dict, n: int, seed: int, instance: int):
    """An endless run of a closed loop's batches: the instance's
    ``pool_batches`` batches of ``batch`` sources each, the same batches for
    every seed, in an order (of the batches, and of the rows in each) drawn
    from ``seed``, anew each time the pool is spent."""
    shape = (int(traffic["pool_batches"]), int(traffic["batch"]))
    pool = rng(instance, SOURCES).integers(0, n, size=shape, dtype=np.int64)
    order = rng(seed, ORDER)
    while True:
        for b in order.permutation(shape[0]):
            yield order.permutation(pool[b])


def _unit_schedule(count: int, seed: int) -> np.ndarray:
    """``count`` arrival points of a unit-rate process: the exponential
    law's ``count`` mid-quantiles as gaps, in an order drawn from ``seed``."""
    q = (np.arange(count, dtype=np.float64) + 0.5) / count
    gaps = -np.log1p(-q)
    gaps *= count / gaps.sum()  # exactly one point per unit of time on average
    return np.cumsum(rng(seed, ORDER).permutation(gaps))


def open_schedule(traffic: dict, seconds: float, n: int, seed: int, instance: int):
    """``(due [N] seconds ascending, sources [N])`` for an open loop of
    ``seconds``: ``N = round(rate_qps * seconds)`` queries, their sources the
    instance's pool in an order drawn from ``seed``."""
    rate = float(traffic["rate_qps"])
    count = max(1, int(round(rate * seconds)))
    # points in the process's own time (its cumulative intensity), spread
    # over [0, seconds) of it
    points = _unit_schedule(count, seed) * (seconds / count)
    segments = traffic.get("modulation")
    if segments:
        # intensity mult(t) * rate, normalized so a period offers rate * period
        lengths = np.array([float(s) for s, _ in segments])
        mult = np.array([float(m) for _, m in segments])
        mult = mult * lengths.sum() / (mult * lengths).sum()
        periods = int(np.ceil(seconds / lengths.sum())) + 1
        bounds = np.concatenate([[0.0], np.cumsum(np.tile(lengths, periods))])
        load = np.concatenate([[0.0], np.cumsum(np.tile(lengths * mult, periods))])
        points = np.interp(points, load, bounds)
    pool = rng(instance, SOURCES).integers(0, n, size=count, dtype=np.int64)
    return points, rng(seed, ORDER).permutation(pool)
