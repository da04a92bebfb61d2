"""``chip_smoke.first_batch_verdict``, the rule of smoke phase 24b's
first-batch check, on readings made from a seed: the median over the
(engine, bucket) pairs of a first batch over its engine's warm median is
held to 1.1, and the cold pairs' median to 1.5 times it."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def _readings(seed, prewarmed_cost, cold_cost=3.2, spread=0.17,
              warm_ms=21.0):
    """``_first_batch_times``'s shape: per mode, one ``(bucket, first,
    warm)`` per engine and bucket, each batch ``warm_ms`` times a
    lognormal of sd ``spread``; a first batch also times its mode's
    cost."""
    rng = np.random.RandomState(seed)
    cold_engines = len(range(0, cs.TUNE_FIRST_TRIALS, cs.TUNE_COLD_EVERY))
    out = {}
    for mode, engines, cost in (
            ("prewarmed", cs.TUNE_FIRST_TRIALS, prewarmed_cost),
            ("cold", cold_engines, cold_cost)):
        out[mode] = [
            (b, cost * warm_ms * rng.lognormal(0, spread),
             list(warm_ms * rng.lognormal(0, spread, cs.TUNE_WARM_REPS)))
            for _ in range(engines) for b in cs.TUNE_FIRST_BUCKETS]
    return out


@pytest.mark.parametrize("seed", range(8))
def test_noise_alone_passes(seed):
    """A prewarm that leaves 3 % on a first batch (the wake of an idle
    batcher thread) passes at the card's host spread, seed after seed."""
    v = cs.first_batch_verdict(_readings(seed, 1.03))
    assert v["ratio"]["prewarmed"] < cs.TUNE_PREWARMED_MAX
    assert v["engines"] == cs.TUNE_FIRST_TRIALS + len(
        range(0, cs.TUNE_FIRST_TRIALS, cs.TUNE_COLD_EVERY))
    assert len(v["ratios"]["prewarmed"]) == (
        cs.TUNE_FIRST_TRIALS * len(cs.TUNE_FIRST_BUCKETS))
    assert len(v["first_ms_32"]["prewarmed"]) == cs.TUNE_FIRST_TRIALS


@pytest.mark.parametrize("prewarmed_cost,cold_cost", [
    (1.2, 3.2),   # the prewarm leaves a fifth of a batch on each first one
    (3.2, 3.2),   # the prewarm does nothing
    (1.0, 1.2),   # a cold first batch that costs nothing to warm
])
def test_a_cost_the_prewarm_leaves_fails(prewarmed_cost, cold_cost):
    with pytest.raises(cs.SmokeError, match="first batch after a prewarm"):
        cs.first_batch_verdict(_readings(0, prewarmed_cost, cold_cost))


@pytest.mark.parametrize("n,side", [(1, 8), (7, 16), (3, 224)])
def test_json_body_is_json_dumps_byte_for_byte(n, side):
    """The serving phases' JSON bodies, built from a table of triples,
    are the bytes ``json.dumps`` writes; other values go through it."""
    import json

    x = cs._rows(n, side, n + side)
    want = json.dumps({"data": x.tolist(), "raw": True}).encode()
    assert cs._json_body(x) == want
    y = x + np.float32(0.01)
    assert cs._json_body(y) == json.dumps(
        {"data": y.tolist(), "raw": True}).encode()
