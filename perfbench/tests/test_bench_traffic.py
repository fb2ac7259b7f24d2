"""The traffic generator: a fixed count and multiset of lengths per run,
the same requests for the same seed, another order for another."""
import numpy as np
import pytest

from perfbench import harness
from perfbench import traffic as gen

RAG = harness.load_cell("serve.mistral7b.rag").traffic
OFF = harness.load_cell("serve.mistral7b.offline").traffic
SEEDS = (1, 2**31 + 5, 987654321987)


def _key(reqs):
    return [(r.due_s, r.max_tokens, r.prompt.tobytes()) for r in reqs]


@pytest.mark.parametrize("seed", SEEDS)
def test_open_loop_count_and_multisets_are_fixed_by_rate_and_window(seed):
    reqs = gen.open_loop(RAG, seed, 45.0, 32768)
    base = gen.open_loop(RAG, 7, 45.0, 32768)
    assert len(reqs) == len(base) == round(RAG["arrivals"]["rate_per_s"] * 45.0)
    assert sorted(len(r.prompt) for r in reqs) == sorted(len(r.prompt) for r in base)
    assert sorted(r.max_tokens for r in reqs) == sorted(r.max_tokens for r in base)
    due = [r.due_s for r in reqs]
    assert due == sorted(due) and 0.0 <= due[0] and due[-1] < 45.0


def test_open_loop_is_deterministic_per_seed_and_differs_across_seeds():
    a, b = gen.open_loop(RAG, 11, 20.0, 32768), gen.open_loop(RAG, 11, 20.0, 32768)
    assert _key(a) == _key(b)
    c = gen.open_loop(RAG, 12, 20.0, 32768)
    assert _key(a) != _key(c)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in c]


def test_lengths_follow_the_mix():
    reqs = gen.open_loop(RAG, 3, 50.0, 32768)
    plen = np.array([len(r.prompt) for r in reqs])
    olen = np.array([r.max_tokens for r in reqs])
    assert plen.min() >= 512 and plen.max() <= 2048 and abs(np.median(plen) - 1024) <= 16
    assert olen.min() >= 64 and olen.max() <= 256
    assert all(0 <= int(r.prompt.min()) and int(r.prompt.max()) < 32768 for r in reqs)


def test_quantile_lengths_hand_worked():
    # u = 0.125, 0.375, 0.625, 0.875 over 10..13 (4 whole numbers): 10, 11, 12, 13
    assert gen.quantile_lengths({"dist": "uniform", "min": 10, "max": 13}, 4).tolist() == [10, 11, 12, 13]
    # the median quantile of a lognormal is its median
    assert gen.quantile_lengths({"dist": "lognormal", "median": 100, "sigma": 1.0, "min": 1, "max": 1000},
                                1).tolist() == [100]


def test_backlog_first_wave_is_staggered_and_the_pool_fixed():
    a = gen.backlog(OFF, 5, 32768, 128)
    b = gen.backlog(OFF, 6, 32768, 128)
    assert len(a) == len(b) == OFF["pool"]
    first = sorted(r.max_tokens for r in a[:128])
    assert first == sorted(r.max_tokens for r in b[:128])
    assert first[0] <= 16 and first[-1] >= 760
    assert sorted(r.max_tokens for r in a[128:]) == sorted(r.max_tokens for r in b[128:])
    assert min(r.max_tokens for r in a[128:]) >= 256


def test_judge_sample_takes_the_longest_and_enough_tokens():
    done = [{"prompt": np.zeros(p, np.int32), "tokens": [0] * t} for p, t in
            [(10, 5), (50, 40), (20, 10), (5, 3), (30, 30)]]
    picked = gen.judge_sample(done, 4, 60)
    assert picked[0] == 1
    assert sum(len(done[i]["tokens"]) for i in picked) >= 60
    assert len(set(picked)) == len(picked)
    assert picked == gen.judge_sample(done, 4, 60)


def test_seed_streams_take_large_seeds():
    assert harness.seed_for(2**40 + 3, "weights") != harness.seed_for(3, "weights")
    assert 0 <= harness.seed_for(2**33, "x") < 2**63
