"""The port's batched sampler against ray_tpu.llm.sampling.sample_batch.

Greedy rows must be exact. Sampled rows come from a torch.Generator, so
they cannot match JAX's random stream: they are checked to return only
allowed candidates, with frequencies that match the renormalised
distribution (chi-square, fixed seed, p > 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from ray_tpu.llm.sampling import sample_batch as jax_sample
from ray_tpu_torch.llm.sampling import SamplingParams, sample_batch


def test_greedy_rows_exact_in_a_mixed_batch():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 97)).astype(np.float32)
    temps = np.where(np.arange(16) % 2 == 0, 0.0, 0.8).astype(np.float32)
    top_ps = np.full(16, 0.9, np.float32)
    top_ks = np.full(16, 5, np.int32)
    want = np.asarray(jax_sample(jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ps),
                                 jnp.asarray(top_ks), jax.random.PRNGKey(0)))
    got = sample_batch(torch.from_numpy(logits), torch.from_numpy(temps), torch.from_numpy(top_ps),
                       torch.from_numpy(top_ks), torch.Generator().manual_seed(0)).numpy()
    greedy = temps <= 0
    np.testing.assert_array_equal(got[greedy], want[greedy])
    np.testing.assert_array_equal(got[greedy], logits[greedy].argmax(-1))


def _draw(logits_row, n, temp, top_p, top_k, seed=0):
    logits = torch.from_numpy(np.tile(logits_row, (n, 1)))
    return sample_batch(logits, torch.full((n,), temp), torch.full((n,), top_p),
                        torch.full((n,), top_k, dtype=torch.int32),
                        torch.Generator().manual_seed(seed)).numpy()


def _renormalised(probs, keep):
    p = np.where(keep, probs, 0.0)
    return p / p.sum()


@pytest.mark.parametrize("temp,top_p,top_k", [(1.0, 1.0, 4), (1.0, 0.7, 0), (0.5, 1.0, 0)])
def test_sampled_rows_follow_renormalised_distribution(temp, top_p, top_k):
    probs = np.array([0.4, 0.25, 0.15, 0.1, 0.05, 0.03, 0.02], np.float64)
    logits = np.log(probs).astype(np.float32)
    n = 20000
    toks = _draw(logits, n, temp, top_p, top_k)
    scaled = np.exp(np.log(probs) / temp)
    scaled /= scaled.sum()
    keep = np.ones(len(probs), bool)
    if top_k:
        keep[top_k:] = False
    if top_p < 1.0:
        prefix = np.cumsum(scaled) - scaled
        keep &= prefix < top_p
    expected = _renormalised(scaled, keep)
    assert set(np.unique(toks)) <= set(np.flatnonzero(keep))  # only allowed candidates
    counts = np.bincount(toks, minlength=len(probs))[keep]
    p_value = stats.chisquare(counts, expected[keep] * n).pvalue
    assert p_value > 1e-3, (counts, expected * n)


def test_sampling_params_validation():
    with pytest.raises(ValueError):
        SamplingParams(top_p=0.0)
    with pytest.raises(ValueError):
        SamplingParams(max_tokens=0)
