"""Parity of the port's sampler against the JAX package.

Both are fed the same logits and the same ``gumbel_noise`` (made with numpy),
so the tokens must agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.config import SoftmaxPolicy as JSoftmaxPolicy
from hpc_ops_tpu.ops import sampler as J
from hpc_ops_tpu_torch.config import SoftmaxPolicy
from hpc_ops_tpu_torch.ops import sampler as T

torch.set_num_threads(1)

B, V = 6, 1000


def inputs(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    logits[0, 10] = logits[0, 20] = logits[0].max() + 5  # an exact tie
    u = rng.uniform(1e-6, 1.0, (B, V)).astype(np.float32)
    noise = np.array(J.gumbel_from_uniform(jnp.asarray(u)))
    assert np.allclose(T.gumbel_from_uniform(torch.from_numpy(u)).numpy(), noise, atol=1e-5)
    return logits, noise


def test_temperature_sample_bit_exact():
    logits, noise = inputs(0)
    temps = np.linspace(0.3, 1.5, B).astype(np.float32)
    want = J.fused_sampler_temperature_sample(jnp.asarray(logits), jnp.asarray(temps),
                                              gumbel_noise=jnp.asarray(noise),
                                              draft_token_ids=jnp.asarray([5, -1, 7, -1, 0, 3]))
    got = T.fused_sampler_temperature_sample(torch.from_numpy(logits), torch.from_numpy(temps),
                                             gumbel_noise=torch.from_numpy(noise),
                                             draft_token_ids=torch.tensor([5, -1, 7, -1, 0, 3]))
    assert got.dtype == torch.int32 and got.shape == (B, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # greedy tie: with zero noise the lower token id wins
    got0 = T.fused_sampler_temperature_sample(torch.from_numpy(logits), 1.0,
                                              gumbel_noise=torch.zeros(B, V))
    assert int(got0[0, 0]) == 10


@pytest.mark.parametrize(
    "policy,topk,topp,max_topk",
    [(0, [0, 1, 5, 32, 40, 3], 0.0, 32), (2, 4, 0.0, 32), (1, 0, 0.7, 64)],
)
def test_fused_sampler_bit_exact(policy, topk, topp, max_topk):
    logits, noise = inputs(1)
    tk = topk if isinstance(topk, int) else np.asarray(topk, np.int32)
    want, _ = J.fused_sampler(jnp.asarray(logits), temperature=0.8,
                              softmax_policy=JSoftmaxPolicy(policy),
                              topk=tk if isinstance(tk, int) else jnp.asarray(tk), topp=topp,
                              max_topk=max_topk, gumbel_noise=jnp.asarray(noise))
    got, _ = T.fused_sampler(torch.from_numpy(logits), temperature=0.8,
                             softmax_policy=SoftmaxPolicy(policy),
                             topk=tk if isinstance(tk, int) else torch.from_numpy(tk), topp=topp,
                             max_topk=max_topk, gumbel_noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_penalty_mask_bit_exact():
    logits, noise = inputs(2)
    rng = np.random.RandomState(3)
    mask = rng.randint(0, 256, (4, (V + 7) // 8)).astype(np.uint8)
    slots = np.array([0, 2, 1, 3, 0, 2], np.int32)
    kw = dict(temperature=1.0, topk=8, repetition_penalty=1.3)
    want, wmask = J.fused_sampler(jnp.asarray(logits), penalty_mask=jnp.asarray(mask),
                                  slot_id=jnp.asarray(slots), gumbel_noise=jnp.asarray(noise), **kw)
    tmask = torch.from_numpy(mask.copy())
    got, gmask = T.fused_sampler(torch.from_numpy(logits), penalty_mask=tmask,
                                 slot_id=torch.from_numpy(slots), gumbel_noise=torch.from_numpy(noise), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gmask is tmask  # updated in place
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))


def test_sampler_contract_errors():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="exact"):
        T.fused_sampler(x, temperature=1.0, topk_impl="partial")
    with pytest.raises(ValueError):
        T.fused_sampler(x, temperature=1.0, topp=0.5)
    with pytest.raises(ValueError):
        T.fused_sampler(x, temperature=1.0, max_topk=16)


@pytest.mark.parametrize("policy,topk,topp,max_topk", [(0, 5, 0.0, 32), (1, 0, 0.7, 64), (2, 40, 0.0, 64)])
def test_fused_sampler_approx_bit_exact_on_cpu(policy, topk, topp, max_topk):
    """topk_impl="approx" on the CPU: exact there, as JAX's approx_max_k on
    the CPU, so the tokens equal JAX's bit for bit."""
    logits, noise = inputs(4)
    kw = dict(temperature=0.8, topk=topk, topp=topp, max_topk=max_topk, topk_impl="approx")
    want, _ = J.fused_sampler(jnp.asarray(logits), softmax_policy=JSoftmaxPolicy(policy),
                              gumbel_noise=jnp.asarray(noise), **kw)
    got, _ = T.fused_sampler(torch.from_numpy(logits), softmax_policy=SoftmaxPolicy(policy),
                             gumbel_noise=torch.from_numpy(noise), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_binned_approx_top_k_recall_against_jax():
    """The card's binned path (PartialReduce's algorithm), run here on the
    CPU, at [8, 128256] and k 64 (llama3's vocabulary, the sampler's
    max_topk): recall of JAX's approx_max_k indices (exact on the CPU) at
    least 0.95, every value the logit at its index, values sorted
    descending, ties to the lower index, and the same on a second call."""
    rng = np.random.RandomState(7)
    logits = (rng.randn(8, 128256) * 3).astype(np.float32)
    logits[0, 1000:1004] = logits[0].max() + 1  # a tie inside one bin and across bins
    logits[0, 90000] = logits[0, 1000]
    _, want = jax.lax.approx_max_k(jnp.asarray(logits), 64, recall_target=0.95)
    work = torch.from_numpy(logits)
    vals, idx = T._approx_max_k(work, 64)
    vals2, idx2 = T._approx_max_k(work, 64)
    assert torch.equal(vals, vals2) and torch.equal(idx, idx2)
    assert vals.shape == idx.shape == (8, 64)
    assert torch.equal(vals, torch.gather(work, 1, idx))
    assert bool((vals[:, :-1] >= vals[:, 1:]).all())
    assert int(idx[0, 0]) == 1000 and int(idx[0, 1]) == 90000  # the lowest of each bin's tie, then by bin
    want = np.asarray(want)
    found = sum(len(set(idx[b].tolist()) & set(want[b].tolist())) for b in range(8))
    assert found / want.size >= 0.95
    assert T._bins(128256, 64, 0.95) >= 1 and 128256 // T._bins(128256, 64, 0.95) >= 1229
