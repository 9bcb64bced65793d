"""A model fed precomputed embeddings in place of tokens (``input_embeds``,
musicgen-large's frontend contract) through the port's ``prefill`` and
``decode_step`` against the JAX package's, from the same weights.  Logit
tolerance 3e-2 (rtol = atol), the serving tests' for a bf16 model.  JAX runs
op by op (``jax.disable_jit()``), as the port runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce
# the port
from repro_torch import convert
from repro_torch import models as tm
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(autouse=True)
def jax_op_by_op():
    with jax.disable_jit():
        yield


def test_input_embeds_prefill_and_decode_match_jax():
    """A musicgen-style model fed precomputed embeddings (``input_embeds``)
    in place of tokens, through prefill and two decode steps."""
    jcfg = jax_reduce(jax_get_arch("musicgen-large"))
    cfg = reduce_for_smoke(get_arch("musicgen-large"))
    jparams = jm.init_params(jcfg, jax.random.key(5))
    params = convert.params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                    jparams), "cpu")
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((2, 14, cfg.d_model)).astype(np.float32)
    tokens = np.zeros((2, 12), np.int32)
    jl, jc = jm.prefill(jparams, jnp.asarray(tokens), jcfg, input_embeds=jnp.asarray(emb[:, :12]))
    tl, tc = tm.prefill(params, torch.from_numpy(tokens), cfg,
                        input_embeds=torch.from_numpy(emb[:, :12]))
    np.testing.assert_allclose(f32(tl), f32(jl), rtol=3e-2, atol=3e-2)
    pad = [(0, 0), (0, 0), (0, 2), (0, 0), (0, 0)]
    jc = jc._replace(k=jnp.pad(jc.k, pad), v=jnp.pad(jc.v, pad))
    tc = convert.cache_from_numpy(np.asarray(jc.k, np.float32), np.asarray(jc.v, np.float32),
                                  int(jc.pos), "cpu")
    for t in (12, 13):
        jl, jc = jm.decode_step(jparams, jnp.asarray(tokens[:, :1]), jc, jcfg,
                                input_embeds=jnp.asarray(emb[:, t:t + 1]))
        tl, tc = tm.decode_step(params, torch.from_numpy(tokens[:, :1]), tc, cfg,
                                input_embeds=torch.from_numpy(emb[:, t:t + 1]))
        np.testing.assert_allclose(f32(tl), f32(jl), rtol=3e-2, atol=3e-2)
    # the embeddings, not the tokens, drive the model
    other, _ = tm.prefill(params, torch.from_numpy(tokens), cfg,
                          input_embeds=torch.from_numpy(emb[:, 1:13]))
    assert not torch.equal(other, tm.prefill(params, torch.from_numpy(tokens), cfg,
                                             input_embeds=torch.from_numpy(emb[:, :12]))[0])
