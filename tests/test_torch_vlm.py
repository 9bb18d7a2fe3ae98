"""The VLM backbone on the port (internvl2-2b reduced: 8 patch embeddings
projected by ``patch_proj`` before the text) against the JAX package, on
the CPU in f32 with the JAX package's weights carried across by
``convert.lm_params_from_jax``: the forward over [patches ‖ text] and the
loss over the text positions only.  Tolerances: rtol 1e-4 (atol 1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.registry import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import build_model

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def vlm():
    jcfg = jget_config("internvl2-2b").reduced()
    cfg = get_config("internvl2-2b").reduced()
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return cfg, jm, jp, tm


def _batch(cfg, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, s))
    labels = rng.integers(0, cfg.vocab, (2, s))
    patches = rng.normal(size=(2, cfg.n_patches, cfg.d_model)
                         ).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             "patches": jnp.asarray(patches)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels),
             "patches": torch.from_numpy(patches)})


@pytest.mark.parametrize("q_chunk", [8, 2048])
def test_vlm_forward_and_loss_match(vlm, q_chunk):
    """24 text tokens after 8 patches: 32 positions, in chunks of 8 or in
    one."""
    cfg, jm, jp, tm = vlm
    assert cfg.n_patches == 8 and tm.patch_proj.shape == (64, 64)
    jb, tb = _batch(cfg, 24, 1)
    s = 24 + cfg.n_patches
    jctx = jm.make_ctx(jnp.arange(s), q_chunk=q_chunk)
    tctx = tm.make_ctx(torch.arange(s), q_chunk=q_chunk)
    want, _ = jm.forward(jp, jb, jctx, remat=False)
    got, aux = tm.forward(tb, tctx)
    assert got.shape == (2, s, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0
    np.testing.assert_allclose(float(tm.loss(tb, tctx)),
                               float(jm.loss(jp, jb, jctx, remat=False)),
                               rtol=1e-5)
    # the default context covers the patches too
    default, _ = tm.forward(tb)
    np.testing.assert_allclose(default.numpy(), got.numpy(), **TOL)


def test_vlm_loss_leaves_out_the_patch_positions(vlm):
    """Changing what the patches' logits would predict moves nothing:
    the loss reads only the text positions' logits."""
    cfg, _, _, tm = vlm
    _, tb = _batch(cfg, 24, 2)
    from repro_torch.models.layers import cross_entropy
    logits, _ = tm.forward(tb)
    want = cross_entropy(logits[:, cfg.n_patches:], tb["labels"])
    torch.testing.assert_close(tm.loss(tb, aux_weight=0.0), want)
