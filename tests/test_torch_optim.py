"""The port's optimizers against the JAX package's on the CPU, over a
stacked tree as the trainer gives them: a (V, d) table, an unstacked (d,)
norm, a stacked (L, d) norm and a stacked (L, d, f) projection.  Three
steps from the same state with the same gradients (numpy, from seeds);
every parameter, moment and metric after each step at rtol 1e-5, atol
1e-7 (f32; bf16 parameters within one bf16 unit in the last place)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim as toptim
from repro_torch import tree
from repro_torch.ckpt.checkpoint import from_numpy, to_numpy

L, V, D, F = 3, 24, 8, 12
TOL = dict(rtol=1e-5, atol=1e-7)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (scale * rng.normal(size=shape)).astype(np.float32)
    return {"embed": w(V, D), "final_ln": w(D),
            "g_blocks": {"ln1": w(L, D), "w1": w(L, D, F)}}


def _jflat(t) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v, dtype=np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}


def _tflat(t) -> dict:
    return {tree.key_of(p): v.float().numpy() for p, v in tree.items(t)}


def _both(make, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), _tree(0))
    tp = tree.map_(lambda a: from_numpy(np.asarray(a)), jax.tree.map(
        np.asarray, jp))
    return make(joptim), make(toptim), jp, tp


OPTS = {
    "adamw": lambda m: m.AdamW(lr=1e-2),
    "adamw_master": lambda m: m.AdamW(lr=1e-2, master_weights=True),
    "adamw_schedule": lambda m: m.AdamW(
        lr=m.cosine_warmup(1e-2, warmup=2, total=5), master_weights=True),
    "adafactor": lambda m: m.Adafactor(lr=1e-2, weight_decay=0.1),
}


# bf16 parameters are trained with f32 master weights (Adafactor has
# none: it updates the bf16 leaf from its f32 value)
CASES = [(n, "float32") for n in sorted(OPTS)] + [
    ("adamw_master", "bfloat16"), ("adamw_schedule", "bfloat16"),
    ("adafactor", "bfloat16")]


@pytest.mark.parametrize("name,dtype", CASES)
def test_three_steps_match_the_reference(name, dtype):
    jopt, topt, jp, tp = _both(OPTS[name], dtype)
    js, ts = jopt.init(jp), topt.init(tp)
    assert _tflat(ts).keys() == _jflat(js).keys()
    for step in range(3):
        g = _tree(10 + step, scale=0.1)
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = topt.update(tree.map_(torch.from_numpy, g), ts, tp)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        ptol = (dict(rtol=2 ** -8, atol=1e-7) if dtype == "bfloat16"
                else TOL)
        for key, want in _jflat(jp).items():
            np.testing.assert_allclose(_tflat(tp)[key], want, err_msg=key,
                                       **ptol)
        for key, want in _jflat(js).items():
            np.testing.assert_allclose(_tflat(ts)[key], want, err_msg=key,
                                       **TOL)


def test_adamw_decays_leaves_of_two_or_more_dims():
    """Zero gradients: the stacked (L, d) norm and the matrices shrink by
    ``lr * weight_decay``; the unstacked (d,) norm stays."""
    opt = toptim.AdamW(lr=0.1, weight_decay=0.5)
    p = tree.map_(torch.from_numpy, _tree(0))
    before = tree.map_(torch.clone, p)
    p, _, m = opt.update(tree.map_(torch.zeros_like, p), opt.init(p), p)
    assert float(m["grad_norm"]) == 0.0
    torch.testing.assert_close(p["final_ln"], before["final_ln"], rtol=0,
                               atol=0)
    torch.testing.assert_close(p["embed"], before["embed"] * 0.95)
    for key in ("ln1", "w1"):
        torch.testing.assert_close(p["g_blocks"][key],
                                   before["g_blocks"][key] * 0.95)


def test_adafactor_factors_every_stacked_leaf():
    """A stacked (L, d) norm gets ``vr`` (L,) and one ``vc`` (d,) that its
    layers share; the unstacked (d,) norm a full ``v``."""
    fac = toptim.Adafactor().init(tree.map_(torch.from_numpy,
                                            _tree(0)))["fac"]
    assert fac["g_blocks"]["ln1"]["vr"].shape == (L,)
    assert fac["g_blocks"]["ln1"]["vc"].shape == (D,)
    assert fac["g_blocks"]["w1"]["vr"].shape == (L, D)
    assert fac["g_blocks"]["w1"]["vc"].shape == (L, F)
    assert fac["final_ln"]["v"].shape == (D,)


def test_master_weights_are_copies():
    """The f32 master weights of f32 parameters are their own tensors."""
    p = tree.map_(torch.from_numpy, _tree(0))
    st = toptim.AdamW(master_weights=True).init(p)
    assert st["master"]["embed"].data_ptr() != p["embed"].data_ptr()


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50, 99, 100, 150])
def test_cosine_warmup_matches_the_reference(step):
    want = joptim.cosine_warmup(1.0, warmup=10, total=100)(jnp.asarray(step))
    got = toptim.cosine_warmup(1.0, warmup=10, total=100)(step)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "adamw_master"])
def test_optimizer_minimises_quadratic(name):
    """The counterpart of the reference's quadratic test: 200 steps on
    |w|^2 + b^2."""
    opt = {"adamw": toptim.AdamW(lr=0.05),
           "adafactor": toptim.Adafactor(
               lr=lambda s: 0.5 / torch.sqrt(1.0 + s.float())),
           "adamw_master": toptim.AdamW(lr=0.05, master_weights=True)}[name]
    params = {"w": torch.tensor([1.0, -2.0, 3.0]), "b": torch.tensor(0.5)}
    state = opt.init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"], "b": 2 * params["b"]}
        params, state, _ = opt.update(g, state, params)
    assert float((params["w"] ** 2).sum() + params["b"] ** 2) < 1e-2


def test_get_optimizer_drops_master_weights_for_adafactor():
    assert isinstance(toptim.get_optimizer("adafactor", master_weights=True),
                      toptim.Adafactor)
    assert toptim.get_optimizer("adamw", master_weights=True).master_weights
    with pytest.raises(ValueError):
        toptim.get_optimizer("sgd")


def test_bf16_numpy_round_trip():
    t = torch.randn(5, 3).bfloat16()
    assert torch.equal(from_numpy(to_numpy(t)).view(torch.int16),
                       t.view(torch.int16))
