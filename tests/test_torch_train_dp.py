"""The port's data-parallel train step against the JAX package's
one-device step, on the CPU in f32, for the six decoder families (reduced
llama3-8b, gemma3-12b, dbrx-132b, internvl2-2b, xlstm-1.3b and
zamba2-2.7b), on meshes of W = 1, 2 and 4 shards that repeat the CPU.

Each shard takes whole micro-batches, so every W computes the reference's
step up to the order of the gradients' additions; a step starts from the
reference's state carried across and is held under
``test_torch_train._compare_step``'s rule for Adafactor (loss at rtol
1e-6, every parameter at rtol 1e-5, atol 1e-6; factored moments at rtol
1e-4).  The optimizer is Adafactor: AdamW's first step sends a
rounding-level gradient entry anywhere within 2 lr (ROADMAP §3), and the
reduced gemma and xlstm trees have 1-2 such entries in leaves of 128,
past the AdamW rule's 0.1% of a leaf, at W = 1 as in the one-device
step.  On a mesh the whole state is read as one block a leaf and every
shard adds its micro-batches' gradients into the one accumulator in
micro-batch order, so every W is the one-device step bit for bit; AdamW
with master weights runs in the compressor and trainer cases."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import ShapeConfig as JShape
from repro.configs import get_config as jget_config
from repro.models.registry import build_model as jbuild_model
from repro.train.step import TrainPlan as JPlan
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import optim as toptim
from repro_torch import tree
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.convert import bind_stacked, stacked_params, \
    train_state_from_jax
from repro_torch.core.blocks import gather_tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.train.step import TrainPlan, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_train import LR, _compare_step

ARCHS = ["llama3-8b", "gemma3-12b", "dbrx-132b", "internvl2-2b",
         "xlstm-1.3b", "zamba2-2.7b"]
SEQ, BATCH, N_MICRO, CHUNK = 16, 4, 4, 8


def _batch(cfg, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ)
                                    ).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (BATCH, SEQ)
                                    ).astype(np.int32)}
    if cfg.n_patches:
        batch["patches"] = rng.normal(
            size=(BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """(state before, state after, metrics, batch) of the reference's
    jitted one-device Adafactor step with ``N_MICRO`` micro-batches, as
    numpy."""
    jcfg = jget_config(arch).reduced()
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jopt = joptim.Adafactor(lr=LR)
    js = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jmake_train_step(jm, jopt, jcfg,
                                     JShape("t", SEQ, BATCH, "train"),
                                     JPlan(n_micro=N_MICRO, q_chunk=CHUNK)))
    batch = _batch(get_config(arch).reduced())
    js2, jmet = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree.map(np.asarray, js), jax.tree.map(np.asarray, js2),
            jax.tree.map(np.asarray, jmet), batch)


def _port_step(arch: str, w, compress_fn=None, n_micro=N_MICRO,
               opt_name="adamw"):
    """The port's step function for ``arch`` on a mesh of ``w`` CPU shards
    (``None``: no mesh)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    opt = (toptim.AdamW(lr=LR, master_weights=True) if opt_name == "adamw"
           else toptim.Adafactor(lr=LR))
    mesh = None if w is None else make_host_mesh(w, 1, device="cpu")
    return make_train_step(model, opt, cfg, ShapeConfig("t", SEQ, BATCH,
                                                        "train"),
                           TrainPlan(n_micro=n_micro, q_chunk=CHUNK),
                           compress_fn=compress_fn, mesh=mesh)


def _carried(js) -> dict:
    return train_state_from_jax(js, device="cpu")


def _adamw_state(js) -> dict:
    """The reference's parameters carried across, with the port's AdamW
    state (master weights) over them, at step 0."""
    params = _carried({"params": js["params"]})["params"]
    opt = toptim.AdamW(lr=LR, master_weights=True)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()]) if t.is_floating_point() else t


def _differ(a, b) -> list:
    """The keys where two states differ in bits (a state in the block
    layout gathered whole first)."""
    fa, fb = (dict(tree.items(gather_tree(t, "cpu"))) for t in (a, b))
    assert fa.keys() == fb.keys()
    return [tree.key_of(p) for p in fa
            if fa[p].dtype != fb[p].dtype
            or not torch.equal(_bits(fa[p]), _bits(fb[p]))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the reduced models' ops are tiny, and the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _port_result(arch: str, w):
    """The port's Adafactor step on ``w`` shards (``None``: no mesh) from
    the reference's state carried across: (state, metrics)."""
    js, _, _, batch = _reference(arch)
    return _port_step(arch, w, opt_name="adafactor")(_carried(js), batch)


@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_data_parallel_step_matches_the_reference(arch, w):
    js, js2, jmet, _ = _reference(arch)
    _compare_step("adafactor", js, js2, jmet, *_port_result(arch, w))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_shard_and_one_micro_a_shard_are_the_one_device_step(arch):
    """W = 1 is today's step bit for bit (loss, parameters, optimizer
    state); so is W = n_micro against W = 1 with an MoE's capacity and aux
    loss taken over each whole micro-batch."""
    want, wmet = _port_result(arch, None)
    for w in (1, N_MICRO):
        got, gmet = _port_result(arch, w)
        assert torch.equal(_bits(gmet["loss"]), _bits(wmet["loss"])), w
        assert _differ(got, want) == [], w


def test_compress_fn_runs_once_on_the_summed_gradient():
    """The hook sees one tree a step, the global gradient: the same as the
    one-device step's (rtol 1e-6: the shards' sums are added in another
    order)."""
    js, _, _, batch = _reference("llama3-8b")
    seen = {}

    def hook(key):
        def compress(grads):
            seen.setdefault(key, []).append(
                tree.map_(lambda g: g.clone(), grads))
            return grads
        return compress

    _port_step("llama3-8b", None, hook("one"))(_adamw_state(js), batch)
    _port_step("llama3-8b", 2, hook("dp"))(_adamw_state(js), batch)
    assert len(seen["one"]) == len(seen["dp"]) == 1
    for (path, a), b in zip(tree.items(seen["one"][0]),
                            tree.leaves(seen["dp"][0])):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(a.abs().max()) + 1e-30,
                                   err_msg=tree.key_of(path))


@pytest.mark.parametrize("n_micro,w", [(2, 4), (3, 2), (4, 3)])
def test_a_plan_the_shards_do_not_divide_raises(n_micro, w):
    with pytest.raises(ValueError, match=f"n_micro={n_micro}"):
        _port_step("llama3-8b", w, n_micro=n_micro)


def test_replica_models_bind_to_their_parameters():
    """A model built on ``meta``, its storage allocated on a device, then
    bound to a copied tree (:func:`~repro_torch.convert.bind_stacked`)
    computes the model's loss from that tree."""
    cfg = get_config("zamba2-2.7b").reduced()
    model = build_model(cfg, device="cpu").init_params(3)
    params = stacked_params(model)
    replica = build_model(cfg, device="meta").to_empty(device="cpu")
    copy = tree.map_(lambda t: t.clone(), params)
    bind_stacked(replica, copy)
    assert replica.embed.data_ptr() == copy["embed"].data_ptr()
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        assert torch.equal(replica.loss(batch), model.loss(batch))


def _trainer(steps, ckpt_dir, n_data):
    cfg = get_config("llama3-8b").reduced()
    tc = TrainerConfig(steps=steps, ckpt_every=2, ckpt_dir=str(ckpt_dir),
                       log_every=100)
    return Trainer(cfg, ShapeConfig("tiny", 32, 4, "train"),
                   make_host_mesh(n_data, 1, device="cpu"), tc,
                   plan=TrainPlan(n_micro=2, q_chunk=32))


def test_a_two_shard_checkpoint_restores_on_one_shard(tmp_path):
    """The state written at W = 2 restores bit for bit at W = 1, and a
    further step gives the same bits on either mesh (one micro-batch a
    shard)."""
    state, hist = _trainer(2, tmp_path, 2).run()
    assert len(hist) == 2 and all(np.isfinite(hist))
    one, two = _trainer(3, tmp_path, 1), _trainer(3, tmp_path, 2)
    restored, start = one.restore_or_init()
    assert start == 2 and _differ(restored, state) == []
    again, _ = two.restore_or_init()
    batch = one.batch_fn(2)
    s1, m1 = one.train_step(restored, batch)
    s2, m2 = two.train_step(again, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    assert _differ(s1, s2) == []
    assert tckpt.steps(tmp_path) == [2]
