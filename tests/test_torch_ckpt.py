"""The port's checkpoints: its own round trip, the atomic commit, and the
files of each package read by the other (f32 both ways, bit for bit; bf16
leaves, which the reference writes as ``|V2`` bit patterns and cannot read
back, read by the port bit for bit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro_torch import tree
from repro_torch.ckpt import checkpoint as tckpt


def _state(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"embed": torch.randn(6, 4, generator=g).to(dtype),
                       "g_blocks": {"ln1": torch.randn(2, 4, generator=g)
                                    .to(dtype)}},
            "opt": {"m": {"embed": torch.randn(6, 4, generator=g)},
                    "fac": {"w": {"vr": torch.randn(3, generator=g)}}},
            "step": torch.tensor(7, dtype=torch.int32)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _assert_bitwise(got, want):
    assert sorted(tree.key_of(p) for p, _ in tree.items(got)) == \
        sorted(tree.key_of(p) for p, _ in tree.items(want))
    for (path, g), w in zip(tree.items(got), tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(_bits(g), _bits(w)), path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_roundtrip(tmp_path, dtype):
    state = _state(dtype=dtype)
    final = tckpt.save(tmp_path, 7, state, extra={"note": "x"})
    assert final.name == "step_00000007"
    assert tckpt.latest_step(tmp_path) == 7 and tckpt.steps(tmp_path) == [7]
    like = tree.map_(lambda t: t.to("meta"), state)
    restored, manifest = tckpt.restore(tmp_path, 7, like, device="cpu")
    _assert_bitwise(restored, state)
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"}
    assert manifest["keys"] == sorted(
        ["params/embed", "params/g_blocks/ln1", "opt/m/embed",
         "opt/fac/w/vr", "step"])
    with np.load(final / "arrays.npz") as data:
        want = "|V2" if dtype == torch.bfloat16 else "<f4"
        assert data["params/embed"].dtype.str == want


def test_checkpoint_atomic_partial_write_invisible(tmp_path):
    (tmp_path / ".tmp_step_00000009_123").mkdir(parents=True)
    assert tckpt.latest_step(tmp_path) is None
    assert tckpt.restore_latest(tmp_path, {}) == (None, None)
    tckpt.save(tmp_path, 4, _state())
    (tmp_path / ".tmp_step_00000009_456").mkdir()
    (tmp_path / "step_00000012").mkdir()         # no manifest: incomplete
    assert tckpt.steps(tmp_path) == [4]


def test_port_restores_a_reference_checkpoint(tmp_path):
    """An f32 state written by the JAX package's ``ckpt.save`` in this
    process, read by the port bit for bit."""
    state = _state(3)
    jstate = jax.tree.map(lambda t: jnp.asarray(t.numpy()), state)
    jckpt.save(tmp_path, 5, jstate)
    got, manifest = tckpt.restore(tmp_path, 5, state, device="cpu")
    _assert_bitwise(got, state)
    assert manifest["step"] == 5


def test_reference_restores_a_port_checkpoint(tmp_path):
    state = _state(4)
    tckpt.save(tmp_path, 6, state)
    jstate = jax.tree.map(lambda t: jnp.asarray(t.numpy()), state)
    like = jax.eval_shape(lambda: jstate)
    got, manifest = jckpt.restore(tmp_path, 6, like)
    for (path, w) in tree.items(state):
        g = np.asarray(tree.get(got, path))
        assert g.dtype == w.numpy().dtype
        np.testing.assert_array_equal(g, w.numpy())
    assert manifest["step"] == 6


def test_port_reads_the_reference_bf16_bits(tmp_path):
    """The reference writes a bf16 leaf as its ``|V2`` bit pattern and
    cannot restore it (a quirk kept as is); the port reads it bit for
    bit."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2 ** 16, (8, 5), dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0x3F80       # no inf/NaN patterns
    want = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    jstate = {"w": jnp.asarray(want.float().numpy()).astype(jnp.bfloat16)}
    jckpt.save(tmp_path, 1, jstate)
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as data:
        assert data["w"].dtype.str == "|V2"
    got, _ = tckpt.restore(tmp_path, 1, {"w": want}, device="cpu")
    assert torch.equal(_bits(got["w"]), _bits(want))
    with pytest.raises(ValueError):
        jckpt.restore(tmp_path, 1, jax.eval_shape(lambda: jstate))


def test_restore_refuses_missing_keys_and_shapes_as_the_reference(tmp_path):
    state = _state()
    tckpt.save(tmp_path, 2, state)
    for mutate in (lambda s: s["params"].update(extra=torch.zeros(3)),
                   lambda s: s["params"].update(embed=torch.zeros(6, 5))):
        like = _state()
        mutate(like)
        jlike = jax.eval_shape(lambda: jax.tree.map(
            lambda t: jnp.asarray(t.numpy()), like))
        with pytest.raises(ValueError) as want:
            jckpt.restore(tmp_path, 2, jlike)
        with pytest.raises(ValueError) as got:
            tckpt.restore(tmp_path, 2, like, device="cpu")
        assert str(got.value) == str(want.value)


def test_restore_places_meta_leaves_on_the_card_by_default(tmp_path,
                                                          monkeypatch):
    """A ``meta`` like leaf goes to the CUDA device unless ``device=`` says
    otherwise; without a card that raises."""
    tckpt.save(tmp_path, 1, {"w": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tckpt.restore(tmp_path, 1, {"w": torch.zeros(2, device="meta")})
