"""How far the train step computed over the "model" axis parts from the
one-device step in bf16, and why: a diagnostic for the card.

At ``chip_smoke.py``'s training configuration (llama3-8b at full width,
2 of its 32 layers, bf16 from seed 0, AdamW, 8 x 512 tokens) it runs the
one-device step (``chip_smoke.train_one_device``) and then measures each
leaf's AdamW first moment (the step's gradient times 1 - beta1) by its
relative Frobenius distance to the one-device step's, for:

* ``f32``: the one-device step in f32 from the same bf16 weights (each
  bf16 step's own distance from it);
* ``one_ulp``: the one-device step with one weight entry moved by one
  bf16 ulp (how far any change of rounding carries);
* ``full``: the sharded step on the 2 x 2 mesh (``chip_smoke.train_sharded``),
  and the same step with only the head, only the attention or only the
  FFN split over "model", with the row-split products (``wo``, ``w2``)
  or the column-split ones computed as one product over all positions'
  weights (``rows_whole``, ``cols_whole``), and with both and the head
  whole (``products_whole``: what is left is the collectives and the
  per-position attention).

At ``chip_smoke.py``'s MoE configuration (dbrx-132b at full width, 1
of its 40 layers, bf16 from seed 0, Adafactor with bf16 gradients, 8 x
512 tokens; ``chip_smoke.train_moe_one_device``) it measures each leaf's
Adafactor second moments (``vr``, ``vc``, ``v``: the squared gradient's
row and column means after the first step) by their relative Frobenius
distance to the one-device step's, and the largest parameter difference
in units of lr, for:

* ``dbrx_one_ulp``: the one-device step with one ``attn.wq`` entry moved
  by one bf16 ulp;
* ``dbrx_experts_only``: the sharded step on the 2 x 2 mesh with only the
  experts split over "model" (``chip_smoke.train_moe_sharded``);
* ``dbrx_full``: the same step with the experts, attention and the head
  split.

At ``chip_smoke.py``'s recurrent configurations (xlstm-1.3b and
zamba2-2.7b at full width, one superblock each, bf16 from seed 0, AdamW
with f32 master weights, 8 x 512 tokens;
``chip_smoke.train_recurrent_one_device``) it measures each leaf's AdamW
first moment against the one-device step's, the loss and gradient norm
relative errors and the largest parameter difference in units of lr,
for:

* ``xlstm_one_ulp`` / ``zamba2_one_ulp``: the one-device step with one
  entry of the first mLSTM's ``wq`` (the first Mamba2's ``in_proj``)
  moved by one bf16 ulp;
* ``xlstm_recurrent_only`` / ``zamba2_recurrent_only``: the sharded step
  on the 2 x 2 mesh with only the recurrent blocks split over "model"
  (``chip_smoke.train_recurrent_sharded`` with zamba2's shared attention
  and the head computed whole, so its per-position byte check fails by
  design and is listed under ``full_phase_failures``);
* ``xlstm_full`` / ``zamba2_full``: the same step with the recurrent
  blocks, zamba2's shared attention and the head split;
* ``xlstm_full_f32`` / ``zamba2_full_f32``: that step and the one-device
  step it is held against both in f32 (the weights the same seed-0 draws
  in f32): how far the split carries where no bf16 rounding moves.

``chip_smoke.REC_LIMITS`` are twice the ``*_full`` and ``*_full_f32``
readings.

At ``chip_smoke.py``'s whisper configuration (whisper-base at full width
and depth, 6 + 6 layers, 1500 frames, bf16 from seed 0, AdamW with f32
master weights, 8 x 4096 tokens in 2 micro-batches;
``chip_smoke.train_whisper_one_device``) it measures the same rows for:

* ``whisper_ulp``: the one-device step with one entry of the first
  decoder layer's ``attn.wq`` moved by one bf16 ulp;
* ``whisper_full``: the sharded step on the 2 x 2 mesh
  (``chip_smoke.train_whisper_sharded``: the encoder and decoder layers,
  the cross attention and the head over "model");
* ``whisper_full_f32``: that step and its one-device step both in f32.

``chip_smoke.WHISPER_LIMITS`` are twice the ``whisper_full`` and
``whisper_full_f32`` readings.

Run it on the card (about 3 minutes for llama, 2 for dbrx, 2.5 for xlstm
or zamba2, 1 for whisper)::

    python3 tools/model_axis_noise.py [--only MODEL] [OUT]

with MODEL one of ``llama``, ``dbrx``, ``xlstm``, ``zamba2``, ``whisper``.

It prints one JSON line a case and writes them all to ``OUT`` (default
``build/model_axis_noise.json``).
"""
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

REAL_WHOLE_TRAIN_STATE = cs.whole_train_state


def moments_against(m, kept) -> dict:
    """Each leaf's relative Frobenius distance of first moments ``m``
    (on the card, or sharded) to ``kept``'s (on the host)."""
    from repro_torch import tree
    out = {}
    for path, s in tree.items(m):
        a = cs.on_card(s).float()
        b = tree.get(kept, path).to(a.device).float()
        if float(b.norm()):
            out[tree.key_of(path)] = float((a - b).norm() / b.norm())
    return out


def one_device_m(cfg, dtype: str, nudge: bool) -> dict:
    """The first moments of the one-device step from the seed-0 bf16
    weights, computed in ``dtype``; ``nudge`` moves one entry of the
    first layer's ``wq`` by one bf16 ulp first."""
    from repro_torch import tree
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import token_stream
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train.step import TrainPlan, make_train_step
    opt = AdamW(master_weights=True)
    model, state = cs.whole_train_state(cfg, opt)
    if nudge:
        state["params"]["g_blocks"]["attn"]["wq"].view(torch.int16)[
            0, 3, 5] += 1
    if dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        params = tree.map_(lambda t: t.to(getattr(torch, dtype)),
                           state["params"])
        del model, state
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device="cuda")}
        model = build_model(cfg, device="meta").to_empty(device="cuda")
    step = make_train_step(model, opt, cfg,
                           ShapeConfig("t", cs.TRAIN_SEQ, cs.TRAIN_BATCH,
                                       "train"),
                           TrainPlan(n_micro=cs.TRAIN_MICRO, q_chunk=512))
    state, _ = step(state, token_stream(0, cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                                        cfg.vocab, seed=0))
    m = state["opt"]["m"]
    del state, model, step
    return m


def dbrx_cases(record) -> None:
    """The MoE configuration's cases (the module docstring), each
    recorded as its second moments' distances and its largest parameter
    difference in lr."""
    _, base = cs.train_moe_one_device()
    torch.cuda.empty_cache()
    _, nudged = cs.train_moe_one_device(nudge=True)
    nudged_drops = nudged["drops"]
    torch.cuda.empty_cache()
    rows = cs.sharded_vs_one_device(
        {k: tree_on_card(nudged["state"][k]) for k in ("params", "opt")},
        base["state"], base["lr"], cs.MOE_MOMENT_REL, cs.MOE_PARAM_LR)
    del nudged
    record("dbrx_one_ulp", rows["moment_rel_errs"],
           param_err_lr=rows["param_err_lr"], param_leaf=rows["param_leaf"],
           drops=nudged_drops, drops_one_device=base["drops"])
    for name, experts_only in (("dbrx_experts_only", True),
                               ("dbrx_full", False)):
        fields = cs.train_moe_sharded(base, experts_only=experts_only)
        record(name, dict(fields["state"]["moment_rel_errs"]),
               param_err_lr=fields["state"]["param_err_lr"],
               param_leaf=fields["state"]["param_leaf"],
               drops=fields["drops"], drops_one_device=base["drops"])
        torch.cuda.empty_cache()


@contextlib.contextmanager
def patched(obj, name: str, value):
    """Within ``with``: ``obj.name`` is ``value``."""
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


def nudge(params) -> None:
    """Move one entry of the first block's first product, which every
    token's path crosses, by one bf16 ulp: the first mLSTM's ``wq``, the
    first Mamba2's ``in_proj``, whisper's first decoder layer's
    ``attn.wq``."""
    if "dec" in params:
        params["dec"]["attn"]["wq"].view(torch.int16)[0, 3, 5] += 1
        return
    group = params["g_super"]
    w = group["mlstm"]["wq"] if "mlstm" in group else group["mamba"][
        "in_proj"]
    w.view(torch.int16)[0, 0, 3, 5] += 1


def nudged_state(cfg, opt):
    """``chip_smoke.whole_train_state`` with :func:`nudge` applied to its
    parameters."""
    model, state = REAL_WHOLE_TRAIN_STATE(cfg, opt)
    nudge(state["params"])
    return model, state


def recurrent_only_regions():
    """Within ``with``: the models split only the recurrent blocks over
    "model" (zamba2's shared attention and the head computed whole on
    each data shard's first position)."""
    from repro_torch.models import lm
    regions = lm.DecoderLM.split_regions

    def recurrent(self, n):
        return {k: v for k, v in regions(self, n).items()
                if any(b in k for b in (".mlstm.", ".slstm.", ".mamba."))}

    stack = contextlib.ExitStack()
    stack.enter_context(patched(lm.DecoderLM, "split_regions", recurrent))
    stack.enter_context(patched(lm.AttnBlock, "split_regions",
                                lambda self, n: {}))
    return stack


def recurrent_cases(arch: str, record, stage: list) -> None:
    """The recurrent configuration's cases for ``arch`` (the module
    docstring), each recorded as its first moments' distances, the loss
    and norm errors and its largest parameter difference in lr; ``stage``
    names the case being run."""
    name = arch.split("-")[0]
    bf16 = "bfloat16"
    stage[:] = [f"{name}_one_device"]
    _, base = cs.train_recurrent_one_device(arch, bf16, False)
    torch.cuda.empty_cache()
    stage[:] = [f"{name}_one_ulp"]
    with patched(cs, "whole_train_state", nudged_state):
        _, nudged = cs.train_recurrent_one_device(arch, bf16, False)
    torch.cuda.empty_cache()
    rows = cs.sharded_vs_one_device(
        {k: tree_on_card(nudged["state"][k]) for k in ("params", "opt")},
        base["state"], base["lr"])
    record(f"{name}_one_ulp", rows["moment_rel_errs"],
           param_err_lr=rows["param_err_lr"], param_leaf=rows["param_leaf"],
           loss_rel_err=rel_err(nudged["loss"], base["loss"]),
           grad_norm_rel_err=rel_err(nudged["grad_norm"], base["grad_norm"]))
    del nudged
    torch.cuda.empty_cache()
    stage[:] = [f"{name}_recurrent_only"]
    with recurrent_only_regions():
        record_sharded(stage[0], cs.train_recurrent_sharded(
            arch, bf16, base, False), record)
    stage[:] = [f"{name}_full"]
    record_sharded(stage[0], cs.train_recurrent_sharded(arch, bf16, base,
                                                        False), record)
    del base
    torch.cuda.empty_cache()
    stage[:] = [f"{name}_full_f32"]
    _, base = cs.train_recurrent_one_device(arch, "float32", False)
    torch.cuda.empty_cache()
    record_sharded(stage[0], cs.train_recurrent_sharded(arch, "float32",
                                                        base, False), record)


def whisper_cases(record, stage: list) -> None:
    """The whisper configuration's cases (the module docstring), each
    recorded as its first moments' distances, the loss and norm errors
    and its largest parameter difference in lr; ``stage`` names the case
    being run."""
    stage[:] = ["whisper_one_device"]
    base = cs.train_whisper_one_device("bfloat16")
    stage[:] = ["whisper_ulp"]
    with patched(cs, "whole_train_state", nudged_state):
        nudged = cs.train_whisper_one_device("bfloat16")
    rows = cs.sharded_vs_one_device(
        {k: tree_on_card(nudged["state"][k]) for k in ("params", "opt")},
        base["state"], base["lr"])
    record("whisper_ulp", rows["moment_rel_errs"],
           param_err_lr=rows["param_err_lr"], param_leaf=rows["param_leaf"],
           loss_rel_err=rel_err(nudged["loss"], base["loss"]),
           grad_norm_rel_err=rel_err(nudged["grad_norm"], base["grad_norm"]))
    del nudged, rows
    torch.cuda.empty_cache()
    stage[:] = ["whisper_full"]
    record_sharded(stage[0], cs.train_whisper_sharded("bfloat16", base,
                                                      False), record)
    del base
    stage[:] = ["whisper_full_f32"]
    base = cs.train_whisper_one_device("float32")
    record_sharded(stage[0], cs.train_whisper_sharded("float32", base,
                                                      False), record)


def record_sharded(name: str, fields: dict, record) -> None:
    """Record a sharded step's distances from its baseline (a recurrent
    or a whisper step's fields)."""
    record(name, fields["state"]["moment_rel_errs"],
           param_err_lr=fields["state"]["param_err_lr"],
           param_leaf=fields["state"]["param_leaf"],
           loss_rel_err=fields["loss_rel_err"],
           grad_norm_rel_err=fields["grad_norm_rel_err"],
           from_model_adds=fields["gather"]["from_model_adds"])
    torch.cuda.empty_cache()


def rel_err(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def tree_on_card(t):
    """A host tree of tensors copied onto the card."""
    from repro_torch import tree
    return tree.map_(lambda x: x.to("cuda"), t)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv[:1] == ["--only"]:
        only, argv = argv[1], argv[2:]
    out = Path(argv[0] if argv else ROOT / "build" / "model_axis_noise.json")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import lm
    from repro_torch.models.layers import dot
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("card:", smi, flush=True)
    failed, stage = [], ["dbrx"]
    cs.check = lambda cond, what: cond or failed.append(
        f"{stage[0]}: {what[:400]}")
    cases = []

    def record(name, rows, **more):
        cases.append(dict(case=name, max=max(rows.values()),
                          leaf=max(rows, key=rows.get), **more, rows=rows))
        print(json.dumps(cases[-1]), flush=True)

    def write():
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            dict(card=smi, cases=cases, full_phase_failures=failed),
            indent=1))

    if only in (None, "dbrx"):
        dbrx_cases(record)
        write()
    for arch in ("xlstm-1.3b", "zamba2-2.7b"):
        if only in (None, arch.split("-")[0]):
            recurrent_cases(arch, record, stage)
            write()
    if only in (None, "whisper"):
        whisper_cases(record, stage)
        write()
    if only not in (None, "llama"):
        return
    stage[:] = ["llama"]
    build.build(["lloyd", "assign", "centroid"])
    _, base = cs.train_one_device()
    kept = base["state"]["opt"]["m"]
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=cs.TRAIN_LAYERS)

    record("f32", moments_against(one_device_m(cfg, "float32", False), kept))
    torch.cuda.empty_cache()
    record("one_ulp", moments_against(one_device_m(cfg, cfg.dtype, True),
                                      kept))
    torch.cuda.empty_cache()

    regions = lm.DecoderLM.split_regions, lm.AttnBlock.split_regions
    products = lm.over_rows, lm.over_columns

    def rows_whole(split, xs, ws):
        return dot(torch.cat(xs, -1), torch.cat(ws, 0))

    def cols_whole(split, x, ws, out_f32=False):
        if out_f32:
            return products[1](split, x, ws, out_f32)
        y = dot(x, torch.cat(ws, 1))
        return list(y.split([w.shape[1] for w in ws], -1))

    def no_head(self, n):
        return {k: v for k, v in regions[0](self, n).items() if k != "head"}

    def block_only(attn: bool):
        return lambda self, n: {k: v for k, v in regions[1](self, n).items()
                                if k.startswith("attn.") == attn}

    variants = {
        "full": {},
        "head_only": {"block": lambda self, n: {}},
        "attn_only": {"model": no_head, "block": block_only(True)},
        "ffn_only": {"model": no_head, "block": block_only(False)},
        "rows_whole": {"rows": rows_whole},
        "cols_whole": {"cols": cols_whole},
        "products_whole": {"model": no_head, "rows": rows_whole,
                           "cols": cols_whole},
    }
    seen = {}
    real = cs.sharded_vs_one_device

    def capture(state, kept_state, lr, *limits):
        seen["rows"] = moments_against(state["opt"]["m"],
                                       kept_state["opt"]["m"])
        return real(state, kept_state, lr, *limits)

    cs.sharded_vs_one_device = capture
    try:
        for name, v in variants.items():
            lm.DecoderLM.split_regions = v.get("model", regions[0])
            lm.AttnBlock.split_regions = v.get("block", regions[1])
            lm.over_rows = v.get("rows", products[0])
            lm.over_columns = v.get("cols", products[1])
            cs.train_sharded(base)
            record(name, seen["rows"])
    finally:
        lm.DecoderLM.split_regions, lm.AttnBlock.split_regions = regions
        lm.over_rows, lm.over_columns = products
        cs.sharded_vs_one_device = real
    write()


if __name__ == "__main__":
    main()
