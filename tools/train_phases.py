"""``chip_smoke.py``'s training phases alone, from a source tree: to
compare two versions of the train step on the card within one call.

    python3 tools/train_phases.py [TREE]

imports ``chip_smoke`` and ``repro_torch`` from ``TREE`` (default: this
checkout), builds the Lloyd kernel, and runs ``train_one_device``, then
``train_sharded`` against it, then ``train_llama3_8b`` (the ``Trainer``'s
1 x 1 step, its checkpoint and restart), each emitting its JSON line; it
prints one last line, ``{"tree": ..., "summary": {...}}``, with each
phase's step wall (and the sharded step's warm one), idle share,
launches, device-busy seconds and peak GB.  To compare a
parent with a change, unpack the parent with ``git archive`` into a
directory ``.gitignore`` lists and run parent, change, change, parent in
one command on the card (each run about 2.5 minutes).
"""
import json
import sys
from pathlib import Path


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    tree = Path(argv[0] if argv else Path(__file__).resolve().parents[1])
    tree = tree.resolve()
    sys.path.insert(0, str(tree))
    sys.path.insert(0, str(tree / "src"))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    assert Path(cs.__file__).resolve().parent == tree, cs.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(["lloyd", "assign", "centroid"])
    one, base = cs.train_one_device()
    sharded, _ = cs.train_sharded(base)
    del base
    torch.cuda.empty_cache()
    trainer, _ = cs.train_llama3_8b()

    def brief(fields):
        prof = fields.get("step_profile", {})
        return dict(step_wall_s=fields["step_wall_s"],
                    warm_step_wall_s=fields.get("warm_step_wall_s"),
                    idle_share=fields.get("idle_share",
                                          prof.get("idle_share")),
                    launches=prof.get("device_launches"),
                    busy_s=prof.get("device_busy_s"),
                    peak_gb=fields["peak_gb"])

    print(json.dumps({"tree": str(tree), "summary": {
        "train_one_device": dict(step_wall_s=one["step_wall_s"],
                                 peak_gb=one["peak_gb"]),
        "train_sharded": brief(sharded),
        "train_llama3_8b": brief(trainer)}}), flush=True)


if __name__ == "__main__":
    main()
