"""Optimizers of the port (the counterpart of :mod:`repro.optim`): AdamW
with f32 moments (and optional f32 master weights) and Adafactor
(factored second moments), over the reference's nested tree of stacked
leaves (:func:`repro_torch.convert.lm_params_to_stacked`), so every
per-leaf rule (decay by ``ndim``, factoring, the RMS clip) sees the
shapes the reference's does.  Plain tensor code: the reference has no
kernel here."""
from .adafactor import Adafactor
from .adamw import AdamW
from .schedule import cosine_warmup

__all__ = ["AdamW", "Adafactor", "cosine_warmup", "get_optimizer"]


def get_optimizer(name: str, **kw):
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        kw.pop("master_weights", None)  # adamw-only knob
        return Adafactor(**kw)
    raise ValueError(name)
