from .loss import lm_loss
from .step import make_decode_step, make_loss_fn, make_prefill_step, make_train_step

__all__ = [
    "lm_loss", "make_decode_step", "make_loss_fn", "make_prefill_step",
    "make_train_step",
]  # fmt: skip
