"""Training (port of ``repro.train``)."""

from repro_torch.train.step import make_grad_fn, make_loss_fn, make_train_step

__all__ = ["make_loss_fn", "make_grad_fn", "make_train_step"]
