"""Training of the port: the optimizers and the train step
(`repro.training` in PyTorch, unsharded or on a mesh of slots)."""
from .optimizer import OptHParams, global_norm, make_optimizer, schedule
from .train_step import (TrainHParams, abstract_train_state, make_grad_fn,
                         make_positions, make_train_step, make_update_fn,
                         train_state_init, train_state_pspecs)

__all__ = ["OptHParams", "make_optimizer", "schedule", "global_norm",
           "TrainHParams", "make_grad_fn", "make_train_step",
           "make_update_fn", "train_state_init", "make_positions",
           "abstract_train_state", "train_state_pspecs"]
