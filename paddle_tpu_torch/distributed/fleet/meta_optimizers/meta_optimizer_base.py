"""MetaOptimizerBase (counterpart of paddle_tpu's)."""

from __future__ import annotations


class MetaOptimizerBase:
    def __init__(self, optimizer):
        self.inner_opt = optimizer
        self.meta_optimizers_white_list = []
        self.meta_optimizers_black_list = []

    def _set_basic_info(self, loss, role_maker, user_defined_optimizer,
                        user_defined_strategy):
        self.loss = loss
        self.role_maker = role_maker
        self.user_defined_optimizer = user_defined_optimizer
        self.user_defined_strategy = user_defined_strategy

    def _can_apply(self) -> bool:
        return False

    def _disable_strategy(self, dist_strategy):
        pass

    def _enable_strategy(self, dist_strategy, context=None):
        pass

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return self.inner_opt.backward(loss, startup_program,
                                       parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        return self.inner_opt.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.inner_opt.apply_gradients(params_grads)

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        return self.inner_opt.minimize(loss, startup_program,
                                       parameter_list, no_grad_set)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return self.minimize_impl(loss, startup_program, parameter_list,
                                  no_grad_set)

    def __getattr__(self, item):
        return getattr(self.inner_opt, item)
