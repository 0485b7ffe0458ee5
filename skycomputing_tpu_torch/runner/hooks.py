"""mmcv-style lifecycle hooks (the port's copy of
``skycomputing_tpu/runner/hooks.py``).

The ``*_val_*`` variants default to no-ops instead of falling through to
the generic ``before/after_epoch``/``iter`` handlers, so a hook that
acts on training iterations does not fire again during evaluation.
"""

from __future__ import annotations


class Hook:
    def before_run(self, runner):
        pass

    def after_run(self, runner):
        pass

    def before_epoch(self, runner):
        pass

    def after_epoch(self, runner):
        pass

    def before_iter(self, runner):
        pass

    def after_iter(self, runner):
        pass

    def before_train_epoch(self, runner):
        self.before_epoch(runner)

    def before_val_epoch(self, runner):
        pass

    def after_train_epoch(self, runner):
        self.after_epoch(runner)

    def after_val_epoch(self, runner):
        pass

    def before_train_iter(self, runner):
        self.before_iter(runner)

    def before_val_iter(self, runner):
        pass

    def after_train_iter(self, runner):
        self.after_iter(runner)

    def after_val_iter(self, runner):
        pass

    # NOTE: the Runner increments epoch/iter BEFORE dispatching after_*
    # hooks, so inside a hook these counters already equal the number of
    # COMPLETED epochs/iters — test divisibility directly.
    def every_n_epochs(self, runner, n):
        return runner.epoch % n == 0 if n > 0 else False

    def every_n_inner_iters(self, runner, n):
        return runner.inner_iter % n == 0 if n > 0 else False

    def every_n_iters(self, runner, n):
        return runner.iter % n == 0 if n > 0 else False

    def end_of_epoch(self, runner):
        return runner.inner_iter + 1 == len(runner.data_loader)


__all__ = ["Hook"]
