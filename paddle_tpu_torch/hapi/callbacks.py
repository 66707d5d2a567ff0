"""``hapi`` callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``):
``Callback``, ``ProgBarLogger`` (to stderr), ``EarlyStopping`` (sets
``model.stop_training`` after ``patience`` evaluations without a gain)
and ``LRScheduler`` (steps the optimizer's scheduler by batch or by
epoch; ``ReduceOnPlateau`` by epoch, on the evaluation loss)."""
from __future__ import annotations

import sys
import time

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "EarlyStopping", "LRScheduler"]


class Callback:
    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(
                f"{k}: {np.asarray(v).round(4)}" for k, v in (logs or {}).items()
            )
            print(f"step {step}: {items}", file=sys.stderr)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            items = " - ".join(
                f"{k}: {np.asarray(v).round(4)}" for k, v in (logs or {}).items()
            )
            print(
                f"Epoch {epoch}: {items} ({time.time() - self._t0:.1f}s)",
                file=sys.stderr,
            )


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.is_better = lambda cur, best: cur > best + self.min_delta
            self.best = -np.inf
        else:
            self.is_better = lambda cur, best: cur < best - self.min_delta
            self.best = np.inf

    def on_eval_end(self, logs=None):
        logs = logs or {}
        # evaluate() prefixes its keys with "eval_"; accept both spellings
        cur = logs.get(self.monitor, logs.get(f"eval_{self.monitor}"))
        if cur is None:
            return
        cur = float(np.asarray(cur).reshape(-1)[0])
        if self.is_better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched

        lr = getattr(self.model._optimizer, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def _step(self, s, logs):
        from ..optimizer.lr import ReduceOnPlateau

        if isinstance(s, ReduceOnPlateau):
            metric = (logs or {}).get("eval_loss", (logs or {}).get("loss"))
            if metric is not None:
                s.step(metric)
            return
        s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            from ..optimizer.lr import ReduceOnPlateau

            if not isinstance(s, ReduceOnPlateau):  # plateau is epoch-wise
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            self._step(s, logs)
