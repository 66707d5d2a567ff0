"""The high-level ``Model`` (counterpart of ``paddle_tpu/hapi/model.py``):
``prepare``, ``fit``, ``evaluate``, ``predict``, ``save``, ``load``,
``parameters`` and ``summary``.

``fit`` drives ``jit.TrainStep`` over the network, as the JAX ``Model``
drives its staged step. Every batch goes to the network's device (the
card, unless the network was built with ``device="cpu"``): a dataset is
batched by a ``DataLoader`` that delivers there; a ``DataLoader`` given
as it is has its batches moved. Host syncs: a ``fit`` step makes one,
the read of its loss (``loss.item()``, as the JAX ``Model`` reads
``float(loss.numpy())``) that the callbacks and the history take; an
evaluation batch one for its loss and one for each metric's ``compute``
(the metrics count on the host). ``save`` and ``load`` write and read
the network's and the optimizer's state dicts with ``torch.save`` at
``path + ".pdparams"`` and ``path + ".pdopt"``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import jit
from ..io import DataLoader, Dataset
from ..metric import Metric
from .callbacks import ProgBarLogger

__all__ = ["Model"]


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self.stop_training = False
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step = None

    @property
    def device(self):
        """The network's device (its first parameter's or buffer's)."""
        for t in self.network.parameters():
            return t.device
        for t in self.network.buffers():
            return t.device
        return torch.device("cpu")

    # -- configuration -----------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        ms = _as_list(metrics)
        for m in ms:
            if not isinstance(m, Metric):
                raise TypeError(f"metric {m!r} is not a metric.Metric")
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = ms
        self._train_step = None
        return self

    # -- internals ---------------------------------------------------------
    def _loader(self, data, batch_size, shuffle, num_workers,
                drop_last=None):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(
                data, batch_size=batch_size, shuffle=shuffle,
                num_workers=num_workers,
                drop_last=shuffle if drop_last is None else drop_last,
                device=self.device)
        raise TypeError(f"cannot build a DataLoader from {type(data)}")

    def _split_batch(self, batch):
        """(inputs, label) on the network's device; the last element of a
        list or tuple batch is the label."""
        dev = self.device

        def move(t):
            return (t.to(dev, non_blocking=True)
                    if isinstance(t, torch.Tensor) else t)

        if isinstance(batch, (list, tuple)):
            *xs, y = batch
            return [move(x) for x in xs], move(y)
        return [move(batch)], None

    def _ensure_train_step(self):
        if self._train_step is None:
            loss_fn = self._loss

            def step_fn(network, *args):
                *xs, y = args
                return loss_fn(network(*xs), y)

            self._train_step = jit.TrainStep(self.network, step_fn,
                                             self._optimizer)
        return self._train_step

    # -- train / eval / predict --------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None):
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer, loss) before fit")
        loader = self._loader(train_data, batch_size, shuffle, num_workers,
                              drop_last=drop_last)
        eval_loader = self._loader(eval_data, batch_size, False,
                                   num_workers)
        cbs = _as_list(callbacks) or [ProgBarLogger(log_freq, verbose)]
        for cb in cbs:
            cb.set_model(self)
        step_fn = self._ensure_train_step()
        self.stop_training = False
        history = {"loss": []}
        for cb in cbs:
            cb.on_train_begin()
        it = 0
        for epoch in range(epochs):
            self.network.train()
            for cb in cbs:
                cb.on_epoch_begin(epoch)
            epoch_losses = []
            for step, batch in enumerate(loader):
                for cb in cbs:
                    cb.on_train_batch_begin(step)
                xs, y = self._split_batch(batch)
                val = step_fn(*xs, y).item()
                epoch_losses.append(val)
                for cb in cbs:
                    cb.on_train_batch_end(step, {"loss": val})
                it += 1
                if num_iters is not None and it >= num_iters:
                    self.stop_training = True
                    break
            if not epoch_losses:
                raise ValueError(
                    "fit() produced no batches: dataset smaller than "
                    "batch_size with drop_last=True?")
            epoch_log = {"loss": float(np.mean(epoch_losses))}
            history["loss"].append(epoch_log["loss"])
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                epoch_log.update(self.evaluate(
                    eval_loader, batch_size=batch_size, verbose=0,
                    num_workers=num_workers, callbacks=cbs))
            for cb in cbs:
                cb.on_epoch_end(epoch, epoch_log)
            if save_dir is not None and (epoch + 1) % save_freq == 0:
                os.makedirs(save_dir, exist_ok=True)
                self.save(os.path.join(save_dir, str(epoch)))
            if self.stop_training:
                break
        for cb in cbs:
            cb.on_train_end()
        return history

    @torch.no_grad()
    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._loader(eval_data, batch_size, False, num_workers)
        cbs = _as_list(callbacks)
        self.network.eval()
        for m in self._metrics:
            m.reset()
        for cb in cbs:
            cb.on_eval_begin()
        losses = []
        for batch in loader:
            xs, y = self._split_batch(batch)
            out = self.network(*xs)
            if self._loss is not None and y is not None:
                losses.append(self._loss(out, y).item())
            for m in self._metrics:
                computed = m.compute(out, y)
                if isinstance(computed, tuple):
                    m.update(*computed)
                else:
                    m.update(computed)
        logs = {}
        if losses:
            logs["eval_loss"] = float(np.mean(losses))
        for m in self._metrics:
            names, vals = m.name(), m.accumulate()
            if isinstance(names, list):
                vals = vals if isinstance(vals, (list, tuple)) else [vals]
                for n, v in zip(names, vals):
                    logs[f"eval_{n}"] = v
            else:
                logs[f"eval_{names}"] = vals
        for cb in cbs:
            cb.on_eval_end(logs)
        return logs

    @torch.no_grad()
    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """The network's outputs per batch, as numpy arrays (one array
        with ``stack_outputs``)."""
        loader = self._loader(test_data, batch_size, False, num_workers)
        self.network.eval()
        outs = []
        for batch in loader:
            xs, _ = self._split_batch(batch)
            out = self.network(*xs)
            outs.append(out.float().cpu().numpy()
                        if isinstance(out, torch.Tensor) else out)
        return np.concatenate(outs) if stack_outputs else outs

    # -- persistence -------------------------------------------------------
    def save(self, path, training=True):
        torch.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            torch.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        self.network.set_state_dict(torch.load(
            path + ".pdparams", map_location=self.device))
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(path + ".pdopt")):
            self._optimizer.set_state_dict(torch.load(
                path + ".pdopt", map_location=self.device))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        n_params = sum(p.numel() for p in self.network.parameters())
        lines = [f"{type(self.network).__name__}: {n_params:,} parameters"]
        for name, sub in self.network.named_modules():
            if sub is self.network:
                continue
            cnt = sum(p.numel() for p in sub.parameters(recurse=False))
            if cnt:
                lines.append(f"  {name}: {cnt:,}")
        print("\n".join(lines))
        return {"total_params": n_params}
