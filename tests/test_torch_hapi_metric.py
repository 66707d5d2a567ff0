"""The port's ``metric`` and ``hapi`` against the JAX package's, on the CPU.

Metrics: the same seeded update sequence through both; every value
``update`` returns and every ``accumulate`` equal to 1e-12 (both count
in f64 numpy). ``Model``: a tiny MLP with the JAX weights copied in,
the same numpy data and the same optimizer; ``fit``'s losses per step,
``evaluate``'s logs and ``predict``'s outputs within 1e-5 relative (f32,
other summation orders), and the trained weights within 1e-5 (1e-4
after Adam, whose update divides small gradients by their own root mean
square and so scales their f32 rounding up). Then the
callbacks' call order, ``EarlyStopping``, the ``LRScheduler`` callback
and a ``save`` / ``load`` round trip, on the port alone.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.hapi as jhapi
import paddle_tpu.metric as jmetric
import paddle_tpu.nn as jnn
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu_torch import hapi, metric, nn, optimizer
from paddle_tpu_torch.io import TensorDataset

TOL = 1e-5


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) <= tol * max(np.linalg.norm(b), 1e-30)


# -- metrics -----------------------------------------------------------------
def _batches(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(16, 5).astype(np.float32),
             rng.randint(0, 5, (16, 1)).astype(np.int64))
            for _ in range(n)]


@pytest.mark.parametrize("topk", [1, (1, 3)])
def test_accuracy_matches_jax(topk):
    j, p = jmetric.Accuracy(topk=topk), metric.Accuracy(topk=topk)
    assert p.name() == j.name()
    for logits, label in _batches():
        jc = j.compute(paddle.to_tensor(logits), paddle.to_tensor(label))
        pc = p.compute(torch.from_numpy(logits), torch.from_numpy(label))
        np.testing.assert_array_equal(pc, np.asarray(jc))
        np.testing.assert_allclose(p.update(pc), j.update(jc), atol=1e-12)
    np.testing.assert_allclose(p.accumulate(), j.accumulate(), atol=1e-12)
    p.reset()
    assert p.accumulate() == (0.0 if topk == 1 else [0.0, 0.0])
    # one-hot labels
    logits, label = _batches(1, seed=3)[0]
    onehot = np.eye(5, dtype=np.float32)[label[:, 0]]
    np.testing.assert_array_equal(
        p.compute(torch.from_numpy(logits), torch.from_numpy(onehot)),
        np.asarray(j.compute(paddle.to_tensor(logits),
                             paddle.to_tensor(onehot))))


@pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_jax(cls):
    j, p = getattr(jmetric, cls)(), getattr(metric, cls)()
    rng = np.random.RandomState(1)
    for _ in range(3):
        preds = rng.rand(32, 2 if cls == "Auc" else 1).astype(np.float32)
        labels = rng.randint(0, 2, (32, 1)).astype(np.int64)
        j.update(paddle.to_tensor(preds), paddle.to_tensor(labels))
        p.update(torch.from_numpy(preds), torch.from_numpy(labels))
    assert p.name() == j.name()
    assert abs(p.accumulate() - j.accumulate()) <= 1e-12
    p.reset()
    assert p.accumulate() == 0.0


def test_functional_accuracy_matches_jax():
    logits, label = _batches(1)[0]
    for k in (1, 2):
        got = metric.accuracy(torch.from_numpy(logits),
                              torch.from_numpy(label), k=k)
        want = jmetric.accuracy(paddle.to_tensor(logits),
                                paddle.to_tensor(label), k=k)
        assert got.dtype == torch.float32 and got.shape == (1,)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-7)


def test_prepare_refuses_a_non_metric():
    with pytest.raises(TypeError, match="not a metric"):
        hapi.Model(nn.Linear(2, 2)).prepare(metrics=[object()])


# -- Model -------------------------------------------------------------------
def _nets():
    paddle.seed(0)
    j = jnn.Sequential(jnn.Linear(6, 16), jnn.ReLU(), jnn.Linear(16, 3))
    p = nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 3))
    p.set_state_dict({k: v.numpy() for k, v in j.state_dict().items()})
    return j, p


def _data(n=40, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 6).astype(np.float32),
            rng.randint(0, 3, (n, 1)).astype(np.int64))


def _models(opt="Adam"):
    jnet, pnet = _nets()
    jm, pm = jhapi.Model(jnet), hapi.Model(pnet)
    kw = dict(learning_rate=0.05)
    jm.prepare(getattr(paddle.optimizer, opt)(parameters=jnet.parameters(),
                                              **kw),
               jnn.CrossEntropyLoss(), jmetric.Accuracy(topk=(1, 2)))
    pm.prepare(getattr(optimizer, opt)(parameters=pnet.parameters(), **kw),
               nn.CrossEntropyLoss(), metric.Accuracy(topk=(1, 2)))
    return jm, pm


class _Record(hapi.Callback):
    def __init__(self):
        self.calls, self.losses = [], []

    def on_train_begin(self, logs=None):
        self.calls.append("train_begin")

    def on_epoch_begin(self, epoch, logs=None):
        self.calls.append(f"epoch_begin {epoch}")

    def on_train_batch_end(self, step, logs=None):
        self.calls.append(f"batch_end {step}")
        self.losses.append(logs["loss"])

    def on_eval_begin(self, logs=None):
        self.calls.append("eval_begin")

    def on_eval_end(self, logs=None):
        self.calls.append("eval_end")

    def on_epoch_end(self, epoch, logs=None):
        self.calls.append(f"epoch_end {epoch}")

    def on_train_end(self, logs=None):
        self.calls.append("train_end")


class _JRecord(jhapi.Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


@pytest.mark.parametrize("opt", ["Adam", "SGD"])
def test_fit_evaluate_predict_match_jax(opt):
    jm, pm = _models(opt)
    x, y = _data()
    xe, ye = _data(24, seed=1)
    jrec, prec = _JRecord(), _Record()
    jh = jm.fit(JTensorDataset([x, y]), JTensorDataset([xe, ye]),
                batch_size=8, epochs=2, shuffle=False, callbacks=[jrec])
    ph = pm.fit(TensorDataset([torch.from_numpy(x), torch.from_numpy(y)]),
                TensorDataset([torch.from_numpy(xe), torch.from_numpy(ye)]),
                batch_size=8, epochs=2, shuffle=False, callbacks=[prec])
    assert len(prec.losses) == len(jrec.losses) == 10
    assert _close(prec.losses, jrec.losses)
    assert _close(ph["loss"], jh["loss"])
    jw = dict(jm.network.named_parameters())
    wtol = 1e-4 if opt == "Adam" else TOL
    for name, q in pm.network.named_parameters():
        assert _close(q.detach().numpy(), jw[name].numpy(), wtol), name
    jl = jm.evaluate(JTensorDataset([xe, ye]), batch_size=8)
    pl = pm.evaluate(TensorDataset([torch.from_numpy(xe),
                                    torch.from_numpy(ye)]), batch_size=8)
    assert set(pl) == set(jl) == {"eval_loss", "eval_acc_top1",
                                  "eval_acc_top2"}
    for k in jl:
        assert _close(pl[k], jl[k]), k
    jp = jm.predict(JTensorDataset([xe, ye]), batch_size=8,
                    stack_outputs=True)
    pp = pm.predict(TensorDataset([torch.from_numpy(xe),
                                   torch.from_numpy(ye)]), batch_size=8,
                    stack_outputs=True)
    assert pp.shape == jp.shape == (24, 3)
    assert _close(pp, jp)


def test_callback_order_and_num_iters():
    _, pm = _models()
    x, y = _data()
    rec = _Record()
    ds = TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    pm.fit(ds, ds, batch_size=20, epochs=2, shuffle=False, callbacks=[rec])
    assert rec.calls == [
        "train_begin", "epoch_begin 0", "batch_end 0", "batch_end 1",
        "eval_begin", "eval_end", "epoch_end 0", "epoch_begin 1",
        "batch_end 0", "batch_end 1", "eval_begin", "eval_end",
        "epoch_end 1", "train_end"]
    rec = _Record()
    pm.fit(ds, batch_size=8, epochs=5, shuffle=False, callbacks=[rec],
           num_iters=3)
    assert len(rec.losses) == 3 and pm.stop_training


def test_early_stopping_and_lr_scheduler_callbacks():
    _, pm = _models()
    x, y = _data()
    ds = TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    stop = hapi.EarlyStopping(monitor="eval_loss", patience=0)
    stop.set_model(pm)
    stop.on_eval_end({"eval_loss": 1.0})
    assert not pm.stop_training and stop.best == 1.0
    stop.on_eval_end({"eval_loss": 1.5})
    assert pm.stop_training
    # through fit: an eval loss that never improves on its first value
    stop = hapi.EarlyStopping(monitor="loss", patience=1, baseline=None)
    stop.best = -np.inf   # nothing beats it
    hist = pm.fit(ds, ds, batch_size=20, epochs=6, shuffle=False,
                  callbacks=[stop])
    assert len(hist["loss"]) == 1
    # the LRScheduler callback steps the optimizer's scheduler per batch
    net = nn.Linear(6, 3)
    sched = optimizer.lr.StepDecay(learning_rate=0.1, step_size=1,
                                   gamma=0.5)
    m = hapi.Model(net).prepare(
        optimizer.SGD(learning_rate=sched, parameters=net.parameters()),
        nn.CrossEntropyLoss())
    m.fit(ds, batch_size=20, epochs=1, shuffle=False,
          callbacks=[hapi.LRScheduler(by_step=True)])
    assert abs(sched() - 0.025) < 1e-12


def test_save_load_round_trip(tmp_path):
    _, pm = _models()
    x, y = _data()
    ds = TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    pm.fit(ds, batch_size=8, epochs=1, shuffle=False, verbose=0)
    pm.save(str(tmp_path / "ckpt"))
    _, fresh = _models()
    fresh.load(str(tmp_path / "ckpt"))
    for (n, a), (_, b) in zip(pm.network.named_parameters(),
                              fresh.network.named_parameters()):
        assert torch.equal(a, b), n
    sa, sb = pm._optimizer.state_dict(), fresh._optimizer.state_dict()
    assert sa.keys() == sb.keys() and sa["global_step"] == 5
    # both continue identically
    la = pm.fit(ds, batch_size=8, epochs=1, shuffle=False, verbose=0)
    lb = fresh.fit(ds, batch_size=8, epochs=1, shuffle=False, verbose=0)
    assert la["loss"] == lb["loss"]
    assert fresh.summary()["total_params"] == 6 * 16 + 16 + 16 * 3 + 3
