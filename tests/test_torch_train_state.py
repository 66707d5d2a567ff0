"""Bit-exact training resume in the port, on the CPU.

The JAX package's contract (``paddle_tpu/resilience/train_state.py``): a
run killed at any step boundary and resumed from its checkpoint ends with
final weights bit-identical to a run that never stopped. A tiny job
(two linear layers with dropout, Adam under a StepDecay schedule, a
seeded shuffled DataLoader) is checkpointed and resumed:

* mid-epoch and mid-gradient-accumulation-window, with the GradScaler;
* by ``request_preemption`` (emergency checkpoint, exit 76), also when
  the notice lands before the loop or in the epoch rollover window
  (``TestEpochBoundaryPreempt``'s cases);
* after a ``train.step`` fault, from the last periodic checkpoint;
* by a real SIGTERM and by a watchdog-detected hang (exit 68, on the
  cooperative and the hard path): these run in a subprocess with its own
  timeout, never in the test process, which an ``os._exit`` would take
  down.

Weights are compared bit for bit. The last test holds the checkpoint of
the same job in both packages to the same data cursor, sampler state,
scheduler and step counters.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.resilience import TrainState as JaxTrainState
from paddle_tpu.resilience import TrainLoop as JaxTrainLoop
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.resilience import (
    HANG_EXIT_CODE,
    PREEMPT_EXIT_CODE,
    FaultSpec,
    TrainLoop,
    TrainState,
    faults,
    request_preemption,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPROCESS_TIMEOUT = 120

# the tiny job, shared by the tests and the subprocess worker (which
# imports only torch and the port)
JOB = r'''
import hashlib
import random
import numpy as np
import torch
from paddle_tpu_torch import amp
from paddle_tpu_torch.io import (BatchSampler, DataLoader, RandomSampler,
                                 TensorDataset)
from paddle_tpu_torch.optimizer import Adam, lr
from paddle_tpu_torch.resilience import TrainState


def build(accum_steps=1, with_scaler=False, scaler_unused=False):
    torch.manual_seed(0)
    np.random.seed(123)
    random.seed(321)
    torch.set_num_threads(1)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8),
                                torch.nn.Dropout(0.5),
                                torch.nn.Linear(8, 4))
    opt = Adam(learning_rate=lr.StepDecay(0.05, step_size=3),
               parameters=model.named_parameters())
    scaler = (amp.GradScaler(init_loss_scaling=2.0 ** 10)
              if with_scaler or scaler_unused else None)
    data = np.arange(64, dtype=np.float32).reshape(16, 4) / 64.0
    ds = TensorDataset([data])
    loader = DataLoader(ds, batch_sampler=BatchSampler(
        sampler=RandomSampler(ds, seed=7), batch_size=4), device="cpu")
    state = TrainState(model=model, optimizer=opt, scaler=scaler,
                       dataloader=loader, accum_steps=accum_steps)

    def step_fn(batch, st):
        x = batch[0]
        loss = ((model(x) - x) ** 2).mean()
        if with_scaler:
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            opt._learning_rate.step()
            return loss
        loss.backward()
        if st.accum_steps > 1:
            st.accum_phase += 1
            if st.accum_phase >= st.accum_steps:
                opt.step()
                opt.clear_grad()
                st.accum_phase = 0
        else:
            opt.step()
            opt.clear_grad()
        opt._learning_rate.step()
        return loss

    return state, step_fn


def digests(state):
    return {k: hashlib.sha256(
                v.detach().contiguous().numpy().tobytes()).hexdigest()
            for k, v in state.model.state_dict().items()}
'''

WORKER = JOB + r'''
import json, os, signal, sys, time
from paddle_tpu_torch.distributed.watchdog import CommWatchdog
from paddle_tpu_torch.resilience import TrainLoop

args = json.loads(sys.argv[1])
state, fn = build()
mode = args.get("mode")
kw = {}
if mode == "sigterm":
    inner = fn

    def fn(batch, st):
        out = inner(batch, st)
        if st.step == args["at"]:
            os.kill(os.getpid(), signal.SIGTERM)
        return out
elif mode in ("hang", "hard_hang"):
    wd = CommWatchdog(timeout=0.4, poll_interval=0.05)
    inner = fn

    def fn(batch, st):
        if st.step == args["at"]:
            if mode == "hang":
                time.sleep(2.0)          # past the deadline, then unwinds
            else:
                end = time.time() + 30   # never unwinds: swallows the
                while time.time() < end:  # watchdog's interrupt
                    try:
                        time.sleep(0.05)
                    except KeyboardInterrupt:
                        pass
        return inner(batch, st)
    kw = dict(watchdog=wd, hang_grace=30.0 if mode == "hang" else 0.5)
TrainLoop(state, fn, args["dir"], save_every=args.get("save_every"),
          **kw).run(args["steps"])
print(json.dumps({"step": state.step, "digests": digests(state)}))
'''

exec(JOB)   # build() and digests() for the in-process tests


def _worker(args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", WORKER, json.dumps(args)],
        capture_output=True, text=True, env=env, cwd=REPO,
        timeout=SUBPROCESS_TIMEOUT)


def _finished(proc):
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _weights(state):
    return digests(state)


def test_mid_epoch_capture_restore(tmp_path):
    st, fn = build()
    TrainLoop(st, fn, str(tmp_path / "a")).run(10)
    want = _weights(st)
    st, fn = build()
    TrainLoop(st, fn, str(tmp_path / "b")).run(6)
    st.save(str(tmp_path / "b"))
    st2, fn2 = build()
    TrainLoop(st2, fn2, str(tmp_path / "b")).run(10)
    assert st2.step == 10 and st2.epoch == 2
    assert _weights(st2) == want


def test_state_dict_namespaces(tmp_path):
    st, fn = build(with_scaler=True)
    TrainLoop(st, fn, str(tmp_path / "a")).run(3)
    sd = st.state_dict()
    spaces = {k.split(".")[0] for k in sd}
    assert spaces == {"model", "opt", "rng", "train", "data", "scaler"}
    assert {k for k in sd if k.startswith("rng.")} == {
        "rng.py", "rng.np.keys", "rng.np.meta", "rng.torch"}
    assert sd["opt.global_step"] == 3 and sd["train.step"] == 3
    assert "opt.0.weight_moment1_0" in sd
    assert sd["data"]["batches_served"] == 3


def test_mid_accum_window_capture(tmp_path):
    st, fn = build(accum_steps=2)
    TrainLoop(st, fn, str(tmp_path / "a")).run(9)
    want = _weights(st)
    st, fn = build(accum_steps=2)
    TrainLoop(st, fn, str(tmp_path / "b")).run(5)
    assert st.accum_phase == 1
    st.save(str(tmp_path / "b"))
    assert "grad.0.weight" in ckpt.load_full(str(tmp_path / "b"))
    st2, fn2 = build(accum_steps=2)
    st2.load(str(tmp_path / "b"))
    assert st2.accum_phase == 1
    assert all(p.grad is not None for p in st2.optimizer._parameter_list)
    TrainLoop(st2, fn2, str(tmp_path / "b")).run(9)
    assert _weights(st2) == want


def test_scaler_state_roundtrip(tmp_path):
    st, fn = build(with_scaler=True)
    TrainLoop(st, fn, str(tmp_path / "a")).run(10)
    want = (_weights(st), st.scaler.state_dict())
    st, fn = build(with_scaler=True)
    TrainLoop(st, fn, str(tmp_path / "c")).run(4)
    st.save(str(tmp_path / "c"))
    st2, fn2 = build(with_scaler=True)
    TrainLoop(st2, fn2, str(tmp_path / "c")).run(10)
    assert (_weights(st2), st2.scaler.state_dict()) == want
    st.scaler._scale = 1234.5
    st.save(str(tmp_path / "d"))
    st3, _ = build(with_scaler=True)
    st3.load(str(tmp_path / "d"))
    assert st3.scaler.get_scale_ratio() == 1234.5


def test_emergency_checkpoint_on_preemption_notice(tmp_path):
    st, fn = build()
    TrainLoop(st, fn, str(tmp_path / "a")).run(10)
    want = _weights(st)
    st, fn = build()
    fired = []

    def preempting_fn(batch, s):
        out = fn(batch, s)
        if s.step == 4 and not fired:
            fired.append(True)
            request_preemption()
        return out

    with pytest.raises(SystemExit) as e:
        TrainLoop(st, preempting_fn, str(tmp_path / "b")).run(10)
    assert e.value.code == PREEMPT_EXIT_CODE
    assert ckpt.load_full(str(tmp_path / "b"))["train.emergency"] is True
    st2, fn2 = build()
    assert st2.try_load(str(tmp_path / "b"))
    assert st2.step == 5
    TrainLoop(st2, fn2, str(tmp_path / "b")).run(10)
    assert _weights(st2) == want


def test_notice_before_run_is_honored(tmp_path):
    st, fn = build()
    TrainLoop(st, fn, str(tmp_path / "a")).run(10)
    want = _weights(st)
    st, fn = build()
    request_preemption()
    with pytest.raises(SystemExit) as e:
        TrainLoop(st, fn, str(tmp_path / "n")).run(10)
    assert e.value.code == PREEMPT_EXIT_CODE
    assert st.step == 0
    st2, fn2 = build()
    TrainLoop(st2, fn2, str(tmp_path / "n")).run(10)
    assert _weights(st2) == want


def test_train_step_fault_site_and_resume(tmp_path):
    st, fn = build()
    TrainLoop(st, fn, str(tmp_path / "a")).run(10)
    want = _weights(st)
    st, fn = build()
    with faults.inject(
            {"train.step": FaultSpec(RuntimeError("chaos"), at=8)}) as inj:
        with pytest.raises(RuntimeError, match="chaos"):
            TrainLoop(st, fn, str(tmp_path / "f"), save_every=3).run(10)
    assert inj.fired["train.step"] == 1
    assert st.step == 7            # fired before the 8th step body
    st2, fn2 = build()
    st2.load(str(tmp_path / "f"))
    assert st2.step == 6           # the last periodic checkpoint
    TrainLoop(st2, fn2, str(tmp_path / "f"), save_every=3).run(10)
    assert _weights(st2) == want


class _WindowLoop(TrainLoop):
    """Fires a preemption notice in the rollover window into epoch 1:
    after epoch 0's iterator is exhausted, before epoch 1's first
    batch."""

    fired = False

    def _sync_epoch(self):
        super()._sync_epoch()
        if self.state.epoch == 1 and not self.fired:
            self.fired = True
            request_preemption()


def _epoch_keyed():
    from paddle_tpu_torch.io import (
        DataLoader,
        DistributedBatchSampler,
        TensorDataset,
    )
    from paddle_tpu_torch.optimizer import Adam

    torch.manual_seed(0)
    model = torch.nn.Linear(4, 4)
    opt = Adam(learning_rate=0.05, parameters=model.parameters())
    data = np.arange(64, dtype=np.float32).reshape(16, 4) / 64.0
    ds = TensorDataset([data])
    loader = DataLoader(ds, batch_sampler=DistributedBatchSampler(
        ds, batch_size=4, num_replicas=1, rank=0, shuffle=True),
        device="cpu")
    st = TrainState(model=model, optimizer=opt, dataloader=loader)

    def fn(batch, s):
        x = batch[0]
        loss = ((model(x) - x) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return st, fn


@pytest.mark.parametrize("job", ["epoch_keyed", "random_sampler"])
def test_rollover_window_preempt_bit_identical(tmp_path, job):
    make = _epoch_keyed if job == "epoch_keyed" else build
    st, fn = make()
    TrainLoop(st, fn, str(tmp_path / "a")).run(12)
    want = _weights(st)
    st, fn = make()
    with pytest.raises(SystemExit) as e:
        _WindowLoop(st, fn, str(tmp_path / "b")).run(12)
    assert e.value.code == PREEMPT_EXIT_CODE
    assert st.step == 4 and st.epoch == 1
    st2, fn2 = make()
    st2.load(str(tmp_path / "b"))
    assert st2.dataloader.state_dict()["batches_served"] == 0
    TrainLoop(st2, fn2, str(tmp_path / "b")).run(12)
    assert _weights(st2) == want


def test_multi_rank_arguments_are_refused_by_name(tmp_path):
    st, fn = build()
    with pytest.raises(NotImplementedError, match="multi-rank"):
        TrainLoop(st, fn, str(tmp_path), world=2)
    with pytest.raises(NotImplementedError, match="multi-rank"):
        TrainLoop(st, fn, str(tmp_path), store=object())
    from paddle_tpu_torch.distributed.watchdog import CommWatchdog
    with pytest.raises(NotImplementedError, match="store"):
        CommWatchdog(store=object())


def test_real_sigterm_in_a_subprocess(tmp_path):
    want = _finished(_worker({"dir": str(tmp_path / "a"), "steps": 10}))
    d = str(tmp_path / "s")
    proc = _worker({"dir": d, "steps": 10, "mode": "sigterm", "at": 3})
    assert proc.returncode == PREEMPT_EXIT_CODE, proc.stderr[-2000:]
    assert "emergency checkpoint saved" in proc.stderr
    saved = ckpt.load_full(d)
    # the signal lands during the 4th step (step index 3): the
    # checkpoint holds that completed step
    assert saved["train.step"] == 4 and saved["train.emergency"] is True
    got = _finished(_worker({"dir": d, "steps": 10}))
    assert got == want


@pytest.mark.parametrize("mode", ["hang", "hard_hang"])
def test_watchdog_hang_exits_68_and_resumes_in_a_subprocess(tmp_path, mode):
    want = _finished(_worker({"dir": str(tmp_path / "a"), "steps": 10}))
    d = str(tmp_path / "h")
    proc = _worker({"dir": d, "steps": 10, "mode": mode, "at": 5,
                    "save_every": 2})
    assert proc.returncode == HANG_EXIT_CODE, proc.stderr[-2000:]
    assert "comm_watchdog" in proc.stderr
    if mode == "hard_hang":
        assert "hard exit 68" in proc.stderr
    assert ckpt.load_full(d)["train.step"] == 4
    got = _finished(_worker({"dir": d, "steps": 10, "save_every": 2}))
    assert got == want


def _jax_job():
    from paddle_tpu.io import BatchSampler, DataLoader, RandomSampler
    from paddle_tpu.io import TensorDataset as JaxTensorDataset

    paddle.seed(0)
    model = paddle.nn.Sequential(paddle.nn.Linear(4, 8),
                                 paddle.nn.Linear(8, 4))
    opt = paddle.optimizer.Adam(
        learning_rate=paddle.optimizer.lr.StepDecay(0.05, step_size=3),
        parameters=model.parameters())
    data = np.arange(64, dtype=np.float32).reshape(16, 4) / 64.0
    ds = JaxTensorDataset([data])
    loader = DataLoader(ds, batch_sampler=BatchSampler(
        sampler=RandomSampler(ds, seed=7), batch_size=4))
    st = JaxTrainState(model=model, optimizer=opt,
                       scaler=paddle.amp.GradScaler(
                           init_loss_scaling=2.0 ** 10),
                       dataloader=loader)

    def fn(batch, s):
        x = batch[0]
        loss = ((model(x) - x) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        opt._learning_rate.step()
        return loss

    return st, fn


def test_same_job_same_cursor_schedule_and_counters_as_jax(tmp_path):
    jst, jfn = _jax_job()
    JaxTrainLoop(jst, jfn, str(tmp_path / "j")).run(6)
    jst.save(str(tmp_path / "j"))
    st, fn = build(scaler_unused=True)
    TrainLoop(st, fn, str(tmp_path / "t")).run(6)
    st.save(str(tmp_path / "t"))
    jsaved = ckpt.load_full(str(tmp_path / "j"))   # the port reads both
    saved = ckpt.load_full(str(tmp_path / "t"))
    for key in ("data", "scaler", "opt.LR_Scheduler", "opt.global_step",
                "train.step", "train.epoch", "train.accum_steps",
                "train.accum_phase", "train.emergency"):
        assert saved[key] == jsaved[key], key
    assert {k.split(".")[0] for k in saved} == {
        k.split(".")[0] for k in jsaved}
