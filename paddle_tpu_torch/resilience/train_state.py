"""Bit-exact training resume.

Counterpart of ``paddle_tpu/resilience/train_state.py`` for one process:
a run killed at any step boundary and resumed from its checkpoint ends
with final weights bit-identical to a run that never stopped.

* :class:`TrainState` — one capture/restore object for everything a
  training process owns: the model, the optimizer (masters, moments,
  LR schedule, global step), the AMP scaler, the gradient-accumulation
  phase (with the in-flight gradients), every RNG stream (python
  ``random``, the global ``np.random``, torch's default CPU generator
  and, where there is a card, its default CUDA generator: the last two
  take the place of the JAX key ``rng.fw``) and the DataLoader's
  mid-epoch cursor. Persisted through checkpoint format v2
  (``distributed.checkpoint``: atomic, checksummed, verified before it
  is published).
* :class:`PreemptionHandler` / :class:`TrainLoop` — SIGTERM (or
  :func:`request_preemption`) makes an **emergency checkpoint** at the
  next step boundary, then the process exits with
  :data:`PREEMPT_EXIT_CODE` (76), which the JAX package's elastic
  launcher reads as a preemption.
* hang handling — with a ``CommWatchdog``, each train step runs under a
  deadline; a stuck step dumps a flight postmortem and exits
  :data:`HANG_EXIT_CODE` (68).

The JAX package's multi-rank coordination (``store=``, ``world > 1``,
the preemption barrier) is not ported: those arguments raise.

Spans, metrics and flight records go through the port's
``observability``: spans ``train.checkpoint`` and ``train.resume``;
histograms ``paddle_tpu_train_ckpt_seconds{kind}`` and
``paddle_tpu_train_resume_seconds``; counters
``paddle_tpu_train_resumes_total{reason}``,
``paddle_tpu_train_preemptions_total`` and
``paddle_tpu_train_steps_total``; flight records ``train/checkpoint``,
``train/resume`` and ``train/preempt-notice``.
"""
from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading
import time

import numpy as np

__all__ = [
    "TrainState", "TrainLoop", "PreemptionHandler", "request_preemption",
    "preemption_requested", "PREEMPT_EXIT_CODE", "HANG_EXIT_CODE",
]

# Exit-code protocol with the JAX package's elastic launcher: a worker
# that exits PREEMPT_EXIT_CODE checkpointed cleanly after a preemption
# notice; HANG_EXIT_CODE is a watchdog-detected stuck step.
PREEMPT_EXIT_CODE = 76
HANG_EXIT_CODE = 68

def _obs():
    """Lazy observability handle (flight, metrics, spans) — may be None
    mid-bootstrap; every caller degrades to a no-op."""
    try:
        from .. import observability

        return observability
    except Exception:
        # analysis: allow(broad-except) telemetry must never take down
        # the training it observes
        return None


# -- RNG stream capture ------------------------------------------------------


def _capture_rng():
    """Snapshot every RNG stream training can draw from: python
    ``random``, the global ``np.random`` MT19937, torch's default CPU
    generator and, when CUDA is initialised, its default generator on
    the current device."""
    import random as pyrandom

    import torch

    out = {}
    version, keys, gauss = pyrandom.getstate()
    out["rng.py"] = [int(version), [int(k) for k in keys],
                     None if gauss is None else float(gauss)]
    name, np_keys, pos, has_gauss, cached = np.random.get_state()
    out["rng.np.keys"] = np.asarray(np_keys, dtype=np.uint32)
    out["rng.np.meta"] = [str(name), int(pos), int(has_gauss),
                          float(cached)]
    out["rng.torch"] = torch.get_rng_state().numpy()
    if torch.cuda.is_initialized():
        out["rng.cuda"] = torch.cuda.get_rng_state().numpy()
    return out


def _restore_rng(flat):
    import random as pyrandom

    import torch

    if "rng.py" in flat:
        version, keys, gauss = flat["rng.py"]
        pyrandom.setstate(
            (int(version), tuple(int(k) for k in keys),
             None if gauss is None else float(gauss))
        )
    if "rng.np.keys" in flat and "rng.np.meta" in flat:
        name, pos, has_gauss, cached = flat["rng.np.meta"]
        np.random.set_state(
            (str(name), _as_np(flat["rng.np.keys"]).astype(np.uint32),
             int(pos), int(has_gauss), float(cached))
        )
    if "rng.torch" in flat:
        torch.set_rng_state(
            torch.from_numpy(_as_np(flat["rng.torch"]).astype(np.uint8)))
    if "rng.cuda" in flat and torch.cuda.is_available():
        torch.cuda.set_rng_state(
            torch.from_numpy(_as_np(flat["rng.cuda"]).astype(np.uint8)))


def _as_np(v):
    """Checkpoint arrays come back as torch tensors; the RNG plumbing
    wants numpy arrays."""
    if hasattr(v, "numpy"):
        return np.asarray(v.numpy())
    return np.asarray(v)


# -- TrainState --------------------------------------------------------------


class TrainState:
    """Everything a training process must carry across a kill.

    ``state_dict()`` returns ONE flat, namespaced dict (``model.*``,
    ``opt.*``, ``grad.*``, ``rng.*``, ``data``, ``scaler``,
    ``train.*``) that round-trips through
    ``distributed.checkpoint.save_state_dict`` / ``load_full``;
    ``save``/``load`` do exactly that. Restoring into freshly
    constructed (identically configured) objects and continuing
    training is bit-identical to never having stopped.

    ``accum_phase`` is the number of micro-batches folded into the
    current gradient-accumulation window; when non-zero, the in-flight
    ``p.grad`` buffers are captured too, so even a mid-window
    checkpoint resumes exactly.
    """

    def __init__(self, model=None, optimizer=None, scaler=None,
                 dataloader=None, step=0, epoch=0, accum_steps=1):
        self.model = model
        self.optimizer = optimizer
        self.scaler = scaler
        self.dataloader = dataloader
        self.step = int(step)
        self.epoch = int(epoch)
        self.accum_steps = int(accum_steps)
        self.accum_phase = 0

    # -- capture -----------------------------------------------------------
    def _named_params(self):
        """(name, parameter) pairs: the optimizer's names where there is
        an optimizer, else the model's ``named_parameters``."""
        if self.optimizer is not None:
            return [(self.optimizer.param_name(p), p)
                    for p in self.optimizer._parameter_list]
        if self.model is not None:
            return list(self.model.named_parameters())
        return []

    def state_dict(self):
        flat = {}
        if self.model is not None:
            for k, v in self.model.state_dict().items():
                flat[f"model.{k}"] = v
        if self.optimizer is not None:
            for k, v in self.optimizer.state_dict().items():
                flat[f"opt.{k}"] = v
        if self.scaler is not None:
            flat["scaler"] = dict(self.scaler.state_dict())
        if self.dataloader is not None and hasattr(
            self.dataloader, "state_dict"
        ):
            flat["data"] = self.dataloader.state_dict()
        flat.update(_capture_rng())
        flat["train.step"] = self.step
        flat["train.epoch"] = self.epoch
        flat["train.accum_steps"] = self.accum_steps
        flat["train.accum_phase"] = self.accum_phase
        if self.accum_phase:
            # mid-accumulation-window: the half-summed gradients are
            # live state — capture them or the window replays wrong
            for name, p in self._named_params():
                if p.grad is not None:
                    flat[f"grad.{name}"] = p.grad
        return flat

    # -- restore -----------------------------------------------------------
    def load_state_dict(self, flat):
        import torch

        if self.model is not None:
            sub = {
                k[len("model."):]: v
                for k, v in flat.items() if k.startswith("model.")
            }
            missing, _unexpected = self.model.load_state_dict(
                sub, strict=False)
            if missing:
                raise ValueError(
                    "checkpoint is missing model entries (bit-exact "
                    f"resume impossible): {missing}"
                )
        if self.optimizer is not None:
            sub = {
                k[len("opt."):]: v
                for k, v in flat.items() if k.startswith("opt.")
            }
            self.optimizer.set_state_dict(sub)
        if self.scaler is not None and flat.get("scaler") is not None:
            self.scaler.load_state_dict(dict(flat["scaler"]))
        if self.dataloader is not None and flat.get("data") is not None:
            self.dataloader.load_state_dict(dict(flat["data"]))
        _restore_rng(flat)
        self.step = int(flat.get("train.step", self.step))
        self.epoch = int(flat.get("train.epoch", self.epoch))
        self.accum_steps = int(
            flat.get("train.accum_steps", self.accum_steps)
        )
        self.accum_phase = int(flat.get("train.accum_phase", 0))
        grads = {
            k[len("grad."):]: v
            for k, v in flat.items() if k.startswith("grad.")
        }
        if grads:
            for name, p in self._named_params():
                if name in grads:
                    p.grad = torch.as_tensor(grads[name]).to(
                        device=p.device, dtype=p.dtype).clone()
        return self

    # -- persistence (checkpoint format v2) --------------------------------
    def save(self, path, keep_last_k=2, emergency=False):
        """Persist through checkpoint v2: atomic, checksummed, verified
        before the ``latest`` pointer moves — an emergency checkpoint
        interrupted by a SIGKILL can never become ``latest``. Returns
        the seconds it took."""
        from ..distributed import checkpoint as ckpt

        obs = _obs()
        t0 = time.perf_counter()
        with (obs.span("train.checkpoint", step=self.step,
                       emergency=bool(emergency))
              if obs is not None else contextlib.nullcontext()):
            sd = self.state_dict()
            sd["train.emergency"] = bool(emergency)
            ckpt.save_state_dict(sd, path, keep_last_k=keep_last_k)
        dt = time.perf_counter() - t0
        if obs is not None:
            obs.metrics.histogram(
                "paddle_tpu_train_ckpt_seconds",
                "TrainState capture+save wall clock", ("kind",),
            ).observe(dt, kind="emergency" if emergency else "periodic")
            obs.flight.record(
                "train", "checkpoint", step=self.step,
                emergency=emergency, ms=round(dt * 1e3, 1),
            )
        return dt

    def load(self, path):
        """Restore from the newest verified checkpoint under ``path``.
        Raises FileNotFoundError when none exists (cold start) —
        callers distinguish 'first incarnation' from 'corrupt beyond
        recovery' (CheckpointCorruptError)."""
        from ..distributed import checkpoint as ckpt

        obs = _obs()
        reason = os.environ.get("PADDLE_RESTART_REASON", "cold")
        t0 = time.perf_counter()
        with (obs.span("train.resume", reason=reason)
              if obs is not None else contextlib.nullcontext()):
            flat = ckpt.load_full(path)
            self.load_state_dict(flat)
        dt = time.perf_counter() - t0
        if obs is not None:
            obs.metrics.counter(
                "paddle_tpu_train_resumes_total",
                "TrainState restores, by restart provenance",
                ("reason",),
            ).inc(reason=reason)
            obs.metrics.histogram(
                "paddle_tpu_train_resume_seconds",
                "TrainState load+restore wall clock",
            ).observe(dt)
            obs.flight.record(
                "train", "resume", step=self.step, reason=reason,
                ms=round(dt * 1e3, 1),
            )
        return self

    def try_load(self, path):
        """``load`` that treats 'no checkpoint yet' as a cold start;
        returns True when a checkpoint was restored."""
        try:
            self.load(path)
            return True
        except FileNotFoundError:
            return False


# -- preemption notice -------------------------------------------------------

# process-wide notice flag: set by signal handlers and by
# request_preemption() (cloud preemption notices arrive out-of-band)
_notice = threading.Event()


def request_preemption():
    """Programmatic preemption notice — equivalent to receiving
    SIGTERM. The train loop checkpoints at the next step boundary and
    exits PREEMPT_EXIT_CODE."""
    _notice.set()
    obs = _obs()
    if obs is not None:
        obs.flight.record("train", "preempt-notice", source="api")


def preemption_requested():
    return _notice.is_set()


class PreemptionHandler:
    """Signal -> notice-flag bridge. ``install()`` chains the previous
    handler (a framework must not eat a user's own SIGTERM hook);
    ``uninstall()`` restores it. Signal handlers only bind on the main
    thread — elsewhere install() is a no-op and only the programmatic
    notice works."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._previous = {}

    def _on_signal(self, signum, frame):
        _notice.set()
        obs = _obs()
        if obs is not None:
            obs.flight.record(
                "train", "preempt-notice", source=f"signal:{signum}"
            )
        prev = self._previous.get(signum)
        if callable(prev):
            prev(signum, frame)

    def install(self):
        # deliberately does NOT clear a pending notice: install() may
        # run while a live notice (e.g. from a cloud-notice poller
        # thread) is already set, and eating it would skip the
        # emergency checkpoint. The flag is consumed exactly where it
        # is honored — TrainLoop._emergency_exit.
        for s in self.signals:
            try:
                self._previous[s] = signal.signal(s, self._on_signal)
            except ValueError:  # not the main thread
                pass
        return self

    def uninstall(self):
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev if prev is not None
                              else signal.SIG_DFL)
            except ValueError:
                pass
        self._previous.clear()

    def requested(self):
        return _notice.is_set()

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False


# -- the elastic train loop --------------------------------------------------


class TrainLoop:
    """Preemption-safe, hang-safe step loop around a :class:`TrainState`.

    ``step_fn(batch, state)`` owns the actual work (forward, backward,
    optimizer step — and, if it accumulates, maintaining
    ``state.accum_phase``); the loop owns everything a preemptible job
    needs around it:

    * automatic resume from ``ckpt_dir`` (cold starts just begin),
    * the ``train.step`` fault site (fired before every step),
    * periodic checkpoints every ``save_every`` steps,
    * SIGTERM / :func:`request_preemption` -> emergency checkpoint ->
      ``SystemExit(PREEMPT_EXIT_CODE)``,
    * optional ``CommWatchdog`` deadline per step: a stuck step exits
      ``HANG_EXIT_CODE`` after the watchdog's postmortem dump.

    ``store=``, ``world > 1`` and the preemption barrier of the JAX
    package (multi-rank coordination) are not ported and raise.
    """

    def __init__(self, state, step_fn, ckpt_dir, *, save_every=None,
                 keep_last_k=2, watchdog=None, step_timeout=None,
                 hang_grace=2.0, store=None, world=1, rank=0,
                 coordinator_rank=0, barrier_timeout=60.0,
                 store_poll_s=0.5, signals=(signal.SIGTERM,)):
        if store is not None or int(world) > 1:
            raise NotImplementedError(
                "TrainLoop(store=..., world > 1): multi-rank coordination "
                "(the preemption notice through a TCPStore and its "
                "checkpoint barrier) is not ported; one process trains"
            )
        self.state = state
        self.step_fn = step_fn
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.keep_last_k = keep_last_k
        self.watchdog = watchdog
        self.step_timeout = step_timeout
        self.hang_grace = float(hang_grace)
        self.rank = int(rank)
        self._handler = PreemptionHandler(signals)
        self._hang_unwound = threading.Event()

    # -- preemption --------------------------------------------------------
    def _preempt_pending(self):
        return self._handler.requested()

    def _emergency_exit(self):
        # the notice is being HONORED — consume it, so a later loop in
        # this process does not instantly re-preempt on a flag whose
        # emergency checkpoint was already taken
        _notice.clear()
        obs = _obs()
        step = self.state.step
        if obs is not None:
            obs.metrics.counter(
                "paddle_tpu_train_preemptions_total",
                "preemption notices honored with an emergency checkpoint",
            ).inc()
        sys.stderr.write(
            f"[train] rank {self.rank}: preemption at step {step} — "
            "emergency checkpoint\n"
        )
        dt = self.state.save(
            self.ckpt_dir, keep_last_k=self.keep_last_k, emergency=True,
        )
        sys.stderr.write(
            f"[train] emergency checkpoint saved in {dt*1e3:.0f}ms "
            f"(step {step})\n"
        )
        raise SystemExit(PREEMPT_EXIT_CODE)

    # -- hang handling -----------------------------------------------------
    def _on_hang(self, tag, why):
        """Runs ON THE WATCHDOG THREAD after its trip (stack dump and
        flight postmortem are already done). ``interrupt_main`` only
        lands once the main thread returns to the interpreter — a step
        wedged inside a blocking runtime call never does — so after
        ``hang_grace`` seconds without a cooperative unwind, hard-exit
        with the provenance-readable code (a relaunch resumes from the
        last checkpoint)."""
        import _thread

        _thread.interrupt_main()
        if self._hang_unwound.wait(self.hang_grace):
            return  # the main thread converted it to SystemExit itself
        sys.stderr.write(
            f"[train] rank {self.rank}: stuck step ({tag}: {why}) did "
            f"not unwind within {self.hang_grace}s — hard exit "
            f"{HANG_EXIT_CODE} for elastic relaunch\n"
        )
        sys.stderr.flush()
        os._exit(HANG_EXIT_CODE)

    def _run_step(self, batch):
        from . import faults

        faults.fire("train.step", step=self.state.step)
        if self.watchdog is None:
            return self.step_fn(batch, self.state)
        from ..distributed.watchdog import CommTimeoutError

        try:
            with self.watchdog.watch(
                "train.step", timeout=self.step_timeout
            ):
                return self.step_fn(batch, self.state)
        except (CommTimeoutError, KeyboardInterrupt) as e:
            if self.watchdog.fired is None:
                raise  # a genuine ctrl-C, not a watchdog trip
            # the watchdog already dumped the flight postmortem; all
            # that is left is to die with a provenance-readable code
            self._hang_unwound.set()  # call off the hard-exit timer
            sys.stderr.write(
                f"[train] rank {self.rank}: step {self.state.step} "
                f"stuck ({e}) — exiting for elastic relaunch\n"
            )
            raise SystemExit(HANG_EXIT_CODE) from e

    # -- the loop ----------------------------------------------------------
    def _batches(self):
        if self.state.dataloader is None:
            while True:
                yield None
        else:
            yield from self.state.dataloader

    def run(self, max_steps):
        """Train until ``state.step == max_steps``; returns the state.
        Automatically resumes from ``ckpt_dir`` when a verified
        checkpoint exists."""
        obs = _obs()
        state = self.state
        # NO _notice.clear() here: a live notice that arrived before
        # run() (e.g. a cloud-notice poller during bootstrap) must be
        # honored with an emergency checkpoint at the first boundary.
        # Staleness is handled at the source — _emergency_exit consumes
        # the flag when it honors it. The handler is installed before
        # the (possibly long) restore so a SIGTERM arriving mid-restore
        # becomes an orderly emergency exit, not process death.
        self._handler.install()
        hooked_watchdog = False
        try:
            resumed = state.try_load(self.ckpt_dir)
            if resumed:
                sys.stderr.write(
                    f"[train] rank {self.rank}: resumed at step "
                    f"{state.step} (epoch {state.epoch})\n"
                )
            steps_total = None
            if obs is not None:
                steps_total = obs.metrics.counter(
                    "paddle_tpu_train_steps_total",
                    "train steps completed by the elastic train loop",
                )
            self._sync_epoch()
            if (self.watchdog is not None
                    and self.watchdog._on_timeout is None):
                # default watchdog trips interrupt the main thread,
                # which a wedged runtime call never observes; take the
                # trip hook so a true hang hard-exits after the
                # cooperative grace
                self.watchdog._on_timeout = self._on_hang
                hooked_watchdog = True
            while state.step < max_steps:
                progressed = False
                # a resume cursor that already consumed the WHOLE epoch
                # (preemption landed on the epoch boundary) yields an
                # empty iterator — that is an epoch rollover, not an
                # empty dataset
                resumed_past_epoch = bool(
                    getattr(state.dataloader, "_resume_skip", 0)
                )
                batches = self._batches()
                while True:
                    # the preemption check runs BEFORE the next batch
                    # is pulled: pulling advances the dataloader's
                    # served-batch cursor, and an emergency checkpoint
                    # must not count a batch the step never trained on
                    if self._preempt_pending():
                        self._emergency_exit()
                    try:
                        batch = next(batches)
                    except StopIteration:
                        break
                    self._run_step(batch)
                    progressed = True
                    state.step += 1
                    if steps_total is not None:
                        steps_total.inc()
                    if (self.save_every
                            and state.step % self.save_every == 0):
                        state.save(
                            self.ckpt_dir, keep_last_k=self.keep_last_k,
                        )
                    if state.step >= max_steps:
                        return state
                if (not progressed and state.dataloader is not None
                        and not resumed_past_epoch):
                    raise RuntimeError(
                        "dataloader yielded no batches; cannot reach "
                        f"step {max_steps} from {state.step}"
                    )
                state.epoch += 1
                self._sync_epoch()
            return state
        finally:
            self._handler.uninstall()
            if hooked_watchdog:
                self.watchdog._on_timeout = None

    def _sync_epoch(self):
        dl = self.state.dataloader
        sampler = getattr(dl, "batch_sampler", None)
        if sampler is not None and hasattr(sampler, "set_epoch"):
            sampler.set_epoch(self.state.epoch)
