"""CLI entry point: start the HTTP front door without writing Python
(counterpart of ``python -m paddle_tpu.serving``).

    python -m paddle_tpu_torch.serving serve --model tiny --port 8000 \
        [--device cpu] [--replicas 2 --max-pending N] [--journal-dir DIR] \
        [--api-key KEY=TENANT ...]

The engine runs on the CUDA device unless ``--device`` names another
one; ``--replicas N`` (N >= 1) serves through a ``Fleet`` of N replicas
sharing the model, whose front-door journal is ``--journal-dir``. Bad
configuration exits non-zero with a named error on stderr (``error:
ConfigError: ...``) instead of a stack trace; so do the flags whose
modules are not ported yet (``--tp-degree`` > 1: tensor parallelism,
``--compile-cache``: the compile cache).
"""
from __future__ import annotations

import argparse
import sys
import time


class ConfigError(Exception):
    """Invalid CLI configuration (named in the exit diagnostic)."""


def _build_model(name, device):
    from ..core.device import resolve_device
    from ..models.llama import LlamaConfig, LlamaForCausalLM

    presets = {
        "tiny": lambda: LlamaConfig.tiny(),
        "tiny-moe": lambda: LlamaConfig.tiny(num_experts=4),
    }
    factory = presets.get(name)
    if factory is None:
        raise ConfigError(
            f"unknown model {name!r} (available: "
            f"{', '.join(sorted(presets))})"
        )
    try:
        device = resolve_device(device)
    except RuntimeError as e:
        raise ConfigError(f"{e} (--device cpu)")
    return LlamaForCausalLM(factory(), device=device)


def _parse_api_keys(pairs):
    keys = {}
    for pair in pairs or ():
        key, sep, tenant = pair.partition("=")
        if not sep or not key or not tenant:
            raise ConfigError(
                f"--api-key must be KEY=TENANT, got {pair!r}"
            )
        keys[key] = tenant
    return keys


def _build_backend(args):
    from . import Engine, EngineConfig, Fleet, FleetConfig

    if args.tp_degree < 1:
        raise ConfigError(
            f"--tp-degree must be >= 1, got {args.tp_degree}"
        )
    if not 0 <= args.port <= 65535:
        raise ConfigError(f"--port must be in [0, 65535], got {args.port}")
    if args.replicas < 0:
        raise ConfigError(
            f"--replicas must be >= 0, got {args.replicas}"
        )
    for flag, value, module in (
            ("--tp-degree", args.tp_degree > 1,
             "tensor parallelism (serving/sharding.py)"),
            ("--compile-cache", args.compile_cache is not None,
             "the compile cache (compilecache/)")):
        if value:
            raise ConfigError(
                f"{flag} needs {module}, which paddle_tpu_torch does not "
                "port yet"
            )
    model = _build_model(args.model, args.device)
    try:
        engine_cfg = EngineConfig(
            max_batch_slots=args.max_batch_slots,
            max_model_len=args.max_model_len,
            journal=args.journal_dir if args.replicas == 0 else None,
        )
        if args.replicas > 0:
            return Fleet(model, engine_cfg, FleetConfig(
                num_replicas=args.replicas,
                max_pending=args.max_pending,
                journal_dir=args.journal_dir,
            ))
        return Engine(model, engine_cfg)
    except ValueError as e:
        # engine/fleet config validation becomes a named CLI error
        raise ConfigError(str(e))


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd")
    sp = sub.add_parser("serve", help="start the HTTP API server")
    sp.add_argument("--model", required=True,
                    help="model preset name (e.g. tiny)")
    sp.add_argument("--device", default=None,
                    help="torch device of the engine (default: the CUDA "
                         "device; cpu on a machine without one)")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8000,
                    help="0 binds an ephemeral port (printed at start)")
    sp.add_argument("--journal-dir", default=None,
                    help="durable request journal directory")
    sp.add_argument("--compile-cache", default=None,
                    help="persistent compile cache directory (not ported)")
    sp.add_argument("--tp-degree", type=int, default=1,
                    help="tensor-parallel degree (only 1 is ported)")
    sp.add_argument("--replicas", type=int, default=0,
                    help="0 = single engine, N >= 1 = fleet of N")
    sp.add_argument("--max-pending", type=int, default=None,
                    help="fleet bounded-admission queue depth")
    sp.add_argument("--max-batch-slots", type=int, default=8)
    sp.add_argument("--max-model-len", type=int, default=2048)
    sp.add_argument("--api-key", action="append", metavar="KEY=TENANT",
                    help="map a bearer API key to a tenant (repeatable)")
    args = parser.parse_args(argv)
    if args.cmd != "serve":
        parser.print_help(sys.stderr)
        return 2
    try:
        # cheap flag validation first, so a bad --api-key fails before
        # the (expensive) model + engine build
        api_keys = _parse_api_keys(args.api_key)
        backend = _build_backend(args)
        from .qos import QoSConfig
        from .server import serve as _serve

        srv = _serve(backend, host=args.host, port=args.port,
                     qos=QoSConfig(api_keys=api_keys))
    except ConfigError as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"error: BindError: {e}", file=sys.stderr)
        return 2
    if args.replicas:
        what = (f"fleet of {args.replicas} on "
                f"{backend.replicas[0].engine.device}")
    else:
        what = f"engine on {backend.device}"
    print(f"paddle_tpu_torch serving on {srv.url} (model={args.model}, "
          f"{what})", flush=True)
    try:
        # foreground until SIGTERM drains + closes (or Ctrl-C)
        while not srv._closed:
            time.sleep(0.2)
    except KeyboardInterrupt:
        srv.drain(timeout=5.0)
        srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
