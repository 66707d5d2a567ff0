"""CLI: read flight-recorder postmortems / scrape the live registry.

Counterpart of ``python -m paddle_tpu.observability`` over the port's
flight recorder and metrics registry, with its subcommands, renders and
exit codes::

    python -m paddle_tpu_torch.observability dump            # newest postmortem
    python -m paddle_tpu_torch.observability dump FILE.json  # a specific one
    python -m paddle_tpu_torch.observability dump --list     # enumerate dumps
    python -m paddle_tpu_torch.observability metrics         # this process's
                                                             # exposition
    python -m paddle_tpu_torch.observability slo --url http://host:9100
                                                             # live percentile/
                                                             # burn snapshot
    python -m paddle_tpu_torch.observability slo --access-log DIR
                                                             # offline summary
    python -m paddle_tpu_torch.observability top --url http://host:9100
                                                             # live per-engine/
                                                             # per-program
                                                             # utilization table

Postmortems are written by ``observability.flight.dump`` on unhandled
engine errors and SIGUSR2; they live under ``$PADDLE_TPU_FLIGHT_DIR``
(default: the system temp dir). A dump renders its probes, the capture
log (one line per program capture; ``RETRACE`` for a program rebuilt
where it should be replayed), the last request timelines and serving
step samples, the goodput ledger and the host spill tier out of its
metrics snapshot, its events and the snapshot itself. The ``slo``
subcommand renders the latency-percentile / SLO-burn picture either
from a live scrape endpoint (the ``paddle_tpu_serving_latency_seconds``
summary and the burn gauges off ``/metrics``) or offline from a serving
access-log directory (the digests rebuilt from its JSONL lines; pass
``--ttft-p99-ms`` / ``--tpot-p99-ms`` to compute burn against targets).
``top`` renders the per-engine/per-program step-wall table, the
utilization gauges, the KV headroom and the spill tier off a scrape
endpoint. Exit codes: 0 rendered, 1 nothing to render (no dump, no
series, no records), 2 usage.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _fmt_ts(ts):
    try:
        return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))
    except (TypeError, ValueError, OSError):
        return str(ts)


def _render_dump(payload, out):
    out.write(
        f"flight recorder postmortem — reason: {payload.get('reason')}\n"
        f"  pid {payload.get('pid')}  at {_fmt_ts(payload.get('ts'))}\n"
    )
    probes = payload.get("probes") or {}
    if probes:
        out.write("-- probes " + "-" * 50 + "\n")
        for name, snap in probes.items():
            out.write(f"  {name}: {json.dumps(snap)}\n")
    clog = payload.get("compile_log") or []
    if clog:
        out.write("-- compile log (oldest first) " + "-" * 30 + "\n")
        for ev in clog:
            if ev.get("retrace"):
                mark = "RETRACE"
            else:
                mark = "compile"
            el = ev.get("elapsed_s")
            out.write(
                f"  {_fmt_ts(ev.get('ts'))} {mark:<8}"
                f" {ev.get('kind')}:{ev.get('fn')}"
                f" sig={ev.get('signature')}"
                + (f" {el:.3f}s" if el is not None else "")
                + "\n"
            )
    tls = payload.get("request_timelines") or []
    if tls:
        out.write(
            f"-- last {len(tls)} request timelines " + "-" * 30 + "\n"
        )
        for t in tls:
            phases = " ".join(
                f"{k[:-2]}={t[k]*1e3:.1f}ms"
                for k in ("queue_wait_s", "ttft_s", "tpot_s", "e2e_s")
                if isinstance(t.get(k), (int, float))
            )
            extra = " ".join(
                f"{k}={t[k]}"
                for k in ("prefill_chunks", "prefix_hit_tokens",
                          "spec_accepted", "preemptions", "hops")
                if t.get(k)
            )
            out.write(
                f"  rid={t.get('rid')} [{t.get('finish_reason')}] "
                f"{phases}" + (f" {extra}" if extra else "") + "\n"
            )
    steps = payload.get("step_samples") or []
    if steps:
        out.write(
            f"-- last {len(steps)} step samples " + "-" * 33 + "\n"
        )
        for s in steps:
            progs = " ".join(
                f"{p}={w:.1f}ms" for p, w in (s.get("launches") or [])
            )
            out.write(
                f"  {_fmt_ts(s.get('ts'))} eng={s.get('engine', '?')}"
                f" wall={s.get('wall_ms', 0):.1f}ms"
                f" host={s.get('host_ms', 0):.1f}ms"
                f" occ={s.get('occupancy', 0):.2f}"
                f" q={s.get('queue_depth', 0)}"
                f" tok={s.get('tokens', 0)}"
                f" kv_headroom={s.get('kv_headroom_blocks', 0)}"
                + (f" [{progs}]" if progs else "") + "\n"
            )
    _render_goodput_summary(payload.get("metrics") or {}, out)
    _render_spill_summary(payload.get("metrics") or {}, out)
    events = payload.get("events") or []
    if events:
        out.write(f"-- last {len(events)} events " + "-" * 38 + "\n")
        for ev in events:
            extra = {
                k: v for k, v in ev.items()
                if k not in ("ts", "category", "name")
            }
            out.write(
                f"  {_fmt_ts(ev.get('ts'))} [{ev.get('category')}] "
                f"{ev.get('name')}"
                + (f" {json.dumps(extra)}" if extra else "")
                + "\n"
            )
    m = payload.get("metrics") or {}
    if m:
        out.write("-- metrics snapshot " + "-" * 40 + "\n")
        for key in sorted(m):
            out.write(f"  {key} = {m[key]}\n")


def _render_goodput_summary(m, out):
    """Aggregate the step-observatory goodput ledger out of a metrics
    snapshot: ``paddle_tpu_serving_goodput_tokens_total{class=...}``
    summed per class (across engines), plus the per-engine goodput
    fraction / MFU gauges when present."""
    prefix = "paddle_tpu_serving_goodput_tokens_total{"
    ledger: dict = {}
    for k, v in m.items():
        if not k.startswith(prefix):
            continue
        labels = dict(
            part.split("=", 1)
            for part in k[len(prefix):-1].split(",") if "=" in part
        )
        cls = labels.get("class", "?")
        ledger[cls] = ledger.get(cls, 0) + v
    if not ledger:
        return
    out.write("-- goodput ledger (tokens) " + "-" * 33 + "\n")
    out.write("  " + " ".join(
        f"{cls}={ledger[cls]:g}" for cls in sorted(ledger)
    ) + "\n")
    for series, label in (
        ("paddle_tpu_serving_goodput_fraction", "goodput"),
        ("paddle_tpu_serving_mfu", "mfu"),
    ):
        vals = [
            (k, v) for k, v in sorted(m.items())
            if k == series or k.startswith(series + "{")
        ]
        for k, v in vals:
            eng = k[len(series):].strip("{}") or ""
            out.write(
                f"  {label}"
                + (f"[{eng}]" if eng else "")
                + f" = {v:.4f}\n"
            )


def _render_spill_summary(m, out):
    """Aggregate the host KV spill tier (serving/spill.py) out of a
    metrics snapshot: occupancy, restore hit rate, and the per-class
    spilled/restored byte counters — rendered next to the goodput
    ledger so a pressure review reads waste and its remedy together."""

    def by_label(series, label):
        prefix = series + "{"
        agg: dict = {}
        for k, v in m.items():
            if not k.startswith(prefix):
                continue
            labels = dict(
                part.split("=", 1)
                for part in k[len(prefix):-1].split(",") if "=" in part
            )
            key = labels.get(label, "?").strip('"')
            agg[key] = agg.get(key, 0) + v
        return agg

    occ = by_label("paddle_tpu_serving_spill_host_bytes", "engine")
    if not occ:
        return
    cap = by_label(
        "paddle_tpu_serving_spill_host_capacity_bytes", "engine"
    )
    hit = by_label("paddle_tpu_serving_spill_restore_hit_rate", "engine")
    spilled = by_label(
        "paddle_tpu_serving_spill_spilled_bytes_total", "class"
    )
    restored = by_label(
        "paddle_tpu_serving_spill_restored_bytes_total", "class"
    )
    out.write("-- kv spill tier " + "-" * 43 + "\n")
    for eng in sorted(occ):
        line = f"  engine {eng}: host={occ[eng]:g}B"
        if eng in cap:
            line += f"/{cap[eng]:g}B"
        if eng in hit:
            line += f" restore_hit_rate={hit[eng]:.3f}"
        out.write(line + "\n")
    if spilled or restored:
        out.write("  " + " ".join(
            f"spilled[{cls}]={spilled[cls]:g}B"
            for cls in sorted(spilled)
        ) + " " + " ".join(
            f"restored[{cls}]={restored[cls]:g}B"
            for cls in sorted(restored)
        ) + "\n")


_PROM_LINE = None   # compiled lazily in _parse_prom


def _parse_prom(text, family):
    """``[(labels_dict, value)]`` for one family's plain samples out
    of a Prometheus text exposition — just enough parser for the slo
    subcommand (no suffixes, no escapes beyond the exporter's own)."""
    import re

    global _PROM_LINE
    if _PROM_LINE is None:
        _PROM_LINE = re.compile(
            r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
            r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$"
        )
    out = []
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = _PROM_LINE.match(line.strip())
        if m is None or m.group("name") != family:
            continue
        labels = {}
        for part in (m.group("labels") or "").split(","):
            if "=" in part:
                k, v = part.split("=", 1)
                labels[k.strip()] = v.strip().strip('"')
        try:
            out.append((labels, float(m.group("value"))))
        except ValueError:
            continue
    return out


def _render_slo_table(rows, out):
    """``rows``: {scope: {phase: {quantile_str: value}}} -> one table
    of milliseconds."""
    qs = ("0.5", "0.9", "0.99")
    out.write(f"{'scope':<12} {'phase':<8} "
              + " ".join(f"{f'p{float(q)*100:g}':>10}" for q in qs)
              + f" {'count':>8}\n")
    for scope in sorted(rows):
        for phase in sorted(rows[scope]):
            vals = rows[scope][phase]
            out.write(
                f"{scope:<12} {phase:<8} "
                + " ".join(
                    f"{vals[q]*1e3:>8.1f}ms" if q in vals
                    else f"{'-':>10}"
                    for q in qs
                )
                + f" {int(vals.get('count', 0)):>8}\n"
            )


def _slo_live(url, out):
    import urllib.request

    text = urllib.request.urlopen(
        url.rstrip("/") + "/metrics", timeout=10
    ).read().decode()
    rows: dict = {}
    for labels, value in _parse_prom(
        text, "paddle_tpu_serving_latency_seconds"
    ):
        scope = (
            f"fleet {labels['fleet']}" if "fleet" in labels
            else f"engine {labels.get('engine', '?')}"
        )
        phase = labels.get("phase", "?")
        q = labels.get("quantile")
        if q is not None:
            rows.setdefault(scope, {}).setdefault(phase, {})[q] = value
    for labels, value in _parse_prom(
        text, "paddle_tpu_serving_latency_seconds_count"
    ):
        scope = (
            f"fleet {labels['fleet']}" if "fleet" in labels
            else f"engine {labels.get('engine', '?')}"
        )
        phase = labels.get("phase", "?")
        rows.setdefault(scope, {}).setdefault(
            phase, {}
        )["count"] = value
    if not rows:
        out.write("no paddle_tpu_serving_latency_seconds series at "
                  f"{url} (is a serving engine running?)\n")
        return 1
    _render_slo_table(rows, out)
    burns = (
        _parse_prom(text, "paddle_tpu_serving_slo_burn_rate")
        + _parse_prom(text, "paddle_tpu_fleet_slo_burn_rate")
    )
    for labels, value in burns:
        scope = ", ".join(
            f"{k}={v}" for k, v in sorted(labels.items())
            if k != "signal"
        )
        out.write(
            f"burn[{labels.get('signal')}] {scope}: {value:.2f}x"
            + ("  ** BURNING **" if value >= 1.0 else "") + "\n"
        )
    return 0


def _top_live(url, out):
    """Live serving-utilization snapshot off a scrape endpoint: the
    per-engine/per-program step-wall table
    (``paddle_tpu_serving_step_seconds``), then one utilization line
    per engine (occupancy / goodput fraction / MFU), then KV headroom
    per engine and per fleet replica."""
    import urllib.request

    text = urllib.request.urlopen(
        url.rstrip("/") + "/metrics", timeout=10
    ).read().decode()
    rows: dict = {}
    for labels, value in _parse_prom(
        text, "paddle_tpu_serving_step_seconds"
    ):
        q = labels.get("quantile")
        if q is not None:
            rows.setdefault(
                f"engine {labels.get('engine', '?')}", {}
            ).setdefault(labels.get("program", "?"), {})[q] = value
    for labels, value in _parse_prom(
        text, "paddle_tpu_serving_step_seconds_count"
    ):
        rows.setdefault(
            f"engine {labels.get('engine', '?')}", {}
        ).setdefault(labels.get("program", "?"), {})["count"] = value
    if not rows:
        out.write("no paddle_tpu_serving_step_seconds series at "
                  f"{url} (is a serving engine running with "
                  "stepstats enabled?)\n")
        return 1
    _render_slo_table(rows, out)
    util: dict = {}
    for series, label in (
        ("paddle_tpu_serving_occupancy", "occupancy"),
        ("paddle_tpu_serving_goodput_fraction", "goodput"),
        ("paddle_tpu_serving_mfu", "mfu"),
    ):
        for labels, value in _parse_prom(text, series):
            util.setdefault(
                labels.get("engine", "?"), {}
            )[label] = value
    for eng in sorted(util):
        vals = util[eng]
        out.write(f"engine {eng}: " + " ".join(
            f"{k}={vals[k]:.3f}"
            for k in ("occupancy", "goodput", "mfu") if k in vals
        ) + "\n")
    for labels, value in _parse_prom(
        text, "paddle_tpu_serving_kv_headroom_blocks"
    ):
        out.write(
            f"kv headroom: engine {labels.get('engine', '?')}"
            f" {int(value)} blocks\n"
        )
    for labels, value in _parse_prom(
        text, "paddle_tpu_fleet_replica_kv_headroom_blocks"
    ):
        out.write(
            f"kv headroom: fleet {labels.get('fleet', '?')}"
            f" replica {labels.get('replica', '?')}"
            f" {int(value)} blocks\n"
        )
    # host spill tier under the pool: occupancy + restore hit rate per
    # engine (the KV-headroom lines' second level — blocks that left
    # the device but are one host-to-device copy from coming back)
    spill_cap = {
        labels.get("engine", "?"): value
        for labels, value in _parse_prom(
            text, "paddle_tpu_serving_spill_host_capacity_bytes"
        )
    }
    spill_hit = {
        labels.get("engine", "?"): value
        for labels, value in _parse_prom(
            text, "paddle_tpu_serving_spill_restore_hit_rate"
        )
    }
    for labels, value in _parse_prom(
        text, "paddle_tpu_serving_spill_host_bytes"
    ):
        eng = labels.get("engine", "?")
        line = f"kv spill: engine {eng} host={value:g}B"
        if eng in spill_cap:
            line += f"/{spill_cap[eng]:g}B"
        if eng in spill_hit:
            line += f" restore_hit_rate={spill_hit[eng]:.3f}"
        out.write(line + "\n")
    return 0


def _slo_offline(directory, out, ttft_p99_ms=None, tpot_p99_ms=None):
    from ..serving.access_log import iter_records

    from .latency import LatencyDigest, SLOConfig, burn_from_counts

    digests = {
        p: LatencyDigest() for p in ("queue", "ttft", "tpot", "e2e")
    }
    reasons: dict = {}
    counts: dict = {}
    n = 0
    for rec in iter_records(directory):
        n += 1
        reasons[rec.get("finish_reason")] = (
            reasons.get(rec.get("finish_reason"), 0) + 1
        )
        aborted = rec.get("finish_reason") == "aborted"
        for phase, key in (
            ("queue", "queue_wait_s"), ("ttft", "ttft_s"),
            ("tpot", "tpot_s"), ("e2e", "e2e_s"),
        ):
            if aborted and phase in ("tpot", "e2e"):
                # mirror the live exclusion contract exactly: queue and
                # ttft are event-time samples (an abort AFTER admission
                # / first token keeps them live, so keep them here),
                # while finish-time samples (tpot/e2e) and the SLO burn
                # window exclude aborts — client aborts/hedge losers
                # are logged for visibility, not as delivery latency
                continue
            v = rec.get(key)
            if isinstance(v, (int, float)):
                digests[phase].record(v)
        if aborted:
            continue
        for sig, target in (("ttft", ttft_p99_ms),
                            ("tpot", tpot_p99_ms)):
            v = rec.get(f"{sig}_s")
            if target is None or not isinstance(v, (int, float)):
                continue
            counts[f"{sig}_total"] = counts.get(f"{sig}_total", 0) + 1
            if v * 1e3 > target:
                counts[f"{sig}_violations"] = (
                    counts.get(f"{sig}_violations", 0) + 1
                )
    if not n:
        out.write(f"no access-log records under {directory}\n")
        return 1
    out.write(f"{n} request(s): " + " ".join(
        f"{k}={v}" for k, v in sorted(reasons.items())
    ) + "\n")
    rows = {
        "offline": {
            p: {
                **{
                    f"{q:g}": d.quantile(q)
                    for q in (0.5, 0.9, 0.99)
                },
                "count": d.count,
            }
            for p, d in digests.items() if d.count
        }
    }
    _render_slo_table(rows, out)
    if ttft_p99_ms is not None or tpot_p99_ms is not None:
        cfg = SLOConfig(
            ttft_p99_ms=ttft_p99_ms, tpot_p99_ms=tpot_p99_ms,
        )
        for sig, burn in sorted(
            burn_from_counts(counts, cfg).items()
        ):
            if burn is None:
                continue
            out.write(
                f"burn[{sig}] vs p99 target: {burn:.2f}x"
                + ("  ** BURNING **" if burn >= 1.0 else "") + "\n"
            )
    return 0


def main(argv=None):
    from . import flight, metrics

    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability",
        description="flight-recorder postmortems and metrics",
    )
    sub = parser.add_subparsers(dest="cmd")
    p_dump = sub.add_parser("dump", help="render a postmortem file")
    p_dump.add_argument(
        "file", nargs="?", help="dump file (default: the newest)"
    )
    p_dump.add_argument(
        "--list", action="store_true", help="list available dumps"
    )
    sub.add_parser("metrics", help="print this process's exposition")
    p_slo = sub.add_parser(
        "slo",
        help="latency percentile / SLO burn snapshot (live or offline)",
    )
    p_slo.add_argument(
        "--url", help="scrape endpoint base URL (e.g. http://host:9100)"
    )
    p_slo.add_argument(
        "--access-log", dest="access_log",
        help="summarize a serving access-log directory offline",
    )
    p_slo.add_argument("--ttft-p99-ms", type=float, default=None)
    p_slo.add_argument("--tpot-p99-ms", type=float, default=None)
    p_top = sub.add_parser(
        "top",
        help="live per-engine/per-program serving utilization table",
    )
    p_top.add_argument(
        "--url", required=True,
        help="scrape endpoint base URL (e.g. http://host:9100)",
    )
    args = parser.parse_args(argv)

    if args.cmd == "top":
        return _top_live(args.url, sys.stdout)
    if args.cmd == "slo":
        if bool(args.url) == bool(args.access_log):
            print(
                "slo needs exactly one of --url or --access-log",
                file=sys.stderr,
            )
            return 2
        if args.url:
            return _slo_live(args.url, sys.stdout)
        return _slo_offline(
            args.access_log, sys.stdout,
            ttft_p99_ms=args.ttft_p99_ms,
            tpot_p99_ms=args.tpot_p99_ms,
        )
    if args.cmd == "metrics":
        sys.stdout.write(metrics.get_registry().render_prometheus())
        return 0
    if args.cmd != "dump":
        parser.print_help()
        return 2
    if args.list:
        for p in flight.find_dumps():
            print(p)
        return 0
    path = args.file
    if path is None:
        dumps = flight.find_dumps()
        if not dumps:
            print(
                f"no postmortems under {flight.dump_dir()} "
                "(set PADDLE_TPU_FLIGHT_DIR?)", file=sys.stderr,
            )
            return 1
        path = dumps[0]
    with open(path) as f:
        payload = json.load(f)
    print(f"# {path}")
    _render_dump(payload, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
