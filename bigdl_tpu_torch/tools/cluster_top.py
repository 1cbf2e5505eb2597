"""Console summary of a cluster telemetry run directory (counterpart of
tools/cluster_top.py, which imports the JAX package).

One-shot (default) or ``--watch`` view over the segments the
TelemetryShipper flushes: per-host step time, MFU, throughput, queue
depth, and federated-watchdog flags, plus the cluster rollup
(p50/p95/p99, world throughput, straggler skew).

    python -m bigdl_tpu_torch.tools.cluster_top RUN_DIR
    python -m bigdl_tpu_torch.tools.cluster_top RUN_DIR --watch 2
    python -m bigdl_tpu_torch.tools.cluster_top RUN_DIR --json
    python -m bigdl_tpu_torch.tools.cluster_top RUN_DIR --trace out.json
    python -m bigdl_tpu_torch.tools.cluster_top RUN_DIR --live 2

``--live`` switches from the file plane to the live ops plane: each
host's ``debug_addr`` (stamped into its segment headers by the
TelemetryShipper when a debug server is up) is polled over HTTP —
``/statusz`` for role/uptime/engines and ``/metricsz`` for the
Prometheus families — so the table reflects *now*, not the last flush.
Hosts without a reachable endpoint fall back to their file-plane row.
Its output is the JAX tool's on the same directory; either package's
segments merge.
"""
import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request

from bigdl_tpu_torch.telemetry.cluster import (
    ClusterAggregator,
    FederatedWatchdog,
)


def render(summary, flags) -> str:
    """Fixed-width console table from a cluster_summary() dict."""
    c = summary["cluster"]
    skew = c["straggler_skew_ms"]
    gskew = c.get("grad_norm_skew") or {}
    head = (
        f"cluster: hosts={c['hosts']} "
        f"step p50={c['step_p50_ms']:.2f}ms "
        f"p95={c['step_p95_ms']:.2f}ms p99={c['step_p99_ms']:.2f}ms | "
        f"world {c['world_throughput']:.1f} rec/s | "
        f"skew mean={skew['mean']:.2f}ms max={skew['max']:.2f}ms "
        f"over {skew['n_steps']} steps")
    if gskew.get("hosts"):
        # hosts disagreeing on the (post-allreduce) grad norm is the
        # corrupt-data-host signature
        head += (f" | gnorm mean={gskew['mean']:.3g} "
                 f"spread={gskew['rel_spread']:.1%}")
    lines = [
        head,
        f"{'host':<12} {'gen':>3} {'steps':>6} {'p50 ms':>8} "
        f"{'p99 ms':>8} {'mfu %':>6} {'rec/s':>8} {'gnorm':>9} "
        f"{'qdepth':>6} {'age s':>6}  flags",
    ]
    for host, s in sorted(summary["per_host"].items()):
        age = s["last_flush_age_s"]
        gn = s.get("grad_norm", 0.0)
        lines.append(
            f"{host:<12} {s['gen']:>3} {s['n_steps']:>6} "
            f"{s['step_p50_ms']:>8.2f} {s['step_p99_ms']:>8.2f} "
            f"{100.0 * s['mfu']:>6.2f} {s['throughput']:>8.1f} "
            f"{gn:>9.3g} {s['queue_depth']:>6} "
            f"{age if age is not None else float('nan'):>6.1f}  "
            f"{','.join(flags.get(host, [])) or '-'}")
    return "\n".join(lines)


def _http_get(addr, path, timeout=1.0):
    """Body of http://<addr><path>, or None when unreachable."""
    try:
        with urllib.request.urlopen(
                f"http://{addr}{path}", timeout=timeout) as resp:
            return resp.read().decode("utf-8", "replace")
    except (urllib.error.URLError, OSError, ValueError):
        return None


def parse_prometheus(text):
    """{(metric, (sorted label pairs)): float} from exposition text.

    Minimal parser for our own /metricsz output — enough to pick
    single samples out of the families cluster_top renders.
    """
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            left, value = line.rsplit(" ", 1)
            if "{" in left:
                name, rest = left.split("{", 1)
                labels = []
                for pair in rest.rstrip("}").split(","):
                    if not pair:
                        continue
                    k, v = pair.split("=", 1)
                    labels.append((k, v.strip('"')))
                key = (name, tuple(sorted(labels)))
            else:
                key = (left, ())
            out[key] = float(value)
        except ValueError:
            continue
    return out


def _prom_pick(prom, family, **labels):
    """First sample of `family` whose labels include `labels`."""
    want = set(labels.items())
    for (metric, pairs), value in prom.items():
        if metric == family and want.issubset(set(pairs)):
            return value
    return None


def poll_host(addr, timeout=1.0):
    """Scrape one host's /statusz + /metricsz into a row dict.

    Returns None when the endpoint is unreachable (caller falls back
    to the file-plane row for that host).
    """
    raw = _http_get(addr, "/statusz", timeout)
    if raw is None:
        return None
    try:
        status = json.loads(raw)
    except ValueError:
        return None
    row = {"addr": addr,
           "role": status.get("role", ""),
           "pid": status.get("pid"),
           "uptime_s": status.get("uptime_s"),
           "generation": status.get("generation"),
           "engines": sorted(
               e.get("name", "?") for e in status.get("engines", [])
               if isinstance(e, dict)),
           "tracer_spans": (status.get("tracer") or {}).get("spans")}
    text = _http_get(addr, "/metricsz", timeout)
    if text is not None:
        prom = parse_prometheus(text)
        row["dispatches"] = _prom_pick(
            prom, "bigdl_tpu_phase_count_total", phase="dispatch")
        row["step_ms"] = _prom_pick(
            prom, "bigdl_tpu_phase_quantile_seconds",
            phase="dispatch", quantile="0.5")
        if row["step_ms"] is not None:
            row["step_ms"] *= 1e3
        row["throughput"] = _prom_pick(
            prom, "bigdl_tpu_value", name="throughput")
        row["mfu"] = _prom_pick(prom, "bigdl_tpu_value", name="mfu")
        row["hbm_in_use"] = _prom_pick(
            prom, "bigdl_tpu_hbm_bytes", kind="in_use")
        # decode-engine snapshot scalars (None when the host runs no
        # decode engine — the columns render as '-')
        row["pages_in_use"] = _prom_pick(
            prom, "bigdl_tpu_snapshot", key="pages_in_use")
        row["spec_acceptance_rate"] = _prom_pick(
            prom, "bigdl_tpu_snapshot", key="spec_acceptance_rate")
        row["prefill_chunks"] = _prom_pick(
            prom, "bigdl_tpu_snapshot", key="prefill_chunks")
    return row


def live_poll(summary, timeout=1.0):
    """{host: row-or-None} for every host the file plane knows about."""
    rows = {}
    for host, s in sorted(summary.get("per_host", {}).items()):
        addr = s.get("debug_addr")
        rows[host] = poll_host(addr, timeout) if addr else None
    return rows


def _num(v, fmt, width):
    return f"{v:>{width}{fmt}}" if v is not None else f"{'-':>{width}}"


def render_live(rows, summary, flags) -> str:
    """Live table: one row per host, scraped rows marked `live`."""
    n_live = sum(1 for r in rows.values() if r)
    lines = [
        f"live ops plane: {n_live}/{len(rows)} hosts reachable",
        f"{'host':<12} {'plane':<5} {'role':<6} {'up s':>7} "
        f"{'steps':>7} {'p50 ms':>8} {'rec/s':>8} {'mfu %':>6} "
        f"{'pages':>6} {'spec %':>6} {'chunks':>6} "
        f"{'spans':>6}  addr",
    ]
    per_host = summary.get("per_host", {})
    for host in sorted(rows):
        r = rows[host]
        if r is not None:
            spec = r.get("spec_acceptance_rate")
            lines.append(
                f"{host:<12} {'live':<5} {r['role'] or '-':<6} "
                f"{_num(r['uptime_s'], '.1f', 7)} "
                f"{_num(r.get('dispatches'), '.0f', 7)} "
                f"{_num(r.get('step_ms'), '.2f', 8)} "
                f"{_num(r.get('throughput'), '.1f', 8)} "
                f"{_num(100.0 * r['mfu'] if r.get('mfu') is not None else None, '.2f', 6)} "
                f"{_num(r.get('pages_in_use'), '.0f', 6)} "
                f"{_num(100.0 * spec if spec is not None else None, '.1f', 6)} "
                f"{_num(r.get('prefill_chunks'), '.0f', 6)} "
                f"{_num(r.get('tracer_spans'), 'd', 6)}  {r['addr']}")
        else:
            s = per_host.get(host, {})
            lines.append(
                f"{host:<12} {'file':<5} {'-':<6} {'-':>7} "
                f"{_num(s.get('n_steps'), 'd', 7)} "
                f"{_num(s.get('step_p50_ms'), '.2f', 8)} "
                f"{_num(s.get('throughput'), '.1f', 8)} "
                f"{_num(100.0 * s['mfu'] if s.get('mfu') is not None else None, '.2f', 6)} "
                f"{'-':>6} {'-':>6} {'-':>6} "
                f"{'-':>6}  {s.get('debug_addr') or 'no endpoint'}"
                f"{'  flags=' + ','.join(flags.get(host, [])) if flags.get(host) else ''}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="cluster telemetry console summary")
    ap.add_argument("run_dir", help="shared telemetry run directory "
                    "(BIGDL_TPU_TELEMETRY_DIR)")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SECS",
                    help="refresh every SECS (0 = one-shot)")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary + flags as JSON")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="also write the merged Perfetto trace to PATH")
    ap.add_argument("--live", type=float, default=None, metavar="SECS",
                    help="poll each host's debug endpoint over HTTP, "
                    "refreshing every SECS (0 = one-shot); hosts "
                    "without a reachable endpoint fall back to their "
                    "file-plane row")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.run_dir):
        print(f"cluster_top: no such directory: {args.run_dir}",
              file=sys.stderr)
        return 2

    fed = FederatedWatchdog(args.run_dir, log=None)
    while True:
        agg = ClusterAggregator(args.run_dir).load()
        flags = fed.check(agg)
        summary = fed._last_summary
        if args.live is not None:
            rows = live_poll(summary)
            if args.json:
                print(json.dumps({"live": rows, "flags": flags},
                                 sort_keys=True))
            else:
                print(render_live(rows, summary, flags))
        elif args.json:
            print(json.dumps({"summary": summary, "flags": flags},
                             sort_keys=True))
        else:
            print(render(summary, flags))
        if args.trace:
            agg.write_trace(args.trace)
        interval = args.live if args.live is not None else args.watch
        if interval <= 0:
            return 0
        time.sleep(interval)
        if not args.json:
            print()


if __name__ == "__main__":
    sys.exit(main())
