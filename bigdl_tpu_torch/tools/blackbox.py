"""Black-box console: post-mortem view of a flight-recorder bundle
(counterpart of tools/blackbox.py, which imports the JAX package).

The :class:`~bigdl_tpu_torch.telemetry.flightrecorder.FlightRecorder` dumps a
``blackbox-<host>-<ts>-<pid>-<seq>/`` directory when a run dies or
diverges.  This tool renders one bundle as a single-screen post-mortem:
what fired and when, the last spans each thread was in, the last
recompile the forensics saw, HBM headroom at death, watchdog counters,
and the numerics tail — the questions an operator asks first.

    python -m bigdl_tpu_torch.tools.blackbox /path/to/blackbox-host-.../
    python -m bigdl_tpu_torch.tools.blackbox /path/to/run/dir  # the newest
    python -m bigdl_tpu_torch.tools.blackbox <bundle> --json
    python -m bigdl_tpu_torch.tools.blackbox <bundle> --threads  # stacks

Its output is the JAX tool's on the same bundle, and it reads either
package's bundles (their files and fields are the same).
"""
import argparse
import json
import os
import sys

from bigdl_tpu_torch.telemetry.flightrecorder import BUNDLE_PREFIX


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _read_jsonl(path):
    records = []
    try:
        with open(path) as f:
            raw = f.read()
    except OSError:
        return records
    for line in raw.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            records.append(rec)
    return records


def resolve_bundle(path):
    """Accept a bundle dir, or a dir of bundles (newest wins)."""
    base = os.path.basename(os.path.normpath(path))
    if base.startswith(BUNDLE_PREFIX):
        return path
    try:
        names = sorted(n for n in os.listdir(path)
                       if n.startswith(BUNDLE_PREFIX)
                       and os.path.isdir(os.path.join(path, n)))
    except OSError:
        return path
    return os.path.join(path, names[-1]) if names else path


def load_bundle(path):
    """Parse one blackbox bundle into a plain dict.

    Missing pieces load as None/[] — a bundle from a hard crash may be
    partial, and the post-mortem must still render.
    """
    path = resolve_bundle(path)
    manifest = _read_json(os.path.join(path, "manifest.json")) or {}
    trace = _read_json(os.path.join(path, "trace.json")) or {}
    bundle = {
        "path": path,
        "manifest": manifest,
        "events": trace.get("traceEvents", []),
        "metrics": _read_jsonl(os.path.join(path, "metrics.jsonl")),
        "xray": _read_json(os.path.join(path, "xray.json")),
        "watchdog": _read_json(os.path.join(path, "watchdog.json")),
        "threads_txt": None,
    }
    try:
        with open(os.path.join(path, "threads.txt")) as f:
            bundle["threads_txt"] = f.read()
    except OSError:
        pass
    # extra blobs (numerics.json etc.) registered via add_blob()
    core = {"manifest.json", "trace.json", "metrics.jsonl",
            "xray.json", "watchdog.json", "threads.txt"}
    blobs = {}
    for name in manifest.get("files", []):
        if name in core or not name.endswith(".json"):
            continue
        blob = _read_json(os.path.join(path, name))
        if blob is not None:
            blobs[name[:-len(".json")]] = blob
    bundle["blobs"] = blobs
    return bundle


def last_spans_per_thread(events, per_thread=3):
    """{thread_name: [last span names, oldest first]} from trace events."""
    names = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev.get("tid")] = ev.get("args", {}).get("name")
    out = {}
    for ev in events:
        if ev.get("ph") not in ("X", "i"):
            continue
        tid = ev.get("tid")
        label = names.get(tid) or f"tid-{tid}"
        tag = ev.get("name", "?")
        if ev.get("ph") == "i":
            tag = f"[{tag}]"
        out.setdefault(label, []).append(tag)
    return {k: v[-per_thread:] for k, v in sorted(out.items())}


def _fmt_bytes(n):
    if n is None:
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return "?"


def summarize(bundle):
    """Machine-readable post-mortem (the --json payload)."""
    man = bundle["manifest"]
    xray = bundle["xray"] or {}
    hbm = (xray.get("hbm") or {}).get("last") or {}
    forensics = xray.get("forensics") or []
    wd = bundle["watchdog"] or {}
    summary = {
        "record": "blackbox_summary",
        "path": bundle["path"],
        "trigger": man.get("trigger"),
        "note": man.get("note"),
        "host": man.get("host"),
        "pid": man.get("pid"),
        "unix_time": man.get("unix_time"),
        "uptime_s": man.get("uptime_s"),
        "n_spans": man.get("n_spans"),
        "knobs": man.get("knobs", {}),
        "last_spans": last_spans_per_thread(bundle["events"]),
        "last_recompile": forensics[-1] if forensics else None,
        "hbm": {"bytes_in_use": hbm.get("bytes_in_use"),
                "peak_bytes": (xray.get("hbm") or {}).get("peak_bytes"),
                "bytes_limit": hbm.get("bytes_limit"),
                "frac_free": hbm.get("frac_free")} if hbm else None,
        "watchdog": {"counters": wd.get("counters", {}),
                     "anomalies": wd.get("anomalies", [])[-3:]}
        if wd else None,
        "numerics": (bundle["blobs"].get("numerics") or {}).get("last"),
        "last_metrics": bundle["metrics"][-1] if bundle["metrics"]
        else None,
    }
    return summary


def render(bundle):
    s = summarize(bundle)
    man = bundle["manifest"]
    lines = []
    lines.append(f"black box  {s['path']}")
    when = s["unix_time"]
    import datetime
    stamp = (datetime.datetime.fromtimestamp(when).isoformat(sep=" ")
             if when else "?")
    lines.append(f"  trigger   {s['trigger'] or '?'}  at {stamp}  "
                 f"host={s['host']} pid={s['pid']} "
                 f"uptime={s['uptime_s']}s")
    if s["note"]:
        lines.append(f"  note      {s['note']}")
    lines.append(f"  capture   {s['n_spans'] or 0} spans, "
                 f"{man.get('n_metrics_records', 0)} metrics records, "
                 f"{len(man.get('files', []))} files")
    if s["last_spans"]:
        lines.append("  last spans per thread:")
        for thread, tags in s["last_spans"].items():
            lines.append(f"    {thread:<24} {' -> '.join(tags)}")
    rc = s["last_recompile"]
    if rc:
        lines.append(f"  last recompile  {rc.get('name', '?')}: "
                     f"{rc.get('cause', rc.get('reason', '?'))}")
    if s["hbm"]:
        h = s["hbm"]
        frac = h.get("frac_free")
        lines.append(
            f"  hbm       in_use={_fmt_bytes(h.get('bytes_in_use'))} "
            f"peak={_fmt_bytes(h.get('peak_bytes'))} "
            f"limit={_fmt_bytes(h.get('bytes_limit'))}"
            + (f" frac_free={frac:.3f}" if frac is not None else ""))
    if s["watchdog"]:
        counters = {k: v for k, v in
                    s["watchdog"]["counters"].items() if v}
        if counters:
            lines.append(f"  watchdog  {counters}")
        for a in s["watchdog"]["anomalies"]:
            lines.append(f"    anomaly {a.get('counter', '?')}: "
                         f"{a.get('message', '')}"[:76])
    if s["numerics"]:
        keys = ("grad_norm", "update_ratio", "nonfinite", "loss")
        tail = {k: s["numerics"][k] for k in keys if k in s["numerics"]}
        lines.append(f"  numerics  {tail or s['numerics']}")
    if s["last_metrics"]:
        phases = s["last_metrics"].get("phases", {})
        if phases:
            txt = " ".join(
                f"{k}={v.get('count')}x{v.get('mean_ms')}ms"
                for k, v in sorted(phases.items()))
            lines.append(f"  phases    {txt}"[:78])
    if s["knobs"]:
        lines.append("  knobs     " + " ".join(
            f"{k.replace('BIGDL_TPU_', '')}={v}"
            for k, v in sorted(s["knobs"].items()))[:66])
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="render a flight-recorder blackbox bundle")
    ap.add_argument("path", help="bundle dir, or a run/telemetry dir "
                    "(newest bundle is picked)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable summary")
    ap.add_argument("--threads", action="store_true",
                    help="print the full per-thread tracebacks")
    args = ap.parse_args(argv)

    bundle = load_bundle(args.path)
    if not bundle["manifest"]:
        print(f"no blackbox bundle at {args.path}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(summarize(bundle), indent=1, sort_keys=True))
    else:
        print(render(bundle))
        if args.threads and bundle["threads_txt"]:
            print("\n" + bundle["threads_txt"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
