"""Exporters + validators for traces and metrics.

Port of `repro.obs.export`; the documents are the reference's.  Three
output formats:

* **Chrome trace-event JSON** — load in `chrome://tracing` or Perfetto.
  Spans become `ph:"X"` complete events (ts/dur in µs, rebased to the
  earliest span so traces start at 0), span events and orphan events
  become `ph:"i"` instants, and `args` carries span_id/parent_id plus
  the span attributes so the nesting is recoverable programmatically
  (Chrome's own nesting is per-tid stack-based; cross-thread parents —
  a queue span parented under another thread's batch span — survive in
  `args.parent_id` only, and `validate_chrome_trace` deliberately does
  NOT require child intervals inside the parent's for that reason).
* **JSON-lines event log** — one object per span/event/metrics-snapshot,
  grep- and pandas-friendly.
* **Prometheus text exposition** — every instrument of one or more
  `MetricsRegistry` sources as `<prefix>_<name>` families; histograms
  expand to cumulative `_bucket{le=...}` + `_sum`/`_count`, text
  instruments to `<name>_info{value="..."} 1`.  Multiple sources with
  the same prefix (per-entry operator registries) merge under one
  HELP/TYPE header, distinguished by caller-supplied labels.

The validators say what a well-formed document is: a trace must
have every span closed and every parent id resolvable; a metrics page
must be line-by-line well-formed with TYPE headers preceding samples.
"""
from __future__ import annotations

import json
import math
import re

__all__ = ["chrome_trace", "write_chrome_trace", "validate_chrome_trace",
           "write_jsonl", "prometheus_text", "validate_prometheus_text"]


def _json_safe(v):
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else repr(v)
    return str(v)


def _args(attrs: dict) -> dict:
    return {str(k): _json_safe(v) for k, v in attrs.items()}


# ----------------------------------------------------------------------
# Chrome trace-event format

def chrome_trace(tracer) -> dict:
    """Render a Tracer's finished spans/events as a trace-event document."""
    spans = tracer.spans()
    orphans = tracer.orphan_events()
    t0 = min(
        [sp.t_start for sp in spans if sp.t_start is not None]
        + [t for _, t, _, _ in orphans],
        default=0.0)

    def us(t):
        return (t - t0) * 1e6

    events = []
    for sp in spans:
        cat = sp.name.split(".", 1)[0]
        events.append({
            "name": sp.name, "cat": cat, "ph": "X",
            "ts": us(sp.t_start), "dur": max(0.0, us(sp.t_end) - us(sp.t_start)),
            "pid": 1, "tid": sp.tid or 0,
            "args": {"span_id": sp.span_id, "parent_id": sp.parent_id,
                     **_args(sp.attrs)},
        })
        for name, t, attrs in sp.events:
            events.append({
                "name": name, "cat": cat, "ph": "i", "s": "t",
                "ts": us(t), "pid": 1, "tid": sp.tid or 0,
                "args": {"span_id": sp.span_id, **_args(attrs)},
            })
    for name, t, attrs, tid in orphans:
        events.append({
            "name": name, "cat": name.split(".", 1)[0], "ph": "i", "s": "g",
            "ts": us(t), "pid": 1, "tid": tid,
            "args": _args(attrs),
        })
    events.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "clock": "perf_counter",
            "open_spans": [sp.name for sp in tracer.open_spans()],
        },
    }


def write_chrome_trace(path, tracer) -> dict:
    doc = chrome_trace(tracer)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
    return doc


def validate_chrome_trace(doc) -> list:
    """Schema check; returns a list of problem strings (empty == valid)."""
    problems = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document is not a dict with a traceEvents list"]
    open_spans = (doc.get("metadata") or {}).get("open_spans", [])
    if open_spans:
        problems.append(f"unclosed spans at export: {open_spans}")
    span_ids = set()
    parents = []
    for i, ev in enumerate(doc["traceEvents"]):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"{where}: missing name")
        if ev.get("ph") not in ("X", "i", "M"):
            problems.append(f"{where}: bad ph {ev.get('ph')!r}")
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"{where}: non-numeric ts")
        if ev.get("ph") == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where} ({ev.get('name')}): bad dur {dur!r}")
            sid = (ev.get("args") or {}).get("span_id")
            if sid is None:
                problems.append(f"{where} ({ev.get('name')}): no span_id")
            elif sid in span_ids:
                problems.append(f"{where}: duplicate span_id {sid}")
            else:
                span_ids.add(sid)
            pid = (ev.get("args") or {}).get("parent_id")
            if pid is not None:
                parents.append((where, ev.get("name"), pid))
    for where, name, pid in parents:
        if pid not in span_ids:
            problems.append(
                f"{where} ({name}): parent_id {pid} does not resolve")
    return problems


# ----------------------------------------------------------------------
# JSON-lines event log

def write_jsonl(path, tracer=None, registries=()) -> int:
    """One JSON object per line: spans, orphan events, then one metrics
    snapshot per registry. Returns the number of lines written."""
    lines = []
    if tracer is not None:
        for sp in tracer.spans():
            lines.append({
                "type": "span", "name": sp.name, "span_id": sp.span_id,
                "parent_id": sp.parent_id, "t_start": sp.t_start,
                "t_end": sp.t_end, "tid": sp.tid, "attrs": _args(sp.attrs),
                "events": [{"name": n, "t": t, "attrs": _args(a)}
                           for n, t, a in sp.events],
            })
        for name, t, attrs, tid in tracer.orphan_events():
            lines.append({"type": "event", "name": name, "t": t,
                          "tid": tid, "attrs": _args(attrs)})
    for reg in registries:
        lines.append({"type": "metrics", "prefix": reg.prefix,
                      "snapshot": reg.snapshot()})
    with open(path, "w") as fh:
        for obj in lines:
            fh.write(json.dumps(obj, default=str) + "\n")
    return len(lines)


# ----------------------------------------------------------------------
# Prometheus text exposition

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_OK = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")


def _metric_name(s: str) -> str:
    s = re.sub(r"[^a-zA-Z0-9_:]", "_", str(s))
    return s if _NAME_OK.match(s) else "_" + s


def _label_str(pairs) -> str:
    parts = []
    for k, v in pairs:
        k = re.sub(r"[^a-zA-Z0-9_]", "_", str(k))
        v = str(v).replace("\\", r"\\").replace('"', r"\"")
        v = v.replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def _num(v) -> str:
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v) if isinstance(v, float) else str(v)


def _family_lines(inst, extra, out):
    """Sample lines for one instrument under `extra` source labels."""
    if inst.kind == "histogram":
        for key, st in inst.series().items():
            base = list(extra) + list(key)
            cum = 0
            for bound, n in zip(list(inst.bounds) + [float("inf")],
                                st["buckets"]):
                cum += n
                le = "+Inf" if math.isinf(bound) else _num(bound)
                out.append(("_bucket",
                            _label_str(base + [("le", le)]), cum))
            out.append(("_sum", _label_str(base), st["sum"]))
            out.append(("_count", _label_str(base), st["count"]))
    elif inst.kind == "text":
        for key, s in inst.series().items():
            out.append(("_info",
                        _label_str(list(extra) + list(key) + [("value", s)]),
                        1))
    else:
        for key, v in inst.series().items():
            out.append(("", _label_str(list(extra) + list(key)), v))


def prometheus_text(*sources) -> str:
    """Render registries as a Prometheus text page.

    Each source is a `MetricsRegistry` or a `(registry, labels_dict)`
    pair; the labels are attached to every sample from that source
    (module doc: how per-entry operator registries merge).
    """
    families: dict = {}       # full name -> (kind, help, [(suffix, labels, value)])
    for src in sources:
        reg, extra = (src if isinstance(src, tuple) else (src, {}))
        extra = tuple(sorted(extra.items()))
        for inst in reg.collect():
            full = _metric_name(f"{reg.prefix}_{inst.name}")
            kind = "gauge" if inst.kind == "text" else inst.kind
            fam = families.setdefault(full, (kind, inst.help, []))
            _family_lines(inst, extra, fam[2])
    chunks = []
    for full, (kind, help, samples) in families.items():
        if help:
            chunks.append(f"# HELP {full} {help}")
        chunks.append(f"# TYPE {full} {kind}")
        for suffix, labels, value in samples:
            chunks.append(f"{full}{suffix}{labels} "
                          f"{_num(value) if not isinstance(value, int) else value}")
    return "\n".join(chunks) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"              # metric name
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r" (NaN|[+-]?Inf|[+-]?[0-9.eE+-]+)$")
_SUFFIX_RE = re.compile(r"(_bucket|_sum|_count|_info)$")


def validate_prometheus_text(text: str) -> list:
    """Line-by-line exposition-format check; returns problem strings."""
    problems = []
    typed: set = set()
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            m = re.match(r"^# (HELP|TYPE) ([a-zA-Z_:][a-zA-Z0-9_:]*) .+$",
                         line)
            if not m:
                problems.append(f"line {ln}: malformed comment: {line!r}")
            elif m.group(1) == "TYPE":
                if m.group(2) in typed:
                    problems.append(
                        f"line {ln}: duplicate TYPE for {m.group(2)}")
                typed.add(m.group(2))
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            problems.append(f"line {ln}: malformed sample: {line!r}")
            continue
        name = m.group(1)
        base = _SUFFIX_RE.sub("", name)
        if name not in typed and base not in typed:
            problems.append(f"line {ln}: sample before TYPE: {name}")
        try:
            float(m.group(3))
        except ValueError:
            problems.append(f"line {ln}: bad value {m.group(3)!r}")
    return problems
