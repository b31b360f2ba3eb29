"""Cross-process trace stitching + Chrome/Perfetto trace export
(``bigdl_tpu/observability/trace.py``).

The ledger writes one ``events-<pid>.jsonl`` file per process (trainer,
ingest workers, serving drill subprocesses ...), which a reader
merged by timestamp — fine for censuses, useless for causality: nothing
said *which* ``data.next`` span a worker's ``ingest.decode`` chunk was
serving.  This module adds the missing two pieces:

* **trace context propagation** — a run-scoped trace id
  (:func:`trace_id`, published via ``BIGDL_TPU_TRACE_ID`` so spawned
  children inherit it) plus :func:`current_wire` / :func:`attach`: the
  submitting side captures ``(trace, pid, span)`` as a plain picklable
  tuple, ships it with the task (ingest chunk jobs, serving worker
  inbox items), and the receiving side re-opens it — every top-level
  span under ``attach`` then carries ``link``/``link_pid`` fields
  pointing at the submitting span.  Links are causal, not containment:
  the report's exclusive-time math never crosses a boundary, while the
  exporter renders them as flow arrows.
* **trace export** — ``python -m bigdl_tpu_torch.cli trace-export <run_dir>``
  reconstructs ONE Chrome trace-event JSON from all the per-pid files:
  spans become ``X`` duration events on their real pid/tid rows,
  compile/io records land beside them, resilience events become
  instants, per-step loss becomes a counter track, and every
  cross-process link becomes a flow arrow — load the file in
  ``chrome://tracing`` or https://ui.perfetto.dev and the multi-process
  run reads as one causal timeline.

Dependency-free on purpose (stdlib + ledger + tracer): ingest worker
processes attach contexts without importing torch, and the exporter is
pure file reading.  ``--fleet`` (a fleet directory of per-host run dirs)
comes with the port's cross-host cluster and raises until then.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from bigdl_tpu_torch.observability import ledger
from bigdl_tpu_torch.observability import tracer
from bigdl_tpu_torch.observability.ledger import trace_id

__all__ = ["trace_id", "current_wire", "attach", "build_trace",
           "stitch_stats", "export_file", "main"]


# -- context propagation ------------------------------------------------------

def current_wire() -> Optional[Tuple[str, int, Optional[int]]]:
    """This thread's trace context as a plain picklable tuple
    ``(trace_id, pid, span_id)`` — ship it across a process/thread
    boundary and :func:`attach` it on the other side.  ``None`` when
    the ledger is off (so disabled runs pay nothing, not even the
    tuple)."""
    if not ledger.enabled():
        return None
    return (trace_id(), os.getpid(), tracer.current_span())


@contextlib.contextmanager
def attach(wire: Optional[Tuple[str, int, Optional[int]]]):
    """Adopt a shipped trace context for the duration of the block:
    top-level spans opened inside it link back to the submitting span
    (``link``/``link_pid`` record fields).  ``attach(None)`` is a free
    no-op, so call sites never need their own ledger check.  Re-entrant:
    a nested attach restores the outer context on exit instead of
    clearing it."""
    if wire is None or wire[2] is None:
        yield
        return
    prev = tracer.swap_remote_parent((int(wire[1]), int(wire[2])))
    try:
        yield
    finally:
        tracer.swap_remote_parent(prev)


# -- export -------------------------------------------------------------------

def _us(ts: float) -> float:
    return ts * 1e6


def _pid_roles(records: List[dict]) -> Dict[int, str]:
    """Best-effort role name per pid for the process_name metadata —
    ``run.start`` kinds win, ingest-span-only pids are workers, pids
    that only ever submitted over the fleet bus are clients."""
    roles: Dict[int, str] = {}
    for r in records:
        if r.get("type") == "run.start" and "_pid" in r:
            roles.setdefault(r["_pid"], str(r.get("kind", "run")))
    for r in records:
        pid = r.get("_pid")
        if pid in roles or pid is None:
            continue
        if r.get("type") == "span":
            name = str(r.get("name", ""))
            if name.startswith("ingest."):
                roles[pid] = "ingest-worker"
            elif name == "fleet.submit":
                roles[pid] = "fleet-client"
    return roles


def _span_links(r: dict):
    """Every causal link edge one span record carries: the attached-wire
    ``link``/``link_pid`` pair plus each extra ``links`` entry (the
    salvage path's second parent).  Yields ``(link_pid, link)``."""
    if "link" in r:
        yield (r.get("link_pid"), r.get("link"))
    for pair in (r.get("links") or ()):
        try:
            yield (pair[0], pair[1])
        except (IndexError, TypeError):
            continue


def _claim_anchors(records: List[dict]) -> Dict[Tuple[int, int], dict]:
    """``bus.claim`` events by ``(pid, span)`` — the durable anchor a
    SIGKILLed host leaves behind.  A span record only reaches disk at
    ``end()``; a host killed mid-dispatch never writes it, but the
    ``emit_critical``'d claim event carries the same span id, so
    salvage-time links can resolve against the claim instead of
    dangling on the dead host's unflushed buffer."""
    anchors: Dict[Tuple[int, int], dict] = {}
    for r in records:
        if (r.get("type") == "event" and r.get("kind") == "bus.claim"
                and r.get("span") is not None and "_pid" in r):
            anchors.setdefault((r["_pid"], int(r["span"])), r)
    return anchors


def stitch_stats(records: List[dict]) -> Dict[str, Any]:
    """How well the per-pid files stitch: distinct pids, cross-boundary
    link edges, and how many of those edges resolve to a span that is
    actually present (an unresolved edge usually means a worker died
    before its ledger flushed)."""
    spans = {(r["_pid"], r.get("span")): r for r in records
             if r.get("type") == "span"}
    anchors = _claim_anchors(records)
    pids = {r["_pid"] for r in records if "_pid" in r}
    edges = resolved = cross_pid = 0
    for r in records:
        if r.get("type") != "span":
            continue
        for link_pid, link in _span_links(r):
            edges += 1
            src = (link_pid, link)
            if src in spans or src in anchors:
                resolved += 1
            if link_pid != r["_pid"]:
                cross_pid += 1
    return {"pids": len(pids), "link_edges": edges,
            "resolved_edges": resolved, "cross_pid_edges": cross_pid}


def build_trace(records: List[dict],
                since_s: Optional[float] = None) -> Dict[str, Any]:
    """Chrome trace-event JSON (object form) from merged ledger records.
    ``since_s`` keeps only the trailing window of the run — the
    triggered-capture mode exports the last N seconds around an SLO
    breach instead of the whole history."""
    if since_s is not None and records:
        horizon = max(r.get("ts", 0.0) for r in records) - float(since_s)
        keep = {"trace.bind", "run.start"}

        def _in_window(r) -> bool:
            # span ts stamps the START; a long span that ENDS inside
            # the window (the hung forward that caused the breach —
            # exactly what a capture exists to show) must be kept, so
            # spans are judged on their end time
            return (r.get("ts", 0.0) + (r.get("dur_s", 0.0)
                    if r.get("type") == "span" else 0.0)) >= horizon

        records = [r for r in records
                   if _in_window(r) or r.get("type") in keep]

    events: List[dict] = []
    tid_of = lambda r: r.get("thread", 0)  # noqa: E731

    # a fleet-merged record set (load_fleet) tags every record with its
    # host label; prefix the process rows so the Perfetto timeline reads
    # host-by-host.  (pids stay the row key — unique on one box; a
    # cross-box fleet with colliding pids would need a pid remap here.)
    host_of: Dict[int, str] = {}
    for r in records:
        if "_host" in r and "_pid" in r:
            host_of.setdefault(r["_pid"], str(r["_host"]))
    for pid, role in sorted(_pid_roles(records).items()):
        label = f"{role} [{pid}]"
        if pid in host_of:
            label = f"{host_of[pid]}:{label}"
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": label}})

    span_index: Dict[Tuple[int, Optional[int]], dict] = {}
    links: List[dict] = []
    for r in records:
        t = r.get("type")
        pid = r.get("_pid", 0)
        if t == "span":
            span_index[(pid, r.get("span"))] = r
            args = dict(r.get("attrs") or {})
            args["span"] = r.get("span")
            if "parent" in r:
                args["parent"] = r["parent"]
            if r.get("error"):
                args["error"] = r["error"]
            events.append({"ph": "X", "cat": "span",
                           "name": str(r.get("name", "?")),
                           "pid": pid, "tid": tid_of(r),
                           "ts": _us(r.get("ts", 0.0)),
                           "dur": _us(r.get("dur_s", 0.0)),
                           "args": args})
            if "link" in r or r.get("links"):
                links.append(r)
        elif t in ("compile", "io"):
            # emitted at completion: ts stamps the END, back the start out
            dur = float(r.get("dur_s", 0.0))
            events.append({"ph": "X", "cat": t,
                           "name": (f"compile:{r.get('event', '?')}"
                                    if t == "compile"
                                    else str(r.get("name", "io"))),
                           "pid": pid, "tid": tid_of(r),
                           "ts": _us(r.get("ts", 0.0) - dur),
                           "dur": _us(dur)})
        elif t in ("serve.request", "serve.batch"):
            dur = float(r.get("dur_s", 0.0))
            args = {k: v for k, v in r.items()
                    if k not in ("type", "ts", "mono", "_pid", "dur_s")}
            events.append({"ph": "X", "cat": "serve", "name": t,
                           "pid": pid, "tid": tid_of(r),
                           "ts": _us(r.get("ts", 0.0) - dur),
                           "dur": _us(dur), "args": args})
        elif t == "step":
            if r.get("loss") is not None:
                events.append({"ph": "C", "name": "loss", "pid": pid,
                               "tid": 0, "ts": _us(r.get("ts", 0.0)),
                               "args": {"loss": r["loss"]}})
        elif t == "event":
            kind = str(r.get("kind", "event"))
            # fleet-scope moments — a generation commit, a lost lease, a
            # dead host — mark the WHOLE merged timeline, not one process
            scope = "g" if kind in ("elastic.generation",
                                    "elastic.lease_lost", "elastic.left",
                                    "fleet.host.lost") else "p"
            events.append({"ph": "i", "s": scope, "cat": "event",
                           "name": kind,
                           "pid": pid, "tid": tid_of(r),
                           "ts": _us(r.get("ts", 0.0)),
                           "args": {k: v for k, v in r.items()
                                    if k not in ("type", "ts", "mono",
                                                 "_pid")}})
        elif t in ("slo.burn", "trace.capture", "run.start", "run.end"):
            events.append({"ph": "i", "s": "g", "cat": t, "name": t,
                           "pid": pid, "tid": tid_of(r),
                           "ts": _us(r.get("ts", 0.0)),
                           "args": {k: v for k, v in r.items()
                                    if k not in ("type", "ts", "mono",
                                                 "_pid")}})

    # a SIGKILLed fleet host's dispatch span never reached end() — but
    # its emit_critical'd bus.claim event did.  Synthesize a short span
    # at the claim so the killed host's accept is VISIBLE on its row and
    # salvage-time link edges resolve instead of dangling.
    for key, claim in _claim_anchors(records).items():
        if key in span_index:
            continue
        anchor = {"_pid": key[0], "span": key[1],
                  "ts": claim.get("ts", 0.0), "thread": 0}
        span_index[key] = anchor
        args = {k: v for k, v in claim.items()
                if k not in ("type", "ts", "mono", "_pid", "kind")}
        args["lost"] = True
        events.append({"ph": "X", "cat": "span", "name": "fleet.dispatch",
                       "pid": key[0], "tid": 0,
                       "ts": _us(claim.get("ts", 0.0)),
                       "dur": 1.0, "args": args})

    # cross-boundary links as flow arrows: submitting span -> first span
    # of the work it caused.  One flow id per edge; an edge whose source
    # span never reached disk is skipped (stitch_stats counts it).
    fid = 0
    for r in links:
        for link_pid, link in _span_links(r):
            src = span_index.get((link_pid, link))
            if src is None:
                continue
            fid += 1
            events.append({"ph": "s", "cat": "link", "name": "submit",
                           "id": fid, "pid": src["_pid"],
                           "tid": tid_of(src),
                           "ts": _us(src.get("ts", 0.0))})
            events.append({"ph": "f", "bp": "e", "cat": "link",
                           "name": "submit", "id": fid, "pid": r["_pid"],
                           "tid": tid_of(r), "ts": _us(r.get("ts", 0.0))})

    tids = {r.get("trace") for r in records if r.get("type") == "trace.bind"}
    tids.discard(None)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"trace_id": sorted(tids)[0] if tids else "",
                          "trace_ids": sorted(tids),
                          "stitch": stitch_stats(records)}}


def export_file(run_dir: str, out: str,
                since_s: Optional[float] = None,
                flush: bool = True) -> Optional[str]:
    """Export ``run_dir``'s ledger as Chrome trace JSON at ``out``;
    returns the path (None on failure — export must never take the
    serving path down, it is called from the SLO trigger)."""
    try:
        if flush:
            ledger.flush()
        from bigdl_tpu_torch.observability.report import load_ledger
        records, _bad = load_ledger(run_dir)
        payload = build_trace(records, since_s=since_s)
        with open(out, "w", encoding="utf-8") as f:
            json.dump(payload, f, separators=(",", ":"))
        return out
    except Exception:
        return None


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        "trace-export",
        description="Stitch a run directory's per-pid ledgers into one "
                    "Chrome/Perfetto trace-event JSON")
    p.add_argument("run_dir", help="directory holding events-*.jsonl")
    p.add_argument("--out", default=None,
                   help="output path (default: <run_dir>/trace.json)")
    p.add_argument("--since-s", type=float, default=None,
                   help="export only the trailing window of the run")
    p.add_argument("--fleet", action="store_true",
                   help="treat run_dir as a FLEET directory (one "
                        "per-host run dir per subdirectory) and merge "
                        "every host's ledger into one timeline")
    args = p.parse_args(argv)
    from bigdl_tpu_torch.observability.report import (ledger_files,
                                                      load_ledger)
    if args.fleet:
        raise NotImplementedError(
            "trace-export --fleet comes with the cross-host cluster "
            "(observability/fleet.py, serving/fleet/cluster.py; ROADMAP.md "
            "Queue 1 item 13, part 3b)")
    if not ledger_files(args.run_dir):
        print(f"trace-export: no events-*.jsonl under {args.run_dir!r}",
              file=sys.stderr)
        return 2
    records, bad = load_ledger(args.run_dir)
    if bad:
        print(f"warning: {bad} malformed ledger line(s) skipped",
              file=sys.stderr)
    payload = build_trace(records, since_s=args.since_s)
    out = args.out or os.path.join(args.run_dir, "trace.json")
    with open(out, "w", encoding="utf-8") as f:
        json.dump(payload, f, separators=(",", ":"))
    st = payload["otherData"]["stitch"]
    print(f"trace-export: {len(payload['traceEvents'])} events over "
          f"{st['pids']} process(es), {st['link_edges']} link edge(s) "
          f"({st['resolved_edges']} resolved, "
          f"{st['cross_pid_edges']} cross-process) -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
