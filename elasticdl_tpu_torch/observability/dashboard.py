"""Terminal dashboard rendering for `edl dash` / `edl top --watch`
(counterpart of elasticdl_tpu/observability/dashboard.py; the `edl` client
comes in the slice after the process entry points).

Pure text: takes the /api/summary JSON dict the master's aggregator
publishes (plus an optional JobStatusResponse) and renders one frame —
per-worker step-time bars with straggler flags, a throughput sparkline,
PS shard load bars, task queue/ETA, active alerts, membership epoch. No
curses dependency: frames are plain strings; the watch loop clears the
screen with ANSI codes, and `--once` prints exactly one frame (the
testable mode).
"""

import json
import shutil
import urllib.request

SPARK_CHARS = "▁▂▃▄▅▆▇█"
BAR_CHAR = "█"


def fetch_summary(host, port, timeout=2.0):
    """GET the master exporter's /api/summary."""
    url = f"http://{host}:{port}/api/summary"
    with urllib.request.urlopen(url, timeout=timeout) as res:
        return json.loads(res.read().decode())


def sparkline(values, width=32):
    """Last `width` values as unicode block characters."""
    values = [v for v in values if v is not None][-width:]
    if not values:
        return ""
    lo, hi = min(values), max(values)
    span = hi - lo
    out = []
    for v in values:
        idx = (
            0
            if span <= 0
            else int((v - lo) / span * (len(SPARK_CHARS) - 1))
        )
        out.append(SPARK_CHARS[idx])
    return "".join(out)


def bar(value, scale, width=24):
    """A left-aligned bar of value/scale, clamped to width cells."""
    if not scale or scale <= 0 or value is None:
        return ""
    cells = int(round(min(1.0, value / scale) * width))
    return BAR_CHAR * max(cells, 1 if value > 0 else 0)


def _fmt_seconds(s):
    if s is None:
        return "-"
    if s >= 3600:
        return f"{s / 3600:.1f}h"
    if s >= 60:
        return f"{s / 60:.1f}m"
    if s >= 1:
        return f"{s:.1f}s"
    return f"{s * 1000:.0f}ms"


def _fmt_rate(v, unit=""):
    if v is None:
        return "-"
    for factor, suffix in ((1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(v) >= factor:
            return f"{v / factor:.1f}{suffix}{unit}"
    return f"{v:.1f}{unit}"


def render(summary, status=None, width=None, top=0):
    """One dashboard frame as a string (no trailing clear codes).

    `top` caps the per-worker and per-PS sections to the K worst rows
    (slowest workers, busiest shards) — at 300+ pods a full roster is
    unreadable and the fleet rollup line carries the rest. 0 shows
    everything (the historical behavior)."""
    if width is None:
        width = shutil.get_terminal_size((100, 24)).columns
    width = max(60, width)
    lines = []
    job = summary.get("job") or "?"
    rps = summary.get("records_per_second")
    records = summary.get("records_done")
    header = f"job {job}"
    if status is not None:
        header += (
            f"  epoch {status.epoch}/{status.num_epochs}"
            f"  v{status.model_version}"
            f"  workers={status.alive_workers}"
        )
        if status.membership_epoch:
            header += f"  mepoch={status.membership_epoch}"
    elif summary.get("membership_epoch"):
        header += f"  mepoch={int(summary['membership_epoch'])}"
    lines.append(header)
    lines.append("─" * min(width, len(header) + 12))

    history = [v for _, v in summary.get("throughput_history") or []]
    lines.append(
        f"throughput {_fmt_rate(rps, ' rec/s'):>12}  "
        f"{sparkline(history)}  records={int(records or 0)}"
    )

    tasks = summary.get("tasks") or {}
    lines.append(
        f"tasks todo={_int(tasks.get('todo'))} "
        f"doing={_int(tasks.get('doing'))} "
        f"drain={_fmt_rate(tasks.get('drain_per_second'), '/s')} "
        f"eta={_fmt_seconds(tasks.get('eta_seconds'))} "
        f"recovered={_int(tasks.get('recovered'))} "
        f"abandoned={_int(tasks.get('abandoned'))}"
    )

    fleet = summary.get("fleet") or {}
    if fleet.get("roles_reporting"):
        lines.append(
            f"fleet roles={_int(fleet.get('roles_reporting'))} "
            f"(push={_int(fleet.get('push_roles'))} "
            f"pull={_int(fleet.get('pull_roles'))})  "
            f"step p50/p90/p99="
            f"{_fmt_seconds(fleet.get('step_ewma_p50'))}/"
            f"{_fmt_seconds(fleet.get('step_ewma_p90'))}/"
            f"{_fmt_seconds(fleet.get('step_ewma_p99'))}  "
            f"telemetry age max={_fmt_seconds(fleet.get('freshness_max_s'))} "
            f"p99={_fmt_seconds(fleet.get('freshness_p99_s'))}"
        )

    workers = summary.get("workers") or {}
    if workers:
        lines.append("")
        shown = sorted(workers)
        if top and len(workers) > top:
            # Slowest-first: at fleet scale the interesting rows are
            # the stragglers; the fleet line above covers the healthy
            # majority.
            shown = sorted(
                workers,
                key=lambda r: workers[r].get("ewma") or 0,
                reverse=True,
            )[:top]
            lines.append(
                f"worker step time (ewma) — slowest {top} of "
                f"{len(workers)}"
            )
        else:
            lines.append("worker step time (ewma)")
        scale = max(
            (w.get("ewma") or 0) for w in workers.values()
        ) or None
        for role in shown:
            w = workers[role]
            ewma = w.get("ewma")
            flags = ""
            if w.get("straggler"):
                flags = (
                    f"  ⚠ STRAGGLER x{w.get('straggler_score', '?')}"
                )
            mfu = w.get("mfu")
            mfu_txt = f"  mfu={mfu * 100:.1f}%" if mfu else ""
            lines.append(
                f"  {role:<12} {_fmt_seconds(ewma):>8} "
                f"p50={_fmt_seconds(w.get('p50'))} "
                f"p99={_fmt_seconds(w.get('p99'))}  "
                f"{bar(ewma, scale)}{flags}{mfu_txt}"
            )

    ps = summary.get("ps") or {}
    if ps:
        lines.append("")
        totals = {
            role: (s.get("push_bytes_per_second") or 0)
            + (s.get("pull_bytes_per_second") or 0)
            for role, s in ps.items()
        }
        shown = sorted(ps)
        if top and len(ps) > top:
            shown = sorted(
                ps, key=lambda r: totals[r], reverse=True
            )[:top]
            lines.append(
                f"ps shard load (push+pull bytes/s) — busiest {top} "
                f"of {len(ps)}"
            )
        else:
            lines.append("ps shard load (push+pull bytes/s)")
        scale = max(totals.values()) or None
        for role in shown:
            s = ps[role]
            ratio = s.get("load_ratio")
            ratio_txt = f"  x{ratio}" if ratio is not None else ""
            lines.append(
                f"  {role:<12} {_fmt_rate(totals[role], 'B/s'):>10}  "
                f"{bar(totals[role], scale)}{ratio_txt}"
            )

    dp = summary.get("datapath") or {}
    if dp:
        lines.append("")
        stages = dp.get("stages") or {}
        head = "data plane"
        if dp.get("records_per_second") is not None:
            head += (
                f" {_fmt_rate(dp.get('records_per_second'), ' rec/s')}"
            )
        if dp.get("dominant_stage"):
            head += f"  slowest stage: {dp['dominant_stage']}"
        if dp.get("backpressure_total"):
            head += (
                f"  backpressure={_int(dp.get('backpressure_total'))}"
            )
        lines.append(head)
        if stages:
            lines.append(
                "  "
                + "  ".join(
                    f"{s}={v:.3f}" for s, v in sorted(stages.items())
                )
                + "  (stage-seconds per wall second, fleet)"
            )
        starve = dp.get("starve_shares") or {}
        starved = set(dp.get("starved") or [])
        worst = sorted(
            starve, key=lambda r: starve[r], reverse=True
        )[: top or len(starve)]
        for role in worst:
            share = starve[role]
            if not share and role not in starved:
                continue
            flag = "  ⚠ STARVED" if role in starved else ""
            lines.append(
                f"  {role:<12} starve={share * 100:5.1f}%  "
                f"{bar(share, 1.0)}{flag}"
            )
        queues = dp.get("queue_depth") or {}
        if queues:
            depth_txt = " ".join(
                f"{q}={_int(d)}" for q, d in sorted(queues.items())
            )
            lines.append(f"  queue depth: {depth_txt}"[:width])

    policy = summary.get("policy") or {}
    if policy.get("enabled"):
        lines.append("")
        head = (
            f"policy actions={_int(policy.get('actions_total'))} "
            f"ticks={_int(policy.get('ticks'))}"
        )
        if policy.get("dry_run"):
            head += "  DRY-RUN"
        blacklisted = policy.get("blacklisted") or []
        if blacklisted:
            head += (
                "  blacklist="
                + ",".join(str(w) for w in blacklisted)
            )
        if policy.get("backups_inflight"):
            head += f"  backups={_int(policy.get('backups_inflight'))}"
        if policy.get("backup_wins"):
            head += f"  backup_wins={_int(policy.get('backup_wins'))}"
        hint = policy.get("world_hint") or {}
        if hint.get("seq"):
            head += (
                f"  hint=world {hint.get('target_world_size')}"
                f" ({_fmt_seconds(hint.get('age_seconds'))} ago)"
            )
        lines.append(head)
        now_ts = summary.get("ts")
        for d in (policy.get("recent") or [])[-4:]:
            age_txt = ""
            if now_ts is not None and d.get("ts") is not None:
                age_txt = f" {_fmt_seconds(max(0, now_ts - d['ts']))} ago"
            lines.append(
                f"  {d.get('action')}[{d.get('subject')}] "
                f"{d.get('outcome')}{age_txt}: {d.get('reason')}"
            )

    alerts = summary.get("alerts") or []
    lines.append("")
    if alerts:
        lines.append(
            f"alerts active={len(alerts)} "
            f"fired={_int(summary.get('alerts_fired'))}"
        )
        for a in alerts:
            detail = {
                k: v
                for k, v in a.items()
                if k not in ("rule", "subject")
            }
            lines.append(f"  ⚠ {a['rule']}: {a['subject']} {detail}")
    else:
        lines.append(
            f"alerts none (fired={_int(summary.get('alerts_fired'))})"
        )
    if status is not None and (status.finished or status.job_failed):
        lines.append("")
        lines.append("JOB FAILED" if status.job_failed else "JOB FINISHED")
    return "\n".join(line[:width] for line in lines)


def _int(v):
    return int(v) if v is not None else 0


CLEAR = "\x1b[2J\x1b[H"
