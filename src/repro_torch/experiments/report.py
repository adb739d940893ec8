"""Markdown summary of a BENCH_matrix record, mirroring the paper's
table layout: one table per constraint regime, rows = device × model ×
workload, columns = CORAL vs every baseline — plus the fleet-convergence
figure for BENCH_fleet records (matplotlib optional: without it the
figure is skipped and ``None`` returned).

The port's own copy of ``repro.experiments.report``: the same text, byte
for byte, for the same record (tests/test_torch_records.py holds
``markdown_report(BENCH_matrix.json)`` to the committed BENCH_matrix.md).
"""
from __future__ import annotations

from typing import List, Optional


def _fmt_score(s) -> str:
    return "—" if s is None else f"{s:.2f}"


def _fmt_m2f(v) -> str:
    return "—" if v is None else f"{v:.1f}"


def _viol(rec: dict) -> str:
    marks = []
    if rec.get("violates_tau"):
        marks.append("τ!")
    if rec.get("violates_power"):
        marks.append("P!")
    return "".join(marks)


def markdown_report(record: dict) -> str:
    """Render a BENCH_matrix record (any schema version — drift, offload
    and cotenant sections appear only when their cell arrays are
    non-empty) as the committed BENCH_matrix.md summary."""
    lines: List[str] = ["# Scenario matrix", ""]
    s = record["summary"]
    lines.append(
        f"{s['n_cells']} cells · iters={record['iters']} · "
        f"seeds={record['seeds']} · quick={record['quick']}"
    )
    lines.append("")
    lines.append(
        f"- mean CORAL normalized score: **{s['mean_coral_score']:.3f}**"
    )
    worst_single = s["min_single_target_score"]
    lines.append(
        "- worst single-target cell: "
        + (
            f"**{worst_single:.3f}** (gate ≥ 0.9)"
            if worst_single is not None
            else "— (no single-target regime in this grid)"
        )
    )
    lines.append(
        f"- dual-constraint power violations: "
        f"**{s['dual_power_violations']}** (gate = 0)"
    )
    if s.get("n_drift_cells"):
        lines.append(
            f"- drift cells: **{s['n_drift_cells']}** · worst adaptive "
            f"post-shift score **{s['min_drift_adaptive_score']:.3f}** "
            f"(gate ≥ 0.85) · best static ablation "
            f"**{s['max_drift_static_score']:.3f}** (gate ≤ 0.5)"
        )
    if s.get("n_offload_cells"):
        lines.append(
            f"- offload cells: **{s['n_offload_cells']}** · worst CORAL "
            f"joint-space score **{s['min_offload_score']:.3f}** "
            f"(gate ≥ 0.85) · power violations "
            f"**{s['offload_power_violations']}** (gate = 0) · feasible "
            f"presets/ablations **{s['offload_feasible_baselines']}** "
            f"(gate = 0)"
        )
    if s.get("n_cotenant_cells"):
        lines.append(
            f"- cotenant cells: **{s['n_cotenant_cells']}** · worst CORAL "
            f"joint-space score **{s['min_cotenant_score']:.3f}** "
            f"(gate ≥ 0.85) · shared-rail violations "
            f"**{s['cotenant_power_violations']}** (gate = 0) · feasible "
            f"presets/greedy **{s['cotenant_feasible_baselines']}** "
            f"(gate = 0)"
        )
    lines.append("")

    for regime in record["grid"]["regimes"]:
        cells = [c for c in record["cells"] if c["regime"] == regime]
        if not cells:
            continue
        head = cells[0]
        budget = "∞" if head["p_budget"] is None else "slack-capped"
        lines.append(f"## Regime `{regime}` (mode={head['mode']}, budget {budget})")
        lines.append("")
        lines.append(
            "| device | model | workload | τ* | P-cap | CORAL | viol | "
            "m→feas | ALERT | ALERT-On | max_power | default | oracle meas |"
        )
        lines.append("|" + "---|" * 13)
        for c in cells:
            b = c["baselines"]
            cap = "—" if c["p_budget"] is None else f"{c['p_budget']:.2f}W"
            coral = c["coral"]
            viol = (
                f"{coral['violation_rate']:.0%}"
                if coral["violation_rate"]
                else "0"
            )

            def col(name: str) -> str:
                r = b[name]
                mark = _viol(r)
                return f"{_fmt_score(r['score'])}{' ' + mark if mark else ''}"

            lines.append(
                f"| {c['device']} | {c['model']} | {c['workload']} "
                f"| {c['tau_target']:.2f} | {cap} "
                f"| **{coral['score']:.2f}** | {viol} "
                f"| {_fmt_m2f(coral['measurements_to_feasible'])} "
                f"| {col('alert')} | {col('alert_online')} "
                f"| {col('max_power')} | {col('default')} "
                f"| {c['oracle']['measurements']} |"
            )
        lines.append("")
    offload_cells = record.get("offload_cells", [])
    if offload_cells:
        lines.append("## Offload regimes (edge↔pod joint search)")
        lines.append("")
        lines.append(
            "| device | model | network | λ | edge-max | τ* | P-cap | "
            "CORAL | viol | no-offload | max_power | min_power |"
        )
        lines.append("|" + "---|" * 12)
        for c in offload_cells:
            o = c["offload"]
            coral = c["coral"]
            viol = (
                f"{coral['violation_rate']:.0%}"
                if coral["violation_rate"]
                else "0"
            )
            no = o["no_offload"]
            no_mark = _viol(no) or "ok"
            mp = c["baselines"]["max_power"]
            mn = c["baselines"]["min_power"]
            lines.append(
                f"| {c['device']} | {c['model']} | {o['network']} "
                f"| {o['demand']:.1f} | {o['edge_only_max']:.1f} "
                f"| {c['tau_target']:.1f} | {c['p_budget']:.2f}W "
                f"| **{coral['score']:.2f}** | {viol} "
                f"| {no_mark} | {_viol(mp) or 'ok'} | {_viol(mn) or 'ok'} |"
            )
        lines.append("")
        lines.append(
            "Offload cells offer demand λ = 2× the best the un-offloaded "
            "edge can serve, so every φ=0 row misses the SLO (`τ!` under "
            "`no-offload`) and the all-hi preset busts the edge power "
            "budget (`P!`) — only the joint route-fraction × concurrency "
            "× two-sided DVFS search is feasible. CORAL scores are "
            "efficiency ratios vs the batched joint-space oracle."
        )
        lines.append("")
    cotenant_cells = record.get("cotenant_cells", [])
    if cotenant_cells:
        lines.append("## Cotenant regimes (per-tenant slots × shared DVFS)")
        lines.append("")
        lines.append(
            "| device | regime | tenants | floors | P-cap | CORAL | viol | "
            "greedy | max_power | default | min_power |"
        )
        lines.append("|" + "---|" * 11)
        for c in cotenant_cells:
            ct = c["cotenant"]
            coral = c["coral"]
            viol = (
                f"{coral['violation_rate']:.0%}"
                if coral["violation_rate"]
                else "0"
            )
            tenants = "+".join(t["model"] for t in ct["tenants"])
            floors = "+".join(f"{t['floor']:.1f}" for t in ct["tenants"])
            greedy_mark = _viol(ct["greedy"]) or "ok"
            mp = c["baselines"]["max_power"]
            df = c["baselines"]["default"]
            mn = c["baselines"]["min_power"]
            lines.append(
                f"| {c['device']} | {c['regime']} | {tenants} "
                f"| {floors} | {c['p_budget']:.2f}W "
                f"| **{coral['score']:.2f}** | {viol} "
                f"| {greedy_mark} | {_viol(mp) or 'ok'} "
                f"| {_viol(df) or 'ok'} | {_viol(mn) or 'ok'} |"
            )
        lines.append("")
        lines.append(
            "Cotenant cells serve two tenants on one rail: each tenant's "
            "τ floor is a fraction of its *solo* maximum, and the shared "
            "power cap is slack over the joint minimum — so per-tenant "
            "greedy planning (each tenant optimizing as if it owned the "
            "rail, combined elementwise) misses a floor or busts the cap "
            "(`τ!`/`P!` under `greedy`). Only the joint per-tenant-slots × "
            "shared-DVFS search is feasible; CORAL scores are efficiency "
            "ratios vs the batched joint-space oracle on the scalarized "
            "(min-headroom, rail-power) channel."
        )
        lines.append("")
    drift_cells = record.get("drift_cells", [])
    if drift_cells:
        lines.append("## Dynamic regimes (drift-adaptive vs static CORAL)")
        lines.append("")
        lines.append(
            "| device | model | regime | shift | adaptive | static | "
            "recovery | transient viol | resets |"
        )
        lines.append("|" + "---|" * 9)
        for c in drift_cells:
            a, st = c["adaptive"], c["static"]
            rec = (
                f"{a['recovery_intervals']:.1f}"
                if a["recovery_intervals"] is not None
                else "—"
            )
            lines.append(
                f"| {c['device']} | {c['model']} | {c['regime']} "
                f"| t={c['drift']['shift_start']} "
                f"| **{a['final_score']:.2f}** | {st['final_score']:.2f} "
                f"| {rec} | {a['transient_violation_rate']:.0%} "
                f"| {a['resets']:.1f} |"
            )
        lines.append("")
        lines.append(
            "Drift scores compare each variant's end-of-run choice against "
            "the *post-shift* oracle (exhaustive search on the fully "
            "shifted landscape); `recovery` is the mean number of control "
            "intervals from the shift until the loop holds a ≥0.85-scoring "
            "config for the rest of the run."
        )
        lines.append("")
    lines.append(
        "Scores are normalized vs the cell's exhaustive-search oracle "
        "(max_throughput: τ ratio; targeted regimes: efficiency ratio); "
        "`τ!`/`P!` mark true constraint violations on the noise-free twin; "
        "`m→feas` is the mean number of measurements until the first "
        "feasible observation."
    )
    lines.append("")
    return "\n".join(lines)


def fleet_convergence_figure(record: dict, path: str) -> Optional[str]:
    """Fraction-of-twins-feasible vs measurement count, cold vs warm, one
    panel per device family (plus the all-families panel) from a
    BENCH_fleet record. Returns the written path, or None when matplotlib
    is unavailable (the figure is a nicety; the JSON record is the
    artifact of record)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    res = record["results"]
    curves = res["convergence"]
    names = ["all"] + [f for f in res["families"] if f in curves]
    names = list(dict.fromkeys(n for n in names if n in curves))
    fig, axes = plt.subplots(
        1, len(names), figsize=(3.4 * len(names), 3.2), sharey=True
    )
    if len(names) == 1:
        axes = [axes]
    for ax, name in zip(axes, names):
        c = curves[name]
        xs = range(1, len(c["cold"]) + 1)
        ax.plot(xs, c["cold"], label="cold", color="tab:blue")
        if c["warm"]:
            ax.plot(
                range(1, len(c["warm"]) + 1),
                c["warm"],
                label="warm",
                color="tab:orange",
            )
        ax.set_title(name, fontsize=9)
        ax.set_xlabel("measurements")
        ax.set_ylim(0, 1.02)
        ax.grid(alpha=0.3)
    axes[0].set_ylabel("fraction of twins feasible")
    axes[0].legend(loc="lower right", fontsize=8)
    gain = res["warm_gain"]
    gain_txt = "—" if gain is None else f"{gain:.2f}×"
    fig.suptitle(
        f"Fleet convergence — {res['n_twins']} twins, warm gain {gain_txt}",
        fontsize=10,
    )
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path
