#!/usr/bin/env python3
"""Figures from the PyTorch port's measured records (the twin of
``scripts/plot_results.py``).

    python3 scripts/torch_plot_results.py [--records chiprun_out]
        [--out chiprun_out/figures]

The reference's figure family, read from the records the port's scripts
write under ``chiprun_out/`` (``*_torch.json``, the card's name and power
limit inside each), never from the reference's TPU records:

  speedup.png           CB against dense fps per workload
                        (RESULTS_torch.json, RESULTS_pose_graph_torch.json)
  pareto.png            accuracy against FLOP reduction at each tuner
                        budget (TUNE_<model>_torch.json)
  sensitivity_<m>.png   per-layer tau sensitivity (TUNE_<model>_torch.json)
  stages.png            per-stage device time per frame
                        (PROFILE_trace_torch.json)
  changerate.png        speedup against the stem's changed share, with
                        the break-even (CHANGERATE_torch.json)

A figure whose record is absent is skipped. A pure consumer: reads JSON,
writes PNGs (matplotlib, Agg) under ``--out`` only, touches no device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

# the reference's validated categorical palette
BLUE, ORANGE, AQUA, YELLOW = "#2a78d6", "#eb6834", "#1baf7a", "#eda100"
MAGENTA, GREEN = "#e87ba4", "#008300"
NEUTRAL = "#9a9a92"  # the dense baseline: a neutral, not a series hue
INK, INK2 = "#1a1a19", "#5f5e56"

STYLE = {
    "axes.spines.top": False, "axes.spines.right": False,
    "axes.edgecolor": INK2, "axes.labelcolor": INK,
    "xtick.color": INK2, "ytick.color": INK2,
    "axes.grid": True, "grid.color": "#e6e5dd", "grid.linewidth": 0.6,
    "font.size": 9, "axes.titlesize": 10, "figure.dpi": 150,
}
MODEL_HUES = {"scene": BLUE, "scene_hard": ORANGE, "seg": AQUA,
              "pose": MAGENTA, "pose_graph": GREEN}
STAGE_HUES = {"detect": BLUE, "compact": YELLOW, "delta_conv": AQUA,
              "delta_pool": MAGENTA, "fused_pool": ORANGE,
              "cached_conv": GREEN, "band_conv": INK2, "glue": NEUTRAL}


def _load(records: pathlib.Path, name: str):
    p = records / name
    return json.loads(p.read_text()) if p.exists() else None


def _card(rec) -> str:
    """The card of a record (its own key, or its rows')."""
    if not rec:
        return ""
    if rec.get("card"):
        return rec["card"]
    rows = rec.get("rows") or []
    return next((r["card"] for r in rows if r.get("card")), "")


def plot_speedup(records, outdir) -> bool:
    rows, seen, cards = [], set(), set()
    for name in ("RESULTS_torch.json", "RESULTS_pose_graph_torch.json"):
        rec = _load(records, name)
        for r in (rec or {}).get("rows", []):
            # one row per workload: the tuned operating point
            if r["model"] in seen or r.get("tau") not in ("tuned", None):
                continue
            seen.add(r["model"])
            rows.append(r)
            cards.add(r.get("card", ""))
    if not rows:
        return False
    fig, ax = plt.subplots(figsize=(6.4, 3.2))
    x = range(len(rows))
    ax.bar([i - 0.21 for i in x], [r["dense_fps"] for r in rows], 0.38,
           color=NEUTRAL, label="dense")
    ax.bar([i + 0.21 for i in x], [r["cb_fps"] for r in rows], 0.38,
           color=BLUE, label="change-based")
    for i, r in enumerate(rows):
        ax.text(i + 0.21, r["cb_fps"], f"{r['speedup']:.2f}x", ha="center",
                va="bottom", fontsize=8, color=INK)
    ax.set_xticks(list(x), [f"{r['model']}\n{r.get('resolution', '')}"
                            for r in rows])
    ax.set_ylabel("frames / s (one card)")
    ax.set_title("CB vs dense throughput, tuned taus: "
                 + "; ".join(sorted(c for c in cards if c)))
    ax.legend(frameon=False, loc="upper right")
    ax.grid(axis="x", visible=False)
    fig.tight_layout()
    fig.savefig(outdir / "speedup.png")
    plt.close(fig)
    return True


def plot_pareto(records, outdir) -> bool:
    fig, ax = plt.subplots(figsize=(5.6, 3.6))
    drew = False
    for model, hue in MODEL_HUES.items():
        tune = _load(records, f"TUNE_{model}_torch.json")
        if not tune or not tune.get("pareto"):
            continue
        pts = sorted(tune["pareto"], key=lambda p: p["flop_reduction"])
        ref = max(p["metric"] for p in pts)
        ax.plot([p["flop_reduction"] for p in pts],
                [max(ref - p["metric"], 0.0) * 100 for p in pts], "-o",
                color=hue, label=model, linewidth=2, markersize=4)
        drew = True
    if not drew:
        plt.close(fig)
        return False
    ax.axhline(0.5, color=INK2, linewidth=1, linestyle="--")
    ax.text(ax.get_xlim()[1], 0.5, " 0.5% budget", va="bottom", ha="right",
            fontsize=8, color=INK2)
    ax.set_xlabel("effective FLOP reduction vs dense (x)")
    ax.set_ylabel("calibration metric degradation (pp)")
    ax.set_title("Tuner Pareto fronts (one point per budget)")
    ax.legend(frameon=False)
    fig.tight_layout()
    fig.savefig(outdir / "pareto.png")
    plt.close(fig)
    return True


def plot_sensitivity(records, outdir) -> list:
    made = []
    for model in MODEL_HUES:
        tune = _load(records, f"TUNE_{model}_torch.json")
        if not tune or not tune.get("sensitivity"):
            continue
        sens = tune["sensitivity"]
        n = len(sens)
        cmap = plt.get_cmap("Blues")
        fig, ax = plt.subplots(figsize=(5.6, 3.4))
        for i, (_layer, curve) in enumerate(sorted(
                sens.items(), key=lambda kv: int(kv[0])
                if str(kv[0]).isdigit() else str(kv[0]))):
            ax.plot([c[0] for c in curve], [c[1] for c in curve],
                    color=cmap(0.35 + 0.6 * i / max(n - 1, 1)),
                    linewidth=1.5)
        ax.set_xscale("log")
        ax.set_xlabel("layer threshold tau (others at baseline)")
        ax.set_ylabel("end metric on calibration set")
        ax.set_title(f"{model}: per-layer tau sensitivity "
                     f"({n} layers, light=shallow, dark=deep)")
        fig.tight_layout()
        fig.savefig(outdir / f"sensitivity_{model}.png")
        plt.close(fig)
        made.append(model)
    return made


def plot_stages(records, outdir) -> bool:
    prof = _load(records, "PROFILE_trace_torch.json")
    if not prof or not prof.get("stages"):
        return False
    stages = prof["stages"]
    keys = [k for k in STAGE_HUES
            if any(k in s["per_frame_us"] for s in stages.values())]
    fig, ax = plt.subplots(figsize=(6.4, 1.1 + 0.5 * len(stages)))
    for j, (m, row) in enumerate(stages.items()):
        left = 0.0
        for k in keys:
            v = row["per_frame_us"].get(k, 0.0)
            ax.barh(j, v, 0.5, left=left, color=STAGE_HUES[k],
                    label=k if j == 0 else None)
            left += v
        ax.text(left, j, f"  {left:.0f} us", va="center", fontsize=8,
                color=INK2)
    ax.set_yticks(range(len(stages)), list(stages))
    ax.invert_yaxis()
    ax.set_xlabel("per-frame device self time by stage (us)")
    ax.set_title("Per-stage attribution from torch.profiler traces: "
                 + _card(prof))
    ax.legend(frameon=False, ncol=4, loc="lower right", fontsize=7)
    ax.grid(axis="y", visible=False)
    fig.tight_layout()
    fig.savefig(outdir / "stages.png")
    plt.close(fig)
    return True


def plot_changerate(records, outdir) -> bool:
    cr = _load(records, "CHANGERATE_torch.json")
    if not cr or not cr.get("rows"):
        return False
    rows = sorted(cr["rows"], key=lambda r: r["changed_tile_frac_layer0"])
    fig, ax = plt.subplots(figsize=(5.6, 3.4))
    ax.plot([r["changed_tile_frac_layer0"] for r in rows],
            [r["speedup"] for r in rows], "-o", color=BLUE, lw=1.6, ms=4)
    for r in rows:
        if r["point"].startswith("pan"):
            ax.annotate(r["point"],
                        (r["changed_tile_frac_layer0"], r["speedup"]),
                        textcoords="offset points", xytext=(4, 6),
                        fontsize=8, color=INK2)
    ax.axhline(1.0, color=NEUTRAL, lw=1.0, ls="--")
    be = cr.get("break_even_changed_tile_frac")
    if be:
        ax.axvline(be, color=YELLOW, lw=1.0, ls=":")
        ax.annotate(f"break-even {be:.0%}", (be, 1.05), fontsize=8,
                    color=INK2, rotation=90, va="bottom")
    ax.set_xlabel("changed-tile fraction (stem layer, per frame)")
    ax.set_ylabel("CB speedup vs dense (same card, interleaved)")
    ax.set_title("Speedup vs change rate, 720p scene: " + _card(cr))
    fig.tight_layout()
    fig.savefig(outdir / "changerate.png")
    plt.close(fig)
    return True


def plot_all(records, outdir):
    """Every figure whose record exists; returns the files written."""
    records, outdir = pathlib.Path(records), pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    with plt.rc_context(STYLE):
        plot_speedup(records, outdir)
        plot_pareto(records, outdir)
        plot_sensitivity(records, outdir)
        plot_stages(records, outdir)
        plot_changerate(records, outdir)
    return sorted(p.name for p in outdir.glob("*.png"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", default=str(ROOT / "chiprun_out"))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "figures"))
    args = ap.parse_args(argv)
    print("wrote", *plot_all(args.records, args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
