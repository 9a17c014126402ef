"""Roofline table generator: reads the dry run's JSON records
(`python -m repro_torch.launch.dryrun --out F`) and emits the roofline
markdown table (per arch × shape × mesh: three terms, dominant
bottleneck, MODEL_FLOPS ratio).

    python -m repro_torch.launch.roofline_report dryrun.json [--md]

Counterpart of the reference's `benchmarks/roofline_report.py`, with the
same rows and table.
"""
from __future__ import annotations

import argparse
import json


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}µs"


def rows_from(records: list[dict]) -> list[dict]:
    out = []
    for r in records:
        if r.get("status") == "SKIP":
            out.append({"arch": r["arch"], "cell": r["cell"],
                        "mesh": r["mesh"], "skip": r["reason"]})
            continue
        if r.get("status") != "OK":
            out.append({"arch": r["arch"], "cell": r["cell"],
                        "mesh": r.get("mesh", "?"),
                        "skip": f"FAIL {r.get('error', '')[:60]}"})
            continue
        roof = r["roofline"]
        out.append({
            "arch": r["arch"], "cell": r["cell"], "mesh": r["mesh"],
            "compute_s": roof["compute_s"], "memory_s": roof["memory_s"],
            "collective_s": roof["collective_s"],
            "bottleneck": roof["bottleneck"],
            "useful": roof.get("useful_ratio"),
            "hbm_gib": r.get("arg_bytes", 0) / 2**30,
            "coll_gib": roof["coll_bytes"] / 2**30,
        })
    return out


def to_markdown(rows: list[dict]) -> str:
    lines = [
        "| arch | cell | mesh | compute | memory | collective | bound |"
        " useful (6ND/HLO) | args GiB/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if "skip" in r:
            lines.append(f"| {r['arch']} | {r['cell']} | {r['mesh']} | "
                         f"SKIP — {r['skip']} | | | | | |")
            continue
        useful = f"{r['useful']:.2f}" if r.get("useful") else "—"
        lines.append(
            f"| {r['arch']} | {r['cell']} | {r['mesh']} | "
            f"{fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} | "
            f"{fmt_s(r['collective_s'])} | **{r['bottleneck']}** | "
            f"{useful} | {r['hbm_gib']:.2f} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("json_path")
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args()
    with open(args.json_path) as f:
        records = json.load(f)
    rows = rows_from(records)
    if args.md:
        print(to_markdown(rows))
        return
    for r in rows:
        if "skip" in r:
            print(f"{r['arch']:28s} {r['cell']:12s} {r['mesh']:8s} SKIP "
                  f"({r['skip'][:50]})")
        else:
            print(f"{r['arch']:28s} {r['cell']:12s} {r['mesh']:8s} "
                  f"c={fmt_s(r['compute_s']):>9s} m={fmt_s(r['memory_s']):>9s}"
                  f" x={fmt_s(r['collective_s']):>9s} → {r['bottleneck']}")


if __name__ == "__main__":
    main()
