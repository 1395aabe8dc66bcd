"""Roofline tables from dry-run records (``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.report [--dir artifacts/dryrun_torch]

Emits one markdown table per mesh with the three roofline terms, the
dominant bottleneck, peak memory, and the MODEL_FLOPS / counted-flops
usefulness ratio per (arch x shape) cell, as the reference's report does.
The terms are modelled from the H100 SXM5's spec-sheet rates
(``launch/mesh.HW``), not measured.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def load(dir_: str):
    return [json.loads(p.read_text()) for p in sorted(Path(dir_).glob("*.json"))]


def fmt_row(r):
    if r["status"] != "ok":
        return None
    ro = r["roofline"]
    mem = r["memory"]
    ratio = r.get("useful_flops_ratio", 0.0)
    return (
        f"| {r['arch']} | {r['shape']} | "
        f"{ro['compute_s']:.3f} | {ro['memory_s']:.3f} | "
        f"{ro['collective_s']:.3f} | {ro['dominant']} | "
        f"{ro['step_s_lower_bound']:.3f} | "
        f"{mem['peak_bytes'] / 2**30:.1f} | "
        f"{(ratio if ratio else float('nan')):.2f} |"
    )


HEADER = (
    "| arch | shape | compute s | memory s | collective s | dominant | "
    "step>= s | peak GiB | useful |\n"
    "|---|---|---|---|---|---|---|---|---|"
)


def emit(dir_: str) -> str:
    recs = load(dir_)
    out = []
    for mesh in ("pod256", "pod512"):
        out.append(f"\n### Mesh {mesh} "
                   f"({'2x16x16 (pod,data,model)' if mesh == 'pod512' else '16x16 (data,model)'})\n")
        out.append(HEADER)
        skips = []
        for r in recs:
            if r["mesh"] != mesh:
                continue
            if r["status"] == "skipped":
                skips.append(f"{r['arch']} x {r['shape']}: {r['reason']}")
                continue
            row = fmt_row(r)
            if row:
                out.append(row)
        if skips:
            out.append("\nSkipped (per assignment rules): " + "; ".join(sorted(set(skips))))
    return "\n".join(out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    a = ap.parse_args()
    print(emit(a.dir))
